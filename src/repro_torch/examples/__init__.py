"""The system's three walkthroughs, on the card by default (``--device
cpu`` runs them on the CPU):

  python -m repro_torch.examples.quickstart
  python -m repro_torch.examples.serve_dualsparse --requests 8
  python -m repro_torch.examples.finetune_partitioned --steps 300

Each exposes its steps as functions of a model or a layer's params, so
they can be fed weights loaded through ``checkpoint.from_numpy``."""
