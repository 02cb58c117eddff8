"""DualSparse-MoE core: gating, dropping, partition, reconstruction,
dispatch, the MoE forward paths and the sparsity policies."""
