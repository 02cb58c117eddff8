"""Hand-written Hopper kernels of the port, their plain PyTorch versions and
the wrappers that choose between them by device (``kernels.ops``)."""
