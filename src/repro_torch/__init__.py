"""PyTorch/CUDA port of the DualSparse-MoE serving system.

Mirrors the layout of the JAX package (``configs``, ``core``, ``kernels``,
``models``, ``obs``, ``serving``, ``launch``, ``data``, ``checkpoint``) and
imports nothing from it. Entry points run on the CUDA card unless the caller
passes ``device="cpu"``.
"""
