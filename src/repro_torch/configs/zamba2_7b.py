"""Zamba2-7B [arXiv:2411.15242] — hybrid Mamba2 backbone with a shared
attention block interleaved periodically. 81 Mamba2 layers, d_model 3584,
the shared attention block uses 32 MHA heads (kv=32), its FFN d_ff=14336,
vocab 32000, ssm_state=64."""
from .base import ModelConfig

CONFIGS = [
    ModelConfig(
        arch_id="zamba2-7b",
        family="hybrid",
        source="arXiv:2411.15242",
        n_layers=81,
        d_model=3584,
        n_heads=32,
        n_kv_heads=32,
        d_ff=14336,
        vocab_size=32000,
        attn_kind="gqa",
        ssm_state=64,
        ssm_head_dim=64,
        ssm_expand=2,
        attn_every=6,          # shared attention block applied every 6 mamba layers
        sliding_window=8192,   # used by the long_500k swa variant of the shared block
        tie_embeddings=True,
    )
]
