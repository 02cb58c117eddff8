"""Granite-20B-Code [arXiv:2405.04324] — llama-arch dense code model with
MQA (1 kv head). 52L, d_model 6144, 48 heads, d_ff 24576, vocab 49152."""
from .base import ModelConfig

CONFIGS = [
    ModelConfig(
        arch_id="granite-20b",
        family="dense",
        source="arXiv:2405.04324",
        n_layers=52,
        d_model=6144,
        n_heads=48,
        n_kv_heads=1,
        d_ff=24576,
        vocab_size=49152,
        attn_kind="gqa",
        mlp_kind="gelu",
        rope_theta=1e4,
        sliding_window=8192,
    )
]
