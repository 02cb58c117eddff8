"""Qwen2-7B [arXiv:2407.10671] — dense, GQA(kv=4), QKV bias.
28L, d_model 3584, 28 heads, d_ff 18944, vocab 152064."""
from .base import ModelConfig

CONFIGS = [
    ModelConfig(
        arch_id="qwen2-7b",
        family="dense",
        source="arXiv:2407.10671",
        n_layers=28,
        d_model=3584,
        n_heads=28,
        n_kv_heads=4,
        d_ff=18944,
        vocab_size=152064,
        attn_kind="gqa",
        rope_theta=1e6,
        qkv_bias=True,
        sliding_window=8192,
    )
]
