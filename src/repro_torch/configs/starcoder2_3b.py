"""StarCoder2-3B [arXiv:2402.19173] — dense, GQA(kv=2), RoPE.
30L, d_model 3072, 24 heads, d_ff 12288, vocab 49152."""
from .base import ModelConfig

CONFIGS = [
    ModelConfig(
        arch_id="starcoder2-3b",
        family="dense",
        source="arXiv:2402.19173",
        n_layers=30,
        d_model=3072,
        n_heads=24,
        n_kv_heads=2,
        d_ff=12288,
        vocab_size=49152,
        attn_kind="gqa",
        mlp_kind="gelu",
        rope_theta=1e5,
        qkv_bias=True,
        sliding_window=4096,
    )
]
