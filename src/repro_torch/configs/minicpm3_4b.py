"""MiniCPM3-4B [hf:openbmb/MiniCPM3-4B] — dense with MLA (multi-head latent
attention). 62L, d_model 2560, 40 heads, d_ff 6400, vocab 73448.
MLA ranks: q_lora 768, kv_lora 256, qk_nope 64, qk_rope 32, v_head 64."""
from .base import ModelConfig

CONFIGS = [
    ModelConfig(
        arch_id="minicpm3-4b",
        family="dense",
        source="hf:openbmb/MiniCPM3-4B",
        n_layers=62,
        d_model=2560,
        n_heads=40,
        n_kv_heads=40,
        d_ff=6400,
        vocab_size=73448,
        attn_kind="mla",
        rope_theta=1e4,
        q_lora_rank=768,
        kv_lora_rank=256,
        qk_nope_head_dim=64,
        qk_rope_head_dim=32,
        v_head_dim=64,
        sliding_window=8192,
        tie_embeddings=True,
    )
]
