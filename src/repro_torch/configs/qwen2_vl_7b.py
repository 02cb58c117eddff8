"""Qwen2-VL-7B [arXiv:2409.12191] — VLM; language backbone with M-RoPE
(multimodal rotary, sections over (t,h,w)). Vision encoder is a STUB: the
frontend provides precomputed patch embeddings merged into the sequence.
28L, d_model 3584, 28 heads (kv=4), d_ff 18944, vocab 152064."""
from .base import ModelConfig

CONFIGS = [
    ModelConfig(
        arch_id="qwen2-vl-7b",
        family="vlm",
        source="arXiv:2409.12191",
        n_layers=28,
        d_model=3584,
        n_heads=28,
        n_kv_heads=4,
        d_ff=18944,
        vocab_size=152064,
        attn_kind="gqa",
        rope_theta=1e6,
        qkv_bias=True,
        mrope_sections=(16, 24, 24),   # half of head_dim 128
        frontend="vision",
        n_frontend_tokens=1024,        # stub: patch embeddings prepended
        sliding_window=8192,
    )
]
