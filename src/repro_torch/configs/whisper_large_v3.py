"""Whisper-large-v3 [arXiv:2212.04356] — encoder-decoder; the conv/mel
frontend is a STUB (the engines feed 1500 frame embeddings).
32 enc + 32 dec layers, d_model 1280, 20 MHA heads, d_ff 5120, vocab 51866."""
from .base import ModelConfig

CONFIGS = [
    ModelConfig(
        arch_id="whisper-large-v3",
        family="audio",
        source="arXiv:2212.04356",
        n_layers=32,            # decoder layers
        encoder_layers=32,
        d_model=1280,
        n_heads=20,
        n_kv_heads=20,
        d_ff=5120,
        vocab_size=51866,
        attn_kind="gqa",
        mlp_kind="gelu",        # MHA == GQA with kv=heads
        frontend="audio",
        n_frontend_tokens=1500, # mel frames after conv downsample (stub)
        tie_embeddings=True,
    )
]
