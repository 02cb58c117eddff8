"""Mamba2-370m [arXiv:2405.21060] — attention-free SSM with SSD
(state-space duality). 48L, d_model 1024, ssm_state 128, vocab 50280."""
from .base import ModelConfig

CONFIGS = [
    ModelConfig(
        arch_id="mamba2-370m",
        family="ssm",
        source="arXiv:2405.21060",
        n_layers=48,
        d_model=1024,
        n_heads=0,
        n_kv_heads=0,
        d_ff=0,
        vocab_size=50280,
        attn_kind="none",
        ssm_state=128,
        ssm_head_dim=64,
        ssm_expand=2,
        tie_embeddings=True,
    )
]
