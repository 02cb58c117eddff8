"""Qwen3-30B-A3B [hf:Qwen/Qwen3-30B-A3B] — fine-grained MoE: 128 experts,
top-8, per-expert d_ff 768. 48L, d_model 2048, 32 heads (kv=4), vocab 151936.

Primary target for the paper's technique: fine-grained experts with
normalized top-k gating, partitioned P=2 -> 256 sub-experts for S-ETP and
2T-Drop."""
from .base import ModelConfig, DualSparseConfig

CONFIGS = [
    ModelConfig(
        arch_id="qwen3-moe-30b-a3b",
        family="moe",
        source="hf:Qwen/Qwen3-30B-A3B",
        n_layers=48,
        d_model=2048,
        n_heads=32,
        n_kv_heads=4,
        head_dim=128,
        d_ff=768,              # = d_expert for the MoE layer
        vocab_size=151936,
        attn_kind="gqa",
        rope_theta=1e6,
        n_experts=128,
        top_k=8,
        d_expert=768,
        router_norm_topk=True,
        sliding_window=8192,
        dualsparse=DualSparseConfig(enabled=True, partition_p=2,
                                    t_drop=0.08, t_major=0.07, t_minor=0.09,
                                    importance="abs_gate", load_aware=True),
    )
]
