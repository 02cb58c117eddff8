"""DBRX-132B [hf:databricks/dbrx-base] — coarse-expert MoE: 16 experts,
top-4, per-expert d_ff 10752. 40L, d_model 6144, 48 heads (kv=8),
vocab 100352. The coarse experts make it the Mixtral-like case from the
paper: partition P has the biggest effect here."""
from .base import ModelConfig, DualSparseConfig

CONFIGS = [
    ModelConfig(
        arch_id="dbrx-132b",
        family="moe",
        source="hf:databricks/dbrx-base",
        n_layers=40,
        d_model=6144,
        n_heads=48,
        n_kv_heads=8,
        d_ff=10752,
        vocab_size=100352,
        attn_kind="gqa",
        rope_theta=5e5,
        n_experts=16,
        top_k=4,
        d_expert=10752,
        router_norm_topk=True,
        sliding_window=8192,
        dualsparse=DualSparseConfig(enabled=True, partition_p=2,
                                    t_drop=0.15, t_major=0.14, t_minor=0.16,
                                    importance="abs_gate", load_aware=True),
    )
]
