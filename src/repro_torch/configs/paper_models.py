"""Synthetic-weight layouts of the paper's own evaluation models, used by the
benchmark harness (Tables 1-3, Figs 4-13). Reduced dims, faithful topology:

- mixtral-8x7b-lite : 8 experts, top-2, coarse experts  (Mixtral-8x7B [21])
- olmoe-lite        : 64 experts, top-8, fine-grained   (OLMoE [35])
- dsv2-lite-lite    : 64 routed + 2 shared experts, top-6 (DeepSeek-V2-Lite [28])
"""
from .base import ModelConfig, DualSparseConfig

CONFIGS = [
    ModelConfig(
        arch_id="mixtral-8x7b-lite",
        family="moe",
        source="arXiv:2401.04088 (reduced layout)",
        n_layers=4,
        d_model=256,
        n_heads=8,
        n_kv_heads=2,
        d_ff=512,
        vocab_size=1024,
        attn_kind="gqa",
        n_experts=8,
        top_k=2,
        d_expert=512,
        router_norm_topk=True,
        dualsparse=DualSparseConfig(enabled=True, partition_p=2,
                                    t_drop=0.30, t_major=0.29, t_minor=0.31),
    ),
    ModelConfig(
        arch_id="olmoe-lite",
        family="moe",
        source="OLMoE [arXiv:2409.02060] (reduced layout)",
        n_layers=4,
        d_model=256,
        n_heads=8,
        n_kv_heads=8,
        d_ff=256,
        vocab_size=1024,
        attn_kind="gqa",
        n_experts=64,
        top_k=8,
        d_expert=256,
        router_norm_topk=True,
        dualsparse=DualSparseConfig(enabled=True, partition_p=2,
                                    t_drop=0.08, t_major=0.07, t_minor=0.09),
    ),
    ModelConfig(
        arch_id="dsv2-lite-lite",
        family="moe",
        source="DeepSeek-V2-Lite [arXiv:2405.04434] (reduced layout)",
        n_layers=4,
        d_model=256,
        n_heads=8,
        n_kv_heads=8,
        d_ff=256,
        vocab_size=1024,
        attn_kind="gqa",
        n_experts=64,
        top_k=6,
        d_expert=256,
        n_shared_experts=2,
        router_norm_topk=False,    # deepseek-v2 does not renormalize top-k
        dualsparse=DualSparseConfig(enabled=True, partition_p=2,
                                    t_drop=0.12, t_major=0.11, t_minor=0.13,
                                    importance="abs_gate_up"),
    ),
]
