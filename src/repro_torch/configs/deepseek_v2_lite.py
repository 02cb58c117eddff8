"""DeepSeek-V2-Lite [hf:deepseek-ai/DeepSeek-V2-Lite] — MoE with MLA.
27L, d_model 2048, 16 heads, vocab 102400, untied head, rms eps 1e-6.
MLA without a query LoRA: kv_lora 512, qk_nope 128, qk_rope 64, v_head 128.
YaRN RoPE: theta 1e4, factor 40 over 4096 original positions, beta_fast
32, beta_slow 1, mscale = mscale_all_dim = 0.707. Layer 0 is a dense
SwiGLU of 10944; layers 1-26 route 64 experts of 1408, top-6 softmax
scores not renormalised, plus 2 shared experts."""
from .base import ModelConfig, DualSparseConfig

CONFIGS = [
    ModelConfig(
        arch_id="deepseek-v2-lite",
        family="moe",
        source="hf:deepseek-ai/DeepSeek-V2-Lite",
        n_layers=27,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        d_ff=10944,
        vocab_size=102400,
        attn_kind="mla",
        rope_theta=1e4,
        rope_scaling_factor=40.0,
        rope_original_max_pos=4096,
        rope_beta_fast=32.0,
        rope_beta_slow=1.0,
        rope_mscale=0.707,
        rope_mscale_all_dim=0.707,
        q_lora_rank=0,
        kv_lora_rank=512,
        qk_nope_head_dim=128,
        qk_rope_head_dim=64,
        v_head_dim=128,
        n_experts=64,
        top_k=6,
        d_expert=1408,
        n_shared_experts=2,
        router_norm_topk=False,
        leading_dense_layers=1,
        norm_eps=1e-6,
        dualsparse=DualSparseConfig(enabled=True, partition_p=2,
                                    importance="abs_gate"),
    )
]
