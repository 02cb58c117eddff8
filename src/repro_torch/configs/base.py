"""Model configuration dataclasses for all supported architectures.

Every assigned architecture gets one module in this package instantiating a
``ModelConfig`` with the exact dimensions from its source paper / model card.
``reduced()`` produces the CPU-smoke variant (≤2 layers, d_model ≤ 512,
≤4 experts) of the same family.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, replace
from typing import Tuple


@dataclass(frozen=True)
class DualSparseConfig:
    """DualSparse-MoE inference-system knobs (paper §4)."""
    enabled: bool = False
    partition_p: int = 2            # partial-transformation factor (P)
    t_drop: float = 0.08            # 1T-Drop threshold on normalized scores
    t_major: float = 0.07           # 2T: below -> drop entirely
    t_minor: float = 0.09           # 2T: above -> full expert; between -> major half
    importance: str = "abs_gate"    # gate | abs_gate | gate_up | abs_gate_up
    load_aware: bool = False        # §4.3 load-aware thresholding in EP
    t_max: float = 0.12             # max threshold for overloaded devices


@dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: str                     # dense | moe | ssm | hybrid | vlm | audio
    source: str                     # citation
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0               # 0 -> d_model // n_heads

    # --- attention ---
    attn_kind: str = "gqa"          # gqa | mla | none
    rope_theta: float = 1e4
    qkv_bias: bool = False
    sliding_window: int = 0         # 0 = full attention; >0 used by swa variant
    mrope_sections: Tuple[int, ...] = ()   # qwen2-vl M-RoPE sections (half-dim)

    # --- MLA (minicpm3 / deepseek-style) ---
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0

    # --- MLP ---
    mlp_kind: str = "swiglu"        # swiglu (3 mats) | gelu (2 mats)

    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    d_expert: int = 0               # per-expert intermediate size
    n_shared_experts: int = 0       # deepseek-style shared experts
    router_norm_topk: bool = True   # normalize top-k scores (qwen3/mixtral style)

    # --- SSM (mamba2 / zamba2) ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv_width: int = 4
    ssm_n_groups: int = 1

    # --- hybrid (zamba2): shared attention block every N mamba layers ---
    attn_every: int = 0

    # --- enc-dec / frontend stubs ---
    encoder_layers: int = 0
    n_frontend_tokens: int = 0      # audio frames / vision patches (stub)
    frontend: str = ""              # "" | audio | vision

    # --- misc ---
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    dualsparse: DualSparseConfig = dataclasses.field(default_factory=DualSparseConfig)

    # ------------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    @property
    def d_inner(self) -> int:
        """SSM inner width."""
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def has_attention(self) -> bool:
        return self.attn_kind != "none" or self.attn_every > 0

    def n_params(self) -> int:
        """Approximate parameter count (embeddings + blocks), for sanity tests."""
        d = self.d_model
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        per_layer = 0
        hd = self.resolved_head_dim
        if self.family in ("ssm", "hybrid"):
            di, ds = self.d_inner, self.ssm_state
            # in_proj(z,x,B,C,dt) + out_proj + conv + dt/A/D
            conv_ch = di + 2 * self.ssm_n_groups * ds
            per_layer = d * (2 * di + 2 * self.ssm_n_groups * ds + self.ssm_heads) \
                + di * d + conv_ch * self.ssm_conv_width + 3 * self.ssm_heads
            blocks = per_layer * self.n_layers
            if self.attn_every:
                # one shared attention block (+ its own ffn) reused
                blocks += d * hd * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * hd * d
                blocks += 3 * d * self.d_ff
            return emb + blocks
        if self.attn_kind == "mla":
            attn = d * self.q_lora_rank \
                + self.q_lora_rank * self.n_heads * (self.qk_nope_head_dim + self.qk_rope_head_dim) \
                + d * (self.kv_lora_rank + self.qk_rope_head_dim) \
                + self.kv_lora_rank * self.n_heads * (self.qk_nope_head_dim + self.v_head_dim) \
                + self.n_heads * self.v_head_dim * d
        else:
            attn = d * hd * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * hd * d
        n_mats = 3 if self.mlp_kind == "swiglu" else 2
        if self.is_moe:
            ffn = self.n_experts * 3 * d * self.d_expert + d * self.n_experts
            ffn += self.n_shared_experts * 3 * d * self.d_expert
        else:
            ffn = n_mats * d * self.d_ff
        per_layer = attn + ffn
        total_layers = self.n_layers + self.encoder_layers
        if self.encoder_layers:  # decoder cross-attn
            per_layer_dec = attn * 2 + ffn
            return emb + self.encoder_layers * (attn + ffn) + self.n_layers * per_layer_dec
        return emb + total_layers * per_layer

    def reduced(self) -> "ModelConfig":
        """CPU-smoke variant: same family/features, tiny dims."""
        kw = dict(
            n_layers=2,
            d_model=256,
            d_ff=512,
            vocab_size=512,
            head_dim=0,
        )
        if self.n_heads:
            kw["n_heads"] = 4
            kw["n_kv_heads"] = max(1, min(self.n_kv_heads, 2)) if self.n_kv_heads < self.n_heads else 4
        if self.is_moe:
            kw["n_experts"] = 4
            kw["top_k"] = 2
            kw["d_expert"] = 128
            kw["n_shared_experts"] = min(self.n_shared_experts, 1)
        if self.attn_kind == "mla":
            kw["q_lora_rank"] = 64
            kw["kv_lora_rank"] = 32
            kw["qk_nope_head_dim"] = 16
            kw["qk_rope_head_dim"] = 16
            kw["v_head_dim"] = 16
        if self.ssm_state:
            kw["ssm_state"] = 16
            kw["ssm_head_dim"] = 32
        if self.attn_every:
            kw["attn_every"] = 2  # hybrid pattern still exercised with 2 layers
        if self.encoder_layers:
            kw["encoder_layers"] = 2
        if self.n_frontend_tokens:
            kw["n_frontend_tokens"] = 16
        if self.mrope_sections:
            # half head_dim = 32 with 4 heads@64 -> sections sum to 32
            kw["mrope_sections"] = (16, 8, 8)
        if self.sliding_window:
            kw["sliding_window"] = 64
        return replace(self, **kw)


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                       # train | prefill | decode


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}
