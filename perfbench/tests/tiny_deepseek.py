"""A tiny DeepSeek-V2 configuration for the CPU tests: MLA without a
query LoRA (d 64, 4 heads, kv_lora 32, nope 16, rope 16, v 16), one dense
layer of 96 then 3 MoE layers of 8 experts of 32, top-2 not renormalised,
plus 2 shared experts; YaRN at the published factor and coefficients
over 32 original positions, so that the ramp runs across the rope
frequencies of positions a tiny prompt reaches."""
import copy

from perfbench.tests import tiny

YARN = {"rope_scaling_factor": 40.0, "rope_original_max_pos": 32,
        "rope_beta_fast": 32.0, "rope_beta_slow": 1.0, "rope_mscale": 0.707,
        "rope_mscale_all_dim": 0.707}

DIMS = {"n_layers": 4, "d_model": 64, "n_heads": 4, "n_experts": 8,
        "top_k": 2, "d_expert": 32, "vocab_size": 512,
        "rope_theta": 10000.0, "norm_eps": 1e-06, "attn_kind": "mla",
        "q_lora_rank": 0, "kv_lora_rank": 32, "qk_nope_head_dim": 16,
        "qk_rope_head_dim": 16, "v_head_dim": 16, "n_shared_experts": 2,
        "first_k_dense": 1, "d_ff": 96, "router_norm_topk": False, **YARN}

_FIELDS = ("n_layers", "d_model", "n_heads", "n_experts", "top_k",
           "d_expert", "vocab_size", "kv_lora_rank", "qk_nope_head_dim",
           "qk_rope_head_dim", "v_head_dim", "d_ff",
           "rope_original_max_pos")

CONFIG = {
    "name": "tiny-deepseek", "reference": "deepseek_v2",
    "port": {"arch": "deepseek-v2-lite",
             "fields": {**{k: DIMS[k] for k in _FIELDS}, "n_kv_heads": 4}},
    "dims": DIMS,
    "serving": copy.deepcopy(tiny.CONFIG["serving"]),
}

KEEPALL = {**CONFIG, "name": "tiny-deepseek-keepall",
           "serving": copy.deepcopy(tiny.KEEPALL["serving"])}

# the document mix at a tiny size: 2 shared 64-token documents, short
# questions and answers, chunks of 32 (a document is two chunks)
DOC = {
    "engine": {"kind": "paged", "n_slots": 4, "page_size": 16,
               "chunk_size": 32, "max_prompt_len": 96,
               "max_new_tokens": 16, "prefix_cache": True},
    "rate_per_s": 6.0,
    "prompt": {"shared_prefix": {"count": 2, "length": 64, "zipf_s": 1.0},
               "suffix": {"dist": "lognormal", "median": 12, "sigma": 0.6,
                          "min": 4, "max": 32}},
    "output": {"dist": "lognormal", "median": 8, "sigma": 0.5, "min": 4,
               "max": 16},
    "check": {"requests": 6},
}

# set from the tiny readings on the CPU, as tiny.LIMITS: sound runs read
# 0, the TF32 control above it
LIMITS = {"mean_logit_gap": {"limit": 2e-8}, "min_compared": {"limit": 5}}


def cell(config=CONFIG, mix=DOC, limits=LIMITS, name="tiny-deepseek.doc"):
    return tiny.cell(mix, name=name, config=config, limits=limits)
