"""Operations and bytes, computed from shapes and the routing outcome,
never from which kernel ran; the peaks they are held against are in
``peaks.json`` beside this file."""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Iterable, Optional

import numpy as np

from . import weights as W

PEAKS = json.loads((Path(__file__).with_name("peaks.json")).read_text())


def swiglu_flops(rows: int, d: int, f: int) -> int:
    """x W1, x W3 (d -> f) and h W2 (f -> d) for ``rows`` rows."""
    return 6 * rows * d * f


def fused_call_cost(n_tokens: int, d: int, f_sub: int, p: int, n_pos: int,
                    elem: int, counts_full, counts_major):
    """(flops, bytes) one call into the fused MoE kernel needs: each
    original expert's FULL rows over all its P sub-experts' neurons, its
    MAJOR-only rows over sub-expert 0's; every expert weight it touches
    read once (the whole expert when any row is FULL, else the MAJOR
    half), the tokens read once, the float32 output written once, and the
    pair maps (token id and combine weight per sorted row, offsets and
    two counts per expert)."""
    cf = np.asarray(counts_full, dtype=np.int64)
    cm = np.asarray(counts_major, dtype=np.int64)
    flops = swiglu_flops(int(cf.sum()), d, f_sub * p) + \
        swiglu_flops(int(cm.sum()), d, f_sub)
    neurons = f_sub * p * int((cf > 0).sum()) + \
        f_sub * int(((cf == 0) & (cm > 0)).sum())
    nbytes = elem * (n_tokens * d + 3 * d * neurons) + 4 * n_tokens * d \
        + 8 * n_pos + 12 * cf.size
    return flops, nbytes


def bound_s(flops: float, nbytes: float, peaks: Optional[Dict] = None):
    """The least time the card could take: the larger of the operations
    at the float32-operand tensor-core rate and the bytes at the HBM
    rate."""
    peaks = peaks or PEAKS
    return max(flops / peaks["tf32_flops"], nbytes / peaks["hbm_bytes_s"])


def fused_roofline_pct(calls: Iterable, kernel_s: float) -> Optional[float]:
    """The fused kernel's share of its roofline over a traced window: the
    calls' summed bounds over the expert kernels' device time."""
    total = 0.0
    n = 0
    for c in calls:
        fl, nb = fused_call_cost(c.n_tokens, c.d, c.f_sub, c.p_factor,
                                 c.n_pos, c.elem_bytes,
                                 c.counts_full.cpu().numpy(),
                                 c.counts_major.cpu().numpy())
        total += bound_s(fl, nb)
        n += 1
    if not n or kernel_s <= 0:
        return None
    return 100.0 * total / kernel_s


def attention_flops(dims: Dict, ctx: float):
    """(projections, core) FLOPs of one position in one attention layer
    attending ``ctx`` keys. GQA: q, k, v and out projections, QK^T and PV
    over ``ctx``. MLA as published, not absorbed: the query (with or
    without its LoRA), the latent and rope key, the latent's decompression
    into every head's key and value, the out projection; QK^T at nope +
    rope and PV at v over ``ctx``."""
    d, h = dims["d_model"], dims["n_heads"]
    if W.layer_kind(dims, "attn_kind") == "gqa":
        D, hkv = dims["head_dim"], dims["n_kv_heads"]
        return (2 * d * (h * D + 2 * hkv * D) + 2 * h * D * d,
                4 * h * D * ctx)
    rq, rkv, dn, dr, dv = (W.layer_kind(dims, k) for k in (
        "q_lora_rank", "kv_lora_rank", "qk_nope_head_dim",
        "qk_rope_head_dim", "v_head_dim"))
    qk = dn + dr
    q = 2 * d * rq + 2 * rq * h * qk if rq else 2 * d * h * qk
    proj = q + 2 * d * (rkv + dr) + 2 * rkv * h * (dn + dv) + 2 * h * dv * d
    return proj, 2 * h * qk * ctx + 2 * h * dv * ctx


def position_flops(dims: Dict, ctx: float, keep_share: float) -> float:
    """Model FLOPs of one position through every layer, attending ``ctx``
    keys, with ``keep_share`` of its routed expert sub-pairs kept (the
    head is counted apart): each layer's attention (``attention_flops``)
    and feed-forward: a dense layer's SwiGLU of ``d_ff``, or the router,
    the kept share of the routed experts and the shared experts, which
    are never dropped."""
    d, n_dense = dims["d_model"], W.layer_kind(dims, "first_k_dense")
    proj, core = attention_flops(dims, ctx)
    router = 2 * d * dims["n_experts"]
    sub = dims["d_expert"] // 2
    experts = dims["top_k"] * 2 * keep_share * swiglu_flops(1, d, sub)
    shared = swiglu_flops(
        1, d, W.layer_kind(dims, "n_shared_experts") * dims["d_expert"])
    dense = swiglu_flops(1, d, W.layer_kind(dims, "d_ff"))
    return (dims["n_layers"] - n_dense) * (
        proj + core + router + experts + shared) + \
        n_dense * (proj + core + dense)


def head_flops(dims: Dict) -> float:
    return 2 * dims["d_model"] * dims["vocab_size"]


def mfu_pct(run) -> Optional[float]:
    """Model FLOPs the window's served tokens needed, over its seconds,
    over the TF32 peak. Counted: every prompt position prefilled and every
    decode position through every layer at the position's context
    (``position_flops``: attention by its kind, a dense layer's SwiGLU, or
    the router, the kept share of the routed expert sub-pairs and the
    shared experts; the share from the engine's counters, whose padding
    rows set it but add no positions), and the head at each position that
    yielded a token.
    Prompt positions come from the paged engine's ``prefill_tokens``
    counter, each at the mean context of the prompts' positions (their
    exact positions depend on prefix hits), or from the continuous
    engine's ``prefill_insert`` spans, at their exact contexts."""
    c, dims, window = run.counters, run.dims, run.main_s
    total = c["kept_full"] + c["kept_major"] + c["dropped"]
    if not total:
        return None
    keep = (c["kept_full"] + c["kept_major"]) / total
    fl = 0.0
    for s in run.served:
        n = sum(1 for t in s.stamps if t <= window)
        # decode position j (j >= 1) attends the prompt and j tokens
        fl += n * head_flops(dims)
        if n > 1:
            fl += (n - 1) * position_flops(dims, s.n_prompt + n / 2, keep)
    if "prefill_tokens" in c:
        seen = [s.n_prompt for s in run.served
                if s.submitted_s is not None and s.submitted_s <= window]
        if seen:
            ctx = sum(p * (p + 1) / 2 for p in seen) / sum(seen)
            fl += c["prefill_tokens"] * position_flops(dims, ctx, keep)
    else:
        for _, _, _, args in run.main_spans("prefill_insert"):
            p = args["prompt_len"]
            fl += p * position_flops(dims, (p + 1) / 2, keep)
    return 100.0 * fl / window / PEAKS["tf32_flops"]
