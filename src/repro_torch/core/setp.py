"""Soft Expert-Tensor Parallelism (paper §3.3) and the ETP baseline over
``torch.distributed``, as ``src/repro/core/setp.py`` computes them under
``shard_map``.

S-ETP = partial transformation + plain EP. Each original expert is split
into P sub-experts placed *strided* across the EP axis (sub-expert ``id``
lives on rank ``id % D``), so the P halves of one expert sit on different
ranks while the communication stays a single AlltoAll each way (Fig. 5b).
Load-aware thresholds (§4.3) cost one all-reduce of a (D,) histogram.

The ETP baseline (Fig. 5a) shards whole experts over an ``ep`` axis and
each expert's d_ff over a ``tp`` axis: AlltoAll + AllGather on dispatch,
ReduceScatter + AlltoAll on return.

Every rank runs the JAX body on its own token block of the replicated
(B, S, d) activation (``distributed.token_block``) with the collectives of
``distributed.DistContext``, then the blocks are all-gathered back into
the replicated output shard_map's ``out_specs`` give JAX. Each rank holds
only its expert shard: the contiguous L = E*P/D placed sub-experts at its
``model`` coordinate (``shard_experts``). The local seating runs the fused
MoE kernel (or the grouped SwiGLU kernel on the buffer path) on operands
cast to the wire type, bfloat16 by default, as the JAX body does.

Both layers are differentiable: the block boundary, the weights' entry
and the collectives inside go through ``distributed.context``'s
differentiable forms, whose backward is JAX's ``shard_map`` transpose.
``kernels=False`` takes the route JAX trains through (the buffer path's
``expert_ffn`` einsum; the kernels have no backward).
"""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from ..distributed import context as dctx
from ..distributed.sharding import BATCH_AXES, TokenBlock, token_block
from . import dispatch as dispatch_mod
from . import drop as drop_mod
from . import gating
from . import moe as moe_mod


# ---------------------------------------------------------------------------
# Placement
# ---------------------------------------------------------------------------

def to_strided_order(w, n_dev: int):
    """Reorder the leading (sub-)expert axis from id order to placement
    order, so that a contiguous shard holds device d's sub-experts:
    id = loc * D + d  ->  placed[d * L + loc] = w[id]."""
    L = w.shape[0] // n_dev
    return w.reshape((L, n_dev) + tuple(w.shape[1:])).transpose(0, 1) \
        .reshape(w.shape).contiguous()


def place_params_strided(params: Dict, n_dev: int) -> Dict:
    out = dict(params)
    for k in ("w1", "w3", "w2"):
        out[k] = to_strided_order(params[k], n_dev)
    return out


def expert_shard(params: Dict, n_dev: int, coord: int) -> Dict:
    """The expert weights one rank holds (``P(expert_axis)`` of placed
    weights): sub-experts ``[coord * L, (coord + 1) * L)``, L = E*P/D;
    every other leaf as it is (replicated)."""
    L = params["w1"].shape[0] // n_dev
    out = dict(params)
    for k in ("w1", "w3", "w2"):
        out[k] = params[k][coord * L:(coord + 1) * L].clone()
    return out


def shard_experts(model, ctx, expert_axis: str = "model") -> None:
    """Keep only this rank's shard of every MoE layer's placed experts
    (IN PLACE: the other ranks' sub-experts are freed). The model must be
    prepared with ``n_ep_devices = ctx.size(expert_axis)``."""
    n_dev, coord = ctx.size(expert_axis), ctx.coord(expert_axis)
    with torch.no_grad():
        for blk in model.blocks:
            if blk.moe is not None:
                blk.moe.load_weights(expert_shard(blk.moe.weights(), n_dev,
                                                  coord))
                blk.moe.ep_shards = n_dev


# ---------------------------------------------------------------------------
# S-ETP body
# ---------------------------------------------------------------------------

def _ceil_mult(x: float, m: int = 8) -> int:
    return max(m, int(math.ceil(x / m) * m)) if m > 1 else \
        max(1, int(math.ceil(x)))


def _setp_body(wg, w1, w3, w2, x_loc, *, cfg, ctx, n_dev: int, axis: str,
               token_axes: tuple, policy, thresholds=None,
               cap_factor: float, local_cap_factor: float,
               cap_multiple: int = 8, wire_dtype=torch.bfloat16,
               tokens_on_axis: bool = True, collect_stats: bool = False,
               kernels: bool = True):
    """One rank's S-ETP MoE (``_setp_body`` of the JAX package, step for
    step). x_loc: (B_l, S_l, d); w1/w3/w2: this rank's L placed
    sub-experts. Returns ``(y_loc, overflow)`` or, with
    ``collect_stats``, ``(y_loc, stats)``; overflow and stats are summed
    over the token axes and the expert axis. ``kernels=False``: the
    buffer path's einsum, never a kernel."""
    p_factor = policy.partition_p
    use_kernel = policy.use_kernel and kernels
    Bl, Sl, d = x_loc.shape
    xt = x_loc.reshape(-1, d)
    T = xt.shape[0]
    L = w1.shape[0]                              # local sub-experts
    # the whole local expert computation runs in the wire type
    w1, w3, w2 = (w.to(wire_dtype) for w in (w1, w3, w2))

    r = gating.route(xt, wg, cfg.top_k, cfg.router_norm_topk)
    K = cfg.top_k
    dev = xt.device

    # --- partial transformation of the routing (Eq. 12) + keep mask ---
    sub = torch.arange(p_factor, dtype=r.idx.dtype, device=dev)
    sub_idx = (r.idx[:, :, None] * p_factor + sub).reshape(T, K * p_factor)
    combine = r.combine[:, :, None].expand(T, K, p_factor) \
        .reshape(T, K * p_factor)
    dev_of = sub_idx % n_dev
    loc_of = torch.div(sub_idx, n_dev, rounding_mode="floor")
    score = r.norm_score[:, :, None].expand(T, K, p_factor) \
        .reshape(T, K * p_factor)
    is_major = (sub_idx % p_factor) == 0 if p_factor > 1 else \
        torch.ones_like(sub_idx, dtype=torch.bool)

    # the token block is a distinct slice along the expert axis only when
    # the sequence is split over it (prefill); on decode it is replicated
    # there, and summing the identical copies would multiply every count
    sum_axes = token_axes + ((axis,) if tokens_on_axis else ())
    loads = None
    if policy.needs_loads:
        loads = dispatch_mod.group_histogram(dev_of, n_dev,
                                             dtype=torch.float32)
        for ax in sum_axes:
            loads = ctx.psum(loads, ax)
    keep = policy.sub_pair_keep(score, is_major, sub_idx, cfg, n_dev=n_dev,
                                loads=loads, thresholds=thresholds)

    stats = None
    if collect_stats:
        hist = dispatch_mod.group_histogram(sub_idx, L * n_dev, mask=keep)
        kf, km, dr = drop_mod.sub_pair_outcome_counts(keep, p_factor)
        for ax in sum_axes:
            hist, kf, km, dr = (ctx.psum(v, ax) for v in (hist, kf, km, dr))
        stats = {"expert_load": hist, "kept_full": kf, "kept_major": km,
                 "dropped_pairs": dr}

    Kp = K * p_factor
    cap = _ceil_mult(cap_factor * T * Kp / n_dev, cap_multiple)

    # --- dispatch: sort-based seating per destination rank; MAJOR-only
    # flags ride in the low bit of the id payload ---
    mflag = dispatch_mod.major_only_flags(keep, p_factor)
    plan_dev = dispatch_mod.sort_dispatch(dev_of, keep, n_groups=n_dev,
                                          capacity=cap)
    send_x = dispatch_mod.gather_rows(xt.to(wire_dtype), plan_dev, cap,
                                      index_div=Kp)
    payload = loc_of * 2 + mflag.to(loc_of.dtype)
    send_e = dispatch_mod.gather_rows(payload.reshape(-1), plan_dev, cap,
                                      fill=-1)

    # --- the S-ETP collective: ONE AlltoAll each way (Fig. 5b) ---
    recv_x = dctx.all_to_all(ctx, send_x, axis)
    recv_e = ctx.all_to_all(send_e, axis)         # ids: no gradient

    # --- local grouped expert FFN (mode-ordered rows) ---
    rx = recv_x.reshape(n_dev * cap, d)
    re2 = recv_e.reshape(-1)
    valid = re2 >= 0
    loc = torch.where(valid, torch.div(re2, 2, rounding_mode="floor"),
                      torch.zeros_like(re2))
    mfl = valid & ((re2 & 1) == 1)
    c2 = _ceil_mult(local_cap_factor * n_dev * cap / L, cap_multiple)
    plan_loc = dispatch_mod.sort_dispatch(loc, valid, n_groups=L,
                                          capacity=c2, major_only=mfl)
    fused = policy.fused_pipeline if kernels else False
    if fused is None:
        fused = dispatch_mod.prefer_fused_pipeline(
            rx.shape[0], L, use_kernel=use_kernel, device=rx.device)
    cf, cm = plan_loc.kernel_counts(c2)
    # each local group IS one sub-expert (the halves of an original expert
    # live on different ranks), so there is no minor-half region locally:
    # n_minor_start is the full width and counts_major only orders rows
    if fused:
        from ..kernels import ops as kops
        bc = min(128, c2)
        tok_s, w_s = dispatch_mod.sorted_pair_arrays(
            plan_loc, valid.to(torch.float32), pad=bc)
        out_tok = kops.fused_moe_pipeline(
            rx, w1, w3, w2, plan_loc.group_offsets, cf, cm, tok_s, w_s,
            capacity=c2, n_minor_start=w1.shape[-1],
            block_c=bc).to(wire_dtype)
    else:
        buf = dispatch_mod.gather_rows(rx, plan_loc, c2)
        if use_kernel:
            from ..kernels import ops as kops
            out_buf = kops.grouped_swiglu(buf, w1, w3, w2, counts_full=cf,
                                          counts_major=cm,
                                          n_minor_start=w1.shape[-1])
        else:
            out_buf = moe_mod.expert_ffn(w1, w3, w2, buf)
        out_tok = dispatch_mod.unpermute(out_buf, plan_loc).to(wire_dtype)
        out_tok = out_tok * valid[:, None].to(out_tok.dtype)

    # --- return AlltoAll + combine on the source rank ---
    back = dctx.all_to_all(ctx, out_tok.reshape(n_dev, cap, d), axis)
    back = F.pad(back, (0, 0, 0, 1))
    out_pair = back[plan_dev.group.long(), plan_dev.slot.long()]  # (T*Kp, d)
    w = combine.reshape(-1) * keep.reshape(-1).to(combine.dtype)
    y = (out_pair * w[:, None].to(out_pair.dtype)).reshape(T, Kp, d).sum(1)
    # kept pairs discarded by capacity overflow, summed over token_axes AND
    # the expert axis whatever the token layout (decode counts each of the
    # D identical copies: the JAX body's accounting, mirrored)
    overflow = plan_dev.overflow + plan_loc.overflow
    for ax in token_axes + (axis,):
        overflow = ctx.psum(overflow, ax)
    y = y.reshape(Bl, Sl, d).to(x_loc.dtype)
    if collect_stats:
        stats["overflow_pairs"] = overflow
        return y, stats
    return y, overflow


def setp_moe_forward(params: Dict, x, cfg, ctx, *,
                     expert_axis: str = "model", policy=None,
                     cap_factor: float = 1.15, local_cap_factor: float = 1.25,
                     cap_multiple: int = 8, wire_dtype=torch.bfloat16,
                     return_overflow: bool = False,
                     return_stats: bool = False, kernels: bool = True):
    """S-ETP MoE layer under a ``SparsityPolicy`` (default ``NoDrop``) on
    the ``DistContext`` ``ctx``. ``params``: this rank's layer — the router
    and any shared expert replicated, w1/w3/w2 its shard of experts
    prepared by the SAME policy with ``n_ep_devices =
    ctx.size(expert_axis)`` (``expert_shard``), and a ``per_layer``
    policy's ``thresholds``.

    x: (B, S, d), the same on every rank. The batch is split over (pod,
    data) where it divides, the sequence over ``expert_axis`` where it
    divides (prefill; decode keeps it replicated). Returns the replicated
    (B, S, d) output; ``return_overflow`` also returns the global count of
    kept token/sub-expert pairs discarded by capacity overflow;
    ``return_stats`` instead returns ``(y, stats)``, the ``obs`` per-layer
    dict summed over the mesh.

    Differentiable, with the gradients of JAX's ``shard_map``: ``wg``
    enters as ``P()`` (its gradient summed over every mesh axis), the
    expert shards as ``P(expert_axis)`` (summed over the token axes), x
    and y as their token blocks (``distributed.context.block_take`` /
    ``block_gather``); a per-layer ``thresholds`` takes no gradient.
    ``kernels=False`` runs the local experts through the einsum."""
    if policy is None:
        from .policy import NoDrop
        policy = NoDrop()
    n_dev = ctx.size(expert_axis)
    token_axes = tuple(a for a in BATCH_AXES if ctx.has(a))
    block = token_block(x.shape[0], x.shape[1], ctx, expert_axis)
    shard_axes = dctx.replicated_axes(ctx, split=(expert_axis,))
    w1, w3, w2 = (dctx.replicate(ctx, params[k], shard_axes)
                  for k in ("w1", "w3", "w2"))
    y_loc, aux = _setp_body(
        dctx.replicate(ctx, params["wg"], ctx.axes()), w1, w3, w2,
        dctx.block_take(ctx, x, block), cfg=cfg, ctx=ctx, n_dev=n_dev,
        axis=expert_axis,
        token_axes=token_axes, policy=policy,
        thresholds=params.get("thresholds"), cap_factor=cap_factor,
        local_cap_factor=local_cap_factor, cap_multiple=cap_multiple,
        wire_dtype=wire_dtype, tokens_on_axis=block.seq_axis is not None,
        collect_stats=return_stats, kernels=kernels)
    y = dctx.block_gather(ctx, y_loc, block)
    if "shared" in params:
        s = params["shared"]
        h = F.silu(x @ s["w1"]) * (x @ s["w3"])
        y = y + h @ s["w2"]
    if return_stats:
        return y, aux
    return (y, aux) if return_overflow else y


# ---------------------------------------------------------------------------
# ETP baseline (Fig. 5a): EP over `ep`, TP over `tp`
# ---------------------------------------------------------------------------

def _etp_body(wg, w1, w3, w2, x_loc, *, cfg, ctx, n_ep: int, n_tp: int,
              cap_factor: float, local_cap_factor: float):
    """w1/w3: (E_loc, d, f/tp); w2: (E_loc, f/tp, d). Tokens split over ep
    and replicated over tp: AlltoAll(ep) + AllGather(tp) dispatch, partial
    FFN, ReduceScatter(tp) + AlltoAll(ep) return."""
    Bl, Sl, d = x_loc.shape
    xt = x_loc.reshape(-1, d)
    T = xt.shape[0]
    L = w1.shape[0]
    r = gating.route(xt, wg, cfg.top_k, cfg.router_norm_topk)
    K = cfg.top_k
    dev_of = torch.div(r.idx, L, rounding_mode="floor")
    loc_of = r.idx % L
    cap = _ceil_mult(cap_factor * T * K / n_ep)
    plan_dev = dispatch_mod.sort_dispatch(dev_of, n_groups=n_ep,
                                          capacity=cap)
    send_x = dispatch_mod.gather_rows(xt, plan_dev, cap, index_div=K)
    send_e = dispatch_mod.gather_rows(loc_of.reshape(-1), plan_dev, cap,
                                      fill=-1)
    # dispatch: AlltoAll over ep, then AllGather over tp (each tp rank
    # routed its own copy of the tokens; the experts need the ep group's)
    recv_x = dctx.all_gather(ctx, dctx.all_to_all(ctx, send_x, "ep"), "tp")
    recv_e = ctx.all_gather(ctx.all_to_all(send_e, "ep"), "tp")
    rx = recv_x.reshape(-1, d)
    re = recv_e.reshape(-1)
    valid = re >= 0
    c2 = _ceil_mult(local_cap_factor * rx.shape[0] / L)
    plan_loc = dispatch_mod.sort_dispatch(
        torch.where(valid, re, torch.zeros_like(re)), valid, n_groups=L,
        capacity=c2)
    buf = dispatch_mod.gather_rows(rx, plan_loc, c2)
    out_buf = moe_mod.expert_ffn(w1, w3, w2, buf)        # partial over f/tp
    out_tok = dispatch_mod.unpermute(out_buf, plan_loc)
    out_tok = out_tok * valid[:, None].to(rx.dtype)
    out_tok = out_tok.reshape(n_tp, n_ep, cap, d)
    # return: ReduceScatter over tp (sum the partial FFN outputs, keep this
    # rank's copy), then AlltoAll over ep
    back = dctx.all_to_all(ctx, dctx.psum_scatter(ctx, out_tok, "tp"), "ep")
    back = F.pad(back, (0, 0, 0, 1))
    out_pair = back[plan_dev.group.long(), plan_dev.slot.long()]
    w = r.combine.reshape(-1)
    y = (out_pair * w[:, None].to(out_pair.dtype)).reshape(T, K, d).sum(1)
    return y.reshape(Bl, Sl, d).to(x_loc.dtype)


def etp_shard(params: Dict, ctx, ep_axis: str = "ep",
              tp_axis: str = "tp") -> Dict:
    """This rank's ETP weights: experts split over ``ep_axis`` and each
    expert's d_ff over ``tp_axis`` (``P(ep, None, tp)`` for w1/w3,
    ``P(ep, tp, None)`` for w2); the router replicated."""
    n_ep, n_tp = ctx.size(ep_axis), ctx.size(tp_axis)
    ie, it = ctx.coord(ep_axis), ctx.coord(tp_axis)
    E, _, f = params["w1"].shape
    el, fl = E // n_ep, f // n_tp
    es, fs = slice(ie * el, (ie + 1) * el), slice(it * fl, (it + 1) * fl)
    return {"wg": params["wg"],
            "w1": params["w1"][es, :, fs].contiguous(),
            "w3": params["w3"][es, :, fs].contiguous(),
            "w2": params["w2"][es, fs, :].contiguous()}


def etp_moe_forward(params: Dict, x, cfg, ctx, *, ep_axis: str = "ep",
                    tp_axis: str = "tp", cap_factor: float = 1.3,
                    local_cap_factor: float = 2.0):
    """ETP baseline on ``ctx`` (a mesh with ``ep`` and ``tp`` axes).
    ``params``: this rank's ``etp_shard``. x: (B, S, d), the same on every
    rank, its batch split over ``ep_axis``; returns the replicated
    output. Differentiable as ``setp_moe_forward``: ``wg`` enters as
    ``P()``, the expert shards split over both axes, x and y as blocks
    split over ``ep_axis`` and replicated over ``tp_axis``."""
    n_ep, n_tp = ctx.size(ep_axis), ctx.size(tp_axis)
    B = x.shape[0]
    if B % n_ep:
        raise ValueError(f"ETP splits the batch over {ep_axis!r}: {B} rows "
                         f"do not divide over {n_ep} ranks")
    bl = B // n_ep
    i = ctx.coord(ep_axis)
    block = TokenBlock(i * bl, (i + 1) * bl, 0, x.shape[1], (ep_axis,), None)
    shard_axes = dctx.replicated_axes(ctx, split=(ep_axis, tp_axis))
    w1, w3, w2 = (dctx.replicate(ctx, params[k], shard_axes)
                  for k in ("w1", "w3", "w2"))
    y_loc = _etp_body(dctx.replicate(ctx, params["wg"], ctx.axes()), w1, w3,
                      w2, dctx.block_take(ctx, x, block), cfg=cfg, ctx=ctx,
                      n_ep=n_ep, n_tp=n_tp, cap_factor=cap_factor,
                      local_cap_factor=local_cap_factor)
    return dctx.block_gather(ctx, y_loc, block)
