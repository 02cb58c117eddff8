"""MoE layer: the exact dense reference and the capacity-based dispatch
forward (the fused kernel pipeline, or the buffer path: gather -> grouped
FFN -> unpermute, whose FFN is the grouped SwiGLU kernel under
``use_kernel`` and an einsum otherwise).

Params are name -> tensor dicts in the JAX layouts: wg (d, E); w1, w3
(E, d, f); w2 (E, f, d); optional "shared" {w1, w3, w2} dense expert;
optional "thresholds" (2,) float32, the layer's calibrated
(T²_major, T²_minor) under the ``per_layer`` policy.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..models.layers import MLP, normal, tensors_of
from . import dispatch as dispatch_mod
from . import gating
from .drop import SubExpertPairs, MODE_FULL, expand_pairs_2t


class MoELayer(nn.Module):
    """One MoE layer's weights: router wg (d, E), experts w1/w3 (E, d, f)
    and w2 (E, f, d), an optional shared dense expert, and the layer's
    ``thresholds`` once a ``per_layer`` policy has prepared it (else
    None)."""

    def __init__(self, cfg, *, device: torch.device,
                 generator: Optional[torch.Generator]):
        super().__init__()
        d, E, f = cfg.d_model, cfg.n_experts, cfg.d_expert
        kw = dict(device=device, generator=generator)
        self.wg = normal((d, E), **kw)
        self.w1 = normal((E, d, f), **kw)
        self.w3 = normal((E, d, f), **kw)
        self.w2 = normal((E, f, d), **kw)
        self.shared = (MLP(d, cfg.n_shared_experts * f, **kw)
                       if cfg.n_shared_experts else None)
        self.register_parameter("thresholds", None)
        # S-ETP: the layer holds 1 / ep_shards of the placed sub-experts
        # (``core.setp.shard_experts``); 1 when it holds them all
        self.ep_shards = 1

    def weights(self) -> Dict:
        """The layer as the name -> tensor dict the core functions take."""
        out = tensors_of(self)
        if self.shared is not None:
            out["shared"] = tensors_of(self.shared)
        return out

    def load_weights(self, params: Dict) -> None:
        """Replace the weights (e.g. by their prepared, partitioned form),
        and the per-layer thresholds when ``params`` holds them."""
        keys = ("wg", "w1", "w3", "w2") + (
            ("thresholds",) if "thresholds" in params else ())
        for k in keys:
            setattr(self, k, nn.Parameter(params[k].contiguous(),
                                          requires_grad=False))
        if self.shared is not None:
            for k, v in params["shared"].items():
                setattr(self.shared, k, nn.Parameter(v.contiguous(),
                                                     requires_grad=False))


def expert_ffn(w1, w3, w2, x):
    """Batched SwiGLU over experts: x (E, C, d) -> (E, C, d)."""
    h = F.silu(torch.einsum("ecd,edf->ecf", x, w1))
    h = h * torch.einsum("ecd,edf->ecf", x, w3)
    return torch.einsum("ecf,efd->ecd", h, w2)


def _shared_out(params: Dict, x):
    if "shared" not in params:
        return 0.0
    s = params["shared"]
    h = F.silu(x @ s["w1"]) * (x @ s["w3"])
    return h @ s["w2"]


def aux_loss_for(params: Dict, x, cfg):
    """Switch-style load-balance auxiliary loss for this MoE layer."""
    r = gating.route(x, params["wg"], cfg.top_k, cfg.router_norm_topk)
    E = params["wg"].shape[1]
    return gating.load_balance_aux_loss(r.probs, r.idx, E)


def route_dualsparse(params: Dict, x, cfg, *,
                     thresholds=None) -> SubExpertPairs:
    """Routing with the partial-transformation expansion and the 2T-Drop
    keep mask, for params already partitioned with
    ``cfg.dualsparse.partition_p``. The thresholds are, in this order of
    precedence: ``thresholds``, a (t_major, t_minor) pair whose entries
    may be scalars or per-token (T,); the layer's calibrated
    ``params["thresholds"]``; ``cfg.dualsparse``'s."""
    ds = cfg.dualsparse
    r = gating.route(x, params["wg"], cfg.top_k, cfg.router_norm_topk)
    if thresholds is not None:
        t_major, t_minor = thresholds
    elif params.get("thresholds") is not None:
        t_major, t_minor = params["thresholds"][0], params["thresholds"][1]
    else:
        t_major, t_minor = ds.t_major, ds.t_minor
    return expand_pairs_2t(r.idx, r.combine, r.norm_score, ds.partition_p,
                           t_major, t_minor)


def route_plain(params: Dict, x, cfg, n_experts=None) -> SubExpertPairs:
    """Routing with no partition/drop (P=1, keep everything)."""
    E = n_experts if n_experts is not None else params["wg"].shape[1]
    k = cfg.top_k if E == cfg.n_experts else cfg.top_k * (E // cfg.n_experts)
    r = gating.route(x, params["wg"], k, cfg.router_norm_topk)
    return SubExpertPairs(idx=r.idx, combine=r.combine,
                          keep=torch.ones_like(r.idx, dtype=torch.bool),
                          modes=torch.full_like(r.idx, MODE_FULL))


def moe_forward_ref(params: Dict, x, cfg,
                    pairs: Optional[SubExpertPairs] = None):
    """Dense oracle: every expert computed for every token. x: (T, d)."""
    E = params["w1"].shape[0]
    if pairs is None:
        pairs = route_plain(params, x, cfg, n_experts=E)
    h = F.silu(torch.einsum("td,edf->etf", x, params["w1"]))
    h = h * torch.einsum("td,edf->etf", x, params["w3"])
    outs = torch.einsum("etf,efd->etd", h, params["w2"])
    w = pairs.combine * pairs.keep.to(pairs.combine.dtype)       # (T, K')
    sel = F.one_hot(pairs.idx.long(), E).to(w.dtype) * w[..., None]
    y = torch.einsum("tke,etd->td", sel, outs).to(x.dtype)
    return y + _shared_out(params, x)


def capacity_for(n_tokens: int, k_eff: int, n_experts: int,
                 capacity_factor: float = 1.25, multiple: int = 8) -> int:
    cap = int(capacity_factor * n_tokens * k_eff / n_experts)
    return max(multiple, (cap + multiple - 1) // multiple * multiple)


def dispatch_indices(pairs: SubExpertPairs, n_experts: int, capacity: int):
    """Per-pair (expert, slot) coordinates from the sort plan
    (``core.dispatch.sort_dispatch``); dropped and over-capacity pairs get
    slot == capacity. Returns ``(group, slot, overflow)``: ``overflow``
    counts the KEPT pairs discarded because their expert was full."""
    plan = dispatch_mod.sort_dispatch(pairs.idx, pairs.keep,
                                      n_groups=n_experts, capacity=capacity)
    return plan.group, plan.slot, plan.overflow


def _pairs_partition_p(pairs: SubExpertPairs) -> int:
    """Partial-transformation factor encoded in an expanded pair list."""
    Kp = pairs.idx.shape[1]
    K = pairs.modes.shape[1]
    return Kp // K if K and Kp % K == 0 else 1


def _sub_pair_overflow(plan, pairs: SubExpertPairs, fused, capacity: int):
    """Capacity-overflow drops of an ORIGINAL-expert (fused) plan counted in
    SUB-expert pairs: a fused row stands for every kept half of its pair."""
    T, K = fused.group.shape
    p = pairs.idx.shape[1] // K
    kept_halves = pairs.keep.reshape(T, K, p).sum(-1, dtype=torch.int32)
    overflowed = fused.keep.reshape(-1) & (plan.slot.reshape(-1) >= capacity)
    return torch.where(overflowed, kept_halves.reshape(-1),
                       kept_halves.new_zeros(())).sum(dtype=torch.int32)


def fused_pipeline_args(params: Dict, pairs: SubExpertPairs, p: int,
                        capacity: int, mode_grouped: bool,
                        block_c: int = 128):
    """The plan-derived arguments of ``kernels.ops.fused_moe_pipeline`` and
    the overflow count, for the layout the forward uses.

    ``mode_grouped`` (P > 1): one row per ORIGINAL pair, sub-expert weights
    fused by ``p_factor``. Otherwise rows are sub-expert pairs against the
    weights' native expert axis (``n_minor_start`` = the full width).
    Overflow is in SUB-pair units on both layouts. Returns
    ``(kernel_kwargs, overflow)``; kwargs hold every argument but x."""
    bc = min(block_c, capacity)
    if mode_grouped and p > 1:
        E = params["w1"].shape[0] // p
        fused = dispatch_mod.fuse_sub_pairs(pairs, p)
        K = fused.group.shape[1]
        plan = dispatch_mod.sort_dispatch(fused.group, fused.keep,
                                          n_groups=E, capacity=capacity,
                                          major_only=fused.major_only)
        w = fused.combine * fused.keep.to(fused.combine.dtype)
        overflow = _sub_pair_overflow(plan, pairs, fused, capacity)
        p_factor, n_minor_start = p, None
    else:
        E = params["w1"].shape[0]
        K = pairs.idx.shape[1]
        plan = dispatch_mod.sort_dispatch(pairs.idx, pairs.keep,
                                          n_groups=E, capacity=capacity)
        w = pairs.combine * pairs.keep.to(pairs.combine.dtype)
        overflow = plan.overflow
        p_factor, n_minor_start = 1, params["w1"].shape[-1]
    tok_sorted, w_sorted = dispatch_mod.sorted_pair_arrays(
        plan, w, index_div=K, pad=bc)
    cf, cm = plan.kernel_counts(capacity)
    kwargs = dict(w1=params["w1"], w3=params["w3"], w2=params["w2"],
                  group_offsets=plan.group_offsets, counts_full=cf,
                  counts_major=cm, tok_sorted=tok_sorted,
                  combine_sorted=w_sorted, capacity=capacity,
                  p_factor=p_factor, n_minor_start=n_minor_start,
                  block_c=block_c)
    return kwargs, overflow


def _fused_pipeline_dispatch(params: Dict, x, cfg, pairs: SubExpertPairs,
                             p: int, capacity: int, mode_grouped: bool,
                             block_c: int = 128, block_f: int = 128,
                             streamed: bool = True):
    """The fused pipeline: the kernel consumes the DispatchPlan directly —
    gathering token rows from the flat (T, d) array, running the
    mode-ordered grouped SwiGLU with minor-half skipping, and combining
    weighted rows per token — with no (E, capacity, d) buffer."""
    from ..kernels import ops as kops
    kwargs, overflow = fused_pipeline_args(params, pairs, p, capacity,
                                           mode_grouped, block_c)
    y = kops.fused_moe_pipeline(x, block_f=block_f, streamed=streamed,
                                **kwargs)
    return y, overflow


def grouped_swiglu_args(params: Dict, x, pairs: SubExpertPairs, p: int,
                        capacity: int, mode_grouped: bool):
    """The buffer path's arguments of ``kernels.ops.grouped_swiglu``, and
    what the unpermute and combine after it need.

    ``mode_grouped`` (P > 1): one row per (token, ORIGINAL expert) pair,
    FULL rows first and MAJOR-only rows second, sub-expert weights fused by
    ``p_factor`` so ``counts_major`` lets the kernel skip the minor half
    (exact w.r.t. the sub-expert path under partial transformation,
    Eq. 13). Otherwise rows are sub-expert pairs against the weights'
    native expert axis (``n_minor_start`` = the full width). Returns
    ``(kernel_kwargs, plan, weights (T*K,), K, overflow)``; overflow is in
    SUB-pair units on both layouts."""
    if mode_grouped and p > 1:
        E = params["w1"].shape[0] // p
        fused = dispatch_mod.fuse_sub_pairs(pairs, p)
        K = fused.group.shape[1]
        plan = dispatch_mod.sort_dispatch(fused.group, fused.keep,
                                          n_groups=E, capacity=capacity,
                                          major_only=fused.major_only)
        w = fused.combine * fused.keep.to(fused.combine.dtype)
        overflow = _sub_pair_overflow(plan, pairs, fused, capacity)
        p_factor, n_minor_start = p, None
    else:
        E = params["w1"].shape[0]
        K = pairs.idx.shape[1]
        plan = dispatch_mod.sort_dispatch(pairs.idx, pairs.keep,
                                          n_groups=E, capacity=capacity)
        w = pairs.combine * pairs.keep.to(pairs.combine.dtype)
        overflow = plan.overflow
        p_factor, n_minor_start = 1, params["w1"].shape[-1]
    cf, cm = plan.kernel_counts(capacity)
    kwargs = dict(x=dispatch_mod.gather_rows(x, plan, capacity, index_div=K),
                  w1=params["w1"], w3=params["w3"], w2=params["w2"],
                  counts_full=cf, counts_major=cm, p_factor=p_factor,
                  n_minor_start=n_minor_start)
    return kwargs, plan, w.reshape(-1), K, overflow


def moe_forward_dispatch(params: Dict, x, cfg,
                         pairs: Optional[SubExpertPairs] = None,
                         capacity_factor: float = 1.25,
                         capacity: Optional[int] = None,
                         use_kernel: bool = False,
                         return_overflow: bool = False,
                         mode_grouped: bool = False,
                         fused_pipeline: Optional[bool] = None,
                         fused_streamed: bool = True):
    """Sort-based dispatch forward. Exact w.r.t. the reference whenever no
    token exceeds capacity.

    ``fused_pipeline`` routes through the fused kernel (dispatch gather,
    grouped SwiGLU with minor-half skipping under ``mode_grouped``, and
    weighted combine); ``None`` resolves via
    ``core.dispatch.prefer_fused_pipeline`` — fused on a CUDA device, fused
    iff ``use_kernel`` on the CPU. Otherwise the buffer path gathers into
    (E, C, d) buffers, runs the FFN and unpermutes: with ``use_kernel`` the
    FFN is the grouped SwiGLU kernel — over ORIGINAL-expert buffers with
    minor-half skipping under ``mode_grouped`` (P > 1), over sub-expert
    buffers otherwise — and without it an einsum over full sub-experts.
    ``return_overflow`` also returns the overflow count (sub-pair units)."""
    T, d = x.shape
    E = params["w1"].shape[0]
    if pairs is None:
        pairs = route_plain(params, x, cfg, n_experts=E)
    if capacity is None:
        capacity = capacity_for(T, pairs.idx.shape[1], E, capacity_factor)

    p = _pairs_partition_p(pairs)
    if fused_pipeline is None:
        fused_pipeline = dispatch_mod.prefer_fused_pipeline(
            T, E, use_kernel=use_kernel, device=x.device)
    if fused_pipeline:
        y, overflow = _fused_pipeline_dispatch(
            params, x, cfg, pairs, p, capacity,
            mode_grouped=mode_grouped and p > 1, streamed=fused_streamed)
        out = y.to(x.dtype) + _shared_out(params, x)
        return (out, overflow) if return_overflow else out

    kwargs, plan, w, K, overflow = grouped_swiglu_args(
        params, x, pairs, p, capacity,
        mode_grouped=use_kernel and mode_grouped and p > 1)
    if use_kernel:
        from ..kernels import ops as kops
        out_buf = kops.grouped_swiglu(**kwargs)
    else:
        out_buf = expert_ffn(params["w1"], params["w3"], params["w2"],
                             kwargs["x"])
    gathered = dispatch_mod.unpermute(out_buf, plan)            # (T*K, d)
    y = gathered * w[:, None].to(gathered.dtype)
    y = y.reshape(T, K, d).sum(dim=1)
    out = y.to(x.dtype) + _shared_out(params, x)
    return (out, overflow) if return_overflow else out
