"""MoE layer: the exact dense reference, the capacity-based dispatch
forward, and the one place each layer call's path is chosen.

``expert_path`` resolves the path of a call from the policy's hints, the
device and the call:

  * ``route_plan``: ``kernels.ops.moe_route_plan``'s launch pair gives the
    routing, keep mask, plan and obs counters, then the fused kernel runs;
  * ``fused``: the composed routing (``policy.route``), then the fused
    kernel (dispatch gather, grouped SwiGLU with minor-half skipping and
    weighted combine, with no (E, capacity, d) buffer);
  * ``grouped``: the buffer path, gather -> grouped SwiGLU kernel ->
    unpermute;
  * ``einsum``: the buffer path with an einsum FFN, the differentiable
    route training takes.

``moe_layer_forward`` is a served layer call's entry and ``expert_runner``
runs every local expert FFN: this module's paths and the S-ETP local
seating (``core.setp``).

Params are name -> tensor dicts in the JAX layouts: wg (d, E); w1, w3
(E, d, f); w2 (E, f, d); optional "shared" {w1, w3, w2} dense expert;
optional "thresholds" (2,) float32, the layer's calibrated
(T²_major, T²_minor) under the ``per_layer`` policy.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..models.layers import MLP, normal, tensors_of
from ..obs.tracing import layer
from . import dispatch as dispatch_mod
from . import drop as drop_mod
from . import gating
from .drop import SubExpertPairs, MODE_FULL, expand_pairs_2t

ROUTE_PLAN, FUSED, GROUPED, EINSUM = "route_plan", "fused", "grouped", "einsum"
# the fused kernel's row block: the sorted pair arrays' trailing pad (at
# most the capacity) and the wrapper's block_c / block_f
BLOCK = 128


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


def _with_shared(params: Dict, x, y):
    """The routed experts' output ``y`` in x's dtype, plus the shared
    experts' SwiGLU over every token (never dropped, in the ``moe.shared``
    span) when the layer has them."""
    y = y.to(x.dtype)
    if "shared" not in params:
        return y
    with layer("moe.shared"):
        s = params["shared"]
        h = F.silu(x @ s["w1"]) * (x @ s["w3"])
        shared = h @ s["w2"]
    return y + shared


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
    return _with_shared(params, x, torch.einsum("tke,etd->td", sel, outs))


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


def expert_path(policy, device: torch.device, *, kernels: bool = True,
                two_t: bool = False) -> str:
    """The path of one MoE layer call (``ROUTE_PLAN``, ``FUSED``,
    ``GROUPED`` or ``EINSUM``); the one reader of the policy's
    ``use_kernel`` and ``fused_pipeline`` hints.

    ``kernels=False`` (training: the kernels have no backward) takes the
    einsum. Otherwise the fused kernel runs where ``fused_pipeline`` says
    so; where it is None, always on a CUDA device and with ``use_kernel``
    on the CPU (whose kernel wrappers run their plain versions). A fused
    call takes the route plan on a CUDA device when the plan is over
    original experts (``kernel_mode_grouping``: P > 1) and ``two_t``, the
    layer's keep rule a 2T threshold pair (``policy.two_t_thresholds``).
    Off the fused kernel, ``use_kernel`` picks the grouped SwiGLU kernel
    over the einsum. All paths agree to fp tolerance."""
    if not kernels:
        return EINSUM
    cuda = device.type == "cuda"
    fused = policy.fused_pipeline
    if fused is None:
        fused = cuda or policy.use_kernel
    if not fused:
        return GROUPED if policy.use_kernel else EINSUM
    if two_t and cuda and policy.kernel_mode_grouping:
        return ROUTE_PLAN
    return FUSED


class _Hints(NamedTuple):
    """``moe_forward_dispatch``'s path arguments as ``expert_path`` reads
    a policy's."""
    use_kernel: bool
    fused_pipeline: Optional[bool]
    kernel_mode_grouping: bool


def _dispatch_plan(params: Dict, pairs: SubExpertPairs, p: int,
                   capacity: int, grouped: bool):
    """The dispatch layout of one layer call and its sort plan.

    ``grouped`` (P > 1): one row per ORIGINAL pair, FULL rows first and
    MAJOR-only rows second, sub-expert weights fused by ``p_factor`` so
    ``counts_major`` lets the kernels skip the minor half (exact w.r.t. the
    sub-expert path under partial transformation, Eq. 13). Otherwise rows
    are sub-expert pairs against the weights' native expert axis
    (``n_minor_start`` = the full width). Returns ``(plan, weights (T, K),
    p_factor, n_minor_start, overflow)``; overflow is in SUB-pair units on
    both layouts."""
    if grouped and p > 1:
        fused = dispatch_mod.fuse_sub_pairs(pairs, p)
        plan = dispatch_mod.sort_dispatch(
            fused.group, fused.keep, n_groups=params["w1"].shape[0] // p,
            capacity=capacity, major_only=fused.major_only)
        w = fused.combine * fused.keep.to(fused.combine.dtype)
        return plan, w, p, None, _sub_pair_overflow(plan, pairs, fused,
                                                    capacity)
    plan = dispatch_mod.sort_dispatch(pairs.idx, pairs.keep,
                                      n_groups=params["w1"].shape[0],
                                      capacity=capacity)
    w = pairs.combine * pairs.keep.to(pairs.combine.dtype)
    return plan, w, 1, params["w1"].shape[-1], plan.overflow


def _fused_args(plan, weights, capacity: int, index_div: int):
    """The fused kernel's plan arguments, in its order: group_offsets,
    counts_full, counts_major, tok_sorted, combine_sorted."""
    cf, cm = plan.kernel_counts(capacity)
    tok_sorted, w_sorted = dispatch_mod.sorted_pair_arrays(
        plan, weights, index_div=index_div, pad=min(BLOCK, capacity))
    return plan.group_offsets, cf, cm, tok_sorted, w_sorted


def fused_pipeline_args(params: Dict, pairs: SubExpertPairs, p: int,
                        capacity: int, mode_grouped: bool):
    """The plan-derived arguments of ``kernels.ops.fused_moe_pipeline`` on
    ``_dispatch_plan``'s layout (``mode_grouped``: one row per ORIGINAL
    pair), and the overflow count. Returns ``(kernel_kwargs, overflow)``;
    kwargs hold every argument but x."""
    plan, w, p_factor, n_minor_start, overflow = _dispatch_plan(
        params, pairs, p, capacity, mode_grouped)
    offsets, cf, cm, tok_sorted, w_sorted = _fused_args(plan, w, capacity,
                                                        w.shape[1])
    kwargs = dict(w1=params["w1"], w3=params["w3"], w2=params["w2"],
                  group_offsets=offsets, counts_full=cf, counts_major=cm,
                  tok_sorted=tok_sorted, combine_sorted=w_sorted,
                  capacity=capacity, p_factor=p_factor,
                  n_minor_start=n_minor_start)
    return kwargs, overflow


def grouped_swiglu_args(params: Dict, x, pairs: SubExpertPairs, p: int,
                        capacity: int, mode_grouped: bool):
    """The buffer path's arguments of ``kernels.ops.grouped_swiglu`` on
    ``_dispatch_plan``'s layout, and what the unpermute and combine after
    it need. Returns ``(kernel_kwargs, plan, weights (T*K,), K,
    overflow)``."""
    plan, w, p_factor, n_minor_start, overflow = _dispatch_plan(
        params, pairs, p, capacity, mode_grouped)
    K = w.shape[1]
    cf, cm = plan.kernel_counts(capacity)
    kwargs = dict(x=dispatch_mod.gather_rows(x, plan, capacity, index_div=K),
                  w1=params["w1"], w3=params["w3"], w2=params["w2"],
                  counts_full=cf, counts_major=cm, p_factor=p_factor,
                  n_minor_start=n_minor_start)
    return kwargs, plan, w.reshape(-1), K, overflow


def expert_runner(path: str, x, w1, w3, w2, plan, weights, *,
                  capacity: int, index_div: int = 1, p_factor: int = 1,
                  n_minor_start=None):
    """One local expert FFN call on ``path``, prepared: returns a function
    of no arguments that runs it, so that a caller times the preparation
    in its ``moe.plan`` span and the run in its ``moe.kernel`` span.

    x: (T, d) rows; ``plan``: a ``DispatchPlan`` seating T * ``index_div``
    flat pairs (pair ``i`` reads row ``i // index_div``) in (G,
    ``capacity``) groups over the weights' experts, ``p_factor``
    sub-experts fused per group, the minor half from ``n_minor_start`` on;
    ``weights``: each pair's combine weight (0 where dropped). The run
    returns (T, d), each row's sum of its pairs' weighted expert outputs:
    the fused kernel over the plan's sorted pair arrays, or the (G,
    capacity, d) buffer through the grouped SwiGLU kernel or the einsum,
    unpermuted. On ``ROUTE_PLAN`` ``plan`` is the launch pair's
    ``kernels.route_plan.RoutePlan``, which carries the sorted arrays and
    clamped counts, and ``weights`` is None."""
    from ..kernels import ops as kops
    if path in (ROUTE_PLAN, FUSED):
        args = ((plan.group_offsets, plan.counts_full, plan.counts_major,
                 plan.tok_sorted, plan.combine_sorted) if path == ROUTE_PLAN
                else _fused_args(plan, weights, capacity, index_div))
        # the wrapper is looked up on its module when the call runs: the
        # benchmark's probe swaps it there
        return lambda: kops.fused_moe_pipeline(
            x, w1, w3, w2, *args, capacity=capacity, p_factor=p_factor,
            n_minor_start=n_minor_start)
    buf = dispatch_mod.gather_rows(x, plan, capacity, index_div=index_div)
    if path == GROUPED:
        cf, cm = plan.kernel_counts(capacity)
        ffn = lambda: kops.grouped_swiglu(
            buf, w1, w3, w2, counts_full=cf, counts_major=cm,
            p_factor=p_factor, n_minor_start=n_minor_start)
    else:
        ffn = lambda: expert_ffn(w1, w3, w2, buf)

    def run():
        rows = dispatch_mod.unpermute(ffn(), plan)        # (T*index_div, d)
        rows = rows * weights.reshape(-1, 1).to(rows.dtype)
        return rows.reshape(x.shape[0], index_div, -1).sum(dim=1)
    return run


def moe_forward_dispatch(params: Dict, x, cfg,
                         pairs: Optional[SubExpertPairs] = None,
                         capacity_factor: float = 1.25,
                         capacity: Optional[int] = None,
                         use_kernel: bool = False,
                         return_overflow: bool = False,
                         mode_grouped: bool = False,
                         fused_pipeline: Optional[bool] = None,
                         path: Optional[str] = None):
    """Sort-based dispatch forward. Exact w.r.t. the reference whenever no
    token exceeds capacity.

    ``path``: ``expert_path``'s ``FUSED``, ``GROUPED`` or ``EINSUM``;
    None resolves it from ``use_kernel`` and ``fused_pipeline`` as
    ``expert_path`` resolves a policy's hints. Under ``mode_grouped``
    (P > 1) the two kernels take one row per ORIGINAL pair and skip minor
    halves; the einsum runs full sub-experts. ``return_overflow`` also
    returns the overflow count (sub-pair units)."""
    T = x.shape[0]
    E = params["w1"].shape[0]
    if pairs is None:
        pairs = route_plain(params, x, cfg, n_experts=E)
    if capacity is None:
        capacity = capacity_for(T, pairs.idx.shape[1], E, capacity_factor)
    if path is None:
        path = expert_path(_Hints(use_kernel, fused_pipeline, mode_grouped),
                           x.device)
    with layer("moe.plan"):
        plan, w, p_factor, n_minor_start, overflow = _dispatch_plan(
            params, pairs, _pairs_partition_p(pairs), capacity,
            mode_grouped and path != EINSUM)
        run = expert_runner(path, x, params["w1"], params["w3"],
                            params["w2"], plan, w, capacity=capacity,
                            index_div=w.shape[1], p_factor=p_factor,
                            n_minor_start=n_minor_start)
    with layer("moe.kernel"):
        y = run()
    out = _with_shared(params, x, y)
    return (out, overflow) if return_overflow else out


def moe_forward_route_plan(params: Dict, x, logits, cfg, policy,
                           thresholds, *, collect: bool = False):
    """The fused pipeline's forward with routing, keep mask, plan and obs
    counters from ``kernels.ops.moe_route_plan``: the same capacity,
    arguments and outputs as ``moe_forward_dispatch(..., mode_grouped=
    True, return_overflow=True)`` on ``policy.route``'s pairs.
    ``logits``: the router's (T, E) float32 logits of ``x`` (T, d);
    ``thresholds``: ``policy.two_t_thresholds(params)``. Returns ``(y,
    overflow)``, or ``(y, stats)`` under ``collect``."""
    from ..kernels import ops as kops
    T = x.shape[0]
    p = policy.partition_p
    capacity = policy.dispatch_capacity(T)
    if capacity is None:
        capacity = capacity_for(T, cfg.top_k * p, params["w1"].shape[0],
                                policy.capacity_factor)
    with layer("moe.plan"):
        plan = kops.moe_route_plan(
            logits, *thresholds, top_k=cfg.top_k,
            renorm=cfg.router_norm_topk, p_factor=p, capacity=capacity,
            pad=min(BLOCK, capacity))
        run = expert_runner(ROUTE_PLAN, x, params["w1"], params["w3"],
                            params["w2"], plan, None, capacity=capacity,
                            p_factor=p)
    with layer("moe.kernel"):
        y = run()
    out = _with_shared(params, x, y)
    if not collect:
        return out, plan.overflow
    with layer("moe.stats"):
        stats = layer_stats(plan.expert_load, plan.kept_full,
                            plan.kept_major, plan.dropped, plan.overflow)
    return out, stats


def layer_stats(expert_load, kept_full, kept_major, dropped, overflow):
    """The obs per-layer stats dict of one MoE layer call, the same keys
    on every route: the kept-pair histogram over sub-expert ids, the mode
    counts and the capacity overflow, in sub-pair units."""
    return {"expert_load": expert_load, "kept_full": kept_full,
            "kept_major": kept_major, "dropped_pairs": dropped,
            "overflow_pairs": overflow}


def moe_layer_forward(params: Dict, x, cfg, policy, *,
                      collect: bool = False, kernels: bool = True):
    """One MoE layer call under ``policy`` on one device: routing, the
    path ``expert_path`` picks, the forward and the obs counters. x:
    (B, S, d); per-request (B,) thresholds act per token. Returns ``(y,
    overflow)``, or with ``collect`` ``(y, stats)``, ``layer_stats``'s dict:
    the same routing and the same ``y`` either way. ``kernels=False``
    takes the einsum (the differentiable route)."""
    B, S, d = x.shape
    xt = x.reshape(-1, d)
    with layer("moe.route"):
        policy = policy.per_token(B, S)
        thresholds = policy.two_t_thresholds(params) if kernels else None
        path = expert_path(policy, x.device, kernels=kernels,
                           two_t=thresholds is not None)
        if path == ROUTE_PLAN:
            logits = gating.gate_logits(xt, params["wg"])
        else:
            pairs = policy.route(params, xt, cfg)
    if path == ROUTE_PLAN:
        y, out = moe_forward_route_plan(params, xt, logits, cfg, policy,
                                        thresholds, collect=collect)
        return y.reshape(B, S, d), out
    y, out = moe_forward_dispatch(
        params, xt, cfg, pairs=pairs, capacity_factor=policy.capacity_factor,
        capacity=policy.dispatch_capacity(xt.shape[0]), return_overflow=True,
        mode_grouped=policy.kernel_mode_grouping, path=path)
    if collect:
        with layer("moe.stats"):
            kf, km, dr = drop_mod.sub_pair_outcome_counts(
                pairs.keep, _pairs_partition_p(pairs))
            out = layer_stats(gating.expert_histogram(
                pairs.idx, params["w1"].shape[0], keep=pairs.keep),
                kf, km, dr, out)
    return y.reshape(B, S, d), out
