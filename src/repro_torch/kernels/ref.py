"""Plain PyTorch versions of the port's kernels. The CPU path of every
kernel wrapper runs these; ``chip_smoke.py`` holds each CUDA kernel against
its plain version on the card.

The MoE versions take float32 operands or bfloat16 ones (the S-ETP wire
type), as the TPU kernels do: bf16 operands are widened to float32, the
products taken in float32, h rounded to bf16 before the down product
(``h.astype(w2.dtype)``), and the float32 result cast to x's type."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .dualsparse_ffn import combine_order, resolve_n_major
from .route_plan import RoutePlan


def fused_moe_pipeline_ref(x, w1, w3, w2, group_offsets, counts_full,
                           counts_major, tok_sorted, combine_sorted,
                           capacity: int, p_factor: int = 1,
                           n_minor_start=None, block_c: int = 128,
                           block_f: int = 128):
    """Fused dispatch -> grouped SwiGLU -> weighted combine, plainly.

    For each expert e: gather the token rows of its sorted positions
    ``group_offsets[e] + [0, cf + cm)``, run the SwiGLU over the virtual
    width ``p_factor * f`` (sub-expert ``e*P + j`` holds neurons
    ``[j*f, (j+1)*f)``) with rows ``>= counts_full`` masked off the MINOR
    neurons, and scale each row by its combine weight. Then add each token's
    rows in increasing sorted-position order, starting from 0 — the order
    the TPU kernel accumulates in. ``capacity`` and ``block_c`` do not
    change the function (counts arrive clamped); ``block_f`` only places a
    caller's ``n_minor_start``."""
    del capacity, block_c
    fused_moe_pipeline_ref.calls += 1
    T, d = x.shape
    f = w1.shape[-1]
    P = p_factor
    V = P * f
    n_major = resolve_n_major(f, P, n_minor_start, block_f)
    dev = x.device
    major = torch.arange(V, device=dev) < n_major                 # (V,)
    w1, w3 = w1.float(), w3.float()
    offs = group_offsets.tolist()
    cf = counts_full.tolist()
    cm = counts_major.tolist()
    y_sorted = torch.zeros((tok_sorted.shape[0], d), dtype=torch.float32,
                           device=dev)
    for e, (o, c_f, c_m) in enumerate(zip(offs, cf, cm)):
        n_rows = c_f + c_m
        if n_rows == 0:
            continue
        xe = x[tok_sorted[o:o + n_rows].long()].float()
        w1e = w1[e * P:(e + 1) * P].permute(1, 0, 2).reshape(d, V)
        w3e = w3[e * P:(e + 1) * P].permute(1, 0, 2).reshape(d, V)
        w2e = w2[e * P:(e + 1) * P].reshape(V, d)
        h = F.silu(xe @ w1e) * (xe @ w3e)
        rows = torch.arange(n_rows, device=dev)[:, None]
        limit = torch.where(major, n_rows, c_f)[None, :]
        h = torch.where(rows < limit, h, torch.zeros((), device=dev))
        h = _round_h(h, w2)
        y_sorted[o:o + n_rows] = (combine_sorted[o:o + n_rows, None].float()
                                  * (h @ w2e.float()))
    order, start, count = combine_order(tok_sorted, group_offsets,
                                        counts_full, counts_major, T)
    out = torch.zeros((T, d), dtype=torch.float32, device=dev)
    n_levels = int(count.max()) if T else 0
    for k in range(n_levels):             # k-th position of every token
        toks = torch.nonzero(count > k)[:, 0]
        out[toks] += y_sorted[order[(start[toks] + k).long()].long()]
    return out.to(x.dtype)


fused_moe_pipeline_ref.calls = 0


def _round_h(h, w2):
    """float32 h rounded to w2's type and widened back (bf16 weights: the
    TPU kernels' ``h.astype(w2.dtype)`` before the down product; float32:
    unchanged)."""
    return h if w2.dtype == torch.float32 else h.to(w2.dtype).float()


def _counts_or_default(counts_full, counts_major, E: int, C: int, device):
    """The TPU kernel's defaults: ``counts_full=None`` means all C rows are
    FULL, ``counts_major=None`` means no MAJOR-only row."""
    if counts_full is None:
        counts_full = torch.full((E,), C, dtype=torch.int32, device=device)
    if counts_major is None:
        counts_major = torch.zeros((E,), dtype=torch.int32, device=device)
    return counts_full, counts_major


def grouped_swiglu_ref(x, w1, w3, w2, counts_full=None, counts_major=None,
                       p_factor: int = 1, n_minor_start=None,
                       block_c: int = 128, block_f: int = 128):
    """Grouped SwiGLU over pre-gathered buffers, plainly, with the TPU
    kernel's semantics (``grouped_swiglu_pallas``).

    x: (E, C, d); w1/w3: (E*P, d, f); w2: (E*P, f, d). Group e runs over the
    virtual width ``P * f`` (sub-expert ``e*P + j`` holds neurons
    ``[j*f, (j+1)*f)``): rows below ``counts_full[e]`` use every neuron,
    rows in ``[cf, cf + cm)`` only the MAJOR ones, rows at or past
    ``cf + cm`` are exact zeros. ``n_minor_start`` is read in the kernel's
    padded virtual coordinate (``block_f`` places it); ``block_c`` does not
    change the function. Returns (E, C, d) in x's dtype."""
    del block_c
    grouped_swiglu_ref.calls += 1
    E, C, d = x.shape
    f = w1.shape[-1]
    P = p_factor
    V = P * f
    dev = x.device
    cf, cm = _counts_or_default(counts_full, counts_major, E, C, dev)
    n_major = resolve_n_major(f, P, n_minor_start, block_f)
    w1v = w1.reshape(E, P, d, f).permute(0, 2, 1, 3).reshape(E, d, V)
    w3v = w3.reshape(E, P, d, f).permute(0, 2, 1, 3).reshape(E, d, V)
    w2v = w2.reshape(E, V, d)
    xf = x.float()
    h = F.silu(torch.einsum("ecd,edv->ecv", xf, w1v.float()))
    h = h * torch.einsum("ecd,edv->ecv", xf, w3v.float())
    rows = torch.arange(C, device=dev)[None, :, None]             # (1,C,1)
    live = (cf + cm).long()[:, None, None]                        # (E,1,1)
    major = (torch.arange(V, device=dev) < n_major)[None, None, :]
    limit = torch.where(major, live, cf.long()[:, None, None])    # (E,1,V)
    zero = torch.zeros((), device=dev)
    h = _round_h(torch.where(rows < limit, h, zero), w2)
    out = torch.einsum("ecv,evd->ecd", h, w2v.float())
    return torch.where(rows < live, out, zero).to(x.dtype)


grouped_swiglu_ref.calls = 0


def chunk_cumsum(x):
    """Float32 prefix sums along the last axis, accumulated in float64.

    Near the diagonal ``exp(cum_i - cum_j)`` differences two large sums,
    so one float32 rounding apart in ``cum`` shows as ~1e-5 relative in
    the decay. Accumulated in float64 and rounded once, the sums do not
    depend on the order a device adds in: the CUDA kernel, the plain
    versions and PyTorch's CPU cumsum (which accumulates float32 in
    float64) agree bit for bit."""
    return torch.cumsum(x.double(), dim=-1).float()


def ssd_chunk_ref(x, dt, a, bm, cm):
    """Intra-chunk SSD (Mamba2), plainly, with the signature of the TPU
    kernel's oracle (``src/repro/kernels/ssd_chunk.py::ssd_chunk_ref``).

    x: (BH, nc, Q, P); dt: (BH, nc, Q); a: (BH,); bm, cm: (BG, nc, Q, N)
    with BG dividing BH, head bh reading group row ``bh // (BH // BG)``.
    Per (batch·head, chunk): ``cum = cumsum(dt·a)``, ``L[i, j] =
    exp(cum_i - cum_j)`` for i >= j else 0, ``y = (C·Bᵀ ∘ L ∘ dt_j)·x``,
    ``states = (B ∘ dt ∘ exp(cum_end - cum))ᵀ·x``, ``decay =
    exp(cum_end)``. Returns (y (BH, nc, Q, P), states (BH, nc, N, P),
    decay (BH, nc)), float32."""
    ssd_chunk_ref.calls += 1
    rep = x.shape[0] // bm.shape[0]
    if rep > 1:
        bm = bm.repeat_interleave(rep, dim=0)
        cm = cm.repeat_interleave(rep, dim=0)
    dA = dt * a[:, None, None]                                  # (BH, nc, Q)
    cum = chunk_cumsum(dA)
    seg = cum[..., :, None] - cum[..., None, :]
    Q = x.shape[2]
    mask = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    # exp of the upper triangle overflows to inf; where() drops it
    L = torch.where(mask, torch.exp(seg), torch.zeros((), device=x.device))
    scores = torch.einsum("bcqn,bckn->bcqk", cm, bm)
    M = scores * L * dt[..., None, :]
    y = torch.einsum("bcqk,bckp->bcqp", M, x)
    decay_to_end = torch.exp(cum[..., -1:] - cum)
    w = bm * (dt * decay_to_end)[..., None]
    st = torch.einsum("bcqn,bcqp->bcnp", w, x)
    return y, st, torch.exp(cum[..., -1])


ssd_chunk_ref.calls = 0


def moe_route_plan_ref(logits, t_major, t_minor, *, top_k: int,
                       renorm: bool, p_factor: int, capacity: int,
                       pad: int) -> RoutePlan:
    """The routing, keep mask, plan and counters of one MoE layer call as
    the composed torch ops give them: ``gating.top_k_routing``,
    ``drop.expand_pairs_2t``, the grouped layout of
    ``core.moe.fused_pipeline_args`` (``fuse_sub_pairs``, ``sort_dispatch``,
    ``sorted_pair_arrays`` padded by ``pad``, ``kernel_counts``, the
    sub-pair overflow), ``drop.sub_pair_outcome_counts`` and
    ``gating.expert_histogram`` over sub-expert ids."""
    from ..core import dispatch, drop, gating
    from ..core.moe import _sub_pair_overflow
    moe_route_plan_ref.calls += 1
    E = logits.shape[1]
    r = gating.top_k_routing(logits, top_k, renorm)
    pairs = drop.expand_pairs_2t(r.idx, r.combine, r.norm_score, p_factor,
                                 t_major, t_minor)
    fused = dispatch.fuse_sub_pairs(pairs, p_factor)
    plan = dispatch.sort_dispatch(fused.group, fused.keep, n_groups=E,
                                  capacity=capacity,
                                  major_only=fused.major_only)
    w = fused.combine * fused.keep.to(fused.combine.dtype)
    tok_sorted, w_sorted = dispatch.sorted_pair_arrays(
        plan, w, index_div=top_k, pad=pad)
    cf, cm = plan.kernel_counts(capacity)
    kf, km, dr = drop.sub_pair_outcome_counts(pairs.keep, p_factor)
    return RoutePlan(
        idx=r.idx, modes=pairs.modes, combine=r.combine,
        group_offsets=plan.group_offsets, counts_full=cf, counts_major=cm,
        tok_sorted=tok_sorted, combine_sorted=w_sorted,
        overflow=_sub_pair_overflow(plan, pairs, fused, capacity),
        kept_full=kf, kept_major=km, dropped=dr,
        expert_load=gating.expert_histogram(pairs.idx, E * p_factor,
                                            keep=pairs.keep))


moe_route_plan_ref.calls = 0


# the score of a masked key
NEG_INF = -1e30


def attend_latent_rows(q_eff, q_rope, c, kr, mask, scale: float, *,
                       latent_out_in_cache_dtype: bool = False):
    """MLA's absorbed attention over gathered latent rows: queries q_eff
    (B,S,H,kv_lora) (q_nope through wk_b) and q_rope (B,S,H,rope) against
    c (B,T,kv_lora) and kr (B,T,rope) under ``mask`` (broadcastable to the
    (B,S,H,T) scores). Float32 scores at ``scale``, the softmax rounded to
    the cache dtype, the output (B,S,H,kv_lora) taken in float32 (in the
    cache dtype with ``latent_out_in_cache_dtype``)."""
    cf = c.float()
    s = (torch.einsum("bshr,btr->bsht", q_eff, cf)
         + torch.einsum("bshk,btk->bsht", q_rope.float(), kr.float())) \
        * scale
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1).to(c.dtype)
    lat = c if latent_out_in_cache_dtype else cf
    return torch.einsum("bsht,btr->bshr", p.to(lat.dtype), lat)


def gather_pages(pool, ids, read_len=None):
    """Pages ``ids`` (..., n) of a paged pool (pages, page_size, ...) as
    (..., n * page_size, ...) rows: only the pages ``read_len`` needs,
    trimmed to it."""
    ps = pool.shape[1]
    if read_len is not None:
        ids = ids[..., :-(-read_len // ps)]
    g = pool[ids.long()].flatten(ids.ndim - 1, ids.ndim)
    if read_len is not None:
        g = g[(slice(None),) * (ids.ndim - 1) + (slice(0, read_len),)]
    return g


def mla_latent_attend_ref(q_lat, q_rope, c, kr, page_table, last,
                          scale: float, read_len=None):
    """``attend_latent_rows`` over the paged latent pool, as the paged MLA
    paths composed it: the N query rows (q_lat (N,H,kv_lora), q_rope
    (N,H,rope)) fall in G = page_table.shape[0] groups of N / G
    consecutive rows, group g reading the pages of ``page_table[g]``; the
    pool's pages c (P+1,page,kv_lora) and kr (P+1,page,rope) are gathered
    through it (``gather_pages``, trimmed to ``read_len`` rows as
    ``PagedLayout.read`` trims them) and row n sees the positions up to
    ``last[n]``. Returns o_lat (N,H,kv_lora) float32."""
    mla_latent_attend_ref.calls += 1
    G = page_table.shape[0]
    N, H, _ = q_lat.shape
    cg, krg = (gather_pages(pool, page_table, read_len) for pool in (c, kr))
    T = cg.shape[1]
    mask = torch.arange(T, device=c.device)[None, None, :] <= \
        last.long().reshape(G, N // G)[:, :, None]
    o = attend_latent_rows(q_lat.reshape(G, N // G, H, -1),
                           q_rope.reshape(G, N // G, H, -1), cg, krg,
                           mask[:, :, None, :], scale)
    return o.reshape(N, H, -1)


mla_latent_attend_ref.calls = 0
