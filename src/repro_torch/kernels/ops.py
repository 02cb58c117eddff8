"""Public kernel wrappers of the port.

Each wrapper checks its inputs, then runs the kernel's plain version when
the tensors lie on the CPU and launches the CUDA kernel when they lie on a
CUDA device — never one in place of the other. ``<wrapper>.launches``
counts CUDA launches (nothing else adds to it), so a run can show that its
main path went through the kernel; the MoE wrappers also count their
launches on bfloat16 operands in ``<wrapper>.launches_bf16``.

The kernels have no backward (nor has the reference's ``pallas_call``), so
each wrapper raises, on every device, when autograd is recording and a
floating operand requires grad: its output would carry no history and the
weights below it would get no gradient without an error. Training takes
the plain differentiable route instead (``transformer.forward(kernels=
False)``).
"""
from __future__ import annotations

import torch

from . import dualsparse_ffn, mla_attend, ref, route_plan
from . import ssd_chunk as ssd_chunk_kernel

__all__ = ["fused_moe_pipeline", "fused_moe_pipeline_ref",
           "grouped_swiglu", "grouped_swiglu_ref", "mla_latent_attend",
           "mla_latent_attend_ref", "moe_route_plan", "moe_route_plan_ref",
           "ssd_chunk", "ssd_chunk_ref"]

fused_moe_pipeline_ref = ref.fused_moe_pipeline_ref
grouped_swiglu_ref = ref.grouped_swiglu_ref
mla_latent_attend_ref = ref.mla_latent_attend_ref
moe_route_plan_ref = ref.moe_route_plan_ref
ssd_chunk_ref = ref.ssd_chunk_ref


def _check_no_grad(op: str, named) -> None:
    if not torch.is_grad_enabled():
        return
    needs = [name for name, t in named.items()
             if t.is_floating_point() and t.requires_grad]
    if needs:
        raise RuntimeError(
            f"{op}: {', '.join(needs)} require grad, and the kernel has no "
            "backward: its output would carry no gradient; run it under "
            "torch.no_grad(), or train through the plain differentiable "
            "route (transformer.forward(kernels=False))")


def _check_devices_and_layout(op: str, named, ref_device):
    for name, t in named.items():
        if t.device != ref_device:
            raise ValueError(f"{op}: {name} is on {t.device}, x on "
                             f"{ref_device}")
        if not t.is_contiguous():
            raise ValueError(f"{op}: {name} is not contiguous")


def _check_dtypes(op: str, named, floats, ints):
    for name in floats:
        if named[name].dtype != torch.float32:
            raise TypeError(f"{op}: {name} must be float32 (got "
                            f"{named[name].dtype}); other weight types are "
                            "not supported yet")
    _check_ints(op, named, ints)


def _check_operand_dtypes(op: str, named, operands, floats, ints):
    """``operands`` (x and the weights) share one type of
    ``dualsparse_ffn.ELEMENT_TYPES`` — float32, or bfloat16 on the S-ETP
    wire; ``floats`` are float32 whatever the operands' type."""
    kind = named[operands[0]].dtype
    if kind not in dualsparse_ffn.ELEMENT_TYPES:
        raise TypeError(f"{op}: {operands[0]} must be float32 or bfloat16 "
                        f"(got {kind})")
    for name in operands[1:]:
        if named[name].dtype != kind:
            raise TypeError(f"{op}: {name} is {named[name].dtype}, "
                            f"{operands[0]} {kind}; x and the weights must "
                            "share one type")
    _check_dtypes(op, named, floats, ints)


def _check_ints(op: str, named, ints):
    for name in ints:
        if named[name].dtype != torch.int32:
            raise TypeError(f"{op}: {name} must be int32 (got "
                            f"{named[name].dtype})")


def _check_fused_inputs(x, w1, w3, w2, group_offsets, counts_full,
                        counts_major, tok_sorted, combine_sorted,
                        capacity: int, p_factor: int):
    named = dict(x=x, w1=w1, w3=w3, w2=w2, group_offsets=group_offsets,
                 counts_full=counts_full, counts_major=counts_major,
                 tok_sorted=tok_sorted, combine_sorted=combine_sorted)
    _check_no_grad("fused_moe_pipeline", named)
    _check_devices_and_layout("fused_moe_pipeline", named, x.device)
    _check_operand_dtypes("fused_moe_pipeline", named,
                          ("x", "w1", "w3", "w2"), ("combine_sorted",),
                          ("group_offsets", "counts_full", "counts_major",
                           "tok_sorted"))
    if x.ndim != 2 or w1.ndim != 3:
        raise ValueError("fused_moe_pipeline: x must be (T, d) and w1/w3 "
                         "(E*P, d, f)")
    T, d = x.shape
    Es, dw, f = w1.shape
    E = group_offsets.shape[0]
    if dw != d or w3.shape != w1.shape or tuple(w2.shape) != (Es, f, d):
        raise ValueError(f"fused_moe_pipeline: weight shapes w1 "
                         f"{tuple(w1.shape)} w3 {tuple(w3.shape)} w2 "
                         f"{tuple(w2.shape)} do not fit x {tuple(x.shape)}")
    if Es != E * p_factor:
        raise ValueError(f"fused_moe_pipeline: weights carry {Es} "
                         f"sub-experts; plan has {E} groups x p_factor "
                         f"{p_factor}")
    if counts_full.shape != (E,) or counts_major.shape != (E,):
        raise ValueError("fused_moe_pipeline: counts must be (E,)")
    if tok_sorted.ndim != 1 or tok_sorted.shape != combine_sorted.shape:
        raise ValueError("fused_moe_pipeline: tok_sorted and "
                         "combine_sorted must be matching (N',) vectors")
    if capacity < 1:
        raise ValueError("fused_moe_pipeline: capacity must be >= 1")


def fused_moe_pipeline(x, w1, w3, w2, group_offsets, counts_full,
                       counts_major, tok_sorted, combine_sorted,
                       capacity: int, p_factor: int = 1, n_minor_start=None,
                       block_c: int = 128, block_f: int = 128):
    """Fused dispatch -> grouped SwiGLU -> weighted combine.

    x: (T, d); w1/w3: (E*p_factor, d, f); w2: (E*p_factor, f, d), all
    float32 or all bfloat16 (products in float32, h rounded to bf16 before
    the down product, as the TPU kernel does on the S-ETP wire type);
    ``group_offsets``/``counts_full``/``counts_major``: (E,) int32 from a
    ``DispatchPlan`` (counts clamped to ``capacity``); ``tok_sorted``/
    ``combine_sorted``: (N',) float32, per sorted pair position, padded as
    ``core.dispatch.sorted_pair_arrays(pad=block_c)`` pads them. Returns
    (T, d) in x's dtype. ``block_c`` is kept for signature parity with the
    JAX wrapper; ``block_f`` only places an explicit ``n_minor_start`` as
    the TPU kernel reads it."""
    _check_fused_inputs(x, w1, w3, w2, group_offsets, counts_full,
                        counts_major, tok_sorted, combine_sorted, capacity,
                        p_factor)
    if x.device.type == "cpu":
        return ref.fused_moe_pipeline_ref(
            x, w1, w3, w2, group_offsets, counts_full, counts_major,
            tok_sorted, combine_sorted, capacity, p_factor=p_factor,
            n_minor_start=n_minor_start, block_c=block_c, block_f=block_f)
    if x.device.type != "cuda":
        raise ValueError(f"fused_moe_pipeline: no kernel for device "
                         f"{x.device}")
    n_major = dualsparse_ffn.resolve_n_major(w1.shape[-1], p_factor,
                                             n_minor_start, block_f)
    out = dualsparse_ffn.launch_fused_moe_pipeline(
        x, w1, w3, w2, group_offsets, counts_full, counts_major, tok_sorted,
        combine_sorted, capacity=capacity, p_factor=p_factor,
        n_major=n_major)
    fused_moe_pipeline.launches += 1
    fused_moe_pipeline.launches_bf16 += x.dtype == torch.bfloat16
    return out.to(x.dtype)


fused_moe_pipeline.launches = 0
fused_moe_pipeline.launches_bf16 = 0


def _check_grouped_inputs(x, w1, w3, w2, counts_full, counts_major,
                          p_factor: int):
    named = dict(x=x, w1=w1, w3=w3, w2=w2, counts_full=counts_full,
                 counts_major=counts_major)
    _check_no_grad("grouped_swiglu", named)
    _check_devices_and_layout("grouped_swiglu", named, x.device)
    _check_operand_dtypes("grouped_swiglu", named, ("x", "w1", "w3", "w2"),
                          (), ("counts_full", "counts_major"))
    if x.ndim != 3 or w1.ndim != 3:
        raise ValueError("grouped_swiglu: x must be (E, C, d) and w1/w3 "
                         "(E*P, d, f)")
    E, C, d = x.shape
    Es, dw, f = w1.shape
    if dw != d or w3.shape != w1.shape or tuple(w2.shape) != (Es, f, d):
        raise ValueError(f"grouped_swiglu: weight shapes w1 "
                         f"{tuple(w1.shape)} w3 {tuple(w3.shape)} w2 "
                         f"{tuple(w2.shape)} do not fit x {tuple(x.shape)}")
    if p_factor < 1 or Es != E * p_factor:
        raise ValueError(f"grouped_swiglu: weights carry {Es} sub-experts; "
                         f"buffers have {E} groups x p_factor {p_factor}")
    if counts_full.shape != (E,) or counts_major.shape != (E,):
        raise ValueError("grouped_swiglu: counts must be (E,)")


def grouped_swiglu(x, w1, w3, w2, counts_full=None, counts_major=None,
                   p_factor: int = 1, n_minor_start=None,
                   block_c: int = 128, block_f: int = 128):
    """Grouped SwiGLU expert FFN over pre-gathered buffers, with 2T-Drop
    row/neuron masking.

    x: (E, C, d); w1/w3: (E*p_factor, d, f); w2: (E*p_factor, f, d), all
    float32 or all bfloat16 (as for ``fused_moe_pipeline``);
    ``counts_full``/``counts_major``: (E,) int32 or ``None`` (all C rows
    FULL / no MAJOR-only row). ``p_factor > 1`` fuses the sub-experts of
    each group back to the full width by indexing. Returns (E, C, d) in x's
    dtype, rows at or past ``cf + cm`` exact zeros. ``block_c`` is kept for
    signature parity with the JAX wrapper; ``block_f`` only places an
    explicit ``n_minor_start`` as the TPU kernel reads it."""
    counts_full, counts_major = ref._counts_or_default(
        counts_full, counts_major, x.shape[0], x.shape[1], x.device)
    _check_grouped_inputs(x, w1, w3, w2, counts_full, counts_major,
                          p_factor)
    if x.device.type == "cpu":
        return ref.grouped_swiglu_ref(
            x, w1, w3, w2, counts_full, counts_major, p_factor=p_factor,
            n_minor_start=n_minor_start, block_c=block_c, block_f=block_f)
    if x.device.type != "cuda":
        raise ValueError(f"grouped_swiglu: no kernel for device {x.device}")
    n_major = dualsparse_ffn.resolve_n_major(w1.shape[-1], p_factor,
                                             n_minor_start, block_f)
    out = dualsparse_ffn.launch_grouped_swiglu(
        x, w1, w3, w2, counts_full, counts_major, p_factor=p_factor,
        n_major=n_major)
    grouped_swiglu.launches += 1
    grouped_swiglu.launches_bf16 += x.dtype == torch.bfloat16
    return out


grouped_swiglu.launches = 0
grouped_swiglu.launches_bf16 = 0


def _check_route_plan_inputs(logits, t_major, t_minor, top_k: int,
                             p_factor: int, capacity: int, pad: int):
    named = dict(logits=logits, **{
        name: t for name, t in (("t_major", t_major), ("t_minor", t_minor))
        if isinstance(t, torch.Tensor)})
    _check_no_grad("moe_route_plan", named)
    _check_devices_and_layout("moe_route_plan", dict(logits=logits),
                              logits.device)
    _check_dtypes("moe_route_plan", named, ("logits",), ())
    if logits.ndim != 2:
        raise ValueError("moe_route_plan: logits must be (T, E)")
    E = logits.shape[1]
    if not 1 <= E <= route_plan.MAX_EXPERTS:
        raise ValueError(f"moe_route_plan: {E} experts; the kernel takes "
                         f"1 to {route_plan.MAX_EXPERTS}")
    if not 1 <= top_k <= min(E, route_plan.MAX_TOP_K):
        raise ValueError(f"moe_route_plan: top_k {top_k} must lie in "
                         f"[1, min(E, {route_plan.MAX_TOP_K})]")
    if p_factor < 2:
        raise ValueError("moe_route_plan: the plan is over original "
                         "experts with FULL and MAJOR-only rows, which "
                         "needs p_factor >= 2")
    if capacity < 1 or pad < 0:
        raise ValueError("moe_route_plan: capacity must be >= 1 and pad "
                         ">= 0")


def moe_route_plan(logits, t_major, t_minor, *, top_k: int, renorm: bool,
                   p_factor: int, capacity: int, pad: int):
    """Routing, 2T-Drop keep mask and the fused pipeline's dispatch plan of
    one MoE layer call, from its router logits.

    logits: (T, E) float32; ``t_major`` / ``t_minor``: numbers or float32
    tensors, scalar, per-token (T,) or per-pair (T, K); ``p_factor`` >= 2
    sub-experts per expert; ``capacity`` rows per expert; ``pad`` trailing
    (row 0, weight 0) positions after the T*K sorted pairs (``block_c`` of
    the fused call, at most ``capacity``). Returns a
    ``route_plan.RoutePlan``: what ``gating.top_k_routing``,
    ``drop.expand_pairs_2t``, ``core.moe.fused_pipeline_args``'s grouped
    layout, ``drop.sub_pair_outcome_counts`` and ``gating.expert_histogram``
    give (``ref.moe_route_plan_ref``). On the card the plan, the overflow
    and the counters are exact functions of ``idx`` and ``modes``;
    ``combine`` may differ from ``torch.softmax``'s by a few ulps."""
    _check_route_plan_inputs(logits, t_major, t_minor, top_k, p_factor,
                             capacity, pad)
    if logits.device.type == "cpu":
        return ref.moe_route_plan_ref(
            logits, t_major, t_minor, top_k=top_k, renorm=renorm,
            p_factor=p_factor, capacity=capacity, pad=pad)
    if logits.device.type != "cuda":
        raise ValueError(f"moe_route_plan: no kernel for device "
                         f"{logits.device}")
    out = route_plan.launch_moe_route_plan(
        logits, t_major, t_minor, top_k=top_k, renorm=renorm,
        p_factor=p_factor, capacity=capacity, pad=pad)
    moe_route_plan.launches += 1
    return out


moe_route_plan.launches = 0


def _check_ssd_inputs(x, dt, a, bm, cm):
    named = dict(x=x, dt=dt, a=a, bm=bm, cm=cm)
    _check_no_grad("ssd_chunk", named)
    _check_devices_and_layout("ssd_chunk", named, x.device)
    _check_dtypes("ssd_chunk", named, tuple(named), ())
    if x.ndim != 4 or bm.ndim != 4:
        raise ValueError("ssd_chunk: x must be (BH, nc, Q, P) and bm/cm "
                         "(BG, nc, Q, N)")
    BH, nc, Q, P = x.shape
    BG, N = bm.shape[0], bm.shape[-1]
    if (tuple(dt.shape) != (BH, nc, Q) or tuple(a.shape) != (BH,)
            or tuple(bm.shape) != (BG, nc, Q, N) or cm.shape != bm.shape):
        raise ValueError(f"ssd_chunk: shapes x {tuple(x.shape)} dt "
                         f"{tuple(dt.shape)} a {tuple(a.shape)} bm "
                         f"{tuple(bm.shape)} cm {tuple(cm.shape)} do not "
                         "fit (BH, nc, Q, P) / (BH, nc, Q) / (BH,) / "
                         "(BG, nc, Q, N)")
    if BG < 1 or BH % BG:
        raise ValueError(f"ssd_chunk: bm/cm's {BG} group rows do not "
                         f"divide the {BH} heads of x")
    if min(Q, P, N) < 1:
        raise ValueError("ssd_chunk: Q, P and N must be >= 1")


def ssd_chunk(x, dt, a, bm, cm):
    """Intra-chunk SSD of Mamba2 (``ssd_chunk_pallas``'s function).

    x: (BH, nc, Q, P); dt: (BH, nc, Q) (softplus'd, > 0); a: (BH,) (< 0);
    bm, cm: (BG, nc, Q, N) with BG dividing BH: head bh reads group row
    ``bh // (BH // BG)`` (``repeat_interleave`` along the heads; BG = BH is
    the TPU kernel's own layout); all float32. Returns (y_intra (BH, nc, Q,
    P), states (BH, nc, N, P), decay (BH, nc)) in float32."""
    _check_ssd_inputs(x, dt, a, bm, cm)
    if x.device.type == "cpu":
        return ref.ssd_chunk_ref(x, dt, a, bm, cm)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_chunk: no kernel for device {x.device}")
    out = ssd_chunk_kernel.launch_ssd_chunk(x, dt, a, bm, cm)
    ssd_chunk.launches += 1
    return out


ssd_chunk.launches = 0


def check_mla_latent_attend_shape(kv_lora: int, rope: int, page_size: int,
                                  device) -> None:
    """Raise ValueError where ``mla_latent_attend`` off the CPU would: latent
    / rope widths the kernel is not built for (``mla_attend.WIDTHS``), or a
    page size that is not a multiple of ``mla_attend.PAGE_STEP``. The plain
    version on the CPU takes any."""
    if torch.device(device).type == "cpu":
        return
    op = "mla_latent_attend"
    if (kv_lora, rope) not in mla_attend.WIDTHS:
        raise ValueError(f"{op}: latent / rope widths {kv_lora} / {rope}: "
                         f"the kernel is built for {mla_attend.WIDTHS}")
    if page_size % mla_attend.PAGE_STEP:
        raise ValueError(f"{op}: page size {page_size}: the kernel takes "
                         f"multiples of {mla_attend.PAGE_STEP}")


def _check_mla_inputs(q_lat, q_rope, c, kr, page_table, last, read_len):
    op = "mla_latent_attend"
    named = dict(q_lat=q_lat, q_rope=q_rope, c=c, kr=kr,
                 page_table=page_table, last=last)
    _check_no_grad(op, named)
    where = q_lat.get_device()
    for name, t in named.items():
        if t.get_device() != where:
            raise ValueError(f"{op}: {name} is on {t.device}, q_lat on "
                             f"{q_lat.device}")
    _check_dtypes(op, named, ("q_lat", "q_rope"), ("page_table", "last"))
    for name in ("c", "kr"):
        if named[name].dtype != torch.bfloat16:
            raise TypeError(f"{op}: the pool {name} must be bfloat16 (got "
                            f"{named[name].dtype})")
    for name in ("c", "kr", "page_table", "last"):
        if not named[name].is_contiguous():
            raise ValueError(f"{op}: {name} is not contiguous")
    if q_lat.ndim != 3 or q_rope.ndim != 3 or c.ndim != 3 or kr.ndim != 3 \
            or page_table.ndim != 2 or last.ndim != 1:
        raise ValueError(f"{op}: q_lat / q_rope must be (N, H, width), c / "
                         "kr (pages, page_size, width), page_table (G, n) "
                         "and last (N,)")
    N, H, R = q_lat.shape
    DR = q_rope.shape[-1]
    check_mla_latent_attend_shape(R, DR, c.shape[1], q_lat.device)
    if tuple(q_rope.shape[:2]) != (N, H) or c.shape[-1] != R or \
            kr.shape[-1] != DR or c.shape[:2] != kr.shape[:2] or \
            last.shape[0] != N:
        raise ValueError(f"{op}: shapes q_lat {tuple(q_lat.shape)} q_rope "
                         f"{tuple(q_rope.shape)} c {tuple(c.shape)} kr "
                         f"{tuple(kr.shape)} last {tuple(last.shape)} do "
                         "not fit")
    G = page_table.shape[0]
    if G < 1 or N % G:
        raise ValueError(f"{op}: {N} query rows do not fall in the "
                         f"{G} groups of the page table")
    if read_len is not None and read_len < 1:
        raise ValueError(f"{op}: read_len must be >= 1")
    for name, t in (("q_lat", q_lat), ("q_rope", q_rope)):
        if t.stride(2) != 1 or t.stride(0) % 4 or t.stride(1) % 4 or \
                t.data_ptr() % 16:
            raise ValueError(f"{op}: {name}'s rows must be contiguous and "
                             "lie on 16 bytes")


def mla_latent_attend(q_lat, q_rope, c, kr, page_table, last, scale: float,
                      read_len=None):
    """MLA's absorbed attention over the paged latent pool: scores, the
    softmax and the output in latent space.

    q_lat: (N, H, kv_lora) float32, q_nope through wk_b; q_rope: (N, H,
    rope) float32 (rows contiguous, row strides free); c: (P+1, page,
    kv_lora) and kr: (P+1, page, rope) bfloat16, the pool as it is;
    page_table: (G, n) int32, G dividing N: query row n reads the pages of
    ``page_table[n // (N // G)]`` (decode: one row per slot; a chunk: one
    slot's row); last: (N,) int32, each row's last visible position (its
    own). Each row sees positions up to min(last, T - 1), T = ``read_len``
    or every page of the table. Scores at ``scale`` in float32, p rounded
    to bf16 after the division, the output (N, H, kv_lora) in float32
    (``ref.mla_latent_attend_ref``). Off the CPU the widths and the page
    size must be the kernel's (``check_mla_latent_attend_shape``)."""
    _check_mla_inputs(q_lat, q_rope, c, kr, page_table, last, read_len)
    if q_lat.device.type == "cpu":
        return ref.mla_latent_attend_ref(q_lat, q_rope, c, kr, page_table,
                                         last, scale, read_len)
    if q_lat.device.type != "cuda":
        raise ValueError(f"mla_latent_attend: no kernel for device "
                         f"{q_lat.device}")
    full = page_table.shape[1] * c.shape[1]
    T = full if read_len is None else min(read_len, full)
    out = mla_attend.launch_mla_latent_attend(q_lat, q_rope, c, kr,
                                              page_table, last, scale, T)
    mla_latent_attend.launches += 1
    return out


mla_latent_attend.launches = 0
