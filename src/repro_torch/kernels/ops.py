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

from . import dualsparse_ffn, ref, ssd_chunk as ssd_chunk_kernel

__all__ = ["fused_moe_pipeline", "fused_moe_pipeline_ref",
           "grouped_swiglu", "grouped_swiglu_ref", "ssd_chunk",
           "ssd_chunk_ref"]

fused_moe_pipeline_ref = ref.fused_moe_pipeline_ref
grouped_swiglu_ref = ref.grouped_swiglu_ref
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
                       block_c: int = 128, block_f: int = 128,
                       streamed: bool = True):
    """Fused dispatch -> grouped SwiGLU -> weighted combine.

    x: (T, d); w1/w3: (E*p_factor, d, f); w2: (E*p_factor, f, d), all
    float32 or all bfloat16 (products in float32, h rounded to bf16 before
    the down product, as the TPU kernel does on the S-ETP wire type);
    ``group_offsets``/``counts_full``/``counts_major``: (E,) int32 from a
    ``DispatchPlan`` (counts clamped to ``capacity``); ``tok_sorted``/
    ``combine_sorted``: (N',) float32, per sorted pair position, padded as
    ``core.dispatch.sorted_pair_arrays(pad=block_c)`` pads them. Returns
    (T, d) in x's dtype. ``block_c``, ``block_f`` and ``streamed`` are kept
    for signature parity with the JAX wrapper: one CUDA kernel serves both
    values of ``streamed``; ``block_f`` only places an explicit
    ``n_minor_start`` as the TPU kernel reads it."""
    _check_fused_inputs(x, w1, w3, w2, group_offsets, counts_full,
                        counts_major, tok_sorted, combine_sorted, capacity,
                        p_factor)
    if x.device.type == "cpu":
        return ref.fused_moe_pipeline_ref(
            x, w1, w3, w2, group_offsets, counts_full, counts_major,
            tok_sorted, combine_sorted, capacity, p_factor=p_factor,
            n_minor_start=n_minor_start, block_c=block_c, block_f=block_f,
            streamed=streamed)
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
