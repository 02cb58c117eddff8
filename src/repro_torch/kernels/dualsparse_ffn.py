"""The dual-sparse SwiGLU kernels for Hopper: geometry shared with their
plain versions, the combine order, and the launches of the CUDA kernels
through ``ctypes``.

* ``csrc/fused_moe_pipeline.cu`` computes what ``src/repro/kernels/
  dualsparse_ffn.py::fused_moe_pipeline_pallas`` computes on the TPU:
  gather each expert segment's token rows through the sort permutation,
  run the grouped SwiGLU with f32 accumulation (rows below ``counts_full``
  use every neuron, rows in ``[cf, cf+cm)`` only the MAJOR neurons, tiles
  with no live row are skipped), and add ``combine * row`` into an f32
  ``(T, d)`` output in increasing sorted-position order.
* ``csrc/grouped_swiglu.cu`` computes what ``grouped_swiglu_pallas``
  computes: the same masked grouped SwiGLU over pre-gathered ``(E, C, d)``
  buffers, with rows at or past ``cf+cm`` returned as exact zeros.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

I32 = torch.int32


def resolve_n_major(f: int, p_factor: int, n_minor_start, block_f: int
                    ) -> int:
    """Number of MAJOR neurons of the virtual width ``p_factor * f``.

    ``n_minor_start`` is read in the TPU kernel's padded virtual coordinate
    (each sub-expert padded to a multiple of ``min(block_f, f)``) and
    defaults as ``_resolve_blocks`` does: the padded sub-expert width at
    ``p_factor > 1``, ``f // 2`` at ``p_factor == 1`` when f is even, else
    ``f``. The MAJOR set is always a prefix of the unpadded virtual width,
    so one count describes it."""
    bf = min(block_f, f)
    fp = f + (-f) % bf
    if n_minor_start is None:
        if p_factor > 1:
            n_minor_start = fp
        else:
            n_minor_start = f // 2 if f % 2 == 0 else f
    return sum(min(max(n_minor_start - j * fp, 0), f)
               for j in range(p_factor))


def combine_order(tok_sorted, group_offsets, counts_full, counts_major,
                  n_tokens: int):
    """Per-token lists of the sorted positions some row block computes.

    Returns ``(order, start, count)``: token t's positions are
    ``order[start[t] : start[t] + count[t]]`` in increasing order (a stable
    sort of the token keys). Positions past an expert's clamped rows —
    capacity overflow, dropped pairs, the padding — are left out."""
    dev = tok_sorted.device
    pos = torch.arange(tok_sorted.shape[0], dtype=I32, device=dev)
    offs = group_offsets.contiguous()
    g = (torch.searchsorted(offs, pos, right=True) - 1).clamp(min=0)
    rows = (counts_full + counts_major)[g]
    valid = (pos - offs[g]) < rows
    key = torch.where(valid, tok_sorted, torch.full_like(tok_sorted,
                                                         n_tokens))
    order = torch.argsort(key, stable=True).to(I32)
    count = torch.zeros(n_tokens + 1, dtype=I32, device=dev)
    count.scatter_add_(0, key.long(), torch.ones_like(key))
    count = count[:n_tokens]
    start = torch.cumsum(count, 0) - count
    return order, start.to(I32), count.to(I32)


_ARGTYPES = {
    "fused_moe_pipeline": ([ctypes.c_void_p] * 15 + [ctypes.c_int] * 7
                           + [ctypes.c_void_p]),
    "grouped_swiglu": ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
                       + [ctypes.c_void_p]),
}


def _library(name: str) -> ctypes.CDLL:
    """The loaded ``csrc/<name>.cu`` library with its C signatures set."""
    lib = _build.load(name)
    launch = getattr(lib, f"{name}_launch")
    if launch.argtypes is None:
        launch.argtypes = _ARGTYPES[name]
        launch.restype = ctypes.c_int
        err = getattr(lib, f"{name}_error_string")
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
    return lib


def _raise_on_error(lib: ctypes.CDLL, name: str, err: int) -> None:
    if err != 0:
        msg = getattr(lib, f"{name}_error_string")(err).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {err} ({msg})")


def launch_fused_moe_pipeline(x, w1, w3, w2, group_offsets, counts_full,
                              counts_major, tok_sorted, combine_sorted, *,
                              capacity: int, p_factor: int, n_major: int):
    """Enqueue the CUDA kernel on the current stream; returns the (T, d)
    float32 output. Inputs must already be checked (``ops`` does that)."""
    lib = _library("fused_moe_pipeline")
    T, d = x.shape
    f = w1.shape[-1]
    E = group_offsets.shape[0]
    n_pos = tok_sorted.shape[0]
    order, start, count = combine_order(tok_sorted, group_offsets,
                                        counts_full, counts_major, T)
    h = torch.empty((n_pos, p_factor * f), dtype=torch.float32,
                    device=x.device)
    y = torch.empty((n_pos, d), dtype=torch.float32, device=x.device)
    out = torch.empty((T, d), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.fused_moe_pipeline_launch(
        x.data_ptr(), w1.data_ptr(), w3.data_ptr(), w2.data_ptr(),
        group_offsets.data_ptr(), counts_full.data_ptr(),
        counts_major.data_ptr(), tok_sorted.data_ptr(),
        combine_sorted.data_ptr(), h.data_ptr(), y.data_ptr(),
        order.data_ptr(), start.data_ptr(), count.data_ptr(),
        out.data_ptr(), T, d, f, E, p_factor, n_major, capacity, stream)
    _raise_on_error(lib, "fused_moe_pipeline", err)
    return out


def launch_grouped_swiglu(x, w1, w3, w2, counts_full, counts_major, *,
                          p_factor: int, n_major: int):
    """Enqueue the grouped SwiGLU kernel on the current stream; returns the
    (E, C, d) float32 output, dead rows exact zeros. Inputs must already be
    checked (``ops`` does that)."""
    E, C, d = x.shape
    f = w1.shape[-1]
    out = torch.empty((E, C, d), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    lib = _library("grouped_swiglu")
    h = torch.empty((E * C, p_factor * f), dtype=torch.float32,
                    device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.grouped_swiglu_launch(
        x.data_ptr(), w1.data_ptr(), w3.data_ptr(), w2.data_ptr(),
        counts_full.data_ptr(), counts_major.data_ptr(), h.data_ptr(),
        out.data_ptr(), E, C, d, f, p_factor, n_major, stream)
    _raise_on_error(lib, "grouped_swiglu", err)
    return out
