"""The intra-chunk SSD kernel for Hopper and its launch through ``ctypes``.

``csrc/ssd_chunk.cu`` computes what ``src/repro/kernels/ssd_chunk.py::
ssd_chunk_pallas`` computes on the TPU: per (batch·head, chunk) the
lower-triangular ``(C·Bᵀ ∘ L ∘ dt)·x``, the chunk's state contribution and
its decay (see ``ref.ssd_chunk_ref``), with B and C passed once per group
of heads. It runs as three launches: C·Bᵀ per (group, chunk) with the
cumsums, then the y row blocks, then the states tiles.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

_ARGTYPES = ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 7
             + [ctypes.c_void_p])


def _library() -> ctypes.CDLL:
    lib = _build.load("ssd_chunk")
    if lib.ssd_chunk_launch.argtypes is None:
        lib.ssd_chunk_launch.argtypes = _ARGTYPES
        lib.ssd_chunk_launch.restype = ctypes.c_int
        lib.ssd_chunk_error_string.argtypes = [ctypes.c_int]
        lib.ssd_chunk_error_string.restype = ctypes.c_char_p
    return lib


def _pad4(n: int) -> int:
    return -(-n // 4) * 4


@functools.lru_cache(maxsize=64)
def _layout(BH: int, BG: int, nc: int, Q: int, P: int, N: int):
    """Float offsets of the parts of the call's one allocation and its
    length: the outputs y (BH, nc, Q, P), states (BH, nc, N, P) and decay
    (BH, nc), then the scratch: scores (BG, nc, Q, Qs), cum, w and v (BH,
    nc, Q) each. Every part starts on 16 bytes."""
    sizes = (BH * nc * Q * P, BH * nc * N * P, BH * nc,
             BG * nc * Q * _pad4(Q), BH * nc * Q, BH * nc * Q, BH * nc * Q)
    offsets = [0]
    for n in sizes:
        offsets.append(offsets[-1] + _pad4(n))
    return tuple(offsets[:-1]), offsets[-1]


def launch_ssd_chunk(x, dt, a, bm, cm):
    """Enqueue the kernel on the current stream; returns (y, states, decay)
    float32. bm/cm are (BG, nc, Q, N) with BG dividing BH; head bh reads
    group row bh // (BH // BG). Inputs must already be checked (``ops``
    does that)."""
    BH, nc, Q, P = x.shape
    BG, N = bm.shape[0], bm.shape[-1]
    lib = _library()
    offsets, total = _layout(BH, BG, nc, Q, P, N)
    buf = torch.empty(total, dtype=torch.float32, device=x.device)
    base = buf.data_ptr()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.ssd_chunk_launch(
        x.data_ptr(), dt.data_ptr(), a.data_ptr(), bm.data_ptr(),
        cm.data_ptr(), *(base + 4 * o for o in offsets), BH, BG, nc, Q, P,
        N, _pad4(Q), stream)
    if err != 0:
        msg = lib.ssd_chunk_error_string(err).decode()
        raise RuntimeError(f"ssd_chunk launch failed: CUDA error {err} "
                           f"({msg})")
    o_y, o_st, o_dc = offsets[:3]
    return (buf[o_y:o_y + BH * nc * Q * P].view(BH, nc, Q, P),
            buf[o_st:o_st + BH * nc * N * P].view(BH, nc, N, P),
            buf[o_dc:o_dc + BH * nc].view(BH, nc))
