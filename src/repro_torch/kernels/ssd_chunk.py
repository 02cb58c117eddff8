"""The intra-chunk SSD kernel for Hopper and its launch through ``ctypes``.

``csrc/ssd_chunk.cu`` computes what ``src/repro/kernels/ssd_chunk.py::
ssd_chunk_pallas`` computes on the TPU: per (batch·head, chunk) the
lower-triangular ``(C·Bᵀ ∘ L ∘ dt)·x``, the chunk's state contribution and
its decay (see ``ref.ssd_chunk_ref``). It runs as two launches, the y row
blocks and the states/decay tiles.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def _library() -> ctypes.CDLL:
    lib = _build.load("ssd_chunk")
    if lib.ssd_chunk_launch.argtypes is None:
        lib.ssd_chunk_launch.argtypes = _ARGTYPES
        lib.ssd_chunk_launch.restype = ctypes.c_int
        lib.ssd_chunk_error_string.argtypes = [ctypes.c_int]
        lib.ssd_chunk_error_string.restype = ctypes.c_char_p
    return lib


def launch_ssd_chunk(x, dt, a, bm, cm):
    """Enqueue the kernel on the current stream; returns (y, states, decay)
    float32. Inputs must already be checked (``ops`` does that)."""
    BH, nc, Q, P = x.shape
    N = bm.shape[-1]
    kw = dict(dtype=torch.float32, device=x.device)
    y = torch.empty((BH, nc, Q, P), **kw)
    states = torch.empty((BH, nc, N, P), **kw)
    decay = torch.empty((BH, nc), **kw)
    lib = _library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.ssd_chunk_launch(
        x.data_ptr(), dt.data_ptr(), a.data_ptr(), bm.data_ptr(),
        cm.data_ptr(), y.data_ptr(), states.data_ptr(), decay.data_ptr(),
        BH, nc, Q, P, N, stream)
    if err != 0:
        msg = lib.ssd_chunk_error_string(err).decode()
        raise RuntimeError(f"ssd_chunk launch failed: CUDA error {err} "
                           f"({msg})")
    return y, states, decay
