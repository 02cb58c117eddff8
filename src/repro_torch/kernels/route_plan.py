"""Routing, 2T-Drop keep mask and dispatch plan of one MoE layer call for
Hopper, and their launch through ``ctypes``.

``csrc/moe_route_plan.cu`` computes, from the router logits, what the
composed ops between the router GEMM and the fused MoE kernel compute
(``ref.moe_route_plan_ref``): the top-k routing, the 2T modes, the
original-expert sort plan and the arguments ``ops.fused_moe_pipeline``
takes, the overflow and the obs counters. It replaces no TPU kernel (the
JAX package leaves these ops to XLA); it exists because PyTorch runs them
as ~100 small launches a layer call. Two launches: the route (one warp
per token row) and the plan (one CTA).

Every output is a view of one int32 allocation (the float32 parts
reinterpreted).
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import _build

# the largest router width and top-k the launches take (a lane holds 32
# scores of a row and two selected pairs)
MAX_EXPERTS = 1024
MAX_TOP_K = 64


class RoutePlan(NamedTuple):
    """One layer call's routing and plan. ``idx`` / ``modes`` / ``combine``
    are per ORIGINAL pair (T, K); the plan is over original experts with
    FULL rows before MAJOR-only rows, as ``core.moe.fused_pipeline_args``
    builds it; the counters are in sub-pair units."""
    idx: torch.Tensor             # (T, K) int32 expert ids
    modes: torch.Tensor           # (T, K) int32 2T modes (0 drop, 1, 2)
    combine: torch.Tensor         # (T, K) float32 combine weights
    group_offsets: torch.Tensor   # (E,) int32
    counts_full: torch.Tensor     # (E,) int32, clamped to capacity
    counts_major: torch.Tensor    # (E,) int32, clamped with counts_full
    tok_sorted: torch.Tensor      # (T*K + pad,) int32
    combine_sorted: torch.Tensor  # (T*K + pad,) float32, 0 where dropped
    overflow: torch.Tensor        # () int32 kept sub-pairs past capacity
    kept_full: torch.Tensor       # () int32
    kept_major: torch.Tensor      # () int32
    dropped: torch.Tensor         # () int32
    expert_load: torch.Tensor     # (E*P,) int32 kept sub-pairs per sub-id


_ARGTYPES = ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
              ctypes.c_longlong, ctypes.c_float, ctypes.c_void_p,
              ctypes.c_longlong, ctypes.c_longlong, ctypes.c_float]
             + [ctypes.c_void_p] * 10 + [ctypes.c_int] * 7
             + [ctypes.c_void_p])


def _library() -> ctypes.CDLL:
    lib = _build.load("moe_route_plan")
    if lib.moe_route_plan_launch.argtypes is None:
        lib.moe_route_plan_launch.argtypes = _ARGTYPES
        lib.moe_route_plan_launch.restype = ctypes.c_int
        lib.moe_route_plan_error_string.argtypes = [ctypes.c_int]
        lib.moe_route_plan_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=64)
def _sizes(T: int, E: int, K: int, P: int, pad: int):
    """The parts of the call's one allocation, in 4-byte words: idx, modes,
    group_offsets, counts_full, counts_major, tok_sorted, expert_load, the
    four counters (int32), then combine and combine_sorted (float32)."""
    N = T * K
    return (N, N, E, E, E, N + pad, E * P, 4, N, N + pad)


def threshold_arg(t, T: int, K: int, device):
    """A threshold as the launch reads it: ``(tensor or None, token
    stride, pair stride, value)``. A number is passed by value; a float32
    tensor, scalar, per-token (T,) or per-pair (T, K), by pointer and the
    strides that broadcast it over the (T, K) pairs."""
    if not isinstance(t, torch.Tensor):
        return None, 0, 0, float(t)
    t = t.to(device=device, dtype=torch.float32)
    if t.ndim > 2 or (t.ndim and t.shape[0] != T) or \
            (t.ndim == 2 and t.shape[1] != K):
        raise ValueError(f"moe_route_plan: a threshold must be a scalar, "
                         f"(T,) or (T, K) = ({T}, {K}); got "
                         f"{tuple(t.shape)}")
    strides = t.stride() + (0,) * (2 - t.ndim)
    return t, strides[0], strides[1], 0.0


def launch_moe_route_plan(logits, t_major, t_minor, *, top_k: int,
                          renorm: bool, p_factor: int, capacity: int,
                          pad: int) -> RoutePlan:
    """Enqueue both launches on the current stream; returns the
    ``RoutePlan`` as views of the call's one allocation. ``logits``: (T, E)
    float32, contiguous; thresholds as ``threshold_arg`` takes them; inputs
    otherwise checked by ``ops``."""
    T, E = logits.shape
    K, P = top_k, p_factor
    dev = logits.device
    lib = _library()
    sizes = _sizes(T, E, K, P, pad)
    buf = torch.empty(sum(sizes), dtype=torch.int32, device=dev)
    idx, modes, offs, cf, cm, tok, load, scalars, comb, comb_sorted = \
        buf.split(sizes)
    comb, comb_sorted = comb.view(torch.float32), comb_sorted.view(
        torch.float32)
    tm, tm_st, tm_sk, tm_v = threshold_arg(t_major, T, K, dev)
    tn, tn_st, tn_sk, tn_v = threshold_arg(t_minor, T, K, dev)
    err = lib.moe_route_plan_launch(
        logits.data_ptr(), 0 if tm is None else tm.data_ptr(), tm_st, tm_sk,
        tm_v, 0 if tn is None else tn.data_ptr(), tn_st, tn_sk, tn_v,
        idx.data_ptr(), modes.data_ptr(), comb.data_ptr(), offs.data_ptr(),
        cf.data_ptr(), cm.data_ptr(), tok.data_ptr(), comb_sorted.data_ptr(),
        load.data_ptr(), scalars.data_ptr(), T, E, K, P, int(renorm),
        capacity, pad, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        msg = lib.moe_route_plan_error_string(err).decode()
        raise RuntimeError(f"moe_route_plan launch failed: CUDA error {err} "
                           f"({msg})")
    overflow, kept_full, kept_major, dropped = scalars.unbind()
    return RoutePlan(idx=idx.view(T, K), modes=modes.view(T, K),
                     combine=comb.view(T, K), group_offsets=offs,
                     counts_full=cf, counts_major=cm, tok_sorted=tok,
                     combine_sorted=comb_sorted, overflow=overflow,
                     kept_full=kept_full, kept_major=kept_major,
                     dropped=dropped, expert_load=load)
