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

Both take float32 operands, or bfloat16 ones (the S-ETP wire type) whose
products are summed in float32 on the tensor cores, with h rounded to
bf16 before the down product. The fused kernel's output is float32 (cast
to x's type by ``ops``); the grouped kernel writes its output in x's type.

Both run the row tiles of ``csrc/swiglu_tiles.cuh``, which choose on the
device, per group, between a few-row and a many-row tile: on float32
operands an FMA few-row tile and a 3xTF32 many-row tile (``wgmma``, fed
by TMA, its width following the live rows), on bf16 ones ``mma.sync``
tiles. ``tile_plan`` says on the host which tile serves each group and
how many row slots it multiplies.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

I32 = torch.int32

# the row tiles of csrc/swiglu_tiles.cuh: groups with at most FEW_ROWS live
# rows take the few-row tile (regime 1), the others the many-row tile
# (regime 2), in row blocks of MANY_ROWS (bf16) or TF32_ROWS (float32).
# ROW_STEP[dtype][regime]: the rows the tile multiplies in one unit, dead or
# live. The float32 few-row FMA tile: 16 threads share a row (64 columns,
# 4 each), so a warp multiplies 2 rows, and warps without a live row skip
# the FMAs. The float32 many-row tile puts a row block's rows on the wgmma's
# N side, N its live rows rounded up to TF32_N_STEP (a divisor of
# TF32_ROWS). The bf16 many-row tile gives each warp MMA_M = 16 rows on the
# mma's M side, and warps without a live row skip their products; its
# few-row tile puts the rows on the mma's N side (steps of MMA_N = 8 rows).
FEW_ROWS = 16
MANY_ROWS = 64
TF32_ROWS, TF32_N_STEP = 128, 32
MMA_M, MMA_N = 16, 8
ROW_STEP = {torch.float32: {1: 2 * FEW_ROWS // 16, 2: TF32_N_STEP},
            torch.bfloat16: {1: MMA_N, 2: MMA_M}}


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


def tile_plan(counts_full, counts_major, capacity: int,
              dtype=torch.float32):
    """The row tile of each group and the row slots it multiplies, for
    operands of ``dtype``.

    Returns ``(regime, row_slots)``, (E,) int64: regime 1 (the few-row
    tile) for groups of at most ``FEW_ROWS`` live rows ``min(cf + cm, C)``,
    2 (the many-row tile) for larger ones; ``row_slots`` counts the rows a
    MAJOR strip multiplies — the live rows rounded up to the tile's row
    step ``ROW_STEP[dtype]`` (the slots of the products, dead or live)."""
    n_rows = torch.clamp(counts_full.long() + counts_major.long(),
                         max=capacity)
    regime = torch.where(n_rows <= FEW_ROWS, 1, 2)
    steps = ROW_STEP[dtype]
    step = torch.where(regime == 1, steps[1], steps[2])
    return regime, (n_rows + step - 1) // step * step


def position_keys(tok_sorted, group_offsets, counts_full, counts_major):
    """Each sorted position's token when some row tile computes it, else
    -1: position p lies in the last group g with ``offs[g] <= p`` (group 0
    if none) and is computed when ``p - offs[g] < cf[g] + cm[g]``.
    Positions past an expert's clamped rows — capacity overflow, dropped
    pairs, the padding — get -1. The CUDA kernel marks them the same way on
    the device (``launch_position_keys``)."""
    dev = tok_sorted.device
    pos = torch.arange(tok_sorted.shape[0], dtype=I32, device=dev)
    offs = group_offsets.contiguous()
    g = (torch.searchsorted(offs, pos, right=True) - 1).clamp(min=0)
    rows = (counts_full + counts_major)[g]
    valid = (pos - offs[g]) < rows
    return torch.where(valid, tok_sorted, torch.full_like(tok_sorted, -1))


def combine_order(tok_sorted, group_offsets, counts_full, counts_major,
                  n_tokens: int):
    """Per-token lists of the sorted positions some row tile computes.

    Returns ``(order, start, count)``: token t's positions are
    ``order[start[t] : start[t] + count[t]]`` in increasing order (a stable
    sort of the ``position_keys``); positions no tile computes are left
    out. The plain version's combine order; the CUDA kernel's combine
    gathers the same lists from the keys on the device."""
    dev = tok_sorted.device
    key = position_keys(tok_sorted, group_offsets, counts_full, counts_major)
    key = torch.where(key >= 0, key, torch.full_like(key, n_tokens))
    order = torch.argsort(key, stable=True).to(I32)
    count = torch.zeros(n_tokens + 1, dtype=I32, device=dev)
    count.scatter_add_(0, key.long(), torch.ones_like(key))
    count = count[:n_tokens]
    start = torch.cumsum(count, 0) - count
    return order, start.to(I32), count.to(I32)


_ARGTYPES = {
    "fused_moe_pipeline": ([ctypes.c_void_p] * 14 + [ctypes.c_int] * 9
                           + [ctypes.c_void_p]),
    "grouped_swiglu": ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 7
                       + [ctypes.c_void_p]),
}

# the operand types the tiles are instantiated for (the C flag ``bf16``)
ELEMENT_TYPES = (torch.float32, torch.bfloat16)


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


def _ptr(t) -> int:
    """A tensor's device pointer, 0 for ``None``."""
    return 0 if t is None else t.data_ptr()


def _raise_on_error(lib: ctypes.CDLL, name: str, err: int) -> None:
    if err != 0:
        msg = getattr(lib, f"{name}_error_string")(err).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {err} ({msg})")


def ring_bytes(dtype=torch.float32) -> dict:
    """The dynamic shared memory (bytes) of one CTA of each row tile's up and
    down launch for operands of ``dtype``, as the built library computes
    it."""
    lib = _library("grouped_swiglu")
    fn = lib.grouped_swiglu_ring_bytes
    fn.argtypes = [ctypes.c_int] * 3
    fn.restype = ctypes.c_int
    bf16 = dtype == torch.bfloat16
    return {f"{launch}_{tile}": fn(launch == "up", tile == "few", bf16)
            for launch in ("up", "down") for tile in ("few", "many")}


def _scratch(h, shape, like):
    """The caller's h scratch, checked, or a new one."""
    if h is None:
        return torch.empty(shape, dtype=like.dtype, device=like.device)
    if (tuple(h.shape) != shape or h.dtype != like.dtype
            or h.device != like.device or not h.is_contiguous()):
        raise ValueError(f"h scratch must be a contiguous {shape} "
                         f"{like.dtype} tensor on {like.device}")
    return h


def launch_fused_moe_pipeline(x, w1, w3, w2, group_offsets, counts_full,
                              counts_major, tok_sorted, combine_sorted, *,
                              capacity: int, p_factor: int, n_major: int,
                              regime=None, h=None):
    """Enqueue the CUDA kernel on the current stream; returns the (T, d)
    float32 output. x and the weights are float32 or bfloat16 (one type);
    inputs must already be checked (``ops`` does that).
    ``regime``: an (E,) int32 CUDA tensor that receives the row tile that
    served each group (see ``tile_plan``), or ``None``. ``h``: the
    (N', p_factor * f) scratch in the weights' type, or ``None`` (a new
    one); the entries no up tile writes (the MINOR neurons of MAJOR-only row
    blocks) keep what it held."""
    lib = _library("fused_moe_pipeline")
    T, d = x.shape
    f = w1.shape[-1]
    E = group_offsets.shape[0]
    n_pos = tok_sorted.shape[0]
    h = _scratch(h, (n_pos, p_factor * f), w1)
    y = torch.empty((n_pos, d), dtype=torch.float32, device=x.device)
    key = torch.empty((n_pos,), dtype=I32, device=x.device)
    out = torch.empty((T, d), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.fused_moe_pipeline_launch(
        x.data_ptr(), w1.data_ptr(), w3.data_ptr(), w2.data_ptr(),
        group_offsets.data_ptr(), counts_full.data_ptr(),
        counts_major.data_ptr(), tok_sorted.data_ptr(),
        combine_sorted.data_ptr(), h.data_ptr(), y.data_ptr(),
        key.data_ptr(), out.data_ptr(), _ptr(regime), T, n_pos, d, f, E,
        p_factor, n_major, capacity, x.dtype == torch.bfloat16, stream)
    _raise_on_error(lib, "fused_moe_pipeline", err)
    return out


def launch_position_keys(tok_sorted, group_offsets, counts_full,
                         counts_major, capacity: int):
    """The fused kernel's first launch alone on CUDA tensors: the (N',)
    int32 ``position_keys``, counts clamped to ``capacity`` as the tiles
    clamp them."""
    lib = _library("fused_moe_pipeline")
    fn = lib.fused_moe_pipeline_position_keys
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    key = torch.empty(tok_sorted.shape, dtype=I32, device=tok_sorted.device)
    err = fn(tok_sorted.data_ptr(), group_offsets.data_ptr(),
             counts_full.data_ptr(), counts_major.data_ptr(), key.data_ptr(),
             tok_sorted.shape[0], group_offsets.shape[0], capacity,
             torch.cuda.current_stream(tok_sorted.device).cuda_stream)
    _raise_on_error(lib, "fused_moe_pipeline", err)
    return key


def launch_grouped_swiglu(x, w1, w3, w2, counts_full, counts_major, *,
                          p_factor: int, n_major: int, regime=None, h=None):
    """Enqueue the grouped SwiGLU kernel on the current stream; returns the
    (E, C, d) output in x's type (bf16: the float32 sums rounded once),
    dead rows exact zeros. x and the weights are float32 or bfloat16 (one
    type); inputs must already be checked (``ops`` does that); counts past
    C are clamped on the device. ``regime`` as for
    ``launch_fused_moe_pipeline``; ``h`` likewise, (E * C, p_factor * f)."""
    E, C, d = x.shape
    f = w1.shape[-1]
    out = torch.empty((E, C, d), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    lib = _library("grouped_swiglu")
    h = _scratch(h, (E * C, p_factor * f), w1)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.grouped_swiglu_launch(
        x.data_ptr(), w1.data_ptr(), w3.data_ptr(), w2.data_ptr(),
        counts_full.data_ptr(), counts_major.data_ptr(), h.data_ptr(),
        out.data_ptr(), _ptr(regime), E, C, d, f, p_factor, n_major,
        x.dtype == torch.bfloat16, stream)
    _raise_on_error(lib, "grouped_swiglu", err)
    return out
