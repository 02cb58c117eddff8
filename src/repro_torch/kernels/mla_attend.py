"""MLA's absorbed attention over the paged latent pool for Hopper, and its
launch through ``ctypes``.

``csrc/mla_latent_attend.cu`` computes what ``ref.mla_latent_attend_ref``
computes: each query row's float32 scores against its slot's bf16 latent
and rope-key rows up to its own position, the softmax rounded to bf16
after its division, and the float32 output in latent space, reading the
pool's pages in place. It replaces no TPU kernel (the JAX package leaves
attention to XLA). Three launches: scores (with partial softmax
statistics), the weighted sum over the latent rows and, when the keys were
split, the sum of the splits.

``plan`` picks the row tile and the key splits from the shapes and the
card's SM count alone.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import _build

# the (latent, rope) widths the kernel is compiled for: DeepSeek-V2-Lite's
# and MiniCPM3-4B's
WIDTHS = ((512, 64), (256, 32))
# page sizes it takes: multiples of PAGE_STEP, read in TMA boxes of
# gcd(page, 32) key rows (whole boxes in a stage of either pass)
PAGE_STEP = 8
COLS = 256                   # latent columns per CTA of the weighted pass
SPLIT3_STEP = 256            # the weighted pass's key splits: multiples

_ARGTYPES = ([ctypes.c_void_p] * 2 + [ctypes.c_longlong] * 4
             + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 15
             + [ctypes.c_float, ctypes.c_void_p])


class Plan(NamedTuple):
    """How one call is cut: ``wm`` 16-row fragments per row tile (the
    score pass's warps cover 64 x ``wn`` keys), ``tiles`` row tiles, and
    the keys per split (``split1``, ``split3``) and split counts of the
    score and weighted passes."""
    wm: int
    wn: int
    tiles: int
    split1: int
    n_split1: int
    split3: int
    n_split3: int


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _split(T: int, ctas: int, step: int, slots: int):
    """Keys per split (a multiple of ``step``) and the split count: as many
    splits as one wave of ``ctas`` CTAs a split fits in the card's
    ``slots`` CTA places (SMs x CTAs an SM, which shared memory sets), and
    equal ones, so no second wave trails behind the first."""
    n = max(1, min(_cdiv(T, step), slots // ctas))
    keys = _cdiv(_cdiv(T, n), step) * step
    return keys, _cdiv(T, keys)


@functools.lru_cache(maxsize=64)
def plan(N: int, H: int, G: int, R: int, T: int, sms: int) -> Plan:
    """The cut of a call with N query rows of H heads in G groups over T
    key positions at latent width R, on a card of ``sms`` SMs (an H100's
    132). A group's S * H (query, head) rows
    are tiled by 16 (one slot of 16 heads decoding; two CTAs of either
    pass fit an SM), 32, 48 (40 heads) or 64 rows (anything wider: a
    prompt chunk; one CTA an SM)."""
    rows = (N // G) * H
    wm = min(_cdiv(rows, 16), 4)
    wn = 4 if wm == 1 else 2
    per_sm = 2 if wm == 1 else 1
    tiles = G * _cdiv(rows, 16 * wm)
    split1, n_split1 = _split(T, tiles, 64 * wn, sms * per_sm)
    split3, n_split3 = _split(T, tiles * (R // COLS), SPLIT3_STEP,
                              sms * per_sm)
    return Plan(wm, wn, tiles, split1, n_split1, split3, n_split3)


@functools.lru_cache(maxsize=None)
def _sms(device: int) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _library() -> ctypes.CDLL:
    lib = _build.load("mla_latent_attend")
    if lib.mla_latent_attend_launch.argtypes is None:
        lib.mla_latent_attend_launch.argtypes = _ARGTYPES
        lib.mla_latent_attend_launch.restype = ctypes.c_int
        lib.mla_latent_attend_error_string.argtypes = [ctypes.c_int]
        lib.mla_latent_attend_error_string.restype = ctypes.c_char_p
    return lib


def launch_mla_latent_attend(q_lat, q_rope, c, kr, page_table, last,
                             scale: float, T: int):
    """Enqueue the launches on the current stream; returns o_lat (N, H, R)
    float32. Inputs must already be checked (``ops`` does that); T is the
    number of key positions the plain version reads."""
    N, H, R = q_lat.shape
    DR = q_rope.shape[-1]
    G, n_logical = page_table.shape
    dev = q_lat.device
    p = plan(N, H, G, R, T, _sms(q_lat.get_device()))
    rows = N * H
    ld_s = _cdiv(T, 4) * 4
    n_stats = _cdiv(2 * p.n_split1 * p.wn * rows, 4) * 4
    part = rows * R if p.n_split3 > 1 else 0
    # the output, then the scratch: the scores, the score pass's partial
    # softmax statistics (a max and a sum of exp per row, split and key
    # slab) and the weighted pass's partial outputs; one allocation, each
    # part on 16 bytes
    work = torch.empty(rows * R + rows * ld_s + n_stats + p.n_split3 * part,
                       dtype=torch.float32, device=dev)
    out = work[:rows * R].view(N, H, R)
    base = work.data_ptr() + 4 * rows * R
    lib = _library()
    err = lib.mla_latent_attend_launch(
        q_lat.data_ptr(), q_rope.data_ptr(), q_lat.stride(0),
        q_lat.stride(1), q_rope.stride(0), q_rope.stride(1), c.data_ptr(),
        kr.data_ptr(), page_table.data_ptr(), last.data_ptr(), base,
        base + 4 * rows * ld_s, base + 4 * (rows * ld_s + n_stats),
        out.data_ptr(), R, DR, H, N // G, G, n_logical, c.shape[0],
        c.shape[1], T, ld_s,
        p.wm, p.split1, p.n_split1, p.split3, p.n_split3, float(scale),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        msg = lib.mla_latent_attend_error_string(err).decode()
        raise RuntimeError(f"mla_latent_attend launch failed: CUDA error "
                           f"{err} ({msg})")
    return out
