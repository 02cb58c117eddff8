"""Host-side helpers of the CUDA SwiGLU tiles (``repro_torch.kernels.
dualsparse_ffn``): the row-tile plan against the header's constants and
the threshold's edges, and the position keys the fused kernel's combine
gathers each token's rows by, against the plain combine order.

The tests marked ``cuda`` run the kernels themselves on the card, against
their plain versions, at reduced widths on both sides of the few-row
threshold, on float32 operands (the FMA tiles, bar 1e-5) and bfloat16 ones
(the tensor-core tiles, bar 1e-3: h rounded to bf16 on both sides, one bf16
ulp where an h element's float32 sums straddle a rounding boundary); they
skip without a card. Run them on one with
``PYTHONPATH=src python -m pytest -m cuda --noconftest
tests/test_torch_swiglu_tiles.py`` (this file imports no JAX)."""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import dualsparse_ffn as D
from repro_torch.kernels import ops

HEADER = (Path(__file__).resolve().parents[1] / "src" / "repro_torch" /
          "kernels" / "csrc" / "swiglu_tiles.cuh").read_text()


def _constant(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", HEADER).group(1))


def _i32(values):
    return torch.tensor(values, dtype=torch.int32)


def test_tile_plan_mirrors_the_header():
    """FEW_ROWS, MANY_ROWS and the rows a warp of the float32 FMA tiles
    multiplies (32 threads over BN / TN columns, rows / ROW_THREADS rows
    each) are the tiles' own."""
    assert D.FEW_ROWS == _constant("FEW_ROWS")
    assert D.MANY_ROWS == _constant("MANY_ROWS")
    columns = _constant("BN") // _constant("TN")
    row_threads = _constant("NT") // columns
    assert D.ROW_STEP[torch.float32] == {
        1: 32 // columns * (D.FEW_ROWS // row_threads),
        2: 32 // columns * (D.MANY_ROWS // row_threads)}
    assert "launch_tile<FEW_ROWS, FEW_TM, kBuffer>" in HEADER
    assert "launch_tile<MANY_ROWS, MANY_TM, kBuffer>" in HEADER


def test_bf16_tile_plan_mirrors_the_header():
    """The bf16 tensor-core tiles: the few-row tile steps its rows on the
    mma's N side (MMA_N), two steps cover FEW_ROWS; the many-row tile
    gives each of 4 warps down the rows MMA_M rows of a MANY_ROWS block;
    a ring step carries 128 B of each weight row; the few-row up tile's 8
    warps each take 16 neurons of the strip, and the down strip is as wide
    as the up strip."""
    m, n = _constant("MMA_M"), _constant("MMA_N")
    assert (D.MMA_M, D.MMA_N) == (m, n)
    assert D.ROW_STEP[torch.bfloat16] == {1: n, 2: m}
    assert D.FEW_ROWS == 2 * n and D.MANY_ROWS == 4 * m
    assert _constant("MMA_BK") * 2 == 128
    assert _constant("MMA_BN_UP") == 16 * _constant("NT") // 32
    assert _constant("MMA_BN_DOWN") == _constant("MMA_BN_UP")
    assert "launch_mma_tile<FEW_ROWS, kBuffer>" in HEADER
    assert "launch_mma_tile<MANY_ROWS, kBuffer>" in HEADER


def _round_up(n: int, step: int) -> int:
    return -(-n // step) * step


R = D.FEW_ROWS
DTYPES = [torch.float32, torch.bfloat16]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("cf,cm,capacity,regime,live", [
    # exactly R and R+1 live rows, at capacity, empty, MAJOR-only only
    ([R, R - 6, 2 * R + 8, 0, 0], [0, 7, 24, 0, 3], 2 * R + 32,
     [1, 2, 2, 1, 1], [R, R + 1, 2 * R + 32, 0, 3]),
    # counts past the capacity are clamped first: R - 4 + 9 -> R rows
    ([R - 4, 2 * R + 14, 2], [9, 0, 1], R, [1, 1, 1], [R, R, 3]),
    # a decode-sized capacity never reaches the many-row tile
    ([1, 2, 0], [1, 0, 0], 8, [1, 1, 1], [2, 2, 0]),
])
def test_tile_plan_regimes_and_row_slots(cf, cm, capacity, regime, live,
                                         dtype):
    """Each group's row slots are its live rows rounded up to the row step
    of the tile that serves it."""
    got_regime, got_slots = D.tile_plan(_i32(cf), _i32(cm), capacity,
                                        dtype)
    assert got_regime.tolist() == regime
    step = D.ROW_STEP[dtype]
    assert got_slots.tolist() == [_round_up(n, step[r])
                                  for n, r in zip(live, regime)]


@pytest.mark.parametrize("dtype", DTYPES)
def test_tile_plan_keeps_dead_row_slots_small_at_the_chunk_shape(dtype):
    """At the paged engine's chunk (C = 64, a few rows per group) the row
    slots stay within one row step of the live rows; a 64-row block per
    group would multiply 64 slots each, the few-row tile at most
    FEW_ROWS."""
    rng = np.random.default_rng(0)
    cf = rng.integers(0, 4, 128).astype(np.int32)
    cm = rng.integers(0, 2, 128).astype(np.int32)
    regime, slots = D.tile_plan(torch.from_numpy(cf), torch.from_numpy(cm),
                                64, dtype)
    live = cf + cm
    assert (regime == 1).all()
    assert ((slots.numpy() - live) < D.ROW_STEP[dtype][1]).all()
    assert slots.sum() <= D.FEW_ROWS * (live > 0).sum() \
        < 64 * (live > 0).sum()
    if dtype == torch.float32:
        assert slots.sum() < 2 * live.sum()


def test_position_keys_give_the_combine_order():
    """Positions past a group's rows (overflow, drops, padding) get -1;
    the other positions, sorted stably by key, are the combine order."""
    tok = _i32([2, 0, 2, 1, 0, 2, 1, 0, 0])
    offs = _i32([0, 3, 3])                          # group 1 empty
    cf = _i32([2, 0, 2])
    cm = _i32([1, 0, 1])
    key = D.position_keys(tok, offs, cf, cm)
    assert key.tolist() == [2, 0, 2, 1, 0, 2, -1, -1, -1]
    order, start, count = D.combine_order(tok, offs, cf, cm, 3)
    assert count.tolist() == [int((key == t).sum()) for t in range(3)]
    for t in range(3):
        s, c = int(start[t]), int(count[t])
        assert order[s:s + c].tolist() == \
            torch.nonzero(key == t)[:, 0].tolist()


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def _weights(gen, E, P, d, f, dev, dtype):
    def randn(*shape):
        return (torch.randn(shape, generator=gen) * 0.1).to(dev, dtype)
    return randn(E * P, d, f), randn(E * P, d, f), randn(E * P, f, d)


# float32: the same products summed in another order; bf16: h rounded to
# bf16 on both sides
BAR = {torch.float32: 1e-5, torch.bfloat16: 1e-3}
# (d, f, n_minor_start): 16-byte widths, scalar widths, and 16-byte widths
# with a MAJOR half of 21 neurons, so MAJOR-only rows stop mid-copy
WIDTHS = [(64, 48, None), (66, 45, None), (64, 48, 21)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d,f,nms", WIDTHS)
def test_grouped_kernel_matches_plain_across_the_threshold(cuda, d, f, nms,
                                                           dtype):
    """Groups of R and R+1 live rows, one with counts past the capacity
    (clamped to C on the device), an empty one and MAJOR-only rows, on
    16-byte and on scalar widths: the kernel equals its plain version to
    the dtype's bar, bit for bit across launches, dead rows 0 (with the
    buffer's dead rows filled with NaN first), in x's type, and reports the
    row tile ``tile_plan`` predicts."""
    gen = torch.Generator().manual_seed(0)
    R, C, P = D.FEW_ROWS, D.FEW_ROWS + 24, 2
    live = [R, R + 1, C + 7, 0, 3, 1]
    cf = _i32([R - 5, R + 1, C + 3, 0, 0, 1]).to(cuda)
    cm = _i32(live).to(cuda) - cf
    x = torch.randn((len(live), C, d), generator=gen).to(cuda, dtype)
    dead = torch.arange(C, device=cuda)[None, :] >= (cf + cm)[:, None]
    x[dead] = float("nan")
    w1, w3, w2 = _weights(gen, len(live), P, d, f, cuda, dtype)
    kw = dict(p_factor=P, n_minor_start=nms)
    y1 = ops.grouped_swiglu(x, w1, w3, w2, cf, cm, **kw)
    y2 = ops.grouped_swiglu(x, w1, w3, w2, cf, cm, **kw)
    want = ops.grouped_swiglu_ref(x.nan_to_num(), w1, w3, w2, cf, cm, **kw)
    assert y1.dtype == dtype and torch.equal(y1, y2)
    err = float((y1.float() - want.float()).norm() / want.float().norm())
    assert err <= BAR[dtype]
    assert (y1[dead] == 0).all()
    regime = torch.zeros(len(live), dtype=torch.int32, device=cuda)
    D.launch_grouped_swiglu(x, w1, w3, w2, cf, cm, p_factor=P,
                            n_major=D.resolve_n_major(f, P, nms, 128),
                            regime=regime)
    assert regime.tolist() == D.tile_plan(cf, cm, C, dtype)[0].tolist()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d,f,nms", WIDTHS)
def test_fused_kernel_matches_plain_across_the_threshold(cuda, d, f, nms,
                                                         dtype):
    """The fused pipeline on groups of R and R+1 live rows, one at
    capacity, an empty one and MAJOR-only rows, with padding positions and
    tokens drawn more than once: equal to its plain version to the dtype's
    bar, bit for bit across launches, with the row tiles ``tile_plan``
    predicts."""
    gen = torch.Generator().manual_seed(2)
    R, C, P, T = D.FEW_ROWS, D.FEW_ROWS + 24, 2, 48
    live = [R, R + 1, C, 0, 3, 1]
    cf = _i32([R - 5, R + 1, C - 7, 0, 0, 1])
    cm = _i32(live) - cf
    sizes = torch.tensor(live) + torch.tensor([0, 2, 5, 1, 0, 0])
    offs = (torch.cumsum(sizes, 0) - sizes).to(torch.int32)
    n_pos = int(sizes.sum()) + 8                    # 8 padding entries
    tok = torch.randint(0, T, (n_pos,), generator=gen, dtype=torch.int32)
    comb = torch.rand((n_pos,), generator=gen)
    x = torch.randn((T, d), generator=gen).to(dtype)
    w1, w3, w2 = _weights(gen, len(live), P, d, f, "cpu", dtype)
    args = [a.to(cuda) for a in (x, w1, w3, w2, offs, cf, cm, tok, comb)]
    kw = dict(capacity=C, p_factor=P, n_minor_start=nms)
    y1 = ops.fused_moe_pipeline(*args, **kw)
    y2 = ops.fused_moe_pipeline(*args, **kw)
    want = ops.fused_moe_pipeline_ref(*args, **kw)
    assert y1.dtype == dtype and torch.equal(y1, y2)
    err = float((y1.float() - want.float()).norm() / want.float().norm())
    assert err <= BAR[dtype]
    regime = torch.zeros(len(live), dtype=torch.int32, device=cuda)
    D.launch_fused_moe_pipeline(
        *args, capacity=C, p_factor=P,
        n_major=D.resolve_n_major(f, P, nms, 128), regime=regime)
    assert regime.tolist() == D.tile_plan(cf, cm, C, dtype)[0].tolist()


@pytest.mark.cuda
def test_device_position_keys_match_plain(cuda):
    """The fused kernel's first launch marks the positions as
    ``position_keys`` does, padding and overflow included."""
    rng = np.random.default_rng(1)
    E, C, T = 16, 12, 40
    sizes = rng.integers(0, 2 * C, E)
    offs = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int32)
    n_pos = int(sizes.sum()) + 8                    # 8 padding entries
    tok = rng.integers(0, T, n_pos).astype(np.int32)
    cf = np.minimum(rng.integers(0, C, E), sizes).astype(np.int32)
    cm = np.minimum(np.minimum(sizes, C) - cf, 3).clip(0).astype(np.int32)
    args = [torch.from_numpy(a).to(cuda) for a in (tok, offs, cf, cm)]
    got = D.launch_position_keys(*args, capacity=C)
    assert torch.equal(got, D.position_keys(*args))
