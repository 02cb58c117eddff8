"""Host-side helpers of the CUDA SwiGLU tiles (``repro_torch.kernels.
dualsparse_ffn``): the row-tile plan against the header's constants and
the threshold's edges, the float32 many-row tile's swizzled fragment
reads, ring and registers, its 3xTF32 products emulated in numpy, and the
position keys the fused kernel's combine gathers each token's rows by,
against the plain combine order.

The tests marked ``cuda`` run the kernels themselves on the card, against
their plain versions, at reduced widths on both sides of the few-row
threshold, on float32 operands (an FMA few-row tile and a 3xTF32 wgmma
many-row tile, bar 1e-5; that tile also at Qwen3-30B-A3B, DBRX-132B and
DeepSeek-V2-Lite widths on both sides of each wgmma width) and bfloat16
ones (the tensor-core tiles, bar 1e-3: h rounded to bf16 on both sides,
one bf16 ulp where an h element's float32 sums straddle a rounding
boundary); they skip without a card. Run them on one with ``PYTHONPATH=src
python -m pytest -m cuda --noconftest tests/test_torch_swiglu_tiles.py``
(this file imports no JAX)."""
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
    """FEW_ROWS, the row blocks and the rows each float32 tile multiplies in
    one unit: the few-row FMA tile's 32 threads over BN / TN columns,
    FEW_ROWS / ROW_THREADS rows each; the many-row 3xTF32 tile's wgmma N,
    a TF32_ROWS block's live rows rounded up to TF32_N_STEP (a divisor of
    the block, so a group's row slots are its live rows rounded up to the
    step), each such N a wgmma width the kernels dispatch. Each is the
    tiles' own, and a many-row float32 group launches the wgmma tile, never
    the FMA one."""
    assert D.FEW_ROWS == _constant("FEW_ROWS")
    assert D.MANY_ROWS == _constant("MANY_ROWS")
    assert (D.TF32_ROWS, D.TF32_N_STEP) == (_constant("TF32_ROWS"),
                                            _constant("TF32_N_STEP"))
    columns = _constant("BN") // _constant("TN")
    row_threads = _constant("NT") // columns
    assert D.ROW_STEP[torch.float32] == {
        1: 32 // columns * (D.FEW_ROWS // row_threads),
        2: _constant("TF32_N_STEP")}
    assert D.TF32_ROWS % D.TF32_N_STEP == 0 and D.TF32_N_STEP % 8 == 0
    assert D.TF32_ROWS <= 256 and D.TF32_N_STEP > D.FEW_ROWS
    widths = range(D.TF32_N_STEP, D.TF32_ROWS + 1, D.TF32_N_STEP)
    for n in widths:
        assert f"struct Wgmma<{n}> {{" in HEADER
        assert f"m64n{n}k8.f32.tf32.tf32" in HEADER
        assert n == D.TF32_ROWS or f"case {n}:" in HEADER
    assert HEADER.count("struct Wgmma<") == len(widths)
    assert D.MANY_ROWS == 4 * _constant("MMA_M")
    assert "up_kernel<FEW_ROWS, TM, kBuffer, float>" in HEADER
    assert "launch_fma_tile<kBuffer>(pb, E, stream, up);" in HEADER
    assert "launch_tf32_tile<kBuffer>(pb, E, stream, up);" in HEADER
    assert "up_kernel<MANY_ROWS" not in HEADER


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


def _sw128(r: int, c: int) -> int:
    """``sw128``: the byte offset of 16-byte chunk c of 128-byte row r under
    TMA's 128-byte swizzle."""
    return r * 128 + ((c ^ (r & 7)) << 4)


def _m_index(wq: int, g: int, hh: int) -> int:
    """``tf32_m_index``: the M index of fragment row g + 8 hh of warp wq."""
    return (_constant("TF32_BOX") * (wq >> 1)
            + 4 * (4 * (g >> 2) + hh + 2 * (wq & 1)) + (g & 3))


def _tf32_ring():
    """The float32 many-row tile's ring, from the header's constants: the
    bytes of a stage (four weight boxes, the row tile's big and small
    parts) and of one CTA's dynamic and static shared memory."""
    bk, rows = _constant("TF32_BK"), _constant("TF32_ROWS")
    stages = _constant("TF32_STAGES")
    box = bk * 128
    stage = 4 * box + 2 * rows * 128
    dynamic = stages * stage + 1024          # + the 1024-byte alignment
    static = 3 * 8 * stages + 4 * rows + 4 * rows   # Tf32Shared
    return stage, dynamic, static


def test_tf32_tile_fragment_reads_are_free_of_bank_conflicts():
    """The float32 many-row tile reads its wgmma A fragments (the weights)
    with 32-bit shared loads from the TMA-swizzled boxes (32 neurons or
    columns a 128-byte row, one row per k): lane (g, t) of warp wq reads M
    index ``tf32_m_index(wq, g, hh)`` at k t and t + 4. The 64 M indices of
    a consumer are each read by one (warp, g, hh); for every warp and
    fragment register the 32 lanes hit 32 distinct banks. The producer's
    16-byte chunks of the row tile (thread q: row q / 8, chunk q % 8) put
    each quarter-warp on one whole 128-byte row, so its cp.async copies and
    its split's 16-byte loads and stores take the fewest wavefronts. The
    header's helpers are these formulas."""
    assert "return r * 128 + ((c ^ (r & 7)) << 4);" in HEADER
    assert ("return TF32_BOX * (wq >> 1) + 4 * (4 * (g >> 2) + hh + "
            "2 * (wq & 1)) +\n         (g & 3);") in HEADER
    box = _constant("TF32_BOX")
    assert box * 4 == 128 and 2 * box == _constant("TF32_M")
    seen = sorted(_m_index(wq, g, hh) for wq in range(4) for g in range(8)
                  for hh in range(2))
    assert seen == list(range(_constant("TF32_M")))
    box_bytes = _constant("TF32_BK") * 128
    for wq in range(4):
        for hh in range(2):
            for k_off in (0, 4):
                for kk in range(_constant("TF32_BK") // 8):
                    banks = set()
                    for lane in range(32):
                        g, t = lane // 4, lane % 4
                        m = _m_index(wq, g, hh)
                        k = 8 * kk + t + k_off
                        byte = ((m // box) * box_bytes
                                + _sw128(k, (m % box) // 4) + 4 * (m % 4))
                        banks.add(byte // 4 % 32)
                    assert len(banks) == 32
    for warp in range(4):
        for quarter in range(4):
            qs = [32 * warp + 8 * quarter + i for i in range(8)]
            rows = {q >> 3 for q in qs}
            chunks = {_sw128(q >> 3, q & 7) % 128 // 16 for q in qs}
            assert len(rows) == 1 and chunks == set(range(8))


def test_tf32_tile_ring_and_registers_fit_the_sm():
    """The ring's stages (16 KB of weights, 16 KB of rows, 16 KB of their
    small parts each), the alignment and the barriers and row tables fit
    one CTA's shared memory (227 KB, 1 KB of it the system's); every stage
    starts on a 1024-byte swizzle period; setmaxnreg's split (the producer
    warpgroup down, the two consumers up), in multiples of 8 within [24,
    256], stays within the registers the CTA is launched with (65536 / 384
    a thread, rounded down to 8): setmaxnreg moves only those, and a
    consumer's increase past them would wait forever."""
    stage, dynamic, static = _tf32_ring()
    assert stage % 1024 == 0 and (stage // 2) % 1024 == 0
    assert _constant("TF32_BK") * 4 * 128 % 1024 == 0
    assert dynamic + static + 1024 <= 232448
    assert _constant("TF32_STAGES") >= 3
    low, high = _constant("TF32_PRODUCER_REGS"), _constant(
        "TF32_CONSUMER_REGS")
    loaders, consumers = _constant("TF32_LOADERS"), _constant(
        "TF32_CONSUMERS")
    assert loaders == 128 and consumers == 256
    launch = 65536 // (loaders + consumers) // 8 * 8
    assert launch == 168
    assert low * loaders + high * consumers <= launch * (loaders + consumers)
    assert low < launch < high
    assert all(24 <= r <= 256 and r % 8 == 0 for r in (low, high))


def _tf32_big(v):
    """split_tf32's big part: float32 v with its 13 low mantissa bits
    cleared (also what the tensor core reads of a float32 operand)."""
    bits = np.asarray(v, np.float32).view(np.uint32) & np.uint32(0xFFFFE000)
    return bits.view(np.float32)


def _round_to_zero(v):
    """float64 v rounded to float32 toward zero, as the tensor cores round
    the float32 sums they accumulate."""
    f = v.astype(np.float32)
    over = np.abs(f.astype(np.float64)) > np.abs(v)
    return np.where(over, np.nextafter(f, np.float32(0)), f)


def _mma_dot(a, b, passes: int, per_step: bool = True):
    """a (K,) . b (K, N) as the many-row tile computes it: per 8-deep
    contraction step (one wgmma k step) the pass products (exact: TF32
    mantissas are 11 bits) summed and added to a float32 fragment rounding
    toward zero, pass by pass. ``passes`` 3: 3xTF32 (small.big, big.small,
    big.big, small = v - big read as TF32); 1: one TF32 pass on the
    operands as the tensor core reads them. ``per_step``: the fragment
    restarts from zero every ring stage (TF32_BK of the contraction: the
    stage's first wgmma runs with scale-d 0) and float32 adds that round to
    nearest carry the stages' sums (``tf32_consume``); else one fragment
    takes the whole contraction."""
    restart = _constant("TF32_BK") // 8
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    ab, bb = _tf32_big(a), _tf32_big(b)
    if passes == 3:
        a_s, b_s = _tf32_big(a - ab), _tf32_big(b - bb)
        pairs = [(a_s, bb), (ab, b_s), (ab, bb)]
    else:
        pairs = [(ab, bb)]
    K, N = b.shape
    steps = [np.matmul(pa.astype(np.float64).reshape(K // 8, 1, 8),
                       pb.astype(np.float64).reshape(K // 8, 8, N))[:, 0]
             for pa, pb in pairs]
    acc = part = np.zeros(N, np.float32)
    for k in range(K // 8):
        for step in steps:
            part = _round_to_zero(part.astype(np.float64) + step[k])
        if per_step and k % restart == restart - 1:
            acc, part = (acc + part).astype(np.float32), np.zeros_like(part)
    return (acc + part).astype(np.float32)


def test_3xtf32_swiglu_row_holds_the_float32_bar_and_one_pass_does_not():
    """One SwiGLU row at DBRX-132B's contraction lengths (d = 6144 for up,
    V = 10752 neurons for down), seeded N(0, 1) data: h and the output row
    computed as the float32 many-row tile computes them (``_mma_dot``)
    against float64. Three TF32 passes restarted every ring stage land
    within 1e-5 (norm-relative, the kernels' float32 bar); one TF32 pass
    does not, and neither do three passes left in one round-toward-zero
    fragment for the whole contraction."""
    assert "Wgmma<N>::run(part, as[kk], big + 2 * kk, kk);" in HEADER
    rng = np.random.default_rng(23)
    d, V, n_out, chunk = 6144, 10752, 64, 1344
    x = rng.standard_normal(d, dtype=np.float32)
    h = {name: np.empty(V) for name in ("f64", "3", "1")}
    for n0 in range(0, V, chunk):
        w1 = rng.standard_normal((d, chunk), dtype=np.float32)
        w3 = rng.standard_normal((d, chunk), dtype=np.float32)
        g, u = x.astype(np.float64) @ w1, x.astype(np.float64) @ w3
        h["f64"][n0:n0 + chunk] = g / (1 + np.exp(-g)) * u
        for passes in (3, 1):
            g, u = (_mma_dot(x, w, passes).astype(np.float64)
                    for w in (w1, w3))
            h[str(passes)][n0:n0 + chunk] = np.float32(g / (1 + np.exp(-g))
                                                       * u)
    w2 = rng.standard_normal((V, n_out), dtype=np.float32)
    want = h["f64"] @ w2

    def rel(a, b):
        return float(np.linalg.norm(a - b) / np.linalg.norm(b))
    h3, y3 = h["3"], _mma_dot(h["3"], w2, 3)
    h1, y1 = h["1"], _mma_dot(h["1"], w2, 1)
    assert rel(h3, h["f64"]) <= 1e-5 and rel(y3, want) <= 1e-5
    assert rel(h1, h["f64"]) > 1e-5 and rel(y1, want) > 1e-5
    assert rel(_mma_dot(h3, w2, 3, per_step=False), want) > 1e-5


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


# float32 groups past one TF32_ROWS block: capacity two row blocks;
# groups of MAJOR-only rows only, FULL rows then MAJOR-only rows into the
# second block, all FULL, just past FEW_ROWS, empty, few-row
BLOCKS_C = D.TF32_ROWS + 8
BLOCKS_CF = [0, 20, BLOCKS_C, R + 1, 0, 3]
BLOCKS_CM = [D.MANY_ROWS + 5, 2 * D.MANY_ROWS - 12, 0, 0, 0, 0]


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["grouped", "fused"])
@pytest.mark.parametrize("d,f,nms", WIDTHS)
def test_float32_row_blocks_match_plain_over_a_nan_scratch(cuda, kernel, d,
                                                           f, nms):
    """float32 groups of several TF32_ROWS blocks, some blocks with no FULL
    row, on 16-byte and scalar widths, over an h scratch filled with NaN:
    the 3xTF32 many-row tile equals the plain version to 1e-5, bit for bit
    across launches; the MINOR h of the MAJOR-only blocks, which no up
    tile writes, is still NaN after the launch and reached no product; the
    row tiles are ``tile_plan``'s."""
    gen = torch.Generator().manual_seed(3)
    P, C, E = 2, BLOCKS_C, len(BLOCKS_CF)
    cf, cm = _i32(BLOCKS_CF).to(cuda), _i32(BLOCKS_CM).to(cuda)
    n_major = D.resolve_n_major(f, P, nms, 128)
    w1, w3, w2 = _weights(gen, E, P, d, f, cuda, torch.float32)
    kw = dict(p_factor=P, n_major=n_major)
    if kernel == "grouped":
        x = torch.randn((E, C, d), generator=gen).to(cuda)
        dead = torch.arange(C, device=cuda)[None, :] >= (cf + cm)[:, None]
        x[dead] = float("nan")
        want = ops.grouped_swiglu_ref(x.nan_to_num(), w1, w3, w2, cf, cm,
                                      p_factor=P, n_minor_start=nms)

        def run(h, regime=None):
            return D.launch_grouped_swiglu(x, w1, w3, w2, cf, cm, h=h,
                                           regime=regime, **kw)
        starts, n_pos = [e * C for e in range(E)], E * C
    else:
        T = 96
        sizes = torch.clamp(cf.cpu() + cm.cpu(), max=C) + 2
        offs = (torch.cumsum(sizes, 0) - sizes).to(torch.int32)
        n_pos = int(sizes.sum()) + 8                # 8 padding entries
        tok = torch.randint(0, T, (n_pos,), generator=gen,
                            dtype=torch.int32)
        comb = torch.rand((n_pos,), generator=gen)
        x = torch.randn((T, d), generator=gen)
        x, offs, tok, comb = (a.to(cuda) for a in (x, offs, tok, comb))
        want = ops.fused_moe_pipeline_ref(x, w1, w3, w2, offs, cf, cm, tok,
                                          comb, capacity=C, p_factor=P,
                                          n_minor_start=nms)

        def run(h, regime=None):
            return D.launch_fused_moe_pipeline(
                x, w1, w3, w2, offs, cf, cm, tok, comb, capacity=C, h=h,
                regime=regime, **kw)
        starts = offs.tolist()
    shape = (n_pos, P * f)
    h = torch.full(shape, float("nan"), device=cuda)
    regime = torch.zeros(E, dtype=torch.int32, device=cuda)
    y1 = run(h, regime)
    y2 = run(torch.full(shape, float("nan"), device=cuda))
    torch.cuda.synchronize()
    assert torch.equal(y1, y2)
    assert float((y1 - want).norm() / want.norm()) <= BAR[torch.float32]
    left = sum(int(torch.isnan(h[s + a:s + min(a + b, C), n_major:]).sum())
               for s, a, b in zip(starts, BLOCKS_CF, BLOCKS_CM))
    assert left > 0
    assert regime.tolist() == D.tile_plan(cf, cm, C)[0].tolist()
    if kernel == "grouped":
        assert (y1[dead] == 0).all()


# DeepSeek-V2-Lite's expert widths: d 2048, sub-experts of 704 neurons at
# P 2, 5.5 strips of 128 (the last half empty); groups of few and many
# rows, MAJOR-only rows, an empty group and one at capacity
DSV2_C = 2 * D.MANY_ROWS + 8
DSV2_CF = [R - 3, R + 1, DSV2_C, 0, 0, 2, D.MANY_ROWS + 9, 1]
DSV2_CM = [2, 0, 0, 0, 5, 1, D.MANY_ROWS - 30, 0]


@pytest.mark.cuda
def test_fused_kernel_at_deepseek_v2_lite_widths(cuda):
    """The fused pipeline on float32 operands at d 2048, f 704: equal to
    its plain version to 1e-5, bit for bit across launches, with the row
    tiles ``tile_plan`` predicts; the half-empty last strip of 128
    neurons adds nothing past the 704th."""
    gen = torch.Generator().manual_seed(29)
    d, f, P, T = 2048, 704, 2, 160
    C, E = DSV2_C, len(DSV2_CF)
    cf, cm = _i32(DSV2_CF), _i32(DSV2_CM)
    sizes = torch.clamp(cf + cm, max=C) + 1
    offs = (torch.cumsum(sizes, 0) - sizes).to(torch.int32)
    n_pos = int(sizes.sum()) + 8
    tok = torch.randint(0, T, (n_pos,), generator=gen, dtype=torch.int32)
    comb = torch.rand((n_pos,), generator=gen)
    x = torch.randn((T, d), generator=gen)
    w1, w3, w2 = _weights(gen, E, P, d, f, "cpu", torch.float32)
    args = [a.to(cuda) for a in (x, w1, w3, w2, offs, cf, cm, tok, comb)]
    kw = dict(capacity=C, p_factor=P, n_minor_start=None)
    y1 = ops.fused_moe_pipeline(*args, **kw)
    y2 = ops.fused_moe_pipeline(*args, **kw)
    want = ops.fused_moe_pipeline_ref(*args, **kw)
    assert torch.equal(y1, y2)
    assert float((y1 - want).norm() / want.norm()) <= BAR[torch.float32]
    regime = torch.zeros(E, dtype=torch.int32, device=cuda)
    D.launch_fused_moe_pipeline(
        *args, capacity=C, p_factor=P,
        n_major=D.resolve_n_major(f, P, None, 128), regime=regime)
    assert D.resolve_n_major(f, P, None, 128) == f
    assert regime.tolist() == D.tile_plan(cf, cm, C)[0].tolist()
    assert {1, 2} <= set(regime.tolist())


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


# float32 groups on both sides of FEW_ROWS, of each wgmma width and of the
# TF32_ROWS block (live rows 16 17 32 33 64 65 96 97 128 129 200 0), FULL
# and MAJOR-only rows mixed, MAJOR-only rows alone, and an empty group
WIDTH_CF = [16, 10, 32, 0, 40, 64, 96, 50, 128, 100, 130, 0]
WIDTH_CM = [0, 7, 0, 33, 24, 1, 0, 47, 0, 29, 70, 0]
WIDTH_C = 2 * D.TF32_ROWS
# (d, f) of one sub-expert (P 2): Qwen3-30B-A3B, DBRX-132B and
# DeepSeek-V2-Lite (f_sub 704: eleven 64-neuron up strips)
MODEL_WIDTHS = {"qwen3": (2048, 384), "dbrx": (6144, 5376),
                "deepseek": (2048, 704)}


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["grouped", "fused"])
@pytest.mark.parametrize("model", sorted(MODEL_WIDTHS))
def test_float32_wgmma_widths_match_plain_at_model_widths(cuda, kernel,
                                                          model):
    """The float32 many-row tile at the models' widths, on groups either
    side of FEW_ROWS, of each wgmma width (live rows rounded up to
    TF32_N_STEP) and of the row block, in both row layouts, over an h
    scratch filled with NaN (and, in the buffer layout, NaN dead rows):
    equal to the plain float32 version to 1e-5, bit for bit across
    launches, dead buffer rows exact zeros, the MINOR h of MAJOR-only rows
    never written and never multiplied, the row tiles ``tile_plan``'s."""
    d, f = MODEL_WIDTHS[model]
    P, C, E = 2, WIDTH_C, len(WIDTH_CF)
    gen = torch.Generator(device=cuda).manual_seed(30)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=cuda) * scale
    cf, cm = _i32(WIDTH_CF).to(cuda), _i32(WIDTH_CM).to(cuda)
    n_major = D.resolve_n_major(f, P, None, 128)
    w1, w3, w2 = (randn(E * P, d, f, scale=0.02),
                  randn(E * P, d, f, scale=0.02),
                  randn(E * P, f, d, scale=0.02))
    kw = dict(p_factor=P, n_major=n_major)
    if kernel == "grouped":
        x = randn(E, C, d)
        dead = torch.arange(C, device=cuda)[None, :] >= (cf + cm)[:, None]
        x[dead] = float("nan")
        want = ops.grouped_swiglu_ref(x.nan_to_num(), w1, w3, w2, cf, cm,
                                      p_factor=P, n_minor_start=None)

        def run(h, regime=None):
            return D.launch_grouped_swiglu(x, w1, w3, w2, cf, cm, h=h,
                                           regime=regime, **kw)
        starts, n_pos = [e * C for e in range(E)], E * C
    else:
        T = 384
        sizes = torch.clamp(cf.cpu() + cm.cpu(), max=C) + 3
        offs = (torch.cumsum(sizes, 0) - sizes).to(torch.int32)
        n_pos = int(sizes.sum()) + 8                # 8 padding entries
        tok = torch.randint(0, T, (n_pos,), generator=gen, device=cuda,
                            dtype=torch.int32)
        comb = torch.rand((n_pos,), generator=gen, device=cuda)
        x, offs = randn(T, d), offs.to(cuda)
        want = ops.fused_moe_pipeline_ref(x, w1, w3, w2, offs, cf, cm, tok,
                                          comb, capacity=C, p_factor=P,
                                          n_minor_start=None)

        def run(h, regime=None):
            return D.launch_fused_moe_pipeline(
                x, w1, w3, w2, offs, cf, cm, tok, comb, capacity=C, h=h,
                regime=regime, **kw)
        starts = offs.tolist()
    shape = (n_pos, P * f)
    h = torch.full(shape, float("nan"), device=cuda)
    regime = torch.zeros(E, dtype=torch.int32, device=cuda)
    y1 = run(h, regime)
    y2 = run(torch.full(shape, float("nan"), device=cuda))
    torch.cuda.synchronize()
    assert torch.equal(y1, y2)
    assert float((y1 - want).norm() / want.norm()) <= BAR[torch.float32]
    left = sum(int(torch.isnan(h[s + a:s + min(a + b, C), n_major:]).sum())
               for s, a, b in zip(starts, WIDTH_CF, WIDTH_CM))
    assert left > 0
    assert regime.tolist() == D.tile_plan(cf, cm, C)[0].tolist()
    if kernel == "grouped":
        assert (y1[dead] == 0).all()
