"""The intra-chunk SSD of the port (``kernels.ops.ssd_chunk``; on the CPU
its plain version ``ssd_chunk_ref``) against the JAX package's TPU kernel
``ssd_chunk_pallas`` in interpret mode and its oracle ``ssd_chunk_ref``,
on the same seeded numpy inputs. B and C reach the port grouped, (BH / rep,
nc, Q, N); JAX is fed them repeated over the heads.

Tolerance: norm-relative 1e-5 on y, states and decay. Both sides compute
the same float32 products; the einsums sum them in other orders, and the
port's cumsum is accumulated in float64 where JAX's is float32, which
moves exp(cum_i - cum_j) by a few float32 ulps of |cum| near the
diagonal. The model-draw case (dt log-uniform in [1e-3, 1e-1], a =
-U[1, 16], Q = 256) reaches |cum| ~ 86, where JAX's float32 cumsum is off
by ~sqrt(Q) float32 ulps of |cum| (~1e-5 relative in L and the decay):
its bar against JAX is 2e-5, and the port is held against a float64
reference at 1e-5.

The tests marked ``cuda`` run the CUDA kernel against its plain version on
the card and skip without one. This file imports JAX only inside the CPU
tests, so on a machine without JAX run them with ``PYTHONPATH=src python
-m pytest -m cuda --noconftest tests/test_torch_ssd_chunk.py``."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref

SHAPES = [(3, 4, 32, 16, 8), (2, 2, 128, 64, 128), (1, 5, 16, 8, 8),
          (2, 2, 256, 64, 64)]
REL = 1e-5


def _inputs(BH, nc, Q, P, N, seed=0, groups=None, model=False):
    """As the JAX kernel tests draw them: dt = softplus(N(0, 1)) > 0,
    a = -exp(0.5 N(0, 1)) < 0; or as the Mamba2 layer draws them
    (``model``): dt log-uniform in [1e-3, 1e-1], a = -U[1, 16]. B and C
    have ``groups`` rows (default BH)."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    G = BH if groups is None else groups
    x = rng.standard_normal((BH, nc, Q, P)).astype(f32)
    if model:
        dt = np.exp(rng.uniform(np.log(1e-3), np.log(1e-1),
                                (BH, nc, Q))).astype(f32)
        a = (-rng.uniform(1.0, 16.0, (BH,))).astype(f32)
    else:
        dt = np.log1p(np.exp(rng.standard_normal((BH, nc, Q)))).astype(f32)
        a = (-np.exp(rng.standard_normal((BH,)) * 0.5)).astype(f32)
    bm = rng.standard_normal((G, nc, Q, N)).astype(f32)
    cm = rng.standard_normal((G, nc, Q, N)).astype(f32)
    return x, dt, a, bm, cm


def _jax(args, rep=1):
    """(ssd_chunk_pallas in interpret mode, its oracle) on ``args`` with
    B and C repeated ``rep`` times over the heads."""
    import jax.numpy as jnp
    from repro.kernels.ssd_chunk import ssd_chunk_pallas
    from repro.kernels.ssd_chunk import ssd_chunk_ref as jax_ssd_chunk_ref
    x, dt, a, bm, cm = args
    full = [jnp.asarray(v) for v in (x, dt, a, np.repeat(bm, rep, 0),
                                     np.repeat(cm, rep, 0))]
    return (("pallas", ssd_chunk_pallas(*full, interpret=True)),
            ("oracle", jax_ssd_chunk_ref(*full)))


def _ssd_f64(x, dt, a, bm, cm):
    """The function in float64 numpy (B/C per head)."""
    x, dt, bm, cm = (v.astype(np.float64) for v in (x, dt, bm, cm))
    cum = np.cumsum(dt * a.astype(np.float64)[:, None, None], -1)
    Q = x.shape[2]
    seg = cum[..., :, None] - cum[..., None, :]
    L = np.where(np.tri(Q, dtype=bool), np.exp(np.minimum(seg, 0)), 0.0)
    M = np.einsum("bcqn,bckn->bcqk", cm, bm) * L * dt[..., None, :]
    w = bm * (dt * np.exp(cum[..., -1:] - cum))[..., None]
    return (np.einsum("bcqk,bckp->bcqp", M, x),
            np.einsum("bcqn,bcqp->bcnp", w, x), np.exp(cum[..., -1]))


def _rel(got, want):
    """Norm-relative error; 0 when both are all zeros (at Q >= 128 these
    inputs decay below float32's range, so every chunk decay is 0)."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = np.linalg.norm(want)
    if scale == 0:
        return float(np.linalg.norm(got) > 0)
    return float(np.linalg.norm(got - want) / scale)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_ssd_chunk_matches_jax_kernel_and_oracle(shape):
    args = _inputs(*shape)
    got = ops.ssd_chunk(*(torch.from_numpy(a) for a in args))
    for name, want in _jax(args):
        for out, g, w in zip(("y", "states", "decay"), got, want):
            assert np.isfinite(g.numpy()).all()
            assert _rel(g.numpy(), w) <= REL, (name, out)


@pytest.mark.parametrize("rep", [1, 2, 4])
def test_ssd_chunk_grouped_matches_jax(rep):
    """B and C once per group of ``rep`` heads (rep = BH: one group)
    against JAX fed them repeated over the heads."""
    BH = 4
    args = _inputs(BH, 3, 32, 16, 8, seed=4, groups=BH // rep)
    got = ops.ssd_chunk(*(torch.from_numpy(a) for a in args))
    for name, want in _jax(args, rep):
        for out, g, w in zip(("y", "states", "decay"), got, want):
            assert np.isfinite(g.numpy()).all()
            assert _rel(g.numpy(), w) <= REL, (name, out, rep)


def test_ssd_chunk_model_draw_matches_jax_and_float64():
    """The Mamba2 layer's own draws at Q = 256, grouped (rep 2): L and the
    chunk decays stay above float32's range (no decay is 0), so the decay
    and the far-off-diagonal terms are checked as values, not zeros."""
    args = _inputs(4, 2, 256, 16, 8, seed=5, groups=2, model=True)
    got = [g.numpy() for g in ops.ssd_chunk(*(torch.from_numpy(a)
                                              for a in args))]
    assert (got[2] > 0).all()
    x, dt, a, bm, cm = args
    exact = _ssd_f64(x, dt, a, np.repeat(bm, 2, 0), np.repeat(cm, 2, 0))
    for out, g, w in zip(("y", "states", "decay"), got, exact):
        assert np.isfinite(g).all()
        assert _rel(g, w) <= REL, ("float64", out)
    for name, want in _jax(args, 2):
        for out, g, w in zip(("y", "states", "decay"), got, want):
            assert _rel(g, w) <= 2e-5, (name, out)


def test_ssd_chunk_ref_repeats_groups_over_heads():
    """The plain version's grouped layout is ``repeat_interleave`` of the
    rows over the heads: the same outputs bit for bit."""
    x, dt, a, bm, cm = (torch.from_numpy(v) for v in
                        _inputs(6, 2, 16, 8, 8, seed=6, groups=3))
    got = ref.ssd_chunk_ref(x, dt, a, bm, cm)
    want = ref.ssd_chunk_ref(x, dt, a, bm.repeat_interleave(2, 0),
                             cm.repeat_interleave(2, 0))
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_ssd_chunk_wrapper_runs_plain_version_on_cpu():
    args = [torch.from_numpy(a) for a in _inputs(2, 3, 16, 8, 8, seed=1)]
    launches, calls = ops.ssd_chunk.launches, ref.ssd_chunk_ref.calls
    y, st, dec = ops.ssd_chunk(*args)
    assert ops.ssd_chunk.launches == launches
    assert ref.ssd_chunk_ref.calls == calls + 1
    assert y.shape == (2, 3, 16, 8) and st.shape == (2, 3, 8, 8)
    assert dec.shape == (2, 3)
    # y's first row of a chunk sees only itself: C_0·B_0 dt_0 x_0
    x, dt, a, bm, cm = args
    want = (cm[:, :, 0] * bm[:, :, 0]).sum(-1) * dt[:, :, 0]
    torch.testing.assert_close(y[:, :, 0], want[..., None] * x[:, :, 0])


def test_chunk_cumsum_is_order_free():
    """Accumulated in float64 and rounded once: the sums of a reversed
    walk agree with the forward ones bit for bit."""
    x = torch.from_numpy(-np.abs(np.random.default_rng(2).standard_normal(
        (4, 256))).astype(np.float32))
    fwd = ref.chunk_cumsum(x)
    total = ref.chunk_cumsum(x.flip(-1))[..., -1]
    assert torch.equal(fwd[..., -1], total)
    assert torch.equal(fwd, torch.cumsum(x.double(), -1).float())


@pytest.mark.parametrize("BH,BG,nc,Q,P,N", [
    (256, 8, 2, 256, 64, 128), (896, 8, 2, 256, 64, 64),
    (5, 1, 3, 100, 13, 7), (6, 3, 2, 70, 66, 129), (1, 1, 5, 15, 7, 9)])
def test_ssd_launch_layout_parts_are_aligned_and_disjoint(BH, BG, nc, Q, P,
                                                          N):
    """The kernel's one allocation per call: y, states, decay, the score
    scratch (rows padded to 4 floats) and cum / w / v each start on 16
    bytes and hold their whole part without overlap."""
    from repro_torch.kernels.ssd_chunk import _layout, _pad4
    offsets, total = _layout(BH, BG, nc, Q, P, N)
    Qs = _pad4(Q)
    assert Qs % 4 == 0 and Q <= Qs < Q + 4
    sizes = (BH * nc * Q * P, BH * nc * N * P, BH * nc, BG * nc * Q * Qs,
             BH * nc * Q, BH * nc * Q, BH * nc * Q)
    ends = list(offsets[1:]) + [total]
    assert offsets[0] == 0
    for o, n, end in zip(offsets, sizes, ends):
        assert o % 4 == 0 and o + n <= end < o + n + 4


@pytest.mark.parametrize("bad", ["dtype", "layout", "shape", "device",
                                 "groups"])
def test_ssd_chunk_rejects_bad_inputs(bad):
    x, dt, a, bm, cm = [torch.from_numpy(v)
                        for v in _inputs(2, 2, 16, 8, 8, seed=3)]
    if bad == "dtype":
        x = x.double()
    elif bad == "layout":
        x = x.transpose(2, 3).contiguous().transpose(2, 3)
    elif bad == "shape":
        dt = dt[:, :, :8].contiguous()
    elif bad == "groups":           # 3 group rows for 2 heads
        bm = torch.cat([bm, bm[:1]]).contiguous()
        cm = torch.cat([cm, cm[:1]]).contiguous()
    else:
        a = a.to("meta")
    with pytest.raises((TypeError, ValueError)):
        ops.ssd_chunk(x, dt, a, bm, cm)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("model", [False, True], ids=["jax_draw",
                                                      "model_draw"])
@pytest.mark.parametrize("BH,groups,nc,Q,P,N", [
    (4, 4, 3, 32, 16, 8),           # rep 1: the TPU kernel's layout
    (8, 2, 2, 256, 64, 128),        # rep 4 at the Mamba2 widths
    (6, 3, 2, 70, 66, 129),         # odd widths: Q, P, N past the tiles
    (5, 1, 3, 100, 13, 7),          # rep 5, P and N off the 16-byte path
    (4, 1, 2, 130, 16, 8),          # a chunk of 130: a 2-row last block
])
def test_ssd_kernel_matches_plain_on_card(cuda, BH, groups, nc, Q, P, N,
                                          model):
    """The CUDA kernel against its plain version on the same inputs: y
    and states to 1e-5 norm-relative (3xTF32 products against float32),
    the decay to 1e-6, finite, and bit for bit across two launches."""
    args = [torch.from_numpy(v).to(cuda) for v in
            _inputs(BH, nc, Q, P, N, seed=7, groups=groups, model=model)]
    launches = ops.ssd_chunk.launches
    got = ops.ssd_chunk(*args)
    again = ops.ssd_chunk(*args)
    want = ref.ssd_chunk_ref(*args)
    assert ops.ssd_chunk.launches == launches + 2
    assert all(torch.equal(g, h) for g, h in zip(got, again))
    for out, g, w, bar in zip(("y", "states", "decay"), got, want,
                              (REL, REL, 1e-6)):
        assert bool(torch.isfinite(g).all()), out
        assert _rel(g.cpu().numpy(), w.cpu().numpy()) <= bar, out
