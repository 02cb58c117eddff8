"""The intra-chunk SSD of the port (``kernels.ops.ssd_chunk``; on the CPU
its plain version ``ssd_chunk_ref``) against the JAX package's TPU kernel
``ssd_chunk_pallas`` in interpret mode and its oracle ``ssd_chunk_ref``,
on the same seeded numpy inputs.

Tolerance: norm-relative 1e-5 on y, states and decay. Both sides compute
the same float32 products; the einsums sum them in other orders, and the
port's cumsum is accumulated in float64 where JAX's is float32, which
moves exp(cum_i - cum_j) by a few float32 ulps of |cum| near the
diagonal."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_chunk import ssd_chunk_pallas
from repro.kernels.ssd_chunk import ssd_chunk_ref as jax_ssd_chunk_ref
from repro_torch.kernels import ops, ref

SHAPES = [(3, 4, 32, 16, 8), (2, 2, 128, 64, 128), (1, 5, 16, 8, 8),
          (2, 2, 256, 64, 64)]
REL = 1e-5


def _inputs(BH, nc, Q, P, N, seed=0):
    """As the JAX kernel tests draw them: dt = softplus(N(0, 1)) > 0,
    a = -exp(0.5 N(0, 1)) < 0."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    x = rng.standard_normal((BH, nc, Q, P)).astype(f32)
    dt = np.log1p(np.exp(rng.standard_normal((BH, nc, Q)))).astype(f32)
    a = (-np.exp(rng.standard_normal((BH,)) * 0.5)).astype(f32)
    bm = rng.standard_normal((BH, nc, Q, N)).astype(f32)
    cm = rng.standard_normal((BH, nc, Q, N)).astype(f32)
    return x, dt, a, bm, cm


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
    for name, want in (("pallas", ssd_chunk_pallas(
            *(jnp.asarray(a) for a in args), interpret=True)),
            ("oracle", jax_ssd_chunk_ref(*(jnp.asarray(a) for a in args)))):
        for out, g, w in zip(("y", "states", "decay"), got, want):
            assert np.isfinite(g.numpy()).all()
            assert _rel(g.numpy(), w) <= REL, (name, out)


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


@pytest.mark.parametrize("bad", ["dtype", "layout", "shape", "device"])
def test_ssd_chunk_rejects_bad_inputs(bad):
    x, dt, a, bm, cm = [torch.from_numpy(v)
                        for v in _inputs(2, 2, 16, 8, 8, seed=3)]
    if bad == "dtype":
        x = x.double()
    elif bad == "layout":
        x = x.transpose(2, 3).contiguous().transpose(2, 3)
    elif bad == "shape":
        dt = dt[:, :, :8].contiguous()
    else:
        a = a.to("meta")
    with pytest.raises((TypeError, ValueError)):
        ops.ssd_chunk(x, dt, a, bm, cm)
