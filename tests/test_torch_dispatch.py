"""The port's dispatch substrate against the JAX package: plans must be
bit-identical (perm, offsets, counts, group, slot, overflow) over the grid
of ``tests/test_dispatch.py``, and so must everything built from a plan."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dispatch as JD
from repro_torch.core import dispatch as TD

PLAN_FIELDS = ("perm", "group_offsets", "counts_full", "counts_major",
               "group", "slot", "overflow")


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _case(n, g, seed, keep_p, major_p):
    rng = np.random.default_rng(seed)
    group = rng.integers(0, g, (n,)).astype(np.int32)
    keep = rng.random(n) < keep_p
    major = (rng.random(n) < major_p) & keep
    return group, keep, major


def _assert_plans_equal(a, b, msg):
    for name in PLAN_FIELDS:
        va, vb = _np(getattr(a, name)), _np(getattr(b, name))
        np.testing.assert_array_equal(va, vb, err_msg=f"{name} ({msg})")
        assert va.dtype == np.int32, f"{name} dtype {va.dtype} ({msg})"


@pytest.mark.parametrize("n", [1, 7, 64, 300, 1024])
@pytest.mark.parametrize("g", [1, 3, 8, 32])
def test_plans_bit_identical_to_jax(n, g):
    for cap in (1, 4, 16, 64):
        for seed, (keep_p, major_p, modes) in enumerate(
                [(1.0, 0.0, False), (0.7, 0.4, True), (0.3, 0.9, True),
                 (0.0, 0.5, True)]):
            group, keep, major = _case(n, g, 100 * n + 10 * g + seed,
                                       keep_p, major_p)
            mj = jnp.asarray(major) if modes else None
            mt = torch.from_numpy(major) if modes else None
            pj = JD.sort_dispatch(jnp.asarray(group), jnp.asarray(keep),
                                  n_groups=g, capacity=cap, major_only=mj)
            msg = f"n={n} g={g} cap={cap} seed={seed}"
            for fn in (TD.sort_dispatch, TD.cumsum_dispatch):
                pt = fn(torch.from_numpy(group), torch.from_numpy(keep),
                        n_groups=g, capacity=cap, major_only=mt)
                _assert_plans_equal(pt, pj, f"{fn.__name__} {msg}")
            cf_j, cm_j = pj.kernel_counts(cap)
            cf_t, cm_t = pt.kernel_counts(cap)
            np.testing.assert_array_equal(_np(cf_t), _np(cf_j))
            np.testing.assert_array_equal(_np(cm_t), _np(cm_j))


@pytest.mark.parametrize("index_div", [1, 2, 4])
def test_buffers_and_pair_arrays_match_jax(index_div):
    rng = np.random.default_rng(index_div)
    n, g, cap = 96, 5, 12
    group, keep, major = _case(n, g, 7 + index_div, 0.8, 0.3)
    values = rng.standard_normal((n // index_div, 6)).astype(np.float32)
    weights = rng.random(n).astype(np.float32)
    pj = JD.sort_dispatch(jnp.asarray(group), jnp.asarray(keep), n_groups=g,
                          capacity=cap, major_only=jnp.asarray(major))
    pt = TD.sort_dispatch(torch.from_numpy(group), torch.from_numpy(keep),
                          n_groups=g, capacity=cap,
                          major_only=torch.from_numpy(major))
    buf_j = JD.gather_rows(jnp.asarray(values), pj, cap, index_div=index_div)
    buf_t = TD.gather_rows(torch.from_numpy(values), pt, cap,
                           index_div=index_div)
    np.testing.assert_array_equal(_np(buf_t), _np(buf_j))
    np.testing.assert_array_equal(_np(TD.unpermute(buf_t, pt)),
                                  _np(JD.unpermute(buf_j, pj)))
    for pad in (0, 8):
        tj, wj = JD.sorted_pair_arrays(pj, jnp.asarray(weights),
                                       index_div=index_div, pad=pad)
        tt, wt = TD.sorted_pair_arrays(pt, torch.from_numpy(weights),
                                       index_div=index_div, pad=pad)
        np.testing.assert_array_equal(_np(tt), _np(tj))
        np.testing.assert_array_equal(_np(wt), _np(wj))
        assert tt.dtype == torch.int32


@pytest.mark.parametrize("p", [1, 2, 3])
def test_mode_helpers_match_jax(p):
    from repro.core.drop import SubExpertPairs as JPairs
    from repro_torch.core.drop import SubExpertPairs as TPairs
    rng = np.random.default_rng(p)
    T, K = 20, 3
    idx = (rng.integers(0, 6, (T, K))[:, :, None] * p
           + np.arange(p)).reshape(T, K * p).astype(np.int32)
    major_kept = rng.random((T, K)) < 0.8
    minor_kept = (rng.random((T, K, max(p - 1, 1))) < 0.5)[:, :, :p - 1] \
        & major_kept[:, :, None]
    keep = np.concatenate([major_kept[:, :, None], minor_kept],
                          axis=2).reshape(T, K * p)
    comb = np.repeat(rng.random((T, K)), p, axis=1).astype(np.float32)
    modes = np.zeros((T, K), np.int32)
    np.testing.assert_array_equal(
        _np(TD.major_only_flags(torch.from_numpy(keep), p)),
        _np(JD.major_only_flags(jnp.asarray(keep), p)))
    fj = JD.fuse_sub_pairs(JPairs(jnp.asarray(idx), jnp.asarray(comb),
                                  jnp.asarray(keep), jnp.asarray(modes)), p)
    ft = TD.fuse_sub_pairs(TPairs(torch.from_numpy(idx),
                                  torch.from_numpy(comb),
                                  torch.from_numpy(keep),
                                  torch.from_numpy(modes)), p)
    for name in ("group", "keep", "major_only", "combine"):
        np.testing.assert_array_equal(_np(getattr(ft, name)),
                                      _np(getattr(fj, name)), err_msg=name)


def test_group_histogram_matches_jax():
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 9, (40, 3)).astype(np.int32)
    mask = rng.random((40, 3)) < 0.6
    for m in (None, mask):
        hj = JD.group_histogram(jnp.asarray(ids), 9,
                                mask=None if m is None else jnp.asarray(m))
        ht = TD.group_histogram(torch.from_numpy(ids), 9,
                                mask=None if m is None else
                                torch.from_numpy(m))
        np.testing.assert_array_equal(_np(ht), _np(hj))
        assert ht.dtype == torch.int32


def test_prefer_fused_pipeline_table():
    """CUDA -> fused always; CPU -> follow ``use_kernel`` (the JAX rule with
    "cuda" in place of "non-CPU backend")."""
    for use_kernel in (False, True):
        assert TD.prefer_fused_pipeline(8, 4, use_kernel=use_kernel,
                                        device=torch.device("cuda"))
        assert TD.prefer_fused_pipeline(8, 4, use_kernel=use_kernel,
                                        device="cpu") == use_kernel
        assert JD.prefer_fused_pipeline(8, 4, use_kernel=use_kernel,
                                        backend="cpu") == use_kernel
