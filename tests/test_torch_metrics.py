"""The paper's drop metrics and the routing helpers of the port against the
JAX package on the same numpy inputs.

The four drop metrics are float32 counts over float32 counts, so they must
equal JAX's bit for bit. Routing: expert ids, keep masks, modes and the
dispatch coordinates equal; combine weights at rtol 1e-6 (exact router
logits, then softmax and its sums in each framework's order).
``scatter_rows`` moves rows, so it is exact; ``layer_norm`` at rtol 1e-6
(its mean and variance sum in another order)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ASSIGNED_ARCHS as JAX_ASSIGNED
from repro.configs import get_config as jax_config
from repro.core import dispatch as jdisp
from repro.core import drop as jdrop
from repro.core import moe as jmoe
from repro.core import policy as jpolicy
from repro.models import layers as jlayers
from repro_torch.configs import ASSIGNED_ARCHS, get_config
from repro_torch.core import dispatch as tdisp
from repro_torch.core import drop as tdrop
from repro_torch.core import moe as tmoe
from repro_torch.core import policy as tpolicy
from repro_torch.models import layers as tlayers
from repro_torch.obs import MetricsState

COMBINE_RTOL = 1e-6
ARCHS = ["olmoe-lite", "qwen3-moe-30b-a3b"]


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _bits_equal(got, want):
    got, want = _np(got), _np(want)
    assert got.dtype == np.float32 and want.dtype == np.float32
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def _scores(rng, n, k):
    """Normalized-score-like (N, K) float32 values in (0, 1)."""
    s = rng.random((n, k)).astype(np.float32) ** 2
    return s / s.sum(-1, keepdims=True)


# -- the four drop metrics, bitwise ----------------------------------------

@pytest.mark.parametrize("T,Kp,frac", [(1, 2, 0.5), (37, 16, 0.3),
                                       (257, 8, 0.71), (1551, 4, 0.04),
                                       (4096, 16, 0.25)])
def test_drop_rate_bitwise(T, Kp, frac):
    rng = np.random.default_rng(T)
    keep = rng.random((T, Kp)) >= frac
    want = jdrop.drop_rate(jdrop.SubExpertPairs(None, None,
                                                jnp.asarray(keep), None))
    got = tdrop.drop_rate(tdrop.SubExpertPairs(None, None,
                                               torch.from_numpy(keep), None))
    _bits_equal(got, want)
    # the same number as 1 - kept / total from the outcome counts
    kf, km, dr = tdrop.sub_pair_outcome_counts(torch.from_numpy(keep), 2
                                               if Kp % 2 == 0 else 1)
    assert int(kf + km + dr) == T * Kp
    assert int(kf + km) == int(keep.sum())


@pytest.mark.parametrize("T,K", [(1, 1), (33, 8), (1357, 2), (3978, 8)])
def test_flops_saved_fraction_bitwise(T, K):
    rng = np.random.default_rng(T + K)
    modes = rng.choice(3, size=(T, K), p=[0.3, 0.2, 0.5]).astype(np.int32)
    _bits_equal(tdrop.flops_saved_fraction(torch.from_numpy(modes)),
                jdrop.flops_saved_fraction(jnp.asarray(modes)))


@pytest.mark.parametrize("N,K,M", [(7, 2, 5), (512, 8, 64), (2048, 8, 64)])
def test_threshold_to_drop_rate_bitwise(N, K, M):
    rng = np.random.default_rng(N)
    scores = _scores(rng, N, K)
    # a grid over [0, max] plus thresholds equal to scores (the ``<=``
    # boundary) and below / above every score
    ts = np.concatenate([np.linspace(0, scores.max(), M).astype(np.float32),
                         scores.reshape(-1)[:8], [-1.0, 2.0]]
                        ).astype(np.float32)
    want = jdrop.threshold_to_drop_rate(jnp.asarray(scores), jnp.asarray(ts))
    got = tdrop.threshold_to_drop_rate(torch.from_numpy(scores),
                                       torch.from_numpy(ts))
    _bits_equal(got, want)
    assert float(got[-2]) == 0.0 and float(got[-1]) == 1.0
    # a Python list of thresholds gives the same bits
    _bits_equal(tdrop.threshold_to_drop_rate(torch.from_numpy(scores),
                                             ts.tolist()), want)


@pytest.mark.parametrize("target,gap", [(0.25, 0.01), (0.5, 0.003),
                                        (0.05, 0.5)])
def test_calibrate_per_layer_thresholds_bitwise(target, gap):
    rng = np.random.default_rng(int(target * 100))
    layers = [_scores(rng, 300 + 50 * i, 8) * (1.0 + i) for i in range(4)]
    want = jdrop.calibrate_per_layer_thresholds(
        [jnp.asarray(s) for s in layers], target, gap)
    got = tdrop.calibrate_per_layer_thresholds(
        [torch.from_numpy(s) for s in layers], target, gap)
    assert got.shape == (4, 2)
    _bits_equal(got, want)
    if gap == 0.5:           # t - gap clamps to 0
        assert (got[:, 0] == 0).all()


# -- routing: route_dualsparse, dispatch_indices ---------------------------

def _cfgs(arch):
    if arch == "qwen3-moe-30b-a3b":
        return get_config(arch).reduced(), jax_config(arch).reduced()
    return get_config(arch), jax_config(arch)


def _router_inputs(rng, T, d, E):
    """x (T, d) and wg (d, E) on grids of 1/8 and 1/64: every product and
    partial sum of ``x @ wg`` is exact in float32, so both frameworks'
    router logits are the same numbers whatever their summation order, and
    the comparison holds the routing helpers themselves (``gating.route``
    on general inputs is held at rtol 1e-5 in test_torch_routing.py)."""
    x = (rng.integers(-16, 17, (T, d)) / 8).astype(np.float32)
    wg = (rng.integers(-8, 9, (d, E)) / 64).astype(np.float32)
    return x, wg


@pytest.mark.parametrize("form", ["config", "scalar", "per_token",
                                  "params"])
@pytest.mark.parametrize("arch", ARCHS)
def test_route_dualsparse_matches_jax(arch, form):
    cfg, jcfg = _cfgs(arch)
    rng = np.random.default_rng(5)
    T, d, E = 48, cfg.d_model, cfg.n_experts
    x, wg = _router_inputs(rng, T, d, E)
    jp, tp = {"wg": jnp.asarray(wg)}, {"wg": torch.from_numpy(wg)}
    jkw, tkw = {}, {}
    if form == "scalar":
        jkw = tkw = {"thresholds": (0.08, 0.15)}
    elif form == "per_token":
        tm = rng.uniform(0.02, 0.12, T).astype(np.float32)
        tn = tm + rng.uniform(0.0, 0.1, T).astype(np.float32)
        jkw = {"thresholds": (jnp.asarray(tm), jnp.asarray(tn))}
        tkw = {"thresholds": (torch.from_numpy(tm), torch.from_numpy(tn))}
    elif form == "params":
        th = np.array([0.06, 0.11], np.float32)
        jp["thresholds"], tp["thresholds"] = (jnp.asarray(th),
                                              torch.from_numpy(th))
    want = jmoe.route_dualsparse(jp, jnp.asarray(x), jcfg, **jkw)
    got = tmoe.route_dualsparse(tp, torch.from_numpy(x), cfg, **tkw)
    P = cfg.dualsparse.partition_p
    assert got.idx.shape == (T, cfg.top_k * P)
    for name in ("idx", "keep", "modes"):
        np.testing.assert_array_equal(_np(getattr(got, name)),
                                      _np(getattr(want, name)))
    np.testing.assert_allclose(_np(got.combine), _np(want.combine),
                               rtol=COMBINE_RTOL)
    # every mode occurs, so each threshold form really drops
    assert set(np.unique(_np(got.modes))) == {0, 1, 2}, form


@pytest.mark.parametrize("capacity", [4, 64])
def test_dispatch_indices_match_jax(capacity):
    cfg, jcfg = _cfgs("olmoe-lite")
    rng = np.random.default_rng(capacity)
    T, d, E = 64, cfg.d_model, cfg.n_experts
    x, wg = _router_inputs(rng, T, d, E)
    kw = {"thresholds": (0.06, 0.11)}
    jpairs = jmoe.route_dualsparse({"wg": jnp.asarray(wg)}, jnp.asarray(x),
                                   jcfg, **kw)
    tpairs = tmoe.route_dualsparse({"wg": torch.from_numpy(wg)},
                                   torch.from_numpy(x), cfg, **kw)
    n_sub = E * cfg.dualsparse.partition_p
    want = jmoe.dispatch_indices(jpairs, n_sub, capacity)
    got = tmoe.dispatch_indices(tpairs, n_sub, capacity)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_np(g), _np(w))
    if capacity == 4:
        assert int(got[2]) > 0       # the small capacity overflows
    else:
        assert int(got[2]) == 0


# -- scatter_rows: the buffer oracle ---------------------------------------

@pytest.mark.parametrize("index_div", [1, 4])
def test_scatter_rows_matches_jax_and_gather_rows(index_div):
    rng = np.random.default_rng(index_div)
    T, d, G, cap = 40, 6, 5, 7
    N = T * index_div
    group = rng.integers(0, G, N).astype(np.int32)
    keep = rng.random(N) < 0.8
    values = rng.standard_normal((T if index_div > 1 else N, d)
                                 ).astype(np.float32)
    jplan = jdisp.sort_dispatch(jnp.asarray(group), jnp.asarray(keep),
                                n_groups=G, capacity=cap)
    tplan = tdisp.sort_dispatch(torch.from_numpy(group),
                                torch.from_numpy(keep), n_groups=G,
                                capacity=cap)
    assert int(tplan.overflow) > 0   # the discard row takes duplicates
    for fill in (0, -3.0):
        want = jdisp.scatter_rows(jnp.asarray(values), jplan, cap,
                                  index_div=index_div, fill=fill)
        got = tdisp.scatter_rows(torch.from_numpy(values), tplan, cap,
                                 index_div=index_div, fill=fill)
        assert got.shape == (G, cap, d)
        np.testing.assert_array_equal(_np(got), _np(want))
        np.testing.assert_array_equal(
            _np(got), _np(tdisp.gather_rows(torch.from_numpy(values), tplan,
                                            cap, index_div=index_div,
                                            fill=fill)))


# -- the small rest ---------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_layer_norm_matches_jax(dtype):
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((4, 9, 32)) * 3 + 1).astype(np.float32)
    w = rng.standard_normal(32).astype(np.float32)
    b = rng.standard_normal(32).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    want = jlayers.layer_norm(jnp.asarray(x).astype(jdt), jnp.asarray(w),
                              jnp.asarray(b))
    got = tlayers.layer_norm(torch.from_numpy(x).to(dtype),
                             torch.from_numpy(w), torch.from_numpy(b))
    assert got.dtype == dtype
    if dtype == torch.float32:
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-6,
                                   atol=1e-6)
    else:    # bf16 in, cast back to bf16 on both sides: one ulp at most
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want.astype(jnp.float32)),
                                   rtol=2 ** -7)


def test_registry_and_defaults_match_jax():
    assert set(tpolicy.registered_policies()) == \
        set(jpolicy.registered_policies())
    snap = tpolicy.registered_policies()
    snap.pop("2t")
    assert "2t" in tpolicy.POLICIES     # a copy, not the registry
    assert isinstance(tpolicy.default_policy(), tpolicy.NoDrop)
    assert type(jpolicy.default_policy()).__name__ == \
        type(tpolicy.default_policy()).__name__
    assert ASSIGNED_ARCHS == JAX_ASSIGNED
    for arch in ASSIGNED_ARCHS:
        assert get_config(arch).arch_id == arch


def test_metrics_total_pairs():
    """kept_full + kept_major + dropped counts every sub-pair of a
    forward: T * K * P."""
    T, K, P = 24, 4, 2
    rng = np.random.default_rng(0)
    keep = torch.from_numpy(rng.random((T, K * P)) < 0.6)
    kf, km, dr = tdrop.sub_pair_outcome_counts(keep, P)
    zero = torch.zeros((), dtype=torch.int32)
    st = MetricsState(expert_load=torch.zeros((1, 8), dtype=torch.int32),
                      kept_full=kf, kept_major=km, dropped_pairs=dr,
                      overflow_pairs=zero)
    assert int(st.total_pairs) == T * K * P
    assert int((st + st).total_pairs) == 2 * T * K * P
