"""One MoE layer of the port against the JAX package under the none/1t/2t
policies: the same numpy weights and inputs, the same thresholds, through
policy preparation, routing and ``moe_forward_dispatch`` on the buffer
path and the fused path (the port's plain version vs the JAX kernel in
interpret mode).

Overflow counts must be equal. Outputs: rtol 1e-5 with atol 1e-5 of the
output's largest entry — float32 products sum in another order in each
framework (and per kernel tile on the JAX fused path)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.core import moe as jmoe
from repro.core import policy as jpolicy
from repro_torch.configs import get_config
from repro_torch.core import moe as tmoe
from repro_torch.core import policy as tpolicy

ARCHS = ["olmoe-lite", "mixtral-8x7b-lite", "qwen3-moe-30b-a3b"]
POLICIES = ["none", "1t", "2t"]
RTOL = 1e-5


def _cfgs(arch):
    if arch == "qwen3-moe-30b-a3b":
        return get_config(arch).reduced(), jax_config(arch).reduced()
    return get_config(arch), jax_config(arch)


def _layer(cfg, seed, T=64, sharp=6.0):
    """Numpy layer weights (router sharpened so 2T modes spread) and x."""
    rng = np.random.default_rng(seed)
    d, E, f = cfg.d_model, cfg.n_experts, cfg.d_expert
    params = dict(
        wg=(rng.standard_normal((d, E)) * 0.02 * sharp).astype(np.float32),
        w1=(rng.standard_normal((E, d, f)) * 0.02).astype(np.float32),
        w3=(rng.standard_normal((E, d, f)) * 0.02).astype(np.float32),
        w2=(rng.standard_normal((E, f, d)) * 0.02).astype(np.float32))
    x = rng.standard_normal((T, d)).astype(np.float32)
    calib = rng.standard_normal((96, d)).astype(np.float32)
    return params, x, calib


def _thresholds(name, scores):
    """Fixed threshold values (floats, given to both sides) that leave FULL,
    MAJOR-only and dropped pairs."""
    t1 = float(np.quantile(scores, 0.35))
    if name == "1t":
        return dict(t_drop=t1)
    if name == "2t":
        return dict(t_major=t1 - 0.02, t_minor=t1 + 0.02)
    return {}


def _assert_same_order_up_to_ties(params, calib, cfg, jcfg, method):
    """The port's neuron reordering equals the JAX one except where two
    neurons' importances agree to float32 rounding (then either order is a
    correct reconstruction)."""
    from repro.core import reconstruct as jrec
    from repro_torch.core import reconstruct as trec
    imp_j = np.asarray(jrec.neuron_importance(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(calib),
        jcfg, method))
    imp_t = trec.neuron_importance(
        {k: torch.from_numpy(v) for k, v in params.items()},
        torch.from_numpy(calib), cfg, method).numpy()
    order_j = np.argsort(-imp_j, axis=-1, kind="stable")
    order_t = np.argsort(-imp_t, axis=-1, kind="stable")
    tol = RTOL * float(np.abs(imp_j).max())
    e, pos = np.nonzero(order_j != order_t)
    assert len(e) <= 0.01 * order_j.size
    np.testing.assert_allclose(imp_j[e, order_t[e, pos]],
                               imp_j[e, order_j[e, pos]], atol=tol, rtol=0)


def _prepared(name, cfg, jcfg, params, calib):
    """Both policies with equal thresholds, and the JAX-prepared weights for
    both forwards (the port's own preparation is held to the JAX one up to
    near-tied neuron importances)."""
    jp = jpolicy.make_policy(name, jcfg.dualsparse)
    tp = tpolicy.make_policy(name, cfg.dualsparse)
    prep_j, _ = jp.prepare({k: jnp.asarray(v) for k, v in params.items()},
                           jcfg, jnp.asarray(calib))
    prep_own, _ = tp.prepare({k: torch.from_numpy(v)
                              for k, v in params.items()}, cfg,
                             torch.from_numpy(calib))
    assert {k: tuple(v.shape) for k, v in prep_own.items()} == \
        {k: tuple(v.shape) for k, v in prep_j.items()}
    if tp.partition_p > 1:
        _assert_same_order_up_to_ties(params, calib, cfg, jcfg, tp.importance)
    prep_t = {k: torch.from_numpy(np.array(v)) for k, v in prep_j.items()}
    from repro.core import gating as jgating
    scores = np.asarray(jgating.route(jnp.asarray(calib), prep_j["wg"],
                                      jcfg.top_k,
                                      jcfg.router_norm_topk).norm_score)
    th = _thresholds(name, scores)
    return (dataclasses.replace(jp, **th), prep_j,
            dataclasses.replace(tp, **th), prep_t)


def _close(a, b):
    b = np.asarray(b)
    np.testing.assert_allclose(np.asarray(a), b, rtol=RTOL,
                               atol=RTOL * float(np.abs(b).max()))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("name", POLICIES)
def test_moe_layer_matches_jax(arch, name):
    cfg, jcfg = _cfgs(arch)
    params, x, calib = _layer(cfg, seed=10 * ARCHS.index(arch)
                              + POLICIES.index(name))
    jp, prep_j, tp, prep_t = _prepared(name, cfg, jcfg, params, calib)
    xj, xt = jnp.asarray(x), torch.from_numpy(x)
    pairs_j = jp.route(prep_j, xj, jcfg)
    pairs_t = tp.route(prep_t, xt, cfg)
    for field in ("idx", "keep", "modes"):
        np.testing.assert_array_equal(getattr(pairs_t, field).numpy(),
                                      np.asarray(getattr(pairs_j, field)))
    if name == "2t":
        assert (pairs_t.modes == 1).any() and (pairs_t.modes == 0).any()
    kw = dict(capacity_factor=jp.capacity_factor, return_overflow=True,
              mode_grouped=jp.kernel_mode_grouping)
    y_j, of_j = jmoe.moe_forward_dispatch(prep_j, xj, jcfg, pairs=pairs_j,
                                          fused_pipeline=False, **kw)
    for fused in (False, True):
        y_t, of_t = tmoe.moe_forward_dispatch(prep_t, xt, cfg, pairs=pairs_t,
                                              fused_pipeline=fused, **kw)
        assert int(of_t) == int(of_j)
        _close(y_t, y_j)
    if arch == "qwen3-moe-30b-a3b":    # interpret mode is slow at 64 experts
        y_jf, of_jf = jmoe.moe_forward_dispatch(
            prep_j, xj, jcfg, pairs=pairs_j, fused_pipeline=True, **kw)
        assert int(of_jf) == int(of_t)
        _close(y_t, y_jf)
    y_ref = tmoe.moe_forward_ref(prep_t, xt, cfg, pairs=pairs_t)
    _close(y_ref, jmoe.moe_forward_ref(prep_j, xj, jcfg, pairs=pairs_j))


@pytest.mark.parametrize("name", ["2t", "none"])
def test_moe_overflow_counts_match_jax(name):
    """Real capacity pressure: same pairs dropped, counted in sub-pair
    units on every path."""
    cfg, jcfg = _cfgs("olmoe-lite")
    params, x, calib = _layer(cfg, seed=21, sharp=12.0)
    jp, prep_j, tp, prep_t = _prepared(name, cfg, jcfg, params, calib)
    xj, xt = jnp.asarray(x), torch.from_numpy(x)
    pairs_j = jp.route(prep_j, xj, jcfg)
    pairs_t = tp.route(prep_t, xt, cfg)
    kw = dict(capacity=8, return_overflow=True,
              mode_grouped=jp.kernel_mode_grouping)
    y_j, of_j = jmoe.moe_forward_dispatch(prep_j, xj, jcfg, pairs=pairs_j,
                                          fused_pipeline=True, **kw)
    assert int(of_j) > 0
    for fused in (False, True):
        y_t, of_t = tmoe.moe_forward_dispatch(prep_t, xt, cfg, pairs=pairs_t,
                                              fused_pipeline=fused, **kw)
        assert int(of_t) == int(of_j)
    _close(y_t, y_j)


@pytest.mark.parametrize("target", [0.0, 0.2, 0.25, 0.3, 1.0])
def test_calibrate_threshold_exact_on_same_scores(target):
    """Fed the same float32 scores, both ``calibrate_threshold``s pick the
    same element: equal bit for bit."""
    from repro.core import drop as jdrop
    from repro_torch.core import drop as tdrop
    scores = np.random.default_rng(11).random((96, 8)).astype(np.float32)
    got = float(tdrop.calibrate_threshold(torch.from_numpy(scores), target))
    want = float(jdrop.calibrate_threshold(jnp.asarray(scores), target))
    assert got == want


def test_calibrated_thresholds_match_jax():
    """End to end: the thresholds each package calibrates from its own
    router scores. The routers' float32 matmuls sum in other orders, so
    the normalized scores differ by up to 3.3e-6 relative here and a
    threshold (one of those scores) by as much: the bar is the port's
    float32 bar, rtol 1e-5."""
    cfg, jcfg = _cfgs("olmoe-lite")
    params, _, calib = _layer(cfg, seed=3)
    for name in ("1t", "2t"):
        jp = jpolicy.make_policy(name, jcfg.dualsparse, drop_target=0.25)
        tp = tpolicy.make_policy(name, cfg.dualsparse, drop_target=0.25)
        _, jc = jp.prepare({k: jnp.asarray(v) for k, v in params.items()},
                           jcfg, jnp.asarray(calib))
        _, tc = tp.prepare({k: torch.from_numpy(v)
                            for k, v in params.items()}, cfg,
                           torch.from_numpy(calib))
        for n in tc._dynamic:
            np.testing.assert_allclose(float(getattr(tc, n)),
                                       float(getattr(jc, n)), rtol=RTOL)


def test_per_token_and_capacity_hints():
    tp = tpolicy.TwoTDrop(t_major=torch.tensor([0.1, 0.2]),
                          t_minor=torch.tensor([0.3, 0.4]))
    pt = tp.per_token(2, 3)
    assert pt.t_major.tolist() == pytest.approx([0.1] * 3 + [0.2] * 3)
    assert tp.per_token(2, 1) is tp
    assert tpolicy.NoDrop().dispatch_capacity(40) is None
    assert tpolicy.NoDrop(exact_capacity=True).dispatch_capacity(40) == 40
    merged = tpolicy.merge_policy_override(
        tpolicy.TwoTDrop(exact_capacity=True),
        tpolicy.TwoTDrop(t_major=0.01, t_minor=0.5))
    assert merged.exact_capacity and merged.t_major == 0.01
    with pytest.raises(ValueError):
        tpolicy.merge_policy_override(tpolicy.TwoTDrop(), tpolicy.OneTDrop())
    for cap_args in [(64, 16, 256, 2.0), (8, 16, 256, 2.0), (100, 6, 64, 1.25),
                     (1, 2, 8, 1.25)]:
        assert tmoe.capacity_for(*cap_args) == jmoe.capacity_for(*cap_args)


@pytest.mark.parametrize("mode_grouped", [True, False])
@pytest.mark.parametrize("capacity", [None, 8])
def test_moe_buffer_kernel_path_matches_jax(mode_grouped, capacity):
    """The buffer path through the grouped SwiGLU kernel
    (``use_kernel=True, fused_pipeline=False``: the port's plain version vs
    the JAX kernel in interpret mode), over ORIGINAL-expert buffers with
    minor-half skipping (``mode_grouped``) or sub-expert buffers; capacity
    8 overflows, and the overflow counts (sub-pair units) must be equal."""
    cfg, jcfg = _cfgs("olmoe-lite")
    params, x, calib = _layer(cfg, seed=31, sharp=12.0)
    jp, prep_j, tp, prep_t = _prepared("2t", cfg, jcfg, params, calib)
    xj, xt = jnp.asarray(x), torch.from_numpy(x)
    pairs_j = jp.route(prep_j, xj, jcfg)
    pairs_t = tp.route(prep_t, xt, cfg)
    kw = dict(capacity_factor=jp.capacity_factor, capacity=capacity,
              return_overflow=True, mode_grouped=mode_grouped,
              use_kernel=True, fused_pipeline=False)
    y_j, of_j = jmoe.moe_forward_dispatch(prep_j, xj, jcfg, pairs=pairs_j,
                                          **kw)
    from repro_torch.kernels import ops as tops
    calls = tops.grouped_swiglu_ref.calls
    y_t, of_t = tmoe.moe_forward_dispatch(prep_t, xt, cfg, pairs=pairs_t,
                                          **kw)
    assert tops.grouped_swiglu_ref.calls == calls + 1
    assert int(of_t) == int(of_j)
    assert (int(of_t) > 0) == (capacity == 8)
    _close(y_t, y_j)
    if capacity is None:
        y_ref = tmoe.moe_forward_ref(prep_t, xt, cfg, pairs=pairs_t)
        _close(y_t, y_ref)
