"""The ``load_aware`` and ``per_layer`` policies of the port against the
JAX package's, on the same numpy inputs.

Tolerances:
  * ``core.load_aware`` functions and the policies' keep masks: exact.
    Loads are integer counts summed in float32, and the thresholds are
    formed in the same float32 order (t_max * min(ratio, 1), then
    ± t_gap), so a pair at a boundary falls the same way on both sides;
  * per-layer thresholds: rtol 1e-5, each package calibrating from its own
    router scores (float32 matmuls summed in other orders, as in
    ``test_torch_moe.py::test_calibrated_thresholds_match_jax``);
  * reduced DBRX-132B logits: within 1e-4 of their largest magnitude at a
    float32 KV cache (the port's float32 bar, ``test_torch_model.py``);
  * the engines' greedy tokens, scheduler counts and MoE counters: equal.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.core import load_aware as jla
from repro.core import policy as jpolicy
from repro.data.pipeline import calibration_activations as jax_calib
from repro.launch.mesh import make_host_mesh
from repro.models import model as JM
from repro.models import transformer as JT
from repro.serving import ContinuousBatchingEngine as JCont
from repro.serving import GenerationConfig as JGen
from repro.serving import PagedEngine as JPaged
from repro.serving import ServingEngine as JSync
from repro_torch.checkpoint.from_numpy import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.core import gating as tgating
from repro_torch.core import load_aware as tla
from repro_torch.core import policy as tpolicy
from repro_torch.models import transformer as TT
from repro_torch.serving import (ContinuousBatchingEngine, GenerationConfig,
                                 PagedEngine, ServingEngine)

ARCH = "dbrx-132b"
RTOL = 1e-5


def _both(fn_t, fn_j, *arrays, **kw):
    """``fn`` of the same numpy arrays through the port and JAX."""
    got = fn_t(*[torch.from_numpy(a) for a in arrays], **kw)
    want = fn_j(*[jnp.asarray(a) for a in arrays], **kw)
    return got, want


def _equal(got, want):
    if isinstance(got, tuple):
        for g, w in zip(got, want):
            _equal(g, w)
        return
    g, w = got.numpy(), np.asarray(want)
    assert g.dtype == w.dtype
    np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------------------------
# core.load_aware
# ---------------------------------------------------------------------------

def _hist(seed, E=16):
    return np.random.default_rng(seed).integers(0, 500, E).astype(np.int32)


@pytest.mark.parametrize("per_dev", [1, 2, 4, 8])
def test_device_loads_exact(per_dev):
    _equal(*_both(tla.device_loads, jla.device_loads, _hist(per_dev),
                  experts_per_device=per_dev))
    _equal(*_both(tla.post_drop_loads, jla.post_drop_loads, _hist(9),
                  experts_per_device=per_dev))


@pytest.mark.parametrize("t_max", [0.1, 0.12, 0.45])
def test_step_down_thresholds_exact(t_max):
    loads = np.array([10., 20., 30., 40., 3., 0., 25., 25.], np.float32)
    got, want = _both(tla.step_down_thresholds, jla.step_down_thresholds,
                      loads, t_max=t_max)
    _equal(got, want)
    # mean load 19.125: ratio >= 1 keeps T_max, below it steps down
    assert got[1] == got[3] == got[6] == np.float32(t_max)
    assert got[5] == 0 < got[4] < got[0] < got[1]


@pytest.mark.parametrize("t_gap", [0.0, 0.01, 0.05])
def test_pair_thresholds_and_makespan_exact(t_gap):
    rng = np.random.default_rng(3)
    idx = rng.integers(0, 16, (64, 4)).astype(np.int32)
    loads = np.array([10., 40., 5., 25.], np.float32)
    _equal(*_both(tla.pair_thresholds, jla.pair_thresholds, idx, loads,
                  experts_per_device=4, t_max=0.12, t_gap=t_gap))
    _equal(*_both(tla.makespan, jla.makespan, loads))


# ---------------------------------------------------------------------------
# The policies' routing
# ---------------------------------------------------------------------------

def _skewed_layer(seed, T=512, d=64, E=16, hot=4, skew=1.5):
    """Router weights and tokens whose routing loads the first ``hot``
    experts (one modelled device at n_devices=4) far above the rest."""
    rng = np.random.default_rng(seed)
    v = rng.standard_normal(d)
    v /= np.linalg.norm(v)
    wg = rng.standard_normal((d, E)) * 0.1
    wg[:, :hot] += skew * v[:, None]
    x = rng.standard_normal((T, d)) + skew * v
    return {"wg": wg.astype(np.float32)}, x.astype(np.float32)


def _route_both(tp, jp, layer, x, cfg, jcfg):
    pt = tp.route({k: torch.from_numpy(v) for k, v in layer.items()},
                  torch.from_numpy(x), cfg)
    pj = jp.route({k: jnp.asarray(v) for k, v in layer.items()},
                  jnp.asarray(x), jcfg)
    for f in ("idx", "keep", "modes"):
        np.testing.assert_array_equal(getattr(pt, f).numpy(),
                                      np.asarray(getattr(pj, f)), err_msg=f)
    return pt


@pytest.mark.parametrize("n_devices", [1, 4])
def test_load_aware_keep_masks_match_jax(n_devices):
    """At n_devices=1 the modelled device is always at ratio 1: the keep
    masks equal ``TwoTDrop(t_max - t_gap, t_max + t_gap)``'s. At 4 on the
    skewed router the light devices drop less than the hot one."""
    cfg, jcfg = get_config(ARCH), jax_config(ARCH)
    layer, x = _skewed_layer(seed=n_devices)
    kw = dict(partition_p=2, n_devices=n_devices, t_max=0.2, t_gap=0.02)
    pt = _route_both(tpolicy.LoadAwareTwoT(**kw), jpolicy.LoadAwareTwoT(**kw),
                     layer, x, cfg, jcfg)
    two = tpolicy.TwoTDrop(partition_p=2, t_major=np.float32(0.2) - 0.02,
                           t_minor=np.float32(0.2) + 0.02)
    p2 = two.route({"wg": torch.from_numpy(layer["wg"])},
                   torch.from_numpy(x), cfg)
    same = bool(torch.equal(pt.keep, p2.keep))
    assert same == (n_devices == 1)
    if n_devices == 4:
        hist = np.bincount(pt.idx.numpy().reshape(-1) // 2, minlength=16)
        loads = hist.reshape(4, 4).sum(1)
        assert loads.argmax() == 0 and loads[0] > 2 * loads[1:].max()
        dev = pt.idx.numpy()[:, ::2] // 8                   # (T, K) devices
        kept = pt.modes.numpy() > 0
        hot_keep, cold_keep = kept[dev == 0].mean(), kept[dev > 0].mean()
        assert cold_keep > hot_keep
        assert pt.keep.sum() > p2.keep.sum()


def test_load_aware_explicit_loads_match_jax():
    """A given (D,) histogram in place of the batch's own: uniform loads
    give 2T at t_max ± t_gap, skewed ones JAX's masks."""
    cfg, jcfg = get_config(ARCH), jax_config(ARCH)
    layer, x = _skewed_layer(seed=7)
    kw = dict(partition_p=2, n_devices=4, t_max=0.2, t_gap=0.02)
    tp, jp = tpolicy.LoadAwareTwoT(**kw), jpolicy.LoadAwareTwoT(**kw)
    wt, xt = {"wg": torch.from_numpy(layer["wg"])}, torch.from_numpy(x)
    wj, xj = {"wg": jnp.asarray(layer["wg"])}, jnp.asarray(x)
    for loads in ([100., 100., 100., 100.], [400., 10., 50., 120.]):
        lt = tp.route(wt, xt, cfg, loads=torch.tensor(loads))
        lj = jp.route(wj, xj, jcfg, loads=jnp.asarray(loads, jnp.float32))
        np.testing.assert_array_equal(lt.keep.numpy(), np.asarray(lj.keep))
    two = tpolicy.TwoTDrop(partition_p=2, t_major=np.float32(0.2) - 0.02,
                           t_minor=np.float32(0.2) + 0.02).route(wt, xt, cfg)
    uni = tp.route(wt, xt, cfg, loads=torch.full((4,), 100.))
    assert torch.equal(uni.keep, two.keep)


def test_load_aware_per_token_thresholds_match_jax():
    """(T,) per-token t_max / t_gap, as the slot engines pass them."""
    cfg, jcfg = get_config(ARCH), jax_config(ARCH)
    layer, x = _skewed_layer(seed=11, T=96)
    rng = np.random.default_rng(12)
    t_max = rng.uniform(0.1, 0.3, 96).astype(np.float32)
    t_gap = rng.uniform(0.0, 0.03, 96).astype(np.float32)
    _route_both(
        tpolicy.LoadAwareTwoT(n_devices=4, t_max=torch.from_numpy(t_max),
                              t_gap=torch.from_numpy(t_gap)),
        jpolicy.LoadAwareTwoT(n_devices=4, t_max=jnp.asarray(t_max),
                              t_gap=jnp.asarray(t_gap)),
        layer, x, cfg, jcfg)


def test_load_aware_drops_less_at_same_makespan():
    """§4.3, Fig. 11: against one uniform T_max, the step-down thresholds
    drop FEWER pairs while the post-drop makespan does not exceed the
    uniform policy's (the port's functions on a seeded skewed router)."""
    D, E_per, T, K = 4, 4, 4096, 2
    E = D * E_per
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((T, E)) + np.where(np.arange(E) < E_per,
                                                    1.5, 0.0)
    r = tgating.top_k_routing(torch.from_numpy(logits.astype(np.float32)),
                              K, renorm=True)
    loads = tla.device_loads(tgating.expert_histogram(r.idx, E), E_per)
    t_max = 0.45
    keep_uniform = r.norm_score > t_max
    t_dev = tla.step_down_thresholds(loads, t_max)
    keep_la = r.norm_score > t_dev[r.idx.long() // E_per]

    def ms(keep):
        h = tgating.expert_histogram(r.idx, E, keep=keep)
        return float(tla.makespan(tla.post_drop_loads(h, E_per)))
    dropped_uniform = 1 - float(keep_uniform.float().mean())
    dropped_la = 1 - float(keep_la.float().mean())
    assert dropped_la < dropped_uniform
    assert ms(keep_la) <= ms(keep_uniform) * 1.02


def test_per_layer_thresholds_match_jax():
    """``PerLayerCalibrated2T.prepare`` on one layer and the same
    calibration batch: the stored (2,) thresholds against JAX's."""
    cfg, jcfg = get_config(ARCH).reduced(), jax_config(ARCH).reduced()
    rng = np.random.default_rng(4)
    d, E, f = cfg.d_model, cfg.n_experts, cfg.d_expert
    layer = dict(
        wg=(rng.standard_normal((d, E)) * 0.1).astype(np.float32),
        w1=(rng.standard_normal((E, d, f)) * 0.02).astype(np.float32),
        w3=(rng.standard_normal((E, d, f)) * 0.02).astype(np.float32),
        w2=(rng.standard_normal((E, f, d)) * 0.02).astype(np.float32))
    calib = rng.standard_normal((256, d)).astype(np.float32)
    for target in (0.1, 0.4):
        tp = tpolicy.make_policy("per_layer", cfg.dualsparse,
                                 drop_target=target)
        jp = jpolicy.make_policy("per_layer", jcfg.dualsparse,
                                 drop_target=target)
        pt, _ = tp.prepare({k: torch.from_numpy(v) for k, v in layer.items()},
                           cfg, torch.from_numpy(calib))
        pj, _ = jp.prepare({k: jnp.asarray(v) for k, v in layer.items()},
                           jcfg, jnp.asarray(calib))
        assert pt["thresholds"].dtype == torch.float32
        assert tuple(pt["thresholds"].shape) == (2,)
        np.testing.assert_allclose(pt["thresholds"].numpy(),
                                   np.asarray(pj["thresholds"]), rtol=RTOL)
        assert pt["thresholds"][0] <= pt["thresholds"][1]


def test_registry():
    assert set(tpolicy.POLICIES) == {"none", "1t", "2t", "load_aware",
                                     "per_layer"}
    assert set(tpolicy.POLICIES) == set(jpolicy.POLICIES)
    ds = get_config(ARCH).dualsparse
    for name in tpolicy.POLICIES:
        assert tpolicy.make_policy(name, ds).name == name
    la = tpolicy.make_policy("load_aware", ds, n_devices=4)
    assert la.thresholds() == (ds.t_max, (ds.t_minor - ds.t_major) / 2)
    assert tpolicy.make_policy("per_layer", ds).thresholds() == ()
    with pytest.raises(ValueError, match="thresholds"):
        tpolicy.make_policy("per_layer", ds).route(
            {"wg": torch.zeros(4, 4)}, torch.zeros(2, 4), get_config(ARCH))


# ---------------------------------------------------------------------------
# Reduced DBRX-132B under both policies
# ---------------------------------------------------------------------------

def _policy_pair(name):
    """(port, JAX) policies with equal values: load_aware over 2 modelled
    devices (2 of the reduced model's 4 experts each) at a T_max where the
    top-2 scores spread; per_layer calibrated to a 25% drop."""
    if name == "load_aware":
        kw = dict(partition_p=2, n_devices=2, t_max=0.42, t_gap=0.03)
        return tpolicy.LoadAwareTwoT(**kw), jpolicy.LoadAwareTwoT(**kw)
    return (tpolicy.PerLayerCalibrated2T(drop_target=0.25),
            jpolicy.PerLayerCalibrated2T(drop_target=0.25))


@functools.lru_cache(maxsize=None)
def _prepared():
    """JAX weights of reduced DBRX-132B prepared by the JAX ``per_layer``
    policy (partition, reconstruction and the per-layer thresholds in the
    tree), and the same tree in the port. ``load_aware`` prepares the
    weights alike and ignores the thresholds, so both policies share it."""
    cfg, jcfg = get_config(ARCH).reduced(), jax_config(ARCH).reduced()
    params = JM.init_params(jax.random.PRNGKey(0), jcfg)
    calib = jax_calib(jax.random.PRNGKey(7), 256, jcfg.d_model)
    params, _ = _policy_pair("per_layer")[1].prepare(params, jcfg, calib)
    model = params_from_numpy(jax.tree.map(np.asarray, params), cfg,
                              device="cpu")
    return cfg, jcfg, params, model


def _setup(name):
    """The shared weights and both packages' policies ``name``."""
    cfg, jcfg, params, model = _prepared()
    tp, jp = _policy_pair(name)
    dist = JT.DistContext(mesh=make_host_mesh(1), moe_impl="dispatch",
                          policy=jp)
    return cfg, jcfg, params, dist, model, tp


def _close(a, b, rel=1e-4):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    assert a.shape == b.shape
    np.testing.assert_allclose(a, b, rtol=0,
                               atol=rel * float(np.abs(b).max()))


def test_thresholds_load_through_the_weight_bridge():
    """The JAX-prepared tree's per-layer (L, 2) thresholds reach each
    ``MoELayer`` (its ``thresholds``) and its ``weights()``."""
    cfg, _, params, _, model, _ = _setup("per_layer")
    th = np.asarray(params["blocks"]["moe"]["thresholds"])
    assert th.shape == (cfg.n_layers, 2)
    for i, blk in enumerate(model.blocks):
        np.testing.assert_array_equal(blk.moe.weights()["thresholds"], th[i])


def test_prepare_keeps_per_layer_thresholds_on_the_model():
    """``MoELayer.load_weights`` keeps a prepared dict's ``thresholds``, so
    a model prepared by ``per_layer`` routes with its layers' own values."""
    from repro_torch.data.pipeline import calibration_activations
    from repro_torch.models import model as M
    cfg = get_config(ARCH).reduced()
    model = M.init_params(cfg, seed=0, device="cpu")
    assert all(b.moe.thresholds is None for b in model.blocks)
    calib = calibration_activations(np.random.default_rng(7), 128,
                                    cfg.d_model, device="cpu")
    pol = tpolicy.make_policy("per_layer", cfg.dualsparse)
    model, pol = pol.prepare(model, cfg, calib)
    ths = [b.moe.weights()["thresholds"] for b in model.blocks]
    assert all(tuple(t.shape) == (2,) and t[0] <= t[1] for t in ths)
    assert not torch.equal(ths[0], ths[1])
    toks = torch.randint(0, cfg.vocab_size, (2, 8))
    with torch.no_grad():
        logits, cache = TT.prefill(model, {"tokens": toks}, cfg, policy=pol)
    assert torch.isfinite(logits).all()
    assert int(cache["metrics"].dropped_pairs) > 0


@pytest.mark.parametrize("name", ["load_aware", "per_layer"])
def test_dbrx_prefill_and_decode_match_jax(name):
    cfg, jcfg, params, dist, model, tp = _setup(name)
    B, S, steps = 2, 12, 3
    toks = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)
    lj, cj = JT.prefill(params, {"tokens": jnp.asarray(toks)}, jcfg,
                        cache_len=S + steps, dist=dist,
                        cache_dtype=jnp.float32)
    with torch.no_grad():
        lt, ct = TT.prefill(model, {"tokens": torch.from_numpy(toks).long()},
                            cfg, cache_len=S + steps, policy=tp,
                            cache_dtype=torch.float32)
    _close(lt, lj)
    nxt = np.array(jnp.argmax(lj[:, -1:], -1), np.int32)
    for _ in range(steps):
        lj, cj = JT.decode_step(params, jnp.asarray(nxt), cj, jcfg,
                                dist=dist)
        with torch.no_grad():
            lt, ct = TT.decode_step(model, torch.from_numpy(nxt).long(), ct,
                                    cfg, policy=tp)
        _close(lt, lj)
        nxt = np.array(jnp.argmax(lj[:, -1:], -1), np.int32)
    mj, mt = cj["metrics"].snapshot(), ct["metrics"].snapshot()
    for k in mj:
        np.testing.assert_array_equal(mt[k], mj[k], err_msg=k)
    assert mt["dropped_pairs"] > 0 and mt["kept_major"] > 0


def _engine_pair(engine, cfg, jcfg, params, dist, model, tp):
    if engine == "sync":
        kw = dict(batch_size=3, max_prompt_len=10, max_new_tokens=5)
        return (ServingEngine(cfg, model, policy=tp, device="cpu",
                              cache_dtype=torch.float32, **kw),
                JSync(jcfg, params, dist=dist, cache_dtype=jnp.float32, **kw))
    kw = dict(n_slots=3, max_prompt_len=10, max_new_tokens=5)
    tcls, jcls = ContinuousBatchingEngine, JCont
    if engine == "paged":
        kw.update(page_size=4, chunk_size=4)
        tcls, jcls = PagedEngine, JPaged
    return (tcls(cfg, model, policy=tp, device="cpu",
                 cache_dtype=torch.float32, **kw),
            jcls(jcfg, params, dist=dist, cache_dtype=jnp.float32, **kw))


@pytest.mark.parametrize("engine", ["sync", "continuous", "paged"])
@pytest.mark.parametrize("name", ["load_aware", "per_layer"])
def test_engines_serve_under_policy_like_jax(name, engine):
    """Each engine under the policy: the same greedy tokens, scheduler
    counts and MoE counters as the JAX engine on the same weights and
    ragged prompts (slot engines: padded and idle slots enter the
    load_aware histogram as they do in JAX)."""
    cfg, jcfg, params, dist, model, tp = _setup(name)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (10, 7, 4, 9, 6)]
    teng, jeng = _engine_pair(engine, cfg, jcfg, params, dist, model, tp)
    rt = teng.generate(prompts, GenerationConfig(max_new_tokens=5))
    rj = jeng.generate(prompts, JGen(max_new_tokens=5))
    assert [r.tokens for r in rt] == [r.tokens for r in rj]
    assert teng.overflow_pairs == jeng.overflow_pairs
    ct, cj = teng.metrics().counters, jeng.metrics().counters
    moe = [k for k in cj if k.startswith("repro_moe_")]
    assert moe and all(ct[k] == cj[k] for k in moe)
    if engine != "sync":
        assert teng.decode_steps == jeng.decode_steps
        assert teng.max_concurrency == jeng.max_concurrency == 3


def test_load_aware_per_request_override_matches_jax():
    """A request with its own (t_max, t_gap) beside base-policy requests in
    the continuous engine: per-slot threshold vectors, as in JAX."""
    cfg, jcfg, params, dist, model, tp = _setup("load_aware")
    over_t = dataclasses.replace(tp, t_max=0.3, t_gap=0.0)
    over_j = dataclasses.replace(dist.policy, t_max=0.3, t_gap=0.0)
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (10, 8, 6)]
    teng, jeng = _engine_pair("continuous", cfg, jcfg, params, dist, model,
                              tp)
    tu = [teng.submit(p, GenerationConfig(
        max_new_tokens=4, policy=over_t if i == 1 else None))
        for i, p in enumerate(prompts)]
    ju = [jeng.submit(p, JGen(max_new_tokens=4,
                              policy=over_j if i == 1 else None))
          for i, p in enumerate(prompts)]
    teng.drain()
    jeng.drain()
    assert [teng.result(u).tokens for u in tu] == \
        [jeng.result(u).tokens for u in ju]
    ct, cj = teng.metrics().counters, jeng.metrics().counters
    assert all(ct[k] == cj[k] for k in cj if k.startswith("repro_moe_"))
