"""Routing math of the port against the JAX package on the same numpy
inputs: gating, 1T/2T drop, partition transforms and reconstruction.

Integer results (expert ids, modes, keep masks, counts, neuron orders) must
be equal. Float results: rtol 1e-5 / atol 1e-6 in float32 — softmax and
matrix products sum in another order in each framework; reshapes and
permutations of weights are exact."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.core import drop as jdrop
from repro.core import gating as jgating
from repro.core import partition as jpart
from repro.core import reconstruct as jrec
from repro_torch.configs import get_config
from repro_torch.core import drop as tdrop
from repro_torch.core import gating as tgating
from repro_torch.core import partition as tpart
from repro_torch.core import reconstruct as trec

RTOL, ATOL = 1e-5, 1e-6
ARCHS = ["olmoe-lite", "mixtral-8x7b-lite", "qwen3-moe-30b-a3b"]


def _cfg(arch):
    """Port config and JAX config of the same (CPU-sized) architecture."""
    if arch == "qwen3-moe-30b-a3b":
        return get_config(arch).reduced(), jax_config(arch).reduced()
    return get_config(arch), jax_config(arch)


def _moe_arrays(cfg, seed, T=64, sharp=4.0):
    rng = np.random.default_rng(seed)
    d, E, f = cfg.d_model, cfg.n_experts, cfg.d_expert
    return dict(
        x=rng.standard_normal((T, d)).astype(np.float32),
        wg=(rng.standard_normal((d, E)) * 0.02 * sharp).astype(np.float32),
        w1=(rng.standard_normal((E, d, f)) * 0.02).astype(np.float32),
        w3=(rng.standard_normal((E, d, f)) * 0.02).astype(np.float32),
        w2=(rng.standard_normal((E, f, d)) * 0.02).astype(np.float32))


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def test_configs_are_copies():
    from repro.configs import list_archs as jax_archs
    from repro_torch.configs import list_archs
    for arch in list_archs():
        assert arch in jax_archs()
        assert get_config(arch) == jax_config(arch) or \
            repr(get_config(arch)) == repr(jax_config(arch))
        assert repr(get_config(arch).reduced()) == \
            repr(jax_config(arch).reduced())


@pytest.mark.parametrize("arch", ARCHS)
def test_route_matches_jax(arch):
    cfg, _ = _cfg(arch)
    a = _moe_arrays(cfg, seed=11)
    rj = jgating.route(jnp.asarray(a["x"]), jnp.asarray(a["wg"]), cfg.top_k,
                       cfg.router_norm_topk)
    rt = tgating.route(torch.from_numpy(a["x"]), torch.from_numpy(a["wg"]),
                       cfg.top_k, cfg.router_norm_topk)
    np.testing.assert_array_equal(_np(rt.idx), _np(rj.idx))
    assert rt.idx.dtype == torch.int32
    for name in ("combine", "norm_score", "probs"):
        np.testing.assert_allclose(_np(getattr(rt, name)),
                                   _np(getattr(rj, name)), rtol=RTOL,
                                   atol=ATOL)


def test_top_k_ties_take_the_lower_index():
    """Equal probabilities: ``lax.top_k`` takes the lower expert id first;
    the port's stable sort keeps that rule."""
    logits = np.zeros((3, 6), np.float32)
    logits[0] = [1, 2, 2, 0, 2, 1]
    logits[1] = 0.5
    logits[2] = [3, 1, 3, 1, 3, 3]
    rj = jgating.top_k_routing(jnp.asarray(logits), 3, True)
    rt = tgating.top_k_routing(torch.from_numpy(logits), 3, True)
    np.testing.assert_array_equal(_np(rt.idx), _np(rj.idx))
    np.testing.assert_array_equal(_np(rt.idx)[1], [0, 1, 2])


@pytest.mark.parametrize("shape", ["scalar", "per_token", "per_pair"])
def test_two_t_and_one_t_match_jax(shape):
    rng = np.random.default_rng(3)
    T, K, P = 50, 4, 2
    score = rng.random((T, K)).astype(np.float32)
    idx = rng.integers(0, 8, (T, K)).astype(np.int32)
    comb = rng.random((T, K)).astype(np.float32)
    # thresholds that hit some scores exactly: both boundaries are strict
    if shape == "scalar":
        tm, tn = float(score[0, 0]), float(score[1, 1])
    elif shape == "per_token":
        tm = score[:, 0].copy()
        tn = np.maximum(score[:, 1], tm).astype(np.float32)
    else:
        tm = np.full((T, K), score[2, 2], np.float32)
        tn = np.full((T, K), score[3, 3], np.float32)
        tn = np.maximum(tn, tm)
    jm = jdrop.two_t_modes(jnp.asarray(score), jnp.asarray(tm),
                           jnp.asarray(tn))
    tmodes = tdrop.two_t_modes(torch.from_numpy(score), torch.as_tensor(tm),
                               torch.as_tensor(tn))
    np.testing.assert_array_equal(_np(tmodes), _np(jm))
    pj = jdrop.expand_pairs_2t(jnp.asarray(idx), jnp.asarray(comb),
                               jnp.asarray(score), P, jnp.asarray(tm),
                               jnp.asarray(tn))
    pt = tdrop.expand_pairs_2t(torch.from_numpy(idx), torch.from_numpy(comb),
                               torch.from_numpy(score), P,
                               torch.as_tensor(tm), torch.as_tensor(tn))
    for name in ("idx", "combine", "keep", "modes"):
        np.testing.assert_array_equal(_np(getattr(pt, name)),
                                      _np(getattr(pj, name)), err_msg=name)
    for p in (1, P):
        keep = _np(pt.keep) if p == P else _np(pt.keep)[:, ::P]
        cj = jdrop.sub_pair_outcome_counts(jnp.asarray(keep), p)
        ct = tdrop.sub_pair_outcome_counts(torch.from_numpy(keep), p)
        assert [int(v) for v in ct] == [int(v) for v in cj]
    if shape != "per_pair":
        qj = jdrop.expand_pairs_1t(jnp.asarray(idx), jnp.asarray(comb),
                                   jnp.asarray(score), P, jnp.asarray(tm))
        qt = tdrop.expand_pairs_1t(torch.from_numpy(idx),
                                   torch.from_numpy(comb),
                                   torch.from_numpy(score), P,
                                   torch.as_tensor(tm))
        for name in ("idx", "combine", "keep", "modes"):
            np.testing.assert_array_equal(_np(getattr(qt, name)),
                                          _np(getattr(qj, name)),
                                          err_msg=name)


@pytest.mark.parametrize("target", [0.0, 0.2, 0.25, 0.5, 1.0])
def test_calibrate_threshold_matches_jax(target):
    scores = np.random.default_rng(4).random((96, 8)).astype(np.float32)
    tj = jdrop.calibrate_threshold(jnp.asarray(scores), target)
    tt = tdrop.calibrate_threshold(torch.from_numpy(scores), target)
    assert tt.dtype == torch.float32
    assert float(tt) == float(tj)


@pytest.mark.parametrize("p", [2, 4])
def test_partition_transforms_match_jax(p):
    cfg, _ = _cfg("olmoe-lite")
    a = _moe_arrays(cfg, seed=5, T=4)
    params_j = {k: jnp.asarray(v) for k, v in a.items() if k != "x"}
    params_t = {k: torch.from_numpy(v) for k, v in a.items() if k != "x"}
    for fn_j, fn_t in ((jpart.partial_transform, tpart.partial_transform),
                       (jpart.complete_transform, tpart.complete_transform)):
        out_j, out_t = fn_j(params_j, p), fn_t(params_t, p)
        for k in out_j:
            np.testing.assert_array_equal(_np(out_t[k]), _np(out_j[k]))
    part_t = tpart.partial_transform(params_t, p)
    back = tpart.invert_partial(part_t, p)
    back_j = jpart.invert_partial(jpart.partial_transform(params_j, p), p)
    for k in ("w1", "w3", "w2"):
        np.testing.assert_array_equal(_np(back[k]), a[k])
        np.testing.assert_array_equal(_np(back[k]), _np(back_j[k]))


@pytest.mark.parametrize("p", [2, 4])
def test_dense_ffn_partition_matches_jax(p):
    """A dense SwiGLU FFN split into p uniform sub-FFNs: leaves bit for bit
    JAX's ``dense_ffn_partition``, and the sub-FFNs' outputs sum to the
    whole FFN's (rel 1e-6 of its largest magnitude)."""
    rng = np.random.default_rng(11)
    d, f = 32, 64
    w1, w3 = (rng.standard_normal((d, f)).astype(np.float32) * 0.1
              for _ in range(2))
    w2 = rng.standard_normal((f, d)).astype(np.float32) * 0.1
    x = rng.standard_normal((8, d)).astype(np.float32)
    got = tpart.dense_ffn_partition(*(torch.from_numpy(w)
                                      for w in (w1, w3, w2)), p)
    want = jpart.dense_ffn_partition(*(jnp.asarray(w) for w in (w1, w3, w2)),
                                     p)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_np(g), _np(w))
    assert tuple(got[0].shape) == (p, d, f // p)
    assert tuple(got[2].shape) == (p, f // p, d)
    xt = torch.from_numpy(x).double()
    whole = (torch.nn.functional.silu(xt @ torch.from_numpy(w1).double())
             * (xt @ torch.from_numpy(w3).double())) \
        @ torch.from_numpy(w2).double()
    parts = sum((torch.nn.functional.silu(xt @ a.double()) * (xt @ b.double()))
                @ c.double() for a, b, c in zip(*got))
    err = (parts - whole).abs().max() / whole.abs().max()
    assert float(err) <= 1e-6


@pytest.mark.parametrize("method", ["gate", "abs_gate", "gate_up",
                                    "abs_gate_up"])
@pytest.mark.parametrize("routed_only", [True, False])
def test_neuron_importance_matches_jax(method, routed_only):
    cfg, jcfg = _cfg("olmoe-lite")
    a = _moe_arrays(cfg, seed=6, T=48)
    imp_j = jrec.neuron_importance({k: jnp.asarray(v) for k, v in a.items()},
                                   jnp.asarray(a["x"]), jcfg, method,
                                   routed_only=routed_only)
    imp_t = trec.neuron_importance(
        {k: torch.from_numpy(v) for k, v in a.items()},
        torch.from_numpy(a["x"]), cfg, method, routed_only=routed_only)
    # the signed metrics cancel: the sum-order error scales with the terms,
    # so the absolute bar is relative to the largest importance
    np.testing.assert_allclose(_np(imp_t), _np(imp_j), rtol=RTOL,
                               atol=RTOL * float(np.abs(_np(imp_j)).max()))


@pytest.mark.parametrize("arch", ARCHS)
def test_partition_and_reconstruct_matches_jax(arch):
    """Neuron order equal for equal importances (stable descending sort on
    both sides, ties included), and the whole reconstruction equal up to
    near-tied importances."""
    cfg, jcfg = _cfg(arch)
    a = _moe_arrays(cfg, seed=8, T=64)
    params_j = {k: jnp.asarray(v) for k, v in a.items() if k != "x"}
    params_t = {k: torch.from_numpy(v) for k, v in a.items() if k != "x"}
    imp = np.array(jrec.neuron_importance(params_j, jnp.asarray(a["x"]),
                                          jcfg))
    # same importance -> identical permutation, including ties
    imp[:, 1] = imp[:, 0]
    rj = jrec.reorder_neurons(params_j, jnp.asarray(imp))
    rt = trec.reorder_neurons(params_t, torch.from_numpy(imp))
    for k in ("w1", "w3", "w2"):
        np.testing.assert_array_equal(_np(rt[k]), _np(rj[k]))
    # the whole process: the port's result is the JAX transforms applied
    # with the port's importance, whose order equals the JAX order except
    # between neurons whose importances agree to float32 rounding
    pt = trec.partition_and_reconstruct(params_t, torch.from_numpy(a["x"]),
                                        cfg, p=2)
    imp_t = trec.neuron_importance(params_t, torch.from_numpy(a["x"]),
                                   cfg).numpy()
    imp_j = np.asarray(jrec.neuron_importance(params_j, jnp.asarray(a["x"]),
                                              jcfg))
    expected = jpart.partial_transform(
        jrec.reorder_neurons(params_j, jnp.asarray(imp_t)), 2)
    for k in ("wg", "w1", "w3", "w2"):
        np.testing.assert_array_equal(_np(pt[k]), _np(expected[k]),
                                      err_msg=k)
    order_j = np.argsort(-imp_j, axis=-1, kind="stable")
    order_t = np.argsort(-imp_t, axis=-1, kind="stable")
    e, pos = np.nonzero(order_j != order_t)
    assert len(e) <= 0.01 * order_j.size
    np.testing.assert_allclose(imp_j[e, order_t[e, pos]],
                               imp_j[e, order_j[e, pos]], rtol=0,
                               atol=RTOL * float(np.abs(imp_j).max()))
