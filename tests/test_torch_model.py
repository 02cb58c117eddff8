"""The port's decoder and serving engine against the JAX package, on the
JAX package's own weights loaded through the weight bridge
(``repro_torch.checkpoint.from_numpy``), under a calibrated 2T policy whose
threshold values both sides share.

Tolerances:
  * float32 KV cache: logits within 1e-4 of their largest magnitude — the
    same float32 arithmetic, summed in another order per matrix product,
    through every layer;
  * bfloat16 KV cache (the default): within 1e-3 of the largest magnitude —
    K/V and the softmax are rounded to bfloat16 before ``p @ v``; both
    frameworks round at the same points on the CPU (the two agree to ~1e-6
    here), but a product rounded one bfloat16 ulp (2^-8) apart in one
    attention output would show in the logits at about this size, after
    the residual stream and the output projection dilute it;
  * greedy tokens of the serving engines: equal, at a float32 cache.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.core.policy import make_policy as jax_make_policy
from repro.data.pipeline import calibration_activations as jax_calib
from repro.launch.mesh import make_host_mesh
from repro.models import model as JM
from repro.models import transformer as JT
from repro.serving import GenerationConfig as JGen
from repro.serving import ServingEngine as JEngine
from repro_torch.checkpoint.from_numpy import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.core.policy import TwoTDrop
from repro_torch.models import transformer as TT
from repro_torch.serving import GenerationConfig, ServingEngine

ARCHS = ["qwen3-moe-30b-a3b", "mixtral-8x7b-lite"]


def _cfgs(arch):
    if arch == "qwen3-moe-30b-a3b":
        return get_config(arch).reduced(), jax_config(arch).reduced()
    return get_config(arch), jax_config(arch)


@functools.lru_cache(maxsize=None)
def _setup(arch):
    """JAX weights prepared by a calibrated JAX 2T policy, the same tree in
    the port, and the two policies with equal thresholds (shared between
    tests: nothing here mutates the weights)."""
    cfg, jcfg = _cfgs(arch)
    params = JM.init_params(jax.random.PRNGKey(0), jcfg)
    calib = jax_calib(jax.random.PRNGKey(7), 256, jcfg.d_model)
    jpol = jax_make_policy("2t", jcfg.dualsparse, drop_target=0.25)
    params, jpol = jpol.prepare(params, jcfg, calib)
    model = params_from_numpy(jax.tree.map(np.asarray, params), cfg,
                              device="cpu")
    tpol = TwoTDrop.from_config(cfg.dualsparse)
    tpol = TwoTDrop(partition_p=tpol.partition_p, importance=tpol.importance,
                    t_major=float(jpol.t_major), t_minor=float(jpol.t_minor))
    dist = JT.DistContext(mesh=make_host_mesh(1), moe_impl="dispatch",
                          policy=jpol)
    return cfg, jcfg, params, jpol, dist, model, tpol


def _tokens(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


def _close(a, b, rel):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    assert a.shape == b.shape
    np.testing.assert_allclose(a, b, rtol=0,
                               atol=rel * float(np.abs(b).max()))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("cache", ["float32", "bfloat16"])
def test_prefill_and_decode_logits_match_jax(arch, cache):
    cfg, jcfg, params, jpol, dist, model, tpol = _setup(arch)
    rel = 1e-4 if cache == "float32" else 1e-3
    jdt = jnp.float32 if cache == "float32" else jnp.bfloat16
    tdt = torch.float32 if cache == "float32" else torch.bfloat16
    B, S, steps = 2, 12, 3
    toks = _tokens(cfg, B, S, seed=1)
    lj, cj = JT.prefill(params, {"tokens": jnp.asarray(toks)}, jcfg,
                        cache_len=S + steps, dist=dist, cache_dtype=jdt)
    with torch.no_grad():
        lt, ct = TT.prefill(model, {"tokens": torch.from_numpy(toks).long()},
                            cfg, cache_len=S + steps, policy=tpol,
                            cache_dtype=tdt)
    _close(lt, lj, rel)
    for i, layer in enumerate(ct["layers"]):
        for kv in ("k", "v"):
            _close(layer[kv].float(),
                   np.asarray(cj["layers"][kv][i], np.float32), rel)
    mj, mt = cj["metrics"].snapshot(), ct["metrics"].snapshot()
    for k in mj:
        np.testing.assert_array_equal(mt[k], mj[k], err_msg=k)
    nxt = np.array(jnp.argmax(lj[:, -1:], -1), np.int32)
    for _ in range(steps):
        lj, cj = JT.decode_step(params, jnp.asarray(nxt), cj, jcfg,
                                dist=dist)
        with torch.no_grad():
            lt, ct = TT.decode_step(model, torch.from_numpy(nxt).long(), ct,
                                    cfg, policy=tpol)
        _close(lt, lj, rel)
        nxt = np.array(jnp.argmax(lj[:, -1:], -1), np.int32)
    assert ct["pos"] == int(cj["pos"]) == S + steps
    mj, mt = cj["metrics"].snapshot(), ct["metrics"].snapshot()
    for k in mj:
        np.testing.assert_array_equal(mt[k], mj[k], err_msg=k)


@pytest.mark.parametrize("arch", ARCHS)
def test_serving_engine_tokens_match_jax(arch):
    """Greedy tokens of the port's engine equal the JAX engine's on the same
    weights, prompts (unequal lengths: left padding) and thresholds."""
    cfg, jcfg, params, jpol, dist, model, tpol = _setup(arch)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (10, 7, 10, 4, 9)]
    kw = dict(batch_size=3, max_prompt_len=10, max_new_tokens=6)
    jeng = JEngine(jcfg, params, dist=dist, cache_dtype=jnp.float32, **kw)
    teng = ServingEngine(cfg, model, policy=tpol, cache_dtype=torch.float32,
                         device="cpu", **kw)
    rj = jeng.generate(prompts, JGen(max_new_tokens=6))
    rt = teng.generate(prompts, GenerationConfig(max_new_tokens=6))
    assert [r.tokens for r in rt] == [r.tokens for r in rj]
    assert all(len(r.tokens) == 6 for r in rt)
    assert teng.overflow_pairs == jeng.overflow_pairs
    sj = jeng.metrics().counters
    st = teng.metrics().counters
    moe_keys = [k for k in sj if k.startswith("repro_moe_")]
    assert moe_keys and all(st[k] == sj[k] for k in moe_keys)
    t = teng.timing
    assert t["compile_steps"] == 1 and t["steady_steps"] == 1


def test_engine_policy_override_and_sampling():
    """Per-request threshold overrides batch separately; a sampled request
    is reproducible for a fixed seed."""
    cfg, _, _, _, _, model, tpol = _setup("qwen3-moe-30b-a3b")
    eng = ServingEngine(cfg, model, policy=tpol, batch_size=4,
                        max_prompt_len=8, max_new_tokens=4, device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, 8) for _ in range(3)]
    over = TwoTDrop(t_major=0.0, t_minor=0.0)
    uids = [eng.submit(prompts[0], GenerationConfig(max_new_tokens=4)),
            eng.submit(prompts[1], GenerationConfig(max_new_tokens=4,
                                                    policy=over)),
            eng.submit(prompts[2], GenerationConfig(max_new_tokens=4,
                                                    temperature=0.8,
                                                    seed=3))]
    eng.drain()
    assert [len(eng.result(u).tokens) for u in uids] == [4, 4, 4]
    assert eng.timing["compile_steps"] + eng.timing["steady_steps"] == 3
    eng2 = ServingEngine(cfg, model, policy=tpol, batch_size=4,
                         max_prompt_len=8, max_new_tokens=4, device="cpu")
    # the sampling generator is seeded by (seed, uid, step): same uid here
    eng2.generate(prompts[:2], GenerationConfig(max_new_tokens=1))
    again = eng2.generate([prompts[2]], GenerationConfig(
        max_new_tokens=4, temperature=0.8, seed=3))
    assert again[0].uid == uids[2]
    assert again[0].tokens == eng.result(uids[2]).tokens
    with pytest.raises(ValueError):
        from repro_torch.core.policy import OneTDrop
        eng.submit(prompts[0], GenerationConfig(policy=OneTDrop()))


def test_serve_cli_reduced_on_cpu(capsys, tmp_path):
    from repro_torch.launch import serve
    trace = tmp_path / "trace.json"
    results = serve.main(["--arch", "qwen3-moe-30b-a3b", "--reduced",
                          "--device", "cpu", "--requests", "3",
                          "--prompt-len", "8", "--new-tokens", "4",
                          "--batch-size", "2", "--policy", "2t",
                          "--drop-target", "0.25", "--metrics-log", "-",
                          "--trace-out", str(trace)])
    out = capsys.readouterr().out
    assert len(results) == 3 and all(len(r.tokens) == 4 for r in results)
    assert "sparsity policy '2t'" in out and "served 3 requests" in out
    assert '"repro_moe_subpairs_total{outcome=\\"kept_major\\"}"' in out
    assert trace.exists()
    with pytest.raises(SystemExit):
        serve.main(["--reduced", "--device", "cpu", "--engine", "convoy"])


@pytest.mark.parametrize("engine", ["continuous", "paged"])
def test_serve_cli_slot_engines_on_cpu(capsys, engine):
    from repro_torch.launch import serve
    results = serve.main(["--arch", "qwen3-moe-30b-a3b", "--reduced",
                          "--device", "cpu", "--engine", engine,
                          "--requests", "3", "--prompt-len", "8",
                          "--new-tokens", "3", "--slots", "2",
                          "--page-size", "4", "--chunk-size", "4",
                          "--policy", "2t"])
    out = capsys.readouterr().out
    assert len(results) == 3 and all(len(r.tokens) == 3 for r in results)
    assert "served 3 requests" in out and "slots=2 admitted=3" in out
