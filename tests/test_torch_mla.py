"""MLA (multi-head latent attention) of the port and MiniCPM3-4B, reduced,
against the JAX package on the same numpy inputs and the JAX package's own
weights (loaded through ``repro_torch.checkpoint.from_numpy``).

Tolerances:
  * the MLA functions, prefill (plain up to 1024 tokens, blockwise past)
    and the absorbed decode at a float32 cache: within 1e-5 of the
    largest magnitude (float32 products summed in other orders);
  * logits within 1e-4 of their largest magnitude at a float32 KV cache
    (the port's float32 bar, ``test_torch_model.py``); the bf16 cache (the
    engines' default) within 1e-2;
  * the engines' greedy tokens: equal.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import attention as JA
from repro.models import model as JM
from repro.models import transformer as JT
from repro.models.layers import split_params
from repro.serving import ContinuousBatchingEngine as JCont
from repro.serving import GenerationConfig as JGen
from repro.serving import PagedEngine as JPaged
from repro.serving import ServingEngine as JSync
from repro_torch.checkpoint.from_numpy import params_from_numpy
from _config_compat import shared_fields
from repro_torch.configs import get_config
from repro_torch.models import attention as TA
from repro_torch.models import transformer as TT
from repro_torch.serving import (ContinuousBatchingEngine, GenerationConfig,
                                 PagedEngine, ServingEngine)

ARCH = "minicpm3-4b"


def _close(a, b, rel=1e-5):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    assert a.shape == b.shape
    np.testing.assert_allclose(a, b, rtol=0,
                               atol=rel * float(np.abs(b).max()))


@functools.lru_cache(maxsize=None)
def _attn_setup():
    """Reduced MLA weights of JAX's init, as numpy, in both packages."""
    cfg, jcfg = get_config(ARCH).reduced(), jax_config(ARCH).reduced()
    params, _ = split_params(JA.make_mla_params(jax.random.PRNGKey(3), jcfg))
    params = jax.tree.map(np.asarray, params)
    attn = TA.MLAttention(cfg, device=torch.device("cpu"), generator=None)
    for k, v in params.items():
        setattr(attn, k, torch.nn.Parameter(torch.from_numpy(v.copy()),
                                            requires_grad=False))
    return cfg, jcfg, params, attn


def _x(B, S, d, seed):
    return (np.random.default_rng(seed).standard_normal((B, S, d)) * 0.3
            ).astype(np.float32)


def _pos(B, S):
    return np.tile(np.arange(S, dtype=np.int32)[None], (B, 1))


def test_config_matches_jax():
    got, want = get_config(ARCH), jax_config(ARCH)
    assert shared_fields(got) == dataclasses.asdict(want)
    assert got.attn_kind == "mla" and got.n_layers == 62


def test_mla_projections_match_jax():
    cfg, jcfg, params, attn = _attn_setup()
    x, pos = _x(2, 7, cfg.d_model, 0), _pos(2, 7)
    for got, want in zip(TA.mla_project_latent(attn, torch.from_numpy(x),
                                               cfg),
                         JA.mla_project_latent(params, jnp.asarray(x), jcfg)):
        _close(got, want)
    for got, want in zip(
            TA.mla_queries(attn, torch.from_numpy(x), torch.from_numpy(pos),
                           cfg),
            JA.mla_queries(params, jnp.asarray(x), jnp.asarray(pos), jcfg)):
        _close(got, want)


@pytest.mark.parametrize("B,S", [(2, 10), (1, 1100)])
def test_mla_attention_matches_jax(B, S):
    """Plain attention up to 1024 tokens, blockwise past that."""
    cfg, jcfg, params, attn = _attn_setup()
    x, pos = _x(B, S, cfg.d_model, S), _pos(B, S)
    got = TA.mla_attention(attn, torch.from_numpy(x), torch.from_numpy(pos),
                           cfg)
    want = JA.mla_attention(params, jnp.asarray(x), jnp.asarray(pos), jcfg)
    _close(got, want)


@pytest.mark.parametrize("per_slot", [False, True])
def test_mla_decode_matches_jax(per_slot):
    """The absorbed decode step by step against JAX's, from the prefill's
    latent cache (float32): at one host position, and at per-slot
    positions (the slots a step apart; the port's cache has the sink
    row)."""
    cfg, jcfg, params, attn = _attn_setup()
    B, S, steps, cap = 2, 6, 4, 12
    x = _x(B, S + steps, cfg.d_model, 5)
    pos = _pos(B, S)
    out_t, ct = TA.mla_prefill_attention(
        attn, torch.from_numpy(x[:, :S]), torch.from_numpy(pos), cfg,
        cap=cap, cache_dtype=torch.float32)
    out_j, cj = JA.mla_prefill_attention(
        params, jnp.asarray(x[:, :S]), jnp.asarray(pos), jcfg, cap=cap,
        cache_dtype=jnp.float32)
    _close(out_t, out_j)
    for k in ("c", "kr"):
        _close(ct[k], cj[k])
    if per_slot:
        ct = {k: torch.cat([v, torch.zeros_like(v[:, :1])], 1)
              for k, v in ct.items()}                     # the sink row
    for t in range(steps):
        xt = x[:, S + t:S + t + 1]
        if per_slot:
            p = np.array([S + t, S + t - 1], np.int32)
            pt, pj = torch.from_numpy(p), jnp.asarray(p)
        else:
            pt = pj = S + t
        ot, ct = TA.mla_decode_attention(attn, torch.from_numpy(xt), ct, pt,
                                         cfg)
        oj, cj = JA.mla_decode_attention(params, jnp.asarray(xt), cj, pj,
                                         jcfg)
        _close(ot, oj)
    for k in ("c", "kr"):
        _close(ct[k][:, :cap], cj[k])


@functools.lru_cache(maxsize=None)
def _model_setup():
    cfg, jcfg = get_config(ARCH).reduced(), jax_config(ARCH).reduced()
    params = JM.init_params(jax.random.PRNGKey(1), jcfg)
    model = params_from_numpy(jax.tree.map(np.asarray, params), cfg,
                              device="cpu")
    return cfg, jcfg, params, model


@pytest.mark.parametrize("cache", ["float32", "bfloat16"])
def test_prefill_and_decode_logits_match_jax(cache):
    """Reduced MiniCPM3-4B: prefill logits, the latent cache and three
    decode steps."""
    cfg, jcfg, params, model = _model_setup()
    B, S, steps = 2, 10, 3
    rel = 1e-4 if cache == "float32" else 1e-2
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size, (B, S)) \
        .astype(np.int32)
    lj, cj = JT.prefill(params, {"tokens": jnp.asarray(toks)}, jcfg,
                        cache_len=S + steps, cache_dtype=getattr(jnp, cache))
    with torch.no_grad():
        lt, ct = TT.prefill(model, {"tokens": torch.from_numpy(toks).long()},
                            cfg, cache_len=S + steps,
                            cache_dtype=getattr(torch, cache))
    _close(lt, lj, rel)
    assert ct["pos"] == int(cj["pos"]) == S
    for i, layer in enumerate(ct["layers"]):
        assert set(layer) == {"c", "kr"}
        _close(layer["c"].float(), np.asarray(cj["layers"]["c"][i],
                                              np.float32), max(rel, 1e-5))
    nxt = np.array(jnp.argmax(lj[:, -1:], -1), np.int32)
    for _ in range(steps):
        lj, cj = JT.decode_step(params, jnp.asarray(nxt), cj, jcfg)
        with torch.no_grad():
            lt, ct = TT.decode_step(model, torch.from_numpy(nxt).long(), ct,
                                    cfg)
        _close(lt, lj, rel)
        nxt = np.array(jnp.argmax(lj[:, -1:], -1), np.int32)


@pytest.mark.parametrize("engine", ["sync", "continuous"])
def test_engines_match_jax(engine):
    """The sync and continuous engines on a reduced MiniCPM3-4B: greedy
    tokens equal to the JAX engines' (the continuous engine inserts each
    request's latent cache into its slot)."""
    cfg, jcfg, params, model = _model_setup()
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (9, 6, 9, 4, 8)]
    if engine == "sync":
        kw = dict(batch_size=3, max_prompt_len=9, max_new_tokens=4)
        teng = ServingEngine(cfg, model, device="cpu", **kw)
        jeng = JSync(jcfg, params, **kw)
    else:
        kw = dict(n_slots=2, max_prompt_len=9, max_new_tokens=4)
        teng = ContinuousBatchingEngine(cfg, model, device="cpu", **kw)
        jeng = JCont(jcfg, params, **kw)
    rt = teng.generate(prompts, GenerationConfig(max_new_tokens=4))
    rj = jeng.generate(prompts, JGen(max_new_tokens=4))
    assert [r.tokens for r in rt] == [r.tokens for r in rj]
    if engine == "continuous":
        assert teng.decode_steps == jeng.decode_steps


def test_chunked_prefill_and_paged_kv_refuse_mla():
    """The JAX package's paged engine takes GQA only. The port's paged
    engine, paged cache and chunked prefill take MLA over a paged latent
    pool ({"c", "kr"} pages; ``tests/test_torch_deepseek_v2.py`` holds
    them to a reference) and refuse a chunk over a contiguous latent
    cache."""
    cfg, jcfg, params, model = _model_setup()
    with pytest.raises(NotImplementedError):
        JPaged(jcfg, params)
    eng = PagedEngine(cfg, model, device="cpu", max_prompt_len=16,
                      max_new_tokens=4, n_slots=2)
    assert set(eng._cache["layers"][0]) == {"c", "kr"}
    pool = TT.init_paged_cache(cfg, 4, 16, 2, device="cpu")
    assert tuple(pool["layers"][0]["c"].shape) == (5, 16, cfg.kv_lora_rank)
    assert tuple(pool["layers"][0]["kr"].shape) == (5, 16,
                                                    cfg.qk_rope_head_dim)
    cache = TT.init_cache(cfg, 1, 16, device="cpu", per_slot_pos=True)
    with pytest.raises(NotImplementedError, match="paged"):
        TT.chunk_step(model, torch.zeros((1, 4), dtype=torch.long), 0, 0, 4,
                      cache, cfg, layout=TA.ContiguousLayout(sink=True))
