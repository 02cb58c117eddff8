"""The port's continuous-batching and paged engines against the JAX
package's, on the JAX package's own weights loaded through the weight
bridge (``repro_torch.checkpoint.from_numpy``): a reduced Qwen3-30B-A3B
under a calibrated 2T policy whose threshold values both sides share, and
a reduced dense Qwen2-7B. Both engines serve with ``exact_moe`` and a
float32 KV cache, over ragged prompts that force mid-decode admission, one
request that retires on EOS and, for the paged engine, prompts that share
a prefix.

Compared: greedy tokens (equal), the schedulers' counts (equal), the obs
sub-pair counters and overflow (equal), and the first-token logits of a
chunked prefill (rel_err <= 1e-5: the same float32 arithmetic, summed in
another order per matrix product, through every layer).
"""
import dataclasses
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
from repro.models import attention as JA
from repro.models import model as JM
from repro.models import transformer as JT
from repro.serving import ContinuousBatchingEngine as JCont
from repro.serving import GenerationConfig as JGen
from repro.serving import PagedEngine as JPaged
from repro.serving.paged import PageAllocator as JAlloc
from repro_torch.checkpoint.from_numpy import params_from_numpy
from repro_torch.configs.base import ModelConfig
from repro_torch.core.policy import TwoTDrop
from repro_torch.models import attention as TA
from repro_torch.models import transformer as TT
from repro_torch.serving import (ContinuousBatchingEngine, GenerationConfig,
                                 PageAllocator, PagedEngine)
from repro_torch.serving.engine import exact_moe_policy
from _config_compat import PORT_ONLY_FIELDS

ARCHS = ["qwen3-moe-30b-a3b", "qwen2-7b"]
REL_TOL = 1e-5


@functools.lru_cache(maxsize=None)
def _setup(arch):
    """JAX weights (prepared by a calibrated JAX 2T policy for the MoE
    arch), the same weights in the port, and the two policies (None for
    the dense arch)."""
    jcfg = jax_config(arch).reduced()
    cfg = ModelConfig(**{f.name: getattr(jcfg, f.name)
                         for f in dataclasses.fields(ModelConfig)
                         if f.name not in PORT_ONLY_FIELDS})
    params = JM.init_params(jax.random.PRNGKey(0), jcfg)
    dist, tpol = None, None
    if jcfg.is_moe:
        calib = jax_calib(jax.random.PRNGKey(7), 256, jcfg.d_model)
        jpol = jax_make_policy("2t", jcfg.dualsparse, drop_target=0.25)
        params, jpol = jpol.prepare(params, jcfg, calib)
        dist = JT.DistContext(mesh=make_host_mesh(1), moe_impl="dispatch",
                              policy=jpol)
        tpol = TwoTDrop(partition_p=jpol.partition_p,
                        importance=jpol.importance,
                        t_major=float(jpol.t_major),
                        t_minor=float(jpol.t_minor))
    model = params_from_numpy(jax.tree.map(np.asarray, params), cfg,
                              device="cpu")
    return cfg, jcfg, params, dist, model, tpol


def _prompts(cfg, lens, seed, shared=0):
    """Random prompts of the given lengths; with ``shared``, every prompt
    starts with the same ``shared`` tokens."""
    rng = np.random.default_rng(seed)
    head = rng.integers(0, cfg.vocab_size, shared)
    return [np.concatenate([head, rng.integers(0, cfg.vocab_size,
                                               n - shared)]).astype(np.int32)
            for n in lens]


def _gens(new, eos=None):
    """One GenerationConfig per request; request 1 stops at ``eos``."""
    return [(new, -1 if i != 1 or eos is None else eos) for i in range(5)]


def _submit_all(eng, prompts, gens, gen_cls, override=None):
    """Submit every prompt; request 3 carries the per-request threshold
    ``override`` when one is given."""
    return [eng.submit(p, gen_cls(max_new_tokens=n, eos_token=e,
                                  policy=override if i == 3 else None))
            for i, (p, (n, e)) in enumerate(zip(prompts, gens))]


def _overrides(dist):
    """The same per-request 2T override (halved thresholds) for the port
    and the JAX engines, or (None, None) without a policy."""
    if dist is None:
        return None, None
    t_major = float(dist.policy.t_major) / 2
    t_minor = float(dist.policy.t_minor) / 2
    return (TwoTDrop(t_major=t_major, t_minor=t_minor),
            dataclasses.replace(dist.policy, t_major=t_major,
                                t_minor=t_minor))


def _eos_for(prompts, make_engine, new):
    """A token request 1 emits third, from a first run of the port's
    engine, so that the compared runs retire it on EOS."""
    eng = make_engine()
    uids = _submit_all(eng, prompts, _gens(new), GenerationConfig)
    eng.drain()
    return eng.result(uids[1]).tokens[2]


def _moe_counters(eng):
    c = eng.metrics().counters
    return {k: v for k, v in c.items() if k.startswith("repro_moe_")}


def _assert_same_serving(teng, tuids, jeng, juids):
    tt = [teng.result(u).tokens for u in tuids]
    assert tt == [jeng.result(u).tokens for u in juids]
    assert teng.decode_steps == jeng.decode_steps
    assert teng.n_admitted == jeng.n_admitted == len(tuids)
    assert teng.n_retired == jeng.n_retired == len(tuids)
    assert teng.max_concurrency == jeng.max_concurrency
    assert teng.overflow_pairs == jeng.overflow_pairs
    assert _moe_counters(teng) == _moe_counters(jeng)
    return tt


@pytest.mark.parametrize("arch", ARCHS)
def test_continuous_engine_matches_jax(arch):
    cfg, jcfg, params, dist, model, tpol = _setup(arch)
    prompts = _prompts(cfg, [12, 5, 9, 3, 7], seed=1)
    kw = dict(n_slots=3, max_prompt_len=12, max_new_tokens=6)

    def port():
        return ContinuousBatchingEngine(cfg, model, policy=tpol,
                                        cache_dtype=torch.float32,
                                        device="cpu", **kw)
    gens = _gens(6, eos=_eos_for(prompts, port, 6))
    tover, jover = _overrides(dist)
    teng = port()
    tuids = _submit_all(teng, prompts, gens, GenerationConfig, tover)
    teng.drain()
    jeng = JCont(jcfg, params, dist=dist, cache_dtype=jnp.float32, **kw)
    juids = _submit_all(jeng, prompts, gens, JGen, jover)
    jeng.drain()
    tt = _assert_same_serving(teng, tuids, jeng, juids)
    assert len(tt[1]) <= 3 and tt[1][-1] == gens[1][1]       # EOS retired
    assert teng.max_concurrency == 3 < len(prompts)           # admitted late
    if cfg.is_moe:
        assert _moe_counters(teng)
    assert teng.timing["compile_steps"] == 1


@pytest.mark.parametrize("arch", ARCHS)
def test_paged_engine_matches_jax(arch):
    cfg, jcfg, params, dist, model, tpol = _setup(arch)
    prompts = _prompts(cfg, [13, 9, 11, 10, 12], seed=2, shared=8)
    kw = dict(n_slots=2, page_size=4, chunk_size=5, max_prompt_len=13,
              max_new_tokens=5)

    def port():
        return PagedEngine(cfg, model, policy=tpol, cache_dtype=torch.float32,
                           device="cpu", **kw)
    gens = _gens(5, eos=_eos_for(prompts, port, 5))
    tover, jover = _overrides(dist)
    teng = port()
    tuids = _submit_all(teng, prompts, gens, GenerationConfig, tover)
    teng.drain()
    jeng = JPaged(jcfg, params, dist=dist, cache_dtype=jnp.float32, **kw)
    juids = _submit_all(jeng, prompts, gens, JGen, jover)
    jeng.drain()
    tt = _assert_same_serving(teng, tuids, jeng, juids)
    assert len(tt[1]) <= 3 and tt[1][-1] == gens[1][1]
    assert teng.prefix_hits == jeng.prefix_hits > 0
    assert teng.prefix_misses == jeng.prefix_misses
    assert teng.chunk_steps == jeng.chunk_steps
    assert teng.prefill_tokens == jeng.prefill_tokens
    assert teng._alloc.evictions == jeng._alloc.evictions


@pytest.mark.parametrize("layout", ["paged", "contiguous"])
@pytest.mark.parametrize("arch", ARCHS)
def test_chunked_prefill_first_token_logits_match_jax(arch, layout):
    """One slot's prompt in chunks through ``chunk_step`` (the paged
    engine's prefill) on either cache layout: logits, the slot's position,
    the cache rows and the obs stats against the JAX package's."""
    cfg, jcfg, params, dist, model, tpol = _setup(arch)
    plen, chunk, ps, slot, cap = 11, 4, 4, 1, 16
    prompt = _prompts(cfg, [plen], seed=3)[0]
    spec = None
    if cfg.is_moe:
        spec = (cfg.n_layers, int(params["blocks"]["moe"]["w1"].shape[1]))
    if layout == "paged":
        pt = np.zeros((2, cap // ps), np.int32)
        pt[slot] = [3, 1, 4, 2]
        jlay, tlay = JA.PagedLayout(ps), TA.PagedLayout(ps)
        jpt, tpt = jnp.asarray(pt), torch.from_numpy(pt)
        jcache = JT.init_paged_cache(jcfg, 5, ps, 2, dtype=jnp.float32,
                                     metrics_spec=spec)
        tcache = TT.init_paged_cache(cfg, 5, ps, 2, dtype=torch.float32,
                                     metrics_spec=spec, device="cpu")
    else:
        jlay, tlay = JA.ContiguousLayout(), TA.ContiguousLayout(sink=True)
        jpt = tpt = None
        jcache = JT.init_cache(jcfg, 2, cap, dtype=jnp.float32,
                               per_slot_pos=True, metrics_spec=spec)
        tcache = TT.init_cache(cfg, 2, cap, dtype=torch.float32,
                               per_slot_pos=True, metrics_spec=spec,
                               device="cpu")
    jdist = None if dist is None else dataclasses.replace(
        dist, policy=dataclasses.replace(dist.policy, exact_capacity=True))
    tpolicy = exact_moe_policy(tpol) if cfg.is_moe else None
    for start in range(0, plen, chunk):
        valid = min(chunk, plen - start)
        toks = np.zeros((1, chunk), np.int32)
        toks[0, :valid] = prompt[start:start + valid]
        lj, jcache = JT.chunk_step(params, jnp.asarray(toks), slot, start,
                                   valid, jcache, jcfg, layout=jlay,
                                   page_table=jpt, read_len=plen, dist=jdist)
        with torch.no_grad():
            lt, tcache = TT.chunk_step(
                model, torch.from_numpy(toks).long(), slot, start, valid,
                tcache, cfg, layout=tlay, page_table=tpt, read_len=plen,
                policy=tpolicy)
        a, b = lt[0, :valid].numpy(), np.asarray(lj[0, :valid])
        assert np.linalg.norm(a - b) <= REL_TOL * np.linalg.norm(b)
    assert tcache["pos"].tolist() == np.asarray(jcache["pos"]).tolist()
    assert int(np.argmax(a[-1])) == int(np.argmax(b[-1]))
    for i, layer in enumerate(tcache["layers"]):
        want = np.asarray(jcache["layers"]["k"][i])
        # the sink page of a pool, the sink row of a slot, left off
        got = layer["k"][:want.shape[0], :want.shape[1]].numpy()
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=REL_TOL * np.abs(want).max())
    if cfg.is_moe:
        mj, mt = jcache["metrics"].snapshot(), tcache["metrics"].snapshot()
        for k in mj:
            np.testing.assert_array_equal(mt[k], mj[k], err_msg=k)


@pytest.mark.parametrize("engine", ["continuous", "paged"])
def test_timed_arrivals_match_offline_tokens(engine):
    """``generate_timed`` admits requests as they arrive, while others
    decode; under ``exact_moe`` each request's greedy tokens are those of
    an offline run of the same requests."""
    cfg, _, _, _, model, tpol = _setup("qwen3-moe-30b-a3b")
    prompts = _prompts(cfg, [12, 5, 9, 3, 7], seed=4)
    kw = dict(n_slots=2, max_prompt_len=12, max_new_tokens=4, policy=tpol,
              cache_dtype=torch.float32, device="cpu")
    cls = ContinuousBatchingEngine
    if engine == "paged":
        cls = PagedEngine
        kw.update(page_size=4, chunk_size=4)
    gen = GenerationConfig(max_new_tokens=4)
    offline = cls(cfg, model, **kw).generate(prompts, gen)
    timed = cls(cfg, model, **kw).generate_timed(
        [(0.02 * i, p, gen) for i, p in enumerate(prompts)])
    assert [r.tokens for r in timed] == [r.tokens for r in offline]
    assert all(r.finished_s >= r.submitted_s == 0.02 * i
               for i, r in enumerate(timed))


def test_page_allocator_matches_jax():
    """One fixed sequence of allocator operations gives the same page ids,
    hit/miss/eviction counts and page-state census on both sides."""
    ta, ja = PageAllocator(6), JAlloc(6)
    log = []

    def both(op, *args):
        out = (getattr(ta, op)(*args), getattr(ja, op)(*args))
        assert out[0] == out[1], (op, args, out)
        log.append(out[0])
        census = [(a.n_free, a.n_held, a.n_parked, a.available(), a.hits,
                   a.misses, a.evictions) for a in (ta, ja)]
        assert census[0] == census[1], (op, args, census)

    pages = [ta.alloc() for _ in range(3)]
    assert pages == [ja.alloc() for _ in range(3)]
    both("register", b"k1", pages[0])
    both("register", b"k2", pages[1])
    both("register", b"k1", pages[2])          # first writer wins
    both("lookup", b"k1")
    both("lookup", b"nope")
    both("release", pages[0])                  # parks (registered)
    both("release", pages[2])                  # frees (unregistered)
    both("acquire_cached", b"k1")
    both("release", pages[1])
    both("release", pages[0])
    for _ in range(5):                         # drains the free stack,
        both("alloc")                          # then evicts LRU-oldest
    both("lookup", b"k1")
    both("lookup", b"k2")
    assert ta.evictions == ja.evictions == 2
    assert log
