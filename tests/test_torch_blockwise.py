"""Blockwise (online-softmax) attention of the port against the JAX
package's ``blockwise_attention`` and against the port's own
``plain_attention``, and a reduced Qwen3-30B-A3B prefill past 1024 tokens
(where both packages switch to it) against the JAX prefill.

Tolerances: attention outputs within 1e-5 of their largest magnitude —
float32 throughout, the same products summed in another order (per block
against the plain (S, S) softmax); prefill logits within 1e-4 of their
largest magnitude at a float32 KV cache (the port's float32 bar,
``test_torch_model.py``), the cache rows within 1e-5.
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
from repro.models import attention as JA
from repro.models import model as JM
from repro.models import transformer as JT
from repro_torch.checkpoint.from_numpy import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.core.policy import TwoTDrop
from repro_torch.models import attention as TA
from repro_torch.models import transformer as TT

REL_TOL = 1e-5


def _qkv(seed, Sq, Skv, B=1, H=2, G=2, D=16):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Sq, H, G, D)).astype(np.float32)
    k = rng.standard_normal((B, Skv, H, D)).astype(np.float32)
    v = rng.standard_normal((B, Skv, H, D)).astype(np.float32)
    return q, k, v


def _close(a, b, rel=REL_TOL):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    assert a.shape == b.shape
    np.testing.assert_allclose(a, b, rtol=0,
                               atol=rel * float(np.abs(b).max()))


# (name, Sq, Skv, kwargs): causal prefill; sliding window; a continuation
# whose queries start at q_offset; masked KV padding past kv_valid_len
CASES = [
    ("causal", None, None, {}),
    ("window", None, None, {"window": 300}),
    ("q_offset", 512, None, {"q_offset": "end"}),
    ("kv_valid_len", None, None, {"kv_valid_len": "S-100"}),
    ("non_causal", None, None, {"causal": False}),
]


def _case_args(S, Sq, Skv, kw):
    Sq, Skv = Sq or S, Skv or S
    kw = dict(kw)
    if kw.get("q_offset") == "end":
        kw["q_offset"] = Skv - Sq
    if kw.get("kv_valid_len") == "S-100":
        kw["kv_valid_len"] = Skv - 100
    return Sq, Skv, kw


@pytest.mark.parametrize("S", [1025, 2048])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_blockwise_matches_jax_and_plain(S, case):
    name, Sq, Skv, kw = case
    Sq, Skv, kw = _case_args(S, Sq, Skv, kw)
    q, k, v = _qkv(S + len(name), Sq, Skv, B=2 if S == 1025 else 1)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = TA.blockwise_attention(tq, tk, tv, **kw)
    want = JA.blockwise_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), **kw)
    assert got.dtype == torch.float32
    _close(got, want)
    _close(got, TA.plain_attention(tq, tk, tv, **kw))


@pytest.mark.parametrize("blocks", [(128, 256), (200, 300), (512, 1024)])
def test_blockwise_block_sizes_match_jax(blocks):
    """Other block sizes (padding on both axes, several KV blocks) under a
    window and a q_offset at once, G = 4."""
    qb, kb = blocks
    q, k, v = _qkv(7, 700, 1100, H=1, G=4)
    kw = dict(window=450, q_offset=400, q_block=qb, kv_block=kb)
    got = TA.blockwise_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                 **kw)
    want = JA.blockwise_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), **kw)
    _close(got, want)


def test_gqa_attention_selects_blockwise_past_1024():
    """The full-sequence entry points take the blockwise path past 1024
    tokens (they raised there before) and the plain one up to it."""
    cfg = get_config("qwen3-moe-30b-a3b").reduced()
    gen = torch.Generator().manual_seed(0)
    att = TA.Attention(cfg, device=torch.device("cpu"), generator=gen)
    calls = []
    orig = TA.blockwise_attention

    def spy(*a, **kw):
        calls.append(a[0].shape[1])
        return orig(*a, **kw)
    TA.blockwise_attention = spy
    try:
        for S in (1024, 1025):
            x = torch.randn((1, S, cfg.d_model), generator=gen)
            pos = torch.arange(S)[None]
            y = TA.gqa_attention(att, x, pos, cfg)
            y2, cache = TA.gqa_prefill_attention(att, x, pos, cfg, cap=S + 4,
                                                 cache_dtype=torch.float32)
            _close(y2, y)
            assert cache["k"].shape[1] == S + 4
    finally:
        TA.blockwise_attention = orig
    assert calls == [1025, 1025]


@functools.lru_cache(maxsize=None)
def _setup():
    """Reduced Qwen3-30B-A3B: JAX weights prepared by a calibrated JAX 2T
    policy, the same tree in the port, and the two policies."""
    arch = "qwen3-moe-30b-a3b"
    cfg, jcfg = get_config(arch).reduced(), jax_config(arch).reduced()
    params = JM.init_params(jax.random.PRNGKey(0), jcfg)
    calib = jax_calib(jax.random.PRNGKey(7), 256, jcfg.d_model)
    jpol = jax_make_policy("2t", jcfg.dualsparse, drop_target=0.25)
    params, jpol = jpol.prepare(params, jcfg, calib)
    model = params_from_numpy(jax.tree.map(np.asarray, params), cfg,
                              device="cpu")
    tpol = TwoTDrop(partition_p=jpol.partition_p, importance=jpol.importance,
                    t_major=float(jpol.t_major), t_minor=float(jpol.t_minor))
    dist = JT.DistContext(mesh=make_host_mesh(1), moe_impl="dispatch",
                          policy=jpol)
    return cfg, jcfg, params, jpol, dist, model, tpol


def test_qwen3_prefill_past_1024_matches_jax():
    """A 1100-token prefill and two decode steps of reduced Qwen3-30B-A3B
    under 2T: logits, the cache and the MoE counters against JAX."""
    cfg, jcfg, params, jpol, dist, model, tpol = _setup()
    S, steps = 1100, 2
    toks = np.random.default_rng(3).integers(
        0, cfg.vocab_size, (1, S)).astype(np.int32)
    lj, cj = JT.prefill(params, {"tokens": jnp.asarray(toks)}, jcfg,
                        cache_len=S + steps, dist=dist,
                        cache_dtype=jnp.float32)
    with torch.no_grad():
        lt, ct = TT.prefill(model, {"tokens": torch.from_numpy(toks).long()},
                            cfg, cache_len=S + steps, policy=tpol,
                            cache_dtype=torch.float32)
    _close(lt, lj, 1e-4)
    for i, layer in enumerate(ct["layers"]):
        for kv in ("k", "v"):
            _close(layer[kv], np.asarray(cj["layers"][kv][i]))
    nxt = np.array(jnp.argmax(lj[:, -1:], -1), np.int32)
    for _ in range(steps):
        lj, cj = JT.decode_step(params, jnp.asarray(nxt), cj, jcfg,
                                dist=dist)
        with torch.no_grad():
            lt, ct = TT.decode_step(model, torch.from_numpy(nxt).long(), ct,
                                    cfg, policy=tpol)
        _close(lt, lj, 1e-4)
        nxt = np.array(jnp.argmax(lj[:, -1:], -1), np.int32)
    mj, mt = cj["metrics"].snapshot(), ct["metrics"].snapshot()
    for k in mj:
        np.testing.assert_array_equal(mt[k], mj[k], err_msg=k)
