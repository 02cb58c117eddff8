"""Mamba2 and the Zamba2 hybrid in the port against the JAX package, on the
CPU: the chunked SSD (plain and through ``ops.ssd_chunk``), the Mamba2
layer's prefill and decode, and the ``ssm`` / ``hybrid`` models' prefill and
decode logits and ``ServingEngine`` greedy tokens, on the JAX package's own
weights loaded through the weight bridge.

Tolerances:
  * SSD and the Mamba2 layer: norm-relative 1e-5 against the JAX function
    of the same name, and against the sequential oracle at the JAX tests'
    own bars (atol 1e-4, 5e-4 for chunks above 64 steps). The port
    accumulates cumsums in float64 and runs the inter-chunk recurrence as
    a loop where JAX uses float32 and a log-depth scan: the same products,
    rounded at other points;
  * logits: those of ``tests/test_torch_model.py`` (1e-4 of the largest
    magnitude at a float32 KV cache, 1e-3 at bfloat16); greedy tokens
    equal;
  * bfloat16 KV entries: also within one bfloat16 ulp (2^-8 relative) of
    the entry: the hybrid's second shared-block occurrence projects K/V
    from Mamba outputs that differ by ~1e-6 between the frameworks, which
    flips the rounding of a few entries (2 of 22016 here).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import mamba2 as JMM
from repro.models import model as JM
from repro.models import transformer as JT
from repro.models.layers import split_params
from repro.serving import GenerationConfig as JGen
from repro.serving import ServingEngine as JEngine
from repro_torch.checkpoint.from_numpy import _load, params_from_numpy
from repro_torch.configs import get_config
from repro_torch.models import mamba2 as TMM
from repro_torch.models import model as M
from repro_torch.models import transformer as TT
from repro_torch.serving import (ContinuousBatchingEngine, GenerationConfig,
                                 PagedEngine, ServingEngine)

REL = 1e-5
ARCHS = ["mamba2-370m", "zamba2-7b"]


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _ssd_inputs(seed, b=2, S=130, H=4, P=16, G=1, N=8):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    x = rng.standard_normal((b, S, H, P)).astype(f32)
    dt = np.log1p(np.exp(rng.standard_normal((b, S, H)))).astype(f32)
    A = (-np.exp(rng.standard_normal((H,)) * 0.5)).astype(f32)
    B = rng.standard_normal((b, S, G, N)).astype(f32)
    C = rng.standard_normal((b, S, G, N)).astype(f32)
    return x, dt, A, B, C


def _t(args):
    return [torch.from_numpy(a) for a in args]


def _j(args):
    return [jnp.asarray(a) for a in args]


# chunk < S with padding (130 = 4 x 32 + 2), chunk = S, chunk > S (one
# padded chunk); one and two groups of heads
SSD_CASES = [(32, 1), (32, 2), (130, 1), (256, 2)]


@pytest.mark.parametrize("chunk,G", SSD_CASES)
def test_ssd_chunked_matches_jax(chunk, G):
    args = _ssd_inputs(0, G=G)
    y_t, h_t = TMM.ssd_chunked(*_t(args), chunk=chunk)
    y_j, h_j = JMM.ssd_chunked(*_j(args), chunk=chunk)
    assert _rel(y_t, y_j) <= REL and _rel(h_t, h_j) <= REL


@pytest.mark.parametrize("chunk,G", SSD_CASES)
def test_ssd_chunked_kernel_matches_jax(chunk, G):
    """The kernel route (``ops.ssd_chunk``'s plain version here) against
    JAX's kernel route (``ssd_chunk_pallas`` in interpret mode)."""
    args = _ssd_inputs(1, G=G)
    y_t, h_t = TMM.ssd_chunked_kernel(*_t(args), chunk=chunk)
    y_j, h_j = JMM.ssd_chunked_kernel(*_j(args), chunk=chunk)
    assert _rel(y_t, y_j) <= REL and _rel(h_t, h_j) <= REL


@pytest.mark.parametrize("chunk,G", SSD_CASES)
def test_ssd_chunked_paths_match_sequential_oracle(chunk, G):
    args = _t(_ssd_inputs(2, G=G))
    y_r, h_r = TMM.ssd_reference(*args)
    y_jr, h_jr = JMM.ssd_reference(*_j(_ssd_inputs(2, G=G)))
    assert _rel(y_r, y_jr) <= REL and _rel(h_r, h_jr) <= REL
    atol = 1e-4 if chunk <= 64 else 5e-4
    for fn in (TMM.ssd_chunked, TMM.ssd_chunked_kernel):
        y, h = fn(*args, chunk=chunk)
        np.testing.assert_allclose(y.numpy(), y_r.numpy(), atol=atol)
        np.testing.assert_allclose(h.numpy(), h_r.numpy(), atol=atol)


@pytest.mark.parametrize("G", [1, 2])
def test_ssd_chunked_kernel_passes_groups_to_the_kernel(monkeypatch, G):
    """B and C reach ``ops.ssd_chunk`` once per (batch, group), (b*G, nc,
    Q, N), not repeated over the H/G heads of a group."""
    seen = []
    real = TMM.ops.ssd_chunk

    def spy(x, dt, a, bm, cm):
        seen.append((tuple(x.shape), tuple(bm.shape), tuple(cm.shape)))
        return real(x, dt, a, bm, cm)
    monkeypatch.setattr(TMM.ops, "ssd_chunk", spy)
    b, S, H, N = 2, 130, 4, 8
    TMM.ssd_chunked_kernel(*_t(_ssd_inputs(3, b=b, S=S, H=H, G=G, N=N)),
                           chunk=32)
    assert seen == [((b * H, 5, 32, 16), (b * G, 5, 32, N),
                     (b * G, 5, 32, N))]


@functools.lru_cache(maxsize=None)
def _layer():
    """JAX Mamba2 layer weights of mamba2-370m --reduced, and the same
    weights in the port's ``Mamba2`` module."""
    cfg = get_config("mamba2-370m").reduced()
    jcfg = jax_config("mamba2-370m").reduced()
    params, _ = split_params(JMM.make_mamba2_params(jax.random.PRNGKey(3),
                                                    jcfg))
    m = TMM.Mamba2(cfg, device=torch.device("cpu"), generator=None)
    _load(m, jax.tree.map(np.asarray, params), None, "cpu")
    return cfg, jcfg, params, m


def _x(cfg, S, seed=4):
    return (np.random.default_rng(seed).standard_normal(
        (2, S, cfg.d_model)) * 0.1).astype(np.float32)


@pytest.mark.parametrize("chunk", [8, 256])
def test_mamba2_forward_matches_jax(chunk):
    cfg, jcfg, params, m = _layer()
    x = _x(cfg, 20)
    with torch.no_grad():
        y_t, st_t = TMM.mamba2_forward(m, torch.from_numpy(x), cfg,
                                       chunk=chunk, return_state=True)
    y_j, st_j = JMM.mamba2_forward(params, jnp.asarray(x), jcfg, chunk=chunk,
                                   return_state=True)
    assert _rel(y_t, y_j) <= REL
    for k in ("conv", "ssm"):
        assert st_t[k].dtype == torch.float32
        assert _rel(st_t[k], st_j[k]) <= REL, k


def test_mamba2_prefill_decode_handoff_matches_jax():
    """forward(return_state) over S tokens, then decode of the next 3, on
    both sides; the port's decode also equals its own full forward."""
    cfg, jcfg, params, m = _layer()
    S = 17
    x = _x(cfg, S + 3, seed=5)
    with torch.no_grad():
        y_all = TMM.mamba2_forward(m, torch.from_numpy(x), cfg, chunk=8)
        _, st = TMM.mamba2_forward(m, torch.from_numpy(x[:, :S]), cfg,
                                   chunk=8, return_state=True)
    _, jst = JMM.mamba2_forward(params, jnp.asarray(x[:, :S]), jcfg, chunk=8,
                                return_state=True)
    st = TMM.MambaState(st["conv"], st["ssm"])
    jst = JMM.MambaState(jst["conv"], jst["ssm"])
    for t in range(S, S + 3):
        with torch.no_grad():
            y, st = TMM.mamba2_decode(m, torch.from_numpy(x[:, t:t + 1]), st,
                                      cfg)
        yj, jst = JMM.mamba2_decode(params, jnp.asarray(x[:, t:t + 1]), jst,
                                    jcfg)
        assert _rel(y, yj) <= REL
        assert _rel(st.ssm, jst.ssm) <= REL
        np.testing.assert_allclose(y.numpy(), y_all[:, t:t + 1].numpy(),
                                   atol=1e-4)


def test_mamba2_init_draws_jax_distributions():
    cfg = get_config("mamba2-370m").reduced()
    m = M.init_params(cfg, seed=0, device="cpu").blocks[0].mamba
    dt = torch.nn.functional.softplus(m.dt_bias)
    assert ((dt >= 1e-3 * 0.999) & (dt <= 0.1 * 1.001)).all()
    A = torch.exp(m.A_log)
    assert ((A >= 1.0) & (A <= 16.0)).all()
    assert (m.conv_b == 0).all() and (m.D == 1).all() and (m.norm == 1).all()
    assert 0.05 < float(m.conv_w.std()) < 0.15
    assert 0.01 < float(m.in_proj.std()) < 0.03


def _cfgs(arch):
    cfg, jcfg = get_config(arch).reduced(), jax_config(arch).reduced()
    if arch == "zamba2-7b":      # 4 layers, attn_every 2: two occurrences
        cfg = dataclasses.replace(cfg, n_layers=4)
        jcfg = dataclasses.replace(jcfg, n_layers=4)
    return cfg, jcfg


@functools.lru_cache(maxsize=None)
def _model(arch):
    cfg, jcfg = _cfgs(arch)
    params = JM.init_params(jax.random.PRNGKey(0), jcfg)
    model = params_from_numpy(jax.tree.map(np.asarray, params), cfg,
                              device="cpu")
    return cfg, jcfg, params, model


def _close(a, b, rel):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    assert a.shape == b.shape
    np.testing.assert_allclose(a, b, rtol=0,
                               atol=rel * float(np.abs(b).max()))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("cache", ["float32", "bfloat16"])
def test_prefill_and_decode_logits_match_jax(arch, cache):
    cfg, jcfg, params, model = _model(arch)
    rel = 1e-4 if cache == "float32" else 1e-3
    jdt = jnp.float32 if cache == "float32" else jnp.bfloat16
    tdt = torch.float32 if cache == "float32" else torch.bfloat16
    B, S, steps = 2, 40, 3
    toks = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)
    lj, cj = JT.prefill(params, {"tokens": jnp.asarray(toks)}, jcfg,
                        cache_len=S + steps, cache_dtype=jdt)
    with torch.no_grad():
        lt, ct = TT.prefill(model, {"tokens": torch.from_numpy(toks).long()},
                            cfg, cache_len=S + steps, cache_dtype=tdt)
    _close(lt, lj, rel)
    assert sorted(ct) == sorted(cj) and "metrics" not in ct
    mamba_t = ct["mamba"] if arch == "zamba2-7b" else ct["layers"]
    mamba_j = cj["mamba"] if arch == "zamba2-7b" else cj["layers"]
    assert len(mamba_t) == cfg.n_layers
    for i, st in enumerate(mamba_t):
        for k in ("conv", "ssm"):
            assert st[k].dtype == torch.float32
            _close(st[k], mamba_j[k][i], rel)
    if arch == "zamba2-7b":
        assert len(ct["attn"]) == 2
        ulp = 2.0 ** -8 if cache == "bfloat16" else 0.0
        for occ, ac in enumerate(ct["attn"]):
            for kv in ("k", "v"):
                want = np.asarray(cj["attn"][kv][occ], np.float32)
                np.testing.assert_allclose(
                    ac[kv].float().numpy(), want, rtol=ulp,
                    atol=rel * float(np.abs(want).max()))
    nxt = np.array(jnp.argmax(lj[:, -1:], -1), np.int32)
    for _ in range(steps):
        lj, cj = JT.decode_step(params, jnp.asarray(nxt), cj, jcfg)
        with torch.no_grad():
            lt, ct = TT.decode_step(model, torch.from_numpy(nxt).long(), ct,
                                    cfg)
        _close(lt, lj, rel)
        nxt = np.array(jnp.argmax(lj[:, -1:], -1), np.int32)
    assert ct["pos"] == int(cj["pos"]) == S + steps
    assert int(ct["moe_overflow"]) == int(cj["moe_overflow"]) == 0


@pytest.mark.parametrize("arch", ARCHS)
def test_serving_engine_tokens_match_jax(arch):
    """Greedy tokens of the port's engine equal the JAX engine's on the
    same weights and prompts (unequal lengths: the recurrence runs over
    the left pads on both sides)."""
    cfg, jcfg, params, model = _model(arch)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (10, 7, 10, 4, 9)]
    kw = dict(batch_size=3, max_prompt_len=10, max_new_tokens=6)
    jeng = JEngine(jcfg, params, cache_dtype=jnp.float32, **kw)
    teng = ServingEngine(cfg, model, cache_dtype=torch.float32,
                         device="cpu", **kw)
    rj = jeng.generate(prompts, JGen(max_new_tokens=6))
    rt = teng.generate(prompts, GenerationConfig(max_new_tokens=6))
    assert [r.tokens for r in rt] == [r.tokens for r in rj]
    assert all(len(r.tokens) == 6 for r in rt)
    assert teng.overflow_pairs == jeng.overflow_pairs == 0
    counters = teng.metrics().counters
    assert not [k for k in counters if k.startswith("repro_moe_")]


@pytest.mark.parametrize("arch", ARCHS)
def test_slot_engines_refuse_recurrent_families(arch):
    cfg, _ = _cfgs(arch)
    model = M.init_params(cfg, seed=0, device="cpu")
    with pytest.raises(NotImplementedError):
        ContinuousBatchingEngine(cfg, model, device="cpu")
    with pytest.raises(NotImplementedError):
        PagedEngine(cfg, model, device="cpu")
    with pytest.raises(NotImplementedError):
        M.init_paged_cache(cfg, 4, 4, 2, device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_recurrent_archs_on_cpu(capsys, arch):
    from repro_torch.launch import serve
    results = serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                          "--requests", "3", "--prompt-len", "8",
                          "--new-tokens", "4", "--batch-size", "2",
                          "--policy", "2t"])
    out = capsys.readouterr().out
    assert len(results) == 3 and all(len(r.tokens) == 4 for r in results)
    assert "served 3 requests" in out and "sparsity policy" not in out
