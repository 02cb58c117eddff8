"""The dense GQA decoders (Qwen2-7B, StarCoder2-3B, Granite-20B) and the
Qwen2-VL-7B decoder with its vision stub and M-RoPE, reduced, against the
JAX package on the JAX package's own weights (loaded through
``repro_torch.checkpoint.from_numpy``), with their building blocks.

Tolerances:
  * logits within 1e-4 of their largest magnitude at a float32 KV cache
    (the port's float32 bar, ``test_torch_model.py``);
  * ``gelu_mlp`` and ``apply_rope`` within 1e-6 of the largest magnitude:
    the same float32 formula (the tanh GELU; one angle per frequency from
    the stream its section selects);
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
from repro.models import layers as JL
from repro.models import model as JM
from repro.models import transformer as JT
from repro.serving import ContinuousBatchingEngine as JCont
from repro.serving import GenerationConfig as JGen
from repro.serving import ServingEngine as JSync
from repro_torch.checkpoint.from_numpy import params_from_numpy
from _config_compat import shared_fields
from repro_torch.configs import get_config
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.serving import (ContinuousBatchingEngine, GenerationConfig,
                                 PagedEngine, ServingEngine)

ARCHS = ["qwen2-7b", "starcoder2-3b", "granite-20b", "qwen2-vl-7b"]


def _close(a, b, rel=1e-4):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    assert a.shape == b.shape
    np.testing.assert_allclose(a, b, rtol=0,
                               atol=rel * float(np.abs(b).max()))


@functools.lru_cache(maxsize=None)
def _setup(arch):
    cfg, jcfg = get_config(arch).reduced(), jax_config(arch).reduced()
    params = JM.init_params(jax.random.PRNGKey(1), jcfg)
    model = params_from_numpy(jax.tree.map(np.asarray, params), cfg,
                              device="cpu")
    return cfg, jcfg, params, model


def _batch(cfg, B, S, seed):
    """Seeded numpy tokens and, for the vision stub, patch embeddings."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if cfg.frontend == "vision":
        out["frontend"] = (rng.standard_normal(
            (B, cfg.n_frontend_tokens, cfg.d_model)) * 0.1).astype(np.float32)
    return out


def test_configs_match_jax():
    for arch in ARCHS + ["dbrx-132b"]:
        got, want = get_config(arch), jax_config(arch)
        assert shared_fields(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_logits_match_jax(arch):
    cfg, jcfg, params, model = _setup(arch)
    B, S, steps = 2, 10, 3
    batch = _batch(cfg, B, S, seed=ARCHS.index(arch))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tb["tokens"] = tb["tokens"].long()
    n_pre = cfg.n_frontend_tokens if cfg.frontend else 0
    lj, cj = JT.prefill(params, jb, jcfg, cache_len=n_pre + S + steps,
                        cache_dtype=jnp.float32)
    with torch.no_grad():
        lt, ct = TT.prefill(model, tb, cfg, cache_len=n_pre + S + steps,
                            cache_dtype=torch.float32)
    assert tuple(lt.shape) == (B, S, cfg.vocab_size)
    _close(lt, lj)
    _close(lt, JT.forward(params, jb, jcfg))
    assert ct["pos"] == int(cj["pos"]) == n_pre + S
    for i, layer in enumerate(ct["layers"]):
        _close(layer["k"], np.asarray(cj["layers"]["k"][i]), 1e-5)
    nxt = np.array(jnp.argmax(lj[:, -1:], -1), np.int32)
    for _ in range(steps):
        lj, cj = JT.decode_step(params, jnp.asarray(nxt), cj, jcfg)
        with torch.no_grad():
            lt, ct = TT.decode_step(model, torch.from_numpy(nxt).long(), ct,
                                    cfg)
        _close(lt, lj)
        nxt = np.array(jnp.argmax(lj[:, -1:], -1), np.int32)


def test_vlm_prefill_past_1024_matches_jax():
    """The full vision stub length: 1024 patch embeddings + 40 text tokens
    take the blockwise path in both packages."""
    cfg, jcfg, params, model = _setup("qwen2-vl-7b")
    cfg = dataclasses.replace(cfg, n_frontend_tokens=1024)
    jcfg = dataclasses.replace(jcfg, n_frontend_tokens=1024)
    batch = _batch(cfg, 1, 40, seed=9)
    with torch.no_grad():
        lt, ct = TT.prefill(model, {"tokens": torch.from_numpy(
            batch["tokens"]).long(), "frontend": torch.from_numpy(
                batch["frontend"])}, cfg, cache_dtype=torch.float32)
    lj, cj = JT.prefill(params, {k: jnp.asarray(v) for k, v in batch.items()},
                        jcfg, cache_dtype=jnp.float32)
    _close(lt, lj)
    assert ct["pos"] == int(cj["pos"]) == 1064


def test_mrope_three_distinct_streams_match_jax():
    """M-RoPE with (t, h, w) streams that all differ: each frequency
    section rotates by its own stream's positions."""
    rng = np.random.default_rng(0)
    B, S, H, D = 2, 12, 3, 64
    sections = (16, 8, 8)
    x = rng.standard_normal((B, S, H, D)).astype(np.float32)
    pos = np.stack([np.arange(S) * (i + 1) + 5 * i
                    for i in range(3)])[:, None].repeat(B, 1)
    pos = pos.astype(np.int32)                               # (3, B, S)
    got = TL.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6,
                        sections)
    want = JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6, sections)
    _close(got, want, 1e-6)
    # each section follows its own stream: not the stream-0 rotation
    plain = TL.apply_rope(torch.from_numpy(x), torch.from_numpy(pos[0]), 1e6)
    half = D // 2
    assert torch.allclose(got[..., :16], plain[..., :16], atol=1e-6)
    assert not torch.allclose(got[..., 16:half], plain[..., 16:half],
                              atol=1e-3)
    with pytest.raises(ValueError):
        TL.apply_rope(torch.from_numpy(x), torch.from_numpy(pos[0]), 1e6,
                      sections)


def test_gelu_mlp_matches_jax_tanh_gelu():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((16, 64)).astype(np.float32) * 2
    w_in = (rng.standard_normal((64, 128)) * 0.3).astype(np.float32)
    w_out = (rng.standard_normal((128, 64)) * 0.3).astype(np.float32)
    got = TL.gelu_mlp(*(torch.from_numpy(a) for a in (x, w_in, w_out)))
    want = JL.gelu_mlp(jnp.asarray(x), jnp.asarray(w_in), jnp.asarray(w_out))
    _close(got, want, 1e-6)
    h = x @ w_in
    np.testing.assert_allclose(
        torch.nn.functional.gelu(torch.from_numpy(h),
                                 approximate="tanh").numpy(),
        np.asarray(jax.nn.gelu(jnp.asarray(h), approximate=True)),
        rtol=0, atol=1e-6)
    # the exact (erf) GELU differs by far more than the bar
    erf = torch.nn.functional.gelu(torch.from_numpy(h)).numpy()
    assert np.abs(erf - np.asarray(jax.nn.gelu(jnp.asarray(h),
                                               approximate=True))).max() > 1e-4


@pytest.mark.parametrize("arch", ["qwen2-vl-7b", "starcoder2-3b"])
@pytest.mark.parametrize("engine", ["sync", "continuous"])
def test_engines_match_jax(arch, engine):
    """The sync and continuous engines: greedy tokens equal to the JAX
    engines' (the vision stub: zero patch embeddings before every prompt,
    the slot's position past them)."""
    cfg, jcfg, params, model = _setup(arch)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (9, 6, 9, 4, 8)]
    if engine == "sync":
        kw = dict(batch_size=3, max_prompt_len=9, max_new_tokens=4)
        teng = ServingEngine(cfg, model, device="cpu",
                             cache_dtype=torch.float32, **kw)
        jeng = JSync(jcfg, params, cache_dtype=jnp.float32, **kw)
    else:
        kw = dict(n_slots=2, max_prompt_len=9, max_new_tokens=4)
        teng = ContinuousBatchingEngine(cfg, model, device="cpu",
                                        cache_dtype=torch.float32, **kw)
        jeng = JCont(jcfg, params, cache_dtype=jnp.float32, **kw)
    rt = teng.generate(prompts, GenerationConfig(max_new_tokens=4))
    rj = jeng.generate(prompts, JGen(max_new_tokens=4))
    assert [r.tokens for r in rt] == [r.tokens for r in rj]
    if engine == "continuous":
        assert teng.decode_steps == jeng.decode_steps
        assert teng._cache["pos"].tolist() == \
            np.asarray(jeng._cache["pos"]).tolist()


def test_paged_engine_refuses_a_frontend():
    """Chunked prefill has no frontend-token analog: the paged engine
    refuses Qwen2-VL, as the JAX one does."""
    cfg, _, _, model = _setup("qwen2-vl-7b")
    with pytest.raises(NotImplementedError, match="frontend"):
        PagedEngine(cfg, model, device="cpu")
    cfg, _, _, model = _setup("qwen2-7b")
    PagedEngine(cfg, model, n_slots=2, max_prompt_len=8, max_new_tokens=2,
                device="cpu")


@pytest.mark.parametrize("argv", [
    ["--arch", "qwen2-vl-7b", "--reduced"],
    ["--arch", "granite-20b", "--reduced", "--engine", "continuous"],
    ["--arch", "dbrx-132b", "--reduced", "--policy", "load_aware"],
    ["--arch", "dbrx-132b", "--reduced", "--policy", "per_layer",
     "--engine", "paged", "--drop-target", "0.3"],
])
def test_serve_cli_new_archs_on_cpu(capsys, argv):
    from repro_torch.launch import serve
    results = serve.main(argv + ["--device", "cpu", "--requests", "3",
                                 "--prompt-len", "8", "--new-tokens", "3",
                                 "--batch-size", "2"])
    out = capsys.readouterr().out
    assert len(results) == 3 and all(len(r.tokens) == 3 for r in results)
    assert "served 3 requests" in out
    if "--policy" in argv:
        assert f"sparsity policy {argv[argv.index('--policy') + 1]!r}" in out
