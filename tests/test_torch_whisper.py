"""Whisper (the ``audio`` family: encoder-decoder, stub audio frontend) in
the port against the JAX package, on the CPU, on the JAX package's own
weights loaded through the weight bridge
(``repro_torch.checkpoint.from_numpy``), with the same numpy inputs.

Tolerances:
  * ``encode``, ``forward`` and ``prefill`` logits (float32 throughout):
    within 1e-5 of their largest magnitude — the same float32 arithmetic,
    each matrix product summed in another order (measured ~5e-7);
  * the bf16 caches (cross K/V, self-attention K/V): each package's cache
    is its own float32 values cast to bf16 bit for bit (the same cast
    point), and the float32 values agree within 1e-5; so the two bf16
    caches differ only where a bf16 rounding midpoint falls between the
    two float32 values: at most 1e-3 of the elements, each by no more
    than the float32 difference plus one bf16 ulp;
  * 4 ``decode_step``s from the same bf16 cache: logits within 1e-5 of
    their largest magnitude, the same greedy tokens;
  * the sinusoids: the prefill table bit for bit (float64, then rounded),
    the decode step's float32 one within 1e-6 (``sin``/``cos`` may round
    one float32 ulp apart);
  * one train step: loss rel 1e-5, each leaf's update norm-relative 1e-3
    (``test_torch_train.py``'s bars);
  * the sync engine's greedy tokens: equal, at a float32 cache;
  * checkpoints: every array bitwise.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as jckpt
from repro.configs import get_config as jax_config
from repro.models import model as JM
from repro.models import whisper as JW
from repro.optim import adamw as jadamw
from repro.serving import ContinuousBatchingEngine as JCont
from repro.serving import GenerationConfig as JGen
from repro.serving import ServingEngine as JSync
from repro.serving.paged import PagedEngine as JPaged
from repro_torch.checkpoint.from_numpy import (_unstack, opt_state_to_numpy,
                                               params_from_numpy,
                                               params_to_numpy)
from _config_compat import shared_fields
from repro_torch.configs import get_config
from repro_torch.data import pipeline
from repro_torch.launch.train import restore_state, save_state
from repro_torch.models import model as M
from repro_torch.models import whisper as TW
from repro_torch.optim import adamw
from repro_torch.serving import (ContinuousBatchingEngine, GenerationConfig,
                                 PagedEngine, ServingEngine)

ARCH = "whisper-large-v3"
F32 = 1e-5


def _close(got, want, rel=F32):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= rel, f"max error {err:.3e} of the largest magnitude"


def _norm_rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _f32(x):
    """A JAX array (bf16 too) or a tensor as a float32 numpy array."""
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _from_jax(x, dtype):
    return torch.from_numpy(_f32(x)).to(dtype)


@functools.lru_cache(maxsize=None)
def _setup(**narrow):
    """Both packages' configs (reduced, optionally narrowed further), the
    JAX init and the port's model loaded from it."""
    cfg = dataclasses.replace(get_config(ARCH).reduced(), **narrow)
    jcfg = dataclasses.replace(jax_config(ARCH).reduced(), **narrow)
    params = JM.init_params(jax.random.PRNGKey(3), jcfg)
    model = params_from_numpy(jax.tree.map(np.asarray, params), cfg,
                              device="cpu")
    return cfg, jcfg, params, model


def _batches(cfg, B, S, seed, kind="prefill"):
    """The same numpy batch (tokens, audio frame embeddings) for both."""
    b = M.make_batch(np.random.default_rng(seed), cfg, B, S, kind)
    tb = M.to_device(b, "cpu")
    tb["tokens"] = tb["tokens"].long()
    return {k: jnp.asarray(v) for k, v in b.items()}, tb


def _bf16_equal_but_ties(got_bf, want_bf, got_f32, want_f32):
    """Each bf16 cache is its package's float32 values cast to bf16, bit
    for bit; the float32 values agree within ``F32``; the bf16 caches then
    differ only in a few elements, each by the float32 difference and one
    bf16 ulp at most."""
    got_f32, want_f32 = _f32(got_f32), _f32(want_f32)
    np.testing.assert_array_equal(
        _f32(got_bf), torch.from_numpy(got_f32).to(torch.bfloat16).float())
    np.testing.assert_array_equal(
        _f32(want_bf), _f32(jnp.asarray(want_f32).astype(jnp.bfloat16)))
    _close(got_f32, want_f32)
    g, w = _f32(got_bf), _f32(want_bf)
    diff = g != w
    assert diff.sum() <= 1e-3 * diff.size, int(diff.sum())
    ulp = 2.0 ** (np.floor(np.log2(np.abs(w[diff]))) - 7)
    assert np.all(np.abs(g[diff] - w[diff])
                  <= np.abs(got_f32 - want_f32)[diff] + ulp)


# ---------------------------------------------------------------------------
# config, weights, inputs
# ---------------------------------------------------------------------------

def test_config_matches_jax_full_and_reduced():
    assert shared_fields(get_config(ARCH)) == \
        dataclasses.asdict(jax_config(ARCH))
    red = get_config(ARCH).reduced()
    assert shared_fields(red) == \
        dataclasses.asdict(jax_config(ARCH).reduced())
    assert (red.encoder_layers, red.n_frontend_tokens) == (2, 16)


def test_weight_tree_round_trips_bitwise():
    """The JAX tree loads into ``Whisper`` and restacks into the same
    leaves (``encoder`` / ``decoder`` stacked over layers, ``enc_norm`` and
    ``frontend_proj`` single, no ``lm_head``: tied)."""
    cfg, _, params, model = _setup()
    want = jax.tree.map(np.asarray, params)
    got = params_to_numpy(model)
    assert set(got) == {"embed", "frontend_proj", "encoder", "enc_norm",
                        "decoder", "final_norm"}
    assert set(got["embed"]) == {"embedding"}
    a, b = _unstack(got), _unstack(want)
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert len(model.encoder) == cfg.encoder_layers
    assert len(model.decoder) == cfg.n_layers


def test_batch_loader_and_engine_inputs_carry_audio():
    cfg = get_config(ARCH).reduced()
    b = M.make_batch(np.random.default_rng(0), cfg, 2, 8, "train")
    assert b["audio_embeds"].shape == (2, 16, cfg.d_model)
    assert b["audio_embeds"].dtype == np.float32
    lb = pipeline.make_loader(cfg, 3, 8, seed=1).get_batch(0)
    assert lb["audio_embeds"].shape == (3, 16, cfg.d_model)
    fe = M.frontend_inputs(cfg, 2, "cpu")
    assert set(fe) == {"audio_embeds"}
    assert not fe["audio_embeds"].any()
    # the frames live in the cross cache: no self-attention prefix
    assert M.frontend_len(cfg) == 0
    assert M.context_len_for(cfg, 10, 4) == \
        JM.context_len_for(jax_config(ARCH).reduced(), 10, 4) == 14


def test_sinusoids_match_jax_at_prefill_and_at_decode(monkeypatch):
    """The prefill table bit for bit; the decode step's float32 embedding
    against the one JAX's ``decode_step`` adds (captured from it); and the
    two differ at some position in both packages (float64 vs float32)."""
    cfg, jcfg, params, model = _setup()
    d = cfg.d_model
    table = TW._sinusoid(64, d, "cpu").numpy()
    np.testing.assert_array_equal(table, np.asarray(JW._sinusoid(64, d)))
    captured = []

    class Spy:
        def __getattr__(self, name):
            return getattr(jnp, name)

        @staticmethod
        def concatenate(xs, *a, **kw):
            out = jnp.concatenate(xs, *a, **kw)
            captured.append(np.asarray(out))
            return out

    monkeypatch.setattr(JW, "jnp", Spy())
    cache = JW.init_cache(jcfg, 1, 64)
    differ = 0
    for pos in (0, 1, 7, 40, 63):
        captured.clear()
        JW.decode_step(params, jnp.zeros((1, 1), jnp.int32),
                       dict(cache, pos=jnp.asarray(pos, jnp.int32)), jcfg)
        want = captured[0]
        got = TW._step_sinusoid(pos, d, "cpu").numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
        differ += int(np.any(want != table[pos]))
        # the halves are [sin | cos] of the float32 angle, not interleaved
        ang = np.float32(pos) / (10000 ** (2 * np.arange(d // 2) / d)
                                 ).astype(np.float32)
        np.testing.assert_allclose(got, np.concatenate(
            [np.sin(ang.astype(np.float64)), np.cos(ang.astype(np.float64))]),
            rtol=0, atol=1e-6)
    assert differ > 0


# ---------------------------------------------------------------------------
# the model functions
# ---------------------------------------------------------------------------

def test_encode_matches_jax():
    cfg, jcfg, params, model = _setup()
    jb, tb = _batches(cfg, 2, 6, seed=0)
    with torch.no_grad():
        got = TW.encode(model, tb["audio_embeds"], cfg)
    _close(got, JW.encode(params, jb["audio_embeds"], jcfg))


def test_forward_logits_match_jax():
    cfg, jcfg, params, model = _setup()
    jb, tb = _batches(cfg, 2, 10, seed=1)
    with torch.no_grad():
        got = TW.forward(model, tb, cfg)
    _close(got, JW.forward(params, jb, jcfg))


def test_prefill_logits_and_cache_match_jax():
    cfg, jcfg, params, model = _setup()
    jb, tb = _batches(cfg, 2, 10, seed=2)
    jl, jc = JW.prefill(params, jb, jcfg, cache_len=16)
    with torch.no_grad():
        tl, tc = TW.prefill(model, tb, cfg, cache_len=16)
        enc = TW.encode(model, tb["audio_embeds"], cfg)
        tk, tv = TW._enc_kv(model, enc, cfg)
        # the self K/V in float32: the prefill projections before the cast
        _, tf32 = TW.prefill(model, tb, cfg, cache_len=16,
                             cache_dtype=torch.float32)
    _close(tl, jl)
    jk, jv = JW._enc_kv(params, JW.encode(params, jb["audio_embeds"], jcfg),
                        jcfg)
    _, jf32 = JW.prefill(params, jb, jcfg, cache_len=16,
                         cache_dtype=jnp.float32)
    assert tc["cross_k"].dtype == torch.bfloat16
    assert tuple(tc["cross_k"].shape) == jc["cross_k"].shape == \
        (cfg.n_layers, 2, cfg.n_frontend_tokens, cfg.n_kv_heads,
         cfg.resolved_head_dim)
    _bf16_equal_but_ties(tc["cross_k"], jc["cross_k"], tk, jk)
    _bf16_equal_but_ties(tc["cross_v"], jc["cross_v"], tv, jv)
    for i in range(cfg.n_layers):
        for key in ("k", "v"):
            _bf16_equal_but_ties(tc["layers"][i][key], jc["layers"][key][i],
                                 tf32["layers"][i][key],
                                 jf32["layers"][key][i])
    assert tc["pos"] == int(jc["pos"]) == 10


def _port_cache(jc, cfg):
    """JAX's bf16 decode cache as the port's."""
    return {"layers": [{k: _from_jax(jc["layers"][k][i], torch.bfloat16)
                        for k in ("k", "v")} for i in range(cfg.n_layers)],
            "cross_k": _from_jax(jc["cross_k"], torch.bfloat16),
            "cross_v": _from_jax(jc["cross_v"], torch.bfloat16),
            "pos": int(jc["pos"])}


def test_four_decode_steps_match_jax():
    """From the same bf16 prefill cache: 4 greedy decode steps, logits and
    tokens (cross-attention over the bf16 cross K/V: the probabilities and
    the output rounded to bf16 in both)."""
    cfg, jcfg, params, model = _setup()
    jb, _ = _batches(cfg, 2, 10, seed=3)
    jl, jc = JW.prefill(params, jb, jcfg, cache_len=16)
    tc = _port_cache(jc, cfg)
    jt = jnp.argmax(jl[:, -1:], axis=-1).astype(jnp.int32)
    tt = torch.from_numpy(np.asarray(jt)).long()
    step = jax.jit(functools.partial(JW.decode_step, cfg=jcfg))
    for s in range(4):
        jl, jc = step(params, jt, jc)
        with torch.no_grad():
            tl, tc = TW.decode_step(model, tt, tc, cfg)
        _close(tl, jl)
        jt = jnp.argmax(jl[:, -1:], axis=-1).astype(jnp.int32)
        tt = torch.argmax(tl[:, -1:], dim=-1)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    assert tc["pos"] == int(jc["pos"]) == 14


def test_init_cache_and_prefill_cache_match_jax():
    """Shapes and dtypes of every leaf of ``init_cache``; ``prefill_cache``
    fills the cross K/V (bf16, as JAX's) and leaves the position at 0."""
    cfg, jcfg, params, model = _setup()
    jc = JW.init_cache(jcfg, 2, 12)
    tc = M.init_cache(cfg, 2, 12, device="cpu")
    assert tc["pos"] == int(jc["pos"]) == 0
    for key in ("cross_k", "cross_v"):
        assert tuple(tc[key].shape) == jc[key].shape
        assert tc[key].dtype == torch.bfloat16 and jc[key].dtype == \
            jnp.bfloat16
    assert len(tc["layers"]) == jc["layers"]["k"].shape[0]
    for key in ("k", "v"):
        assert tuple(tc["layers"][0][key].shape) == \
            jc["layers"][key].shape[1:]
    jb, tb = _batches(cfg, 2, 4, seed=4)
    jf = JW.prefill_cache(params, jb, jcfg, jc)
    with torch.no_grad():
        tf = TW.prefill_cache(model, tb, cfg, tc)
        tk, tv = TW._enc_kv(model, TW.encode(model, tb["audio_embeds"], cfg),
                            cfg)
    jk, jv = JW._enc_kv(params, JW.encode(params, jb["audio_embeds"], jcfg),
                        jcfg)
    _bf16_equal_but_ties(tf["cross_k"], jf["cross_k"], tk, jk)
    _bf16_equal_but_ties(tf["cross_v"], jf["cross_v"], tv, jv)
    assert tf["pos"] == 0
    with pytest.raises(NotImplementedError):
        M.init_cache(cfg, 2, 12, per_slot_pos=True, device="cpu")


def test_blockwise_branches_match_jax():
    """Past 1024 queries the encoder, the decoder's self-attention and its
    cross-attention take blockwise attention (512 / 1024 blocks, padded),
    on a narrow config: 1100 frames, 1030 tokens."""
    narrow = dict(d_model=64, n_heads=2, n_kv_heads=2, d_ff=128,
                  vocab_size=64, n_layers=1, encoder_layers=1,
                  n_frontend_tokens=1100)
    cfg, jcfg, params, model = _setup(**narrow)
    jb, tb = _batches(cfg, 1, 1030, seed=5)
    with torch.no_grad():
        enc = TW.encode(model, tb["audio_embeds"], cfg)
        logits = TW.forward(model, tb, cfg)
    _close(enc, JW.encode(params, jb["audio_embeds"], jcfg))
    _close(logits, JW.forward(params, jb, jcfg))


def test_whisper_refuses_an_ep_context(tmp_path):
    """The name dates from when Whisper refused an EP context; it takes
    one since training over EP was ported: in
    a world of one gloo rank, under a (1, 1) context with ``remat``, the
    forward logits and every gradient equal those without a context
    bitwise (remat recomputes the same float32 ops), and prefill and a
    decode step run under it and give the same logits. The 4-rank worlds
    against JAX are ``test_torch_train_world.py``."""
    import torch.distributed as tdist
    from repro_torch.distributed import DistContext, make_mesh
    cfg, _, _, model = _setup()
    _, tb = _batches(cfg, 2, 8, seed=0, kind="train")
    tdist.init_process_group("gloo", store=tdist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        ctx = DistContext(make_mesh((1, 1), ("data", "model")), remat=True)
        params = M.set_trainable(model)
        got = {}
        for name, d in (("plain", None), ("ctx", ctx)):
            with torch.enable_grad():
                logits = TW.forward(model, tb, cfg, dist=d)
                loss = M.cross_entropy(logits, tb["targets"])
                grads = torch.autograd.grad(loss, list(params.values()))
            with torch.no_grad():
                pl, cache = TW.prefill(model, tb, cfg, cache_len=10, dist=d)
                dl, _ = TW.decode_step(model, tb["tokens"][:, :1], cache,
                                       cfg, dist=d)
            got[name] = [logits, pl, dl, *grads]
        for a, b in zip(got["ctx"], got["plain"]):
            assert torch.equal(a, b)
    finally:
        for p in model.parameters():
            p.requires_grad_(False)
        tdist.destroy_process_group()


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def test_sync_engine_tokens_match_jax():
    """``ServingEngine`` (zero audio frames, fed by the engine) serves
    JAX's greedy tokens, float32 cache."""
    cfg, jcfg, params, model = _setup()
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (8, 8, 8)]
    jeng = JSync(jcfg, params, batch_size=3, max_prompt_len=8,
                 max_new_tokens=5, cache_dtype=jnp.float32)
    want = [r.tokens for r in jeng.generate(prompts, JGen(max_new_tokens=5))]
    eng = ServingEngine(cfg, model, batch_size=3, max_prompt_len=8,
                        max_new_tokens=5, cache_dtype=torch.float32,
                        device="cpu")
    got = [r.tokens for r in eng.generate(prompts,
                                          GenerationConfig(max_new_tokens=5))]
    assert got == want
    assert all(len(t) == 5 for t in got)
    assert eng.overflow_pairs == 0
    eng.metrics()                    # the drain tolerates a cache w/o metrics


def test_slot_engines_refuse_audio_as_jax_does():
    """Both packages' slot engines refuse audio, with the same words; the
    port's paged engine names the attention it takes besides GQA (MLA,
    which the JAX package's does not take)."""
    cfg, jcfg, params, model = _setup()
    for port, ref in ((ContinuousBatchingEngine, JCont),
                      (PagedEngine, JPaged)):
        with pytest.raises(NotImplementedError) as want:
            ref(jcfg, params, n_slots=2)
        with pytest.raises(NotImplementedError) as got:
            port(cfg, model, n_slots=2, device="cpu")
        expect = str(want.value)
        if port is PagedEngine:
            expect = expect.replace("GQA attention", "GQA or MLA attention")
        assert str(got.value) == expect


# ---------------------------------------------------------------------------
# training and checkpoints
# ---------------------------------------------------------------------------

def test_train_step_matches_jax():
    """One AdamW step on the loader's batch (tokens, targets and audio
    frames): the loss (cross entropy only: no MoE, no aux term) and every
    leaf's update against JAX's ``make_train_step``."""
    cfg, jcfg, params, _ = _setup()
    tree = jax.tree.map(np.asarray, params)
    batch = pipeline.make_loader(cfg, 2, 12, seed=7).get_batch(0)
    jopt = jadamw(3e-3)
    jp, jst, jloss = jax.jit(JM.make_train_step(jcfg, jopt, aux_coef=0.01))(
        params, jopt.init(params), {k: jnp.asarray(v)
                                    for k, v in batch.items()})
    model = params_from_numpy(tree, cfg, device="cpu")
    opt = adamw(3e-3)
    st = opt.init(M.trainable(model))
    loss = M.make_train_step(cfg, opt, aux_coef=0.01)(model, st, batch)
    assert abs(float(loss) - float(jloss)) <= 1e-5 * abs(float(jloss))
    got, want, start = (_unstack(params_to_numpy(model)),
                        _unstack(jax.tree.map(np.asarray, jp)),
                        _unstack(tree))
    assert sorted(got) == sorted(want)
    for name in start:
        assert _norm_rel(got[name] - start[name],
                         want[name] - start[name]) <= 1e-3, name


def _flat(tree):
    return {"/".join(str(getattr(k, "key", getattr(k, "name", k)))
                     for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _assert_equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_checkpoint_round_trips_with_jax(tmp_path):
    """A checkpoint the port writes after a train step restores in JAX's
    ``restore_checkpoint``; one JAX writes restores in the port's
    ``restore_state``: every array equal both ways."""
    cfg, jcfg, params, _ = _setup()
    tree = jax.tree.map(np.asarray, params)
    model = params_from_numpy(tree, cfg, device="cpu")
    opt = adamw(3e-3)
    st = opt.init(M.trainable(model))
    step = M.make_train_step(cfg, opt)
    step(model, st, pipeline.make_loader(cfg, 2, 8, seed=8).get_batch(0))
    save_state(str(tmp_path / "port"), 1, model, st)
    jopt = jadamw(3e-3)
    target = {"params": params, "opt": jopt.init(params)}
    restored = jckpt.restore_checkpoint(str(tmp_path / "port"), target)
    port_flat = _flat({"params": params_to_numpy(model),
                       "opt": opt_state_to_numpy(st)})
    _assert_equal(_flat(restored), port_flat)
    # and back: JAX's state after its own step, into a fresh port model
    jp, jst, _ = jax.jit(JM.make_train_step(jcfg, jopt))(
        params, jopt.init(params),
        {k: jnp.asarray(v) for k, v in
         pipeline.make_loader(cfg, 2, 8, seed=9).get_batch(0).items()})
    jckpt.save_checkpoint(str(tmp_path / "jax"), 1, {"params": jp,
                                                     "opt": jst})
    fresh = params_from_numpy(tree, cfg, device="cpu")
    fst = opt.init(M.trainable(fresh))
    restore_state(str(tmp_path / "jax"), fresh, fst)
    _assert_equal(_flat({"params": params_to_numpy(fresh),
                         "opt": opt_state_to_numpy(fst)}),
                  _flat({"params": jp, "opt": jst}))
