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
from repro_torch.kernels import ops
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


# ---------------------------------------------------------------------------
# the paged paths' latent attention (kernels.ops.mla_latent_attend)
# ---------------------------------------------------------------------------

PS = 4                       # page size of the pools below


def _pool(cfg, n_pages, seed):
    """A paged latent pool {"c", "kr"} of n_pages + 1 pages (the sink last)
    filled with bf16 noise."""
    g = torch.Generator().manual_seed(seed)
    return {k: torch.randn((n_pages + 1, PS, w), generator=g).bfloat16()
            for k, w in (("c", cfg.kv_lora_rank),
                         ("kr", cfg.qk_rope_head_dim))}


def _gathered(cache, ids, read_len):
    """The latent pools' pages ``ids`` (..., n) as rows, trimmed to
    ``read_len``."""
    return tuple(cache[k][ids.long()].flatten(-3, -2)[..., :read_len, :]
                 for k in ("c", "kr"))


def _composed_decode(attn, q_nope, q_rope, cache, pos, cfg, table, read_len):
    """The paged decode's attention as it was composed before the wrapper:
    the pages gathered, the validity mask, ``_attend_latent``."""
    c, kr = _gathered(cache, table, read_len)
    valid = TA.PagedLayout(PS).validity(pos + 1, c.shape[1], c.device)
    return TA._attend_latent(attn, q_nope, q_rope, c, kr,
                             TA._valid_mask(valid, 4), cfg)


def _composed_chunk(attn, q_nope, q_rope, cache, slot, positions, cfg, table,
                    read_len):
    c, kr = _gathered(cache, table[slot], read_len)
    k_abs = torch.arange(c.shape[0])
    mask = (k_abs[None, :] <= positions[0].long()[:, None])[None, :, None, :]
    return TA._attend_latent(attn, q_nope, q_rope, c[None], kr[None], mask,
                             cfg)


@pytest.mark.parametrize("read_len", [None, 22])
def test_latent_attend_plain_is_the_composed_decode(read_len):
    """``mla_paged_decode_attention`` through the wrapper's plain version
    equals the gather + mask + ``_attend_latent`` it replaced, bit for bit:
    four slots at mixed positions — one at a page's last row, one on the
    first row of the next, a retired slot whose table is all page 0, and
    two slots sharing their first pages — with and without a read length
    that trims the last page."""
    cfg, _, _, attn = _attn_setup()
    cache = _pool(cfg, 12, 0)
    table = torch.tensor([[1, 2, 3, 4, 5, 6], [1, 2, 7, 8, 9, 10],
                          [0, 0, 0, 0, 0, 0], [11, 12, 3, 4, 5, 6]],
                         dtype=torch.int32)
    pos = torch.tensor([7, 8, 5, 21], dtype=torch.int32)
    x = torch.from_numpy(_x(4, 1, cfg.d_model, 7))
    q_nope, q_rope = TA.mla_queries(attn, x, pos[:, None], cfg)
    calls = ops.mla_latent_attend_ref.calls
    got, cache = TA.mla_paged_decode_attention(
        attn, x, cache, pos, cfg, layout=TA.PagedLayout(PS), page_table=table,
        read_len=read_len)
    assert ops.mla_latent_attend_ref.calls == calls + 1
    want = _composed_decode(attn, q_nope, q_rope, cache, pos, cfg, table,
                            read_len)
    assert torch.equal(got, want)


@pytest.mark.parametrize("start,valid_len", [(0, 6), (8, 5)])
def test_latent_attend_plain_is_the_composed_chunk(start, valid_len):
    """``mla_chunk_attention`` through the wrapper's plain version equals
    the composition it replaced, bit for bit: a 6-row chunk at position 0,
    and one after a prefix hit (slot 1 maps slot 0's first two pages and
    writes from position 8) with valid_len < C, whose padding rows still
    attend."""
    cfg, _, _, attn = _attn_setup()
    cache = _pool(cfg, 10, 1)
    table = torch.tensor([[1, 2, 3, 4], [1, 2, 5, 6]], dtype=torch.int32)
    slot, C, read_len = (0, 6, 16) if start == 0 else (1, 6, 14)
    x = torch.from_numpy(_x(1, C, cfg.d_model, 9))
    positions = start + torch.arange(C, dtype=torch.int32)[None, :]
    q_nope, q_rope = TA.mla_queries(attn, x, positions, cfg)
    got, cache = TA.mla_chunk_attention(
        attn, x, cache, slot, start, valid_len, cfg,
        layout=TA.PagedLayout(PS), page_table=table, read_len=read_len)
    want = _composed_chunk(attn, q_nope, q_rope, cache, slot, positions, cfg,
                           table, read_len)
    assert torch.equal(got, want)


def _attend_args(R=32, DR=16, device="cpu"):
    H, N = 2, 3
    return dict(q_lat=torch.zeros((N, H, R), device=device),
                q_rope=torch.zeros((N, H, DR), device=device),
                c=torch.zeros((5, PS, R), dtype=torch.bfloat16, device=device),
                kr=torch.zeros((5, PS, DR), dtype=torch.bfloat16,
                               device=device),
                page_table=torch.zeros((N, 2), dtype=torch.int32,
                                       device=device),
                last=torch.zeros((N,), dtype=torch.int32, device=device),
                scale=0.5)


@pytest.mark.parametrize("case", ["q_bf16", "pool_f32", "last_int64",
                                  "pool_strided", "table_strided",
                                  "width_untemplated", "page_untemplated",
                                  "groups"])
def test_latent_attend_refuses(case):
    """The wrapper raises, on every device, on a query that is not float32,
    a pool that is not bf16, positions that are not int32, a pool or a
    table that is not contiguous and rows that do not fall in the table's
    groups; off the CPU (a meta tensor here) on widths or a page size the
    kernel is not built for. The plain version takes any."""
    kw = _attend_args()
    if case == "q_bf16":
        kw["q_lat"] = kw["q_lat"].bfloat16()
    elif case == "pool_f32":
        kw["c"] = kw["c"].float()
    elif case == "last_int64":
        kw["last"] = kw["last"].long()
    elif case == "pool_strided":
        kw["c"] = torch.zeros((5, 2 * PS, 32), dtype=torch.bfloat16)[:, ::2]
    elif case == "table_strided":
        kw["page_table"] = torch.zeros((3, 4), dtype=torch.int32)[:, ::2]
    elif case == "width_untemplated":
        assert ops.mla_latent_attend(**kw).shape == (3, 2, 32)
        kw = _attend_args(device="meta")
    elif case == "page_untemplated":
        assert ops.mla_latent_attend(**_attend_args(256, 32)).shape == \
            (3, 2, 256)
        kw = _attend_args(256, 32, device="meta")
    else:
        kw["page_table"] = torch.zeros((2, 2), dtype=torch.int32)
    with pytest.raises((TypeError, ValueError)) as err:
        ops.mla_latent_attend(**kw)
    if case == "width_untemplated":
        assert "widths" in str(err.value)
    if case == "page_untemplated":
        assert "page size" in str(err.value)
    if case == "pool_strided":
        assert "contiguous" in str(err.value)


@pytest.mark.parametrize("widths,page_size,refused", [
    ((None, None), 16, "widths"), ((512, 64), 4, "page size"),
    ((256, 32), 12, "page size"), ((512, 64), 64, None),
    ((256, 32), 24, None)])
def test_paged_engine_refuses_mla_shapes_the_kernel_lacks(widths, page_size,
                                                          refused):
    """A paged engine for an MLA model on the card is refused when it is
    built, before anything is allocated, where the latent attention kernel
    would refuse its calls: latent / rope widths it is not built for (the
    reduced config's), or a page size that is not a multiple of 8. Other
    page sizes pass that check (and then fail only for want of a card
    here). On the CPU the engine takes any."""
    cfg0, _, _, model = _model_setup()
    R, DR = widths
    cfg = cfg0 if R is None else dataclasses.replace(
        cfg0, kv_lora_rank=R, qk_rope_head_dim=DR)
    if refused is None:
        ops.check_mla_latent_attend_shape(R, DR, page_size, "cuda")
    else:
        with pytest.raises(ValueError, match=refused):
            PagedEngine(cfg, model, device="cuda", page_size=page_size,
                        max_prompt_len=16, max_new_tokens=4, n_slots=2)
    eng = PagedEngine(cfg0, model, device="cpu", page_size=page_size,
                      max_prompt_len=16, max_new_tokens=4, n_slots=2)
    assert eng._cache["layers"][0]["c"].shape[1] == page_size


def test_latent_attend_plan_fills_the_card():
    """The cut ``mla_attend.plan`` takes from the shapes on an H100 (132
    SMs): the doc
    cell's decode (32 slots x 16 heads over 5120 positions) one 16-row tile
    a slot, 7 key splits in the score pass and 4 in the weighted one (two
    CTAs an SM); its chunk (256 rows x 16 heads over 4608) 64 tiles of 64
    rows, 2 splits and 1 (one CTA an SM); MiniCPM3's decode (40 heads) one
    48-row tile a slot. Every split is whole tiles of the score pass's
    keys, and each pass is one wave of CTAs, at least half the card."""
    from repro_torch.kernels import mla_attend as MA
    sms = 132
    dec = MA.plan(32, 16, 32, 512, 5120, sms)
    assert (dec.wm, dec.wn, dec.tiles) == (1, 4, 32)
    assert (dec.split1, dec.n_split1) == (768, 7)
    assert (dec.split3, dec.n_split3) == (1280, 4)
    chunk = MA.plan(256, 16, 1, 512, 4608, sms)
    assert (chunk.wm, chunk.wn, chunk.tiles) == (4, 2, 64)
    assert (chunk.split1, chunk.n_split1) == (2304, 2)
    assert (chunk.split3, chunk.n_split3) == (4608, 1)
    assert MA.plan(8, 40, 8, 256, 2048, sms)[:3] == (3, 2, 8)
    for p, per_sm in ((dec, 2), (chunk, 1)):
        assert p.split1 % (64 * p.wn) == 0 and p.split3 % MA.SPLIT3_STEP == 0
        for ctas in (p.tiles * p.n_split1, p.tiles * 2 * p.n_split3):
            assert sms // 2 <= ctas <= sms * per_sm


def test_latent_attend_kernels_clear_the_fused_roofline():
    """No kernel of ``csrc/mla_latent_attend.cu`` is named so that the
    fused MoE kernel's roofline (``perfbench/metrics/
    fused_moe_pipeline_roofline.py``) would count its time."""
    import re
    import sys
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(root))
    from perfbench.metrics import fused_moe_pipeline_roofline as FR
    src = (root / "src" / "repro_torch" / "kernels" / "csrc"
           / "mla_latent_attend.cu").read_text()
    names = re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)"
                       r"\s*)?(\w+)\s*\(", src)
    assert len(names) == 3, names
    for name in names:
        assert not re.search(FR.KERNELS, f"void (anonymous namespace)::"
                             f"{name}<512, 64, 1, 4>(Args)"), name
