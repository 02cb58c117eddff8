"""DeepSeek-V2 in the port — MLA without a query LoRA, YaRN, a leading
dense layer, shared experts, the paged latent cache — against the plain
reference ``perfbench/reference/deepseek_v2.py`` at a tiny shape
(``perfbench/tests/tiny_deepseek.py``: d 64, 4 heads, kv_lora 32, nope /
rope / v 16, one dense layer of 96, 3 MoE layers of 8 experts top-2 + 2
shared, YaRN factor 40 over 32 original positions), on the benchmark's
seeded weights, served keep-all and under 2T-Drop.

Tolerances, on logits relative to their largest magnitude (the TF32
control, the reference with TF32 products, reads 4e-4 - 6e-4 on both):
  * the whole-prompt forward (float32 throughout): 1e-5; float32 products
    summed in other orders read ~4e-7;
  * the paged engine (chunked prefill over a prefix hit, then decode, all
    through the bf16 latent cache, which the reference rounds alike):
    1e-4; the softmax rounded to bf16 on both sides lands an element one
    bf16 ulp apart where the two float32 scores straddle a rounding
    boundary, and the absorbed and the decompressed products associate
    differently: ~1.4e-5.
Positions where the reference's routing came within rounding of a 2T
threshold or of the top-k boundary (``check.ambiguous``) are left out.

Also: YaRN's frequencies, correction range and softmax scale against
their closed forms at the published numbers; the leading dense layer's
block and the MoE-layer indexing of thresholds and ``MetricsState`` rows;
the spans MLA, the shared experts and the dense layer open; the paged
engine's peak-pages counter; and a GQA paged run's tokens as they were
before the latent cache existed."""
import collections
import dataclasses
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from perfbench.harness import check, program  # noqa: E402
from perfbench.harness import weights as W  # noqa: E402
from perfbench.reference import deepseek_v2 as REF  # noqa: E402
from perfbench.tests import tiny_deepseek as TD  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.policy import make_policy  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.obs import metrics_spec  # noqa: E402
from repro_torch.serving import GenerationConfig, PagedEngine  # noqa: E402
from repro_torch.serving.engine import exact_moe_policy  # noqa: E402

SEED = 2 ** 31 + 5
WHOLE_TOL = 1e-5
PAGED_TOL = 1e-4
POLICIES = {"none": TD.KEEPALL["serving"], "2t": TD.CONFIG["serving"]}


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _widened(conf, **widths):
    """``conf`` with the latent / rope widths ``widths`` in its dims and
    its port fields."""
    port = {**conf["port"], "fields": {**conf["port"]["fields"], **widths}}
    return {**conf, "dims": {**conf["dims"], **widths}, "port": port}


# the tiny configuration at MiniCPM3-4B's latent and rope widths, which
# the card's latent-attention kernel is built for
WIDE = _widened(TD.CONFIG, kv_lora_rank=256, qk_rope_head_dim=32)


def _prepared(policy: str, conf=TD.CONFIG, device="cpu"):
    """(cfg, model, calibrated policy) of the tiny configuration."""
    serving = POLICIES[policy]
    cfg = program.port_config({**conf, "serving": serving})
    model = program.build_model(cfg, conf["dims"], SEED, device)
    calib = W.calibration(conf["dims"], serving["calibration_tokens"], SEED,
                          device) if "calibration_tokens" in serving else None
    return cfg, model, program.prepare(model, cfg, serving, calib)


def _reference(policy: str, precision: str = "float32", dims=TD.DIMS,
               device="cpu"):
    return REF.Reference(dims, POLICIES[policy], SEED, device,
                         precision=precision)


def _gap(got, want, margins):
    """The largest |got - want| over the unambiguous positions, relative
    to the largest |want|."""
    keep = ~check.ambiguous(margins)
    assert keep.sum() >= 0.9 * len(keep)
    d = (got - want).abs()[keep].max()
    return float(d / want.abs().max())


# ---------------------------------------------------------------------------
# YaRN
# ---------------------------------------------------------------------------

def test_yarn_at_the_published_numbers():
    """DeepSeek-V2-Lite: rope 64, theta 1e4, factor 40 over 4096 positions,
    beta 32 / 1, mscale 0.707 / 0.707: the ramp runs from frequency 10 to
    23 of 32; the softmax scale is 192^-0.5 x mscale(40, 0.707)^2 =
    0.1147214 (0.114722 to six places); cos and sin unscaled (the two
    mscales cancel). The port's and the reference's frequencies are the
    closed form's, computed here in float64."""
    cfg = get_config("deepseek-v2-lite")
    yarn = L.yarn_of(cfg)
    assert L.yarn_correction_range(64, 1e4, yarn) == (10, 23)
    m = 0.1 * 0.707 * math.log(40) + 1
    assert L.yarn_mscale(40, 0.707) == pytest.approx(m, rel=1e-15)
    scale = L.yarn_attention_scale(192, yarn)
    assert scale == pytest.approx(m * m / math.sqrt(192), rel=1e-15)
    assert scale == pytest.approx(0.114722, abs=1e-6)
    i = np.arange(32, dtype=np.float64)
    extra = 1e4 ** (-2 * i / 64)
    ramp = np.clip((i - 10) / 13, 0, 1)
    want = extra / 40 * ramp + extra * (1 - ramp)
    got = L.yarn_freqs(64, 1e4, yarn)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-6)
    np.testing.assert_array_equal(
        got, REF.yarn_inv_freq({**TD.DIMS, "rope_original_max_pos": 4096,
                                "rope_theta": 1e4}, 64))
    assert REF.softmax_scale({"qk_nope_head_dim": 128,
                              "qk_rope_head_dim": 64,
                              "rope_scaling_factor": 40.0,
                              "rope_mscale_all_dim": 0.707}) == \
        pytest.approx(scale, rel=1e-15)
    x = torch.randn(1, 3, 2, 64, generator=torch.Generator().manual_seed(1))
    pos = torch.tensor([[0, 1, 4000]])
    rot = L.apply_rope(x, pos, 1e4, yarn=yarn)
    torch.testing.assert_close(rot.norm(dim=-1), x.norm(dim=-1))
    assert torch.equal(rot[:, 0], x[:, 0])


def test_yarn_ramp_bites_at_the_tiny_shape():
    """Rope 16 over 32 original positions: the ramp from 0 to 2, so half
    a step at frequency 1 and every frequency from 2 on divided by 40; a
    factor of 1 is plain RoPE, bit for bit."""
    cfg = program.port_config(TD.CONFIG)
    yarn = L.yarn_of(cfg)
    assert L.yarn_correction_range(16, 1e4, yarn) == (0, 2)
    plain = L.rope_freqs(16, 1e4)
    got = L.yarn_freqs(16, 1e4, yarn)
    assert got[0] == plain[0]
    np.testing.assert_allclose(got[2:], plain[2:] / 40, rtol=1e-6)
    assert got[1] == pytest.approx(plain[1] * (0.5 / 40 + 0.5), rel=1e-6)
    x = torch.randn(1, 5, 2, 16, generator=torch.Generator().manual_seed(2))
    pos = torch.arange(5)[None]
    assert L.yarn_of(dataclasses.replace(cfg, rope_scaling_factor=1.0)) \
        is None
    assert torch.equal(L.apply_rope(x, pos, 1e4, yarn=None),
                       L.apply_rope(x, pos, 1e4))


# ---------------------------------------------------------------------------
# the port against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("policy", ["none", "2t"])
def test_whole_prompt_forward_matches_reference(policy):
    """An 80-token prompt through ``transformer.forward`` (past the rope's
    32 original positions) against the reference's full forward, both in
    float32: logits within WHOLE_TOL; the TF32 control is not."""
    cfg, model, pol = _prepared(policy)
    seq = np.random.default_rng(0).integers(1, 512, 80).astype(np.int32)
    with torch.no_grad():
        got = TT.forward(model, {"tokens": torch.as_tensor(seq[None]).long()},
                         cfg, policy=exact_moe_policy(pol))[0]
    gaps = {}
    for precision in ("float32", "tf32"):
        ref = _reference(policy, precision)
        with torch.no_grad():
            hidden, margins = ref.run([seq], [len(seq)], [range(len(seq))])
            gaps[precision] = _gap(got, ref.logits(hidden, ref.head()),
                                   margins)
    assert gaps["float32"] <= WHOLE_TOL
    assert gaps["tf32"] > 10 * WHOLE_TOL


class _Capture:
    """Wraps ``transformer.chunk_step`` / ``decode_step`` to keep the
    logits the paged engine computed: the last valid row of each chunk
    by (slot, prompt length reached), and each decode step's rows with
    the positions they decoded at."""

    def __init__(self, monkeypatch):
        self.chunks, self.decodes = {}, []
        chunk, decode = TT.chunk_step, TT.decode_step

        def chunk_step(model, tokens, slot, start, valid, cache, cfg, **kw):
            logits, cache = chunk(model, tokens, slot, start, valid, cache,
                                  cfg, **kw)
            self.chunks[(slot, start + valid)] = logits[0, valid - 1].clone()
            return logits, cache

        def decode_step(model, token, cache, cfg, **kw):
            pos = cache["pos"].clone()
            logits, cache = decode(model, token, cache, cfg, **kw)
            self.decodes.append((pos, logits[:, -1].clone()))
            return logits, cache
        monkeypatch.setattr(TT, "chunk_step", chunk_step)
        monkeypatch.setattr(TT, "decode_step", decode_step)

    def served_logits(self, slot, plen, n):
        """The logits behind the ``n`` tokens a request of prompt length
        ``plen`` in ``slot`` was served."""
        out = [self.chunks[(slot, plen)]]
        for j in range(1, n):
            out += [lg[slot] for pos, lg in self.decodes
                    if int(pos[slot]) == plen + j - 1][-1:]
        return torch.stack(out)


def _doc_prompts():
    rng = np.random.default_rng(1)
    doc = rng.integers(1, 512, 64).astype(np.int32)
    return [np.concatenate([doc, rng.integers(1, 512, n).astype(np.int32)])
            for n in (20, 9)]


def _paged_gaps(monkeypatch, policy, conf, device):
    """Two requests on one 64-token document through ``PagedEngine`` on
    ``device`` (chunks of 32, pages of 16): the first prefills three
    chunks and decodes 7 tokens; the second, after it, maps the document's
    4 pages from the prefix cache and prefills the rest. Returns the
    largest gap of the served logits to the reference's teacher-forced
    full forward at float32 and at TF32 products, and the latent
    attention calls (kernel launches on the card, plain calls on the
    CPU) against the MLA layer calls the steps made."""
    cfg, model, pol = _prepared(policy, conf, device)
    cap = _Capture(monkeypatch)
    eng = PagedEngine(cfg, model, n_slots=2, page_size=16, chunk_size=32,
                      max_prompt_len=96, max_new_tokens=8, policy=pol,
                      device=device)
    gen = GenerationConfig(max_new_tokens=8, temperature=0.0, eos_token=-1)
    counter = ops.mla_latent_attend_ref if device == "cpu" else \
        ops.mla_latent_attend
    count = counter.calls if device == "cpu" else counter.launches
    served = []
    for p in _doc_prompts():
        tokens = eng.generate([p], gen)[0].tokens
        served.append((p, tokens, cap.served_logits(0, len(p), len(tokens))))
    assert eng.prefix_hits == 4 and eng.chunk_steps == 3 + 1
    calls = (counter.calls if device == "cpu" else counter.launches) - count
    layer_calls = cfg.n_layers * (eng.chunk_steps + len(cap.decodes))
    seqs = [np.concatenate([p, np.asarray(t[:-1], np.int32)])
            for p, t, _ in served]
    pos = [range(len(p) - 1, len(p) - 1 + len(t)) for p, t, _ in served]
    got = torch.cat([lg for _, _, lg in served])
    gaps = {}
    for precision in ("float32", "tf32"):
        # the seeded weights are drawn on the device: the reference too
        ref = _reference(policy, precision, conf["dims"], device)
        with torch.no_grad():
            hidden, margins = ref.run(seqs, [0, 0], pos)
            gaps[precision] = _gap(got, ref.logits(hidden, ref.head()),
                                   margins)
    return gaps, calls, layer_calls


@pytest.mark.parametrize("policy", ["none", "2t"])
def test_paged_chunks_and_decode_match_reference(monkeypatch, policy):
    """``_paged_gaps`` on the CPU: every served logit is the reference's
    teacher-forced full forward (all positions through the bf16 latent
    cache) within PAGED_TOL; the TF32 control is not. Every MLA layer call
    of a chunk or a decode step ran the latent attention's plain version
    once."""
    gaps, calls, layer_calls = _paged_gaps(monkeypatch, policy, TD.CONFIG,
                                           "cpu")
    assert gaps["float32"] <= PAGED_TOL
    assert gaps["tf32"] > 2 * PAGED_TOL
    assert calls == layer_calls


@pytest.mark.cuda
@pytest.mark.parametrize("policy", ["none", "2t"])
def test_paged_chunks_and_decode_match_reference_on_the_card(monkeypatch,
                                                             policy):
    """``_paged_gaps`` on the card at MiniCPM3-4B's latent widths (256 /
    32), the paged MLA paths through the latent-attention kernel: the
    served logits within PAGED_TOL of the float32 reference and the TF32
    control still outside twice that, so the kernel's scores keep float32
    accuracy. One launch per MLA layer call. Skips without a card; this
    file imports no JAX (``--noconftest`` runs it there)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    gaps, calls, layer_calls = _paged_gaps(monkeypatch, policy, WIDE,
                                           "cuda")
    assert gaps["float32"] <= PAGED_TOL
    assert gaps["tf32"] > 2 * PAGED_TOL
    assert calls == layer_calls


def test_latent_pages_are_shared_by_the_prefix_cache():
    """The second request's page table starts with the first one's
    document pages (refcounted, zero-copy), and its chunk writes land
    after them: the document's latent rows are untouched."""
    cfg, model, pol = _prepared("2t")
    eng = PagedEngine(cfg, model, n_slots=2, page_size=16, chunk_size=32,
                      max_prompt_len=96, max_new_tokens=8, policy=pol,
                      device="cpu")
    a, b = _doc_prompts()
    gen = GenerationConfig(max_new_tokens=4)
    eng.generate([a], gen)
    doc_pages = [eng._alloc.lookup(eng._prefix_key(a, 16 * h, gen))
                 for h in range(1, 5)]
    before = [lay["c"][doc_pages].clone() for lay in eng._cache["layers"]]
    eng.submit(b, gen)
    eng.step()                                   # admit + first chunk
    assert eng._page_table[0, :4].tolist() == doc_pages
    for lay, old in zip(eng._cache["layers"], before):
        assert torch.equal(lay["c"][doc_pages], old)
    eng.drain()


# ---------------------------------------------------------------------------
# the leading dense layer, MoE-layer rows
# ---------------------------------------------------------------------------

def test_leading_dense_layer_and_moe_layer_rows():
    """Block 0 is a dense SwiGLU of d_ff and no MoE layer; blocks 1-3 are
    MoE layers with shared experts. Everything kept per MoE layer is
    indexed by MoE layer: the per-layer thresholds (3 pairs),
    ``metrics_spec`` and the ``MetricsState`` rows (3), and the counters
    (each of the 3 MoE layers routes every token's K x P sub-pairs)."""
    cfg = program.port_config(TD.CONFIG)
    model = program.build_model(cfg, TD.DIMS, SEED, "cpu")
    b0 = model.blocks[0]
    assert b0.moe is None and tuple(b0.mlp.w1.shape) == (64, 96)
    assert all(b.moe is not None and b.mlp is None
               and tuple(b.moe.shared.w1.shape) == (64, 64)
               for b in model.blocks[1:])
    assert metrics_spec(cfg, model) == (3, 8)
    calib = W.calibration(TD.DIMS, 256, SEED, "cpu")
    _, per_layer = make_policy("per_layer", cfg.dualsparse,
                               drop_target=0.25).prepare(model, cfg, calib)
    assert metrics_spec(cfg, model) == (3, 16)
    assert [b.moe is not None and b.moe.thresholds is not None
            for b in model.blocks] == [False, True, True, True]
    T = 24
    tokens = torch.randint(1, 512, (1, T),
                           generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        _, cache = TT.prefill(model, {"tokens": tokens}, cfg,
                              policy=per_layer)
    m = cache["metrics"]
    assert tuple(m.expert_load.shape) == (3, 16)
    assert int(m.total_pairs) == 3 * T * cfg.top_k * 2
    assert int(m.expert_load.sum()) == int(m.kept_full + m.kept_major)


def test_n_params_is_the_published_count_less_the_norms():
    cfg = get_config("deepseek-v2-lite")
    norms = 27 * (2 * 2048 + 512) + 2048
    assert cfg.n_params() + norms == 15_706_484_224
    assert (cfg.leading_dense_layers, cfg.q_lora_rank, cfg.n_shared_experts,
            cfg.router_norm_topk) == (1, 0, 2, False)


# ---------------------------------------------------------------------------
# spans and the peak-pages counter
# ---------------------------------------------------------------------------

def _enclosing(events, inner, outer):
    """How many ``inner`` spans, and how many of them lie inside an
    ``outer`` span."""
    outs = [(e["ts"], e["ts"] + e["dur"]) for e in events
            if e["ph"] == "X" and e["name"] == outer]
    ins = [(e["ts"], e["ts"] + e["dur"]) for e in events
           if e["ph"] == "X" and e["name"] == inner]
    inside = sum(any(a <= s and t <= b for a, b in outs) for s, t in ins)
    return len(ins), inside


def test_mla_shared_and_dense_spans_nest_in_their_layers():
    """Over a served run: ``mla.latent`` and ``mla.attend`` once per layer
    per forward, inside ``model.attention``; ``moe.shared`` once per MoE
    layer per forward, inside ``moe``; ``model.dense`` once per forward
    (one dense layer), in no ``moe``; and each decode step holds one of
    each per layer."""
    cfg, model, pol = _prepared("2t")
    eng = PagedEngine(cfg, model, n_slots=2, page_size=16, chunk_size=32,
                      max_prompt_len=96, max_new_tokens=8, policy=pol,
                      device="cpu")
    for p in _doc_prompts():
        eng.submit(p, GenerationConfig(max_new_tokens=5))
    eng.drain()
    ev = eng.tracer.events()
    n_fwd = eng.decode_steps + eng.chunk_steps
    for inner, outer, per in (("mla.latent", "model.attention", 4),
                              ("mla.attend", "model.attention", 4),
                              ("moe.shared", "moe", 3)):
        n, inside = _enclosing(ev, inner, outer)
        assert n == inside == per * n_fwd, inner
    n, inside = _enclosing(ev, "model.dense", "moe")
    assert n == n_fwd and inside == 0
    decodes = [(e["ts"], e["ts"] + e["dur"]) for e in ev
               if e["ph"] == "X" and e["name"] == "decode"]
    per_step = collections.Counter()
    for e in ev:
        if e["ph"] == "X" and e["name"] in ("mla.attend", "model.dense"):
            for i, (a, b) in enumerate(decodes):
                if a <= e["ts"] and e["ts"] + e["dur"] <= b:
                    per_step[(i, e["name"])] += 1
    assert {n for (_, name), n in per_step.items()
            if name == "mla.attend"} == {4}
    assert {n for (_, name), n in per_step.items()
            if name == "model.dense"} == {1}


def test_peak_pages_counter():
    """The peak counts pages held by slots and parked in the prefix cache
    together: after two requests on one document, the second holding 2
    new pages beside the first's 5 parked prompt pages, 7 of the pool's
    14; it never falls, each chunk span carries it with the pool's size,
    and the metrics snapshot exports it."""
    cfg, model, pol = _prepared("2t")
    eng = PagedEngine(cfg, model, n_slots=2, page_size=16, chunk_size=32,
                      max_prompt_len=96, max_new_tokens=8, policy=pol,
                      device="cpu")
    gen = GenerationConfig(max_new_tokens=8, temperature=0.0, eos_token=-1)
    a, b = _doc_prompts()
    eng.generate([a], gen)
    assert eng.pages_peak == 6
    eng.generate([b], gen)
    assert eng.pages_peak == 7 and eng.n_pages - 1 == 14
    chunks = [e["args"] for e in eng.tracer.events()
              if e["ph"] == "X" and e["name"] == "prefill_chunk"]
    assert [c["pages_peak"] for c in chunks] == [6, 6, 6, 7]
    assert {c["pool_pages"] for c in chunks} == {14}
    snap = eng.metrics()
    assert snap.gauges["repro_page_pool_pages_peak"] == 7


# ---------------------------------------------------------------------------
# the GQA paged path as it was
# ---------------------------------------------------------------------------

def test_gqa_paged_tokens_unchanged():
    """Reduced Qwen3 (GQA) through the paged engine under 2T, three
    prompts on one 48-token prefix: the tokens the engine served before
    the paged latent cache existed, and the same prefix hits."""
    cfg = get_config("qwen3-moe-30b-a3b").reduced()
    model = M.init_params(cfg, seed=3, device="cpu")
    calib = torch.randn((128, cfg.d_model),
                        generator=torch.Generator().manual_seed(4))
    _, pol = make_policy("2t", cfg.dualsparse,
                         drop_target=0.25).prepare(model, cfg, calib)
    eng = PagedEngine(cfg, model, n_slots=2, page_size=16, chunk_size=32,
                      max_prompt_len=96, max_new_tokens=6, policy=pol,
                      device="cpu")
    rng = np.random.default_rng(5)
    doc = rng.integers(1, cfg.vocab_size, 48).astype(np.int32)
    prompts = [np.concatenate([doc, rng.integers(1, cfg.vocab_size, n)
                               .astype(np.int32)]) for n in (30, 7, 40)]
    got = [r.tokens for r in eng.generate(prompts,
                                          GenerationConfig(max_new_tokens=6))]
    assert got == [[460, 393, 229, 329, 229, 329],
                   [105, 204, 393, 182, 460, 460],
                   [182, 460, 460, 460, 460, 460]]
    assert eng.prefix_hits == 3
