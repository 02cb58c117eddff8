"""The port's span tracing (``repro_torch.obs.tracing``) on the CPU at a
tiny size: the span tree of one paged and one continuous step (engine
spans, scheduler / model / MoE layer spans, one ``moe`` with its four
children per MoE layer per forward), the counts and device times the
prefill spans carry, ``record_function`` ranges only while a profiler
records (and then nested inside the step in its trace), no drops at the
benchmark's busiest span count, the pending device timers, and a
disabled tracer recording nothing."""
import collections
import dataclasses
import json

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.models import model as M
from repro_torch.models import transformer
from repro_torch.obs import tracing
from repro_torch.serving import (ContinuousBatchingEngine, GenerationConfig,
                                 PagedEngine)

CHUNK = 16
MAX_PROMPT = 32
MOE_PARTS = ("moe.route", "moe.plan", "moe.kernel", "moe.stats")


@pytest.fixture(scope="module")
def tiny():
    torch.manual_seed(0)
    cfg = dataclasses.replace(get_config("qwen3-moe-30b-a3b").reduced(),
                              d_model=64, d_ff=64, d_expert=32,
                              vocab_size=128)
    return cfg, M.init_params(cfg, seed=0, device="cpu")


def _engine(tiny, kind, **kw):
    cfg, model = tiny
    if kind == "paged":
        return PagedEngine(cfg, model, n_slots=2, page_size=8,
                           chunk_size=CHUNK, max_prompt_len=MAX_PROMPT,
                           max_new_tokens=4, device="cpu", **kw)
    return ContinuousBatchingEngine(cfg, model, n_slots=2,
                                    max_prompt_len=MAX_PROMPT,
                                    max_new_tokens=4, device="cpu", **kw)


def _prompt(n, seed=0):
    return np.random.default_rng(seed).integers(0, 128, n).astype(np.int32)


def _tree(events):
    """(event, parent name) of every span, the parent being the innermost
    span that encloses it."""
    spans = sorted((e for e in events if e["ph"] == "X"),
                   key=lambda e: (e["ts"], -e["dur"]))
    out, stack = [], []
    for e in spans:
        while stack and e["ts"] >= stack[-1]["ts"] + stack[-1]["dur"]:
            stack.pop()
        out.append((e, stack[-1]["name"] if stack else None))
        stack.append(e)
    return out


def _forward_children(tree, n_layers):
    """Checks one forward's layer spans under their parents."""
    parents = collections.Counter((e["name"], p) for e, p in tree)
    assert parents[("moe", None)] == 0
    n_moe = sum(n for (name, _), n in parents.items() if name == "moe")
    assert n_moe == n_layers
    for part in MOE_PARTS:
        assert parents[(part, "moe")] == n_layers, part
    assert sum(n for (name, _), n in parents.items()
               if name == "model.attention") == n_layers
    return parents


def test_paged_step_span_tree(tiny):
    """A step that carries a prompt's second chunk and a decode: every
    layer span sits inside its engine span, one ``moe`` with its four
    children per layer per forward."""
    cfg, _ = tiny
    eng = _engine(tiny, "paged")
    eng.submit(_prompt(CHUNK + 4), GenerationConfig(max_new_tokens=3))
    eng.step()                              # first chunk
    eng.tracer.clear()
    eng.step()                              # last chunk + first decode
    tree = _tree(eng.tracer.events())
    roots = [e["name"] for e, p in tree if p is None]
    assert roots == ["step"]
    step_children = [e["name"] for e, p in tree if p == "step"]
    assert step_children == ["scheduler.admit", "prefill_chunk",
                             "scheduler.readback", "scheduler.emit",
                             "decode", "scheduler.emit"]
    for parent in ("prefill_chunk", "decode"):
        inside = _subtree(tree, parent)
        _forward_children(inside, cfg.n_layers)
        names = collections.Counter(e["name"] for e, _ in inside)
        assert names["scheduler.inputs"] == 1
        assert names["model.embed"] == 1 and names["model.stats"] == 1
        assert names["model.head"] == 2    # the model's, then the engine's
    decode = _subtree(tree, "decode")
    assert [e["name"] for e, p in decode if p == "decode"][-1] == \
        "scheduler.readback"


def _subtree(tree, root):
    """The spans inside the first span named ``root``."""
    top = next(e for e, _ in tree if e["name"] == root)
    end = top["ts"] + top["dur"]
    return [(e, p) for e, p in tree
            if e is not top and top["ts"] <= e["ts"] and
            e["ts"] + e["dur"] <= end]


def test_continuous_step_span_tree(tiny):
    cfg, _ = tiny
    eng = _engine(tiny, "continuous")
    eng.submit(_prompt(12), GenerationConfig(max_new_tokens=3))
    eng.step()                              # prefill-insert + decode
    tree = _tree(eng.tracer.events())
    assert [e["name"] for e, p in tree if p == "step"] == \
        ["scheduler.admit", "decode", "scheduler.emit"]
    admit = _subtree(tree, "scheduler.admit")
    assert [e["name"] for e, p in admit if p == "scheduler.admit"] == \
        ["prefill_insert", "scheduler.emit"]
    prefill = _subtree(tree, "prefill_insert")
    _forward_children(prefill, cfg.n_layers)
    assert [e["name"] for e, p in prefill if p == "prefill_insert"] == \
        ["scheduler.inputs", "model.embed"] + \
        ["model.attention", "moe"] * cfg.n_layers + \
        ["model.stats", "model.head", "scheduler.insert", "model.head",
         "scheduler.readback"]
    _forward_children(_subtree(tree, "decode"), cfg.n_layers)


@pytest.mark.parametrize("kind", ["paged", "continuous"])
def test_prefill_spans_carry_positions_and_device_time(tiny, kind):
    eng = _engine(tiny, kind)
    plen = CHUNK + 4
    eng.submit(_prompt(plen), GenerationConfig(max_new_tokens=2))
    eng.drain()
    name = "prefill_chunk" if kind == "paged" else "prefill_insert"
    spans = [e for e in eng.tracer.events() if e["name"] == name]
    assert spans
    rows = CHUNK if kind == "paged" else MAX_PROMPT
    for e in spans:
        assert e["args"]["positions"] == rows
        # on the CPU ops run synchronously: the device time is the span's
        # own host time
        assert e["args"]["device_s"] > 0
        assert e["args"]["device_s"] == pytest.approx(e["dur"] / 1e6,
                                                      rel=1e-9)
    carried = sum(e["args"]["n_tokens" if kind == "paged" else "prompt_len"]
                  for e in spans)
    assert carried == plen


def test_no_record_function_without_a_profiler(tiny, monkeypatch):
    opened = []
    real = torch.profiler.record_function

    def counting(name, *a, **kw):
        opened.append(name)
        return real(name, *a, **kw)
    monkeypatch.setattr(torch.profiler, "record_function", counting)
    eng = _engine(tiny, "paged")
    eng.submit(_prompt(CHUNK + 4), GenerationConfig(max_new_tokens=2))
    eng.drain()
    assert len(eng.tracer.events()) > 50 and opened == []
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        eng.submit(_prompt(CHUNK + 4, 1), GenerationConfig(max_new_tokens=2))
        eng.drain()
    assert "moe.route" in opened and "step" in opened


def test_profiled_spans_nest_inside_the_step(tiny, tmp_path):
    """Under ``torch.profiler`` each span is a ``user_annotation`` range of
    the same name on the profiler's clock, inside the step's range."""
    eng = _engine(tiny, "paged")
    eng.submit(_prompt(CHUNK + 4), GenerationConfig(max_new_tokens=2))
    eng.step()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        eng.step()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    ranges = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("cat") == "user_annotation"]
    names = collections.Counter(e["name"] for e in ranges)
    spans = collections.Counter(e["name"] for e in eng.tracer.events()
                                if e["ph"] == "X" and
                                e["ts"] >= _last_step_ts(eng))
    assert names == spans
    step = next(e for e in ranges if e["name"] == "step")
    t0, t1 = step["ts"], step["ts"] + step["dur"]
    for e in ranges:
        assert t0 <= e["ts"] and e["ts"] + e["dur"] <= t1, e["name"]


def _last_step_ts(eng):
    return max(e["ts"] for e in eng.tracer.events() if e["name"] == "step")


def _spans_per_forward(tiny, n_layers):
    """Spans of one decode step (its step span included) at ``n_layers``
    MoE layers, from a tiny engine's counts: what a layer adds and what
    the step adds besides."""
    eng = _engine(tiny, "continuous")
    eng.submit(_prompt(8), GenerationConfig(max_new_tokens=4))
    eng.step()
    eng.tracer.clear()
    eng.step()                              # a decode step alone
    names = collections.Counter(e["name"] for e in eng.tracer.events()
                                if e["ph"] == "X")
    cfg, _ = tiny
    per_layer = names["model.attention"] + names["moe"] + sum(
        names[p] for p in MOE_PARTS)
    assert per_layer == 6 * cfg.n_layers
    return sum(names.values()) - per_layer + 6 * n_layers


def test_no_drops_at_the_busiest_cells_span_count(tiny):
    """600 forwards at Qwen3-30B-A3B's 24 benchmarked layers (about a
    50 s window of its chat cell) fit an engine's tracer with room."""
    per_forward = _spans_per_forward(tiny, 24)
    assert 150 <= per_forward <= 160
    eng = _engine(tiny, "paged")
    tracer = eng.tracer
    with tracing.active(tracer):
        for _ in range(600 * per_forward):
            with tracing.layer("moe.route"):
                pass
    assert tracer.dropped == 0
    assert len(tracer.events()) == 600 * per_forward
    assert tracer.max_events >= 3 * 600 * per_forward


def test_drops_are_counted():
    tracer = tracing.SpanTracer(max_events=10)
    with tracing.active(tracer):
        for _ in range(15):
            with tracing.layer("model.embed"):
                pass
    tracer.instant("submit", uid=0)
    assert len(tracer.events()) == 10 and tracer.dropped == 6
    assert tracer.chrome_trace()["otherData"]["dropped_events"] == 6


class _FakeEvent:
    """A CUDA event's completion, as ``query`` / ``synchronize`` see it."""

    def __init__(self, log):
        self.done = False
        self.log = log

    def query(self):
        return self.done

    def synchronize(self):
        self.log.append("synchronize")
        self.done = True

    def elapsed_time(self, end):
        assert end.done, "elapsed_time on an event not yet complete"
        return 12.5                       # ms


def test_device_timers_resolve_only_once_complete():
    log = []
    tracer = tracing.SpanTracer()
    with tracer.span("prefill_chunk", uid=0):
        pass
    args = tracer._events[-1][3]
    start, end = _FakeEvent(log), _FakeEvent(log)
    tracer._pending.append((args, (start, end)))
    tracer.resolve()                        # what a step does: no wait
    assert "device_s" not in args and log == []
    end.done = True
    tracer.resolve()
    assert args["device_s"] == 0.0125 and not tracer._pending
    end2 = _FakeEvent(log)
    tracer._pending.append((args, (start, end2)))
    assert tracer.events()[0]["args"]["device_s"] == 0.0125
    assert log == ["synchronize"] and not tracer._pending


def test_disabled_tracer_records_nothing(tiny):
    eng = _engine(tiny, "paged", metrics=False)
    eng.submit(_prompt(CHUNK + 4), GenerationConfig(max_new_tokens=2))
    eng.drain()
    assert eng.tracer.events() == [] and eng.tracer.dropped == 0
    off = tracing.SpanTracer(enabled=False)
    assert off.layer("moe") is off.span("step", uid=1) is \
        tracing.null_tracer().layer("moe")


def test_outside_a_step_the_current_tracer_is_disabled(tiny):
    """A forward called outside an engine's step (training, kernel
    benchmarks) records nowhere: the current tracer is the disabled one,
    and an engine's tracer is current only inside its step."""
    cfg, model = tiny
    eng = _engine(tiny, "continuous")
    noop = tracing.null_tracer().layer("moe")
    assert tracing.layer("moe") is noop
    with torch.no_grad():
        transformer.forward(model, {"tokens": torch.zeros(
            (1, 8), dtype=torch.long)}, cfg)
    assert eng.tracer.events() == []
    real = eng._step

    def probed():
        with tracing.layer("scheduler.probe"):
            return real()
    eng._step = probed
    eng.submit(_prompt(8), GenerationConfig(max_new_tokens=1))
    eng.step()
    assert [e["name"] for e in eng.tracer.events()].count(
        "scheduler.probe") == 1
    assert tracing.layer("moe") is noop
