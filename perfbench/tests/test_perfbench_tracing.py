"""The readings the program's own spans feed: the idle seconds per
innermost program range that ``tools/idle_split.py`` takes from a trace
(on a fixed event list, beside the trace reader's own readings, pinned),
the readers of the layer metrics on synthetic records (None where there
is nothing to read), and a tiny CPU run of each engine whose spans feed
``moe_host_ms``, ``chunk_ms`` and ``prefill_pad_pct``."""
import sys
import time
from pathlib import Path

import pytest
import torch

sys.path[:0] = [str(Path(__file__).resolve().parents[2]),
                str(Path(__file__).resolve().parents[2] / "src")]

from perfbench.harness import cell as C, spec, trace  # noqa: E402
from perfbench.tests import tiny  # noqa: E402
from tools import idle_split  # noqa: E402

SEED = 2 ** 31 + 4242


def _x(name, cat, t0, t1):
    return {"ph": "X", "cat": cat, "name": name, "ts": t0, "dur": t1 - t0}


# device work (µs): [0, 20] as two overlapping kernels, [50, 60],
# [100, 110], [140, 150], [170, 180]; idle gaps [20, 50], [60, 100],
# [110, 140], [150, 170]
EVENTS = [
    _x("k_a", "kernel", 0, 10), _x("k_b", "kernel", 5, 20),
    _x("k_c", "kernel", 50, 60), _x("Memcpy HtoD", "gpu_memcpy", 100, 110),
    _x("k_d", "kernel", 140, 150), _x("k_a", "kernel", 170, 180),
    _x("engine.step", "user_annotation", 0, 120),
    _x("step", "user_annotation", 1, 119),
    _x("moe", "user_annotation", 20, 55),
    _x("moe.route", "user_annotation", 22, 40),
    _x("aten::mul", "cpu_op", 25, 30),
    _x("scheduler.readback", "user_annotation", 60, 100),
    _x("aten::copy_", "cpu_op", 61, 95),
    _x("harness.wait_for_arrival", "user_annotation", 115, 130),
    _x("moe", "gpu_user_annotation", 20, 60),
    {"ph": "i", "cat": "user_annotation", "name": "instant", "ts": 30},
]


def test_idle_put_down_to_the_innermost_program_range():
    s = trace.summarize_events(EVENTS)
    # the trace reader's readings: pinned
    assert s.busy_s == 60 / 1e6 and s.span_s == 180 / 1e6
    assert s.kernel_s == {"k_a": 10 / 1e6 + 10 / 1e6, "k_b": 15 / 1e6,
                          "k_c": 10 / 1e6, "Memcpy HtoD": 10 / 1e6,
                          "k_d": 10 / 1e6}
    assert s.idle_s == {"moe.route": 30 / 1e6, "aten::copy_": 40 / 1e6,
                        "harness.wait_for_arrival": 30 / 1e6,
                        "host: no range open": 20 / 1e6}
    assert s.breakdown(2) == {
        "device_ops": [["k_a", 20 / 1e6], ["k_b", 15 / 1e6]],
        "idle_gaps": [["aten::copy_", 40 / 1e6], ["moe.route", 30 / 1e6]]}
    # the split by program range: aten ops ignored, every range a key
    split = idle_split.idle_by_range(EVENTS)
    assert split == {
        "engine.step": 0.0, "step": 0.0, "moe": 0.0,
        "moe.route": 30 / 1e6, "scheduler.readback": 40 / 1e6,
        "harness.wait_for_arrival": 30 / 1e6,
        "host: no range open": 20 / 1e6}
    assert idle_split.idle_in(split, "moe") == 30 / 1e6
    assert idle_split.idle_in(split, "scheduler") == 40 / 1e6
    assert idle_split.idle_in(split, "model") is None
    assert sum(split.values()) == pytest.approx(
        s.span_s - s.busy_s, rel=1e-12)


def test_nested_ranges_starting_together_go_to_the_inner_one():
    events = [_x("k", "kernel", 0, 10), _x("k", "kernel", 40, 50),
              _x("model.attention", "user_annotation", 10, 40),
              _x("moe", "user_annotation", 10, 38),
              _x("moe.plan", "user_annotation", 10, 36)]
    assert idle_split.idle_by_range(events) == {
        "model.attention": 0.0, "moe": 0.0, "moe.plan": 30 / 1e6}
    assert idle_split.idle_by_range(events[2:]) == {}


def _record(spans=(), summary=None, profiled_s=0.0):
    return C.RunRecord(dims=tiny.DIMS, window_s=50.0, main_s=45.0,
                       served=[], spans=list(spans), counters={},
                       setup_s=1.0, trace=summary, profiled_s=profiled_s)


SPANS = [
    ("decode", 1.0, 0.100, {"batch": 4}),
    ("moe", 1.01, 0.002, {}), ("moe", 1.05, 0.004, {}),
    ("moe", 2.00, 0.010, {}),                      # inside no decode
    ("decode", 3.0, 0.100, {"batch": 4}),
    ("moe", 3.02, 0.003, {}),
    ("moe", 46.0, 0.050, {}),                      # after the profiler opened
    ("decode", 45.99, 0.1, {"batch": 4}),
    ("prefill_chunk", 4.0, 0.01, {"n_tokens": 256, "positions": 256,
                                  "device_s": 0.030}),
    ("prefill_chunk", 5.0, 0.01, {"n_tokens": 80, "positions": 256,
                                  "device_s": 0.050}),
    ("prefill_insert", 6.0, 0.2, {"prompt_len": 1000, "positions": 2048}),
    ("prefill_insert", 7.0, 0.2, {"prompt_len": 2048, "positions": 2048}),
]


def test_readers_on_synthetic_records():
    rec = _record(SPANS, trace.summarize_events(EVENTS), 200 / 1e6)
    read = {m: spec.reader(m)(rec) for m in (
        "moe_host_ms.chat", "chunk_ms.chat", "prefill_pad_pct.long")}
    assert read["moe_host_ms.chat"] == pytest.approx(3.0)
    assert read["chunk_ms.chat"] == pytest.approx(40.0)
    assert read["prefill_pad_pct.long"] == pytest.approx(
        100 * (4096 - 3048) / 4096)


# the parent program's records: engine spans without the new args, no
# layer spans, a trace with the harness's ranges only
PARENT_SPANS = [("decode", 1.0, 0.1, {"batch": 4}),
                ("prefill_chunk", 4.0, 0.01, {"n_tokens": 256}),
                ("prefill_insert", 6.0, 0.2, {"prompt_len": 1000})]


@pytest.mark.parametrize("metric", [
    "moe_host_ms.chat", "chunk_ms.chat", "prefill_pad_pct.long"])
def test_readers_read_none_where_nothing_is_there(metric):
    read = spec.reader(metric)
    assert read(_record()) is None
    harness_only = [e for e in EVENTS if e["cat"] != "user_annotation" or
                    e["name"] in ("engine.step", "harness.wait_for_arrival")]
    assert read(_record(PARENT_SPANS, trace.summarize_events(harness_only),
                        200 / 1e6)) is None


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_tiny_runs_feed_the_span_readers():
    """Each engine's own spans, on the CPU at a tiny size, feed the
    readers: the MoE layer's host time at decode in both, the chunks'
    device time in the paged engine, the padded prefill rows in the
    continuous one (prompts of 16-96 tokens padded to 96)."""
    chat = tiny.cell(tiny.CHAT)
    prog = C.setup(chat, SEED, "cpu", time.perf_counter())
    rec = C.measure(prog, chat, chat.traffic, SEED, 4.0, False, "cpu",
                    clocked=tiny.VirtualTime())
    assert spec.reader("moe_host_ms.chat")(rec) > 0
    assert spec.reader("chunk_ms.chat")(rec) > 0
    assert spec.reader("prefill_pad_pct.long")(rec) is None
    long_c = tiny.cell(tiny.LONG, "tiny.long")
    rec = C.measure(prog, long_c, long_c.traffic, SEED, 4.0, False, "cpu",
                    clocked=tiny.VirtualTime())
    assert spec.reader("moe_host_ms.chat")(rec) > 0
    assert spec.reader("chunk_ms.chat")(rec) is None
    pad = spec.reader("prefill_pad_pct.long")(rec)
    assert 0 < pad < 100
    inserts = rec.main_spans("prefill_insert")
    assert all(s[3]["positions"] == 96 for s in inserts)
    assert pad == pytest.approx(100 * (1 - sum(
        s[3]["prompt_len"] for s in inserts) / (96 * len(inserts))))
