"""One harness run end to end on the CPU at a tiny size (the look for a
card skipped), for each engine; the same run with the timed path broken
underneath comes out not correct; and the control (the reference with
TF32 products in the program's place, and with an fp8 KV cache as well)
fails the comparison."""
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path[:0] = [str(Path(__file__).resolve().parents[2]),
                str(Path(__file__).resolve().parents[2] / "src")]

from perfbench.harness import cell as C, check, spec  # noqa: E402
from perfbench.tests import tiny  # noqa: E402

SEED = 2 ** 31 + 777


@pytest.fixture(autouse=True)
def _few_threads():
    """Two threads: the file runs beside other test files on a shared
    machine (the window's clock is virtual, so speed changes nothing
    else)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
SECONDS = 4.0
MIXES = {"chat": tiny.CHAT, "long": tiny.LONG}


def _run(mix):
    c = tiny.cell(mix)
    return C.run(c, SEED, SECONDS, False, "cpu", time.perf_counter(),
                 clocked=tiny.VirtualTime())


@pytest.mark.parametrize("kind", ["chat", "long"])
def test_run_end_to_end_on_cpu(kind):
    metrics, verdict, extra = _run(MIXES[kind])
    assert all(v["ok"] for v in verdict.values()), verdict
    assert extra["failed"] == 0 and extra["attempted"] > 5
    for name in ("output_tok_s", "setup_s", "itl_p95_ms"):
        assert metrics[name]["value"] > 0


def _alter_tokens(monkeypatch):
    from repro_torch.serving import engine
    orig = engine.SlotEngineBase._decode_call
    state = {"n": 0}

    def altered(self, **kw):
        logits, toks = orig(self, **kw)
        state["n"] += 1
        if state["n"] % 5 == 0:
            toks = (toks + 1) % self.cfg.vocab_size
        return logits, toks
    monkeypatch.setattr(engine.SlotEngineBase, "_decode_call", altered)


def _state_unchanged(monkeypatch):
    from repro_torch.models import attention
    for layout in (attention.PagedLayout, attention.ContiguousLayout):
        monkeypatch.setattr(layout, "append",
                            lambda self, cache, *a, **k: cache)


def _half_batch(monkeypatch):
    from repro_torch.core import moe
    orig = moe.moe_forward_dispatch

    def half(params, x, cfg, *a, **kw):
        out = orig(params, x, cfg, *a, **kw)
        y = out[0] if isinstance(out, tuple) else out
        keep = torch.arange(x.shape[0]) % 2 == 0     # every other row
        y = y * keep[:, None].to(y.dtype)
        return (y,) + tuple(out[1:]) if isinstance(out, tuple) else y
    monkeypatch.setattr(moe, "moe_forward_dispatch", half)


FAULTS = {"token_altered": _alter_tokens, "state_unchanged": _state_unchanged,
          "half_batch_left_out": _half_batch}


@pytest.mark.parametrize("kind", ["chat", "long"])
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_broken_timed_path_is_not_correct(monkeypatch, fault, kind):
    FAULTS[fault](monkeypatch)
    _, verdict, _ = _run(MIXES[kind])
    assert not verdict["mean_logit_gap"]["ok"], verdict


@pytest.mark.parametrize("precision", ["tf32", "lower"])
@pytest.mark.parametrize("kind", ["chat", "long"])
def test_control_fails_the_comparison(kind, precision):
    """Many teacher-forced positions (seeded prompts and tokens) through
    the reference and its control (TF32 products; "lower": an fp8 KV cache
    as well): the control's verdict under the tiny cell's limits is not
    correct."""
    mix = MIXES[kind]
    conf = tiny.CONFIG
    rng = np.random.default_rng(5)
    picks = []
    for _ in range(64):
        p = rng.integers(1, 512, int(rng.integers(16, 80)), dtype=np.int32)
        s = check.Served(due_s=0.0, prompt=p, n_out=48)
        s.tokens = rng.integers(1, 512, 48).tolist()
        picks.append(s)
    readings = check.control(spec.reference_class(conf), conf["dims"],
                             conf["serving"], SEED, "cpu", picks,
                             mix["engine"]["kind"], precision=precision)
    assert readings["compared"] > 1000
    verdict = check.verdict(readings, 0, tiny.LIMITS)
    assert not verdict["mean_logit_gap"]["ok"]


def test_per_layer_readers_on_a_cpu_record():
    """The readers that need no device trace read a CPU run's record."""
    c = tiny.cell(tiny.CHAT)
    prog = C.setup(c, SEED, "cpu", time.perf_counter())
    rec = C.measure(prog, c, c.traffic, SEED, SECONDS, False, "cpu",
                    clocked=tiny.VirtualTime())
    read = {m: spec.reader(m)(rec) for m in
            ("prefix_hit_pct", "decode_step_ms.chat", "mfu_pct.chat",
             "ttft_p95_ms.chat", "ttft_p50_ms.chat",
             "fused_moe_pipeline_roofline.chat",
             "device_idle_pct.chat")}
    assert 0 < read["prefix_hit_pct"] <= 100
    assert read["decode_step_ms.chat"] > 0 and read["ttft_p95_ms.chat"] > 0
    assert 0 < read["ttft_p50_ms.chat"] <= read["ttft_p95_ms.chat"]
    assert 0 < read["mfu_pct.chat"]
    assert read["fused_moe_pipeline_roofline.chat"] is None
    assert read["device_idle_pct.chat"] is None
    long_c = tiny.cell(tiny.LONG, "tiny.long")
    rec = C.measure(prog, long_c, long_c.traffic, SEED, SECONDS, False,
                    "cpu", clocked=tiny.VirtualTime())
    assert spec.reader("prefill_ms_per_ktok.long")(rec) > 0
    assert 0 < spec.reader("moe_drop_pct.long")(rec) < 100
    assert spec.reader("mfu_pct.long")(rec) > 0
    assert spec.reader("ttft_p95_ms.saturated")(rec) > 0
    assert spec.reader("itl_p95_ms.saturated")(rec) > 0
    assert spec.reader("prefix_hit_pct")(rec) is None
