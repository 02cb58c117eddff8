"""One run of one cell: set-up (the model made from the seed, the
preparation under the configuration's policy, every step shape warmed),
the measured window, the metrics, then — the window closed, the peak
memory read and the program freed — the comparison with the plain
reference.

With ``trace`` the last part of the window runs under ``torch.profiler``;
the readings that come from the host clock, the spans and the counters
are then taken over the part before it, and the device readings over the
profiled part."""
from __future__ import annotations

import dataclasses
import gc
import os
import tempfile
import time
from typing import Callable, Dict, List, Optional

import torch

from . import check, driver, program, spec, stats, traffic
from . import trace as trace_mod
from . import weights as W

PROFILE_S = 5.0


@dataclasses.dataclass
class RunRecord:
    """What the metric readers read."""
    dims: Dict
    window_s: float                 # the whole measured window
    main_s: float                   # the part read by host-side readings
    served: List[stats.Served]
    spans: List[tuple]              # (name, start s, duration s, args)
    counters: Dict[str, float]      # at main_s
    setup_s: float
    trace: Optional[trace_mod.TraceSummary] = None
    profiled_s: float = 0.0
    fused_calls: List = dataclasses.field(default_factory=list)

    def main_spans(self, name: str) -> List[tuple]:
        """The spans named ``name``; in a traced run only those that ended
        before the profiler opened."""
        return [s for s in self.spans if s[0] == name and (
            self.trace is None or s[1] + s[2] <= self.main_s)]


class TraceHooks(driver.Hooks):
    """Opens the profiler (and the fused-call probe) between steps once
    the clock passes ``start_s``; ``close`` ends both."""

    def __init__(self, start_s: float, engine, device):
        self.start_s = start_s
        self.engine = engine
        self.device = device
        self.prof = None
        self.probe = None
        self.calls: List = []
        self.t_open = 0.0
        self.open_at = None
        self.counters = None

    def between_steps(self, now_s: float) -> None:
        if self.prof is not None or now_s < self.start_s:
            return
        from torch.profiler import ProfilerActivity, profile
        self.counters = program.counters(self.engine)
        self.open_at = now_s
        torch.cuda.synchronize(self.device)
        self.probe = program.fused_calls(self.calls)
        self.probe.__enter__()
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.t_open = time.perf_counter()

    def step(self, engine) -> None:
        if self.prof is None:
            return engine.step()
        with torch.profiler.record_function("engine.step"):
            engine.step()

    def wait(self, seconds: float) -> None:
        if self.prof is None:
            return time.sleep(seconds)
        with torch.profiler.record_function("harness.wait_for_arrival"):
            time.sleep(seconds)

    def close(self):
        """(trace summary, profiled seconds) or (None, 0)."""
        if self.prof is None:
            return None, 0.0
        torch.cuda.synchronize(self.device)
        profiled = time.perf_counter() - self.t_open
        self.prof.__exit__(None, None, None)
        self.probe.__exit__(None, None, None)
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            summary = trace_mod.summarize_file(path)
        finally:
            os.unlink(path)
        self.prof = None
        return summary, profiled


def set_precision() -> None:
    """The configurations' arithmetic: float32 products in float32 (no
    TF32), and bf16 products (attention over the bf16 KV cache) summed in
    float32, with no reduced-precision partial sums."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction = False


def warm_profiler(device) -> None:
    """One tiny profiled op, so that the profiler's own start-up (CUPTI)
    is paid before the window, not inside it."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.ones(8, device=device).sum().item()


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


@dataclasses.dataclass
class Program:
    """The program set up for a cell: its config, the prepared model and
    the calibrated policy."""
    cfg: object
    model: object
    policy: object
    setup_s: float


def setup(cell: spec.Cell, seed: int, device, t_start: float,
          log: Callable[[str], None] = lambda s: None) -> Program:
    """The model made from the seed, the preparation under the file's
    policy (2T, or none for keep-all) and every step shape the mix uses
    warmed, through a first engine that is then dropped."""
    conf, mix = cell.config, cell.traffic
    dims, serving = conf["dims"], conf["serving"]
    set_precision()
    cfg = program.port_config(conf)
    model = program.build_model(cfg, dims, seed, device)
    # calibration activations for a policy that profiles and calibrates
    calib = W.calibration(dims, serving["calibration_tokens"], seed,
                          device) if "calibration_tokens" in serving else None
    policy = program.prepare(model, cfg, serving, calib)
    del calib
    warm = program.make_engine(cfg, model, policy, mix["engine"], device)
    for r in traffic.warmup_requests(mix, seed, dims["vocab_size"]):
        warm.submit(r.prompt, program.generation(r.n_out))
    warm.drain()
    del warm
    sync(device)
    setup_s = time.perf_counter() - t_start
    log(f"set-up {setup_s:.3f} s")
    return Program(cfg, model, policy, setup_s)


def measure(prog: Program, cell: spec.Cell, mix: Dict, seed: int,
            seconds: float, trace: bool, device,
            log: Callable[[str], None] = lambda s: None,
            clocked: Optional[driver.Hooks] = None) -> RunRecord:
    """One window of ``mix`` on a fresh engine. ``clocked``: hooks that
    also keep the window's clock (``clocked.clock``), for tests that must
    not depend on the speed of the machine."""
    dims = cell.config["dims"]
    reqs = traffic.generate(mix, seed, seconds, dims["vocab_size"])
    if trace:
        warm_profiler(device)
    engine = program.make_engine(prog.cfg, prog.model, prog.policy,
                                 mix["engine"], device)
    hooks = TraceHooks(max(0.0, seconds - PROFILE_S), engine, device) \
        if trace else (clocked or driver.Hooks())
    engine.tracer.clear()
    served = driver.drive(engine, reqs, seconds,
                          lambda r: program.generation(r.n_out), hooks,
                          **({"clock": clocked.clock} if clocked else {}))
    sync(device)
    summary, profiled = hooks.close() if trace else (None, 0.0)
    opened = trace and hooks.open_at is not None
    record = RunRecord(
        dims=dims, window_s=seconds,
        main_s=hooks.open_at if opened else seconds, served=served,
        spans=program.spans(engine),
        counters=hooks.counters if opened else program.counters(engine),
        setup_s=prog.setup_s, trace=summary, profiled_s=profiled,
        fused_calls=hooks.calls if trace else [])
    late = stats.lateness(served)
    ttft = stats.ttft_samples(served, record.main_s)
    log(f"window {seconds} s at {mix['rate_per_s']} requests/s: "
        f"{len(reqs)} offered, {len(late)} submitted, "
        f"{stats.tokens_in_window(served, seconds)} tokens, "
        f"{engine.queued} queued at the close, clock late by at most "
        f"{max(late) if late else 0.0:.6f} s; TTFT mean "
        f"{sum(ttft) / max(1, len(ttft))!r} s, p50 "
        f"{stats.percentile(ttft, 50)!r} s, p95 "
        f"{stats.percentile(ttft, 95)!r} s")
    return record


def free(prog: Program, device) -> None:
    prog.model = prog.policy = None
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def verify(cell: spec.Cell, record: RunRecord, seed: int, device,
           log: Callable[[str], None] = lambda s: None):
    """(readings, verdict) of the comparison with the plain reference."""
    conf, mix = cell.config, cell.traffic
    attempted = [s for s in record.served if s.submitted_s is not None]
    failed = sum(1 for s in attempted if s.failed)
    picks = check.sample(record.served, record.window_s,
                         mix["check"]["requests"], seed)
    t0 = time.perf_counter()
    readings = check.compare(spec.reference_class(conf), conf["dims"],
                             conf["serving"], seed, device, picks,
                             mix["engine"]["kind"])
    log(f"reference: {len(picks)} requests, {readings['compared']} "
        f"positions compared, {readings['excluded']} left out as "
        f"ambiguous, {time.perf_counter() - t0:.3f} s; widest gap "
        f"{readings['max_logit_gap']!r}, share of served tokens not the "
        f"reference's best {readings.get('mismatch_share')!r}; widest "
        f"[gap, threshold margin, top-k margin]: {readings.get('widest')}")
    return readings, check.verdict(readings, failed, cell.limits)


def run(cell: spec.Cell, seed: int, seconds: float, trace: bool, device,
        t_start: float, log: Callable[[str], None] = lambda s: None,
        clocked: Optional[driver.Hooks] = None):
    """Returns (metrics {name: {value, unit}}, check verdict, extra):
    extra holds the request counts, the device facts and, traced, the
    breakdown."""
    device = torch.device(device)
    prog = setup(cell, seed, device, t_start, log)
    record = measure(prog, cell, cell.traffic, seed, seconds, trace, device,
                     log, clocked)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = spec.reader(m["name"])(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    attempted = [s for s in record.served if s.submitted_s is not None]
    extra = {"attempted": len(attempted),
             "failed": sum(1 for s in attempted if s.failed)}
    if device.type == "cuda":
        extra["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated(
            device))
    if record.trace is not None:
        extra["busy_s"] = record.trace.busy_s
        extra["window_s"] = record.profiled_s
        extra["breakdown"] = record.trace.breakdown()
    record.fused_calls = []
    free(prog, device)
    _, verdict = verify(cell, record, seed, device, log)
    return metrics, verdict, extra
