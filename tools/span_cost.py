"""What a span of ``repro_torch.obs.tracing`` costs on this host.

    python3 tools/span_cost.py [--n 200000]

Times, per span, on the host clock: a layer span on an enabled tracer
with no profiler recording, the shared no-op of the disabled tracer, an
engine span with args, the same three while ``torch.profiler`` records
(each span then also opens a ``record_function`` range), and the bare
``record_function`` range with no profiler, which the spans never open
then. Prints one JSON object. A span's cost is paid on the host; on a
host-bound step it adds to the step's time."""
from __future__ import annotations

import argparse
import json
import platform
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402

from repro_torch.obs import tracing  # noqa: E402


def per_span_us(make, n: int) -> float:
    """Median over 5 repeats of the µs one ``with make():`` costs."""
    reps = []
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(n):
            with make():
                pass
        reps.append((time.perf_counter() - t0) / n * 1e6)
    return sorted(reps)[2]


def cases(tracer, n: int):
    """(name, µs per span) of the three kinds of span."""
    with tracing.active(tracer):
        yield "layer", per_span_us(lambda: tracing.layer("moe.route"), n)
    yield "disabled", per_span_us(lambda: tracing.layer("moe.route"), n)
    yield "engine_span", per_span_us(
        lambda: tracer.span("prefill_chunk", uid=1, slot=2, start=0,
                            n_tokens=256, positions=256), n)


def measure(n: int) -> dict:
    """µs per span; under the profiler over a twentieth as many spans,
    which it records in memory."""
    tracer = tracing.SpanTracer(max_events=15 * n)
    out = dict(cases(tracer, n))
    tracer.clear()
    out["record_function_unprofiled"] = per_span_us(
        lambda: torch.profiler.record_function("moe.route"), n // 20)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts):
        for name, us in cases(tracer, n // 20):
            out[name + "_profiled"] = us
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=200_000)
    args = ap.parse_args(argv)
    result = {"host": platform.processor() or platform.machine(),
              "python": platform.python_version(),
              "torch": torch.__version__, "n": args.n,
              "us_per_span": measure(args.n)}
    if torch.cuda.is_available():
        result["device"] = torch.cuda.get_device_name(0)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
