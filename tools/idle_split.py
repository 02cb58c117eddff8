"""The card's idle time put down to the program's layers, for one cell of
the benchmark:

    python3 tools/idle_split.py --workload qwen3-30b-a3b.chat --seed 7 \
        [--seconds 50]

from the root of a checkout, on a machine with the cell's card(s). Runs
the cell's traced window through the benchmark's harness (the last part
under ``torch.profiler``, as ``perfbench/run.py --trace 1`` does) and
splits the idle gaps of the profiled part by the innermost
``record_function`` range open at each gap's middle, aten ops ignored.
While the profiler records, every span of the program's tracer
(``repro_torch.obs.tracing``, named ``<layer>.<part>``) is such a range,
so each gap goes to the layer whose host work held the card idle; the
gaps are those the benchmark's ``device_idle_pct`` counts. Prints one
JSON object: ``device_idle_pct``, ``idle_pct`` per layer (``moe``,
``model``, ``scheduler``: the range named so or ``<layer>.*``, and for
``model`` MLA's ``mla.*`` parts too) and per
range, each as a share of the profiled window. Skips the comparison with
the reference."""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Dict, List  # noqa: E402

import numpy as np  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from perfbench.harness import trace  # noqa: E402

RANGE_CAT = "user_annotation"
NO_RANGE = "host: no range open"
LAYERS = ("moe", "model", "scheduler")
# the range-name prefixes each layer's idle is read under: MLA's parts
# (``mla.latent``, ``mla.attend``) open inside ``model.attention``
PREFIXES = {"moe": ("moe",), "model": ("model", "mla"),
            "scheduler": ("scheduler",)}


def idle_by_range(events: List[Dict]) -> Dict[str, float]:
    """Idle seconds of the card per innermost ``record_function`` range
    open at each idle gap's middle (aten ops ignored); the gaps and the
    window are those of ``trace.summarize_events``. Every range in the
    trace is a key, 0.0 if it held no gap; gaps under no range go to
    ``NO_RANGE``. Empty when no device work was recorded."""
    dev, edges, ranges = [], [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat = e.get("cat", "")
        t0, t1 = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        if cat in trace.DEVICE_CATS:
            dev.append((t0, t1))
        elif cat in trace.HOST_CATS:
            edges.append((t0, t1))
        if cat == RANGE_CAT:
            ranges.append((t0, t1, e.get("name", "?")))
    if not dev:
        return {}
    merged = trace.union_intervals(np.asarray(dev))
    lo = min([merged[0, 0]] + [a for a, _ in edges])
    hi = max([merged[-1, 1]] + [b for _, b in edges])
    starts = np.concatenate([[lo], merged[:, 1]])
    ends = np.concatenate([merged[:, 0], [hi]])
    keep = ends > starts
    starts, ends = starts[keep], ends[keep]
    mids = (starts + ends) / 2
    inner = np.full(len(mids), NO_RANGE, dtype=object)
    # at equal starts the longer (outer) range first, the inner one wins
    for t0, t1, name in sorted(ranges, key=lambda r: (r[0], -r[1])):
        a, b = np.searchsorted(mids, [t0, t1])
        inner[a:b] = name
    out = {name: 0.0 for _, _, name in ranges}
    for name, s, e in zip(inner, starts, ends):
        out[name] = out.get(name, 0.0) + (e - s) / 1e6
    return out


def idle_in(split: Dict[str, float], layer: str):
    """Idle seconds under the ranges named ``p`` or ``p.<part>`` for the
    layer's prefixes ``p`` (``PREFIXES``: the layer's own name, and for
    ``model`` also ``mla``); None when the trace holds no such range."""
    names = [k for k in split for p in PREFIXES.get(layer, (layer,))
             if k == p or k.startswith(p + ".")]
    return sum(split[k] for k in names) if names else None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=50.0)
    args = ap.parse_args(argv)
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(ROOT / "build" / "perfbench-cache" / sub)

    import torch
    from perfbench.harness import cell as C, spec

    split: Dict[str, float] = {}
    summarize_file = trace.summarize_file

    def keep_split(path):
        with open(path) as f:
            data = json.load(f)
        split.update(idle_by_range(
            data["traceEvents"] if isinstance(data, dict) else data))
        return summarize_file(path)

    # the harness reads the exported trace and deletes it: read it too
    trace.summarize_file = keep_split
    c = spec.cell(spec.load_benchmark(), args.workload)
    device = torch.device("cuda", 0)
    log = lambda s: print(f"[idle_split] {s}", file=sys.stderr, flush=True)
    prog = C.setup(c, args.seed, device, T_START, log)
    rec = C.measure(prog, c, c.traffic, args.seed, args.seconds, True,
                    device, log)
    if rec.trace is None or rec.profiled_s <= 0:
        log("no device work was profiled")
        return 1
    pct = lambda s: 100.0 * s / rec.profiled_s
    layers = {k: idle_in(split, k) for k in LAYERS}
    print(json.dumps({
        "workload": args.workload, "seed": args.seed,
        "device": torch.cuda.get_device_name(device),
        "profiled_s": rec.profiled_s,
        "device_idle_pct": 100.0 * (1.0 - rec.trace.busy_s / rec.profiled_s),
        "idle_pct": {k: None if v is None else pct(v)
                     for k, v in layers.items()},
        "idle_pct_by_range": {k: pct(v) for k, v in sorted(
            split.items(), key=lambda kv: -kv[1])}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
