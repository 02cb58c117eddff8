"""Run one cell of the benchmark on the card(s) of this machine:

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. Prints a log and, as its last lines on
standard error, each number the correctness check compared beside its
limit; the last line of standard output is the result as one JSON object.
Exits non-zero, with no result, when the card or the program is missing,
or when JAX or the JAX package got loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "build" / "perfbench-cache"


def log(msg: str) -> None:
    print(f"[perfbench] {msg}", file=sys.stderr, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    if not (ROOT / "src" / "repro_torch").is_dir():
        log(f"the program (src/repro_torch) is not in {ROOT}")
        return 3
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(CACHE / sub)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]

    import torch
    from perfbench.harness import cell as cell_mod, imports, spec

    bench = spec.load_benchmark()
    c = spec.cell(bench, args.workload)
    chips = c.workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"{args.workload} needs {chips} CUDA card(s); this machine has "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    device = torch.device("cuda", 0)
    metrics, verdict, extra = cell_mod.run(
        c, args.seed, args.seconds, bool(args.trace), device, T_START, log)

    found = imports.forbidden_loaded()
    if found:
        log(f"forbidden modules loaded: {', '.join(found)}")
        return 4
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
           "count": chips, "memory_peak_bytes": extra["memory_peak_bytes"]}
    if args.trace:
        dev["busy_s"] = extra.get("busy_s", 0.0)
        dev["window_s"] = extra.get("window_s", 0.0)
    result = {"correct": all(v["ok"] for v in verdict.values()),
              "attempted": extra["attempted"], "failed": extra["failed"],
              "metrics": metrics, "device": dev}
    if args.trace and "breakdown" in extra:
        result["breakdown"] = extra["breakdown"]
    result["check"] = {k: {"value": v["value"], "limit": v["limit"]}
                       for k, v in verdict.items()}
    for k, v in verdict.items():
        print(f"check {k}: {v['value']!r} limit {v['limit']!r} "
              f"{'ok' if v['ok'] else 'FAILS'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
