"""Find a cell's knee on the card: one set-up, then one window per
offered rate on a fresh engine, each reported as a JSON line (tokens per
second, TTFT and ITL tails, requests still waiting at the close, and the
mean TTFT of the first and last quarter of the arrivals: a backlog that
grows shows as the second far above the first).

    python3 perfbench/tools/sweep.py --workload qwen3-30b-a3b.chat \
        --seed 11 --seconds 20 --rates 2 3 4 5 6
"""
import argparse
import json
import sys
import time
from pathlib import Path

T_START = time.perf_counter()
ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def quarter_ttft(served, window_s, which):
    due = sorted(served, key=lambda s: s.due_s)
    n = max(1, len(due) // 4)
    part = due[:n] if which == 0 else due[-n:]
    from perfbench.harness import stats
    vals = stats.ttft_samples(part, window_s)
    return sum(vals) / len(vals) if vals else None


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    args = ap.parse_args()
    import torch
    from perfbench.harness import cell as C, spec, stats
    c = spec.cell(spec.load_benchmark(), args.workload)
    dev = torch.device("cuda", 0)
    log = lambda s: print(f"[sweep] {s}", file=sys.stderr, flush=True)
    prog = C.setup(c, args.seed, dev, T_START, log)
    log(f"memory peak after set-up {torch.cuda.max_memory_allocated(dev)} B")
    for rate in args.rates:
        mix = {**c.traffic, "rate_per_s": rate}
        rec = C.measure(prog, c, mix, args.seed, args.seconds, False, dev,
                        log)
        w = rec.window_s
        ttft = stats.ttft_samples(rec.served, w)
        itl = stats.itl_samples(rec.served, w)
        waiting = sum(1 for s in rec.served if s.due_s < w and
                      not (s.stamps and s.stamps[0] <= w))
        print(json.dumps({
            "rate_per_s": rate, "offered": len(rec.served),
            "output_tok_s": stats.tokens_in_window(rec.served, w) / w,
            "ttft_p50_ms": 1e3 * stats.percentile(ttft, 50),
            "ttft_p95_ms": 1e3 * stats.percentile(ttft, 95),
            "itl_p50_ms": 1e3 * (stats.percentile(itl, 50) or 0),
            "itl_p95_ms": 1e3 * (stats.percentile(itl, 95) or 0),
            "waiting_at_close": waiting,
            "ttft_first_quarter_ms": 1e3 * quarter_ttft(rec.served, w, 0),
            "ttft_last_quarter_ms": 1e3 * quarter_ttft(rec.served, w, 1),
            "offered_tok_s": sum(s.n_out for s in rec.served) / w,
            "memory_peak_bytes": torch.cuda.max_memory_allocated(dev),
            "card": torch.cuda.get_device_name(dev)}), flush=True)


if __name__ == "__main__":
    main()
