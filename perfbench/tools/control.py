"""The two readings the correctness limit of a cell is set from, on the
card at the cell's own size: for each seed, the program's mean logit
gap over a window at the cell's load (its sample compared as a run
compares it), and, for the seeds named in --control-seeds, the control's:
the reference computed one step down in precision (--precisions: "tf32",
TF32 products, the step below the configurations' float32; "lower", that
and an fp8 KV cache as well) put in the program's place, on the same
prompts and served tokens, each with the verdict that the cell's limits
give it. One JSON line per seed.

    python3 perfbench/tools/control.py --workload qwen3-30b-a3b.chat \
        --seconds 40 --seeds 101 102 103 --control-seeds 101 102 103
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--precisions", nargs="+", default=["tf32"],
                    help="the control's steps down: tf32, lower")
    args = ap.parse_args()
    import torch
    from perfbench.harness import cell as C, check, spec
    c = spec.cell(spec.load_benchmark(), args.workload)
    dev = torch.device("cuda", 0)
    log = lambda s: print(f"[control] {s}", file=sys.stderr, flush=True)
    conf, mix = c.config, c.traffic
    ref_cls = spec.reference_class(conf)
    for seed in args.seeds:
        prog = C.setup(c, seed, dev, time.perf_counter(), log)
        rec = C.measure(prog, c, mix, seed, args.seconds, False, dev, log)
        C.free(prog, dev)
        program, _ = C.verify(c, rec, seed, dev, log)
        out = {"seed": seed, "rate_per_s": mix["rate_per_s"],
               "program": program}
        if seed in args.control_seeds:
            picks = check.sample(rec.served, rec.window_s,
                                 mix["check"]["requests"], seed)
            for prec in args.precisions:
                low = check.control(
                    ref_cls, conf["dims"], conf["serving"], seed, dev, picks,
                    mix["engine"]["kind"], precision=prec)
                low["verdict"] = check.verdict(low, 0, c.limits)
                low["correct"] = all(v["ok"] for v in low["verdict"].values())
                out[f"control_{prec}"] = low
        out["card"] = torch.cuda.get_device_name(dev)
        print(json.dumps(out), flush=True)
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
