#!/usr/bin/env python3
"""The fused MoE pipeline on float32 operands at the shapes the benchmark
cells hand its many-row tile, on the card, against its plain version, with
each case's time, bound and the device time of its row tiles:

* ``dbrx_prefill`` / ``dbrx_served``: DBRX-132B widths (d 6144, 16 experts,
  P 2, f 5376, top-4), 2T thresholds calibrated to a 25% drop target, T
  2048 and 6144 (the long cells' padded prefill: ~500-1500 rows a group);
* ``dbrx_keepall``: the same at T 2048 with every pair kept FULL (the
  keep-all cell's prefill);
* ``dbrx_chunk``: T 256 at the exact capacity (~64 rows a group: the DBRX
  chat cell's prompt chunks, bound by bytes);
* ``qwen3_keepall``: Qwen3-30B-A3B widths (d 2048, 128 experts, P 2, f
  384, top-8), T 8192, every pair kept (Fig. 10's keep-all point);
* ``qwen3_prefill``: the same widths, T 1024, 2T at 25%;
* ``dsv2_chunk``: DeepSeek-V2-Lite widths (d 2048, 64 experts, P 2, f 704,
  top-6, unnormalised), T 256 at the exact capacity (the doc cell's chunk).

Bound: the larger of the bytes over 3.35 TB/s and the many-row groups'
FLOPs as three TF32 passes at 495 TFLOP/s (``chip_smoke.fused_bound``).
Runs from any checkout's root with that checkout's kernels, so two trees
are compared in one call (parent, change, change, parent):

    python3 tools/moe_tile_shapes.py [--cases dbrx_prefill,dsv2_chunk]

Prints one line per case and, last, the results as one JSON line.
"""
import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke as cs  # noqa: E402

# (label, config, T, keep every pair, capacity: None for the serving
# engine's factor 2.0, else the exact capacity T)
CASES = (("dbrx_prefill", "dbrx-132b", 2048, False, None),
         ("dbrx_served", "dbrx-132b", 6144, False, None),
         ("dbrx_keepall", "dbrx-132b", 2048, True, None),
         ("dbrx_chunk", "dbrx-132b", 256, False, "exact"),
         ("qwen3_keepall", "qwen3-moe-30b-a3b", 8192, True, None),
         ("qwen3_prefill", "qwen3-moe-30b-a3b", 1024, False, None),
         ("dsv2_chunk", "deepseek-v2-lite", 256, False, "exact"))


def run_case(dev, cfg, params, label: str, T: int, keep_all: bool, cap):
    import torch
    from repro_torch.core import gating, moe
    from repro_torch.core.drop import expand_pairs_2t
    from repro_torch.kernels import dualsparse_ffn, ops
    P = 2
    d, E, K = cfg.d_model, cfg.n_experts, cfg.top_k
    gen = torch.Generator(device=dev)
    gen.manual_seed(3030 + T)
    if keep_all:
        x = torch.randn((T, d), generator=gen, device=dev)
        r = gating.route(x, params["wg"], K, cfg.router_norm_topk)
        pairs = expand_pairs_2t(r.idx, r.combine, r.norm_score, P, -1.0,
                                -1.0)
    else:
        x, pairs = cs.routed_case(gen, dev, cfg, params, T, P)
    cap = T if cap == "exact" else moe.capacity_for(T, K * P, E * P, 2.0)
    kw, overflow = moe.fused_pipeline_args(params, pairs, P, cap, True)
    want = ops.fused_moe_pipeline_ref(x, **kw)
    y1 = ops.fused_moe_pipeline(x, **kw)
    y2 = ops.fused_moe_pipeline(x, **kw)
    torch.cuda.synchronize()
    rel = float((y1 - want).norm() / want.norm())
    stable = bool(torch.equal(y1, y2))
    del want
    ms = cs.cuda_ms(lambda: ops.fused_moe_pipeline(x, **kw), 10)
    bound_ms, bound_by, flops, nbytes, _ = cs.fused_bound(kw, T, d)
    cf, cm = kw["counts_full"], kw["counts_major"]
    n_major = dualsparse_ffn.resolve_n_major(f=kw["w1"].shape[-1], p_factor=P,
                                             n_minor_start=None, block_f=128)
    tiles = cs.tile_stats(
        lambda reg: dualsparse_ffn.launch_fused_moe_pipeline(
            x, kw["w1"], kw["w3"], kw["w2"], kw["group_offsets"], cf, cm,
            kw["tok_sorted"], kw["combine_sorted"], capacity=cap,
            p_factor=P, n_major=n_major, regime=reg),
        cf, cm, cap, x.dtype)
    prof = cs.launch_profile(lambda: ops.fused_moe_pipeline(x, **kw), 3)
    rows = torch.clamp(cf + cm, max=cap)
    res = dict(case=label, T=T, capacity=cap, keep_all=keep_all,
               overflow=int(overflow), rel_err=rel, bit_stable=stable,
               ms=ms, bound_ms=bound_ms, bound_by=bound_by,
               bound_share=bound_ms / ms, flops=flops, bytes=nbytes,
               rows_mean=float(rows.float().mean()), rows_max=int(rows.max()),
               many_groups=tiles["many_groups"],
               matches_plan=tiles["matches_plan"],
               device_us=prof["device_us"],
               host_enqueue_us=prof["host_enqueue_us"])
    dev_us = ", ".join(f"{k} {v:.1f}" for k, v in
                       sorted(prof["device_us"].items()))
    cs.log(f"{label}: T={T} C={cap} rows mean {res['rows_mean']:.1f} max "
           f"{res['rows_max']}, many-row groups {tiles['many_groups']}: "
           f"ms={ms:.4f} bound_ms={bound_ms:.4f} ({bound_by}) share "
           f"{100 * bound_ms / ms:.1f}% rel_err={rel:.3e} bit_stable={stable}"
           f" plan={tiles['matches_plan']}; device µs per call: {dev_us}; "
           f"host enqueue {prof['host_enqueue_us']:.1f} µs")
    return res


def main() -> int:
    import torch
    from repro_torch.configs import get_config
    if not torch.cuda.is_available():
        print("moe_tile_shapes: no CUDA device is visible", file=sys.stderr)
        return 2
    ap = argparse.ArgumentParser()
    ap.add_argument("--cases", default=",".join(c[0] for c in CASES))
    args = ap.parse_args()
    want = args.cases.split(",")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    cs.log(f"{torch.cuda.get_device_name(0)}; tree {ROOT}")
    out, params, params_of = [], None, None
    for label, arch, T, keep_all, cap in CASES:
        if label not in want:
            continue
        cfg = get_config(arch)
        if params_of != arch:
            params = None
            cs.free_memory()
            gen = torch.Generator(device=dev)
            gen.manual_seed(30)
            params = cs.moe_params(gen, dev, cfg.d_model, cfg.n_experts, 2,
                                   cfg.d_expert // 2)
            params_of = arch
        out.append(run_case(dev, cfg, params, label, T, keep_all, cap))
    print(json.dumps(dict(card=torch.cuda.get_device_name(0), cases=out)))
    bad = [r["case"] for r in out
           if not (r["rel_err"] <= cs.REL_TOL and r["bit_stable"]
                   and r["matches_plan"])]
    if bad:
        print(f"moe_tile_shapes: disagree with the plain version: {bad}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
