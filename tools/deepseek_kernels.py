"""The MoE kernels at DeepSeek-V2-Lite's widths on the card, against their
plain versions (``kernels/ref.py``), with times beside their bounds:

* ``fused_moe_pipeline``: d 2048, 64 experts partitioned P 2 into
  sub-experts of 704 neurons (5.5 strips of 128: the last strip half
  empty), top-6 router probabilities not renormalised, 2T thresholds
  calibrated to a 25% drop; a decode step of the document cell (T 32,
  the few-row tile) and a prompt chunk (T 256, the many-row tile), at the
  engines' exact capacity; float32, bar 1e-5, bit-stable across launches;
* ``moe_route_plan`` with ``renorm=False`` at E 64, K 6, P 2: decode T 32
  (per-slot thresholds) and chunk T 256, every plan field equal, the
  combine weights within 1e-6.

    python3 tools/deepseek_kernels.py      # on a machine with the card

Prints one line per case and, last, the results as one JSON line.
"""
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke as cs  # noqa: E402

# (label, tokens T); the capacity is T, as the engines' exact capacity
FUSED_CASES = (("dsv2_decode", 32), ("dsv2_chunk", 256))
ROUTE_CASES = (("dsv2_decode", 32), ("dsv2_chunk", 256))


def fused_cases(dev):
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import moe
    from repro_torch.kernels import dualsparse_ffn, ops

    cfg = get_config("deepseek-v2-lite")
    d, E, K, P = cfg.d_model, cfg.n_experts, cfg.top_k, 2
    f = cfg.d_expert // P
    gen = torch.Generator(device=dev)
    gen.manual_seed(2929)
    params = cs.moe_params(gen, dev, d, E, P, f)
    n_major = dualsparse_ffn.resolve_n_major(f, P, None, 128)
    out = []
    for label, T in FUSED_CASES:
        x, pairs = cs.routed_case(gen, dev, cfg, params, T, P)
        kw, _ = moe.fused_pipeline_args(params, pairs, P, T, True)
        want = ops.fused_moe_pipeline_ref(x, **kw)
        y1 = ops.fused_moe_pipeline(x, **kw)
        y2 = ops.fused_moe_pipeline(x, **kw)
        torch.cuda.synchronize()
        rel = float((y1 - want).norm() / want.norm())
        stable = bool(torch.equal(y1, y2))
        cf, cm = kw["counts_full"], kw["counts_major"]
        ms = cs.cuda_ms(lambda: ops.fused_moe_pipeline(x, **kw), 50)
        bound = cs.fused_bound(kw, T, d)
        tiles = cs.tile_stats(
            lambda reg: dualsparse_ffn.launch_fused_moe_pipeline(
                x, kw["w1"], kw["w3"], kw["w2"], kw["group_offsets"], cf, cm,
                kw["tok_sorted"], kw["combine_sorted"], capacity=T,
                p_factor=P, n_major=n_major, regime=reg),
            cf, cm, T, x.dtype)
        res = dict(case=label, T=T, d=d, f_sub=f, n_major=n_major,
                   rows_full=int(cf.sum()), rows_major=int(cm.sum()),
                   rel_err=rel, bit_stable=stable, ms=ms,
                   bound_ms=bound[0], bound_by=bound[1], flops=bound[2],
                   bytes=bound[3])
        cs.log(f"fused_moe_pipeline[{label}] T={T} d={d} f_sub={f} "
               f"(n_major {n_major}, {f / 128:.1f} strips of 128) rows "
               f"full {res['rows_full']} major {res['rows_major']} "
               f"rel_err={rel:.3e} bit_stable={stable} ms={ms:.4f} "
               f"bound_ms={bound[0]:.4f} ({bound[1]})")
        res.update(cs.case_report(
            f"fused_moe_pipeline[{label}]", ms, bound, tiles,
            cs.launch_profile(lambda: ops.fused_moe_pipeline(x, **kw))))
        out.append(res)
        if not (rel <= cs.REL_TOL and stable and res["rows_major"]):
            raise AssertionError(f"fused_moe_pipeline[{label}]: rel_err "
                                 f"{rel:.3e} (bar {cs.REL_TOL}), bit_stable "
                                 f"{stable}, MAJOR-only rows "
                                 f"{res['rows_major']}")
    return out


def route_cases(dev):
    import torch
    from repro_torch.kernels import ops, ref
    E, K, P = 64, 6, 2
    gen = torch.Generator(device=dev)
    gen.manual_seed(2930)
    out = []
    for label, T in ROUTE_CASES:
        logits = torch.randint(-1024, 1025, (T, E), generator=gen,
                               device=dev).float() / 512
        norm = torch.topk(torch.softmax(logits, -1), K).values
        norm = norm / norm.sum(-1, keepdim=True)
        tm, tn = cs._widest_gap(norm, 0.2), cs._widest_gap(norm, 0.3)
        shape = (T,) if label.endswith("decode") else ()
        th = (torch.full(shape, tm, device=dev),
              torch.full(shape, tn, device=dev))
        kw = dict(top_k=K, renorm=False, p_factor=P, capacity=T,
                  pad=min(128, T))
        got = ops.moe_route_plan(logits, *th, **kw)
        again = ops.moe_route_plan(logits, *th, **kw)
        want = ref.moe_route_plan_ref(logits, *th, **kw)
        torch.cuda.synchronize()
        equal = {name: bool(torch.equal(getattr(got, name),
                                        getattr(want, name)))
                 for name in cs.ROUTE_PLAN_FIELDS}
        stable = all(torch.equal(a, b) for a, b in zip(got, again))
        rel = max(float(((a - b).abs() / b.abs().clamp(min=1e-30)).max())
                  for a, b in ((got.combine, want.combine),
                               (got.combine_sorted, want.combine_sorted)))
        # not renormalised: a token's combine weights are its top-k
        # probabilities, summing to less than 1
        raw = bool((got.combine.sum(-1) < 1 - 1e-3).all())
        ms = cs.cuda_ms(lambda: ops.moe_route_plan(logits, *th, **kw), 50)
        bound_ms, nbytes = cs.route_plan_bound(T, E, K, P, min(128, T))
        res = dict(case=label, T=T, E=E, K=K, renorm=False, ms=ms,
                   bound_ms=bound_ms, bytes=nbytes, equal=equal,
                   bit_stable=stable, combine_rel=rel, raw_weights=raw,
                   dropped=int(got.dropped))
        cs.log(f"moe_route_plan[{label}] E {E} top-{K} T {T} renorm=False: "
               f"{ms:.4f} ms, bound {bound_ms * 1e3:.2f} µs; equal "
               f"{all(equal.values())}, combine rel {rel:.2e}, bit-stable "
               f"{stable}, weights not renormalised {raw}, dropped "
               f"{res['dropped']}")
        out.append(res)
        if not (all(equal.values()) and stable and rel <= 1e-6 and raw):
            raise AssertionError(f"moe_route_plan[{label}]: {res}")
    return out


def main():
    import torch
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    result = {"card": torch.cuda.get_device_name(dev),
              "fused": fused_cases(dev), "route_plan": route_cases(dev)}
    print(json.dumps(result, default=str), flush=True)


if __name__ == "__main__":
    main()
