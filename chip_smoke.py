#!/usr/bin/env python3
"""Chip smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

1. Device: the card's name and power limit, the torch and CUDA versions,
   and the build of every kernel from the sources in this checkout.
2. Kernels: each CUDA kernel of the main path against its plain PyTorch
   version on the card, at the shapes the main path gives it, with its
   time, its plain version's time and its bound.
3. Serve: Qwen3-30B-A3B at full width (depth cut from 48 to 4 layers,
   seeded random weights) through ``ServingEngine`` under 2T-Drop: 8
   requests x 128-token prompts x 16 new tokens, greedy. Checks the result
   and that every MoE layer went through the kernel.

Exits non-zero if any phase fails, and before printing any result when no
CUDA card is visible. The last line of standard output is one JSON object
naming the device. Run from the root of a checkout:

    python3 chip_smoke.py
"""
from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# published H100 SXM peaks (dense): HBM bytes/s and float32 FLOP/s on the
# CUDA cores (the kernel does not use the tensor cores)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
REL_TOL = 1e-5          # float32: the same products summed in another order
N_LAYERS = 4            # depth cut of the serve phase (the model has 48)


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, runs: int) -> float:
    """Median of ``runs`` CUDA-event timings of ``fn`` (after one warm-up)."""
    import torch
    fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def fused_bound(kw, T: int, d: int):
    """(bound_ms, bound_by, flops, bytes) of one fused pipeline call: the
    bytes it must move (x read once, the weights of the neurons its rows
    need read once, the pair maps, the output written once) over the HBM
    rate, and the SwiGLU FLOPs of the rows it computes over the float32
    rate; the larger of the two."""
    from repro_torch.kernels.dualsparse_ffn import resolve_n_major
    f = kw["w1"].shape[-1]
    P = kw["p_factor"]
    V = P * f
    n_major = resolve_n_major(f, P, kw["n_minor_start"], 128)
    cf = kw["counts_full"].tolist()
    cm = kw["counts_major"].tolist()
    n_pos = kw["tok_sorted"].shape[0]
    nbytes = 2 * T * d * 4 + 4 * (3 * len(cf) + 2 * n_pos)
    flops = 0
    for rows_f, rows_m in zip(cf, cm):
        if rows_f:
            nbytes += 3 * d * V * 4
        elif rows_m:
            nbytes += 3 * d * n_major * 4
        flops += 6 * d * (V * rows_f + n_major * rows_m)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / F32_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", flops, nbytes)


def kernel_phase(dev):
    """The fused MoE pipeline against its plain version at Qwen3-30B-A3B
    widths (d 2048, 128 experts, P 2, 384 neurons per sub-expert, top-8),
    with routing from a router and 2T thresholds calibrated to a 25% drop
    target, so that rows are FULL, MAJOR-only and dropped."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import gating, moe
    from repro_torch.core.drop import expand_pairs_2t
    from repro_torch.core.policy import TwoTDrop
    from repro_torch.kernels import ops

    cfg = get_config("qwen3-moe-30b-a3b")
    d, E, K, P = cfg.d_model, cfg.n_experts, cfg.top_k, 2
    f = cfg.d_expert // P
    gen = torch.Generator(device=dev)
    gen.manual_seed(1234)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    params = dict(wg=randn(d, E, scale=0.1), w1=randn(E * P, d, f, scale=0.02),
                  w3=randn(E * P, d, f, scale=0.02),
                  w2=randn(E * P, f, d, scale=0.02))
    # the layer's capacity: capacity_for(T, K*P sub-pairs, E*P sub-experts)
    cap_decode = moe.capacity_for(8, K * P, E * P, 2.0)
    cap_prefill = moe.capacity_for(1024, K * P, E * P, 2.0)
    cases = [
        # name, T, capacity, mode_grouped, experts left empty
        ("decode", 8, cap_decode, True, 0),
        ("prefill", 1024, cap_prefill, True, 0),
        ("overflow", 1024, 16, True, 0),
        ("empty_experts", 1024, cap_prefill, True, E // 8),
        ("p1_sub_pairs", 1024, cap_prefill, False, 0),
    ]
    results = []
    for name, T, cap, mode_grouped, n_empty in cases:
        x = randn(T, d)
        # with n_empty, the router covers experts n_empty.. only, so the
        # first n_empty experts receive no row
        wg = params["wg"][:, n_empty:]
        pol = TwoTDrop(drop_target=0.25)._calibrated([wg], cfg, x)
        r = gating.route(x, wg, K, cfg.router_norm_topk)
        pairs = expand_pairs_2t(r.idx + n_empty, r.combine, r.norm_score, P,
                                pol.t_major, pol.t_minor)
        kw, overflow = moe.fused_pipeline_args(params, pairs, P, cap,
                                               mode_grouped)
        y_ref = ops.fused_moe_pipeline_ref(x, **kw)
        y1 = ops.fused_moe_pipeline(x, **kw)
        y2 = ops.fused_moe_pipeline(x, **kw)
        torch.cuda.synchronize()
        rel = float((y1 - y_ref).norm() / y_ref.norm())
        max_abs = float((y1 - y_ref).abs().max())
        stable = bool(torch.equal(y1, y2))
        cf = kw["counts_full"]
        cm = kw["counts_major"]
        rows = dict(full=int(cf.sum()), major=int(cm.sum()),
                    overflow=int(overflow),
                    empty=int(((cf + cm) == 0).sum()))
        ms = cuda_ms(lambda: ops.fused_moe_pipeline(x, **kw), 20)
        plain_ms = cuda_ms(lambda: ops.fused_moe_pipeline_ref(x, **kw), 5)
        kw_full = dict(kw, counts_full=cf + cm, counts_major=torch.zeros_like(cm))
        full_ms = cuda_ms(lambda: ops.fused_moe_pipeline(x, **kw_full), 20)
        bound_ms, bound_by, flops, nbytes = fused_bound(kw, T, d)
        res = dict(case=name, T=T, capacity=cap, p_factor=kw["p_factor"],
                   rows=rows, rel_err=rel, max_abs_err=max_abs,
                   bit_stable=stable, ms=ms, plain_ms=plain_ms,
                   all_full_ms=full_ms, bound_ms=bound_ms, bound_by=bound_by,
                   flops=flops, bytes=nbytes)
        results.append(res)
        log(f"  fused_moe_pipeline[{name}] T={T} cap={cap} "
            f"P={kw['p_factor']} rows={rows} rel_err={rel:.3e} "
            f"max_abs={max_abs:.3e} bit_stable={stable} ms={ms:.4f} "
            f"plain_ms={plain_ms:.4f} all_rows_full_ms={full_ms:.4f} "
            f"bound_ms={bound_ms:.4f} ({bound_by}; {flops / 1e9:.2f} GFLOP, "
            f"{nbytes / 1e6:.1f} MB)")
        if name == "overflow" and rows["overflow"] == 0:
            raise AssertionError("overflow case did not overflow")
        if name == "empty_experts" and rows["empty"] < n_empty:
            raise AssertionError("empty-expert case has no empty expert")
        if mode_grouped and rows["major"] == 0 and name != "overflow":
            raise AssertionError(f"{name}: no MAJOR-only rows")
        if not (rel <= REL_TOL and stable and torch.isfinite(y1).all()):
            raise AssertionError(f"fused_moe_pipeline[{name}] disagrees with "
                                 f"its plain version: rel_err={rel:.3e} "
                                 f"(bar {REL_TOL}) bit_stable={stable}")
    return results


# ---------------------------------------------------------------------------
# Phase 3: serve through the engine
# ---------------------------------------------------------------------------

def serve_phase(dev):
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import moe
    from repro_torch.core.policy import make_policy
    from repro_torch.data.pipeline import SyntheticLM, calibration_activations
    from repro_torch.kernels import ops
    from repro_torch.models import attention
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    from repro_torch.models import transformer as T_
    from repro_torch.serving import GenerationConfig, ServingEngine

    full = get_config("qwen3-moe-30b-a3b")
    cfg = dataclasses.replace(full, n_layers=N_LAYERS)
    log(f"  config {cfg.arch_id}: full width (d_model {cfg.d_model}, "
        f"{cfg.n_heads} heads / {cfg.n_kv_heads} kv, head_dim "
        f"{cfg.head_dim}, {cfg.n_experts} experts top-{cfg.top_k}, "
        f"d_expert {cfg.d_expert}, vocab {cfg.vocab_size}); depth cut from "
        f"{full.n_layers} to {cfg.n_layers} layers; seeded random weights")
    t0 = time.perf_counter()
    model = M.init_params(cfg, seed=0, device=dev)
    calib = calibration_activations(np.random.default_rng(7), 512,
                                    cfg.d_model, device=dev)
    policy = make_policy("2t", cfg.dualsparse, drop_target=0.25)
    model, policy = policy.prepare(model, cfg, calib)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"  init + 2T prepare {time.perf_counter() - t0:.2f}s, "
        f"{n_params / 1e9:.2f} B float32 parameters, thresholds "
        f"t_major={float(policy.t_major):.5f} "
        f"t_minor={float(policy.t_minor):.5f}")

    B, S, NEW = 8, 128, 16
    src = SyntheticLM(cfg.vocab_size, seed=0)
    rng = np.random.default_rng(0)
    prompts = [src.sample_batch(rng, 1, S)["tokens"][0] for _ in range(B)]
    kw = dict(batch_size=B, max_prompt_len=S, max_new_tokens=NEW,
              policy=policy, device=dev)
    # warm-up on its own engine: first calls load the kernel library and
    # grow the allocator; its metrics stay out of the measured engine
    ServingEngine(cfg, model, **kw).generate(
        prompts, GenerationConfig(max_new_tokens=2))
    eng = ServingEngine(cfg, model, **kw)

    ops.fused_moe_pipeline.launches = 0
    ops.fused_moe_pipeline_ref.calls = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = eng.generate(prompts, GenerationConfig(max_new_tokens=NEW))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.fused_moe_pipeline.launches
    plain_calls = ops.fused_moe_pipeline_ref.calls

    n_tok = sum(len(r.tokens) for r in results)
    decode_steps = NEW - 1
    counters = eng.metrics().counters

    def subpairs(outcome):
        return int(counters[f'repro_moe_subpairs_total{{outcome="{outcome}"}}'])
    kept_f, kept_m = subpairs("kept_full"), subpairs("kept_major")
    dropped = subpairs("dropped")
    total = kept_f + kept_m + dropped
    serve = dict(
        layers=cfg.n_layers, layers_full_model=full.n_layers, requests=B,
        prompt_len=S, new_tokens=NEW, tokens=n_tok, wall_s=wall,
        tok_per_s=n_tok / wall, prefill_s=results[0].prefill_s,
        decode_step_ms=results[0].decode_s / decode_steps * 1e3,
        overflow_pairs=eng.overflow_pairs, kept_full=kept_f,
        kept_major=kept_m, dropped_pairs=dropped,
        drop_rate=dropped / max(total, 1), launches=launches,
        plain_calls=plain_calls,
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    log(f"  served {B} requests x {S}-token prompts x {NEW} new tokens: "
        f"{n_tok} tokens in {wall:.3f}s ({serve['tok_per_s']:.1f} tok/s), "
        f"prefill {serve['prefill_s']:.4f}s, decode step "
        f"{serve['decode_step_ms']:.3f} ms (mean of {decode_steps})")
    log(f"  MoE sub-pairs: kept_full={kept_f} kept_major={kept_m} "
        f"dropped={dropped} (drop rate {serve['drop_rate']:.4f}) "
        f"overflow_pairs={serve['overflow_pairs']}; fused_moe_pipeline "
        f"launches={launches}, plain-version calls={plain_calls}; peak "
        f"memory {serve['peak_mem_gb']:.2f} GB")

    expected = cfg.n_layers * (1 + decode_steps)
    if not all(len(r.tokens) == NEW for r in results):
        raise AssertionError("a request did not return every token")
    if launches != expected or plain_calls != 0:
        raise AssertionError(f"fused_moe_pipeline launched {launches} times "
                             f"(expected {expected}); plain version called "
                             f"{plain_calls} times (expected 0)")

    # the output is right: finite prefill logits of the right shape, and
    # layer 0's MoE on the batch's real hidden states equal to its plain
    # version at the policy's capacity (overflow included) and to the
    # dense oracle at capacity T (no overflow). (The sub-pair buffer path
    # seats pairs per sub-expert, so under overflow it keeps other pairs.)
    batch = {"tokens": torch.from_numpy(np.stack(prompts)).long().to(dev)}
    logits, _ = M.make_prefill_step(cfg, cache_len=S + NEW,
                                    policy=policy)(model, batch)
    with torch.no_grad():
        blk = model.blocks[0]
        x, pos = T_.embed_inputs(model, batch, cfg)
        x = x + attention.gqa_attention(
            blk.attn, L.rms_norm(x, blk.ln1, cfg.norm_eps), pos, cfg)
        h = L.rms_norm(x, blk.ln2, cfg.norm_eps).reshape(B * S, -1)
        layer = blk.moe.weights()
        pairs = policy.route(layer, h, cfg)
        cap = moe.capacity_for(B * S, pairs.idx.shape[1],
                               layer["w1"].shape[0], policy.capacity_factor)
        kw_served, overflow = moe.fused_pipeline_args(layer, pairs, 2, cap,
                                                      True)
        y_served = ops.fused_moe_pipeline(h, **kw_served)
        y_plain = ops.fused_moe_pipeline_ref(h, **kw_served)
        y_exact = moe.moe_forward_dispatch(
            layer, h, cfg, pairs=pairs, capacity=B * S, mode_grouped=True,
            fused_pipeline=True)
        y_ref = moe.moe_forward_ref(layer, h, cfg, pairs=pairs)

    def rel(a, b):
        return float((a - b).norm() / b.norm())
    rel_plain = rel(y_served, y_plain)
    rel_ref = rel(y_exact, y_ref)
    serve.update(layer0_rel_err_vs_plain=rel_plain,
                 layer0_rel_err_vs_dense_ref=rel_ref,
                 layer0_overflow=int(overflow))
    log(f"  prefill logits {tuple(logits.shape)} finite="
        f"{bool(torch.isfinite(logits).all())}; layer-0 MoE on the batch: "
        f"kernel vs plain version at capacity {cap} (overflow "
        f"{int(overflow)}) rel_err {rel_plain:.3e}; kernel at capacity T "
        f"vs dense oracle rel_err {rel_ref:.3e}")
    if tuple(logits.shape) != (B, S, cfg.vocab_size) \
            or not torch.isfinite(logits).all():
        raise AssertionError("prefill logits are not finite or misshaped")
    if rel_plain > REL_TOL or rel_ref > REL_TOL:
        raise AssertionError("the served MoE path disagrees with its "
                             "references")
    serve["profile"] = profile_decode(eng, prompts)
    return serve


def profile_decode(eng, prompts):
    """Where one more served batch (1 prefill + 3 decode steps) spends its
    time: its wall time without the profiler, then the device time of
    every CUDA kernel under ``torch.profiler`` (top kernels by time) and
    the device-busy share = kernel time / unprofiled wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serving import GenerationConfig
    gen = GenerationConfig(max_new_tokens=4)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.generate(prompts, gen)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        eng.generate(prompts, gen)
        torch.cuda.synchronize()

    def dev_us(ev):
        return getattr(ev, "self_device_time_total",
                       getattr(ev, "self_cuda_time_total", 0.0))
    kernels = [ev for ev in prof.key_averages()
               if ev.device_type == torch.autograd.DeviceType.CUDA
               and dev_us(ev) > 0]
    busy_ms = sum(dev_us(ev) for ev in kernels) / 1e3
    top = sorted(kernels, key=dev_us, reverse=True)[:8]
    log(f"  profile (1 prefill + 3 decode steps): wall {wall_ms:.1f} ms "
        f"unprofiled, CUDA kernels {busy_ms:.1f} ms (device busy "
        f"{100 * busy_ms / wall_ms:.1f}%)")
    for ev in top:
        log(f"    {dev_us(ev) / 1e3:9.3f} ms  x{ev.count:<5d} {ev.key[:70]}")
    return dict(wall_ms=wall_ms, device_busy_ms=busy_ms,
                top=[dict(name=ev.key, device_ms=dev_us(ev) / 1e3,
                          count=ev.count) for ev in top])


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build     # fails outside a checkout
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    log("phase 1: device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    log(smi.splitlines()[0])
    log(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}, python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    libs = _build.build_all()
    log(f"  built {sorted(libs)} in {time.perf_counter() - t0:.2f}s "
        f"(nvcc time {sum(_build.BUILD_SECONDS.values()):.2f}s)")
    for name, text in _build.BUILD_LOG.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"    {name}: {line.strip()}")

    log("phase 2: kernels against their plain versions")
    log(f"  bound = max(bytes / {HBM_BYTES_PER_S / 1e12:.2f} TB/s HBM, "
        f"FLOPs / {F32_FLOPS / 1e12:.0f} TFLOP/s float32 CUDA-core peak); "
        f"bar rel_err <= {REL_TOL:g} and bit-identical across launches")
    cases = kernel_phase(dev)
    log("phase 3: serve Qwen3-30B-A3B (4 of 48 layers) under 2T-Drop")
    serve = serve_phase(dev)

    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    with open(out_dir / "chip_smoke.json", "w") as fh:
        json.dump({"device": smi, "torch": torch.__version__,
                   "kernel_cases": cases, "serve": serve}, fh, indent=1)

    main_case = next(c for c in cases if c["case"] == "prefill")
    print(json.dumps({"kernels": [{
        "name": "fused_moe_pipeline", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fused_moe_pipeline.cu",
        "replaces": "src/repro/kernels/dualsparse_ffn.py:498",
        "launches": serve["launches"],
        "max_abs_err": max(c["max_abs_err"] for c in cases),
        "ms": main_case["ms"], "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"],
        "bound_by": main_case["bound_by"], "library_ms": None,
        "at": "prefill T=1024, Qwen3-30B-A3B widths"}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
