"""Serving CLI of the PyTorch port: requests through one of the serving
engines on the card (``--device cpu`` to run on the CPU): synchronized
batches (``--engine sync``), slot-based continuous batching with
mid-decode admission (``continuous``), or the paged KV cache with chunked
prefill and prefix caching (``paged``).

Sparsity is selected with ``--policy``: none | 1t | 2t.

Example:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-moe-30b-a3b \
      --reduced --requests 8 --prompt-len 64 --new-tokens 32 --policy 2t
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-moe-30b-a3b \
      --reduced --device cpu --engine paged --slots 4 --policy 2t
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np

from repro_torch.configs import get_config, list_archs
from repro_torch.core.policy import POLICIES, make_policy
from repro_torch.data.pipeline import SyntheticLM, calibration_activations
from repro_torch.device import resolve_device
from repro_torch.models import model as M
from repro_torch.serving import (ContinuousBatchingEngine, GenerationConfig,
                                 PagedEngine, ServingEngine)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-moe-30b-a3b", choices=list_archs())
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default: the card)")
    ap.add_argument("--engine", default="sync",
                    choices=("sync", "continuous", "paged"),
                    help="synchronized batches, slot-based continuous "
                         "batching with mid-decode admission, or paged KV "
                         "(page-table cache + chunked prefill + prefix cache)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--batch-size", type=int, default=8,
                    help="sync batch size / continuous slot count")
    ap.add_argument("--slots", type=int, default=0,
                    help="continuous/paged engine slot count "
                         "(0 = --batch-size)")
    ap.add_argument("--page-size", type=int, default=16,
                    help="paged engine: tokens per KV page")
    ap.add_argument("--chunk-size", type=int, default=32,
                    help="paged engine: prompt tokens per prefill chunk")
    ap.add_argument("--no-prefix-cache", action="store_true",
                    help="paged engine: disable cross-request prefix reuse")
    ap.add_argument("--policy", default=None, choices=sorted(POLICIES),
                    help="sparsity policy (default: none)")
    ap.add_argument("--drop-target", type=float, default=None,
                    help="calibrate policy thresholds to this drop rate on "
                         "synthetic calibration activations")
    ap.add_argument("--fused-pipeline", action="store_true", default=None,
                    help="force MoE layers through the fused "
                         "dispatch->FFN->combine kernel (default AUTO: "
                         "always on CUDA, the buffer path on the CPU)")
    ap.add_argument("--no-fused-pipeline", dest="fused_pipeline",
                    action="store_false",
                    help="force the buffer path")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--no-metrics", action="store_true",
                    help="disable the on-device metrics (the cache then "
                         "carries the moe_overflow scalar)")
    ap.add_argument("--metrics-port", type=int, default=None,
                    help="serve Prometheus text exposition on this port "
                         "while requests run (0 = ephemeral); the driver "
                         "scrapes /metrics at the end and fails if the "
                         "payload does not round-trip")
    ap.add_argument("--metrics-log", default=None, metavar="PATH",
                    help="append one JSON metrics snapshot line after the "
                         "run ('-' = stdout)")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write the engine span trace as Chrome-trace JSON")
    ap.add_argument("--profile-dir", default=None, metavar="DIR",
                    help="write a torch.profiler Chrome trace of the whole "
                         "run into this directory")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = M.init_params(cfg, seed=args.seed, device=device)

    policy_name = args.policy or "none"

    policy = None
    force_policy = policy_name != "none" or args.fused_pipeline is not None
    if force_policy and cfg.is_moe and cfg.dualsparse.enabled:
        policy = make_policy(policy_name, cfg.dualsparse,
                             drop_target=args.drop_target,
                             fused_pipeline=args.fused_pipeline)
        calib = calibration_activations(np.random.default_rng(7), 512,
                                        cfg.d_model, device=device)
        model, policy = policy.prepare(model, cfg, calib)
        print(f"sparsity policy {policy.name!r}: partition P="
              f"{policy.partition_p}"
              + (f", drop_target={args.drop_target}"
                 if args.drop_target is not None else ""))

    src = SyntheticLM(cfg.vocab_size, seed=args.seed)
    rng = np.random.default_rng(args.seed)
    prompts = [src.sample_batch(rng, 1, args.prompt_len)["tokens"][0]
               for _ in range(args.requests)]

    metrics = not args.no_metrics
    common = dict(max_prompt_len=args.prompt_len,
                  max_new_tokens=args.new_tokens, policy=policy,
                  metrics=metrics, device=device)
    if args.engine == "continuous":
        eng = ContinuousBatchingEngine(
            cfg, model, n_slots=args.slots or args.batch_size, **common)
    elif args.engine == "paged":
        eng = PagedEngine(
            cfg, model, n_slots=args.slots or args.batch_size,
            page_size=args.page_size, chunk_size=args.chunk_size,
            prefix_cache=not args.no_prefix_cache, **common)
    else:
        eng = ServingEngine(cfg, model, batch_size=args.batch_size, **common)

    server = None
    if args.metrics_port is not None:
        from repro_torch.obs import MetricsServer
        server = MetricsServer(eng.metrics, port=args.metrics_port)
        server.start()
        print(f"metrics: serving Prometheus exposition at {server.url}")
    profiler = None
    if args.profile_dir:
        import torch.profiler as tp
        acts = [tp.ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(tp.ProfilerActivity.CUDA)
        profiler = tp.profile(activities=acts)
        profiler.start()
    t0 = time.time()
    try:
        results = eng.generate(prompts, GenerationConfig(
            max_new_tokens=args.new_tokens, seed=args.seed))
    finally:
        if profiler is not None:
            profiler.stop()
            os.makedirs(args.profile_dir, exist_ok=True)
            path = os.path.join(args.profile_dir, "trace.json")
            profiler.export_chrome_trace(path)
            print(f"profiler trace written to {path}")
    dt = time.time() - t0
    n_tok = sum(len(r.tokens) for r in results)
    print(f"served {len(results)} requests, {n_tok} tokens "
          f"in {dt:.2f}s ({n_tok / dt:.1f} tok/s) "
          f"policy={policy_name} moe_overflow={eng.overflow_pairs}")
    timing = eng.timing
    print(f"  warmup={timing['compile_s']:.2f}s "
          f"({timing['compile_steps']} warm-up steps) "
          f"steady_step={timing['steady_step_s'] * 1e3:.1f}ms "
          f"over {timing['steady_steps']} steps")
    if args.engine == "continuous":
        print(f"  slots={eng.n_slots} admitted={eng.n_admitted} "
              f"decode_steps={eng.decode_steps} "
              f"max_concurrency={eng.max_concurrency}")
    elif args.engine == "paged":
        print(f"  slots={eng.n_slots} admitted={eng.n_admitted} "
              f"chunk_steps={eng.chunk_steps} "
              f"decode_steps={eng.decode_steps} "
              f"prefix_hit_rate={eng.prefix_hit_rate:.2f}")
    for r in results[:4]:
        print(f"  req{r.uid}: {r.tokens[:12]}...")

    if args.metrics_log:
        from repro_torch.obs import snapshot_json_line
        line = snapshot_json_line(eng.metrics(), arch=args.arch,
                                  engine=args.engine, policy=policy_name)
        if args.metrics_log == "-":
            print(line)
        else:
            with open(args.metrics_log, "a") as f:
                f.write(line + "\n")
            print(f"metrics: snapshot appended to {args.metrics_log}")
    if args.trace_out:
        eng.tracer.write_chrome_trace(args.trace_out)
        print(f"metrics: span trace written to {args.trace_out} "
              f"({len(eng.tracer.events())} events)")
    if server is not None:
        import urllib.request
        from repro_torch.obs import parse_prometheus
        with urllib.request.urlopen(server.url) as resp:
            text = resp.read().decode()
        snap = parse_prometheus(text)
        n_series = (len(snap.counters) + len(snap.gauges)
                    + len(snap.histograms))
        server.stop()
        if n_series == 0:
            raise SystemExit("metrics scrape FAILED: no series parsed")
        print(f"metrics scrape ok ({n_series} series)")
    return results


if __name__ == "__main__":
    main()
