#!/usr/bin/env python3
"""Chip smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

1. Device: the card's name and power limit, the torch and CUDA versions,
   and the build of every kernel from the sources in this checkout.
2. Kernels: the fused MoE pipeline (2) and the grouped SwiGLU (2b)
   against their plain PyTorch versions on the card, at the shapes the
   serving paths give them (decode, the paged engine's 64-token chunk,
   prefill, P=1 layouts, overflow, empty experts), at a skewed routing
   whose groups need both row tiles, at two odd widths (one off the
   16-byte path), and (2 only) at DBRX-132B's widths (d 6144, 16 experts
   top-4, P 2, 5376 neurons per sub-expert) at decode T=8 and prefill
   T=2048, with their times, their plain versions' times, their
   bounds and shares of them, which row tile served each group, the row
   slots multiplied against the live rows, and a profile splitting each
   call into its launches and the wrapper's own ops. The ``_bf16`` cases
   run bf16 operands (the S-ETP wire type): decode and prefill at Qwen3
   widths and S-ETP's local seating on one rank of phase 11's world.
3. Serve: Qwen3-30B-A3B at full width (depth cut from 48 to 4 layers,
   seeded random weights) through ``ServingEngine`` under 2T-Drop: 8
   requests x 128-token prompts x 16 new tokens, greedy. Checks the result
   and that every MoE layer went through the fused kernel.
4. The same model through ``ContinuousBatchingEngine`` (8 slots, 16
   requests of 32-128 prompt tokens, mid-decode admission) on the fused
   kernel.
5. The same model through ``PagedEngine`` (page 16, chunk 64, 8 slots, 16
   requests, 8 of them sharing a 64-token prefix) on the buffer path, whose
   expert FFN is the grouped SwiGLU kernel; then the same requests on the
   fused route, and the share of greedy tokens the two routes agree on.

6. Kernels: the intra-chunk SSD of Mamba2 (``ssd_chunk``) against its
   plain version at the shapes the Mamba2 and Zamba2 prefills give it,
   at Q = 128 and at the JAX kernel tests' odd shape, with B/C per head;
   at the two prefill shapes with B/C per group, as the models pass them,
   once more with the Mamba2 layer's own draws of dt and a; with each
   call's bound, share of it and device time per launch.
7. Serve: Mamba2-370m at full width and full depth (48 layers, seeded
   random weights) through ``ServingEngine``: 8 requests x 512-token
   prompts x 16 new tokens, greedy. Every layer's prefill SSD goes through
   the kernel; decode is the plain O(1) state update.
8. Serve: Zamba2-7B at full width and full depth (81 Mamba2 layers, the
   shared attention + MLP block before every 6th: 14 occurrences) through
   ``ServingEngine``: 8 requests x 384-token prompts x 16 new tokens.
9. Serve: DBRX-132B at full width (d_model 6144, 48 heads / 8 kv, 16
   experts top-4, d_expert 10752, vocab 100352; depth cut from 40 to 3
   layers, seeded random float32 weights, prepared once by ``per_layer``)
   through ``ServingEngine``: 4 requests x 1536-token prompts x 16 new
   tokens (blockwise attention, the fused kernel at T=6144), under ``2t``
   and ``per_layer`` calibrated to a 25% drop and ``load_aware`` over 4
   modelled EP devices at the 2T policy's T¹ ± gap. Then the Fig. 11
   proxy on layer 0 with a skewed router: makespan, drop rate and output
   error of 2T and load-aware against keep-all (a single-card proxy, not
   a measured EP speedup).
10. Serve the dense and VLM decoders through ``ServingEngine``:
   Qwen2-VL-7B at full width and depth (1024 vision-stub tokens + 256
   text tokens: blockwise attention; also through
   ``ContinuousBatchingEngine``), Qwen2-7B and StarCoder2-3B at full depth
   and Granite-20B at full width with depth cut from 52 to 24 layers, 4
   requests x 512 x 16; and layer 0's blockwise attention against
   ``plain_attention`` on the card at S = 1280.
11. S-ETP over ``torch.distributed``: a world of 4 ranks, one process
   each, all on this card, over gloo (NCCL refuses two ranks on one GPU;
   the collectives route through host memory, so the times are no EP step
   time). Each rank builds Qwen3-30B-A3B (4 of 48 layers), prepares it
   under ``load_aware`` for the ranks' strided placement one rank at a
   time and keeps its shard of the experts (64 of 256 sub-experts per
   layer). Layer 0 on real hidden states: keep-all 2T at the float32 wire
   against the one-process dispatch path (bar REL_TOL), and load_aware at
   the bf16 wire, kernels against their plain versions (bar
   BF16_REL_TOL), the latter also at the paged run's shapes (one
   slot's 64-token chunk, a decode batch of 4 slots). Then 8 x 128 x 16
   on ``ServingEngine`` (the bf16 fused
   kernel on every rank), 8 requests on 4 ``ContinuousBatchingEngine``
   slots on the buffer path (the bf16 grouped kernel) and 8 requests on 4
   ``PagedEngine`` slots (page 16, chunk 64, 4 requests sharing a 64-token
   prefix; S-ETP in every chunk and decode step, the bf16 fused kernel);
   every rank serves the same tokens (by construction: each takes the
   first model rank's). Then one ETP layer on (ep 2, tp 2) against the
   dense oracle.
12. Serve MiniCPM3-4B (MLA) at full width and depth (62 layers) through
   ``ServingEngine``, 4 x 512 x 16, and ``ContinuousBatchingEngine``: no
   kernel of ours.
13. Train on the card (``make_train_step``: AdamW on a cosine schedule,
   aux 0.01, the differentiable route, which launches no kernel of ours:
   the kernels have no backward). (a) Reduced Qwen3-30B-A3B, 3 steps on
   the card and on the CPU from the same weights and batches: losses and
   each leaf's update. (b) Qwen3-30B-A3B at full width, depth cut from 48
   to 4 layers (3.1 B parameters; params, grads and the moments take ~50
   GB), 8 steps at 4 x 512: loss and grad norm per step, step time,
   tokens/s, peak memory, model FLOPs and their share of the float32 rate,
   a profile of one more step; the init's log-sum-exp at chance, the loss
   falling, every kernel counter still 0. (c) The paper's Fig. 4 fine-tune:
   a ~128M MoE and its P=2 complete-transformation twin, 200 steps each at
   8 x 128, the same step-1 cross entropy; the original's state saved at
   step 100 (``checkpoint.io``), restored into a fresh model and optimizer,
   runs steps 101-110 as the uninterrupted run did. (d) Each kernel
   wrapper, given a card operand that requires grad, raises and launches
   nothing.
14. Serve Whisper-large-v3 (encoder-decoder, stub audio frontend) at full
   width and depth (32 + 32 layers, 1.54 B float32 parameters) through
   ``ServingEngine``: 8 requests x 1500 stub frames x 128-token prompts x
   32 new tokens, greedy; the prefill split into encoder, cross K/V and
   decoder; a profile of the decode step alone (wall against CUDA kernel
   time). Then the card against the CPU at full width, depth cut to 2 +
   2 layers, on the same weights: prefill logits, and 4 decode steps over
   the bf16 caches. No kernel of ours.
15. Train over EP: a world of 4 ranks on this card over gloo, as phase
   11, on a (data 1, model 4) mesh with ``remat``. (a) Reduced
   Qwen3-30B-A3B prepared by ``load_aware`` for the 4 ranks: the
   gradients of ``loss_fn`` and two AdamW steps on the card and on the
   CPU in each rank (TF32 off), at the float32 wire (bars as phase 13
   (a)) and at the default bf16 wire (the bf16 bars of
   tests/test_torch_train_world.py); at the float32 wire a sharded
   checkpoint after step 1 (the experts gathered over ``model``, the
   first rank writes), restored into a fresh model and state, runs step
   2 as the straight run did, bit for bit. (b) Qwen3-30B-A3B at full
   width, depth cut from 48 to 2 layers, ``none`` placed for the 4 ranks
   (32 of 128 experts each), 4 AdamW steps at 4 x 256: each rank's step
   time, tokens/s, the collectives' host time in the forward and in the
   backward pass (the remat recompute included), peak memory; one step
   with ``remat`` off (fewer collectives in its backward pass, which
   shows it ran without the recompute), and the peak of one forward and
   backward alone with and without ``remat``; the ranks' losses equal
   and their
   replicated leaves bit for bit equal (deterministic algorithms on).
   (c) Whisper-large-v3 at full width, 4 + 4 of 32 + 32 layers: one
   train step under the context against one without (rel 1e-5), prefill
   and a decode step under it. No kernel of ours.
16. The paper's drop metrics on the card: one Qwen3-30B-A3B MoE layer at
   full width (d 2048, 128 experts top-8, d_expert 768), seeded random
   weights, 2048 calibration tokens. (a) The Fig. 12 threshold -> drop-rate
   map, the per-layer thresholds over 4 routers, and the drop rate and
   FLOPs saved of a 2T routing, on router scores computed on the card,
   each equal bit for bit to the same function on a CPU copy. (b) Fig. 10:
   the layer prepared once (``partition_and_reconstruct``, P 2), then 2T
   calibrated to FLOPs-saved targets 0 (keep-all), 0.10, 0.25, 0.40 and
   0.50 on the timed tokens at T = 8, 1024 and 8192, one capacity per T
   (factor 2.0, no overflow): the realised drop rate and FLOPs saved, the
   fused kernel's time against its bound and its plain version, its row
   tiles, and the served MoE layer's time (routing, plan and kernel)
   beside 1 - FLOPs saved; how far time follows the drop is measured, not
   asserted. (c) The three walkthroughs (``repro_torch.examples``) through
   their ``main()`` on the card: quickstart, the serve example with 8
   requests (both launch the fused kernel) and the Fig. 4 fine-tune for 20
   steps.

Phases 3-5 also hold layer 0's MoE, on real hidden states at the shape each
path serves (sync prefill batch, prefill-insert, chunk), against the
kernel's plain version and the dense oracle (phase 9 likewise, per
policy, at DBRX widths); phases 7 and 8 hold the first Mamba2 layer's SSD
on real hidden states, through the kernel, against the plain chunked SSD
and the sequential-scan oracle. Each model is freed before the next.

Each serving path runs with every kernel's launch count and every plain
version's call count set to 0 just before it and read just after.

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

# published H100 SXM peaks (dense): HBM bytes/s, float32 FLOP/s on the
# CUDA cores (the MoE kernels' float32 few-row tile), TF32 FLOP/s on the
# tensor cores (three passes per product: ssd_chunk and the MoE kernels'
# float32 many-row tile) and bf16 FLOP/s on the tensor cores (the bf16 MoE
# tiles): the least time the card could take for their work
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
TF32_FLOPS = 495e12
BF16_FLOPS = 989e12
REL_TOL = 1e-5          # float32: the same products summed in another order
# bf16 operands: h rounded to bf16 and the output cast to bf16 on both
# sides; an h element whose float32 sums straddle a rounding boundary
# differs by one bf16 ulp
BF16_REL_TOL = 1e-3
DECAY_TOL = 1e-6        # ssd_chunk decay: exp of the same float32 cumsum
# the first Mamba2 layer's SSD through the kernel against the sequential
# scan: 384-512 float32 decay products per step against exp of cumsums
# accumulated in float64 (1.5e-6 to 4.5e-6 measured on the CPU)
ORACLE_TOL = 5e-5
N_LAYERS = 4            # depth cut of the serve phases (the model has 48)
KERNELS = ("fused_moe_pipeline", "grouped_swiglu", "ssd_chunk")
# (d, E, P, f, top_k) of DBRX-132B's MoE layer, partitioned P=2
DBRX_WIDTHS = (6144, 16, 2, 5376, 4)
DBRX_LAYERS = 3         # depth cut of phase 9 (the model has 40)


def free_memory() -> None:
    """Return the freed models' blocks to the card before the next one."""
    import gc
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def ptxas_report(text: str):
    """(kernel, registers, spilled bytes, static shared-memory bytes) of
    each entry function in an ``nvcc -Xptxas -v`` log."""
    import re
    rows, name, spill = [], None, 0
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name, spill = m.group(1), 0
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = int(m.group(1)) + int(m.group(2))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            smem = re.search(r"(\d+) bytes smem", line)
            rows.append((kernel_label(name), int(m.group(1)), spill,
                         int(smem.group(1)) if smem else 0))
            name = None
    return rows


def kernel_label(name: str) -> str:
    """A readable label for a mangled kernel name: the SwiGLU tiles as
    ``up_kernel<16x1, pipeline>`` (the float32 FMA few-row tile: rows x
    rows per thread), ``up_tf32_kernel<64, buffer, f32>`` (the float32
    3xTF32 many-row tile: rows) or ``up_mma_kernel<16, buffer, bf16>``
    (the bf16 tensor-core tiles: rows), other kernels by their name."""
    import re
    tile = re.search(r"(up|down)_kernelILi(\d+)ELi(\d+)ELb([01])E", name)
    if tile:
        return (f"{tile.group(1)}_kernel<{tile.group(2)}x{tile.group(3)}, "
                f"{'buffer' if tile.group(4) == '1' else 'pipeline'}>")
    tile = re.search(r"(up|down)_tf32_kernelILb([01])E", name)
    if tile:
        return (f"{tile.group(1)}_tf32_kernel<64, "
                f"{'buffer' if tile.group(2) == '1' else 'pipeline'}, f32>")
    tile = re.search(r"(up|down)_mma_kernelILi(\d+)ELb([01])E", name)
    if tile:
        return (f"{tile.group(1)}_mma_kernel<{tile.group(2)}, "
                f"{'buffer' if tile.group(3) == '1' else 'pipeline'}, bf16>")
    kern = re.search(r"([a-z_]*kernel)", name)
    return kern.group(1) if kern else name[:60]


# the SwiGLU tiles that run on the tensor cores: the bf16 tiles and the
# float32 many-row tile
TENSOR_CORE_TILES = ("_mma_kernel", "_tf32_kernel")


def sass_mma(lib: Path) -> dict:
    """label -> whether the kernel's SASS holds HMMA (tensor-core) ops, for
    each tensor-core tile of a built library, from ``cuobjdump -sass``."""
    import shutil
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, timeout=120, check=True).stdout
    found = {}
    for section in text.split("Function : ")[1:]:
        name = section.split(None, 1)[0]
        if any(tile in name for tile in TENSOR_CORE_TILES):
            found[kernel_label(name)] = "HMMA" in section
    return found


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

def op_seconds(w, flops: int, n_rows: int) -> tuple:
    """(seconds, seconds as PRs 14-22 counted them): the least time for one
    group's SwiGLU ``flops`` at the peak rate of the units that run its row
    tile. bf16 operands: the bf16 tensor cores. float32: the many-row tile
    (past FEW_ROWS live rows) as three TF32 passes on the tensor cores
    (3·FLOPs / TF32 rate, as ``ssd_bound``), the few-row tile as FMAs on the
    CUDA cores. The second counts every float32 FLOP at the CUDA-core rate,
    the bound before the many-row tile moved to the tensor cores."""
    import torch
    from repro_torch.kernels.dualsparse_ffn import FEW_ROWS
    if w.dtype == torch.bfloat16:
        return flops / BF16_FLOPS, flops / BF16_FLOPS
    core = flops / F32_FLOPS
    return (3 * flops / TF32_FLOPS if n_rows > FEW_ROWS else core), core


def _bound(nbytes: int, flops: int, t_ops: float, t_core: float):
    """(bound_ms, bound_by, flops, bytes, f32core_ms): the larger of the
    bytes over the HBM rate and the operations' time; ``f32core_ms`` the
    same with the operations' time as PRs 14-22 counted it."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", flops, nbytes,
            max(t_bytes, t_core) * 1e3)


def fused_bound(kw, T: int, d: int):
    """(bound_ms, bound_by, flops, bytes, f32core_ms) of one fused pipeline
    call: the bytes it must move (x read once, the weights of the neurons
    its rows need read once, the pair maps, the output written once) over
    the HBM rate, and each group's SwiGLU FLOPs over the rate of the units
    its row tile runs on (``op_seconds``); the larger of the two."""
    from repro_torch.kernels.dualsparse_ffn import resolve_n_major
    f = kw["w1"].shape[-1]
    P = kw["p_factor"]
    V = P * f
    n_major = resolve_n_major(f, P, kw["n_minor_start"], 128)
    cf = kw["counts_full"].tolist()
    cm = kw["counts_major"].tolist()
    n_pos = kw["tok_sorted"].shape[0]
    elem = kw["w1"].element_size()
    nbytes = 2 * T * d * elem + 4 * (3 * len(cf) + 2 * n_pos)
    flops, t_ops, t_core = 0, 0.0, 0.0
    for rows_f, rows_m in zip(cf, cm):
        if rows_f:
            nbytes += 3 * d * V * elem
        elif rows_m:
            nbytes += 3 * d * n_major * elem
        g_flops = 6 * d * (V * rows_f + n_major * rows_m)
        t, core = op_seconds(kw["w1"], g_flops,
                             min(rows_f + rows_m, kw["capacity"]))
        flops, t_ops, t_core = flops + g_flops, t_ops + t, t_core + core
    return _bound(nbytes, flops, t_ops, t_core)


# the skewed cases: a direction added to every token and to the router
# columns of HOT_EXPERTS experts lifts their logits by SKEW ** 2, so a few
# groups hold far more than FEW_ROWS rows and the rest a handful
HOT_EXPERTS = 6
SKEW = 4.0
# (name, d, E, P, f, top_k): the widths of the odd-width cases; the second
# is no multiple of 4 floats, so it takes the tiles' scalar edge path
ODD_WIDTHS = (("odd_width", 200, 8, 2, 100, 2),
              ("odd_width_scalar", 202, 8, 2, 98, 2))
# the float32 cases of phases 2 and 2b that also run on bf16 operands
BF16_TWINS = ("chunk", "skewed", "p1_sub_pairs", "overflow", "odd_width",
              "odd_width_scalar")


def moe_params(gen, dev, d: int, E: int, P: int, f: int) -> dict:
    """Seeded router and sub-expert weights: wg (d, E), w1/w3 (E*P, d, f),
    w2 (E*P, f, d)."""
    import torch

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale
    return dict(wg=randn(d, E, scale=0.1), w1=randn(E * P, d, f, scale=0.02),
                w3=randn(E * P, d, f, scale=0.02),
                w2=randn(E * P, f, d, scale=0.02))


def routed_case(gen, dev, cfg, params, T: int, P: int, n_empty: int = 0,
                hot: int = 0):
    """x (T, d) and its 2T sub-expert pairs: a router's routing under
    thresholds calibrated to a 25% drop target, so that rows are FULL,
    MAJOR-only and dropped. With ``n_empty`` the router covers experts
    n_empty.. only, so the first n_empty experts receive no row; with
    ``hot`` the experts n_empty..n_empty+hot draw most pairs (the load
    imbalance of the paper's Fig. 11)."""
    import torch
    from repro_torch.core import gating
    from repro_torch.core.drop import expand_pairs_2t
    from repro_torch.core.policy import TwoTDrop
    d = params["wg"].shape[0]
    x = torch.randn((T, d), generator=gen, device=dev)
    wg = params["wg"][:, n_empty:]
    if hot:
        v = torch.randn((d,), generator=gen, device=dev)
        v = v / v.norm()
        x = x + SKEW * v
        wg = wg.clone()
        wg[:, :hot] += SKEW * v[:, None]
    pol = TwoTDrop(drop_target=0.25)._calibrated([wg], cfg, x)
    r = gating.route(x, wg, cfg.top_k, cfg.router_norm_topk)
    pairs = expand_pairs_2t(r.idx + n_empty, r.combine, r.norm_score, P,
                            pol.t_major, pol.t_minor)
    return x, pairs


# S-ETP's local seating in the phase 11 world: 4 EP ranks, 128 experts x
# P 2 = 256 sub-experts, L = 64 on each rank; T_local = 256 tokens per rank
# at the 8 x 128 prefill (the sequence split over the ranks), 8 at decode
SETP_RANKS = 4
SETP_T_LOCAL = {"setp_prefill": 256, "setp_decode": 8}


def setp_local_case(gen, dev, cfg, params, T_local: int,
                    n_dev: int = SETP_RANKS):
    """What rank 0 of an ``n_dev``-rank S-ETP world hands its kernel: each
    source rank routes ``T_local`` tokens of a router under 2T thresholds
    calibrated to a 25% drop, seats its kept sub-pairs per destination
    rank at ``setp_moe_forward``'s default capacity, and rank 0 receives
    each source's block (bf16, the wire type); the received rows are then
    seated per local sub-expert (rank 0's strided shard) at the default
    local capacity. Returns (rx (n_dev * cap, d), the local DispatchPlan,
    the fused kernel's kwargs with bf16 weights, cap, c2)."""
    import torch
    from repro_torch.core import dispatch as D
    from repro_torch.core import gating, setp
    from repro_torch.core.policy import TwoTDrop
    d, E = params["wg"].shape
    K, P = cfg.top_k, 2
    Kp = K * P
    L = E * P // n_dev
    x = torch.randn((n_dev * T_local, d), generator=gen, device=dev)
    pol = TwoTDrop(drop_target=0.25)._calibrated([params["wg"]], cfg, x)
    cap = setp._ceil_mult(1.15 * T_local * Kp / n_dev)
    rows_x, rows_e = [], []
    for src in range(n_dev):
        xs = x[src * T_local:(src + 1) * T_local]
        r = gating.route(xs, params["wg"], K, cfg.router_norm_topk)
        sub_idx = (r.idx[:, :, None] * P + torch.arange(
            P, dtype=r.idx.dtype, device=dev)).reshape(T_local, Kp)
        score = r.norm_score[:, :, None].expand(T_local, K, P) \
            .reshape(T_local, Kp)
        keep = pol.sub_pair_keep(score, sub_idx % P == 0, sub_idx, cfg,
                                 n_dev=n_dev)
        plan = D.sort_dispatch(sub_idx % n_dev, keep, n_groups=n_dev,
                               capacity=cap)
        payload = (sub_idx // n_dev) * 2 + \
            D.major_only_flags(keep, P).to(sub_idx.dtype)
        rows_x.append(D.gather_rows(xs.bfloat16(), plan, cap,
                                    index_div=Kp)[0])
        rows_e.append(D.gather_rows(payload.reshape(-1), plan, cap,
                                    fill=-1)[0])
    rx, re2 = torch.cat(rows_x), torch.cat(rows_e)
    valid = re2 >= 0
    loc = torch.where(valid, re2 // 2, torch.zeros_like(re2))
    c2 = setp._ceil_mult(1.25 * n_dev * cap / L)
    plan = D.sort_dispatch(loc, valid, n_groups=L, capacity=c2,
                           major_only=valid & ((re2 & 1) == 1))
    cf, cm = plan.kernel_counts(c2)
    bc = min(128, c2)
    tok_s, w_s = D.sorted_pair_arrays(plan, valid.float(), pad=bc)
    shard = setp.expert_shard(setp.place_params_strided(params, n_dev),
                              n_dev, 0)
    kw = dict(w1=shard["w1"].bfloat16(), w3=shard["w3"].bfloat16(),
              w2=shard["w2"].bfloat16(), group_offsets=plan.group_offsets,
              counts_full=cf, counts_major=cm, tok_sorted=tok_s,
              combine_sorted=w_s, capacity=c2, p_factor=1,
              n_minor_start=shard["w1"].shape[-1], block_c=bc)
    return rx, plan, kw, cap, c2


def major_only_rows(kw):
    """The kernel kwargs with a quarter of each group's live rows FULL and
    the rest MAJOR-only, so that many-row groups hold row blocks with no
    FULL row: their MINOR h is written by no up tile."""
    full = kw["counts_full"] // 4
    return dict(kw, counts_full=full,
                counts_major=kw["counts_full"] + kw["counts_major"] - full)


def nan_scratch_run(launch, shape, w, spans, n_major: int):
    """``launch(h)`` on an h scratch of ``shape`` filled with NaN; returns
    its output and the NaN entries left in the MINOR columns (from
    ``n_major``) of the rows ``spans`` ([(start, stop), ...]: each group's
    MAJOR-only rows), the entries no up tile wrote, which the down tile's
    copies must zero-fill."""
    import torch
    h = torch.full(shape, float("nan"), dtype=w.dtype, device=w.device)
    out = launch(h)
    torch.cuda.synchronize()
    left = sum(int(torch.isnan(h[a:b, n_major:]).sum()) for a, b in spans)
    return out, left


def check_nan_masking(label: str, out, want, left: int) -> dict:
    """Fails unless the run over a NaN h scratch left NaN in some MINOR
    entry of a MAJOR-only row (the case reaches the masking) and gave the
    bits of the run over a fresh scratch."""
    import torch
    same = bool(torch.equal(out, want))
    log(f"    {label}: over a NaN-filled h scratch, {left} MINOR entries of "
        f"MAJOR-only rows left unwritten (NaN), output bit-identical to the "
        f"fresh-scratch run: {same}")
    if not (left > 0 and same):
        raise AssertionError(f"{label}: MINOR h masking not shown: {left} "
                             f"NaN entries left, bit-identical {same}")
    return dict(nan_h_left=left, nan_h_bit_identical=same)


def _as_bf16(kw):
    """The kernel kwargs with x / weights in bf16 (the rest as they are)."""
    return {k: v.bfloat16() if k in ("x", "w1", "w3", "w2") else v
            for k, v in kw.items()}


def _dev_us(ev) -> float:
    return getattr(ev, "self_device_time_total",
                   getattr(ev, "self_cuda_time_total", 0.0))


def launch_profile(fn, runs: int = 5) -> dict:
    """Device µs per call of ``fn`` by launch, from ``torch.profiler``:
    each row tile's up and down launches, the combine, the SSD's three
    launches, and the wrapper's own torch ops (every other kernel), apart;
    and the host's enqueue time per call."""
    import re
    import warnings
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels.dualsparse_ffn import FEW_ROWS
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(runs):
        fn()
    host_us = (time.perf_counter() - t0) / runs * 1e6
    torch.cuda.synchronize()
    with warnings.catch_warnings():     # the profiler's per-cycle notice
        warnings.simplefilter("ignore")
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(runs):
                fn()
            torch.cuda.synchronize()
    split, wrapper_kernels = {}, 0
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA \
                or _dev_us(ev) <= 0:
            continue
        m = re.search(r"(up|down)_(mma_|tf32_)?kernel<(\w+)", ev.key)
        if m:
            few = m.group(2) != "tf32_" and int(m.group(3)) == FEW_ROWS
            key = m.group(1) + ("_few" if few else "_many")
        elif "combine_kernel" in ev.key:
            key = "combine"
        elif "position_key_kernel" in ev.key:
            key = "keys"
        elif "ssd_prep_kernel" in ev.key:
            key = "ssd_prep"
        elif "ssd_y_kernel" in ev.key:
            key = "ssd_y"
        elif "ssd_states_kernel" in ev.key:
            key = "ssd_states"
        else:
            key = "wrapper_ops"
            wrapper_kernels += ev.count
        split[key] = split.get(key, 0.0) + _dev_us(ev) / runs
    return dict(device_us=split, wrapper_kernels=wrapper_kernels / runs,
                host_enqueue_us=host_us)


def tile_stats(launch, counts_full, counts_major, capacity: int,
               dtype) -> dict:
    """Which row tile served each group, as the kernel reports it
    (``launch(regime)`` fills an (E,) int32 buffer), checked against
    ``tile_plan`` for operands of ``dtype``; the row slots the tiles
    multiply beside the live rows and beside the slots of a row tile chosen
    from the capacity alone (16 rows at C <= 16, else blocks of 64)."""
    import torch
    from repro_torch.kernels.dualsparse_ffn import tile_plan
    regime = torch.zeros(counts_full.shape, dtype=torch.int32,
                         device=counts_full.device)
    launch(regime)
    torch.cuda.synchronize()
    want, slots = tile_plan(counts_full, counts_major, capacity, dtype)
    n_rows = torch.clamp(counts_full.long() + counts_major.long(),
                         max=capacity)
    got = regime.long()
    by_cap = 16 if capacity <= 16 else 64
    return dict(
        few_groups=int((got == 1).sum()), many_groups=int((got == 2).sum()),
        few_live_groups=int(((got == 1) & (n_rows > 0)).sum()),
        few_rows=int(n_rows[got == 1].sum()),
        many_rows=int(n_rows[got == 2].sum()), live_rows=int(n_rows.sum()),
        row_slots=int(slots.sum()),
        row_slots_capacity_tile=int(((n_rows + by_cap - 1) // by_cap
                                     * by_cap).sum()),
        max_rows=int(n_rows.max()), matches_plan=bool(torch.equal(got, want)))


def case_report(label: str, ms: float, bound, tiles: dict, prof: dict
                ) -> dict:
    """Logs a case's share of its bound (and of the bound PRs 14-22
    counted), achieved rate, row tiles and launch profile; returns them."""
    bound_ms, bound_by, flops, nbytes, f32core_ms = bound
    share = bound_ms / ms
    rate = (f"{nbytes / ms / 1e6:.1f} GB/s" if bound_by == "bytes"
            else f"{flops / ms / 1e9:.2f} TFLOP/s")
    dev = ", ".join(f"{k} {v:.1f}" for k, v in
                    sorted(prof["device_us"].items()))
    log(f"    {label}: {100 * share:.1f}% of the bound "
        f"({100 * f32core_ms / ms:.1f}% of the CUDA-core bound "
        f"{f32core_ms:.4f} ms), {rate}; tiles: few "
        f"{tiles['few_groups']} groups ({tiles['few_rows']} rows), many "
        f"{tiles['many_groups']} ({tiles['many_rows']} rows), max "
        f"{tiles['max_rows']}; row slots {tiles['row_slots']} for "
        f"{tiles['live_rows']} live rows (capacity-chosen tile: "
        f"{tiles['row_slots_capacity_tile']}); device µs per call: {dev}; "
        f"{prof['wrapper_kernels']:.0f} wrapper kernels; host enqueue "
        f"{prof['host_enqueue_us']:.1f} µs")
    if not tiles["matches_plan"]:
        raise AssertionError(f"{label}: the kernel's row tiles differ from "
                             "tile_plan")
    return dict(bound_share=share, bound_f32core_ms=f32core_ms,
                bound_f32core_share=f32core_ms / ms, rate=rate, tiles=tiles,
                profile=prof)


def kernel_phase(dev):
    """The fused MoE pipeline against its plain version at Qwen3-30B-A3B
    widths (d 2048, 128 experts, P 2, 384 neurons per sub-expert, top-8),
    at two odd widths (d 200 / f 100 and d 202 / f 98, 8 experts, top-2)
    and at DBRX-132B's (d 6144, 16 experts, P 2, f 5376, top-4: 4.2 GB per
    weight stack, past 32-bit byte offsets), with routing from a router
    and 2T thresholds calibrated to a 25% drop target, so that rows are
    FULL, MAJOR-only and dropped. The ``_bf16`` cases run bf16 operands
    (the S-ETP wire type, the tensor-core tiles, bar BF16_REL_TOL): decode
    and prefill at Qwen3 widths, S-ETP's local seating on rank 0 of phase
    11's world (``setp_local_case``), and twins of the ``BF16_TWINS``
    cases."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import moe
    from repro_torch.kernels import dualsparse_ffn, ops

    cfg = get_config("qwen3-moe-30b-a3b")
    d, E, K, P = cfg.d_model, cfg.n_experts, cfg.top_k, 2
    f = cfg.d_expert // P
    gen = torch.Generator(device=dev)
    gen.manual_seed(1234)
    params = moe_params(gen, dev, d, E, P, f)
    # the layer's capacity: capacity_for(T, K*P sub-pairs, E*P sub-experts)
    cap_decode = moe.capacity_for(8, K * P, E * P, 2.0)
    cap_prefill = moe.capacity_for(1024, K * P, E * P, 2.0)
    dd, de, dp, _, dk = DBRX_WIDTHS
    cases = [
        # name, T, capacity, mode_grouped, experts left empty, hot experts
        ("decode", 8, cap_decode, True, 0, 0),
        ("prefill", 1024, cap_prefill, True, 0, 0),
        ("overflow", 1024, 16, True, 0, 0),
        ("empty_experts", 1024, cap_prefill, True, E // 8, 0),
        ("p1_sub_pairs", 1024, cap_prefill, False, 0, 0),
        # the paged engine's fused route: a 64-token chunk, exact capacity
        ("chunk", 64, 64, True, 0, 0),
        ("skewed", 256, 256, True, 0, HOT_EXPERTS),
    ] + [(name, 64, 64, True, 0, 0) for name, *_ in ODD_WIDTHS] + [
        # DBRX-132B: a decode step and a 2048-token prefill at the serving
        # engine's capacity factor
        ("dbrx_decode", 8, moe.capacity_for(8, dk * dp, de * dp, 2.0), True,
         0, 0),
        ("dbrx_prefill", 2048, moe.capacity_for(2048, dk * dp, de * dp, 2.0),
         True, 0, 0),
        # bf16 operands: the wire type of the S-ETP path (the tensor-core
        # tiles), and bf16 twins of the cases above that exercise the
        # tiles' paths: both row tiles, P 1, overflow, both edge widths
        ("decode_bf16", 8, cap_decode, True, 0, 0),
        ("prefill_bf16", 1024, cap_prefill, True, 0, 0),
        ("setp_prefill_bf16", None, None, False, 0, 0),
        ("setp_decode_bf16", None, None, False, 0, 0)]
    cases += [(c[0] + "_bf16",) + c[1:] for c in cases
              if c[0] in BF16_TWINS]
    # DBRX-132B widths, three quarters of each group's rows MAJOR-only
    # (``major_only_rows``), over a NaN-filled h scratch; last, so that the
    # cases above draw the data they drew before it
    cases.append(("dbrx_major_only", 1024,
                  moe.capacity_for(1024, dk * dp, de * dp, 2.0), True, 0, 0))
    widths = {name: tuple(rest) for name, *rest in ODD_WIDTHS}
    widths.update(dbrx_decode=DBRX_WIDTHS, dbrx_prefill=DBRX_WIDTHS,
                  dbrx_major_only=DBRX_WIDTHS)
    case_params = {}
    results = []
    for name, T, cap, mode_grouped, n_empty, hot in cases:
        base = name.removesuffix("_bf16")
        bf16 = name != base
        ccfg, cparams, pp = cfg, params, P
        if base in widths:
            dd, EE, pp, ff, kk = widths[base]
            ccfg = dataclasses.replace(cfg, top_k=kk)
            if widths[base] not in case_params:
                case_params.clear()
                free_memory()
                case_params[widths[base]] = moe_params(gen, dev, dd, EE, pp,
                                                       ff)
            cparams = case_params[widths[base]]
        if name.startswith("setp_"):
            x, _, kw, _, cap = setp_local_case(gen, dev, cfg, params,
                                               SETP_T_LOCAL[base])
            T, overflow = x.shape[0], 0
        else:
            x, pairs = routed_case(gen, dev, ccfg, cparams, T, pp, n_empty,
                                   hot)
            kw, overflow = moe.fused_pipeline_args(cparams, pairs, pp, cap,
                                                   mode_grouped)
            if base == "dbrx_major_only":
                kw = major_only_rows(kw)
            if bf16:
                x, kw = x.bfloat16(), _as_bf16(kw)
        d_case = x.shape[1]
        y_ref = ops.fused_moe_pipeline_ref(x, **kw)
        y1 = ops.fused_moe_pipeline(x, **kw)
        y2 = ops.fused_moe_pipeline(x, **kw)
        torch.cuda.synchronize()
        rel = float((y1.float() - y_ref.float()).norm()
                    / y_ref.float().norm())
        max_abs = float((y1.float() - y_ref.float()).abs().max())
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
        bound = fused_bound(kw, T, d_case)
        bound_ms, bound_by, flops, nbytes, _ = bound
        n_major = dualsparse_ffn.resolve_n_major(
            kw["w1"].shape[-1], kw["p_factor"], kw["n_minor_start"], 128)
        tiles = tile_stats(
            lambda reg: dualsparse_ffn.launch_fused_moe_pipeline(
                x, kw["w1"], kw["w3"], kw["w2"], kw["group_offsets"], cf, cm,
                kw["tok_sorted"], kw["combine_sorted"], capacity=cap,
                p_factor=kw["p_factor"], n_major=n_major, regime=reg),
            cf, cm, cap, x.dtype)
        res = dict(case=name, T=T, d=d_case, f=kw["w1"].shape[-1],
                   capacity=cap, p_factor=kw["p_factor"], rows=rows,
                   dtype=str(x.dtype).replace("torch.", ""),
                   rel_err=rel, max_abs_err=max_abs, bit_stable=stable,
                   ms=ms, plain_ms=plain_ms, all_full_ms=full_ms,
                   bound_ms=bound_ms, bound_by=bound_by, flops=flops,
                   bytes=nbytes)
        results.append(res)
        log(f"  fused_moe_pipeline[{name}] T={T} d={d_case} cap={cap} "
            f"P={kw['p_factor']} rows={rows} rel_err={rel:.3e} "
            f"max_abs={max_abs:.3e} bit_stable={stable} ms={ms:.4f} "
            f"plain_ms={plain_ms:.4f} all_rows_full_ms={full_ms:.4f} "
            f"bound_ms={bound_ms:.4f} ({bound_by}; {flops / 1e9:.2f} GFLOP, "
            f"{nbytes / 1e6:.1f} MB)")
        # the kernel's combine gathers each token's rows by these keys
        keys_ok = bool(torch.equal(
            dualsparse_ffn.launch_position_keys(
                kw["tok_sorted"], kw["group_offsets"], cf, cm, cap),
            dualsparse_ffn.position_keys(kw["tok_sorted"],
                                         kw["group_offsets"], cf, cm)))
        res.update(case_report(
            f"fused_moe_pipeline[{name}]", ms, bound, tiles,
            launch_profile(lambda: ops.fused_moe_pipeline(x, **kw))),
            position_keys_equal=keys_ok)
        if base == "overflow" and rows["overflow"] == 0:
            raise AssertionError(f"{name}: the case did not overflow")
        if name == "empty_experts" and rows["empty"] < n_empty:
            raise AssertionError("empty-expert case has no empty expert")
        if base == "skewed" and not (tiles["many_groups"]
                                     and tiles["few_live_groups"]):
            raise AssertionError(f"{name}: one row tile served every group")
        # (a DBRX decode step holds only 32 pairs: it may have no MAJOR-only
        # row)
        if mode_grouped and rows["major"] == 0 and base not in (
                "overflow", "dbrx_decode"):
            raise AssertionError(f"{name}: no MAJOR-only rows")
        bar = BF16_REL_TOL if bf16 else REL_TOL
        if not (rel <= bar and stable and keys_ok
                and torch.isfinite(y1).all() and y1.dtype == x.dtype):
            raise AssertionError(f"fused_moe_pipeline[{name}] disagrees with "
                                 f"its plain version: rel_err={rel:.3e} "
                                 f"(bar {bar}) bit_stable={stable} "
                                 f"position_keys_equal={keys_ok}")
        if base == "dbrx_major_only":
            spans = [(o + a, o + min(a + b, cap)) for o, a, b in zip(
                kw["group_offsets"].tolist(), cf.tolist(), cm.tolist())]
            y_nan, left = nan_scratch_run(
                lambda h: dualsparse_ffn.launch_fused_moe_pipeline(
                    x, kw["w1"], kw["w3"], kw["w2"], kw["group_offsets"], cf,
                    cm, kw["tok_sorted"], kw["combine_sorted"], capacity=cap,
                    p_factor=kw["p_factor"], n_major=n_major, h=h),
                (kw["tok_sorted"].shape[0],
                 kw["p_factor"] * kw["w1"].shape[-1]), kw["w1"], spans,
                n_major)
            res.update(check_nan_masking(f"fused_moe_pipeline[{name}]",
                                         y_nan, y1, left))
    return results


def reset_counts() -> None:
    """Zero every kernel's launch counts and plain version's call count."""
    from repro_torch.kernels import ops
    for name in KERNELS:
        getattr(ops, name).launches = 0
        if hasattr(getattr(ops, name), "launches_bf16"):
            getattr(ops, name).launches_bf16 = 0
        getattr(ops, name + "_ref").calls = 0


def read_counts() -> dict:
    from repro_torch.kernels import ops
    out = {name: dict(launches=getattr(ops, name).launches,
                      plain_calls=getattr(ops, name + "_ref").calls)
           for name in KERNELS}
    for name in KERNELS:
        if hasattr(getattr(ops, name), "launches_bf16"):
            out[name]["launches_bf16"] = getattr(ops, name).launches_bf16
    return out


def grouped_bound(kw):
    """(bound_ms, bound_by, flops, bytes, f32core_ms) of one grouped SwiGLU
    call: the live rows read once, the whole (E, C, d) output written once,
    the weights of the neurons the live rows need read once and the counts,
    over the HBM rate; each group's SwiGLU FLOPs over the rate of the units
    its row tile runs on (``op_seconds``); the larger of the two."""
    from repro_torch.kernels.dualsparse_ffn import resolve_n_major
    E, C, d = kw["x"].shape
    f = kw["w1"].shape[-1]
    P = kw["p_factor"]
    V = P * f
    n_major = resolve_n_major(f, P, kw["n_minor_start"], 128)
    cf = kw["counts_full"].tolist()
    cm = kw["counts_major"].tolist()
    elem = kw["w1"].element_size()
    nbytes = E * C * d * elem + 2 * E * 4
    flops, t_ops, t_core = 0, 0.0, 0.0
    for rows_f, rows_m in zip(cf, cm):
        nbytes += (rows_f + rows_m) * d * elem
        if rows_f:
            nbytes += 3 * d * V * elem
        elif rows_m:
            nbytes += 3 * d * n_major * elem
        g_flops = 6 * d * (V * rows_f + n_major * rows_m)
        t, core = op_seconds(kw["w1"], g_flops, min(rows_f + rows_m, C))
        flops, t_ops, t_core = flops + g_flops, t_ops + t, t_core + core
    return _bound(nbytes, flops, t_ops, t_core)


def grouped_phase(dev):
    """The grouped SwiGLU (the buffer path's expert FFN) against its plain
    version at Qwen3-30B-A3B widths (d 2048, 128 experts, P 2, 384 neurons
    per sub-expert, top-8) and at the odd widths of phase 2, on the buffers
    and counts the buffer path builds from a router's routing under 2T
    thresholds calibrated to a 25% drop target. The dead rows of every
    buffer (at or past cf + cm) are filled with noise first: they must come
    out as exact zeros. The ``_bf16`` cases run bf16 operands: decode and
    prefill at Qwen3 widths, S-ETP's local buffers on rank 0 of phase 11's
    world (``setp_local_case``; its buffer path when a policy turns the
    fused pipeline off), and twins of the ``BF16_TWINS`` cases."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import moe
    from repro_torch.kernels import dualsparse_ffn, ops

    cfg = get_config("qwen3-moe-30b-a3b")
    d, E, K, P = cfg.d_model, cfg.n_experts, cfg.top_k, 2
    f = cfg.d_expert // P
    gen = torch.Generator(device=dev)
    gen.manual_seed(4321)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    params = moe_params(gen, dev, d, E, P, f)

    def full_width(w, axis):
        """(E*P, ...) sub-expert weights -> (E, ...) full-width experts
        (sub-expert j's neurons at [j*f, (j+1)*f) of the neuron axis)."""
        parts = w.reshape((E, P) + tuple(w.shape[1:])).unbind(1)
        return torch.cat(parts, dim=axis).contiguous()
    cap_prefill = moe.capacity_for(1024, K * P, E * P, 2.0)
    cases = [
        # name, T, capacity, mode_grouped, experts left empty, full width,
        # hot experts
        ("decode", 8, 8, True, 0, False, 0),
        ("chunk", 64, 64, True, 0, False, 0),    # the paged engine's chunk
        ("prefill", 1024, cap_prefill, True, 0, False, 0),
        ("p1_sub_pairs", 1024, cap_prefill, False, 0, False, 0),
        ("p1_half_split", 1024, cap_prefill, True, 0, True, 0),
        ("ragged", 1024, 100, True, E // 8, False, 0),
        ("skewed", 256, 256, True, 0, False, HOT_EXPERTS),
    ] + [(name, 64, 64, True, 0, False, 0) for name, *_ in ODD_WIDTHS] + [
        ("decode_bf16", 8, 8, True, 0, False, 0),
        ("prefill_bf16", 1024, cap_prefill, True, 0, False, 0),
        ("setp_prefill_bf16", None, None, False, 0, False, 0),
        ("setp_decode_bf16", None, None, False, 0, False, 0)]
    cases += [(c[0] + "_bf16",) + c[1:] for c in cases
              if c[0] in BF16_TWINS]
    # DBRX-132B widths, three quarters of each group's rows MAJOR-only
    # (``major_only_rows``), over a NaN-filled h scratch; last, so that the
    # cases above draw the data they drew before it
    _, dE, dP, _, dK = DBRX_WIDTHS
    cases.append(("dbrx_major_only", 1024,
                  moe.capacity_for(1024, dK * dP, dE * dP, 2.0), True, 0,
                  False, 0))
    odd = {name: rest for name, *rest in ODD_WIDTHS}
    odd["dbrx_major_only"] = DBRX_WIDTHS
    results = []
    for name, T, cap, mode_grouped, n_empty, widen, hot in cases:
        base = name.removesuffix("_bf16")
        bf16 = name != base
        ccfg, cparams, pp = cfg, params, P
        if base in odd:
            dd, EE, pp, ff, kk = odd[base]
            ccfg = dataclasses.replace(cfg, top_k=kk)
            cparams = moe_params(gen, dev, dd, EE, pp, ff)
        if name.startswith("setp_"):
            from repro_torch.core import dispatch
            rx, plan, fkw, _, cap = setp_local_case(gen, dev, cfg, params,
                                                    SETP_T_LOCAL[base])
            T, overflow = rx.shape[0], 0
            kw = dict(x=dispatch.gather_rows(rx, plan, cap),
                      **{k: fkw[k] for k in ("w1", "w3", "w2", "counts_full",
                                             "counts_major", "p_factor",
                                             "n_minor_start")})
        else:
            x, pairs = routed_case(gen, dev, ccfg, cparams, T, pp, n_empty,
                                   hot)
            kw, _, _, _, overflow = moe.grouped_swiglu_args(
                cparams, x, pairs, pp, cap, mode_grouped)
            if base == "dbrx_major_only":
                kw = major_only_rows(kw)
            if bf16:
                kw = _as_bf16(kw)
        d_case = kw["x"].shape[-1]
        if widen:      # the same experts unpartitioned: P = 1, split f // 2
            kw.update(w1=full_width(kw["w1"], 2), w3=full_width(kw["w3"], 2),
                      w2=full_width(kw["w2"], 1), p_factor=1,
                      n_minor_start=None)
        cf, cm = kw["counts_full"], kw["counts_major"]
        G, C = kw["x"].shape[:2]
        dead = (torch.arange(C, device=dev)[None, :]
                >= (cf + cm)[:, None])                           # (G, C)
        kw["x"] = torch.where(dead[..., None],
                              randn(G, C, d_case).to(kw["x"].dtype), kw["x"])
        # the kernel runs before the plain version: its output cannot land
        # in a freed block that already holds the plain version's result
        y1 = ops.grouped_swiglu(**kw)
        y2 = ops.grouped_swiglu(**kw)
        y_ref = ops.grouped_swiglu_ref(**kw)
        torch.cuda.synchronize()
        rel = float((y1.float() - y_ref.float()).norm()
                    / y_ref.float().norm())
        max_abs = float((y1.float() - y_ref.float()).abs().max())
        stable = bool(torch.equal(y1, y2))
        zeros = bool((y1[dead] == 0).all() and (y_ref[dead] == 0).all())
        rows = dict(full=int(cf.sum()), major=int(cm.sum()),
                    overflow=int(overflow), groups=G,
                    empty=int(((cf + cm) == 0).sum()))
        ms = cuda_ms(lambda: ops.grouped_swiglu(**kw), 20)
        plain_ms = cuda_ms(lambda: ops.grouped_swiglu_ref(**kw), 5)
        kw_full = dict(kw, counts_full=cf + cm,
                       counts_major=torch.zeros_like(cm))
        full_ms = cuda_ms(lambda: ops.grouped_swiglu(**kw_full), 20)
        bound = grouped_bound(kw)
        bound_ms, bound_by, flops, nbytes, _ = bound
        n_major = dualsparse_ffn.resolve_n_major(
            kw["w1"].shape[-1], kw["p_factor"], kw["n_minor_start"], 128)
        tiles = tile_stats(
            lambda reg: dualsparse_ffn.launch_grouped_swiglu(
                kw["x"], kw["w1"], kw["w3"], kw["w2"], cf, cm,
                p_factor=kw["p_factor"], n_major=n_major, regime=reg),
            cf, cm, C, kw["x"].dtype)
        res = dict(case=name, T=T, d=d_case, capacity=C,
                   p_factor=kw["p_factor"], f=kw["w1"].shape[-1], rows=rows,
                   dtype=str(kw["x"].dtype).replace("torch.", ""),
                   rel_err=rel, max_abs_err=max_abs, bit_stable=stable,
                   dead_rows_zero=zeros, ms=ms, plain_ms=plain_ms,
                   all_full_ms=full_ms, bound_ms=bound_ms, bound_by=bound_by,
                   flops=flops, bytes=nbytes)
        results.append(res)
        log(f"  grouped_swiglu[{name}] T={T} d={d_case} C={C} groups={G} "
            f"P={kw['p_factor']} f={kw['w1'].shape[-1]} rows={rows} "
            f"rel_err={rel:.3e} max_abs={max_abs:.3e} bit_stable={stable} "
            f"dead_rows_zero={zeros} ms={ms:.4f} plain_ms={plain_ms:.4f} "
            f"all_rows_full_ms={full_ms:.4f} bound_ms={bound_ms:.4f} "
            f"({bound_by}; {flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB)")
        res.update(case_report(
            f"grouped_swiglu[{name}]", ms, bound, tiles,
            launch_profile(lambda: ops.grouped_swiglu(**kw))))
        if name == "ragged" and (C % 64 == 0 or rows["empty"] < n_empty):
            raise AssertionError("ragged case is not ragged or has no "
                                 "empty expert")
        if base == "skewed" and not (tiles["many_groups"]
                                     and tiles["few_live_groups"]):
            raise AssertionError(f"{name}: one row tile served every group")
        if mode_grouped and name != "ragged" and rows["major"] == 0:
            raise AssertionError(f"{name}: no MAJOR-only rows")
        bar = BF16_REL_TOL if bf16 else REL_TOL
        if not (rel <= bar and stable and zeros
                and torch.isfinite(y1).all() and y1.dtype == kw["x"].dtype):
            raise AssertionError(f"grouped_swiglu[{name}] disagrees with its "
                                 f"plain version: rel_err={rel:.3e} (bar "
                                 f"{bar}) bit_stable={stable} "
                                 f"dead_rows_zero={zeros}")
        if base == "dbrx_major_only":
            spans = [(e * C + a, e * C + min(a + b, C)) for e, (a, b) in
                     enumerate(zip(cf.tolist(), cm.tolist()))]
            y_nan, left = nan_scratch_run(
                lambda h: dualsparse_ffn.launch_grouped_swiglu(
                    kw["x"], kw["w1"], kw["w3"], kw["w2"], cf, cm,
                    p_factor=kw["p_factor"], n_major=n_major, h=h),
                (G * C, kw["p_factor"] * kw["w1"].shape[-1]), kw["w1"], spans,
                n_major)
            res.update(check_nan_masking(f"grouped_swiglu[{name}]", y_nan, y1,
                                         left))
    return results


def layer0_hidden(model, cfg, tokens):
    """Layer 0's MoE input (B, S, d): the hidden states of ``tokens`` after
    layer 0's attention, as a prefill from position 0 computes them."""
    import torch
    from repro_torch.models import attention
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T_
    with torch.no_grad():
        blk = model.blocks[0]
        x, pos, _ = T_.embed_inputs(model, {"tokens": tokens}, cfg)
        x = x + attention.gqa_attention(
            blk.attn, L.rms_norm(x, blk.ln1, cfg.norm_eps), pos, cfg)
        return L.rms_norm(x, blk.ln2, cfg.norm_eps)


def layer0_check(label: str, model, cfg, policy, tokens, capacity,
                 fused: bool) -> dict:
    """Layer 0's MoE on the real hidden states of ``tokens`` (B, S) as a
    prefill from position 0 computes them (a sync prefill, a prefill-insert
    or a first chunk): the served kernel at the served ``capacity`` against
    its plain version on the same inputs (``capacity`` None: the policy's
    capacity for T tokens), and the served route at capacity T (no
    overflow) against the dense oracle ``moe_forward_ref``. Fails
    beyond REL_TOL. (The sub-pair buffer path seats pairs per sub-expert,
    so under overflow it keeps other pairs than the kernels do.) Also
    times the served call (median of 3 CUDA-event runs) beside its
    bound."""
    import torch
    from repro_torch.core import moe
    from repro_torch.kernels import ops
    with torch.no_grad():
        h = layer0_hidden(model, cfg, tokens).reshape(-1, cfg.d_model)
        layer = model.blocks[0].moe.weights()
        pairs = policy.route(layer, h, cfg)
        T = h.shape[0]
        if capacity is None:
            capacity = moe.capacity_for(T, pairs.idx.shape[1],
                                        layer["w1"].shape[0],
                                        policy.capacity_factor)
        if fused:
            name = "fused_moe_pipeline"
            kw, overflow = moe.fused_pipeline_args(layer, pairs, 2, capacity,
                                                   True)
            y_k = ops.fused_moe_pipeline(h, **kw)
            y_p = ops.fused_moe_pipeline_ref(h, **kw)
        else:
            name = "grouped_swiglu"
            kw, *_, overflow = moe.grouped_swiglu_args(layer, h, pairs, 2,
                                                       capacity, True)
            y_k = ops.grouped_swiglu(**kw)
            y_p = ops.grouped_swiglu_ref(**kw)
        y_exact = moe.moe_forward_dispatch(
            layer, h, cfg, pairs=pairs, capacity=T, use_kernel=True,
            mode_grouped=True, fused_pipeline=fused)
        y_ref = moe.moe_forward_ref(layer, h, cfg, pairs=pairs)

        if fused:
            ms = cuda_ms(lambda: ops.fused_moe_pipeline(h, **kw), 3)
            bound_ms, bound_by, *_ = fused_bound(kw, T, cfg.d_model)
        else:
            ms = cuda_ms(lambda: ops.grouped_swiglu(**kw), 3)
            bound_ms, bound_by, *_ = grouped_bound(kw)

    def rel(a, b):
        return float((a - b).norm() / b.norm())
    res = dict(kernel=name, T=T, capacity=capacity, overflow=int(overflow),
               rel_err_vs_plain=rel(y_k, y_p),
               rel_err_vs_dense_ref=rel(y_exact, y_ref),
               max_abs_err_vs_plain=float((y_k - y_p).abs().max()),
               ms=ms, bound_ms=bound_ms, bound_by=bound_by)
    log(f"  layer-0 MoE on {label}: {name} vs its plain version at capacity "
        f"{capacity} (T {T}, overflow {res['overflow']}) rel_err "
        f"{res['rel_err_vs_plain']:.3e}; the route at capacity T vs the "
        f"dense oracle rel_err {res['rel_err_vs_dense_ref']:.3e}; the "
        f"served call {ms:.3f} ms against a {bound_ms:.3f} ms bound "
        f"({bound_by})")
    if not (res["rel_err_vs_plain"] <= REL_TOL
            and res["rel_err_vs_dense_ref"] <= REL_TOL
            and torch.isfinite(y_k).all()):
        raise AssertionError(f"layer-0 MoE on {label} disagrees with its "
                             f"references")
    return res


# ---------------------------------------------------------------------------
# Phase 3: serve through the engine
# ---------------------------------------------------------------------------

def serve_phase(dev):
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.policy import make_policy
    from repro_torch.data.pipeline import SyntheticLM, calibration_activations
    from repro_torch.models import model as M
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

    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = eng.generate(prompts, GenerationConfig(max_new_tokens=NEW))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    launches = counts["fused_moe_pipeline"]["launches"]
    plain_calls = sum(c["plain_calls"] for c in counts.values())

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
    if counts["grouped_swiglu"]["launches"] != 0:
        raise AssertionError("the fused route launched grouped_swiglu")
    if launches != expected or plain_calls != 0:
        raise AssertionError(f"fused_moe_pipeline launched {launches} times "
                             f"(expected {expected}); plain version called "
                             f"{plain_calls} times (expected 0)")

    # the output is right: finite prefill logits of the right shape, and
    # layer 0's MoE on the batch's real hidden states at the policy's
    # capacity (overflow included) equal to its plain version
    batch = {"tokens": torch.from_numpy(np.stack(prompts)).long().to(dev)}
    logits, _ = M.make_prefill_step(cfg, cache_len=S + NEW,
                                    policy=policy)(model, batch)
    log(f"  prefill logits {tuple(logits.shape)} finite="
        f"{bool(torch.isfinite(logits).all())}")
    if tuple(logits.shape) != (B, S, cfg.vocab_size) \
            or not torch.isfinite(logits).all():
        raise AssertionError("prefill logits are not finite or misshaped")
    serve["layer0"] = layer0_check(f"the {B}x{S} prefill batch", model, cfg,
                                   policy, batch["tokens"], None, fused=True)
    serve["profile"] = profile_run(
        "1 prefill + 3 decode steps",
        lambda: eng.generate(prompts, GenerationConfig(max_new_tokens=4)))
    return serve, (cfg, model, policy, calib)


def profile_run(label: str, serve_once):
    """Where one more served run (``serve_once()``) spends its time: its
    wall time without the profiler, then the device time of every CUDA
    kernel under ``torch.profiler`` (top kernels by time) and the
    device-busy share = kernel time / unprofiled wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    serve_once()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        serve_once()
        torch.cuda.synchronize()

    kernels = [ev for ev in prof.key_averages()
               if ev.device_type == torch.autograd.DeviceType.CUDA
               and _dev_us(ev) > 0]
    busy_ms = sum(_dev_us(ev) for ev in kernels) / 1e3
    top = sorted(kernels, key=_dev_us, reverse=True)[:8]
    log(f"  profile ({label}): wall {wall_ms:.1f} ms "
        f"unprofiled, CUDA kernels {busy_ms:.1f} ms (device busy "
        f"{100 * busy_ms / wall_ms:.1f}%)")
    for ev in top:
        log(f"    {_dev_us(ev) / 1e3:9.3f} ms  x{ev.count:<5d} {ev.key[:70]}")
    return dict(wall_ms=wall_ms, device_busy_ms=busy_ms,
                top=[dict(name=ev.key, device_ms=_dev_us(ev) / 1e3,
                          count=ev.count) for ev in top])


# ---------------------------------------------------------------------------
# Phases 4 and 5: the slot engines
# ---------------------------------------------------------------------------

SLOTS, N_REQ, NEW_TOK, MAX_PROMPT, CHUNK = 8, 16, 16, 128, 64


def slot_prompts(vocab: int, shared: int = 0):
    """N_REQ prompts with lengths spread over 32..128 tokens; with
    ``shared``, the requests at even positions start with one common
    ``shared``-token prefix (half of them are admitted in the first wave
    of slots, half after the first sharers have registered their pages)."""
    import numpy as np
    from repro_torch.data.pipeline import SyntheticLM
    src = SyntheticLM(vocab, seed=1)
    rng = np.random.default_rng(1)
    lens = np.linspace(32, MAX_PROMPT, N_REQ).astype(int)
    rng.shuffle(lens)
    prefix = src.sample_batch(rng, 1, shared)["tokens"][0]
    prompts = []
    for i, n in enumerate(lens):
        p = src.sample_batch(rng, 1, int(n))["tokens"][0]
        if shared and i % 2 == 0:
            n = max(int(n), shared + 16)
            p = np.concatenate([prefix, src.sample_batch(
                rng, 1, n - shared)["tokens"][0]]).astype(np.int32)
        prompts.append(p)
    return prompts


def serve_slots(eng, prompts, budgets=None):
    """One measured run of every prompt (request i generating
    ``budgets[i]`` tokens, default NEW_TOK), with the counts zeroed just
    before and read just after. Returns (results, wall s, counts)."""
    import torch
    from repro_torch.serving import GenerationConfig
    budgets = budgets or [NEW_TOK] * len(prompts)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    uids = [eng.submit(p, GenerationConfig(max_new_tokens=n))
            for p, n in zip(prompts, budgets)]
    eng.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    results = [eng.result(u) for u in uids]
    if [len(r.tokens) for r in results] != list(budgets):
        raise AssertionError("a request did not return every token")
    return results, wall, counts


def slot_stats(eng, results, wall, counts) -> dict:
    import statistics
    n_tok = sum(len(r.tokens) for r in results)
    decode = eng.tracer.durations("decode")
    return dict(requests=len(results), tokens=n_tok, wall_s=wall,
                tok_per_s=n_tok / wall, decode_steps=eng.decode_steps,
                decode_step_ms=statistics.median(decode) * 1e3,
                max_concurrency=eng.max_concurrency,
                overflow_pairs=eng.overflow_pairs, counts=counts)


def continuous_phase(dev, cfg, model, policy):
    """``ContinuousBatchingEngine`` on the default (fused) route. The first
    wave of requests generates 9..16 tokens (the rest 16), so its slots
    free up one by one and later requests are admitted while the others
    decode."""
    import numpy as np
    import torch
    from repro_torch.serving import (ContinuousBatchingEngine,
                                     GenerationConfig)
    prompts = slot_prompts(cfg.vocab_size)
    budgets = [NEW_TOK - (SLOTS - 1 - i) if i < SLOTS else NEW_TOK
               for i in range(N_REQ)]
    kw = dict(n_slots=SLOTS, max_prompt_len=MAX_PROMPT,
              max_new_tokens=NEW_TOK, policy=policy, device=dev)
    ContinuousBatchingEngine(cfg, model, **kw).generate(
        prompts[:2], GenerationConfig(max_new_tokens=2))        # warm-up
    eng = ContinuousBatchingEngine(cfg, model, **kw)
    results, wall, counts = serve_slots(eng, prompts, budgets)
    st = slot_stats(eng, results, wall, counts)
    first_decode = min(ev["ts"] for ev in eng.tracer.events()
                       if ev["name"] == "decode")
    mid = sum(ev["ts"] > first_decode for ev in eng.tracer.events()
              if ev["name"] == "prefill_insert")
    st.update(prefill_inserts=eng.n_admitted, mid_decode_admissions=mid)
    log(f"  served {N_REQ} requests (prompts {min(map(len, prompts))}-"
        f"{max(map(len, prompts))} tokens) x {min(budgets)}-{max(budgets)} "
        f"new tokens on {SLOTS} slots: {st['tokens']} tokens in "
        f"{wall:.3f}s ({st['tok_per_s']:.1f} tok/s), {eng.n_admitted} "
        f"prefill-inserts ({mid} mid-decode), "
        f"{eng.decode_steps} decode steps (median {st['decode_step_ms']:.3f} "
        f"ms), max_concurrency {eng.max_concurrency}, overflow_pairs "
        f"{st['overflow_pairs']}; counts {counts}")
    expected = cfg.n_layers * (eng.n_admitted + eng.decode_steps)
    fused = counts["fused_moe_pipeline"]
    if fused["launches"] != expected or \
            counts["grouped_swiglu"]["launches"] != 0 or \
            any(c["plain_calls"] for c in counts.values()):
        raise AssertionError(f"continuous engine: fused launches "
                             f"{fused['launches']} (expected {expected}), "
                             f"counts {counts}")
    if eng.max_concurrency != SLOTS or eng.n_admitted != N_REQ or mid == 0:
        raise AssertionError("continuous engine: no mid-decode admission")
    # a prefill-insert as served: the prompt right-padded to MAX_PROMPT,
    # at exact capacity (the engine's policy)
    toks = np.zeros((1, MAX_PROMPT), np.int64)
    toks[0, :len(prompts[0])] = prompts[0]
    st["layer0"] = layer0_check(
        f"a {MAX_PROMPT}-token prefill-insert", model, cfg, eng.policy,
        torch.from_numpy(toks).to(dev), MAX_PROMPT, fused=True)
    st["profile"] = profile_run(
        f"{N_REQ} requests x 4 new tokens",
        lambda: eng.generate(prompts, GenerationConfig(max_new_tokens=4)))
    return st


def paged_phase(dev, cfg, model, calib):
    """``PagedEngine`` on the buffer path (grouped SwiGLU kernel), then on
    the fused route; layer 0's MoE on a real chunk on both routes."""
    import torch
    from repro_torch.core.policy import make_policy
    from repro_torch.serving import GenerationConfig, PagedEngine

    policy = make_policy("2t", cfg.dualsparse, drop_target=0.25,
                         use_kernel=True, fused_pipeline=False)
    policy = policy.calibrate(model, cfg, calib)
    prompts = slot_prompts(cfg.vocab_size, shared=64)
    kw = dict(n_slots=SLOTS, page_size=16, chunk_size=CHUNK,
              max_prompt_len=MAX_PROMPT, max_new_tokens=NEW_TOK, device=dev)
    PagedEngine(cfg, model, policy=policy, **kw).generate(
        prompts[:2], GenerationConfig(max_new_tokens=2))        # warm-up
    eng = PagedEngine(cfg, model, policy=policy, **kw)
    results, wall, counts = serve_slots(eng, prompts)
    st = slot_stats(eng, results, wall, counts)
    st.update(chunk_steps=eng.chunk_steps, prefix_hits=eng.prefix_hits,
              prefix_misses=eng.prefix_misses,
              prefix_hit_rate=eng.prefix_hit_rate)
    log(f"  buffer path: {st['tokens']} tokens in {wall:.3f}s "
        f"({st['tok_per_s']:.1f} tok/s), {eng.chunk_steps} chunk steps, "
        f"{eng.decode_steps} decode steps (median {st['decode_step_ms']:.3f} "
        f"ms), max_concurrency {eng.max_concurrency}, prefix hits "
        f"{eng.prefix_hits} / misses {eng.prefix_misses} (hit rate "
        f"{eng.prefix_hit_rate:.3f}), overflow_pairs {st['overflow_pairs']}; "
        f"counts {counts}")
    expected = cfg.n_layers * (eng.chunk_steps + eng.decode_steps)
    grouped = counts["grouped_swiglu"]
    if grouped["launches"] != expected or \
            counts["fused_moe_pipeline"]["launches"] != 0 or \
            any(c["plain_calls"] for c in counts.values()):
        raise AssertionError(f"paged engine: grouped_swiglu launches "
                             f"{grouped['launches']} (expected {expected}), "
                             f"counts {counts}")
    if not eng.prefix_hit_rate > 0:
        raise AssertionError("paged engine: no prefix-cache hit")
    st["profile"] = profile_run(
        f"buffer path, {N_REQ} requests x 4 new tokens, prefix cache warm",
        lambda: eng.generate(prompts, GenerationConfig(max_new_tokens=4)))

    # the same requests on the fused route: the two kernels sum in other
    # orders, so the share of equal greedy tokens is reported, not asserted
    fused_pol = make_policy("2t", cfg.dualsparse, drop_target=0.25)
    fused_pol = fused_pol.calibrate(model, cfg, calib)
    eng_f = PagedEngine(cfg, model, policy=fused_pol, **kw)
    results_f, wall_f, counts_f = serve_slots(eng_f, prompts)
    same = sum(a == b for r, rf in zip(results, results_f)
               for a, b in zip(r.tokens, rf.tokens))
    st.update(fused_route=slot_stats(eng_f, results_f, wall_f, counts_f),
              tokens_agree=same / st["tokens"])
    log(f"  fused route: {st['fused_route']['tok_per_s']:.1f} tok/s, decode "
        f"step median {st['fused_route']['decode_step_ms']:.3f} ms; greedy "
        f"tokens equal to the buffer path's: {same} of {st['tokens']} "
        f"({100 * same / st['tokens']:.1f}%)")

    # layer 0 on a real chunk, on each route: the first 64-token chunk of
    # a prompt is the prefill of those tokens from position 0, at exact
    # capacity (the engines' policies)
    toks = torch.from_numpy(prompts[0][None, :CHUNK]).long().to(dev)
    for e, fused in ((eng, False), (eng_f, True)):
        st["layer0_fused" if fused else "layer0"] = layer0_check(
            f"a {CHUNK}-token chunk", model, cfg, e.policy, toks, CHUNK,
            fused=fused)
    return st


# ---------------------------------------------------------------------------
# Phase 6: the intra-chunk SSD kernel against its plain version
# ---------------------------------------------------------------------------

def ssd_bound(BH: int, nc: int, Q: int, P: int, N: int, G: int):
    """(bound_ms, bound_by, flops, bytes, f32core_ms) of one ssd_chunk call
    with B/C in G group rows (G = BH: the TPU layout): the larger of the
    bytes it must move (each input read once, B and C once per group, each
    output written once) over the HBM rate and its products over the rate
    of the units that run them, three TF32 passes on the tensor cores
    (3·FLOPs / TF32 rate). FLOPs: the C·Bᵀ triangle (Q(Q+1)/2 pairs, 2N
    each) once per (group, chunk), and per (head, chunk) the triangle's M·x
    (2P per pair) and the states product (2·N·P·Q). ``f32core_ms``: the
    same bytes against FLOPs over the float32 CUDA-core rate, the bound
    before the products moved to the tensor cores."""
    tri = Q * (Q + 1) // 2
    nbytes = 4 * (BH * nc * Q * (2 * P + 1) + G * nc * Q * 2 * N + BH
                  + BH * nc * (N * P + 1))
    flops = G * nc * tri * 2 * N + BH * nc * (tri * 2 * P + 2 * N * P * Q)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = 3 * flops / TF32_FLOPS
    f32core_ms = max(t_bytes, flops / F32_FLOPS) * 1e3
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", flops, nbytes,
            f32core_ms)


def norm_rel(got, want) -> float:
    """Norm-relative error; 0 when both are all zeros (inputs whose chunk
    decays fall below float32's range)."""
    scale = float(want.double().norm())
    diff = float((got.double() - want.double()).norm())
    if scale == 0:
        return 0.0 if diff == 0 else float("inf")
    return diff / scale


def ssd_phase(dev):
    """``ssd_chunk`` against its plain version at the prefill shapes of
    the two serve phases (8 x 512 tokens of Mamba2-370m: BH 8 x 32 heads,
    2 chunks of 256, P 64, N 128; 8 x 384 tokens of Zamba2-7B: BH 8 x 112,
    one whole and one padded chunk, N 64), at Q = 128, and at the JAX
    kernel tests' odd shape, with B/C per head (the TPU layout); then at
    the two serve shapes with B/C per group, as the models pass them (one
    group: leading dimension 8), the second time at the Mamba2 shape with
    the layer's own draws (dt log-uniform in [1e-3, 1e-1], a = -U[1, 16]:
    neither L nor the decays fall below float32's range). Other inputs as
    the JAX kernel tests draw them: dt = softplus(N(0, 1)), a =
    -exp(0.5 N(0, 1))."""
    import math
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops
    gen = torch.Generator(device=dev)
    gen.manual_seed(2024)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    def model_draws(BH, nc, Q):
        lo, hi = math.log(1e-3), math.log(1e-1)
        dt = torch.exp(lo + (hi - lo) * torch.rand(
            (BH, nc, Q), generator=gen, device=dev))
        a = -(1.0 + 15.0 * torch.rand((BH,), generator=gen, device=dev))
        return dt, a
    cases = [("mamba2-370m", (256, 2, 256, 64, 128, 256), False),
             ("zamba2-7b", (896, 2, 256, 64, 64, 896), False),
             ("q128", (256, 4, 128, 64, 128, 256), False),
             ("jax_odd", (1, 5, 16, 8, 8, 1), False),
             ("mamba2-370m/grouped", (256, 2, 256, 64, 128, 8), False),
             ("zamba2-7b/grouped", (896, 2, 256, 64, 64, 8), False),
             ("mamba2-370m/grouped/model-draw", (256, 2, 256, 64, 128, 8),
              True)]
    results = []
    for name, (BH, nc, Q, P, N, G), model in cases:
        if model:
            dt, a = model_draws(BH, nc, Q)
        else:
            dt = F.softplus(randn(BH, nc, Q))
            a = -torch.exp(randn(BH) * 0.5)
        args = (randn(BH, nc, Q, P), dt, a, randn(G, nc, Q, N),
                randn(G, nc, Q, N))
        out1 = ops.ssd_chunk(*args)
        out2 = ops.ssd_chunk(*args)
        ref = ops.ssd_chunk_ref(*args)
        torch.cuda.synchronize()
        rel = {k: norm_rel(o, r) for k, o, r in zip(
            ("y", "states", "decay"), out1, ref)}
        max_abs = max(float((o - r).abs().max()) for o, r in zip(out1, ref))
        stable = all(torch.equal(a, b) for a, b in zip(out1, out2))
        finite = all(bool(torch.isfinite(o).all()) for o in out1)
        decay_min = float(out1[2].min())
        decay_live = float((out1[2] > 0).float().mean())
        ms = cuda_ms(lambda: ops.ssd_chunk(*args), 20)
        plain_ms = cuda_ms(lambda: ops.ssd_chunk_ref(*args), 5)
        bound_ms, bound_by, flops, nbytes, f32core_ms = ssd_bound(
            BH, nc, Q, P, N, G)
        prof = launch_profile(lambda: ops.ssd_chunk(*args))
        dev_total_us = sum(prof["device_us"].values()) or float("nan")
        res = dict(case=name, BH=BH, G=G, nc=nc, Q=Q, P=P, N=N,
                   model_draw=model, rel_err=rel, max_abs_err=max_abs,
                   bit_stable=stable, decay_min=decay_min,
                   decay_nonzero=decay_live, ms=ms,
                   plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                   bound_f32core_ms=f32core_ms, bound_share=bound_ms / ms,
                   bound_share_device=1e3 * bound_ms / dev_total_us,
                   flops=flops, bytes=nbytes, profile=prof)
        results.append(res)
        dev_us = ", ".join(f"{k} {v:.1f}" for k, v in
                           sorted(prof["device_us"].items()))
        log(f"  ssd_chunk[{name}] BH={BH} G={G} nc={nc} Q={Q} P={P} N={N} "
            f"rel_err y={rel['y']:.3e} states={rel['states']:.3e} "
            f"decay={rel['decay']:.3e} max_abs={max_abs:.3e} "
            f"bit_stable={stable} min_decay={decay_min:.3e} (nonzero "
            f"{100 * decay_live:.1f}%) ms={ms:.4f} "
            f"plain_ms={plain_ms:.4f} bound_ms={bound_ms:.4f} (3xTF32 "
            f"tensor cores, {bound_by}; {flops / 1e9:.2f} GFLOP, "
            f"{nbytes / 1e6:.1f} MB; {100 * bound_ms / ms:.1f}% of it, "
            f"{1e5 * bound_ms / dev_total_us:.1f}% of device time; "
            f"float32 CUDA-core bound {f32core_ms:.4f} ms); device µs per "
            f"call: {dev_us}; host "
            f"enqueue {prof['host_enqueue_us']:.1f} µs")
        if not (rel["y"] <= REL_TOL and rel["states"] <= REL_TOL
                and rel["decay"] <= DECAY_TOL and stable and finite):
            raise AssertionError(f"ssd_chunk[{name}] disagrees with its "
                                 f"plain version: {rel} (bars {REL_TOL} / "
                                 f"decay {DECAY_TOL}) bit_stable={stable} "
                                 f"finite={finite}")
        # the model's draws keep the decays as values, not zeros (a rare
        # head with a near -16 and a long dt sum may still underflow)
        if model and decay_live < 0.99:
            raise AssertionError(f"ssd_chunk[{name}]: {decay_live:.3f} of "
                                 "the chunk decays are nonzero")
    return results


# ---------------------------------------------------------------------------
# Phases 7 and 8: serve Mamba2-370m and Zamba2-7B
# ---------------------------------------------------------------------------

def mamba_layer0_check(label: str, model, cfg, tokens) -> dict:
    """The first Mamba2 layer's SSD on the real hidden states of ``tokens``
    (for the hybrid: after the first shared-block occurrence), at the
    prefill's chunk of 256: through the kernel (``ssd_chunked_kernel``)
    against the plain chunked SSD (bar REL_TOL) and the sequential-scan
    oracle (bar ORACLE_TOL), on y and the final state."""
    import torch
    from repro_torch.models import attention
    from repro_torch.models import layers as L
    from repro_torch.models import mamba2 as mm
    from repro_torch.models import transformer as T_
    with torch.no_grad():
        x, pos, _ = T_.embed_inputs(model, {"tokens": tokens}, cfg)
        if cfg.family == "hybrid":
            sh = model.shared_attn
            x = x + attention.gqa_attention(
                sh.attn, L.rms_norm(x, sh.ln1, cfg.norm_eps), pos, cfg)
            x = x + L.apply_mlp(sh.mlp, L.rms_norm(x, sh.ln2, cfg.norm_eps),
                                cfg.mlp_kind)
            blk = model.mamba_blocks[0]
        else:
            blk = model.blocks[0]
        _, _, args = mm.ssd_inputs(blk.mamba, L.rms_norm(x, blk.ln1,
                                                         cfg.norm_eps), cfg)
        y_k, h_k = mm.ssd_chunked_kernel(*args, chunk=256)
        y_p, h_p = mm.ssd_chunked(*args, chunk=256)
        y_r, h_r = mm.ssd_reference(*args)
    res = dict(S=int(tokens.shape[1]),
               rel_err_vs_plain=max(norm_rel(y_k, y_p), norm_rel(h_k, h_p)),
               rel_err_vs_oracle=max(norm_rel(y_k, y_r), norm_rel(h_k, h_r)),
               max_abs_err_vs_plain=max(float((y_k - y_p).abs().max()),
                                        float((h_k - h_p).abs().max())))
    log(f"  layer-0 SSD on {label}: kernel route vs ssd_chunked rel_err "
        f"{res['rel_err_vs_plain']:.3e}, vs the sequential oracle "
        f"{res['rel_err_vs_oracle']:.3e} (y and final state)")
    if not (res["rel_err_vs_plain"] <= REL_TOL
            and res["rel_err_vs_oracle"] <= ORACLE_TOL
            and torch.isfinite(y_k).all()):
        raise AssertionError(f"layer-0 SSD on {label} disagrees with its "
                             f"references")
    return res


def recurrent_serve_phase(dev, arch: str, S: int):
    """``arch`` at full width and depth through ``ServingEngine``: 8
    requests x ``S``-token prompts (equal lengths: no left padding) x 16
    new tokens, greedy; a warm-up engine first, then the measured run with
    the counts zeroed just before and read just after."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models import model as M
    from repro_torch.serving import GenerationConfig, ServingEngine

    cfg = get_config(arch)
    t0 = time.perf_counter()
    model = M.init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"  config {arch}: d_model {cfg.d_model}, d_inner {cfg.d_inner}, "
        f"{cfg.ssm_heads} SSM heads x P {cfg.ssm_head_dim}, N "
        f"{cfg.ssm_state}, {cfg.n_layers} Mamba2 layers"
        + (f", shared block ({cfg.n_heads} heads x {cfg.resolved_head_dim}, "
           f"d_ff {cfg.d_ff}) before every {cfg.attn_every}th"
           if cfg.family == "hybrid" else "")
        + f", vocab {cfg.vocab_size}; full depth, seeded random weights; "
        f"init {time.perf_counter() - t0:.2f}s, {n_params / 1e9:.2f} B "
        f"float32 parameters")
    B, NEW = 8, 16
    src = SyntheticLM(cfg.vocab_size, seed=0)
    rng = np.random.default_rng(0)
    prompts = [src.sample_batch(rng, 1, S)["tokens"][0] for _ in range(B)]
    kw = dict(batch_size=B, max_prompt_len=S, max_new_tokens=NEW, device=dev)
    ServingEngine(cfg, model, **kw).generate(
        prompts, GenerationConfig(max_new_tokens=2))          # warm-up
    eng = ServingEngine(cfg, model, **kw)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = eng.generate(prompts, GenerationConfig(max_new_tokens=NEW))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    launches = counts["ssd_chunk"]["launches"]
    plain_calls = sum(c["plain_calls"] for c in counts.values())
    n_tok = sum(len(r.tokens) for r in results)
    decode_steps = NEW - 1
    serve = dict(
        arch=arch, layers=cfg.n_layers, requests=B, prompt_len=S,
        new_tokens=NEW, tokens=n_tok, wall_s=wall, tok_per_s=n_tok / wall,
        prefill_ms=results[0].prefill_s * 1e3,
        decode_step_ms=results[0].decode_s / decode_steps * 1e3,
        launches=launches, plain_calls=plain_calls, counts=counts,
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    log(f"  served {B} requests x {S}-token prompts x {NEW} new tokens: "
        f"{n_tok} tokens in {wall:.3f}s ({serve['tok_per_s']:.1f} tok/s), "
        f"prefill {serve['prefill_ms']:.2f} ms, decode step "
        f"{serve['decode_step_ms']:.3f} ms (mean of {decode_steps}); "
        f"ssd_chunk launches={launches}, plain-version calls={plain_calls}; "
        f"peak memory {serve['peak_mem_gb']:.2f} GB")
    if not all(len(r.tokens) == NEW for r in results):
        raise AssertionError("a request did not return every token")
    # one prefill (one convoy batch) launches the kernel once per Mamba2
    # layer; decode launches none
    if launches != cfg.n_layers or plain_calls != 0 or \
            counts["fused_moe_pipeline"]["launches"] or \
            counts["grouped_swiglu"]["launches"]:
        raise AssertionError(f"{arch}: ssd_chunk launched {launches} times "
                             f"(expected {cfg.n_layers}); counts {counts}")
    batch = {"tokens": torch.from_numpy(np.stack(prompts)).long().to(dev)}
    logits, cache = M.make_prefill_step(cfg, cache_len=S + NEW)(model, batch)
    states = cache["mamba"] if cfg.family == "hybrid" else cache["layers"]
    finite = bool(torch.isfinite(logits).all()) and all(
        bool(torch.isfinite(st["ssm"]).all()) for st in states)
    log(f"  prefill logits {tuple(logits.shape)}, {len(states)} Mamba "
        f"states, finite={finite}")
    if tuple(logits.shape) != (B, S, cfg.vocab_size) or not finite:
        raise AssertionError("prefill logits or states are not finite or "
                             "misshaped")
    del logits, cache, states
    serve["layer0"] = mamba_layer0_check(f"the {B}x{S} prefill batch", model,
                                         cfg, batch["tokens"])
    serve["profile"] = profile_run(
        "1 prefill + 3 decode steps",
        lambda: eng.generate(prompts, GenerationConfig(max_new_tokens=4)))
    return serve


# ---------------------------------------------------------------------------
# Phase 9: DBRX-132B under 2t, load_aware and per_layer
# ---------------------------------------------------------------------------

def fig11_proxy(dev, cfg, layer, n_devices: int = 4) -> dict:
    """Paper Fig. 11 on one card, set up as
    ``benchmarks/bench_fig11_load_aware.py`` does: layer 0's router
    sharpened x20 and skewed toward the first E/8 experts (one modelled
    device), 2048 calibration tokens, n_devices contiguous expert blocks,
    T_max the 30% quantile of the keep-all scores. The skew is a unit
    direction added x2 to those experts' router columns and to the tokens,
    as phase 2's skewed case does (the benchmark's constant column offset
    meets zero-mean activations, so it skews no device). For 2T
    (T_max ± gap) and load-aware at the same T_max: the makespan (largest
    modelled device load, in kept sub-pairs) relative to keep-all, the drop
    rate, and the MoE output's error against keep-all (dense oracle). A
    single-card proxy of the EP step time, not a measured EP speedup."""
    import numpy as np
    import torch
    from repro_torch.core import drop, gating
    from repro_torch.core import moe
    from repro_torch.core.policy import LoadAwareTwoT, TwoTDrop
    from repro_torch.data.pipeline import calibration_activations
    E = cfg.n_experts
    per_dev = E // n_devices
    layer = dict(layer)
    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    v = torch.randn((cfg.d_model,), generator=gen, device=dev)
    v = v / v.norm()
    layer["wg"] = layer["wg"] * 20.0
    layer["wg"][:, :E // 8] += 2.0 * v[:, None]
    x = calibration_activations(np.random.default_rng(4), 2048, cfg.d_model,
                                device=dev) + 2.0 * v
    r = gating.route(x, layer["wg"], cfg.top_k, cfg.router_norm_topk)
    t_max = float(torch.quantile(r.norm_score.reshape(-1), 0.3))
    gap = max(min(0.01, t_max * 0.2), 1e-4)

    def stats(pairs):
        dev_of = (pairs.idx.long() // 2) // per_dev
        loads = torch.zeros(n_devices, device=dev).index_add_(
            0, dev_of[pairs.keep], torch.ones_like(dev_of[pairs.keep],
                                                   dtype=torch.float32))
        with torch.no_grad():
            y = moe.moe_forward_ref(layer, x, cfg, pairs=pairs)
        return loads, y
    keep_all = TwoTDrop(partition_p=2, t_major=-1.0, t_minor=-1.0)
    loads0, y0 = stats(keep_all.route(layer, x, cfg))
    ms0 = float(loads0.max())
    out = dict(t_max=t_max, t_gap=gap, n_devices=n_devices,
               keep_all_loads=loads0.tolist())
    for label, pol in (
            ("2t", TwoTDrop(partition_p=2, t_major=t_max - gap,
                            t_minor=t_max + gap)),
            ("load_aware", LoadAwareTwoT(partition_p=2, n_devices=n_devices,
                                         t_max=t_max, t_gap=gap))):
        pairs = pol.route(layer, x, cfg)
        loads, y = stats(pairs)
        ms = float(loads.max())
        out[label] = dict(
            makespan_rel=ms / ms0, speedup=ms0 / ms, loads=loads.tolist(),
            drop_rate=float(drop.drop_rate(pairs)),
            rel_err=float((y - y0).norm() / y0.norm()))
        log(f"  Fig. 11 proxy (single card, {n_devices} modelled EP devices, "
            f"keep-all loads {[int(v) for v in loads0.tolist()]}), {label} "
            f"at T_max {t_max:.4f} ± {gap:.4f}: makespan "
            f"{out[label]['makespan_rel']:.4f} of keep-all (proxy speedup "
            f"{out[label]['speedup']:.3f}x), drop rate "
            f"{out[label]['drop_rate']:.4f}, rel_err vs keep-all "
            f"{out[label]['rel_err']:.4f}")
    if not out["load_aware"]["drop_rate"] < out["2t"]["drop_rate"]:
        raise AssertionError("Fig. 11 proxy: load-aware does not drop less "
                             "than 2T at the same T_max")
    return out


def served_stats(eng, results, wall, counts, new_tokens: int) -> dict:
    """tok/s, prefill and decode-step times, drop rate and peak memory of
    one measured ``ServingEngine`` run (one convoy batch)."""
    import torch
    n_tok = sum(len(r.tokens) for r in results)
    st = dict(tokens=n_tok, wall_s=wall, tok_per_s=n_tok / wall,
              prefill_ms=results[0].prefill_s * 1e3,
              decode_step_ms=results[0].decode_s / (new_tokens - 1) * 1e3,
              counts=counts,
              peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    if eng.metrics_enabled:
        c = eng.metrics().counters
        sub = {o: int(c.get(f'repro_moe_subpairs_total{{outcome="{o}"}}', 0))
               for o in ("kept_full", "kept_major", "dropped")}
        st.update(sub, drop_rate=sub["dropped"] / max(sum(sub.values()), 1),
                  overflow_pairs=eng.overflow_pairs)
    return st


def dbrx_phase(dev) -> dict:
    """DBRX-132B at full width, depth cut to DBRX_LAYERS, served under
    ``2t``, ``load_aware`` and ``per_layer`` (see the module docstring)."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.policy import make_policy
    from repro_torch.data.pipeline import SyntheticLM, calibration_activations
    from repro_torch.models import model as M
    from repro_torch.serving import GenerationConfig, ServingEngine

    full = get_config("dbrx-132b")
    cfg = dataclasses.replace(full, n_layers=DBRX_LAYERS)
    B, S, NEW = 4, 1536, 16
    log(f"  config {cfg.arch_id}: full width (d_model {cfg.d_model}, "
        f"{cfg.n_heads} heads / {cfg.n_kv_heads} kv, {cfg.n_experts} experts "
        f"top-{cfg.top_k}, d_expert {cfg.d_expert}, vocab {cfg.vocab_size}); "
        f"depth cut from {full.n_layers} to {cfg.n_layers} layers; seeded "
        f"random float32 weights; {B} x {S} x {NEW}")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = M.init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    resident = torch.cuda.memory_allocated() / 1e9
    calib = calibration_activations(np.random.default_rng(7), 512,
                                    cfg.d_model, device=dev)
    t0 = time.perf_counter()
    per_layer = make_policy("per_layer", cfg.dualsparse, drop_target=0.25)
    model, per_layer = per_layer.prepare(model, cfg, calib)
    torch.cuda.synchronize()
    prep_s = time.perf_counter() - t0
    prep_peak = torch.cuda.max_memory_allocated() / 1e9
    two = make_policy("2t", cfg.dualsparse, drop_target=0.25)
    two = two.calibrate(model, cfg, calib)
    tm, tn = float(two.t_major), float(two.t_minor)
    la = dataclasses.replace(make_policy("load_aware", cfg.dualsparse,
                                         n_devices=4),
                             t_max=(tm + tn) / 2, t_gap=(tn - tm) / 2)
    ths = [[round(float(v), 5) for v in b.moe.thresholds]
           for b in model.blocks]
    out = dict(layers=cfg.n_layers, layers_full_model=full.n_layers,
               requests=B, prompt_len=S, new_tokens=NEW, init_s=init_s,
               resident_gb=resident, prepare_s=prep_s,
               prepare_peak_gb=prep_peak, t_major=tm, t_minor=tn,
               per_layer_thresholds=ths)
    log(f"  init {init_s:.2f}s ({resident:.2f} GB resident), per_layer "
        f"prepare {prep_s:.2f}s (peak {prep_peak:.2f} GB); 2t thresholds "
        f"({tm:.5f}, {tn:.5f}); load_aware T_max {la.t_max:.5f} ± "
        f"{la.t_gap:.5f} over 4 modelled devices; per-layer thresholds "
        f"{ths}")

    src = SyntheticLM(cfg.vocab_size, seed=0)
    rng = np.random.default_rng(0)
    prompts = [src.sample_batch(rng, 1, S)["tokens"][0] for _ in range(B)]
    tokens = torch.from_numpy(np.stack(prompts)).long().to(dev)
    kw = dict(batch_size=B, max_prompt_len=S, max_new_tokens=NEW, device=dev)
    ServingEngine(cfg, model, policy=two, **kw).generate(
        prompts, GenerationConfig(max_new_tokens=2))          # warm-up
    for name, pol in (("2t", two), ("load_aware", la),
                      ("per_layer", per_layer)):
        eng = ServingEngine(cfg, model, policy=pol, **kw)
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results = eng.generate(prompts, GenerationConfig(max_new_tokens=NEW))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
        st = served_stats(eng, results, wall, counts, NEW)
        launches = counts["fused_moe_pipeline"]["launches"]
        st["launches"] = launches
        log(f"  {name}: {st['tokens']} tokens in {wall:.3f}s "
            f"({st['tok_per_s']:.1f} tok/s), prefill {st['prefill_ms']:.2f} "
            f"ms, decode step {st['decode_step_ms']:.3f} ms (mean of "
            f"{NEW - 1}); drop rate {st['drop_rate']:.4f} (kept_full "
            f"{st['kept_full']}, kept_major {st['kept_major']}, dropped "
            f"{st['dropped']}), overflow_pairs {st['overflow_pairs']}; "
            f"fused_moe_pipeline launches {launches}; peak memory "
            f"{st['peak_mem_gb']:.2f} GB")
        expected = cfg.n_layers * NEW
        if not all(len(r.tokens) == NEW for r in results):
            raise AssertionError("a request did not return every token")
        if launches != expected or counts["grouped_swiglu"]["launches"] or \
                any(c["plain_calls"] for c in counts.values()):
            raise AssertionError(f"dbrx {name}: fused launches {launches} "
                                 f"(expected {expected}), counts {counts}")
        st["layer0"] = layer0_check(f"the DBRX {B}x{S} prefill batch under "
                                    f"{name}", model, cfg, pol, tokens, None,
                                    fused=True)
        st["profile"] = profile_run(
            f"{name}, 1 prefill + 3 decode steps",
            lambda: eng.generate(prompts, GenerationConfig(max_new_tokens=4)))
        out[name] = st
        del eng, results
    logits, _ = M.make_prefill_step(cfg, cache_len=S + NEW, policy=la)(
        model, {"tokens": tokens})
    finite = bool(torch.isfinite(logits).all())
    log(f"  prefill logits {tuple(logits.shape)} finite={finite}")
    if tuple(logits.shape) != (B, S, cfg.vocab_size) or not finite:
        raise AssertionError("prefill logits are not finite or misshaped")
    del logits
    out["fig11_proxy"] = fig11_proxy(dev, cfg, model.blocks[0].moe.weights())
    return out


# ---------------------------------------------------------------------------
# Phase 10: the dense and VLM decoders
# ---------------------------------------------------------------------------

def blockwise_check(model, cfg, tokens) -> dict:
    """Layer 0's attention on the real hidden states of ``tokens`` after
    the vision stub's zero patch embeddings: ``blockwise_attention``
    against ``plain_attention`` on the card (bar REL_TOL), with their
    times."""
    import torch
    from repro_torch.models import attention as A
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    from repro_torch.models import transformer as T_
    with torch.no_grad():
        batch = {"tokens": tokens,
                 **M.frontend_inputs(cfg, tokens.shape[0], tokens.device)}
        x, pos, _ = T_.embed_inputs(model, batch, cfg)
        blk = model.blocks[0]
        q, k, v = A.gqa_project_qkv(blk.attn, L.rms_norm(x, blk.ln1,
                                                         cfg.norm_eps),
                                    pos, cfg)
        o_b = A.blockwise_attention(q, k, v)
        o_p = A.plain_attention(q, k, v)
        rel = float((o_b - o_p).norm() / o_p.norm())
        res = dict(S=int(x.shape[1]), rel_err=rel,
                   max_abs_err=float((o_b - o_p).abs().max()),
                   blockwise_ms=cuda_ms(lambda: A.blockwise_attention(q, k,
                                                                      v), 5),
                   plain_ms=cuda_ms(lambda: A.plain_attention(q, k, v), 5))
    log(f"  layer-0 attention at S={res['S']} (B {tokens.shape[0]}): "
        f"blockwise vs plain_attention rel_err {rel:.3e} (bar {REL_TOL}); "
        f"blockwise {res['blockwise_ms']:.3f} ms, plain "
        f"{res['plain_ms']:.3f} ms")
    if not (rel <= REL_TOL and torch.isfinite(o_b).all()):
        raise AssertionError("blockwise attention disagrees with "
                             "plain_attention")
    return res


# (arch, depth (None: full), requests, text tokens per prompt, new tokens)
DENSE_CASES = (("qwen2-vl-7b", None, 4, 256, 16),
               ("qwen2-7b", None, 4, 512, 16),
               ("starcoder2-3b", None, 4, 512, 16),
               ("granite-20b", 24, 4, 512, 16))


def dense_serve(dev, arch: str, n_layers, B: int, S: int, NEW: int,
                continuous: bool = False) -> dict:
    """One dense or VLM decoder through ``ServingEngine`` (a warm-up engine
    first, then the measured run, counts zeroed just before and read just
    after: these models run no kernel of ours); for the VLM also the
    blockwise check; for the VLM and with ``continuous`` also through
    ``ContinuousBatchingEngine``."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models import model as M
    from repro_torch.serving import (ContinuousBatchingEngine,
                                     GenerationConfig, ServingEngine)
    full = get_config(arch)
    cfg = dataclasses.replace(full, n_layers=n_layers) if n_layers else full
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = M.init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    prefix = M.frontend_len(cfg)
    log(f"  {arch}: d_model {cfg.d_model}, {cfg.n_heads} heads / "
        f"{cfg.n_kv_heads} kv, d_ff {cfg.d_ff} ({cfg.mlp_kind}), "
        f"{cfg.n_layers} layers"
        + (f" (depth cut from {full.n_layers})" if n_layers else
           " (full depth)")
        + (f", M-RoPE {cfg.mrope_sections}, {prefix} vision-stub tokens"
           if prefix else "")
        + f"; init {time.perf_counter() - t0:.2f}s, {n_params / 1e9:.2f} B "
        f"float32 parameters; {B} x ({prefix} + {S}) x {NEW}")
    src = SyntheticLM(cfg.vocab_size, seed=0)
    rng = np.random.default_rng(0)
    prompts = [src.sample_batch(rng, 1, S)["tokens"][0] for _ in range(B)]
    kw = dict(batch_size=B, max_prompt_len=S, max_new_tokens=NEW, device=dev)
    ServingEngine(cfg, model, **kw).generate(
        prompts, GenerationConfig(max_new_tokens=2))          # warm-up
    eng = ServingEngine(cfg, model, **kw)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = eng.generate(prompts, GenerationConfig(max_new_tokens=NEW))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    st = served_stats(eng, results, wall, counts, NEW)
    st.update(arch=arch, layers=cfg.n_layers, layers_full_model=full.n_layers,
              requests=B, prompt_len=S, prefix=prefix, new_tokens=NEW,
              params_b=n_params / 1e9)
    log(f"  served {B} x ({prefix} + {S}) x {NEW}: {st['tokens']} tokens in "
        f"{wall:.3f}s ({st['tok_per_s']:.1f} tok/s), prefill "
        f"{st['prefill_ms']:.2f} ms, decode step {st['decode_step_ms']:.3f} "
        f"ms (mean of {NEW - 1}); peak memory {st['peak_mem_gb']:.2f} GB")
    if not all(len(r.tokens) == NEW for r in results):
        raise AssertionError("a request did not return every token")
    if any(c["launches"] or c["plain_calls"] for c in counts.values()):
        raise AssertionError(f"{arch}: a dense model called a MoE or SSD "
                             f"kernel: {counts}")
    tokens = torch.from_numpy(np.stack(prompts)).long().to(dev)
    batch = {"tokens": tokens, **M.frontend_inputs(cfg, B, dev)}
    logits, cache = M.make_prefill_step(cfg, cache_len=prefix + S + NEW)(
        model, batch)
    finite = bool(torch.isfinite(logits).all())
    log(f"  prefill logits {tuple(logits.shape)}, cache pos {cache['pos']}, "
        f"finite={finite}")
    if tuple(logits.shape) != (B, S, cfg.vocab_size) or not finite or \
            cache["pos"] != prefix + S:
        raise AssertionError("prefill logits are not finite or misshaped")
    del logits, cache
    st["profile"] = profile_run(
        "1 prefill + 3 decode steps",
        lambda: eng.generate(prompts, GenerationConfig(max_new_tokens=4)))
    del eng
    if prefix:
        st["blockwise"] = blockwise_check(model, cfg, tokens)
    if prefix or continuous:
        ckw = dict(n_slots=B, max_prompt_len=S, max_new_tokens=NEW,
                   device=dev)
        ContinuousBatchingEngine(cfg, model, **ckw).generate(
            prompts[:1], GenerationConfig(max_new_tokens=2))  # warm-up
        ceng = ContinuousBatchingEngine(cfg, model, **ckw)
        cprompts = prompts + [p[: S // 2] for p in prompts]
        results, wall, counts = serve_slots(ceng, cprompts,
                                            [NEW] * len(cprompts))
        st["continuous"] = slot_stats(ceng, results, wall, counts)
        log(f"  continuous ({B} slots, {len(cprompts)} requests of "
            f"{prefix} + {S // 2}-{S} tokens): "
            f"{st['continuous']['tokens']} tokens in {wall:.3f}s "
            f"({st['continuous']['tok_per_s']:.1f} tok/s), "
            f"{ceng.n_admitted} prefill-inserts, {ceng.decode_steps} decode "
            f"steps (median {st['continuous']['decode_step_ms']:.3f} ms)")
        if ceng.n_admitted != len(cprompts) or \
                ceng.max_concurrency != B:
            raise AssertionError("continuous engine: not every request "
                                 "admitted")
    return st


# ---------------------------------------------------------------------------
# Phase 11: S-ETP over a world of 4 ranks on the one card, and ETP
# ---------------------------------------------------------------------------

EP_B, EP_S, EP_NEW = 8, 128, 16
EP_SLOTS, EP_REQ, EP_CONT_NEW = 4, 8, 8
EP_TIMEOUT_S = 300      # a collective that waits longer raises on its rank
# the paged run's page pool: twice the slots' demand, so no registered
# prefix page is evicted before a later sharer is admitted
EP_PAGES = 1 + 2 * EP_SLOTS * -(-(MAX_PROMPT + EP_CONT_NEW) // 16)


class plain_kernels:
    """Within the block the MoE wrappers' names point at their plain
    versions, so a run of the S-ETP body computes the same function
    through ``kernels.ref`` on the same inputs (the wrappers' counts stay
    untouched)."""

    def __enter__(self):
        from repro_torch.kernels import ops
        self._saved = (ops.fused_moe_pipeline, ops.grouped_swiglu)
        ops.fused_moe_pipeline = ops.fused_moe_pipeline_ref
        ops.grouped_swiglu = ops.grouped_swiglu_ref

    def __exit__(self, *exc):
        from repro_torch.kernels import ops
        ops.fused_moe_pipeline, ops.grouped_swiglu = self._saved


def timed_collectives(ctx):
    """A copy of the EP context (every field) whose collectives add their
    host time, the card synchronised before and after each, to
    ``spent["ms"]`` / ``spent["calls"]``, and those that autograd's
    backward pass runs (a remat recompute's included) also to
    ``spent["backward_ms"]`` / ``spent["backward_calls"]``."""
    import torch
    from repro_torch.distributed import DistContext
    spent = {"ms": 0.0, "calls": 0, "backward_ms": 0.0, "backward_calls": 0}

    class Timed(DistContext):
        def _timed(self, name, *args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = getattr(DistContext, name)(self, *args)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            spent["ms"] += ms
            spent["calls"] += 1
            if torch._C._current_graph_task_id() != -1:
                spent["backward_ms"] += ms
                spent["backward_calls"] += 1
            return out

        def psum(self, t, axis):
            return self._timed("psum", t, axis)

        def all_to_all(self, t, axis):
            return self._timed("all_to_all", t, axis)

        def all_gather(self, t, axis):
            return self._timed("all_gather", t, axis)

        def psum_scatter(self, t, axis):
            return self._timed("psum_scatter", t, axis)

    return Timed(**{f.name: getattr(ctx, f.name)
                    for f in dataclasses.fields(ctx)}), spent


def _unplace(w, n_dev: int):
    """Placement order -> sub-expert id order (``to_strided_order``'s
    inverse)."""
    L = w.shape[0] // n_dev
    return w.reshape((n_dev, L) + tuple(w.shape[1:])).transpose(0, 1) \
        .reshape(w.shape)


def _ep_prepare(rank: int, ctx, cfg, tokens, dev):
    """The Qwen3 model on this rank: every rank in turn builds the seeded
    model, prepares it under ``load_aware`` placed for the ranks' strided
    layout and keeps its expert shard (one prepared copy on the card at a
    time). Rank 0 also computes layer 0's reference while it holds every
    expert: the single-process dispatch path under keep-all 2T at capacity
    T, on the prepared layer in sub-expert id order."""
    import gc
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.core import moe, setp
    from repro_torch.core.policy import TwoTDrop, make_policy
    from repro_torch.data.pipeline import calibration_activations
    from repro_torch.models import model as M
    n = ctx.size("model")
    model = policy = y_ref = None
    info = {}
    for turn in range(n):
        if rank == turn:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model = M.init_params(cfg, seed=0, device=dev)
            calib = calibration_activations(np.random.default_rng(7), 512,
                                            cfg.d_model, device=dev)
            policy = make_policy("load_aware", cfg.dualsparse)
            model, policy = policy.prepare(model, cfg, calib,
                                           n_ep_devices=n)
            if rank == 0:
                with torch.no_grad():
                    h = layer0_hidden(model, cfg, tokens)
                    h = h.reshape(-1, cfg.d_model)
                    layer = model.blocks[0].moe.weights()
                    for k in ("w1", "w3", "w2"):
                        layer[k] = _unplace(layer[k], n)
                    keep_all = TwoTDrop(partition_p=2, t_major=-1.0,
                                        t_minor=-1.0)
                    y_ref = moe.moe_forward_dispatch(
                        layer, h, cfg, pairs=keep_all.route(layer, h, cfg),
                        capacity=h.shape[0], mode_grouped=True)
                del layer, h
            info["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
            setp.shard_experts(model, ctx)
            del calib
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.synchronize()
            info["prepare_s"] = time.perf_counter() - t0
            info["resident_gb"] = torch.cuda.memory_allocated() / 1e9
        dist.barrier()
    return model, policy, y_ref, info


def join_ep_world(rank: int, out: Path, dev_type: str):
    """This rank's setup in a world of SETP_RANKS processes on the one card
    (TF32 off, two host threads, gloo over a FileStore under ``out``):
    returns the rank's device."""
    import datetime
    import torch
    import torch.distributed as dist
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(2)          # 4 ranks share the host's cores
    torch.cuda.set_device(0)
    dist.init_process_group(
        "gloo", store=dist.FileStore(str(out / "store"), SETP_RANKS),
        rank=rank, world_size=SETP_RANKS,
        timeout=datetime.timedelta(seconds=EP_TIMEOUT_S))
    return torch.device(dev_type)


def ep_rank(rank: int, out: str, dev_type: str) -> None:
    """One rank of phase 11 (run by ``ep_phase`` in its own process, all
    ranks on the one device of type ``dev_type``, gloo over a FileStore).
    Writes ``rank<r>.json``; any failure raises out of the process."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.core import moe, setp
    from repro_torch.core.policy import TwoTDrop
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.distributed import DistContext, make_mesh
    from repro_torch.serving import (ContinuousBatchingEngine,
                                     GenerationConfig, PagedEngine,
                                     ServingEngine)
    out = Path(out)
    dev = join_ep_world(rank, out, dev_type)
    ctx = DistContext(make_mesh((1, SETP_RANKS), ("data", "model")))
    full = get_config("qwen3-moe-30b-a3b")
    cfg = dataclasses.replace(full, n_layers=N_LAYERS)
    src = SyntheticLM(cfg.vocab_size, seed=0)
    rng = np.random.default_rng(0)
    prompts = [src.sample_batch(rng, 1, EP_S)["tokens"][0]
               for _ in range(EP_B)]
    tokens = torch.from_numpy(np.stack(prompts)).long().to(dev)
    res = dict(rank=rank)
    model, policy, y_ref, res["prepare"] = _ep_prepare(rank, ctx, cfg,
                                                       tokens, dev)
    res["expert_shape"] = list(model.blocks[0].moe.w1.shape)

    # layer 0 on real hidden states (every rank: its replicated attention)
    d = cfg.d_model
    layer = model.blocks[0].moe.weights()
    with torch.no_grad():
        h = layer0_hidden(model, cfg, tokens)
        keep_all = TwoTDrop(partition_p=2, t_major=-1.0, t_minor=-1.0)
        y32, of32 = setp.setp_moe_forward(
            layer, h, cfg, ctx, policy=keep_all, wire_dtype=torch.float32,
            cap_factor=4.0, local_cap_factor=8.0, return_overflow=True)
        y_k = setp.setp_moe_forward(layer, h, cfg, ctx, policy=policy)
        # the layer's host time at the prefill and decode shapes, and the
        # share of it inside the collectives
        timing = {}
        for label, xin in (("prefill", h), ("decode", h[:, -1:])):
            tctx, spent = timed_collectives(ctx)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            setp.setp_moe_forward(layer, xin, cfg, tctx, policy=policy)
            torch.cuda.synchronize()
            timing[label] = dict(layer_ms=(time.perf_counter() - t0) * 1e3,
                                 collective_ms=spent["ms"],
                                 collectives=spent["calls"])
        # the cast of this rank's float32 experts to the wire type that
        # opens every S-ETP layer call (core/setp.py:118), alone
        local = [layer[k] for k in ("w1", "w3", "w2")]
        weight_cast = dict(
            ms=cuda_ms(lambda: [w.to(torch.bfloat16) for w in local], 5),
            read_mb=sum(w.numel() * 4 for w in local) / 1e6,
            written_mb=sum(w.numel() * 2 for w in local) / 1e6)
        with plain_kernels():
            y_p = setp.setp_moe_forward(layer, h, cfg, ctx, policy=policy)
        # the paged run's shapes: one slot's (1, CHUNK) chunk (CHUNK /
        # SETP_RANKS tokens on each rank) and a decode batch of EP_SLOTS
        # tokens (replicated over the ranks); the kernels against their
        # plain versions, and their launches counted to show they ran here
        paged_shapes = {}
        for label, xin in (("chunk", h[:1, :CHUNK]),
                           ("decode", h[:EP_SLOTS, -1:])):
            reset_counts()
            y_kp = setp.setp_moe_forward(layer, xin, cfg, ctx,
                                         policy=policy)
            launched = {k: v["launches_bf16"]
                        for k, v in read_counts().items()
                        if v.get("launches_bf16")}
            with plain_kernels():
                y_pp = setp.setp_moe_forward(layer, xin, cfg, ctx,
                                             policy=policy)
            diff = y_kp.float() - y_pp.float()
            paged_shapes[label] = dict(
                shape=list(xin.shape), launches_bf16=launched,
                rel_err=float(diff.norm() / y_pp.float().norm()),
                max_abs_err=float(diff.abs().max()),
                finite=bool(torch.isfinite(y_kp).all()))
        torch.cuda.synchronize()
    check = dict(
        overflow_f32=int(of32), timing_bf16=timing, weight_cast=weight_cast,
        rel_err_bf16_vs_plain=float((y_k.float() - y_p.float()).norm()
                                    / y_p.float().norm()),
        max_abs_err_bf16_vs_plain=float((y_k.float() - y_p.float())
                                        .abs().max()),
        finite=bool(torch.isfinite(y_k).all() and torch.isfinite(y32).all()),
        paged_shapes=paged_shapes)
    if rank == 0:
        y32 = y32.reshape(-1, d)
        check.update(rel_err_f32_vs_dispatch=float(
            (y32 - y_ref).norm() / y_ref.norm()),
            max_abs_err_f32_vs_dispatch=float((y32 - y_ref).abs().max()))
    res["layer0"] = check
    del y32, y_k, y_p, y_ref, h

    # serve: the sync engine, then the continuous engine on the buffer path
    # (the grouped SwiGLU kernel), each rank in SPMD
    kw = dict(batch_size=EP_B, max_prompt_len=EP_S, max_new_tokens=EP_NEW,
              policy=policy, device=dev, dist=ctx)
    ServingEngine(cfg, model, **kw).generate(
        prompts, GenerationConfig(max_new_tokens=2))          # warm-up
    eng = ServingEngine(cfg, model, **kw)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = eng.generate(prompts, GenerationConfig(max_new_tokens=EP_NEW))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    st = served_stats(eng, results, wall, read_counts(), EP_NEW)
    st["tokens_out"] = [r.tokens for r in results]
    res["sync"] = st

    cpol = dataclasses.replace(policy, use_kernel=True, fused_pipeline=False)
    ckw = dict(n_slots=EP_SLOTS, max_prompt_len=MAX_PROMPT,
               max_new_tokens=EP_CONT_NEW, policy=cpol, exact_moe=False,
               device=dev, dist=ctx)
    cprompts = slot_prompts(cfg.vocab_size)[:EP_REQ]
    ContinuousBatchingEngine(cfg, model, **ckw).generate(
        cprompts[:1], GenerationConfig(max_new_tokens=2))     # warm-up
    ceng = ContinuousBatchingEngine(cfg, model, **ckw)
    cres, cwall, ccounts = serve_slots(ceng, cprompts,
                                       [EP_CONT_NEW] * EP_REQ)
    cst = slot_stats(ceng, cres, cwall, ccounts)
    cst.update(prefill_inserts=ceng.n_admitted,
               tokens_out=[r.tokens for r in cres])
    res["continuous"] = cst

    # the paged engine: chunked prefill and paged decode, S-ETP in every
    # chunk step and decode step (the default route: the fused kernel at
    # the bf16 wire), half the requests sharing a 64-token prefix; the
    # measured run's collectives timed (the card synchronised around each)
    pkw = dict(n_slots=EP_SLOTS, page_size=16, chunk_size=CHUNK,
               max_prompt_len=MAX_PROMPT, max_new_tokens=EP_CONT_NEW,
               n_pages=EP_PAGES, policy=policy, exact_moe=False, device=dev)
    pprompts = slot_prompts(cfg.vocab_size, shared=64)[:EP_REQ]
    PagedEngine(cfg, model, dist=ctx, **pkw).generate(
        pprompts[:1], GenerationConfig(max_new_tokens=2))     # warm-up
    tctx, spent = timed_collectives(ctx)
    peng = PagedEngine(cfg, model, dist=tctx, **pkw)
    pres, pwall, pcounts = serve_slots(peng, pprompts,
                                       [EP_CONT_NEW] * EP_REQ)
    pst = slot_stats(peng, pres, pwall, pcounts)
    pst.update(chunk_steps=peng.chunk_steps,
               chunk_step_ms=statistics.median(
                   peng.tracer.durations("prefill_chunk")) * 1e3,
               prefix_hits=peng.prefix_hits,
               prefix_misses=peng.prefix_misses,
               prefix_hit_rate=peng.prefix_hit_rate,
               collective_ms=spent["ms"], collectives=spent["calls"],
               tokens_out=[r.tokens for r in pres])
    res["paged"] = pst
    del eng, ceng, peng, model
    free_memory()

    # ETP: one layer at Qwen3 widths on (ep 2, tp 2) against the oracle
    ectx = DistContext(make_mesh((2, 2), ("ep", "tp")))
    gen = torch.Generator(device=dev)
    gen.manual_seed(99)
    full_layer = moe_params(gen, dev, d, cfg.n_experts, 1, cfg.d_expert)
    x = torch.randn((4, 64, d), generator=gen, device=dev)
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y = setp.etp_moe_forward(setp.etp_shard(full_layer, ectx), x, cfg,
                                 ectx, cap_factor=4.0, local_cap_factor=8.0)
        torch.cuda.synchronize()
        etp = dict(ms=(time.perf_counter() - t0) * 1e3,
                   finite=bool(torch.isfinite(y).all()))
        if rank == 0:
            want = moe.moe_forward_ref(full_layer, x.reshape(-1, d), cfg)
            y = y.reshape(-1, d)
            etp.update(rel_err=float((y - want).norm() / want.norm()),
                       max_abs_err=float((y - want).abs().max()))
    res["etp"] = etp
    (out / f"rank{rank}.json").write_text(json.dumps(res))
    dist.barrier()
    dist.destroy_process_group()


def ep_phase(dev) -> dict:
    """Phase 11: spawn the 4 ranks (one process each, all on ``dev``'s
    card, gloo over a FileStore under build/), wait for them (a failing
    rank fails the phase), read their results and hold them to the
    bars."""
    import shutil
    import torch.multiprocessing as mp
    from repro_torch.configs import get_config
    cfg = get_config("qwen3-moe-30b-a3b")
    out = ROOT / "build" / "ep_world"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    t0 = time.perf_counter()
    mp.spawn(ep_rank, args=(str(out), dev.type), nprocs=SETP_RANKS,
             join=True)
    wall = time.perf_counter() - t0
    ranks = [json.loads((out / f"rank{r}.json").read_text())
             for r in range(SETP_RANKS)]
    r0 = ranks[0]
    shard = [cfg.n_experts * 2 // SETP_RANKS, cfg.d_model, cfg.d_expert // 2]
    st, cst, chk = r0["sync"], r0["continuous"], r0["layer0"]
    log(f"  {SETP_RANKS} ranks in {wall:.1f}s (spawn to join); each holds "
        f"experts {r0['expert_shape']} per layer; prepare (rank by rank): "
        + ", ".join(f"{r['prepare']['prepare_s']:.2f}s / "
                    f"{r['prepare']['resident_gb']:.2f} GB resident"
                    for r in ranks)
        + f"; rank 0 prepare peak {r0['prepare']['peak_gb']:.2f} GB")
    log(f"  layer 0 on the {EP_B}x{EP_S} prompts: S-ETP keep-all 2T at the "
        f"float32 wire vs the one-process dispatch path rel_err "
        f"{chk['rel_err_f32_vs_dispatch']:.3e} (bar {REL_TOL:g}, overflow "
        f"{chk['overflow_f32']}); S-ETP load_aware at the bf16 wire, "
        f"kernels vs plain versions: rel_err "
        + ", ".join(f"{r['layer0']['rel_err_bf16_vs_plain']:.3e}"
                    for r in ranks)
        + f" (ranks 0-3, bar {BF16_REL_TOL:g}); the bf16 layer call "
        "(host clock, rank 0): "
        + ", ".join(f"{k} {v['layer_ms']:.2f} ms of which "
                    f"{v['collective_ms']:.2f} ms in {v['collectives']} "
                    "collectives" for k, v in chk["timing_bf16"].items())
        + f"; its first step, the cast of the rank's float32 experts to bf16 "
        f"(CUDA events, median of 5, 4 ranks sharing the card): "
        f"{chk['weight_cast']['ms']:.3f} ms, "
        f"{chk['weight_cast']['read_mb']:.1f} MB read, "
        f"{chk['weight_cast']['written_mb']:.1f} MB written")
    log(f"  sync, rank 0: {st['tokens']} tokens in {st['wall_s']:.3f}s "
        f"({st['tok_per_s']:.1f} tok/s), prefill {st['prefill_ms']:.2f} ms, "
        f"decode step {st['decode_step_ms']:.3f} ms (mean of "
        f"{EP_NEW - 1}); drop rate {st['drop_rate']:.4f} (kept_full "
        f"{st['kept_full']}, kept_major {st['kept_major']}, dropped "
        f"{st['dropped']}), overflow_pairs {st['overflow_pairs']}; counts "
        + "; ".join(f"rank {r['rank']} {r['sync']['counts']}"
                    for r in ranks))
    log(f"  continuous (buffer path), rank 0: {cst['tokens']} tokens in "
        f"{cst['wall_s']:.3f}s ({cst['tok_per_s']:.1f} tok/s), "
        f"{cst['prefill_inserts']} prefill-inserts, {cst['decode_steps']} "
        f"decode steps (median {cst['decode_step_ms']:.3f} ms), overflow "
        f"{cst['overflow_pairs']}; grouped_swiglu bf16 launches per rank "
        + ", ".join(str(r['continuous']['counts']['grouped_swiglu']
                        ['launches_bf16']) for r in ranks))
    log("  layer 0 at the paged run's shapes, S-ETP load_aware at the bf16 "
        "wire, kernels vs plain versions (ranks 0-3, bar "
        f"{BF16_REL_TOL:g}): "
        + "; ".join(f"{k} {v['shape']} rel_err "
                    + ", ".join(f"{r['layer0']['paged_shapes'][k]['rel_err']:.3e}"
                                for r in ranks)
                    + f" (bf16 launches on rank 0: {v['launches_bf16']})"
                    for k, v in chk["paged_shapes"].items()))
    pst = r0["paged"]
    log(f"  paged (page 16, chunk {CHUNK}, {EP_SLOTS} slots, {EP_REQ} "
        f"requests, 4 sharing a 64-token prefix), rank 0: {pst['tokens']} "
        f"tokens in {pst['wall_s']:.3f}s ({pst['tok_per_s']:.1f} tok/s), "
        f"{pst['chunk_steps']} chunk steps (median "
        f"{pst['chunk_step_ms']:.3f} ms), {pst['decode_steps']} decode "
        f"steps (median {pst['decode_step_ms']:.3f} ms), prefix hit rate "
        f"{pst['prefix_hit_rate']:.3f} ({pst['prefix_hits']} hits / "
        f"{pst['prefix_misses']} misses), overflow {pst['overflow_pairs']}; "
        f"collectives {pst['collective_ms']:.1f} ms in "
        f"{pst['collectives']} calls of {1e3 * pst['wall_s']:.1f} ms; "
        "bf16 launches per rank (fused, grouped): "
        + ", ".join(f"({r['paged']['counts']['fused_moe_pipeline']['launches_bf16']}, "
                    f"{r['paged']['counts']['grouped_swiglu']['launches_bf16']})"
                    for r in ranks))
    etp = r0["etp"]
    log(f"  ETP (ep 2 x tp 2), one layer at Qwen3 widths, 4 x 64 tokens: "
        f"rel_err vs the dense oracle {etp['rel_err']:.3e}, "
        f"{etp['ms']:.2f} ms (host clock)")
    sync_expected = N_LAYERS * EP_NEW
    for r in ranks:
        c, cc = r["sync"]["counts"], r["continuous"]["counts"]
        fused, grouped = c["fused_moe_pipeline"], cc["grouped_swiglu"]
        cont_expected = N_LAYERS * (r["continuous"]["prefill_inserts"]
                                    + r["continuous"]["decode_steps"])
        if r["expert_shape"] != shard:
            raise AssertionError(f"rank {r['rank']} holds experts "
                                 f"{r['expert_shape']}")
        if not (fused["launches"] == fused["launches_bf16"] == sync_expected
                and c["grouped_swiglu"]["launches"] == 0
                and grouped["launches"] == grouped["launches_bf16"]
                == cont_expected
                and cc["fused_moe_pipeline"]["launches"] == 0
                and not any(v["plain_calls"] for v in c.values())
                and not any(v["plain_calls"] for v in cc.values())):
            raise AssertionError(f"rank {r['rank']}: launches {c} / {cc} "
                                 f"(expected {sync_expected} fused bf16, "
                                 f"{cont_expected} grouped bf16, 0 plain)")
        pc = r["paged"]["counts"]
        paged_expected = N_LAYERS * (r["paged"]["chunk_steps"]
                                     + r["paged"]["decode_steps"])
        paged_bf16 = sum(pc[k]["launches_bf16"] for k in
                         ("fused_moe_pipeline", "grouped_swiglu"))
        paged_all = sum(pc[k]["launches"] for k in
                        ("fused_moe_pipeline", "grouped_swiglu"))
        if not (paged_bf16 == paged_all == paged_expected
                and not any(v["plain_calls"] for v in pc.values())):
            raise AssertionError(f"rank {r['rank']}: paged launches {pc} "
                                 f"(expected {paged_expected} bf16, 0 "
                                 "plain)")
        # every engine feeds each rank the model axis' first rank's tokens
        # (``DistContext.host_view``, a broadcast), so this holds by
        # construction: it checks the engines' SPMD plumbing, not values
        if r["sync"]["tokens_out"] != st["tokens_out"] or \
                r["continuous"]["tokens_out"] != cst["tokens_out"] or \
                r["paged"]["tokens_out"] != pst["tokens_out"]:
            raise AssertionError(f"rank {r['rank']} served other tokens "
                                 "than rank 0")
        for k, v in r["layer0"]["paged_shapes"].items():
            if not (v["rel_err"] <= BF16_REL_TOL and v["finite"]
                    and sum(v["launches_bf16"].values()) > 0):
                raise AssertionError(f"rank {r['rank']}: the {k} check at "
                                     f"the paged run's shapes: {v}")
        if not (r["layer0"]["rel_err_bf16_vs_plain"] <= BF16_REL_TOL
                and r["layer0"]["finite"] and r["etp"]["finite"]
                and r["layer0"]["overflow_f32"] == 0):
            raise AssertionError(f"rank {r['rank']}: layer-0 check "
                                 f"{r['layer0']}")
    if not (chk["rel_err_f32_vs_dispatch"] <= REL_TOL
            and etp["rel_err"] <= REL_TOL):
        raise AssertionError("S-ETP or ETP disagrees with its reference")
    if not all(len(t) == EP_NEW for t in st["tokens_out"]) or \
            not all(len(t) == EP_CONT_NEW for t in cst["tokens_out"]
                    + pst["tokens_out"]):
        raise AssertionError("a request did not return every token")
    if not pst["prefix_hit_rate"] > 0:
        raise AssertionError("paged engine over EP: no prefix-cache hit")
    return dict(wall_s=wall, ranks=ranks)


# ---------------------------------------------------------------------------
# Phase 13: train on the card
# ---------------------------------------------------------------------------

TRAIN_LAYERS = 4        # depth cut of the full-width training (of 48)
TRAIN_B, TRAIN_S, TRAIN_STEPS = 4, 512, 8
# Adam moves every weight by ~lr per step: at 1e-3 a 2048-wide lm_head
# column's logits move by ~2 per step, and the full-width loss swings
TRAIN_LR = 1e-4
AUX_COEF = 0.01
# the card against the CPU, reduced Qwen3, 3 steps: the same float32 math
# summed in another order per product (cuBLAS vs the CPU's BLAS); the
# update bar is looser, since Adam divides by sqrt(v)
PARITY_LOSS_TOL = 1e-4
PARITY_UPDATE_TOL = 1e-3
# at init the final RMSNorm leaves x with unit mean square and lm_head is
# 0.02 * N(0, 1), so the logits have variance 0.02^2 * d and the mean
# log-sum-exp is ln(V) + 0.02^2 * d / 2 (12.341 at d 2048, V 151936):
# chance for this init, not ln(V). The cross entropy adds minus the mean
# target logit, which the Zipf targets (about a fifth of them one token)
# keep from averaging out over a batch; the train loss adds AUX_COEF x
# the aux loss summed over the layers (E x top-k share per layer: ~8 per
# layer at a uniform top-8 router)
INIT_LSE_TOL = 0.05
INIT_CE_TOL = 0.2
FIG4_STEPS, FIG4_B, FIG4_S, FIG4_LR = 200, 8, 128, 1e-3
FIG4_CKPT_STEP, FIG4_RESUME = 100, 10
FIG4_CE_TOL = 1e-4      # orig vs its P=2 twin at init: the same function
RESUME_TOL = 1e-5       # index_add's backward on CUDA is not bitwise


def fig4_config():
    """The ~128M-parameter MoE of the paper's Fig. 4 fine-tune (the
    walkthrough's ``CFG_100M``): 8 layers, d 512, 16 experts top-2,
    d_expert 512, vocab 16384."""
    from repro_torch.examples.finetune_partitioned import CFG_100M
    return CFG_100M


def train_flops(cfg, tokens: int, seq: int) -> float:
    """Model FLOPs of one train step: 6 x active params x tokens (the
    top-k experts, the router, attention's projections and lm_head; no
    embedding lookup) + the attention products, 12 x layers x tokens x
    seq x heads x head_dim."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    attn = d * hd * (cfg.n_heads + 2 * cfg.n_kv_heads) + cfg.n_heads * hd * d
    moe = cfg.top_k * 3 * d * cfg.d_expert + d * cfg.n_experts
    active = cfg.n_layers * (attn + moe) + d * cfg.vocab_size
    return (6.0 * active * tokens
            + 12.0 * cfg.n_layers * tokens * seq * cfg.n_heads * hd)


def train_run(cfg, model, dev, loader, steps: int, lr: float, total: int,
              warmup: int, start: int = 0, opt_state=None, on_step=None):
    """``steps`` steps of ``make_train_step`` (AdamW on a cosine schedule
    of ``total`` steps, aux ``AUX_COEF``) from loader batch ``start``.
    Returns (losses, grad norms, host ms per step around
    ``synchronize()``, the AdamW state)."""
    import torch
    from repro_torch.models import model as M
    from repro_torch.optim import adamw, cosine_schedule
    opt = adamw(cosine_schedule(lr, total, warmup=warmup))
    if opt_state is None:
        opt_state = opt.init(M.trainable(model))
    step = M.make_train_step(cfg, opt, aux_coef=AUX_COEF)
    losses, norms, ms = [], [], []
    for i in range(start, start + steps):
        batch = loader.get_batch(i)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = step(model, opt_state, batch)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
        norms.append(float(opt.last_grad_norm))
        if on_step is not None:
            on_step(i + 1, model, opt_state)
    return losses, norms, ms, opt_state


def train_parity(dev) -> dict:
    """(a) Reduced Qwen3-30B-A3B, 3 steps on the card and on the CPU from
    the same weights and numpy batches: losses and each leaf's update."""
    import torch
    from repro_torch.checkpoint.from_numpy import (params_from_numpy,
                                                   params_to_numpy)
    from repro_torch.configs import get_config
    from repro_torch.data import pipeline
    from repro_torch.models import model as M
    cfg = get_config("qwen3-moe-30b-a3b").reduced()
    tree = params_to_numpy(M.init_params(cfg, seed=3, device="cpu"))
    loader = pipeline.make_loader(cfg, 4, 64, seed=3)
    out, after = {}, {}
    for where, d in (("cuda", dev), ("cpu", torch.device("cpu"))):
        model = params_from_numpy(tree, cfg, device=d)
        losses, norms, _, _ = train_run(cfg, model, d, loader, 3, TRAIN_LR,
                                        total=3, warmup=1)
        out[where] = {"losses": losses, "grad_norms": norms}
        after[where] = params_to_numpy(model)
    loss_rel = max(abs(a - b) / abs(b) for a, b in
                   zip(out["cuda"]["losses"], out["cpu"]["losses"]))

    def leaves(t, prefix=""):
        for k, v in t.items():
            if isinstance(v, dict):
                yield from leaves(v, prefix + k + "/")
            else:
                yield prefix + k, v
    p0 = dict(leaves(tree))
    upd = {k: norm_rel(torch.from_numpy(v - p0[k]),
                       torch.from_numpy(dict(leaves(after["cpu"]))[k]
                                        - p0[k]))
           for k, v in leaves(after["cuda"])}
    worst = max(upd, key=upd.get)
    ok = loss_rel <= PARITY_LOSS_TOL and upd[worst] <= PARITY_UPDATE_TOL
    log(f"  (a) reduced Qwen3, 3 steps, card vs CPU: losses "
        f"{[round(x, 6) for x in out['cuda']['losses']]} vs "
        f"{[round(x, 6) for x in out['cpu']['losses']]}, rel {loss_rel:.3e} "
        f"(bar {PARITY_LOSS_TOL:g}); worst leaf update {worst} "
        f"{upd[worst]:.3e} (bar {PARITY_UPDATE_TOL:g}) -> "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("phase 13 (a): the card's training disagrees with "
                         "the CPU's")
    return {"loss_rel": loss_rel, "worst_update_rel": upd[worst],
            "worst_leaf": worst, **out}


def train_full_width(dev) -> dict:
    """(b) Qwen3-30B-A3B at full width, depth cut to ``TRAIN_LAYERS``:
    ``TRAIN_STEPS`` AdamW steps on the loader's batches through the
    differentiable route (no kernel may launch)."""
    import math
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import pipeline
    from repro_torch.models import model as M
    cfg = dataclasses.replace(get_config("qwen3-moe-30b-a3b"),
                              n_layers=TRAIN_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    model = M.init_params(cfg, seed=0, device=dev)
    n_params = sum(p.numel() for p in model.parameters())
    loader = pipeline.make_loader(cfg, TRAIN_B, TRAIN_S, seed=0)
    from repro_torch.models import transformer as TT
    b0 = M.to_device(loader.get_batch(0), dev)
    with torch.no_grad():
        logits, aux = TT.forward(model, b0, cfg, with_aux=True,
                                 kernels=False)
        init = {"lse": float(torch.logsumexp(logits, -1).mean()),
                "ce": float(M.cross_entropy(logits, b0["targets"])),
                "aux": float(aux)}
    del logits, aux, b0
    reset_counts()
    losses, norms, ms, state = train_run(cfg, model, dev, loader,
                                         TRAIN_STEPS, TRAIN_LR,
                                         total=TRAIN_STEPS, warmup=2)
    counts = read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for i, (loss, gn, t) in enumerate(zip(losses, norms, ms)):
        log(f"    step {i + 1}: loss {loss:.4f}  grad norm {gn:.4f}  "
            f"{t:.1f} ms")
    prof = profile_run("one more train step, full width", lambda: train_run(
        cfg, model, dev, loader, 1, TRAIN_LR, total=TRAIN_STEPS, warmup=2,
        start=TRAIN_STEPS, opt_state=state))
    tokens = TRAIN_B * TRAIN_S
    step_ms = statistics.median(ms[1:])
    flops = train_flops(cfg, tokens, TRAIN_S)
    share = flops / (step_ms / 1e3) / F32_FLOPS
    chance = math.log(cfg.vocab_size) + 0.02 ** 2 * cfg.d_model / 2
    init["chance"] = chance
    moved = {k: v for k, v in counts.items()
             if v["launches"] or v["plain_calls"]
             or v.get("launches_bf16", 0)}
    step1 = init["ce"] + AUX_COEF * init["aux"]
    checks = {
        "finite": all(math.isfinite(x) for x in losses),
        "init_lse_at_chance": abs(init["lse"] - chance) <= INIT_LSE_TOL,
        "init_ce_near_chance": abs(init["ce"] - chance) <= INIT_CE_TOL,
        "step1_loss_is_ce_plus_aux": abs(losses[0] - step1)
        <= PARITY_LOSS_TOL * step1,
        "loss_fell": losses[-1] < losses[0],
        "no_kernel_launched": not moved,
    }
    log(f"  (b) Qwen3-30B-A3B full width, {TRAIN_LAYERS} of 48 layers, "
        f"{n_params / 1e9:.3f} B parameters, {TRAIN_B} x {TRAIN_S}: median "
        f"step {step_ms:.1f} ms over steps 2-{TRAIN_STEPS}, "
        f"{tokens / (step_ms / 1e3):.0f} tokens/s, peak {peak_gb:.2f} GB, "
        f"{flops / 1e12:.3f} TFLOP per step = {share:.1%} of "
        f"{F32_FLOPS / 1e12:.0f} TFLOP/s float32; step 1 loss "
        f"{losses[0]:.4f} = CE {init['ce']:.4f} + {AUX_COEF} x aux "
        f"{init['aux']:.3f}; mean log-sum-exp {init['lse']:.4f} vs chance "
        f"ln V + 0.02^2 d / 2 = {chance:.4f} (ln V "
        f"{math.log(cfg.vocab_size):.4f}); kernel counters {counts} -> "
        + ", ".join(f"{k} {'ok' if v else 'FAIL'}"
                    for k, v in checks.items()))
    del model, state
    free_memory()
    if not all(checks.values()):
        raise SystemExit(f"phase 13 (b) failed: {checks}")
    return {"n_layers": TRAIN_LAYERS, "n_params": n_params,
            "batch": [TRAIN_B, TRAIN_S], "losses": losses,
            "grad_norms": norms, "step_ms": ms, "median_step_ms": step_ms,
            "tokens_per_s": tokens / (step_ms / 1e3), "peak_gb": peak_gb,
            "flops_per_step": flops, "f32_share": share, "init": init,
            "counts": counts, "profile": prof}


def train_fig4(dev) -> dict:
    """(c) The paper's Fig. 4 fine-tune: the ~128M MoE and its P=2
    complete-transformation twin (32 experts top-4, d_expert 256), 200
    steps each; step-1 CE equal; a checkpoint of the original at step 100,
    restored into a fresh model and optimizer, runs steps 101-110 as the
    uninterrupted run did."""
    import shutil
    import torch
    from repro_torch.checkpoint.from_numpy import (params_from_numpy,
                                                   params_to_numpy)
    from repro_torch.data import pipeline
    from repro_torch.examples.finetune_partitioned import (
        partition_model, partitioned_config)
    from repro_torch.launch.train import restore_state, save_state
    from repro_torch.models import model as M
    cfg = fig4_config()
    cfg_p = partitioned_config(cfg, 2)
    tree = params_to_numpy(M.init_params(cfg, seed=0, device=dev))
    loader = pipeline.make_loader(cfg, FIG4_B, FIG4_S, seed=0)
    held_out = [loader.get_batch(10_000 + i) for i in range(4)]
    ckpt_dir = ROOT / "build" / "fig4_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    warm = max(FIG4_STEPS // 20, 5)
    saved = {}

    def save_at(step, model, opt_state):
        if step == FIG4_CKPT_STEP:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            save_state(str(ckpt_dir), step, model, opt_state)
            saved["save_s"] = time.perf_counter() - t0

    def ce(model, c, batches):
        with torch.no_grad():
            return [float(M.loss_fn(model, b, c)) for b in batches]

    runs = {}
    for tag, c in (("orig", cfg), ("p2", cfg_p)):
        model = params_from_numpy(tree, cfg, device=dev)
        if tag == "p2":
            partition_model(model, 2)
        ce1 = ce(model, c, [loader.get_batch(0)])[0]
        t0 = time.perf_counter()
        losses, _, ms, state = train_run(
            c, model, dev, loader, FIG4_STEPS, FIG4_LR, total=FIG4_STEPS,
            warmup=warm, on_step=save_at if tag == "orig" else None)
        wall = time.perf_counter() - t0
        n = FIG4_STEPS // 10
        runs[tag] = {"step1_ce": ce1, "losses": losses,
                     "final10_loss": sum(losses[-n:]) / n,
                     "held_out_ce": statistics.mean(ce(model, c, held_out)),
                     "median_step_ms": statistics.median(ms[1:]),
                     "wall_s": wall}
        if tag == "orig":
            runs[tag]["profile"] = profile_run(
                "one more Fig. 4 step", lambda: train_run(
                    c, model, dev, loader, 1, FIG4_LR, total=FIG4_STEPS,
                    warmup=warm, start=FIG4_STEPS, opt_state=state))
        del model, state
        free_memory()

    # resume from the step-100 checkpoint into a fresh model and optimizer
    fresh = M.init_params(cfg, seed=1, device=dev)
    from repro_torch.optim import adamw
    state = adamw().init(M.trainable(fresh))
    t0 = time.perf_counter()
    restore_state(str(ckpt_dir), fresh, state)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    ckpt_mb = sum(f.stat().st_size for f in ckpt_dir.rglob("*")) / 1e6
    resumed, _, _, _ = train_run(cfg, fresh, dev, loader, FIG4_RESUME,
                                 FIG4_LR, total=FIG4_STEPS, warmup=warm,
                                 start=FIG4_CKPT_STEP, opt_state=state)
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    want = runs["orig"]["losses"][FIG4_CKPT_STEP:
                                  FIG4_CKPT_STEP + FIG4_RESUME]
    resume_rel = max(abs(a - b) / abs(b) for a, b in zip(resumed, want))
    ce_rel = abs(runs["p2"]["step1_ce"] - runs["orig"]["step1_ce"])         / abs(runs["orig"]["step1_ce"])
    checks = {"step1_ce_equal": ce_rel <= FIG4_CE_TOL,
              "resume_matches": resume_rel <= RESUME_TOL}
    for tag in runs:
        r = runs[tag]
        log(f"  (c) Fig. 4 {tag}: step-1 CE {r['step1_ce']:.6f}; final-10% "
            f"mean loss (CE + {AUX_COEF} aux) {r['final10_loss']:.4f}; "
            f"held-out CE {r['held_out_ce']:.4f}; median step "
            f"{r['median_step_ms']:.1f} ms; {FIG4_STEPS} steps in "
            f"{r['wall_s']:.1f} s")
    log(f"  (c) step-1 CE orig vs P=2 rel {ce_rel:.3e} (bar "
        f"{FIG4_CE_TOL:g}); checkpoint at step {FIG4_CKPT_STEP}: "
        f"{ckpt_mb:.1f} MB, save {saved['save_s']:.3f} s, restore "
        f"{restore_s:.3f} s; steps {FIG4_CKPT_STEP + 1}-"
        f"{FIG4_CKPT_STEP + FIG4_RESUME} resumed vs uninterrupted rel "
        f"{resume_rel:.3e} (bar {RESUME_TOL:g}) -> "
        + ", ".join(f"{k} {'ok' if v else 'FAIL'}"
                    for k, v in checks.items()))
    del fresh, state
    free_memory()
    if not all(checks.values()):
        raise SystemExit(f"phase 13 (c) failed: {checks}")
    return {"runs": runs, "step1_ce_rel": ce_rel, "ckpt_mb": ckpt_mb,
            "save_s": saved["save_s"], "restore_s": restore_s,
            "resumed": resumed, "resume_rel": resume_rel}


def grad_guard_check(dev) -> dict:
    """(d) Each kernel wrapper, given an operand on the card that requires
    grad while autograd records, raises before launching anything: the
    kernels have no backward."""
    import torch
    from repro_torch.kernels import ops
    gen = torch.Generator(device=dev).manual_seed(0)

    def rnd(*shape, grad=False):
        return torch.randn(*shape, generator=gen,
                           device=dev).requires_grad_(grad)
    i32 = dict(dtype=torch.int32, device=dev)
    w1, w3, w2 = rnd(2, 8, 8, grad=True), rnd(2, 8, 8), rnd(2, 8, 8)
    calls = {
        "fused_moe_pipeline": lambda: ops.fused_moe_pipeline(
            rnd(4, 8), w1, w3, w2, torch.tensor([0, 2], **i32),
            torch.tensor([2, 2], **i32), torch.zeros(2, **i32),
            torch.tensor([0, 1, 2, 3, 0, 0], **i32),
            torch.ones(6, device=dev), capacity=2, block_c=2),
        "grouped_swiglu": lambda: ops.grouped_swiglu(
            rnd(2, 4, 8), w1, w3, w2, torch.tensor([4, 2], **i32),
            torch.zeros(2, **i32)),
        "ssd_chunk": lambda: ops.ssd_chunk(
            rnd(2, 1, 4, 4, grad=True), rnd(2, 1, 4).abs() + 0.1,
            -rnd(2).abs() - 0.5, rnd(1, 1, 4, 4), rnd(1, 1, 4, 4)),
    }
    reset_counts()
    raised = {}
    for name, call in calls.items():
        try:
            call()
            raised[name] = False
        except RuntimeError as err:
            raised[name] = "no backward" in str(err)
    counts = read_counts()
    ok = all(raised.values()) and not any(
        v["launches"] or v["plain_calls"] for v in counts.values())
    log(f"  (d) kernel wrappers on {dev.type} operands that require grad: "
        f"raised {raised}; launches / plain calls {counts} -> "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("phase 13 (d): a kernel wrapper took an operand "
                         "that requires grad")
    return {"raised": raised, "counts": counts}


def train_phase(dev) -> dict:
    """Phase 13: (a) the card against the CPU, (b) full-width training,
    (c) the Fig. 4 fine-tune with a checkpoint round trip, (d) the kernel
    wrappers refusing operands that require grad. TF32 off, as ``main``
    sets it."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    out = {"parity": train_parity(dev), "full_width": train_full_width(dev),
           "fig4": train_fig4(dev), "grad_guard": grad_guard_check(dev)}
    out["wall_s"] = time.perf_counter() - t0
    log(f"  phase 13 took {out['wall_s']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# Phase 14: Whisper-large-v3 (encoder-decoder, audio stub) on the card
# ---------------------------------------------------------------------------

WHISPER_B, WHISPER_S, WHISPER_NEW = 8, 128, 32
WHISPER_CHECK_LAYERS = 2    # encoder + decoder layers of the card-vs-CPU check
WHISPER_CHECK_B, WHISPER_CHECK_S, WHISPER_CHECK_STEPS = 2, 16, 4
WHISPER_PREFILL_TOL = 1e-4  # float32, TF32 off: products summed otherwise
WHISPER_DECODE_TOL = 1e-3   # the bf16 caches round a float32 tie otherwise
WHISPER_PROFILE_STEPS = 8   # decode steps of the decode-only profile window


def whisper_check(dev, cfg) -> dict:
    """Whisper at full width with depth cut to 2 + 2 layers, on the card
    and on the CPU from the same weights (the card's init through the
    weight bridge) and the same inputs (1500 stub frames: blockwise
    encoder attention): prefill logits norm-rel <= WHISPER_PREFILL_TOL,
    then WHISPER_CHECK_STEPS decode steps over each side's bf16 cache,
    both fed the CPU's greedy tokens, logits norm-rel <=
    WHISPER_DECODE_TOL."""
    import numpy as np
    import torch
    from repro_torch.checkpoint.from_numpy import (params_from_numpy,
                                                   params_to_numpy)
    from repro_torch.models import model as M
    small = dataclasses.replace(cfg, n_layers=WHISPER_CHECK_LAYERS,
                                encoder_layers=WHISPER_CHECK_LAYERS)
    card = M.init_params(small, seed=1, device=dev)
    host = params_from_numpy(params_to_numpy(card), small, device="cpu")
    b = M.make_batch(np.random.default_rng(3), small, WHISPER_CHECK_B,
                     WHISPER_CHECK_S, "prefill")
    ctx = WHISPER_CHECK_S + WHISPER_CHECK_STEPS
    sides = {}
    for name, model, d in (("card", card, dev),
                           ("cpu", host, torch.device("cpu"))):
        batch = M.to_device(b, d)
        batch["tokens"] = batch["tokens"].long()
        sides[name] = M.make_prefill_step(small, cache_len=ctx)(model, batch)
    pre = norm_rel(sides["card"][0].cpu(), sides["cpu"][0])
    steps = []
    tok = torch.argmax(sides["cpu"][0][:, -1:], dim=-1)
    caches = {k: v[1] for k, v in sides.items()}
    for _ in range(WHISPER_CHECK_STEPS):
        out = {}
        for name, model in (("card", card), ("cpu", host)):
            out[name], caches[name] = M.make_serve_step(small)(
                model, tok.to(model.device), caches[name])
        steps.append(norm_rel(out["card"].cpu(), out["cpu"]))
        tok = torch.argmax(out["cpu"][:, -1:], dim=-1)
    res = dict(prefill_norm_rel=pre, decode_norm_rel=steps,
               finite=bool(torch.isfinite(sides["card"][0]).all()))
    log(f"  card vs CPU at full width, {WHISPER_CHECK_LAYERS} + "
        f"{WHISPER_CHECK_LAYERS} layers, {WHISPER_CHECK_B} x "
        f"({cfg.n_frontend_tokens} frames, {WHISPER_CHECK_S} tokens): "
        f"prefill logits norm-rel {pre:.3e} (bar {WHISPER_PREFILL_TOL:g}); "
        f"decode steps " + ", ".join(f"{e:.3e}" for e in steps)
        + f" (bar {WHISPER_DECODE_TOL:g}, bf16 caches)")
    if not (pre <= WHISPER_PREFILL_TOL and res["finite"]
            and max(steps) <= WHISPER_DECODE_TOL):
        raise AssertionError(f"phase 14: the card disagrees with the CPU: "
                             f"{res}")
    del card, host, sides, caches
    free_memory()
    return res


def whisper_phase(dev) -> dict:
    """Phase 14: Whisper-large-v3 at full width and depth (32 + 32 layers)
    through ``ServingEngine``: WHISPER_B requests x 1500 stub frames x
    WHISPER_S-token prompts x WHISPER_NEW new tokens, greedy; the prefill
    split into encoder, cross K/V and decoder; a profile window; then the
    card against the CPU at full width and cut depth. No kernel of ours
    runs (no MoE, no SSM). TF32 off, as ``main`` sets it."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models import model as M
    from repro_torch.models import whisper as W
    from repro_torch.serving import GenerationConfig, ServingEngine
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config("whisper-large-v3")
    B, S, NEW = WHISPER_B, WHISPER_S, WHISPER_NEW
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = M.init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    parts = {"encoder": model.encoder, "decoder": model.decoder,
             "embedding": model.embed, "frontend_proj": None}
    sizes = {k: (sum(p.numel() for p in m.parameters()) if m is not None
                 else model.frontend_proj.numel()) / 1e6
             for k, m in parts.items()}
    n_params = sum(p.numel() for p in model.parameters())
    log(f"  whisper-large-v3: {cfg.encoder_layers} + {cfg.n_layers} layers, "
        f"d_model {cfg.d_model}, {cfg.n_heads} heads, d_ff {cfg.d_ff} "
        f"(gelu), vocab {cfg.vocab_size} (tied); init "
        f"{time.perf_counter() - t0:.2f}s, {n_params / 1e9:.3f} B float32 "
        f"parameters (" + ", ".join(f"{k} {v:.1f} M" for k, v in
                                    sizes.items())
        + f"); {B} x ({cfg.n_frontend_tokens} frames, {S} tokens) x {NEW}")
    src = SyntheticLM(cfg.vocab_size, seed=0)
    rng = np.random.default_rng(0)
    prompts = [src.sample_batch(rng, 1, S)["tokens"][0] for _ in range(B)]
    kw = dict(batch_size=B, max_prompt_len=S, max_new_tokens=NEW, device=dev)
    ServingEngine(cfg, model, **kw).generate(
        prompts, GenerationConfig(max_new_tokens=2))          # warm-up
    eng = ServingEngine(cfg, model, **kw)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = eng.generate(prompts, GenerationConfig(max_new_tokens=NEW))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    st = served_stats(eng, results, wall, counts, NEW)
    st.update(requests=B, frames=cfg.n_frontend_tokens, prompt_len=S,
              new_tokens=NEW, params_b=n_params / 1e9, params_m=sizes)
    # the prefill's parts, each timed alone on the same batch (median of 3
    # CUDA-event timings); the decoder's share is the rest of the prefill
    tokens = torch.from_numpy(np.stack(prompts)).long().to(dev)
    batch = {"tokens": tokens, **M.frontend_inputs(cfg, B, dev)}
    with torch.no_grad():
        enc = W.encode(model, batch["audio_embeds"], cfg)
        split = {name: cuda_ms(fn, 3) for name, fn in (
            ("encoder_ms", lambda: W.encode(model, batch["audio_embeds"],
                                            cfg)),
            ("cross_kv_ms", lambda: W._enc_kv(model, enc, cfg)),
            ("prefill_ms", lambda: W.prefill(model, batch, cfg,
                                             cache_len=S + NEW)))}
        logits, cache = W.prefill(model, batch, cfg, cache_len=S + NEW)
    split["decoder_ms"] = split["prefill_ms"] - split["encoder_ms"] \
        - split["cross_kv_ms"]
    st["prefill_split"] = split
    finite = bool(torch.isfinite(logits).all())
    cross_gb = (cache["cross_k"].numel() + cache["cross_v"].numel()) \
        * cache["cross_k"].element_size() / 1e9
    st.update(cross_cache_gb=cross_gb, finite=finite)
    log(f"  served {B} x {S} x {NEW}: {st['tokens']} tokens in {wall:.3f}s "
        f"({st['tok_per_s']:.1f} tok/s), prefill {st['prefill_ms']:.2f} ms "
        f"(alone: encoder {split['encoder_ms']:.2f}, cross K/V "
        f"{split['cross_kv_ms']:.2f}, decoder {split['decoder_ms']:.2f} of "
        f"{split['prefill_ms']:.2f} ms), decode step "
        f"{st['decode_step_ms']:.3f} ms (mean of {NEW - 1}); bf16 cross "
        f"K/V cache {cross_gb:.2f} GB; peak memory {st['peak_mem_gb']:.2f} "
        f"GB; counts {counts}")
    if not all(len(r.tokens) == NEW for r in results):
        raise AssertionError("a request did not return every token")
    if any(c["launches"] or c["plain_calls"] for c in counts.values()):
        raise AssertionError(f"whisper called a MoE or SSD kernel: {counts}")
    if tuple(logits.shape) != (B, S, cfg.vocab_size) or not finite or \
            cache["pos"] != S or tuple(cache["cross_k"].shape) != (
                cfg.n_layers, B, cfg.n_frontend_tokens, cfg.n_kv_heads,
                cfg.resolved_head_dim):
        raise AssertionError("whisper prefill: logits not finite or cache "
                             "misshaped")
    # the decode step alone: WHISPER_PROFILE_STEPS steps from the prefill's
    # cache, each reading its greedy tokens back as the engine does; the
    # device-busy share says how much of a step the host's launches take
    step = M.make_serve_step(cfg)
    first = torch.argmax(logits[:, -1:], dim=-1)

    def decode_window():
        c, tok = cache, first
        with torch.no_grad():
            for _ in range(WHISPER_PROFILE_STEPS):
                out, c = step(model, tok, c)
                tok = torch.argmax(out[:, -1:], dim=-1)
                tok.cpu()
    dprof = profile_run(f"{WHISPER_PROFILE_STEPS} decode steps alone",
                        decode_window)
    st["decode_profile"] = dict(
        dprof, step_wall_ms=dprof["wall_ms"] / WHISPER_PROFILE_STEPS,
        step_device_ms=dprof["device_busy_ms"] / WHISPER_PROFILE_STEPS)
    log(f"  decode step alone: {st['decode_profile']['step_wall_ms']:.3f} "
        f"ms wall, {st['decode_profile']['step_device_ms']:.3f} ms of CUDA "
        "kernels")
    del logits, cache, enc, batch, first
    st["profile"] = profile_run(
        "1 prefill + 3 decode steps",
        lambda: eng.generate(prompts, GenerationConfig(max_new_tokens=4)))
    del eng, model
    free_memory()
    st["check"] = whisper_check(dev, cfg)
    return st


# ---------------------------------------------------------------------------
# Phase 15: training over EP, 4 ranks on the one card over gloo
# ---------------------------------------------------------------------------

TRAIN_EP_LAYERS = 2     # depth cut of the full-width EP training (of 48)
TRAIN_EP_B, TRAIN_EP_S, TRAIN_EP_STEPS = 4, 256, 4
TRAIN_EP_PARITY_B, TRAIN_EP_PARITY_S = 4, 64
WHISPER_EP_LAYERS = 4   # encoder and decoder layers of (c) (of 32 + 32)
WHISPER_EP_B, WHISPER_EP_S = 2, 64
WHISPER_EP_TOL = 1e-5   # the step under the context vs without: same ops
# (a)'s bars per wire: float32 those of phase 13; bf16 those of
# tests/test_torch_train_world.py's bf16 case (the two devices' float32
# sums land some elements one bf16 ulp apart before each cast; "moved":
# the share of a leaf's elements whose update differs by more than half
# the leaf's largest update)
TRAIN_EP_BARS = {
    "float32": dict(loss=PARITY_LOSS_TOL, grad=PARITY_UPDATE_TOL,
                    update=PARITY_UPDATE_TOL, moved=0.0),
    "bfloat16": dict(loss=1e-4, grad=1e-2, update=0.15, moved=0.01)}


def _moved(got, want) -> float:
    ref = want.abs().max()
    return float(((got - want).abs() > 0.5 * ref).double().mean())


def _train_ep_parity(ctx, dev, wire: str, ckpt: bool) -> dict:
    """(a) Reduced Qwen3-30B-A3B prepared by ``load_aware`` for the EP
    ranks, ``remat`` on, S-ETP's wire at ``wire`` (``setp_moe_forward``'s
    default, bf16, patched for this run as the tests patch it): the
    gradients of ``loss_fn`` and two AdamW steps on the card and on the
    CPU in this rank, held to ``TRAIN_EP_BARS[wire]`` by the caller. With
    ``ckpt``, on the card a checkpoint after step 1 (sharded: the experts
    gathered, the first rank writes), restored into a fresh model and
    state, runs step 2 as the straight run did, bit for bit."""
    import shutil
    import numpy as np
    import torch
    from repro_torch.checkpoint.from_numpy import (params_from_numpy,
                                                   params_to_numpy)
    from repro_torch.configs import get_config
    from repro_torch.core import setp
    from repro_torch.core.policy import make_policy
    from repro_torch.data import pipeline
    from repro_torch.data.pipeline import calibration_activations
    from repro_torch.launch.train import restore_state, save_state
    from repro_torch.models import model as M
    from repro_torch.optim import adamw, cosine_schedule
    cfg = get_config("qwen3-moe-30b-a3b").reduced()
    model = M.init_params(cfg, seed=3, device="cpu")
    calib = calibration_activations(np.random.default_rng(7), 256,
                                    cfg.d_model, device="cpu")
    model, policy = make_policy("load_aware", cfg.dualsparse).prepare(
        model, cfg, calib, n_ep_devices=ctx.size("model"))
    tree = params_to_numpy(model)
    loader = pipeline.make_loader(cfg, TRAIN_EP_PARITY_B, TRAIN_EP_PARITY_S,
                                  seed=3)
    ckpt_dir = ROOT / "build" / "train_ep_ckpt"
    if ckpt and ctx.is_origin():
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    torch.distributed.barrier()

    def fresh(d):
        m = params_from_numpy(tree, cfg, device=d, dist=ctx)
        opt = adamw(cosine_schedule(TRAIN_LR, 2, warmup=1))
        return m, opt, opt.init(M.trainable(m)), M.make_train_step(
            cfg, opt, aux_coef=AUX_COEF, dist=ctx, policy=policy)
    defaults = setp.setp_moe_forward.__kwdefaults__
    default_wire = defaults["wire_dtype"]
    defaults["wire_dtype"] = getattr(torch, wire)
    out = {}
    try:
        for where, d in (("cuda", dev), ("cpu", torch.device("cpu"))):
            m, opt, st, step = fresh(d)
            start = {n: p.detach().cpu().clone() for n, p in
                     m.named_parameters()}
            params = M.set_trainable(m)
            with torch.enable_grad():
                loss = M.loss_fn(m, loader.get_batch(0), cfg,
                                 aux_coef=AUX_COEF, dist=ctx, policy=policy)
                grads = torch.autograd.grad(loss, list(params.values()))
            losses = [float(step(m, st, loader.get_batch(0)))]
            if ckpt and where == "cuda":
                save_state(str(ckpt_dir), 1, m, st, dist=ctx)
            losses.append(float(step(m, st, loader.get_batch(1))))
            out[where] = {"losses": [float(loss.detach())] + losses,
                          "grads": {n: g.cpu() for n, g in zip(params,
                                                               grads)},
                          "update": {n: p.detach().cpu() - start[n]
                                     for n, p in m.named_parameters()}}
            if ckpt and where == "cuda":
                m2, _, st2, step2 = fresh(d)
                restore_state(str(ckpt_dir), m2, st2, dist=ctx)
                resumed = float(step2(m2, st2, loader.get_batch(1)))
                out["resume_bitwise"] = resumed == losses[1] and all(
                    torch.equal(a, b) for a, b in zip(m2.parameters(),
                                                      m.parameters()))
                del m2, st2
            del m, st
    finally:
        defaults["wire_dtype"] = default_wire
    c, p = out["cuda"], out["cpu"]
    loss_rel = max(abs(a - b) / abs(b) for a, b in
                   zip(c["losses"], p["losses"]))
    grad_rel = {n: norm_rel(c["grads"][n], p["grads"][n])
                for n in c["grads"]}
    upd_rel = {n: norm_rel(c["update"][n], p["update"][n])
               for n in c["update"]}
    moved = {n: _moved(c["update"][n], p["update"][n]) for n in c["update"]}
    wg, wu = max(grad_rel, key=grad_rel.get), max(upd_rel, key=upd_rel.get)
    wm = max(moved, key=moved.get)
    return {"wire": wire, "losses_card": c["losses"],
            "losses_cpu": p["losses"],
            "loss_rel": loss_rel, "worst_grad": [wg, grad_rel[wg]],
            "worst_update": [wu, upd_rel[wu]], "worst_moved": [wm, moved[wm]],
            "expert_shape": list(c["grads"]["blocks.0.moe.w1"].shape),
            "resume_bitwise": out.get("resume_bitwise")}


def _digest(t) -> str:
    import hashlib
    return hashlib.sha256(t.detach().cpu().numpy().tobytes()).hexdigest()


def _train_ep_full(ctx, dev) -> dict:
    """(b) Qwen3-30B-A3B at full width, ``TRAIN_EP_LAYERS`` of 48 layers,
    ``none`` prepared for the EP ranks (strided placement, 32 of 128
    experts per rank), ``remat`` on: ``TRAIN_EP_STEPS`` AdamW steps of
    TRAIN_EP_B x TRAIN_EP_S tokens; then one step with ``remat`` off, and
    the peak of one forward and backward alone with and without it."""
    import gc
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import setp
    from repro_torch.core.policy import make_policy
    from repro_torch.data import pipeline
    from repro_torch.models import model as M
    from repro_torch.optim import adamw, cosine_schedule
    cfg = dataclasses.replace(get_config("qwen3-moe-30b-a3b"),
                              n_layers=TRAIN_EP_LAYERS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = M.init_params(cfg, seed=0, device=dev)
    model, policy = make_policy("none", cfg.dualsparse).prepare(
        model, cfg, n_ep_devices=ctx.size("model"))
    setp.shard_experts(model, ctx)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    resident_gb = torch.cuda.memory_allocated() / 1e9
    names = M.expert_shard_names(model)
    n_params = sum(p.numel() for p in M.trainable(model).values())
    n_expert = sum(p.numel() for n, p in model.named_parameters()
                   if n in names)
    tctx, spent = timed_collectives(ctx)
    opt = adamw(cosine_schedule(TRAIN_LR, TRAIN_EP_STEPS, warmup=1))
    state = opt.init(M.trainable(model))
    step = M.make_train_step(cfg, opt, aux_coef=AUX_COEF, dist=tctx,
                             policy=policy)
    loader = pipeline.make_loader(cfg, TRAIN_EP_B, TRAIN_EP_S, seed=0)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    steps = []
    for i in range(TRAIN_EP_STEPS):
        for k in spent:
            spent[k] = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = step(model, state, loader.get_batch(i))
        torch.cuda.synchronize()
        steps.append(dict(
            ms=(time.perf_counter() - t0) * 1e3, loss=float(loss),
            grad_norm=float(opt.last_grad_norm),
            forward_ms=spent["ms"] - spent["backward_ms"],
            forward_calls=spent["calls"] - spent["backward_calls"],
            backward_ms=spent["backward_ms"],
            backward_calls=spent["backward_calls"]))
    counts = read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    digests = {n: _digest(p) for n, p in model.named_parameters()
               if n not in names}
    # remat off: one step (its time, collectives and peak); then one
    # forward and backward alone under each setting, for the peak that
    # remat can lower (AdamW's update, which may set a step's peak, left
    # out). The recompute's collectives run in the backward pass, so the
    # step without remat runs fewer there.
    plain_ctx = dataclasses.replace(tctx, remat=False)
    plain = M.make_train_step(cfg, opt, aux_coef=AUX_COEF, dist=plain_ctx,
                              policy=policy)
    for k in spent:
        spent[k] = 0
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss = plain(model, state, loader.get_batch(TRAIN_EP_STEPS))
    torch.cuda.synchronize()
    no_remat = dict(ms=(time.perf_counter() - t0) * 1e3, loss=float(loss),
                    peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                    backward_ms=spent["backward_ms"],
                    backward_calls=spent["backward_calls"])
    del plain
    params = M.set_trainable(model)
    grad_peak = {}
    for name, c in (("remat", tctx), ("no_remat", plain_ctx)):
        gc.collect()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        with torch.enable_grad():
            loss = M.loss_fn(model, loader.get_batch(0), cfg,
                             aux_coef=AUX_COEF, dist=c, policy=policy)
            grads = torch.autograd.grad(loss, list(params.values()))
        peak = torch.cuda.max_memory_allocated()
        grad_peak[name] = dict(peak_gb=peak / 1e9,
                               above_resident_gb=(peak - base) / 1e9,
                               loss=float(loss.detach()))
        del loss, grads
    del model, state, opt, step, params
    gc.collect()
    torch.cuda.empty_cache()
    return {"setup_s": setup_s, "resident_gb": resident_gb,
            "n_params": n_params,
            "n_expert_params": n_expert, "steps": steps, "peak_gb": peak_gb,
            "digests": digests, "counts": counts, "no_remat": no_remat,
            "grad_peak": grad_peak}


def _train_ep_whisper(ctx, dev) -> dict:
    """(c) Whisper-large-v3 at full width, WHISPER_EP_LAYERS + same of 32 +
    32 layers: one AdamW step under the EP context (``remat`` on) against
    the same step without it; prefill and a decode step under the
    context against those without."""
    import gc
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import pipeline
    from repro_torch.models import model as M
    from repro_torch.optim import adamw
    cfg = dataclasses.replace(get_config("whisper-large-v3"),
                              n_layers=WHISPER_EP_LAYERS,
                              encoder_layers=WHISPER_EP_LAYERS)
    model = M.init_params(cfg, seed=0, device=dev)
    init = {n: p.detach().clone() for n, p in model.named_parameters()}
    loader = pipeline.make_loader(cfg, WHISPER_EP_B, WHISPER_EP_S, seed=0)
    batch = loader.get_batch(0)
    got = {}
    for name, d in (("ctx", ctx), ("plain", None)):
        with torch.no_grad():
            for n, p in model.named_parameters():
                p.copy_(init[n])
        opt = adamw(TRAIN_LR)
        st = opt.init(M.trainable(model))
        step = M.make_train_step(cfg, opt, dist=d)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = float(step(model, st, batch))
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        update = {n: p.detach() - init[n]
                  for n, p in model.named_parameters()}
        with torch.no_grad():
            pb = M.to_device({k: v for k, v in batch.items()
                              if k != "targets"}, dev)
            pb["tokens"] = pb["tokens"].long()
            logits, cache = M.make_prefill_step(
                cfg, cache_len=WHISPER_EP_S + 1, dist=d)(model, pb)
            tok = torch.argmax(logits[:, -1:], dim=-1)
            dlogits, _ = M.make_serve_step(cfg, dist=d)(model, tok, cache)
        got[name] = dict(loss=loss, ms=ms, update=update, prefill=logits,
                         decode=dlogits)
        del st, opt, cache
    c, p = got["ctx"], got["plain"]
    upd = max(norm_rel(c["update"][n], p["update"][n]) for n in init)
    res = {"loss_ctx": c["loss"], "loss_plain": p["loss"],
           "loss_rel": abs(c["loss"] - p["loss"]) / abs(p["loss"]),
           "worst_update_rel": upd, "step_ms_ctx": c["ms"],
           "step_ms_plain": p["ms"],
           "prefill_rel": norm_rel(c["prefill"], p["prefill"]),
           "decode_rel": norm_rel(c["decode"], p["decode"]),
           "finite": bool(torch.isfinite(c["prefill"]).all()
                          and torch.isfinite(c["decode"]).all())}
    del model, got
    gc.collect()
    torch.cuda.empty_cache()
    return res


def train_ep_rank(rank: int, out: str, dev_type: str) -> None:
    """One rank of phase 15 (run by ``train_ep_phase`` in its own process,
    all ranks on the one device of type ``dev_type``, gloo over a
    FileStore). Deterministic algorithms on, so the ranks' replicated
    leaves stay bit for bit equal (the embedding's backward accumulates
    with atomics otherwise). Writes ``rank<r>.json``."""
    import os
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch
    import torch.distributed as dist
    from repro_torch.distributed import DistContext, make_mesh
    torch.use_deterministic_algorithms(True, warn_only=True)
    out = Path(out)
    dev = join_ep_world(rank, out, dev_type)
    ctx = DistContext(make_mesh((1, SETP_RANKS), ("data", "model")),
                      remat=True)
    res = {"rank": rank}
    t0 = time.perf_counter()
    res["parity"] = [_train_ep_parity(ctx, dev, "float32", ckpt=True),
                     _train_ep_parity(ctx, dev, "bfloat16", ckpt=False)]
    res["parity_wall_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    res["full"] = _train_ep_full(ctx, dev)
    res["full"]["wall_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    res["whisper"] = _train_ep_whisper(ctx, dev)
    res["whisper"]["wall_s"] = time.perf_counter() - t0
    (out / f"rank{rank}.json").write_text(json.dumps(res))
    dist.barrier()
    dist.destroy_process_group()


def train_ep_phase(dev) -> dict:
    """Phase 15: spawn the 4 ranks (one process each, all on ``dev``'s
    card, gloo over a FileStore under build/), wait for them (a failing
    rank fails the phase), read their results and hold them to the bars.
    No kernel of ours launches: training runs the differentiable route."""
    import math
    import shutil
    import torch.multiprocessing as mp
    import torch
    out = ROOT / "build" / "train_ep_world"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    if dev.type == "cuda":
        free, total = torch.cuda.mem_get_info()
        log(f"  the card before the ranks start: {free / 1e9:.2f} of "
            f"{total / 1e9:.2f} GB free")
    t0 = time.perf_counter()
    mp.spawn(train_ep_rank, args=(str(out), dev.type), nprocs=SETP_RANKS,
             join=True)
    wall = time.perf_counter() - t0
    ranks = [json.loads((out / f"rank{r}.json").read_text())
             for r in range(SETP_RANKS)]
    ok = {}
    for i, wire in enumerate(TRAIN_EP_BARS):
        a, bar = [r["parity"][i] for r in ranks], TRAIN_EP_BARS[wire]
        assert all(x["wire"] == wire for x in a)
        ok[f"a_card_vs_cpu_{wire}"] = all(
            x["loss_rel"] <= bar["loss"] and x["worst_grad"][1] <= bar["grad"]
            and x["worst_update"][1] <= bar["update"]
            and x["worst_moved"][1] <= bar["moved"] for x in a)
        log(f"  (a) reduced Qwen3, load_aware for {SETP_RANKS} EP ranks "
            f"(experts {a[0]['expert_shape']} per rank), remat, {wire} "
            "wire, 2 steps, card "
            f"vs CPU: losses {[round(v, 6) for v in a[0]['losses_card']]} vs "
            f"{[round(v, 6) for v in a[0]['losses_cpu']]}; per rank loss rel "
            + ", ".join(f"{x['loss_rel']:.2e}" for x in a)
            + f" (bar {bar['loss']:g}), worst gradient "
            + ", ".join(f"{x['worst_grad'][0]} {x['worst_grad'][1]:.2e}"
                        for x in a)
            + f" (bar {bar['grad']:g}), worst update "
            + ", ".join(f"{x['worst_update'][0]} {x['worst_update'][1]:.2e}"
                        for x in a)
            + f" (bar {bar['update']:g}), most moved "
            + ", ".join(f"{x['worst_moved'][0]} {x['worst_moved'][1]:.2e}"
                        for x in a)
            + f" (bar {bar['moved']:g})")
    a = [r["parity"][0] for r in ranks]
    ok["a_resume_bitwise"] = all(x["resume_bitwise"] for x in a)
    log("  (a) sharded checkpoint after step 1 (float32 wire), resumed step "
        f"2 bitwise: {[x['resume_bitwise'] for x in a]}; (a) took "
        + ", ".join(f"{r['parity_wall_s']:.1f}" for r in ranks) + " s")
    b = [r["full"] for r in ranks]
    tokens = TRAIN_EP_B * TRAIN_EP_S
    for r, x in zip(ranks, b):
        med = statistics.median(s["ms"] for s in x["steps"][1:])
        x["median_step_ms"] = med
        x["tokens_per_s"] = tokens / (med / 1e3)
        x["median_forward_collective_ms"] = statistics.median(
            s["forward_ms"] for s in x["steps"][1:])
        x["median_backward_collective_ms"] = statistics.median(
            s["backward_ms"] for s in x["steps"][1:])
        log(f"  (b) rank {r['rank']}: steps "
            + ", ".join(f"{s['ms']:.1f}" for s in x["steps"])
            + f" ms (median of 2-{TRAIN_EP_STEPS} {med:.1f} ms, "
            f"{x['tokens_per_s']:.0f} tokens/s); collectives forward "
            f"{x['median_forward_collective_ms']:.1f} ms in "
            f"{x['steps'][-1]['forward_calls']} calls, backward "
            f"{x['median_backward_collective_ms']:.1f} ms in "
            f"{x['steps'][-1]['backward_calls']} calls; losses "
            f"{[round(s['loss'], 5) for s in x['steps']]}; grad norms "
            f"{[round(s['grad_norm'], 4) for s in x['steps']]}; peak "
            f"{x['peak_gb']:.2f} GB; remat off: step "
            f"{x['no_remat']['ms']:.1f} ms, peak "
            f"{x['no_remat']['peak_gb']:.2f} GB, backward collectives "
            f"{x['no_remat']['backward_ms']:.1f} ms in "
            f"{x['no_remat']['backward_calls']} calls; forward and backward "
            "alone, peak with / without remat "
            f"{x['grad_peak']['remat']['peak_gb']:.2f} / "
            f"{x['grad_peak']['no_remat']['peak_gb']:.2f} GB ("
            f"{x['grad_peak']['remat']['above_resident_gb']:.2f} / "
            f"{x['grad_peak']['no_remat']['above_resident_gb']:.2f} above "
            f"resident); setup {x['setup_s']:.1f} s, "
            f"{x['resident_gb']:.2f} GB resident")
    b0 = b[0]
    log(f"  (b) Qwen3-30B-A3B full width, {TRAIN_EP_LAYERS} of 48 layers, "
        f"none for {SETP_RANKS} EP ranks, remat: {b0['n_params'] / 1e6:.1f} "
        f"M trainable parameters per rank ({b0['n_expert_params'] / 1e6:.1f}"
        f" M of them expert shards), {TRAIN_EP_B} x {TRAIN_EP_S} tokens, "
        f"aux {AUX_COEF}, lr {TRAIN_LR}; kernel counters {b0['counts']}")
    ok["b_losses_equal"] = all(
        [s["loss"] for s in x["steps"]] == [s["loss"] for s in b0["steps"]]
        and x["no_remat"]["loss"] == b0["no_remat"]["loss"] for x in b)
    ok["b_remat_off_ran"] = all(
        x["no_remat"]["backward_calls"] < x["steps"][-1]["backward_calls"]
        and x["grad_peak"]["remat"]["loss"]
        == x["grad_peak"]["no_remat"]["loss"] for x in b)
    ok["b_replicated_leaves_bitwise"] = all(x["digests"] == b0["digests"]
                                            for x in b)
    ok["b_finite"] = all(math.isfinite(s["loss"]) for s in b0["steps"])
    ok["b_no_kernel_launched"] = all(
        not any(v["launches"] or v["plain_calls"] or
                v.get("launches_bf16", 0) for v in x["counts"].values())
        for x in b)
    c = [r["whisper"] for r in ranks]
    ok["c_whisper_step_equal"] = all(
        x["loss_rel"] <= WHISPER_EP_TOL
        and x["worst_update_rel"] <= WHISPER_EP_TOL for x in c)
    ok["c_whisper_serve_equal"] = all(
        x["finite"] and x["prefill_rel"] <= WHISPER_EP_TOL
        and x["decode_rel"] <= WHISPER_EP_TOL for x in c)
    log(f"  (c) Whisper-large-v3 full width, {WHISPER_EP_LAYERS} + "
        f"{WHISPER_EP_LAYERS} of 32 + 32 layers, {WHISPER_EP_B} x "
        f"(1500 frames, {WHISPER_EP_S} tokens): one step under the context "
        "(remat) vs without, per rank: loss rel "
        + ", ".join(f"{x['loss_rel']:.2e}" for x in c)
        + ", worst update rel "
        + ", ".join(f"{x['worst_update_rel']:.2e}" for x in c)
        + f" (bar {WHISPER_EP_TOL:g}); step {c[0]['step_ms_ctx']:.1f} ms "
        f"under it vs {c[0]['step_ms_plain']:.1f} ms; prefill / decode "
        "logits rel "
        + ", ".join(f"{x['prefill_rel']:.2e} / {x['decode_rel']:.2e}"
                    for x in c))
    log(f"  phase 15: {SETP_RANKS} ranks in {wall:.1f} s (spawn to join) "
        "-> " + ", ".join(f"{k} {'ok' if v else 'FAIL'}"
                          for k, v in ok.items()))
    if not all(ok.values()):
        raise SystemExit(f"phase 15 failed: {ok}")
    return dict(wall_s=wall, ranks=ranks)


# ---------------------------------------------------------------------------
# Phase 16: the paper's drop metrics on the card, Fig. 10 at full width, and
# the three walkthroughs
# ---------------------------------------------------------------------------

# FLOPs-saved targets of the Fig. 10 sweep; 0 is keep-all (t = -1)
FIG10_TARGETS = (0.0, 0.10, 0.25, 0.40, 0.50)
FIG10_T = (8, 1024, 8192)   # decode, the sync prefill, a 32 x 256 prefill
FIG10_CALIB = 2048          # calibration tokens of (a) and of the prepare
FIG10_THRESHOLDS = 64       # thresholds of (a)'s Fig. 12 map
FIG10_LAYERS = 4            # routers of (a)'s per-layer calibration
FIG10_CAPACITY = 2.0        # capacity factor, one capacity per T


def _bits(t):
    """A float32 tensor's bits, on the host (for bitwise comparisons)."""
    import torch
    return t.detach().cpu().contiguous().view(torch.int32)


def metrics_check(dev, cfg, layer, calib) -> dict:
    """(a) The drop metrics of ``core.drop`` on router scores computed on
    the card, each against the same function on a CPU copy of the same
    inputs, bitwise: the Fig. 12 threshold -> drop-rate map at
    FIG10_THRESHOLDS thresholds in [0, max score], the per-layer
    thresholds over FIG10_LAYERS routers (layer 0's and seeded others), and
    the drop rate and FLOPs saved of layer 0's pairs under 2T calibrated to
    a 25% target; the drop rate also against 1 - kept / total from
    ``sub_pair_outcome_counts``, in float32."""
    import numpy as np
    import torch
    from repro_torch.core import drop, gating
    from repro_torch.core.policy import TwoTDrop
    gen = torch.Generator(device=dev)
    gen.manual_seed(1616)
    wgs = [layer["wg"]] + [torch.randn(layer["wg"].shape, generator=gen,
                                       device=dev) * 0.1
                           for _ in range(FIG10_LAYERS - 1)]
    with torch.no_grad():
        scores = [gating.route(calib, wg, cfg.top_k,
                               cfg.router_norm_topk).norm_score
                  for wg in wgs]
    cpu = [s.cpu() for s in scores]
    ts = torch.linspace(0.0, float(cpu[0].max()), FIG10_THRESHOLDS)
    rate_map = drop.threshold_to_drop_rate(scores[0], ts.to(dev))
    per_layer = drop.calibrate_per_layer_thresholds(scores, 0.25)
    pol = TwoTDrop(drop_target=0.25)._calibrated([wgs[0]], cfg, calib)
    r = gating.route(calib, wgs[0], cfg.top_k, cfg.router_norm_topk)
    pairs = drop.expand_pairs_2t(r.idx, r.combine, r.norm_score, 2,
                                 pol.t_major, pol.t_minor)
    rate = drop.drop_rate(pairs)
    saved = drop.flops_saved_fraction(pairs.modes)
    pairs_cpu = drop.SubExpertPairs(*(t.cpu() for t in pairs))
    kf, km, dr = (int(c) for c in drop.sub_pair_outcome_counts(pairs.keep,
                                                               2))
    kept_share = np.float32(kf + km) * (np.float32(1.0)
                                        / np.float32(kf + km + dr))
    checks = {
        "threshold_to_drop_rate": torch.equal(
            _bits(rate_map), _bits(drop.threshold_to_drop_rate(cpu[0], ts))),
        "calibrate_per_layer_thresholds": torch.equal(
            _bits(per_layer), _bits(drop.calibrate_per_layer_thresholds(
                cpu, 0.25))),
        "drop_rate": torch.equal(_bits(rate),
                                 _bits(drop.drop_rate(pairs_cpu))),
        "flops_saved_fraction": torch.equal(
            _bits(saved), _bits(drop.flops_saved_fraction(pairs_cpu.modes))),
        "drop_rate_is_1_minus_kept_over_total":
            float(rate) == float(np.float32(1.0) - kept_share),
    }
    out = dict(checks=checks, drop_rate=float(rate),
               flops_saved=float(saved), kept_full=kf, kept_major=km,
               dropped=dr, t_major=float(pol.t_major),
               t_minor=float(pol.t_minor),
               rate_map=[(float(t), float(v)) for t, v in
                         zip(ts, rate_map.cpu())][::8],
               per_layer=per_layer.cpu().tolist())
    log(f"  (a) {FIG10_CALIB} calibration tokens, {FIG10_LAYERS} routers at "
        f"Qwen3-30B-A3B width: Fig. 12 map at {FIG10_THRESHOLDS} thresholds "
        f"in [0, {float(ts[-1]):.4f}] (every 8th: "
        + ", ".join(f"{t:.3f}->{v:.4f}" for t, v in out["rate_map"])
        + f"); per-layer (t_major, t_minor) at 0.25: "
        + ", ".join(f"({a:.4f}, {b:.4f})" for a, b in out["per_layer"])
        + f"; 2T at 0.25: drop rate {out['drop_rate']:.6f}, FLOPs saved "
        f"{out['flops_saved']:.6f}, kept_full {kf} kept_major {km} "
        f"dropped {dr}; card vs CPU bitwise -> "
        + ", ".join(f"{k} {'ok' if v else 'FAIL'}" for k, v in
                    checks.items()))
    if not all(checks.values()):
        raise AssertionError(f"phase 16 (a): {checks}")
    return out


def fig10_point(dev, cfg, rec, x, pol, cap: int) -> dict:
    """One point of (b): the realised drop, the fused kernel's time against
    its bound and plain version, its row tiles, and the served MoE layer's
    time (routing, plan and kernel) with its launches counted."""
    import torch
    from repro_torch.core import drop, moe
    from repro_torch.kernels import dualsparse_ffn, ops
    T = x.shape[0]
    with torch.no_grad():
        pairs = pol.route(rec, x, cfg)
        kw, overflow = moe.fused_pipeline_args(rec, pairs, 2, cap, True)
        kf, km, dr = (int(c) for c in drop.sub_pair_outcome_counts(
            pairs.keep, 2))
        y1 = ops.fused_moe_pipeline(x, **kw)
        y2 = ops.fused_moe_pipeline(x, **kw)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        y_ref = ops.fused_moe_pipeline_ref(x, **kw)
        end.record()
        end.synchronize()
        plain_ms = start.elapsed_time(end)
        rel = float((y1 - y_ref).norm() / y_ref.norm())
        stable = bool(torch.equal(y1, y2))
        ms = cuda_ms(lambda: ops.fused_moe_pipeline(x, **kw), 20)

        def layer_call():
            return moe.moe_forward_dispatch(
                rec, x, cfg, pairs=pol.route(rec, x, cfg), capacity=cap,
                mode_grouped=True)
        reset_counts()
        layer_call()
        torch.cuda.synchronize()
        counts = read_counts()
        layer_ms = cuda_ms(layer_call, 20)
    cf, cm = kw["counts_full"], kw["counts_major"]
    n_major = dualsparse_ffn.resolve_n_major(
        kw["w1"].shape[-1], kw["p_factor"], kw["n_minor_start"], 128)
    tiles = tile_stats(
        lambda reg: dualsparse_ffn.launch_fused_moe_pipeline(
            x, kw["w1"], kw["w3"], kw["w2"], kw["group_offsets"], cf, cm,
            kw["tok_sorted"], kw["combine_sorted"], capacity=cap,
            p_factor=kw["p_factor"], n_major=n_major, regime=reg),
        cf, cm, cap, x.dtype)
    # row blocks of the many-row tile with no FULL row: the ones whose
    # minor-half strips are skipped
    blocks = (torch.clamp(cf + cm, max=cap) + 63) // 64
    full_blocks = (cf + 63) // 64
    bound_ms, bound_by, flops, nbytes, f32core_ms = fused_bound(
        kw, T, x.shape[1])
    return dict(
        T=T, capacity=cap, t_major=float(pol.t_major),
        t_minor=float(pol.t_minor),
        drop_rate=float(drop.drop_rate(pairs)),
        flops_saved=float(drop.flops_saved_fraction(pairs.modes)),
        kept_full=kf, kept_major=km, dropped=dr, overflow=int(overflow),
        ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
        bound_share=bound_ms / ms, bound_f32core_ms=f32core_ms,
        flops=flops, bytes=nbytes,
        rel_err=rel, max_abs_err=float((y1 - y_ref).abs().max()),
        bit_stable=stable, tiles=tiles,
        row_blocks=int(blocks.sum()),
        major_only_blocks=int((blocks - full_blocks).clamp(min=0).sum()),
        layer_ms=layer_ms, layer_launches=counts["fused_moe_pipeline"][
            "launches"],
        layer_plain_calls=sum(c["plain_calls"] for c in counts.values()))


def fig10_sweep(dev, cfg, rec) -> dict:
    """(b) Fig. 10 at full width: 2T-Drop calibrated to each FLOPs-saved
    target on the timed tokens themselves, at each T, at one capacity per T
    (the kernel skips dead tiles, so only the drop changes)."""
    import torch
    from repro_torch.core import moe
    from repro_torch.core.policy import TwoTDrop
    gen = torch.Generator(device=dev)
    gen.manual_seed(1010)
    d, E, K = cfg.d_model, cfg.n_experts, cfg.top_k
    out = {}
    for T in FIG10_T:
        x = torch.randn((T, d), generator=gen, device=dev)
        cap = moe.capacity_for(T, K * 2, E * 2, FIG10_CAPACITY)
        points = []
        for target in FIG10_TARGETS:
            pol = (TwoTDrop(partition_p=2, t_major=-1.0, t_minor=-1.0)
                   if target == 0 else
                   TwoTDrop(partition_p=2, drop_target=target)._calibrated(
                       [rec["wg"]], cfg, x))
            p = dict(target=target, **fig10_point(dev, cfg, rec, x, pol,
                                                  cap))
            base = points[0] if points else p
            p["kernel_rel"] = p["ms"] / base["ms"]
            p["layer_rel"] = p["layer_ms"] / base["layer_ms"]
            points.append(p)
            tl = p["tiles"]
            log(f"  (b) T={T} C={cap} target {target:.2f}: drop rate "
                f"{p['drop_rate']:.4f}, FLOPs saved {p['flops_saved']:.4f}; "
                f"kept_full {p['kept_full']} kept_major {p['kept_major']} "
                f"dropped {p['dropped']} overflow {p['overflow']}; kernel "
                f"{p['ms']:.4f} ms ({p['kernel_rel']:.3f} of keep-all), "
                f"bound {p['bound_ms']:.4f} ms ({p['bound_by']}, "
                f"{100 * p['bound_share']:.1f}% reached; CUDA-core bound "
                f"{p['bound_f32core_ms']:.4f} ms), plain "
                f"{p['plain_ms']:.3f} ms, rel_err {p['rel_err']:.3e}, "
                f"bit_stable {p['bit_stable']}; tiles: few "
                f"{tl['few_groups']} groups ({tl['few_rows']} rows), many "
                f"{tl['many_groups']} ({tl['many_rows']} rows), row slots "
                f"{tl['row_slots']} for {tl['live_rows']} live rows, "
                f"{p['row_blocks']} row blocks of 64, "
                f"{p['major_only_blocks']} with minor halves skipped; served "
                f"layer {p['layer_ms']:.4f} ms ({p['layer_rel']:.3f} of "
                f"keep-all; 1 - FLOPs saved {1 - p['flops_saved']:.3f}), "
                f"{p['layer_launches']} launch")
            if p["overflow"]:
                raise AssertionError(f"phase 16 (b) T={T} target {target}: "
                                     f"{p['overflow']} pairs overflowed "
                                     f"capacity {cap}")
            if not (p["rel_err"] <= REL_TOL and p["bit_stable"]):
                raise AssertionError(f"phase 16 (b) T={T} target {target}: "
                                     f"the kernel disagrees with its plain "
                                     f"version (rel_err {p['rel_err']:.3e}, "
                                     f"bit_stable {p['bit_stable']})")
            if p["layer_launches"] != 1 or p["layer_plain_calls"]:
                raise AssertionError(f"phase 16 (b): the served layer "
                                     f"launched {p['layer_launches']} times, "
                                     f"plain calls {p['layer_plain_calls']}")
            if not p["tiles"]["matches_plan"]:
                raise AssertionError("phase 16 (b): the kernel's row tiles "
                                     "differ from tile_plan")
        rates = [p["drop_rate"] for p in points]
        if not all(a < b for a, b in zip(rates, rates[1:])):
            raise AssertionError(f"phase 16 (b) T={T}: the realised drop "
                                 f"rate does not rise with the target: "
                                 f"{rates}")
        out[T] = points
        del x
    return out


def examples_run(dev) -> dict:
    """(c) The three walkthroughs through their ``main()`` on the card:
    quickstart at its default, the serve example with 8 requests, the
    Fig. 4 fine-tune for 20 steps; launches counted around each."""
    import contextlib
    import io
    import torch
    from repro_torch.examples import (finetune_partitioned, quickstart,
                                      serve_dualsparse)
    runs = {}
    for name, mod, argv in (
            ("quickstart", quickstart, []),
            ("serve_dualsparse", serve_dualsparse, ["--requests", "8"]),
            ("finetune_partitioned", finetune_partitioned,
             ["--steps", "20"])):
        buf = io.StringIO()
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            result = mod.main(argv + ["--device", str(dev)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
        runs[name] = dict(wall_s=wall, counts=counts,
                          output=buf.getvalue().splitlines())
        for line in runs[name]["output"]:
            log(f"    {name}: {line}")
        log(f"  (c) {name} {' '.join(argv) or '(defaults)'}: {wall:.1f} s, "
            f"fused_moe_pipeline launches "
            f"{counts['fused_moe_pipeline']['launches']}, plain calls "
            f"{sum(c['plain_calls'] for c in counts.values())}")
        if name == "finetune_partitioned":
            losses = result["orig"] + result["partitioned"]
            if not (len(losses) == 40 and all(l == l for l in losses)):
                raise AssertionError("phase 16 (c): the fine-tune's losses "
                                     "are not finite")
        elif counts["fused_moe_pipeline"]["launches"] == 0:
            raise AssertionError(f"phase 16 (c): {name} never launched "
                                 "the fused kernel")
        free_memory()
    return runs


def paper_metrics_phase(dev) -> dict:
    """Phase 16: one Qwen3-30B-A3B MoE layer at full width (d 2048, 128
    experts top-8, d_expert 768), seeded as ``moe_params`` draws, and
    FIG10_CALIB calibration tokens; (a) the drop metrics card vs CPU,
    (b) the layer prepared once by ``partition_and_reconstruct`` (P 2) on
    the calibration tokens, then Fig. 10's sweep, (c) the walkthroughs."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import reconstruct
    from repro_torch.data.pipeline import calibration_activations
    t0 = time.perf_counter()
    cfg = get_config("qwen3-moe-30b-a3b")
    gen = torch.Generator(device=dev)
    gen.manual_seed(16)
    layer = moe_params(gen, dev, cfg.d_model, cfg.n_experts, 1,
                       cfg.d_expert)
    calib = calibration_activations(np.random.default_rng(16), FIG10_CALIB,
                                    cfg.d_model, device=dev)
    metrics = metrics_check(dev, cfg, layer, calib)
    with torch.no_grad():
        rec = reconstruct.partition_and_reconstruct(layer, calib, cfg, p=2)
    del layer
    free_memory()
    sweep = fig10_sweep(dev, cfg, rec)
    del rec
    free_memory()
    summary = {str(T): [(p["target"], round(p["drop_rate"], 4),
                         round(p["flops_saved"], 4), round(p["ms"], 4),
                         round(p["layer_ms"], 4)) for p in pts]
               for T, pts in sweep.items()}
    examples = examples_run(dev)
    wall = time.perf_counter() - t0
    log(f"  phase 16 took {wall:.1f} s")
    return dict(metrics=metrics, fig10=sweep, fig10_summary=summary,
                examples=examples, wall_s=wall)


def build_phase() -> str:
    """Phase 1: the card's line, the versions, the build of every kernel
    with its ptxas registers and spills (none allowed in a tensor-core
    tile), HMMA in every tensor-core tile's SASS, the SwiGLU rings' shared
    memory. Returns the card's ``nvidia-smi`` line."""
    import re
    import torch
    from repro_torch.kernels import _build, dualsparse_ffn
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
        report = ptxas_report(text)
        for kernel, regs, spill, smem in report:
            log(f"    {name}: {kernel}: {regs} registers, {spill} bytes "
                f"spilled, {smem} bytes static shared memory")
        # the float32 tiles: the FMA few-row tile and the 3xTF32 many-row
        # tile, up and down
        floats = [(k, r) for k, r, _, _ in report
                  if re.match(r"(up|down)_(tf32_)?kernel<", k)]
        if floats:
            log(f"  {name}: float32 tiles' registers: " + ", ".join(
                f"{k} {r}" for k, r in floats))
        spilled = [k for k, _, spill, _ in report
                   if spill and any(t in k for t in TENSOR_CORE_TILES)]
        if spilled:
            raise AssertionError(f"{name}: tensor-core tiles spill: "
                                 f"{spilled}")
    for name in ("fused_moe_pipeline", "grouped_swiglu"):
        hmma = sass_mma(libs[name])
        log(f"  {name}: HMMA in the SASS of " + ", ".join(
            f"{k} {v}" for k, v in sorted(hmma.items())))
        # four bf16 tiles (up / down, few / many) and the two float32
        # many-row tiles
        if len(hmma) != 6 or not all(hmma.values()):
            raise AssertionError(f"{name}: a tensor-core tile without HMMA "
                                 f"ops: {hmma}")
    for dtype in dualsparse_ffn.ELEMENT_TYPES:
        ring = dualsparse_ffn.ring_bytes(dtype)
        log(f"  swiglu tiles' cp.async rings, {dtype} operands (dynamic "
            "shared memory per CTA): "
            + ", ".join(f"{k} {v}" for k, v in ring.items()))

    return smi


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    # fails outside a checkout
    import repro_torch.kernels  # noqa: F401
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    log("phase 1: device")
    smi = build_phase()

    log("phase 2: kernels against their plain versions")
    log(f"  bound = max(bytes / {HBM_BYTES_PER_S / 1e12:.2f} TB/s HBM, "
        f"each group's FLOPs at the rate of its row tile's units: float32 "
        f"many-row 3 x FLOPs / {TF32_FLOPS / 1e12:.0f} TFLOP/s TF32 "
        f"tensor-core peak, float32 few-row FLOPs / "
        f"{F32_FLOPS / 1e12:.0f} TFLOP/s CUDA-core peak, bf16 FLOPs / "
        f"{BF16_FLOPS / 1e12:.0f} TFLOP/s tensor-core peak); the CUDA-core "
        f"bound counts every float32 FLOP at {F32_FLOPS / 1e12:.0f} "
        f"TFLOP/s (PRs 14-22); bar rel_err <= {REL_TOL:g} "
        f"({BF16_REL_TOL:g} for bf16) and bit-identical across launches")
    cases = kernel_phase(dev)
    log("phase 2b: grouped_swiglu against its plain version")
    grouped = grouped_phase(dev)
    log("phase 3: serve Qwen3-30B-A3B (4 of 48 layers) under 2T-Drop")
    serve, (cfg, model, policy, calib) = serve_phase(dev)
    log(f"phase 4: continuous batching ({SLOTS} slots, {N_REQ} requests, "
        f"fused route)")
    cont = continuous_phase(dev, cfg, model, policy)
    log(f"phase 5: paged engine (page 16, chunk 64, {SLOTS} slots, {N_REQ} "
        f"requests, buffer path on grouped_swiglu)")
    paged = paged_phase(dev, cfg, model, calib)
    del model, policy, calib
    torch.cuda.empty_cache()
    log("phase 6: ssd_chunk against its plain version")
    log(f"  bound = max(bytes / {HBM_BYTES_PER_S / 1e12:.2f} TB/s HBM, "
        f"3 x FLOPs / {TF32_FLOPS / 1e12:.0f} TFLOP/s TF32 tensor-core "
        f"peak: the kernel's 3xTF32 products); bars rel_err <= {REL_TOL:g} "
        f"(y, states), <= {DECAY_TOL:g} (decay), bit-identical")
    ssd = ssd_phase(dev)
    log("phase 7: serve Mamba2-370m (48 layers), 8 x 512 x 16")
    mamba = recurrent_serve_phase(dev, "mamba2-370m", 512)
    torch.cuda.empty_cache()
    log("phase 8: serve Zamba2-7B (81 layers, 14 shared-block occurrences), "
        "8 x 384 x 16")
    zamba = recurrent_serve_phase(dev, "zamba2-7b", 384)
    free_memory()
    log(f"phase 9: serve DBRX-132B ({DBRX_LAYERS} of 40 layers) under 2t, "
        f"load_aware and per_layer, 4 x 1536 x 16")
    dbrx = dbrx_phase(dev)
    free_memory()
    log("phase 10: serve the dense and VLM decoders")
    dense = {}
    for arch, n_layers, B, S, NEW in DENSE_CASES:
        dense[arch] = dense_serve(dev, arch, n_layers, B, S, NEW)
        free_memory()
    log(f"phase 11: S-ETP over {SETP_RANKS} ranks on this card (gloo, the "
        f"wire through host memory; times are not an EP step time): "
        f"Qwen3-30B-A3B ({N_LAYERS} of 48 layers) under load_aware, "
        f"{EP_B} x {EP_S} x {EP_NEW} sync + {EP_REQ} requests on "
        f"{EP_SLOTS} continuous slots + {EP_REQ} requests on {EP_SLOTS} "
        f"paged slots; then ETP on (ep 2, tp 2)")
    ep = ep_phase(dev)
    log("phase 12: serve MiniCPM3-4B (MLA, 62 layers), 4 x 512 x 16")
    mla = dense_serve(dev, "minicpm3-4b", None, 4, 512, 16, continuous=True)
    free_memory()
    log(f"phase 13: train on the card: reduced Qwen3 card vs CPU; "
        f"Qwen3-30B-A3B full width ({TRAIN_LAYERS} of 48 layers) "
        f"{TRAIN_STEPS} steps at {TRAIN_B} x {TRAIN_S}; the Fig. 4 "
        f"fine-tune, {FIG4_STEPS} steps x 2 at {FIG4_B} x {FIG4_S}, with a "
        f"checkpoint round trip")
    train = train_phase(dev)
    free_memory()
    log(f"phase 14: serve Whisper-large-v3 (32 + 32 layers), {WHISPER_B} x "
        f"(1500 stub frames, {WHISPER_S} tokens) x {WHISPER_NEW}; card vs "
        f"CPU at {WHISPER_CHECK_LAYERS} + {WHISPER_CHECK_LAYERS} layers")
    whisper = whisper_phase(dev)
    free_memory()
    log(f"phase 15: train over EP, {SETP_RANKS} ranks on this card (gloo, "
        f"the wire through host memory): reduced Qwen3 card vs CPU at the "
        f"float32 and bf16 wires with a sharded checkpoint round trip; "
        f"Qwen3-30B-A3B full width "
        f"({TRAIN_EP_LAYERS} of 48 layers) {TRAIN_EP_STEPS} steps at "
        f"{TRAIN_EP_B} x {TRAIN_EP_S}, remat; Whisper-large-v3 "
        f"({WHISPER_EP_LAYERS} + {WHISPER_EP_LAYERS} layers) under the "
        f"context vs without")
    train_ep = train_ep_phase(dev)
    free_memory()
    log(f"phase 16: the paper's drop metrics on the card: one Qwen3-30B-A3B "
        f"MoE layer at full width, card vs CPU bitwise; Fig. 10 (2T "
        f"targets {list(FIG10_TARGETS)} at T {list(FIG10_T)}, capacity "
        f"factor {FIG10_CAPACITY}); the three walkthroughs")
    paper = paper_metrics_phase(dev)

    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    with open(out_dir / "chip_smoke.json", "w") as fh:
        json.dump({"device": smi, "torch": torch.__version__,
                   "kernel_cases": cases, "grouped_cases": grouped,
                   "serve": serve, "continuous": cont, "paged": paged,
                   "ssd_cases": ssd, "mamba2": mamba, "zamba2": zamba,
                   "dbrx": dbrx, "dense": dense, "setp_world": ep,
                   "minicpm3": mla, "train": train, "whisper": whisper,
                   "train_ep": train_ep, "paper_metrics": paper},
                  fh, indent=1)

    def kernel_entry(name, replaces, case_list, case, launches, at=None,
                     dtype="float32"):
        """The kernel's line, timed at the main path's shape ``case``; its
        error is the largest over the cases of its operand type."""
        case_list = [c for c in case_list
                     if c.get("dtype", "float32") == dtype]
        main_case = next(c for c in case_list if c["case"] == case)
        source = name.split("[")[0]
        return {"name": name, "route": "cuda",
                "source": f"src/repro_torch/kernels/csrc/{source}.cu",
                "replaces": replaces, "launches": launches,
                "max_abs_err": max(c["max_abs_err"] for c in case_list),
                "ms": main_case["ms"], "plain_ms": main_case["plain_ms"],
                "bound_ms": main_case["bound_ms"],
                "bound_by": main_case["bound_by"], "library_ms": None,
                "bound_f32core_ms": main_case["bound_f32core_ms"],
                "at": at or f"{case} T={main_case['T']} "
                            f"C={main_case['capacity']}, Qwen3-30B-A3B "
                            f"widths"}
    # launches of every served phase that runs the kernel
    fused_launches = (serve["launches"]
                      + cont["counts"]["fused_moe_pipeline"]["launches"]
                      + paged["fused_route"]["counts"]["fused_moe_pipeline"][
                          "launches"]
                      + sum(dbrx[p]["launches"]
                            for p in ("2t", "load_aware", "per_layer"))
                      + sum(p["layer_launches"]
                            for pts in paper["fig10"].values() for p in pts)
                      + sum(r["counts"]["fused_moe_pipeline"]["launches"]
                            for r in paper["examples"].values()))
    fused = kernel_entry("fused_moe_pipeline",
                         "src/repro/kernels/dualsparse_ffn.py:498", cases,
                         "prefill", fused_launches,
                         at="prefill T=1024 at Qwen3-30B-A3B widths; "
                            "launches of phases 3, 4, 5 (fused route), 9 "
                            "and 16")
    wide = next(c for c in cases if c["case"] == "dbrx_prefill")
    fused["dbrx_prefill"] = {k: wide[k] for k in (
        "T", "capacity", "ms", "plain_ms", "bound_ms", "bound_by",
        "bound_f32core_ms", "max_abs_err", "rel_err")}
    ep_ranks = ep["ranks"]
    log("fig10 " + json.dumps(paper["fig10_summary"]))
    log(smi.splitlines()[0])          # the card's line, again beside the result
    print(json.dumps({"kernels": [
        fused,
        kernel_entry("fused_moe_pipeline[bf16]",
                     "src/repro/kernels/dualsparse_ffn.py:498", cases,
                     "setp_prefill_bf16",
                     sum(r[run]["counts"]["fused_moe_pipeline"]
                         ["launches_bf16"] for r in ep_ranks
                         for run in ("sync", "paged")),
                     at="S-ETP local seating of rank 0, prefill (T_local "
                        "256, 4736 received rows, 64 local sub-experts, "
                        "c2 96), bf16; launches of phase 11's sync and "
                        "paged runs, 4 ranks", dtype="bfloat16"),
        kernel_entry("grouped_swiglu",
                     "src/repro/kernels/dualsparse_ffn.py:192", grouped,
                     "chunk",
                     paged["counts"]["grouped_swiglu"]["launches"]),
        kernel_entry("grouped_swiglu[bf16]",
                     "src/repro/kernels/dualsparse_ffn.py:192", grouped,
                     "setp_decode_bf16",
                     sum(r[run]["counts"]["grouped_swiglu"]
                         ["launches_bf16"] for r in ep_ranks
                         for run in ("continuous", "paged")),
                     at="S-ETP local buffers of rank 0, decode (T_local 8, "
                        "160 received rows, c2 8), bf16; launches of "
                        "phase 11's continuous (buffer path) and paged "
                        "runs, 4 ranks",
                     dtype="bfloat16"),
        # no single PyTorch call computes the intra-chunk SSD either
        kernel_entry("ssd_chunk", "src/repro/kernels/ssd_chunk.py:59", ssd,
                     "mamba2-370m/grouped",
                     mamba["launches"] + zamba["launches"],
                     at="Mamba2-370m prefill BH=256 nc=2 Q=256 P=64 "
                        "N=128, B/C in 8 group rows; launches of phases 7 "
                        "and 8")]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
