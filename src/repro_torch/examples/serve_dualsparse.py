"""Serving with the DualSparse-MoE inference system (paper §4-§5.3), on the
card unless ``--device`` names another: throughput of baseline against
2T-Drop serving on the synchronized-batch engine, then 2T-Drop on the
continuous-batching engine (mixed-length requests admitted into slots as
they free up).

    PYTHONPATH=src python -m repro_torch.examples.serve_dualsparse \\
        --requests 8 [--device cpu]

PyTorch runs eagerly, so the continuous engine's line counts decode steps
and no traces.
"""
from __future__ import annotations

import argparse
import time
from typing import List, Sequence

import numpy as np

from repro_torch.configs import get_config
from repro_torch.core.policy import make_policy
from repro_torch.data.pipeline import SyntheticLM, calibration_activations
from repro_torch.device import resolve_device
from repro_torch.models import model as M
from repro_torch.serving import (ContinuousBatchingEngine, GenerationConfig,
                                 ServingEngine)


def make_prompts(cfg, n: int, prompt_len: int) -> List[np.ndarray]:
    """``n`` prompts of ``prompt_len`` tokens from the synthetic source,
    request ``i`` drawn from seed ``i``."""
    src = SyntheticLM(cfg.vocab_size)
    return [src.sample_batch(np.random.default_rng(i), 1,
                             prompt_len)["tokens"][0] for i in range(n)]


def throughput(engine, prompts: Sequence[np.ndarray], new_tokens: int):
    """(tok/s, results) of one ``generate`` over every prompt."""
    t0 = time.time()
    res = engine.generate(prompts, GenerationConfig(max_new_tokens=new_tokens))
    dt = time.time() - t0
    return sum(len(r.tokens) for r in res) / dt, res


def sync_engine(cfg, model, prompts, new_tokens: int, policy=None,
                device="cuda"):
    """The synchronized-batch engine over all ``prompts`` at once: the
    baseline without ``policy``, DualSparse under a 2T one (its MoE
    layers take the fused kernel on the card)."""
    return ServingEngine(cfg, model, batch_size=len(prompts),
                         max_prompt_len=max(len(p) for p in prompts),
                         max_new_tokens=new_tokens, policy=policy,
                         device=device)


def continuous_engine(cfg, model, prompts, new_tokens: int, slots: int,
                      policy, device="cuda"):
    """The continuous-batching engine: the same 2T policy threads through
    its per-slot decode path; requests flow through ``slots`` slots."""
    return ContinuousBatchingEngine(
        cfg, model, n_slots=slots,
        max_prompt_len=max(len(p) for p in prompts),
        max_new_tokens=new_tokens, policy=policy, device=device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmoe-lite")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=50)
    ap.add_argument("--new-tokens", type=int, default=10)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_config(args.arch)
    model = M.init_params(cfg, seed=0, device=dev)
    prompts = make_prompts(cfg, args.requests, args.prompt_len)

    base_tps, base_res = throughput(
        sync_engine(cfg, model, prompts, args.new_tokens, device=dev),
        prompts, args.new_tokens)
    print(f"baseline (sync)  : {base_tps:.1f} tok/s")

    calib = calibration_activations(np.random.default_rng(7), 512,
                                    cfg.d_model, device=dev)
    policy = make_policy("2t", cfg.dualsparse)
    model, policy = policy.prepare(model, cfg, calib)
    ds_tps, ds_res = throughput(
        sync_engine(cfg, model, prompts, args.new_tokens, policy, dev),
        prompts, args.new_tokens)
    print(f"DualSparse 2T    : {ds_tps:.1f} tok/s "
          f"(T²=({policy.t_major}, {policy.t_minor}))")

    agree = np.mean([a.tokens == b.tokens
                     for a, b in zip(base_res, ds_res)])
    print(f"greedy outputs identical on {agree:.0%} of requests "
          "(drop perturbs low-score experts only)")

    cont_eng = continuous_engine(cfg, model, prompts, args.new_tokens,
                                 args.slots, policy, dev)
    cont_tps, cont_res = throughput(cont_eng, prompts, args.new_tokens)
    print(f"DualSparse 2T + continuous batching ({args.slots} slots): "
          f"{cont_tps:.1f} tok/s — admitted {cont_eng.n_admitted} requests "
          f"over {cont_eng.decode_steps} decode steps")
    return {"baseline": base_res, "2t": ds_res, "continuous": cont_res,
            "tok_per_s": {"baseline": base_tps, "2t": ds_tps,
                          "continuous": cont_tps}}


if __name__ == "__main__":
    main()
