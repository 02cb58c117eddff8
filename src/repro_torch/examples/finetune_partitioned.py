"""End-to-end fine-tuning run (paper §3.1 / Fig. 4), on the card unless
``--device`` names another: fine-tune a ~100M-param MoE model for a few
hundred steps, original granularity vs complete-transformation-partitioned
(P=2), and compare loss curves.

    PYTHONPATH=src python -m repro_torch.examples.finetune_partitioned \\
        --steps 300 [--device cpu]

The data pipeline, AdamW on a cosine schedule, gradient clipping,
checkpointing (every 100 steps of the original run under ``--ckpt-dir``,
in the format both packages restore) and loss reporting.
"""
from __future__ import annotations

import argparse
import copy
import dataclasses
import time
from typing import List, Optional

import torch

from repro_torch.checkpoint import from_numpy as bridge
from repro_torch.checkpoint import io as ckpt
from repro_torch.configs.base import DualSparseConfig, ModelConfig
from repro_torch.core import partition
from repro_torch.data import pipeline
from repro_torch.device import resolve_device
from repro_torch.models import model as M
from repro_torch.optim import adamw, cosine_schedule

# ~100M params: 8 layers, d_model 512, 16 experts x d_expert 512 top-2,
# vocab 16k  ->  emb 2x8.2M + 8 x (attn 1.3M + moe 12.6M) ≈ 128M
CFG_100M = ModelConfig(
    arch_id="moe-100m", family="moe", source="examples",
    n_layers=8, d_model=512, n_heads=8, n_kv_heads=2, d_ff=512,
    vocab_size=16384, n_experts=16, top_k=2, d_expert=512,
    dualsparse=DualSparseConfig(enabled=True))


def partitioned_config(cfg: ModelConfig, p: int) -> ModelConfig:
    """The complete-transformation twin's config: P x the experts, P x the
    top-k, 1/P of the neurons per expert."""
    return dataclasses.replace(cfg, n_experts=cfg.n_experts * p,
                               top_k=cfg.top_k * p,
                               d_expert=cfg.d_expert // p)


def partition_model(model, p: int):
    """Complete transformation of every MoE layer, in place: the same
    function at init, at P x the expert granularity."""
    with torch.no_grad():
        for b in model.blocks:
            b.moe.load_weights(partition.complete_transform(b.moe.weights(),
                                                            p))
    return model


def train(cfg, model, steps: int, batch: int, seq: int, lr: float, tag: str,
          log_every: int = 20, ckpt_dir: Optional[str] = None) -> List[float]:
    """``steps`` AdamW steps (cosine schedule, aux 0.01) on the synthetic
    loader, in place; returns each step's loss (taken before its update)."""
    opt = adamw(cosine_schedule(lr, steps, warmup=max(steps // 20, 5)))
    ost = opt.init(M.trainable(model))
    step_fn = M.make_train_step(cfg, opt, aux_coef=0.01)
    loader = pipeline.make_loader(cfg, batch, seq)
    t0 = time.time()
    losses = []
    for i in range(steps):
        loss = step_fn(model, ost, loader.get_batch(i))
        losses.append(float(loss))
        if (i + 1) % log_every == 0:
            print(f"[{tag}] step {i+1:4d} loss {losses[-1]:.4f} "
                  f"({(time.time()-t0)/(i+1):.2f}s/step)", flush=True)
        if ckpt_dir and (i + 1) % 100 == 0:
            ckpt.save_checkpoint(ckpt_dir, i + 1,
                                 {"params": bridge.params_to_numpy(model)})
    return losses


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = CFG_100M
    print(f"params ~{cfg.n_params()/1e6:.0f}M; {args.steps} steps, "
          f"batch {args.batch} x seq {args.seq}")
    model = M.init_params(cfg, seed=0, device=dev)
    # complete transformation P=2: top-4 of 32 — same function at init
    cfg_p = partitioned_config(cfg, 2)
    model_p = partition_model(copy.deepcopy(model), 2)

    # original granularity: top-2 of 16
    l_orig = train(cfg, model, args.steps, args.batch, args.seq, args.lr,
                   "orig  top2/16e", ckpt_dir=args.ckpt_dir)
    del model
    l_part = train(cfg_p, model_p, args.steps, args.batch, args.seq,
                   args.lr, "P=2   top4/32e")

    n = max(args.steps // 10, 1)
    print("\nfinal-10% mean loss:")
    print(f"  original    : {sum(l_orig[-n:])/n:.4f}")
    print(f"  partitioned : {sum(l_part[-n:])/n:.4f}")
    print("(paper Fig 4: partitioned experts reach lower fine-tuning loss)")
    return {"orig": l_orig, "partitioned": l_part}


if __name__ == "__main__":
    main()
