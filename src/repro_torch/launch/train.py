"""Training driver of the PyTorch port, on the card unless ``--device``
names another (``--device cpu`` runs it on the CPU).

Example (CPU, reduced arch, synthetic data, resumes from ``--ckpt-dir``):
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-moe-30b-a3b \\
      --reduced --device cpu --steps 4 --ckpt-dir /tmp/ckpt --ckpt-every 2

Checkpoints use the JAX package's format and leaf names
(``params/...``, ``opt/step``, ``opt/mu/...``, ``opt/nu/...``), so either
package resumes from the other's.
"""
from __future__ import annotations

import argparse
import os
import time
from typing import Optional

import torch

from repro_torch.checkpoint import from_numpy as bridge
from repro_torch.checkpoint import io as ckpt
from repro_torch.configs import get_config, list_archs
from repro_torch.data import pipeline
from repro_torch.device import resolve_device
from repro_torch.models import model as M
from repro_torch.optim import adamw, cosine_schedule


def save_state(ckpt_dir: str, step: int, model, opt_state, dist=None,
               **kw) -> str:
    """Write the model's weights and its AdamW state as one checkpoint.
    Under an EP context ``dist`` every rank calls this: the expert leaves
    and their moments are gathered into the global arrays the JAX package
    saves, the rank at coordinate 0 of every axis writes, and every rank
    returns once the files are there; only the writing rank builds the
    host tree."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    if dist is None or dist.is_origin():
        tree = {"params": bridge.params_to_numpy(model, dist),
                "opt": bridge.opt_state_to_numpy(opt_state, model, dist)}
        path = ckpt.save_checkpoint(ckpt_dir, step, tree, **kw)
    else:
        bridge.join_gathers(model, opt_state, dist)
    if dist is not None:
        torch.distributed.barrier()
    return path


def restore_state(ckpt_dir: str, model, opt_state,
                  step: Optional[int] = None, dist=None) -> None:
    """Load a checkpoint (the latest without ``step``) into the model and
    its AdamW state in place; under an EP context ``dist`` every rank reads
    the file and keeps its expert shard."""
    tree = ckpt.restore_checkpoint(
        ckpt_dir, bridge.train_state_spec(model, opt_state, dist), step=step)
    bridge.load_params(model, tree["params"], dist)
    bridge.load_opt_state(opt_state, tree["opt"], model, dist)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-moe-30b-a3b", choices=list_archs())
    ap.add_argument("--reduced", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default: the card)")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--aux-coef", type=float, default=0.01,
                    help="MoE load-balance aux loss coefficient")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--log-every", type=int, default=10)
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    print(f"arch={cfg.arch_id} family={cfg.family} "
          f"params~{cfg.n_params()/1e6:.1f}M reduced={args.reduced}")

    model = M.init_params(cfg, seed=args.seed, device=dev)
    opt = adamw(cosine_schedule(args.lr, args.steps, warmup=args.steps // 20))
    opt_state = opt.init(M.trainable(model))
    loader = pipeline.make_loader(cfg, args.batch, args.seq, seed=args.seed)
    step_fn = M.make_train_step(
        cfg, opt, aux_coef=args.aux_coef if cfg.is_moe else 0.0)

    start = 0
    if args.ckpt_dir and ckpt.latest_step(args.ckpt_dir) is not None:
        start = ckpt.latest_step(args.ckpt_dir)
        restore_state(args.ckpt_dir, model, opt_state, step=start)
        print(f"restored step {start}")

    t0 = time.time()
    for i in range(start, args.steps):
        loss = step_fn(model, opt_state, loader.get_batch(i))
        if (i + 1) % args.log_every == 0 or i == start:
            dt = time.time() - t0
            print(f"step {i+1:5d}  loss {float(loss):.4f}  "
                  f"({dt / max(i + 1 - start, 1):.2f}s/step)", flush=True)
        if args.ckpt_dir and (i + 1) % args.ckpt_every == 0:
            save_state(args.ckpt_dir, i + 1, model, opt_state)
    print("done")


if __name__ == "__main__":
    main()
