"""Quickstart: the DualSparse-MoE pipeline end to end on a tiny MoE model,
on the card unless ``--device`` names another.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

1. Build an OLMoE-layout MoE model (random "pre-trained" weights).
2. Profile neuron importance on calibration data (paper Eq. 15).
3. Reconstruct experts into major/minor halves + partial transformation.
4. Compare full vs 1T-Drop vs 2T-Drop outputs and FLOPs savings.
5. Generate a few tokens with 2T-Drop enabled (on the card, through the
   fused MoE kernel).
"""
from __future__ import annotations

import argparse
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core import drop, gating, moe, reconstruct
from repro_torch.core.policy import make_policy
from repro_torch.data.pipeline import calibration_activations
from repro_torch.device import resolve_device
from repro_torch.examples.serve_dualsparse import make_prompts, sync_engine
from repro_torch.models import model as M
from repro_torch.serving import GenerationConfig

PROMPT_LEN = 16
NEW_TOKENS = 12


def profile_and_reconstruct(layer: Dict, calib, cfg
                            ) -> Tuple[torch.Tensor, Dict]:
    """Steps 2-3 on one MoE layer's params: the (E, f) neuron importance,
    and the layer reconstructed and partitioned into P=2 sub-experts."""
    with torch.no_grad():
        imp = reconstruct.neuron_importance(layer, calib, cfg, "abs_gate")
        rec = reconstruct.partition_and_reconstruct(layer, calib, cfg, p=2)
    return imp, rec


def drop_comparison(layer: Dict, rec: Dict, x, cfg
                    ) -> List[Tuple[str, float, float]]:
    """Step 4: (name, FLOPs-saved fraction, relative output error against
    the full layer) of 1T-Drop at the scores' 25% quantile and of 2T-Drop
    at that quantile ± 0.005, through the dense oracle."""
    with torch.no_grad():
        y_full = moe.moe_forward_ref(layer, x, cfg)
        r = gating.route(x, layer["wg"], cfg.top_k, cfg.router_norm_topk)
        t1 = float(torch.quantile(r.norm_score, 0.25))
        rows = []
        for name, pairs in [
                ("1T-Drop", drop.expand_pairs_1t(r.idx, r.combine,
                                                 r.norm_score, 2, t1)),
                ("2T-Drop", drop.expand_pairs_2t(r.idx, r.combine,
                                                 r.norm_score, 2,
                                                 t1 - 0.005, t1 + 0.005))]:
            y = moe.moe_forward_ref(rec, x, cfg, pairs=pairs)
            fs = float(drop.flops_saved_fraction(pairs.modes))
            err = float(torch.sqrt(torch.mean((y - y_full) ** 2)
                                   / torch.mean(y_full ** 2)))
            rows.append((name, fs, err))
    return rows


def generate_2t(cfg, model, policy, prompts: Sequence[np.ndarray], *,
                new_tokens: int = NEW_TOKENS, device="cuda"):
    """Step 5: greedy generation from a 2T-prepared model under ``policy``
    (its MoE layers take the fused kernel on the card)."""
    eng = sync_engine(cfg, model, prompts, new_tokens, policy, device)
    return eng.generate(prompts, GenerationConfig(max_new_tokens=new_tokens))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_config("olmoe-lite")
    print(f"model: {cfg.arch_id} — {cfg.n_experts} experts, top-{cfg.top_k}, "
          f"~{cfg.n_params()/1e6:.1f}M params")
    model = M.init_params(cfg, seed=0, device=dev)

    # --- 2+3: profile + reconstruct + partial transformation (paper §4.2) ---
    calib = calibration_activations(np.random.default_rng(1), 512,
                                    cfg.d_model, device=dev)
    layer0 = model.blocks[0].moe.weights()
    imp, rec = profile_and_reconstruct(layer0, calib, cfg)
    print(f"neuron importance: shape {tuple(imp.shape)}, "
          f"top/bottom ratio {float(imp.max()/imp.min()):.1f}")
    print(f"partitioned experts: {tuple(layer0['w1'].shape)} -> "
          f"{tuple(rec['w1'].shape)} (major/minor sub-experts)")

    # --- 4: drop comparison on one MoE layer ---
    rows = drop_comparison(layer0, rec, calib[:256], cfg)
    for name, fs, err in rows:
        print(f"{name}: flops saved {fs:.1%}, relative output error {err:.4f}")

    # --- 5: generate with the full DualSparse model. ONE policy object
    # carries partition factor, thresholds, and execution hints end to end.
    policy = make_policy("2t", cfg.dualsparse)
    model, policy = policy.prepare(model, cfg, calib)
    prompts = make_prompts(cfg, 2, PROMPT_LEN)
    results = generate_2t(cfg, model, policy, prompts, device=dev)
    for res in results:
        print(f"request {res.uid}: generated {res.tokens}")
    print("OK")
    return {"drop": rows, "tokens": [r.tokens for r in results]}


if __name__ == "__main__":
    main()
