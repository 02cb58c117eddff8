"""Static expert reconstruction (paper §4.2(b)).

Neuron-importance profiling on calibration samples (four metrics,
Eqs. 14-17), then a per-expert neuron permutation that sorts neurons by
importance so that after partial transformation with P=2 sub-expert ``2e``
holds the MAJOR (important) half and ``2e+1`` the MINOR half. Permuting the
columns of W1/W3 with the rows of W2 leaves a SwiGLU expert unchanged.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from . import gating

IMPORTANCE_METHODS = ("gate", "abs_gate", "gate_up", "abs_gate_up")


def neuron_importance(params: Dict, x, cfg, method: str = "abs_gate",
                      routed_only: bool = True):
    """Accumulated neuron importance per (expert, neuron) -> (E, f).

    Eq. 14 gate: Σ Swish(x·W1)        Eq. 15 abs_gate: Σ |Swish(x·W1)|
    Eq. 16 gate_up: Σ Swish(x·W1)⊙(x·W3)   Eq. 17 abs_gate_up: Σ |...|
    ``routed_only`` accumulates only over tokens routed to the expert."""
    if method not in IMPORTANCE_METHODS:
        raise ValueError(f"unknown importance method {method}")
    E = params["w1"].shape[0]
    g = F.silu(torch.einsum("td,edf->etf", x, params["w1"]))     # (E,T,f)
    if method in ("gate_up", "abs_gate_up"):
        g = g * torch.einsum("td,edf->etf", x, params["w3"])
    if method.startswith("abs"):
        g = torch.abs(g)
    if routed_only:
        r = gating.route(x, params["wg"], cfg.top_k, cfg.router_norm_topk)
        T = r.idx.shape[0]
        sel = torch.zeros((T, E), dtype=g.dtype, device=x.device)
        sel.scatter_add_(1, r.idx.long(),
                         torch.ones(r.idx.shape, dtype=g.dtype,
                                    device=x.device))
        g = g * sel.T[:, :, None]
    return g.sum(dim=1)


def reorder_neurons(params: Dict, importance) -> Dict:
    """Permute each expert's neurons so importance is descending (exact).
    The sort is stable, as ``jnp.argsort`` is."""
    order = torch.argsort(-importance, dim=-1, stable=True)      # (E, f)
    d = params["w1"].shape[1]
    idx_in = order[:, None, :].expand(-1, d, -1)
    out = dict(params)
    out.update({
        "w1": torch.gather(params["w1"], 2, idx_in),
        "w3": torch.gather(params["w3"], 2, idx_in),
        "w2": torch.gather(params["w2"], 1,
                           order[:, :, None].expand(-1, -1, d)),
    })
    return out


def partition_and_reconstruct(params: Dict, x, cfg, p: int = 2,
                              method: str = "abs_gate") -> Dict:
    """The paper's unified process (§4.2(b)): profile each original expert's
    neurons, reorder by importance, then partial-transform so the major
    sub-expert is ``e*p`` and the minor ones ``e*p+1..``."""
    from . import partition as part
    imp = neuron_importance(params, x, cfg, method)
    return part.partial_transform(reorder_neurons(params, imp), p)
