"""Expert partition: complete and partial transformations (paper §3).

Both transformations are exact restructurings of a pre-trained MoE layer.
Params layout: wg (d, E); w1, w3 (E, d, f); w2 (E, f, d).
"""
from __future__ import annotations

from typing import Dict

import torch


def _partition_expert_weights(w1, w3, w2, p: int):
    """Evenly split each expert's neurons into p contiguous sub-experts:
    (E, d, f) -> (E*p, d, f/p); (E, f, d) -> (E*p, f/p, d). Sub-expert
    e*p + j holds neuron slice [j*f/p, (j+1)*f/p) of expert e."""
    E, d, f = w1.shape
    if f % p:
        raise ValueError(f"d_expert {f} not divisible by partition factor {p}")
    fp = f // p

    def split_in(w):
        return w.reshape(E, d, p, fp).permute(0, 2, 1, 3).reshape(E * p, d, fp)

    return split_in(w1), split_in(w3), w2.reshape(E * p, fp, d)


def complete_transform(params: Dict, p: int) -> Dict:
    """Complete transformation (§3.1): a standard MoE layer with E*p experts
    and Top-(K*p) selection computing the identical function — gating rows
    repeated p times (Eq. 7), neurons partitioned, W2 scaled by p (Eq. 11)."""
    w1p, w3p, w2p = _partition_expert_weights(params["w1"], params["w3"],
                                              params["w2"], p)
    out = dict(params)
    out.update({"wg": torch.repeat_interleave(params["wg"], p, dim=1),
                "w1": w1p, "w3": w3p, "w2": w2p * p})
    return out


def partial_transform(params: Dict, p: int) -> Dict:
    """Partial transformation (§3.2): gating untouched; only expert weights
    are split. Score repetition / index remapping (Eq. 12) happens at routing
    time (``core.drop.expand_pairs_*``). No W2 scaling (Eq. 13)."""
    w1p, w3p, w2p = _partition_expert_weights(params["w1"], params["w3"],
                                              params["w2"], p)
    out = dict(params)
    out.update({"w1": w1p, "w3": w3p, "w2": w2p})
    return out


def invert_partial(params: Dict, p: int) -> Dict:
    """Reverse of ``partial_transform`` (the gating network is preserved)."""
    w1, w3, w2 = params["w1"], params["w3"], params["w2"]
    Ep, d, fp = w1.shape
    E = Ep // p

    def merge_in(w):
        return w.reshape(E, p, d, fp).permute(0, 2, 1, 3).reshape(E, d, p * fp)

    out = dict(params)
    out.update({"w1": merge_in(w1), "w3": merge_in(w3),
                "w2": w2.reshape(E, p * fp, d)})
    return out


def dense_ffn_partition(w1, w3, w2, p: int):
    """Exact partition of a dense SwiGLU FFN, w1/w3 (d, f) and w2 (f, d),
    into p uniform sub-FFNs (gate 1 each): (p, d, f/p) x2 and (p, f/p, d),
    with sum_j f_j(x) == f(x). No entry point calls it; it is the form
    S-ETP-style AlltoAll sharding would take for a dense FFN."""
    return _partition_expert_weights(w1[None], w3[None], w2[None], p)
