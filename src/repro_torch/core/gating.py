"""MoE gating (paper §2.1.1, Eqs. 1-3).

The *combine weight* multiplies each expert output (renormalized top-k for
Qwen3/Mixtral-style routers, raw softmax score for DeepSeek-style); the
*normalized gating score* drives the DualSparse drop decision (paper §4.1
always normalizes over the selected top-k).
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class Routing(NamedTuple):
    """Top-k routing decision for a flat batch of T tokens."""
    idx: torch.Tensor          # (T, K) int32 — selected expert ids
    combine: torch.Tensor      # (T, K) f32 — weight applied to expert outputs
    norm_score: torch.Tensor   # (T, K) f32 — normalized score for drops
    probs: torch.Tensor        # (T, E) f32 — full softmax


def gate_logits(x, wg):
    """x: (T, d), wg: (d, E) -> (T, E) f32 logits (Eq. 5)."""
    return x.float() @ wg.float()


def top_k(probs, k: int):
    """Top-k along the last axis with ``lax.top_k``'s tie rule (the lower
    index first): a stable descending sort. ``torch.topk`` promises no
    order among equal values on CUDA."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k].to(torch.int32)


def top_k_routing(logits, k: int, renorm: bool) -> Routing:
    probs = torch.softmax(logits, dim=-1)                     # (T, E) Eq. 6
    vals, idx = top_k(probs, k)                               # (T, K)
    denom = torch.sum(vals, dim=-1, keepdim=True)
    norm_score = vals / torch.clamp(denom, min=1e-20)         # §4.1 normalize
    combine = norm_score if renorm else vals
    return Routing(idx=idx, combine=combine, norm_score=norm_score,
                   probs=probs)


def route(x, wg, k: int, renorm: bool) -> Routing:
    return top_k_routing(gate_logits(x, wg), k, renorm)


def load_balance_aux_loss(probs, idx, n_experts: int):
    """Switch-style auxiliary load-balance loss for training runs: E times
    the dot of the mean router probabilities and the routed token share."""
    me = torch.mean(probs, dim=0)                              # (E,)
    ce = expert_histogram(idx, n_experts).to(probs.dtype) / idx.shape[0]
    return n_experts * torch.sum(me * ce)


def expert_histogram(idx, n_experts: int, keep=None):
    """Token count per expert; ``keep`` optionally masks dropped pairs."""
    from .dispatch import group_histogram
    return group_histogram(idx, n_experts, mask=keep)
