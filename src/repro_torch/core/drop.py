"""Token-expert computation dropping (paper §4.1-§4.2).

1T-Drop: drop pairs whose normalized gating score is not above T¹.
2T-Drop: with each original expert partitioned+reconstructed into a MAJOR
and MINOR sub-expert (partial transformation, P=2):

    score <= T²_major                -> drop both halves      (mode 0)
    T²_major < score <= T²_minor     -> compute major only    (mode 1)
    score >  T²_minor                -> compute both halves   (mode 2)

Both comparisons are strict ``>`` keeps, so T²_major == T²_minor == T¹
degenerates 2T-Drop to 1T-Drop exactly. Thresholds may be Python floats or
tensors: scalar, per-token (T,) or per-pair (T, K).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

MODE_DROP, MODE_MAJOR, MODE_FULL = 0, 1, 2


def _threshold(t, ref: torch.Tensor) -> torch.Tensor:
    """A threshold as a float32 tensor on ``ref``'s device."""
    return torch.as_tensor(t, dtype=torch.float32, device=ref.device)


def one_t_keep(norm_score, t_drop):
    """(T,K) bool keep mask. The paper retains scores *exceeding* T¹."""
    t = _threshold(t_drop, norm_score)
    if t.ndim >= 1:
        t = t[..., None]
    return norm_score > t


def two_t_modes(norm_score, t_major, t_minor):
    """(T,K) int32 modes per original token-expert pair."""
    t_major = _threshold(t_major, norm_score)
    t_minor = _threshold(t_minor, norm_score)
    if t_major.ndim == 1:
        t_major = t_major[:, None]
        t_minor = t_minor[:, None]
    full = norm_score > t_minor
    major = norm_score > t_major
    return torch.where(full, MODE_FULL,
                       torch.where(major, MODE_MAJOR, MODE_DROP)
                       ).to(torch.int32)


class SubExpertPairs(NamedTuple):
    """Token/sub-expert pair list after partial transformation (Eq. 12)."""
    idx: torch.Tensor        # (T, K*P) sub-expert ids
    combine: torch.Tensor    # (T, K*P) combine weights (repeated, Eq. 13)
    keep: torch.Tensor       # (T, K*P) bool — pair survives the drop
    modes: torch.Tensor      # (T, K) original-expert modes (diagnostics)


def _expand_idx_combine(idx, combine, p: int):
    T, K = idx.shape
    sub = torch.arange(p, dtype=idx.dtype, device=idx.device)
    new_idx = (idx[:, :, None] * p + sub[None, None, :]).reshape(T, K * p)
    new_combine = combine[:, :, None].expand(T, K, p).reshape(T, K * p)
    return new_idx, new_combine


def expand_pairs_2t(idx, combine, norm_score, p: int,
                    t_major, t_minor) -> SubExpertPairs:
    """Partial transformation of the routing (Eq. 12) + 2T keep mask.
    Sub-expert j of original expert e has id e*P + j; sub-expert 0 holds the
    MAJOR neurons, 1..P-1 the minor ones (minor halves share T²_minor)."""
    T, K = idx.shape
    modes = two_t_modes(norm_score, t_major, t_minor)          # (T,K)
    new_idx, new_combine = _expand_idx_combine(idx, combine, p)
    keep_major = modes >= MODE_MAJOR
    keep_minor = modes >= MODE_FULL
    sub0 = torch.zeros(p, dtype=torch.bool, device=idx.device)
    sub0[0] = True
    keep = torch.where(sub0[None, None, :], keep_major[:, :, None],
                       keep_minor[:, :, None])
    return SubExpertPairs(idx=new_idx, combine=new_combine,
                          keep=keep.reshape(T, K * p), modes=modes)


def expand_pairs_1t(idx, combine, norm_score, p: int,
                    t_drop) -> SubExpertPairs:
    """Partial transformation + 1T drop (all-or-nothing per original expert)."""
    T, K = idx.shape
    keep1 = one_t_keep(norm_score, t_drop)                     # (T,K)
    new_idx, new_combine = _expand_idx_combine(idx, combine, p)
    keep = keep1[:, :, None].expand(T, K, p).reshape(T, K * p)
    modes = torch.where(keep1, MODE_FULL, MODE_DROP).to(torch.int32)
    return SubExpertPairs(new_idx, new_combine, keep, modes)


def _f32_mean(total, n: int) -> torch.Tensor:
    """``total / n`` as the JAX package's ``jnp.mean`` computes it on the
    CPU: the float32 sum times the float32 reciprocal of the count (XLA
    folds the division by a constant into that product). ``total`` is an
    exact float32 tensor (a count, or a count of halves), so the result is
    the same bits on every device."""
    return total * torch.tensor(np.float32(1.0) / np.float32(n),
                                device=total.device)


def drop_rate(pairs: SubExpertPairs) -> torch.Tensor:
    """Fraction of token-(sub-)expert computations dropped (the paper's
    metric): 1 - mean(keep), a float32 scalar."""
    keep = pairs.keep
    kept = keep.sum(dtype=torch.int64).to(torch.float32)
    return 1.0 - _f32_mean(kept, keep.numel())


def sub_pair_outcome_counts(keep, p: int):
    """(kept_full, kept_major, dropped) int32 scalars in sub-pair units from
    a (T, K*P) keep mask (P-major layout, sub 0 = MAJOR half). A pair ran
    FULL when any minor half survived; with P == 1 every kept pair is FULL."""
    T, Kp = keep.shape
    kp = keep.reshape(T, Kp // p, p)
    full = kp[..., 1:].any(-1) if p > 1 else kp[..., 0]
    per_pair = kp.sum(-1, dtype=torch.int32)
    zero = torch.zeros((), dtype=torch.int32, device=keep.device)
    kept_full = torch.where(full, per_pair, zero).sum(dtype=torch.int32)
    kept_major = torch.where(full, zero, per_pair).sum(dtype=torch.int32)
    dropped = (T * Kp) - kept_full - kept_major
    return kept_full, kept_major, dropped.to(torch.int32)


def flops_saved_fraction(modes) -> torch.Tensor:
    """Fraction of expert FLOPs skipped, a float32 scalar: mode 0 saves 1,
    mode 1 saves 1/2, mode 2 nothing (the mean over original pairs)."""
    halves = (2 * (modes == MODE_DROP).sum(dtype=torch.int64)
              + (modes == MODE_MAJOR).sum(dtype=torch.int64))
    return _f32_mean(halves.to(torch.float32) * 0.5, modes.numel())


def threshold_to_drop_rate(norm_scores, thresholds) -> torch.Tensor:
    """Empirical threshold -> drop-rate map (paper Fig. 12) from
    calibration scores (N, K): for each of the (M,) thresholds the share of
    scores ``<= t``, as (M,) float32. One sort and a right-sided search,
    so no (M, N) mask is formed."""
    flat = torch.sort(norm_scores.reshape(-1).float()).values
    t = torch.as_tensor(thresholds, dtype=torch.float32, device=flat.device)
    n_le = torch.searchsorted(flat, t.reshape(-1), right=True)
    return _f32_mean(n_le.to(torch.float32), flat.numel()).reshape(t.shape)


def calibrate_threshold(norm_scores, target_drop_rate: float):
    """The T¹ achieving a target drop rate on calibration scores (the
    threshold -> drop-rate mapping of §5.3.3). Returns a float32 scalar."""
    flat = torch.sort(norm_scores.reshape(-1).float()).values
    n = flat.shape[0]
    frac = torch.tensor(target_drop_rate, dtype=torch.float32)
    idx = int(torch.clamp(torch.floor(frac * n).to(torch.int32), 0, n - 1))
    return flat[idx]


def calibrate_per_layer_thresholds(layer_norm_scores, target_drop_rate: float,
                                   gap: float = 0.01) -> torch.Tensor:
    """Per-layer (T²_major, T²_minor) = (max(t - gap, 0), t + gap) around
    each layer's ``calibrate_threshold`` at the target, so every layer
    drops at the target rate (the paper's §5.3.3 future work; not the
    ``per_layer`` policy's ``delta`` band). ``layer_norm_scores``: one
    (N, K) score tensor per layer. Returns (L, 2) float32."""
    ts = torch.stack([calibrate_threshold(s, target_drop_rate)
                      for s in layer_norm_scores])
    gap = torch.tensor(gap, dtype=torch.float32, device=ts.device)
    return torch.stack([torch.clamp(ts - gap, min=0.0), ts + gap], dim=1)
