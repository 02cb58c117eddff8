"""Load-aware thresholding in Expert Parallelism (paper §4.3).

The MoE step waits for the most-loaded EP device, so one uniform drop
threshold spends accuracy on lightly-loaded devices for nothing. The
paper's step-down rule: each device's load ratio r_d = actual / ideal;
devices with r_d >= 1 use the maximum threshold T_max, devices with
r_d < 1 lower it in proportion to r_d.

Experts map to devices in contiguous blocks of ``experts_per_device``.
Every reduction is float32, as in the JAX package.
"""
from __future__ import annotations

import torch


def device_loads(hist, experts_per_device: int):
    """hist: (E,) token counts per expert -> (D,) float32 loads per device
    (contiguous expert blocks)."""
    E = hist.shape[0]
    D = E // experts_per_device
    return hist.reshape(D, experts_per_device).float().sum(dim=1)


def step_down_thresholds(loads, t_max):
    """Paper §4.3 rule. loads: (D,) -> per-device float32 thresholds (D,)."""
    t_max = torch.as_tensor(t_max, dtype=torch.float32, device=loads.device)
    loads = loads.float()
    ratio = loads / torch.clamp(loads.mean(), min=1e-9)
    return torch.where(ratio >= 1.0, t_max, t_max * ratio)


def pair_thresholds(idx, loads, experts_per_device: int, t_max,
                    t_gap: float = 0.01):
    """Per-(token, expert) 2T thresholds from the target device's load.
    idx: (T, K) ORIGINAL expert ids -> (t_major, t_minor), each (T, K): the
    device's stepped-down T¹ split ±``t_gap``."""
    t_dev = step_down_thresholds(loads, t_max)                   # (D,)
    t1 = t_dev[idx.long() // experts_per_device]                 # (T, K)
    return torch.clamp(t1 - t_gap, min=0.0), t1 + t_gap


def makespan(loads):
    """EP step-time proxy: the largest device load."""
    return loads.max()


def post_drop_loads(hist_kept, experts_per_device: int):
    return device_loads(hist_kept, experts_per_device)
