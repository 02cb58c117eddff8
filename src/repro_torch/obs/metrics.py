"""On-device MoE metrics (the sensor half of ``repro_torch.obs``).

``MetricsState`` holds int32 tensors on the model's device and rides in
the decode cache:

* ``expert_load`` — (n_layers, n_sub) histogram of KEPT token/sub-expert
  pairs per sub-expert per layer (routing-time counts, pre-capacity);
* ``kept_full`` / ``kept_major`` — kept sub-pairs by the 2T-Drop mode of
  their original pair (P == 1: every kept pair counts as FULL);
* ``dropped_pairs`` — sub-pairs dropped by the sparsity policy;
* ``overflow_pairs`` — KEPT pairs discarded by dispatch-capacity overflow.

Every update is a device-side add: nothing reads a value back to the host
until ``snapshot()``, which engines call only at step boundaries.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device

STAT_KEYS = ("expert_load", "kept_full", "kept_major", "dropped_pairs",
             "overflow_pairs")


@dataclasses.dataclass(frozen=True)
class MetricsState:
    """Device-resident MoE metrics accumulator (all int32 tensors)."""
    expert_load: torch.Tensor       # (n_layers, n_sub)
    kept_full: torch.Tensor         # ()
    kept_major: torch.Tensor        # ()
    dropped_pairs: torch.Tensor     # ()
    overflow_pairs: torch.Tensor    # ()

    @classmethod
    def zeros(cls, n_layers: int, n_sub: int,
              device="cuda") -> "MetricsState":
        """A zeroed accumulator on ``device`` (default the card)."""
        device = resolve_device(device)
        z = torch.zeros((4,), dtype=torch.int32, device=device)
        return cls(expert_load=torch.zeros((n_layers, n_sub),
                                           dtype=torch.int32, device=device),
                   kept_full=z[0].clone(), kept_major=z[1].clone(),
                   dropped_pairs=z[2].clone(), overflow_pairs=z[3].clone())

    @classmethod
    def from_stacked(cls, stats: List[Dict[str, torch.Tensor]]
                     ) -> "MetricsState":
        """From the per-layer stats dicts of one forward (layer order):
        expert_load stacks to (n_layers, n_sub); scalar counters sum."""
        def total(k):
            return torch.stack([s[k] for s in stats]).sum(dtype=torch.int32)
        return cls(
            expert_load=torch.stack([s["expert_load"] for s in stats]
                                    ).to(torch.int32),
            kept_full=total("kept_full"), kept_major=total("kept_major"),
            dropped_pairs=total("dropped_pairs"),
            overflow_pairs=total("overflow_pairs"))

    def __add__(self, other: "MetricsState") -> "MetricsState":
        return MetricsState(*(getattr(self, k) + getattr(other, k)
                              for k in STAT_KEYS))

    def accumulate(self, stats: List[Dict[str, torch.Tensor]]
                   ) -> "MetricsState":
        """Fold one step's per-layer stats into the total."""
        return self + MetricsState.from_stacked(stats)

    def snapshot(self) -> Dict[str, np.ndarray]:
        """Values on the host (the only device -> host transfer)."""
        return {k: getattr(self, k).cpu().numpy() for k in STAT_KEYS}

    @property
    def total_pairs(self) -> torch.Tensor:
        return self.kept_full + self.kept_major + self.dropped_pairs


def metrics_spec(cfg, model) -> Optional[Tuple[int, int]]:
    """(n_layers, n_sub_experts) of a model's MoE stack — the shape of the
    engine-wide ``MetricsState`` its steps add into (prepared weights
    count their sub-experts; an S-ETP rank's shard counts every rank's) —
    or None for a model without MoE layers."""
    if not cfg.is_moe:
        return None
    moes = [b.moe for b in model.blocks if b.moe is not None]
    if not moes:
        return None
    return len(moes), int(moes[0].w1.shape[0]) * moes[0].ep_shards
