"""End-to-end statistics over a window's token log, on the host clock.

Every request due in the window counts; times run from its due time, not
from when it was submitted, so a stall delays the requests that fall due
during it. Percentiles are numpy's linear interpolation over all samples.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np


@dataclasses.dataclass
class Served:
    """One request as the window saw it (seconds after the window
    opened)."""
    due_s: float
    prompt: np.ndarray
    n_out: int
    submitted_s: Optional[float] = None
    stamps: List[float] = dataclasses.field(default_factory=list)
    tokens: List[int] = dataclasses.field(default_factory=list)
    failed: bool = False
    uid: int = -1

    @property
    def n_prompt(self) -> int:
        return len(self.prompt)


def percentile(values, q: float) -> Optional[float]:
    vals = np.asarray(values, dtype=np.float64)
    if vals.size == 0:
        return None
    return float(np.percentile(vals, q))


def ttft_samples(reqs: List[Served], window_s: float) -> List[float]:
    """Due time -> first token for every request due in the window; one
    still waiting at the close counts at its wait so far."""
    out = []
    for r in reqs:
        if r.due_s >= window_s or r.failed:
            continue
        first = r.stamps[0] if r.stamps and r.stamps[0] <= window_s \
            else window_s
        out.append(first - r.due_s)
    return out


def itl_samples(reqs: List[Served], window_s: float) -> List[float]:
    """Every gap between consecutive output tokens of every request,
    both tokens emitted inside the window, pooled."""
    out = []
    for r in reqs:
        s = [t for t in r.stamps if t <= window_s]
        out.extend(np.diff(s).tolist())
    return out


def tokens_in_window(reqs: List[Served], window_s: float) -> int:
    return sum(1 for r in reqs for t in r.stamps if t <= window_s)


def lateness(reqs: List[Served]) -> List[float]:
    """How late the open-loop clock submitted each request."""
    return [r.submitted_s - r.due_s for r in reqs
            if r.submitted_s is not None]
