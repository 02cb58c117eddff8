"""Reading a ``torch.profiler`` trace of a steady sub-window: device busy
time as the union of the intervals in which a kernel, copy or fill ran
(not the sum of their durations), device time per kernel name, and the
idle gaps between device work, each named by the innermost host range
(an aten op, or the harness's own ``record_function`` range) that was
open at the gap's middle."""
from __future__ import annotations

import dataclasses
import json
import re
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import numpy as np

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")
NAME_CHARS = 96


@dataclasses.dataclass
class TraceSummary:
    busy_s: float
    span_s: float                         # first to last device/host event
    kernel_s: Dict[str, float]            # device seconds per name
    idle_s: Dict[str, float]              # idle seconds per host range

    def device_time(self, pattern: str) -> float:
        """Device seconds of every kernel whose name matches ``pattern``."""
        rx = re.compile(pattern)
        return sum(s for name, s in self.kernel_s.items() if rx.search(name))

    def breakdown(self, n: int = 10) -> Dict[str, List]:
        def top(d):
            return [[k[:NAME_CHARS], v] for k, v in
                    sorted(d.items(), key=lambda kv: -kv[1])[:n]]
        return {"device_ops": top(self.kernel_s),
                "idle_gaps": top(self.idle_s)}


def union_intervals(iv: np.ndarray) -> np.ndarray:
    """Merged, sorted (n, 2) intervals."""
    if len(iv) == 0:
        return iv.reshape(0, 2)
    iv = iv[np.argsort(iv[:, 0], kind="stable")]
    out = [list(iv[0])]
    for a, b in iv[1:]:
        if a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return np.asarray(out)


def summarize_events(events: List[Dict]) -> Optional[TraceSummary]:
    """The summary of chrome-trace events (microsecond ``ts`` / ``dur``);
    None when no device work was recorded."""
    dev: List[Tuple[float, float, str]] = []
    host: List[Tuple[float, float, str]] = []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat = e.get("cat", "")
        t0, t1 = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        if cat in DEVICE_CATS:
            dev.append((t0, t1, e.get("name", "?")))
        elif cat in HOST_CATS:
            host.append((t0, t1, e.get("name", "?")))
    if not dev:
        return None
    kernel_s: Dict[str, float] = defaultdict(float)
    for t0, t1, name in dev:
        kernel_s[name] += (t1 - t0) / 1e6
    merged = union_intervals(np.asarray([(a, b) for a, b, _ in dev]))
    busy = float((merged[:, 1] - merged[:, 0]).sum()) / 1e6
    lo = min([merged[0, 0]] + [a for a, _, _ in host])
    hi = max([merged[-1, 1]] + [b for _, b, _ in host])
    starts = np.concatenate([[lo], merged[:, 1]])
    ends = np.concatenate([merged[:, 0], [hi]])
    keep = ends > starts
    starts, ends = starts[keep], ends[keep]
    mids = (starts + ends) / 2
    label = np.full(len(mids), "host: no range open", dtype=object)
    for t0, t1, name in sorted(host, key=lambda h: h[0]):
        a, b = np.searchsorted(mids, [t0, t1])
        label[a:b] = name          # later-starting (inner) ranges win
    idle: Dict[str, float] = defaultdict(float)
    for name, s, e in zip(label, starts, ends):
        idle[name] += (e - s) / 1e6
    return TraceSummary(busy_s=busy, span_s=(hi - lo) / 1e6,
                        kernel_s=dict(kernel_s), idle_s=dict(idle))


def summarize_file(path) -> Optional[TraceSummary]:
    with open(path) as f:
        data = json.load(f)
    events = data["traceEvents"] if isinstance(data, dict) else data
    return summarize_events(events)
