"""Host-side engine span tracing.

``SpanTracer`` records wall-clock spans (submit/prefill_chunk/decode/
retire and friends) as the engines run: a bounded in-memory event buffer
with ``time.perf_counter`` timestamps, exportable as Chrome-trace
(Perfetto / chrome://tracing) JSON. It is pure host bookkeeping — it
never touches device arrays, so it adds no syncs to the jitted hot path.

Spans nest naturally: an ``engine.step`` span opened by ``EngineBase``
contains the ``decode`` / ``prefill_chunk`` spans the engine opens
inside it, and the viewer reconstructs the hierarchy from timestamps.
"""
from __future__ import annotations

import json
import threading
import time
from contextlib import contextmanager
from typing import Any, Dict, List, Optional


class SpanTracer:
    """Bounded recorder of wall-clock spans and instant events.

    Disabled tracers ( ``enabled=False`` ) keep every call a cheap no-op
    so engines can invoke hooks unconditionally.
    """

    def __init__(self, *, enabled: bool = True, max_events: int = 100_000):
        self.enabled = enabled
        self.max_events = int(max_events)
        self._events: List[Dict[str, Any]] = []
        self._origin = time.perf_counter()
        self._lock = threading.Lock()
        self._dropped = 0

    # -- recording -------------------------------------------------------

    def _push(self, ev: Dict[str, Any]) -> None:
        with self._lock:
            if len(self._events) >= self.max_events:
                self._dropped += 1
                return
            self._events.append(ev)

    @contextmanager
    def span(self, name: str, **args: Any):
        """Record a complete-duration ("X") event around the body."""
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            t1 = time.perf_counter()
            self._push({"name": name, "ph": "X",
                        "ts": (t0 - self._origin) * 1e6,
                        "dur": (t1 - t0) * 1e6, "args": args})

    def instant(self, name: str, **args: Any) -> None:
        """Record a zero-duration ("i") marker event."""
        if not self.enabled:
            return
        self._push({"name": name, "ph": "i",
                    "ts": (time.perf_counter() - self._origin) * 1e6,
                    "s": "t", "args": args})

    # -- queries ---------------------------------------------------------

    def events(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._events)

    def durations(self, name: str) -> List[float]:
        """Seconds spent in every completed span with this name."""
        return [ev["dur"] / 1e6 for ev in self.events()
                if ev["ph"] == "X" and ev["name"] == name]

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self._dropped = 0
            self._origin = time.perf_counter()

    # -- export ----------------------------------------------------------

    def chrome_trace(self, *, pid: int = 1, tid: int = 1) -> Dict[str, Any]:
        """Chrome-trace JSON object (``traceEvents`` array format)."""
        out = []
        for ev in self.events():
            ce = dict(ev)
            ce.setdefault("pid", pid)
            ce.setdefault("tid", tid)
            ce.setdefault("cat", "engine")
            out.append(ce)
        return {"traceEvents": out, "displayTimeUnit": "ms",
                "otherData": {"dropped_events": self._dropped}}

    def write_chrome_trace(self, path: str, **kw: Any) -> None:
        with open(path, "w") as f:
            json.dump(self.chrome_trace(**kw), f)


_NULL: Optional[SpanTracer] = None


def null_tracer() -> SpanTracer:
    """Shared disabled tracer (every method is a no-op)."""
    global _NULL
    if _NULL is None:
        _NULL = SpanTracer(enabled=False, max_events=0)
    return _NULL
