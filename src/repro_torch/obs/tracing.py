"""Host-side span tracing of the engines and the layers they call.

``SpanTracer`` records spans on the host clock (``time.perf_counter_ns``)
in a bounded in-memory buffer, exportable as Chrome-trace (Perfetto /
chrome://tracing) JSON. Two kinds:

* engine spans (``step``, ``decode``, ``prefill_insert``,
  ``prefill_chunk``, the ``submit`` / ``retire`` instants), opened by the
  engines through ``tracer.span(name, **args)``;
* layer spans (``scheduler.*``, ``model.*``, ``moe`` and ``moe.*``),
  opened by the scheduler, model and MoE code through ``layer(name)`` on
  the *current* tracer: ``EngineBase.step`` makes its engine's tracer the
  current one for the length of the step. Outside a step (training,
  tests, kernel benchmarks) the current tracer is the disabled one and a
  layer span is a shared no-op. A layer span stores its name and two
  clock readings, nothing else.

While ``torch.profiler`` records, every span either kind opens is also a
``record_function`` range of the same name, so the span sits in the
device trace on the profiler's own clock; the guard is one flag read, so
an unprofiled step opens no range.

A span given ``device_clock`` (the prefill spans) also times the device
stream: a pair of CUDA events around it, left pending and resolved only
once the end event has completed (which the step's own read-back
guarantees), or when ``events()`` is called. Its ``device_s`` arg holds
the result; on the CPU, where ops run synchronously, the host time. No
span adds a synchronisation to a step.
"""
from __future__ import annotations

import contextlib
import contextvars
import json
import time
from typing import Any, Dict, List, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

_now_ns = time.perf_counter_ns


class _Noop:
    """The span of a disabled tracer: does nothing."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _Noop()


class _Layer:
    """A layer span: a name and two clock readings; a ``record_function``
    range as well while the profiler records."""
    __slots__ = ("_tracer", "_name", "_t0", "_range")

    def __init__(self, tracer: "SpanTracer", name: str):
        self._tracer = tracer
        self._name = name

    def __enter__(self):
        if _autograd_profiler._is_profiler_enabled:
            self._range = torch.profiler.record_function(self._name)
            self._range.__enter__()
        else:
            self._range = None
        self._t0 = _now_ns()
        return self

    def __exit__(self, *exc):
        t1 = _now_ns()
        if self._range is not None:
            self._range.__exit__(None, None, None)
        events = self._tracer._events
        if len(events) < self._tracer.max_events:
            events.append((self._name, self._t0, t1, None))
        else:
            self._tracer._dropped += 1
        return False


class _Span(_Layer):
    """An engine span: a layer span with args, and optionally a pair of
    CUDA events timing the device stream."""
    __slots__ = ("_args", "_device", "_start")

    def __init__(self, tracer, name, args, device):
        super().__init__(tracer, name)
        self._args = args
        self._device = device

    def __enter__(self):
        super().__enter__()
        self._start = None
        if self._device is not None and self._device.type == "cuda":
            self._start = torch.cuda.Event(enable_timing=True)
            self._start.record(torch.cuda.current_stream(self._device))
        return self

    def __exit__(self, *exc):
        t1 = _now_ns()
        if self._range is not None:
            self._range.__exit__(None, None, None)
        tr = self._tracer
        if self._start is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record(torch.cuda.current_stream(self._device))
            tr._pending.append((self._args, (self._start, end)))
        elif self._device is not None:       # the CPU: ops are synchronous
            self._args["device_s"] = (t1 - self._t0) / 1e9
        if len(tr._events) < tr.max_events:
            tr._events.append((self._name, self._t0, t1, self._args))
        else:
            tr._dropped += 1
        return False


class SpanTracer:
    """Bounded recorder of spans and instant events.

    A disabled tracer (``enabled=False``) records nothing and hands out a
    shared no-op span, so callers invoke it unconditionally. Events past
    ``max_events`` are dropped and counted (``dropped``)."""

    def __init__(self, *, enabled: bool = True, max_events: int = 500_000):
        self.enabled = enabled
        self.max_events = int(max_events)
        # (name, t0 ns, t1 ns or None for an instant, args or None);
        # list.append is atomic under the interpreter lock
        self._events: List[tuple] = []
        self._pending: List[tuple] = []      # (args, (start, end) events)
        self._origin = _now_ns()
        self._dropped = 0

    # -- recording -------------------------------------------------------

    def layer(self, name: str):
        """A layer span (no args) around the body."""
        return _Layer(self, name) if self.enabled else _NOOP

    def span(self, name: str, *, device_clock: Optional[torch.device] = None,
             **args: Any):
        """An engine span around the body, with ``args``; with
        ``device_clock`` also the device stream's time as ``device_s``."""
        if not self.enabled:
            return _NOOP
        return _Span(self, name, args, device_clock)

    def instant(self, name: str, **args: Any) -> None:
        """Record a zero-duration ("i") marker event."""
        if not self.enabled:
            return
        if len(self._events) < self.max_events:
            self._events.append((name, _now_ns(), None, args))
        else:
            self._dropped += 1

    def resolve(self, wait: bool = False) -> None:
        """Put ``device_s`` into each pending span whose end event has
        completed; with ``wait`` first wait for every one (never inside a
        step)."""
        still = []
        for args, (start, end) in self._pending:
            if wait:
                end.synchronize()
            if end.query():
                args["device_s"] = start.elapsed_time(end) / 1e3
            else:
                still.append((args, (start, end)))
        self._pending = still

    # -- queries ---------------------------------------------------------

    @property
    def dropped(self) -> int:
        return self._dropped

    def events(self) -> List[Dict[str, Any]]:
        """Every event as a Chrome-trace dict (``ts`` / ``dur`` in µs from
        the tracer's origin), device times resolved first."""
        self.resolve(wait=True)
        out = []
        for name, t0, t1, args in list(self._events):
            ts = (t0 - self._origin) / 1e3
            if t1 is None:
                out.append({"name": name, "ph": "i", "ts": ts, "s": "t",
                            "args": dict(args)})
            else:
                out.append({"name": name, "ph": "X", "ts": ts,
                            "dur": (t1 - t0) / 1e3,
                            "args": dict(args) if args else {}})
        return out

    def durations(self, name: str) -> List[float]:
        """Seconds spent in every completed span with this name."""
        return [(t1 - t0) / 1e9 for n, t0, t1, _ in list(self._events)
                if n == name and t1 is not None]

    def clear(self) -> None:
        self._events = []
        self._pending = []
        self._dropped = 0
        self._origin = _now_ns()

    # -- export ----------------------------------------------------------

    def chrome_trace(self, *, pid: int = 1, tid: int = 1) -> Dict[str, Any]:
        """Chrome-trace JSON object (``traceEvents`` array format)."""
        out = []
        for ev in self.events():
            ev.update(pid=pid, tid=tid, cat="engine")
            out.append(ev)
        return {"traceEvents": out, "displayTimeUnit": "ms",
                "otherData": {"dropped_events": self._dropped}}

    def write_chrome_trace(self, path: str, **kw: Any) -> None:
        with open(path, "w") as f:
            json.dump(self.chrome_trace(**kw), f)


_NULL = SpanTracer(enabled=False, max_events=0)


def null_tracer() -> SpanTracer:
    """Shared disabled tracer (every method is a no-op)."""
    return _NULL


_CURRENT: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_current_tracer", default=_NULL)


@contextlib.contextmanager
def active(tracer: SpanTracer):
    """Make ``tracer`` the current one for the body."""
    token = _CURRENT.set(tracer)
    try:
        yield tracer
    finally:
        _CURRENT.reset(token)


def layer(name: str):
    """A layer span on the current tracer: ``with layer("moe.route"):``."""
    return _CURRENT.get().layer(name)
