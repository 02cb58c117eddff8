"""Unified serving request API (paper §4).

Every engine speaks the same request lifecycle (the port has the
synchronized-batch engine so far):

    uid = engine.submit(prompt, gen)     # enqueue (validated, never blocks)
    while engine.step(): ...             # advance one scheduler iteration
    results = engine.drain()             # run to completion, collect Results

``Request`` is the canonical unit of work (prompt tokens + per-request
``GenerationConfig`` + optional arrival time for replayed traces); ``Result``
is the canonical outcome. ``Engine`` is the structural protocol benchmarks
and launchers program against; ``EngineBase`` supplies the shared lifecycle
(uid allocation, result bookkeeping, ``run``/``drain``/``generate``/
``generate_timed``) so concrete engines only implement admission + ``step``.

The synchronized engine's ``step()`` serves one convoy batch to
completion. ``generate_timed`` drives an engine through two hooks:
``_has_work()`` (anything queued or in flight) and ``_ready()`` (worth
stepping now, e.g. the synchronized engine waits for a full convoy until
the trace is exhausted).
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import (Deque, Dict, List, Optional, Protocol, Sequence, Tuple,
                    runtime_checkable)

import numpy as np

from ..core.policy import SparsityPolicy
from ..obs import MetricsSnapshot, SpanTracer, tracing


@dataclasses.dataclass
class GenerationConfig:
    max_new_tokens: int = 32
    temperature: float = 0.0          # 0 => greedy
    eos_token: int = -1               # -1 => never stop early
    seed: int = 0
    # per-request sparsity-policy override. Engines require the SAME policy
    # family as their base policy — only threshold *values* may differ.
    policy: Optional[SparsityPolicy] = None


@dataclasses.dataclass
class Request:
    """One unit of serving work: prompt tokens, generation settings, and an
    optional arrival time (seconds on the engine clock) for trace replay."""
    prompt: np.ndarray
    gen: GenerationConfig = dataclasses.field(default_factory=GenerationConfig)
    arrival: float = 0.0


@dataclasses.dataclass
class Result:
    uid: int
    tokens: List[int]
    prefill_s: float = 0.0
    decode_s: float = 0.0
    submitted_s: float = 0.0          # arrival time (engine clock)
    finished_s: float = 0.0           # completion time (engine clock)
    first_token_s: Optional[float] = None   # first token emission time

    @property
    def latency_s(self) -> float:
        return self.finished_s - self.submitted_s

    @property
    def ttft_s(self) -> Optional[float]:
        """Time to first token (None until one is emitted)."""
        if self.first_token_s is None:
            return None
        return self.first_token_s - self.submitted_s

    @property
    def tpot_s(self) -> Optional[float]:
        """Mean time per output token after the first (None with < 2)."""
        if self.first_token_s is None or len(self.tokens) < 2 \
                or not self.finished_s:
            return None
        return ((self.finished_s - self.first_token_s)
                / (len(self.tokens) - 1))


@runtime_checkable
class Engine(Protocol):
    """Structural protocol every serving engine implements."""

    def submit(self, prompt, gen: Optional[GenerationConfig] = None) -> int:
        """Enqueue one request; returns its uid."""
        ...

    def step(self) -> bool:
        """Advance the scheduler one iteration; True while work may remain."""
        ...

    def drain(self) -> List[Result]:
        """Run until idle; return Results not yet drained, submission order."""
        ...

    def result(self, uid: int) -> Result:
        ...


class EngineBase:
    """Shared request lifecycle for serving engines.

    Subclass contract:
      * ``_validate(req)`` — raise on inadmissible requests (called by
        ``submit`` before the uid is allocated).
      * ``_step()`` — pop work from ``self._queue`` (deque of
        ``(uid, Request)``), advance it, record tokens into
        ``self._results[uid]`` (via ``_record_token``); return True while
        work may remain. The public ``step()`` wraps it with span tracing
        and compile-vs-steady wall-clock accounting.
      * ``_has_work()`` — anything queued or in flight (default: queue only).
      * ``_ready()`` — worth calling ``step()`` right now (default:
        ``_has_work()``); engines that batch by convoy return False until
        the convoy fills or ``self._flush`` is set.
      * ``_warm(kind)`` — call before each prefill/decode/chunk call:
        the first call of each kind is warm-up (kernel build and load,
        allocator growth), and ``step()`` counts a step that made one as
        warm-up time rather than steady state.
      * ``_device_metrics()`` — the engine's device-resident MetricsState
        (or None); ``_metrics_hook(snap)`` — add engine-specific series.
    """

    def __init__(self, *, metrics: bool = True):
        self._queue: Deque[Tuple[int, Request]] = collections.deque()
        self._results: Dict[int, Result] = {}
        self._undrained: List[int] = []
        self._next_uid = 0
        self._clock_origin: Optional[float] = None
        self._flush = False
        self.metrics_enabled = metrics
        self.tracer = SpanTracer(enabled=metrics)
        # compile vs steady step timing (see generate_timed / step())
        self._compile_s = 0.0
        self._steady_s = 0.0
        self._compile_steps = 0
        self._steady_steps = 0
        self._warmed: set = set()      # step kinds called at least once

    # -- clock ----------------------------------------------------------

    def _now(self) -> float:
        if self._clock_origin is None:
            return 0.0
        return time.perf_counter() - self._clock_origin

    # -- hooks ----------------------------------------------------------

    def _validate(self, req: Request) -> None:
        pass

    def _has_work(self) -> bool:
        return bool(self._queue)

    def _ready(self) -> bool:
        return self._has_work()

    def _step(self) -> bool:
        raise NotImplementedError

    def _warm(self, kind: str) -> None:
        self._warmed.add(kind)

    def _device_metrics(self):
        return None

    def _metrics_hook(self, snap: MetricsSnapshot) -> None:
        pass

    def _record_token(self, uid: int, token: int) -> None:
        """Append one generated token, stamping first-token time (TTFT)."""
        res = self._results[uid]
        if not res.tokens:
            res.first_token_s = self._now()
        res.tokens.append(token)

    def step(self) -> bool:
        """Advance the scheduler one iteration (traced + timed). The
        engine's tracer is the current one inside (``obs.tracing.layer``
        spans of the scheduler, model and MoE code land in it). A step
        that made a warm-up call counts as compile time; all others
        accumulate into the steady-state step time."""
        n0 = len(self._warmed)
        t0 = time.perf_counter()
        self.tracer.resolve()
        with tracing.active(self.tracer), \
                self.tracer.span("step", engine=type(self).__name__):
            out = self._step()
        dt = time.perf_counter() - t0
        if len(self._warmed) > n0:
            self._compile_s += dt
            self._compile_steps += 1
        else:
            self._steady_s += dt
            self._steady_steps += 1
        return out

    @property
    def timing(self) -> Dict[str, float]:
        """Wall-clock accounting over every ``step()`` so far:
        ``compile_s`` (steps that made a warm-up call), ``steady_s`` total /
        ``steady_step_s`` mean for the remaining steady-state steps."""
        return {
            "compile_s": self._compile_s,
            "compile_steps": float(self._compile_steps),
            "steady_s": self._steady_s,
            "steady_steps": float(self._steady_steps),
            "steady_step_s": (self._steady_s / self._steady_steps
                              if self._steady_steps else 0.0),
        }

    # -- metrics snapshot (host sync happens HERE, at a step boundary) ---

    def metrics(self) -> MetricsSnapshot:
        """One point-in-time snapshot of engine metrics: device-resident
        MoE counters (drained here — the only host transfer), queue/timing
        gauges, and per-request TTFT/TPOT/latency histograms."""
        snap = MetricsSnapshot()
        dm = self._device_metrics()
        if dm is not None:
            s = dm.snapshot()
            for outcome in ("kept_full", "kept_major"):
                snap.counter("repro_moe_subpairs_total", int(s[outcome]),
                             outcome=outcome)
            snap.counter("repro_moe_subpairs_total",
                         int(s["dropped_pairs"]), outcome="dropped")
            snap.counter("repro_moe_subpairs_total",
                         int(s["overflow_pairs"]), outcome="overflow")
            el = s["expert_load"]
            for layer in range(el.shape[0]):
                for expert in range(el.shape[1]):
                    snap.counter("repro_moe_expert_load_total",
                                 int(el[layer, expert]),
                                 layer=layer, expert=expert)
        snap.gauge("repro_queue_depth", len(self._queue))
        t = self.timing
        snap.gauge("repro_engine_compile_s", t["compile_s"])
        snap.gauge("repro_engine_steady_step_s", t["steady_step_s"])
        finished = [r for r in self._results.values() if r.finished_s]
        snap.counter("repro_requests_total", len(self._results),
                     state="submitted")
        snap.counter("repro_requests_total", len(finished), state="finished")
        h_lat = snap.histogram("repro_request_latency_seconds")
        h_ttft = snap.histogram("repro_request_ttft_seconds")
        h_tpot = snap.histogram("repro_request_tpot_seconds")
        for r in finished:
            h_lat.observe(r.latency_s)
            if r.ttft_s is not None:
                h_ttft.observe(r.ttft_s)
            if r.tpot_s is not None:
                h_tpot.observe(r.tpot_s)
        self._metrics_hook(snap)
        return snap

    # -- request lifecycle ----------------------------------------------

    def submit(self, prompt, gen: Optional[GenerationConfig] = None) -> int:
        """Enqueue one request (a prompt array or a ``Request``); returns its
        uid. Admission into compute happens inside ``step()``."""
        if isinstance(prompt, Request):
            if gen is not None:
                raise ValueError("pass gen inside the Request")
            req = prompt
        else:
            req = Request(prompt=prompt,
                          gen=gen if gen is not None else GenerationConfig())
        req = dataclasses.replace(req,
                                  prompt=np.asarray(req.prompt, np.int32))
        self._validate(req)
        if self._clock_origin is None:
            # start the engine clock at the first submission so TTFT /
            # latency are meaningful outside generate_timed too
            self._clock_origin = time.perf_counter()
        uid = self._next_uid
        self._next_uid += 1
        self._queue.append((uid, req))
        self._undrained.append(uid)
        self._results[uid] = Result(
            uid=uid, tokens=[],
            submitted_s=req.arrival if req.arrival else self._now())
        self.tracer.instant("submit", uid=uid,
                            prompt_len=int(len(req.prompt)))
        return uid

    def run(self) -> None:
        """Drive the scheduler until queue and in-flight work are empty."""
        self._flush = True
        try:
            while self._has_work():
                self.step()
        finally:
            self._flush = False

    def drain(self) -> List[Result]:
        """Run to completion and return every Result not yet returned by a
        previous ``drain``/``generate``, in submission order."""
        self.run()
        out = [self._results[u] for u in self._undrained]
        self._undrained = []
        return out

    def result(self, uid: int) -> Result:
        return self._results[uid]

    # -- high-level entry points (wrappers over submit/step/drain) -------

    def generate(self, prompts: Sequence[np.ndarray],
                 gen: GenerationConfig) -> List[Result]:
        """Offline batch entry point: submit every prompt, drain, return
        Results in submission order."""
        uids = [self.submit(p, gen) for p in prompts]
        self.drain()
        return [self._results[u] for u in uids]

    def generate_timed(self, arrivals: Sequence[Tuple[float, np.ndarray,
                                                      GenerationConfig]]
                       ) -> List[Result]:
        """Online entry point: ``arrivals`` is a list of
        (arrival_time_s, prompt, gen). Requests are submitted when the wall
        clock passes their arrival time (Poisson traffic etc.); Results carry
        submitted_s/finished_s for latency accounting."""
        order = sorted(range(len(arrivals)), key=lambda i: arrivals[i][0])
        pending = collections.deque(order)
        self._clock_origin = time.perf_counter()
        uids: Dict[int, int] = {}
        try:
            while pending or self._has_work():
                now = self._now()
                while pending and arrivals[pending[0]][0] <= now:
                    i = pending.popleft()
                    t, prompt, gen = arrivals[i]
                    uid = self.submit(Request(prompt=prompt, gen=gen,
                                              arrival=t))
                    self._results[uid].submitted_s = t
                    uids[i] = uid
                self._flush = not pending
                if not self._ready():
                    if pending:
                        time.sleep(min(0.01, max(
                            0.0, arrivals[pending[0]][0] - self._now())))
                    continue
                self.step()
        finally:
            self._flush = False
            self._clock_origin = None
        self._undrained = [u for u in self._undrained
                           if u not in set(uids.values())]
        return [self._results[uids[i]] for i in range(len(arrivals))]
