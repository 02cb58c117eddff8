"""The open-loop clock: submits each request when it falls due, steps the
engine while it has work, and stamps every token when ``step()`` returns
it. Nothing here knows the engine's insides beyond ``submit``, ``step``,
``result``, ``queued``, ``free_slots`` and ``n_slots``."""
from __future__ import annotations

import time
from collections import deque
from typing import Callable, List, Optional

from .stats import Served
from .traffic import Request


class Hooks:
    """Called by the loop between steps (window-relative seconds)."""

    def between_steps(self, now_s: float) -> None:
        pass

    def step(self, engine) -> None:
        engine.step()

    def wait(self, seconds: float) -> None:
        time.sleep(seconds)


def busy(engine) -> bool:
    return engine.queued > 0 or engine.free_slots < engine.n_slots


def drive(engine, requests: List[Request], seconds: float,
          make_gen: Callable[[Request], object],
          hooks: Optional[Hooks] = None,
          clock: Callable[[], float] = time.perf_counter) -> List[Served]:
    """Run the window; returns one ``Served`` per request, due order.
    Requests due after the close are never submitted; a step that starts
    before the close runs to its end, and what it emits after the close
    falls outside the window."""
    hooks = hooks or Hooks()
    served = [Served(due_s=r.due_s, prompt=r.prompt, n_out=r.n_out)
              for r in requests]
    pending = deque(range(len(requests)))
    inflight: List[int] = []
    t0 = clock()
    while True:
        now = clock() - t0
        if now >= seconds:
            break
        hooks.between_steps(now)
        while pending and requests[pending[0]].due_s <= now:
            i = pending.popleft()
            s = served[i]
            s.submitted_s = clock() - t0
            try:
                s.uid = engine.submit(requests[i].prompt,
                                      make_gen(requests[i]))
            except (ValueError, RuntimeError):
                s.failed = True
                continue
            inflight.append(i)
        if not busy(engine):
            if pending:
                hooks.wait(max(0.0, min(requests[pending[0]].due_s,
                                        seconds) - (clock() - t0)))
                continue
            hooks.wait(max(0.0, seconds - (clock() - t0)))
            continue
        hooks.step(engine)
        stamp = clock() - t0
        still = []
        for i in inflight:
            s = served[i]
            toks = engine.result(s.uid).tokens
            new = toks[len(s.tokens):]
            s.tokens.extend(int(t) for t in new)
            s.stamps.extend([stamp] * len(new))
            if len(s.tokens) < s.n_out:
                still.append(i)
        inflight = still
    return served
