"""Rates and tails are taken over the whole window: a stall injected into
a synthetic token log moves them."""
import sys
from pathlib import Path

import numpy as np
import pytest

sys.path[:0] = [str(Path(__file__).resolve().parents[2])]

from perfbench.harness import stats  # noqa: E402


def _log(stall=None, n_req=38, window=20.0):
    """Requests due every 0.5 s, first token 0.1 s after due, then a token
    every 0.05 s. ``stall`` = (a, b): the engine runs 4x slower from a to
    b, so every stamp after a moves later by 3 x the slow part before
    it."""
    def warp(t):
        if stall is None:
            return t
        a, b = stall
        return t + 3.0 * min(max(t - a, 0.0), b - a)
    out = []
    for i in range(n_req):
        due = 0.5 * i
        s = stats.Served(due_s=due, prompt=np.zeros(8, np.int32), n_out=20)
        s.submitted_s = due
        for j in range(20):
            t = warp(due + 0.1 + 0.05 * j)
            s.stamps.append(t)
            s.tokens.append(j)
        out.append(s)
    return out, window


def _read(served, window):
    ttft = stats.percentile(stats.ttft_samples(served, window), 95)
    itl = stats.percentile(stats.itl_samples(served, window), 95)
    rate = stats.tokens_in_window(served, window) / window
    return ttft, itl, rate


def test_steady_log_reads_its_own_numbers():
    ttft, itl, rate = _read(*_log())
    assert ttft == pytest.approx(0.1)
    assert itl == pytest.approx(0.05)
    assert rate == pytest.approx(38 * 20 / 20.0)


def test_stall_moves_every_metric():
    base = _read(*_log())
    stalled = _read(*_log(stall=(8.0, 12.0)))
    assert stalled[0] > base[0] + 0.1        # requests due in it wait longer
    assert stalled[1] == pytest.approx(0.2)  # a fifth of the gaps 4x longer
    assert stalled[2] < base[2]              # tokens pushed past the close


def test_waiting_request_counts_its_wait_so_far():
    served, window = _log()
    late = stats.Served(due_s=15.0, prompt=np.zeros(8, np.int32), n_out=4)
    late.submitted_s = 15.0
    served.append(late)
    assert max(stats.ttft_samples(served, window)) == pytest.approx(5.0)
    due_after = stats.Served(due_s=25.0, prompt=np.zeros(8, np.int32),
                             n_out=4)
    assert stats.ttft_samples([due_after], window) == []


def test_tokens_after_the_close_do_not_count():
    served, window = _log(n_req=60)
    inside = stats.tokens_in_window(served, window)
    assert inside < 60 * 20
    assert all(g <= 0.05 + 1e-12 for g in stats.itl_samples(served, window))
