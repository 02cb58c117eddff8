"""itl_p95_ms (and ``itl_p95_ms.saturated``, the same above the knee): 95th
percentile of every gap between consecutive output tokens of every
request, both tokens inside the window, pooled (host clock; tokens
stamped when the engine's step returns them)."""
from perfbench.harness import stats


def read(run):
    v = stats.percentile(stats.itl_samples(run.served, run.main_s), 95)
    return None if v is None else 1e3 * v
