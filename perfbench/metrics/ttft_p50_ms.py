"""ttft_p50_ms (read as ``ttft_p50_ms.chat``): the median, over every
request due in the window, of due time -> first token; a request still
waiting at the close counts at its wait so far (host clock)."""
from perfbench.harness import stats


def read(run):
    v = stats.percentile(stats.ttft_samples(run.served, run.main_s), 50)
    return None if v is None else 1e3 * v
