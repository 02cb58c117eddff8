"""output_tok_s: output tokens emitted inside the window over its
length (host clock)."""
from perfbench.harness import stats


def read(run):
    return stats.tokens_in_window(run.served, run.main_s) / run.main_s
