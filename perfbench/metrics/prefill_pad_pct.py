"""prefill_pad_pct (read as ``prefill_pad_pct.long``): the share of the
prompt rows the continuous engine's prefills ran that were padding, from
the counts on its ``prefill_insert`` spans before the profiler opens:
100 x (sum of ``positions``, the rows run, minus sum of ``prompt_len``,
the prompt tokens carried) / sum of ``positions``. None where the spans
carry no ``positions``."""


def read(run):
    spans = [s for s in run.main_spans("prefill_insert")
             if "positions" in s[3]]
    rows = sum(s[3]["positions"] for s in spans)
    if not rows:
        return None
    return 100.0 * (rows - sum(s[3]["prompt_len"] for s in spans)) / rows
