"""prefill_ms_per_ktok (read as ``prefill_ms_per_ktok.long``): the
continuous engine's ``prefill_insert`` spans (each ends in the read-back
of the first token), total time over the prompt tokens the requests
carried, per 1000 tokens; the padding to max_prompt_len is not counted
as tokens."""


def read(run):
    spans = run.main_spans("prefill_insert")
    tokens = sum(s[3]["prompt_len"] for s in spans)
    if not tokens:
        return None
    return 1e6 * sum(s[2] for s in spans) / tokens
