"""decode_step_ms (read as ``decode_step_ms.chat``): the engine's
``decode`` spans (each ends in the step's read-back of its tokens, so
the device work is inside), total time over count."""


def read(run):
    spans = run.main_spans("decode")
    if not spans:
        return None
    return 1e3 * sum(s[2] for s in spans) / len(spans)
