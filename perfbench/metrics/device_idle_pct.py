"""device_idle_pct (``.chat``, ``.long``: the same reading, split by the
end-to-end metric it moves): the share of the traced sub-window in which
no kernel, copy or fill ran on the card (the union of their intervals,
not the sum of their durations)."""


def read(run):
    if run.trace is None or run.profiled_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.profiled_s)
