"""moe_drop_pct (read as ``moe_drop_pct.long``): token/sub-expert pairs the
2T policy dropped over all pairs routed (the engine's on-device
``MetricsState`` counters, read once; padding rows route and count as
the program counts them)."""


def read(run):
    c = run.counters
    total = c["kept_full"] + c["kept_major"] + c["dropped"]
    return 100.0 * c["dropped"] / total if total else None
