"""prefix_hit_pct: the paged engine's prefix-cache hits over its lookups
of full prompt pages (``PagedEngine.prefix_hits`` / ``prefix_misses``)."""


def read(run):
    c = run.counters
    if "prefix_hits" not in c:
        return None
    total = c["prefix_hits"] + c["prefix_misses"]
    return 100.0 * c["prefix_hits"] / total if total else None
