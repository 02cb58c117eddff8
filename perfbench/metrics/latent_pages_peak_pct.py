"""latent_pages_peak_pct (read as ``latent_pages_peak_pct.doc``): the most
pages of the paged engine's pool held at once, by slots and the prefix
cache together, over the pages the pool has, in %: the largest
``pages_peak`` / ``pool_pages`` the program puts on its
``prefill_chunk`` spans before the profiler opens. The engine takes pages
only when it admits a request (for the prompt and the whole decode
budget), and a step admits before it runs its chunk, so each request's
first chunk span reads a peak that holds its own pages: the reading
misses only requests whose first chunk falls after the window. None where
the spans carry no such count."""


def read(run):
    peaks = [(s[3]["pages_peak"], s[3]["pool_pages"])
             for s in run.main_spans("prefill_chunk")
             if "pages_peak" in s[3] and s[3].get("pool_pages")]
    if not peaks:
        return None
    return 100.0 * max(p for p, _ in peaks) / peaks[0][1]
