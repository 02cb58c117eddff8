"""chunk_ms (read as ``chunk_ms.chat``): the mean device-stream time of
one prompt chunk of the paged engine, from the ``device_s`` the program
puts on each ``prefill_chunk`` span (a pair of CUDA events around the
chunk's forward, read once its end has passed: no sync of its own),
before the profiler opens. None where the spans carry no ``device_s``."""


def read(run):
    times = [s[3]["device_s"] for s in run.main_spans("prefill_chunk")
             if "device_s" in s[3]]
    if not times:
        return None
    return 1e3 * sum(times) / len(times)
