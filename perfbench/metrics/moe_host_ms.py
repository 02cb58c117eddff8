"""moe_host_ms (read as ``moe_host_ms.chat``): the mean host time of one
MoE layer call at decode, from the program's ``moe`` spans (norm,
routing, the dispatch plan, the kernel call and the obs counters of one
layer) that lie inside its ``decode`` spans, before the profiler opens.
The kernel runs asynchronously, so this is host work, not device time.
None where the program opens no such span."""
import bisect


def read(run):
    decode = sorted((s[1], s[1] + s[2]) for s in run.main_spans("decode"))
    starts = [a for a, _ in decode]
    inside = []
    for _, t0, dur, _ in run.main_spans("moe"):
        i = bisect.bisect_right(starts, t0) - 1
        if i >= 0 and t0 + dur <= decode[i][1]:
            inside.append(dur)
    if not inside:
        return None
    return 1e3 * sum(inside) / len(inside)
