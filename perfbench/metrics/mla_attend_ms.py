"""mla_attend_ms (read as ``mla_attend_ms.doc``): the host time of MLA
attention in one decode step, from the program's ``mla.attend`` spans
(the latent page read, scores, softmax, the latent output, ``wv_b`` and
``wo`` of one layer) that lie inside its ``decode`` spans, summed over a
step's layers and averaged over the decode steps, before the profiler
opens. The work is queued asynchronously, so this is host work, not
device time. None where the program opens no such span."""
import bisect


def read(run):
    decode = sorted((s[1], s[1] + s[2]) for s in run.main_spans("decode"))
    if not decode:
        return None
    starts = [a for a, _ in decode]
    total, steps = 0.0, set()
    for _, t0, dur, _ in run.main_spans("mla.attend"):
        i = bisect.bisect_right(starts, t0) - 1
        if i >= 0 and t0 + dur <= decode[i][1]:
            total += dur
            steps.add(i)
    if not steps:
        return None
    return 1e3 * total / len(decode)
