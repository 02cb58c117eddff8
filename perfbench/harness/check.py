"""Whether what the timed path served is correct: a sample, drawn from the
seed, of the requests the window finished (the one with the most output
tokens always in it) is run through the plain reference, teacher-forced
on each prompt and its served tokens, and at every served position the
served token's logit is held against the reference's best. A cell's limits file names the numbers it compares
(``COMPARED``): the mean of that gap over the positions, or the share of
positions whose served token is not the reference's best (the widest gap
is reported too: it is set by single routing decisions that a rounding
flips, and swings from seed to seed). Positions where the reference's
routing was within rounding of a threshold or of the top-k boundary are
left out (their count is reported)."""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from .stats import Served

# which prompt positions the engine attends in float32 (a whole-prompt
# prefill) rather than through its bf16 cache (chunked prefill)
FLOAT_PROMPT = {"continuous": True, "paged": False}
LOGIT_BLOCK = 512
# a routing decision this close to flipping has no defined outcome at
# float32: a kept score within AMBIG_ABS of a 2T threshold, or the k-th
# and (k+1)-th router probabilities within AMBIG_REL of each other.
# Positions with such a decision in any layer are left out.
AMBIG_ABS = 1e-5
AMBIG_REL = 1e-4
# the readings a cell's limits file may set a limit on, in the order the
# verdict gives them
COMPARED = ("mean_logit_gap", "mismatch_share")


def ambiguous(margins: torch.Tensor) -> torch.Tensor:
    return (margins[:, 0] <= AMBIG_ABS) | (margins[:, 1] <= AMBIG_REL)


def sample(served: List[Served], window_s: float, n_max: int,
           seed: int) -> List[Served]:
    done = [s for s in served if not s.failed and s.n_out > 0
            and len(s.tokens) >= s.n_out and s.stamps[-1] <= window_s]
    if not done:
        return []
    longest = max(range(len(done)),
                  key=lambda i: (done[i].n_out, done[i].n_prompt))
    rest = [i for i in range(len(done)) if i != longest]
    rng = np.random.default_rng([int(seed) % 2 ** 64, 7])
    pick = rng.choice(len(rest), size=min(n_max - 1, len(rest)),
                      replace=False) if rest and n_max > 1 else []
    return [done[longest]] + [done[rest[i]] for i in sorted(pick)]


def reference_inputs(picks: List[Served], engine_kind: str):
    """Teacher-forced sequences, their float32 prompt lengths, the
    positions scored and the served token at each."""
    seqs, n_float, pos, targets = [], [], [], []
    for s in picks:
        p = len(s.prompt)
        seqs.append(np.concatenate([s.prompt, np.asarray(s.tokens[:-1],
                                                         np.int32)]))
        n_float.append(p if FLOAT_PROMPT[engine_kind] else 0)
        pos.append(range(p - 1, p - 1 + len(s.tokens)))
        targets.extend(s.tokens)
    return seqs, n_float, pos, targets



def logit_gaps(ref, hidden, chosen: Optional[torch.Tensor] = None,
               other=None, other_hidden=None) -> torch.Tensor:
    """Per position: the reference's best logit minus its logit of the
    token chosen there — ``chosen`` given, or the argmax of ``other``'s
    logits over ``other_hidden`` (the control)."""
    head = ref.head()
    other_head = other.head() if other is not None else None
    out = []
    for a in range(0, hidden.shape[0], LOGIT_BLOCK):
        b = min(a + LOGIT_BLOCK, hidden.shape[0])
        lg = ref.logits(hidden[a:b], head)
        if other is not None:
            pick = other.logits(other_hidden[a:b], other_head).argmax(-1)
        else:
            pick = chosen[a:b]
        out.append(lg.max(-1).values - lg.gather(1, pick[:, None])[:, 0])
    return torch.cat(out)


def compare(reference_cls, dims: Dict, serving: Dict, seed: int, device,
            picks: List[Served], engine_kind: str) -> Dict[str, float]:
    """The widest gap of the served tokens, and how many positions were
    compared and left out."""
    if not picks:
        return {"max_logit_gap": float("nan"), "mean_logit_gap": float("nan"),
                "mismatch_share": float("nan"), "compared": 0, "excluded": 0}
    seqs, n_float, pos, targets = reference_inputs(picks, engine_kind)
    ref = reference_cls(dims, serving, seed, device)
    with torch.no_grad():
        hidden, margins = ref.run(seqs, n_float, pos)
        tgt = torch.as_tensor(targets, dtype=torch.long, device=hidden.device)
        gaps = logit_gaps(ref, hidden, chosen=tgt)
    return _readings(gaps, margins)


def _readings(gaps, margins) -> Dict:
    amb = ambiguous(margins)
    keep = ~amb
    g = gaps[keep]
    widest = float(g.max()) if g.numel() else float("nan")
    top = torch.argsort(gaps, descending=True)[:5]
    out = {"max_logit_gap": widest, "compared": int(keep.sum()),
           "excluded": int(amb.sum()),
           "mean_logit_gap": float(g.mean()) if g.numel() else float("nan"),
           "mismatch_share": float((g > 0).float().mean()) if g.numel()
           else float("nan"),
           "widest": [[float(gaps[i]), float(margins[i, 0]),
                       float(margins[i, 1])] for i in top.tolist()]}
    return out


def control(reference_cls, dims: Dict, serving: Dict, seed: int, device,
            picks: List[Served], engine_kind: str,
            precision: str = "lower") -> Dict[str, float]:
    """The same readings for the control: the reference computed one step
    down in precision (see the reference's ``precision``), put in the
    program's place (its own argmax at each position of the same prompts
    and served tokens)."""
    seqs, n_float, pos, _ = reference_inputs(picks, engine_kind)
    ref = reference_cls(dims, serving, seed, device)
    low = reference_cls(dims, serving, seed, device, precision=precision)
    with torch.no_grad():
        hidden, margins = ref.run(seqs, n_float, pos)
        low_hidden, _ = low.run(seqs, n_float, pos)
        gaps = logit_gaps(ref, hidden, other=low, other_hidden=low_hidden)
    return _readings(gaps, margins)


def verdict(readings: Dict[str, float], failed: int,
            limits: Dict) -> Dict[str, Dict[str, float]]:
    """Each number compared beside its limit, and whether it holds: the
    ``COMPARED`` readings the cell's limits name, the positions compared
    and the failed requests."""
    out = {}
    for key in COMPARED:
        if key in limits:
            v, limit = readings[key], limits[key]["limit"]
            out[key] = {"value": v, "limit": limit,
                        "ok": bool(v == v and v <= limit)}
    out["positions_compared"] = {
        "value": readings["compared"],
        "limit": limits["min_compared"]["limit"],
        "ok": readings["compared"] >= limits["min_compared"]["limit"]}
    out["failed_requests"] = {"value": failed, "limit": 0, "ok": failed == 0}
    return out
