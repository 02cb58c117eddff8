"""The one traffic generator: a mix file's parameters and a seed in, a
list of requests (due time, prompt tokens, output length) out.

Arrivals are an open-loop Poisson process, stratified: for N = rate x
seconds requests the inter-arrival gaps are the N exponential quantiles
at (i + 0.5) / N, and the prompt and output lengths the quantiles of
their distributions, each set put in an order drawn from the seed. Every
seed therefore offers the same work in another order, so runs with
different seeds differ by the order and the token ids, not by how much
they ask for. Prompts may start with one of a few shared prefixes (system
prompts), picked by a Zipf law; token ids are uniform over [1, vocab).
"""
from __future__ import annotations

import dataclasses
from statistics import NormalDist
from typing import Dict, List

import numpy as np

_NORMAL = NormalDist()


@dataclasses.dataclass
class Request:
    due_s: float            # seconds after the window opens
    prompt: np.ndarray      # int32 token ids
    n_out: int              # output tokens asked for
    prefix: int = -1        # index of the shared prefix, -1 for none


def _rng(seed: int, tag: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % 2 ** 64, tag])


def quantiles(spec: Dict, n: int) -> np.ndarray:
    """The n quantiles at (i + 0.5) / n of a length distribution, as ints
    clipped to [min, max]: ``lognormal`` (median, sigma) or ``uniform``
    (every int in [min, max] equally likely)."""
    q = (np.arange(n) + 0.5) / n
    lo, hi = int(spec["min"]), int(spec["max"])
    if spec["dist"] == "lognormal":
        z = np.array([_NORMAL.inv_cdf(float(v)) for v in q])
        vals = np.rint(spec["median"] * np.exp(spec["sigma"] * z))
    elif spec["dist"] == "uniform":
        vals = lo + np.floor(q * (hi - lo + 1))
    else:
        raise ValueError(f"unknown length distribution {spec['dist']!r}")
    return np.clip(vals, lo, hi).astype(np.int64)


def zipf_counts(n: int, n_items: int, s: float) -> np.ndarray:
    """How many of n draws go to each item under a Zipf(s) law, by the
    largest remainders (the counts sum to n)."""
    w = 1.0 / np.arange(1, n_items + 1) ** s
    exact = n * w / w.sum()
    counts = np.floor(exact).astype(np.int64)
    rest = n - int(counts.sum())
    counts[np.argsort(-(exact - counts), kind="stable")[:rest]] += 1
    return counts


def n_requests(mix: Dict, seconds: float) -> int:
    return max(1, int(round(mix["rate_per_s"] * seconds)))


def generate(mix: Dict, seed: int, seconds: float,
             vocab: int) -> List[Request]:
    """The requests due in a window of ``seconds``, in due order."""
    n = n_requests(mix, seconds)
    q = (np.arange(n) + 0.5) / n
    gaps = -np.log1p(-q) / mix["rate_per_s"]
    gaps = gaps[_rng(seed, 1).permutation(n)]
    due = np.cumsum(gaps)
    prompt = mix["prompt"]
    suffix = quantiles(prompt["suffix"], n)[_rng(seed, 2).permutation(n)]
    n_out = quantiles(mix["output"], n)[_rng(seed, 3).permutation(n)]
    tok = _rng(seed, 4)
    prefixes: List[np.ndarray] = []
    owner = np.full(n, -1)
    shared = prompt.get("shared_prefix")
    if shared:
        prefixes = [tok.integers(1, vocab, shared["length"], dtype=np.int32)
                    for _ in range(shared["count"])]
        counts = zipf_counts(n, shared["count"], shared["zipf_s"])
        owner = np.repeat(np.arange(shared["count"]), counts)
        owner = owner[_rng(seed, 5).permutation(n)]
    out = []
    for i in range(n):
        body = tok.integers(1, vocab, int(suffix[i]), dtype=np.int32)
        if owner[i] >= 0:
            body = np.concatenate([prefixes[owner[i]], body])
        out.append(Request(due_s=float(due[i]), prompt=body,
                           n_out=int(n_out[i]), prefix=int(owner[i])))
    return out


def warmup_requests(mix: Dict, seed: int, vocab: int) -> List[Request]:
    """Two short requests that drive every step shape the mix uses: the
    longest prompt (every chunk size) and the shortest, a few tokens
    each."""
    prompt = mix["prompt"]
    extra = prompt["shared_prefix"]["length"] if prompt.get(
        "shared_prefix") else 0
    tok = _rng(seed, 6)
    lens = [prompt["suffix"]["max"] + extra, prompt["suffix"]["min"]]
    return [Request(due_s=0.0,
                    prompt=tok.integers(1, vocab, n, dtype=np.int32),
                    n_out=4) for n in lens]
