"""The traffic generator repeats exactly per seed and offers every seed
the same work in another order."""
import sys
from pathlib import Path

import numpy as np
import pytest

sys.path[:0] = [str(Path(__file__).resolve().parents[2])]

from perfbench.harness import spec, traffic  # noqa: E402
from perfbench.tests import tiny  # noqa: E402

BIG_SEED = 2 ** 31 + 12345


def _flat(reqs):
    return [(r.due_s, r.n_out, r.prefix, r.prompt.tobytes()) for r in reqs]


@pytest.mark.parametrize("mix", [tiny.CHAT, tiny.LONG], ids=["chat", "long"])
def test_same_seed_same_requests(mix):
    a = traffic.generate(mix, BIG_SEED, 10.0, 512)
    b = traffic.generate(mix, BIG_SEED, 10.0, 512)
    assert _flat(a) == _flat(b)
    c = traffic.generate(mix, BIG_SEED + 1, 10.0, 512)
    assert _flat(a) != _flat(c)


@pytest.mark.parametrize("mix", [tiny.CHAT, tiny.LONG], ids=["chat", "long"])
def test_seeds_share_the_work(mix):
    a = traffic.generate(mix, 3, 20.0, 512)
    b = traffic.generate(mix, 4, 20.0, 512)
    assert len(a) == len(b) == round(mix["rate_per_s"] * 20)
    assert sorted(len(r.prompt) for r in a) == sorted(len(r.prompt) for r in b)
    assert sorted(r.n_out for r in a) == sorted(r.n_out for r in b)
    assert sorted(np.diff([0] + [r.due_s for r in a])) == pytest.approx(
        sorted(np.diff([0] + [r.due_s for r in b])))
    assert all(0 < r.due_s < 20.0 for r in a)


def test_lengths_within_bounds_and_prefixes_shared():
    mix = tiny.CHAT
    reqs = traffic.generate(mix, 5, 30.0, 512)
    sp = mix["prompt"]["shared_prefix"]
    for r in reqs:
        n = len(r.prompt) - sp["length"]
        assert mix["prompt"]["suffix"]["min"] <= n <= \
            mix["prompt"]["suffix"]["max"]
        assert mix["output"]["min"] <= r.n_out <= mix["output"]["max"]
        assert r.prompt.min() >= 1 and r.prompt.max() < 512
    heads = {}
    for r in reqs:
        heads.setdefault(r.prefix, set()).add(r.prompt[:sp["length"]]
                                              .tobytes())
    assert all(len(v) == 1 for v in heads.values())
    counts = np.bincount([r.prefix for r in reqs])
    assert counts[0] > counts[1]        # Zipf: the first prompt most often


def test_zipf_counts_sum_and_order():
    c = traffic.zipf_counts(100, 8, 1.0)
    assert c.sum() == 100 and list(c) == sorted(c, reverse=True)


def test_quantiles_lognormal_median():
    q = traffic.quantiles({"dist": "lognormal", "median": 128, "sigma": 0.8,
                           "min": 16, "max": 768}, 1001)
    assert q[500] == 128 and q.min() >= 16 and q.max() <= 768


def test_benchmark_mixes_load_and_extend():
    bench = spec.load_benchmark()
    for w in bench["workloads"]:
        mix = spec.traffic_mix(w["traffic"])
        assert mix["rate_per_s"] > 0 and "extends" not in mix
        reqs = traffic.generate(mix, BIG_SEED, 2.0, 1000)
        assert reqs and max(len(r.prompt) for r in reqs) <= \
            mix["engine"]["max_prompt_len"]
        assert max(r.n_out for r in reqs) <= mix["engine"]["max_new_tokens"]
    chat, dbrx = spec.traffic_mix("chat"), spec.traffic_mix("chat-dbrx")
    own = ("rate_per_s", "why", "engine")
    assert {k: v for k, v in dbrx.items() if k not in own} \
        == {k: v for k, v in chat.items() if k not in own}
    assert {k: v for k, v in dbrx["engine"].items() if k != "n_slots"} \
        == {k: v for k, v in chat["engine"].items() if k != "n_slots"}
