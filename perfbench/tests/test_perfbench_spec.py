"""BENCHMARK.json and the files it names hold together: every metric has
its reader, every cell its configuration, mix and limits, and each
configuration's sizes agree with its published keys."""
import re
import sys
from pathlib import Path

import pytest

sys.path[:0] = [str(Path(__file__).resolve().parents[2])]

from perfbench.harness import check, spec  # noqa: E402

BENCH = spec.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


@pytest.mark.parametrize("m", METRICS, ids=[m["name"] for m in METRICS])
def test_metric_has_a_reader_and_a_sound_entry(m):
    assert NAME.match(m["name"])
    assert spec.reader_path(m["name"]).is_file()
    assert callable(spec.reader(m["name"]))
    assert m["better"] in ("lower", "higher")
    if m in BENCH["per_layer"]:
        e2e = {e["name"]: e for e in BENCH["end_to_end"]}
        assert m["moves"] in e2e
        for w in m["workloads"]:
            assert spec.applies(e2e[m["moves"]], w)
    else:
        assert 0.01 <= m["bound"] <= 0.25


@pytest.mark.parametrize("w", BENCH["workloads"],
                         ids=[w["name"] for w in BENCH["workloads"]])
def test_cell_resolves_and_reports_enough(w):
    c = spec.cell(BENCH, w["name"])
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2 and c.per_layer
    compared = [k for k in check.COMPARED if k in c.limits]
    assert compared
    for key in compared:
        assert c.limits[key]["limit"] > max(c.limits[key]["lower"])
        assert c.limits[key]["limit"] < min(c.limits[key]["upper"])
    assert c.traffic["engine"]["kind"] in ("paged", "continuous")


# published key -> the harness's size, per model type
KEYS = {"qwen3_moe": {"hidden_size": "d_model", "num_attention_heads":
                      "n_heads", "num_key_value_heads": "n_kv_heads",
                      "head_dim": "head_dim", "num_hidden_layers":
                      "n_layers", "moe_intermediate_size": "d_expert",
                      "num_experts": "n_experts", "num_experts_per_tok":
                      "top_k", "vocab_size": "vocab_size", "rope_theta":
                      "rope_theta", "rms_norm_eps": "norm_eps"},
        "dbrx": {"d_model": "d_model", "n_heads": "n_heads", "n_layers":
                 "n_layers", "vocab_size": "vocab_size",
                 "attn_config.kv_n_heads": "n_kv_heads",
                 "attn_config.rope_theta": "rope_theta",
                 "ffn_config.ffn_hidden_size": "d_expert",
                 "ffn_config.moe_num_experts": "n_experts",
                 "ffn_config.moe_top_k": "top_k"}}


@pytest.mark.parametrize("c", BENCH["configs"],
                         ids=[c["name"] for c in BENCH["configs"]])
def test_config_sizes_match_its_published_keys(c):
    conf = spec.load_json(spec.ROOT / c["file"])
    assert conf["source"] == c["source"]
    assert set(c["reduced"]) == set(conf["reduced"])
    for key, dim in KEYS[conf["model_type"]].items():
        value = conf
        for part in key.split("."):
            value = value[part]
        assert value == conf["dims"][dim], key
    assert conf["dims"]["n_heads"] * conf["dims"]["head_dim"] % \
        conf["dims"]["d_model"] == 0
