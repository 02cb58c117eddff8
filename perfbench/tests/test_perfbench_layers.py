"""Layer kinds in the harness: the leaves and model FLOPs of the existing
configurations pinned to what they were before layer kinds existed; the
leaves of MLA, shared-expert and leading dense layers filling the port's
models and summing to DeepSeek-V2-Lite's published parameter count; a
reference's declared coverage deciding, before any weight is made, which
configurations it takes; and the tiny cell served keep-all (policy
``none``) end to end, broken, and against its control."""
import dataclasses
import math
import sys
import time
import types
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path[:0] = [str(Path(__file__).resolve().parents[2]),
                str(Path(__file__).resolve().parents[2] / "src")]

from perfbench.harness import cell as C, check, flops  # noqa: E402
from perfbench.harness import program, spec  # noqa: E402
from perfbench.harness import weights as W  # noqa: E402
from perfbench.tests import tiny  # noqa: E402
from perfbench.tests.test_perfbench_run import FAULTS  # noqa: E402

SEED = 2 ** 31 + 1913
SECONDS = 4.0
MIXES = {"chat": tiny.CHAT, "long": tiny.LONG}


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _dims(name):
    return spec.load_json(spec.BENCH_DIR / "configs" /
                          f"{name}.json")["dims"]


EXISTING = {"qwen3-30b-a3b": _dims("qwen3-30b-a3b"),
            "dbrx-132b": _dims("dbrx-132b"), "tiny": tiny.DIMS}


def _parent_layer_leaves(dims, i):
    """``weights.layer_leaves`` as it was before layer kinds, verbatim."""
    d, D = dims["d_model"], dims["head_dim"]
    hq, hkv = dims["n_heads"], dims["n_kv_heads"]
    g = hq // hkv
    e, f = dims["n_experts"], dims["d_expert"]
    p = f"layers.{i}."
    return [(p + "ln1", (d,), "norm"),
            (p + "wq", (d, hkv, g, D), "matrix"),
            (p + "wk", (d, hkv, D), "matrix"),
            (p + "wv", (d, hkv, D), "matrix"),
            (p + "wo", (hkv, g, D, d), "matrix"),
            (p + "ln2", (d,), "norm"),
            (p + "wg", (d, e), "matrix"),
            (p + "w1", (e, d, f), "matrix"),
            (p + "w3", (e, d, f), "matrix"),
            (p + "w2", (e, f, d), "matrix")]


@pytest.mark.parametrize("name", sorted(EXISTING))
def test_existing_leaves_pinned(name):
    dims = EXISTING[name]
    d, v = dims["d_model"], dims["vocab_size"]
    want = [("embed", (v, d), "matrix"), ("lm_head", (d, v), "matrix"),
            ("final_norm", (d,), "norm")]
    for i in range(dims["n_layers"]):
        want += _parent_layer_leaves(dims, i)
    assert W.leaves(dims) == want


# position_flops(dims, ctx, keep) as the harness computed it before layer
# kinds, to the last bit
PINNED_FLOPS = [
    ("qwen3-30b-a3b", 1.0, 1.0, 2730885120.0),
    ("qwen3-30b-a3b", 1024.5, 0.7512, 2682531191.1935997),
    ("qwen3-30b-a3b", 3000.25, 0.25, 2551283712.0),
    ("dbrx-132b", 1.0, 1.0, 5285486592.0),
    ("dbrx-132b", 1024.5, 0.7512, 4177569624.8831997),
    ("dbrx-132b", 3000.25, 0.25, 1939359744.0),
    ("tiny", 17.5, 0.6, 89651.2),
]


@pytest.mark.parametrize("name,ctx,keep,value", PINNED_FLOPS)
def test_existing_position_flops_pinned(name, ctx, keep, value):
    assert flops.position_flops(EXISTING[name], ctx, keep) == value


# DeepSeek-V2-Lite's published config.json, as the harness's dims
DSV2_LITE = {"n_layers": 27, "d_model": 2048, "n_heads": 16,
             "n_kv_heads": 16, "vocab_size": 102400, "attn_kind": "mla",
             "q_lora_rank": 0, "kv_lora_rank": 512, "qk_nope_head_dim": 128,
             "qk_rope_head_dim": 64, "v_head_dim": 128, "n_experts": 64,
             "top_k": 6, "d_expert": 1408, "n_shared_experts": 2,
             "first_k_dense": 1, "d_ff": 10944, "router_norm_topk": False,
             "rope_theta": 10000.0, "norm_eps": 1e-06}


def test_deepseek_v2_lite_leaves_sum_to_its_parameter_count():
    leaves = W.leaves(DSV2_LITE)
    assert sum(math.prod(s) for _, s, _ in leaves) == 15_706_484_224
    names = [n for n, _, _ in leaves]
    assert len(names) == len(set(names))
    layer0, layer1 = ({n.rsplit(".", 1)[-1] for n in names
                       if n.startswith(f"layers.{i}.")} for i in (0, 1))
    mla = {"wq", "wkv_a", "kv_norm", "wk_b", "wv_b", "wo"}
    assert layer0 == {"ln1", "ln2", "mlp_w1", "mlp_w3", "mlp_w2"} | mla
    assert layer1 == {"ln1", "ln2", "wg", "w1", "w3", "w2", "shared_w1",
                      "shared_w3", "shared_w2"} | mla


def test_deepseek_v2_lite_position_flops_by_hand():
    ctx, keep = 1000.0, 0.75
    # MLA, no q LoRA: q 2 d H (nope + rope), latent + rope key 2 d (r_kv +
    # rope), decompression 2 r_kv H (nope + v), out 2 H v d
    proj = (2 * 2048 * 16 * 192 + 2 * 2048 * 576 + 2 * 512 * 16 * 256
            + 2 * 16 * 128 * 2048)
    assert proj == 27_525_120
    core = 2 * 16 * 192 * ctx + 2 * 16 * 128 * ctx
    router = 2 * 2048 * 64
    routed = 6 * keep * 6 * 2048 * 1408
    shared = 6 * 2048 * 2 * 1408
    dense = 6 * 2048 * 10944
    want = 27 * (proj + core) + 26 * (router + routed + shared) + dense
    assert want == 4_084_908_032
    assert flops.position_flops(DSV2_LITE, ctx, keep) == want


def _dims_of(cfg):
    """The harness's dims of one of the port's configs."""
    out = {k: getattr(cfg, k) for k in (
        "n_layers", "d_model", "n_heads", "n_kv_heads", "n_experts",
        "top_k", "d_expert", "vocab_size", "rope_theta", "norm_eps",
        "attn_kind", "q_lora_rank", "kv_lora_rank", "qk_nope_head_dim",
        "qk_rope_head_dim", "v_head_dim", "n_shared_experts",
        "router_norm_topk")}
    out["head_dim"] = cfg.resolved_head_dim
    return out


def _port_cfg(kind):
    from repro_torch.configs import get_config
    dsv2 = get_config("dsv2-lite-lite").reduced()
    if kind == "dsv2-lite-lite":
        return dsv2
    return dataclasses.replace(dsv2, attn_kind="mla", q_lora_rank=32,
                               kv_lora_rank=16, qk_nope_head_dim=16,
                               qk_rope_head_dim=8, v_head_dim=16,
                               n_shared_experts=0, router_norm_topk=True)


@pytest.mark.parametrize("kind", ["dsv2-lite-lite", "mla"])
def test_build_model_fills_every_parameter(kind):
    cfg = _port_cfg(kind)
    dims = _dims_of(cfg)
    model = program.build_model(cfg, dims, SEED, "cpu")
    named = dict(model.named_parameters())
    leaves = W.leaves(dims)
    assert {program.port_param_name(n) for n, _, _ in leaves} == set(named)
    for name, shape, k in leaves:
        want = W.make_leaf(name, shape, k, SEED, "cpu")
        assert torch.equal(named[program.port_param_name(name)], want), name


@pytest.fixture
def no_weights(monkeypatch):
    """Fails the test if any weight is made."""
    def refuse(*a, **k):
        raise AssertionError("a weight was made")
    monkeypatch.setattr(W, "make_leaf", refuse)


def _dsv2_conf(reference, **dims):
    d = {**DSV2_LITE, **dims}
    fields = {k: v for k, v in d.items() if k != "first_k_dense"}
    return {"reference": reference, "dims": d,
            "port": {"arch": "dsv2-lite-lite", "fields": fields},
            "serving": {"policy": "2t", "drop_target": 0.25, "delta": 0.05,
                        "partition_p": 2, "importance": "abs_gate_up",
                        "calibration_tokens": 1024}}


@pytest.mark.parametrize("dims,key", [
    ({}, "attn_kind"),
    ({"attn_kind": "gqa", "n_kv_heads": 16, "head_dim": 128,
      "first_k_dense": 0, "router_norm_topk": True}, "n_shared_experts")])
def test_moe_decoder_refuses_before_any_weight(no_weights, dims, key):
    conf = _dsv2_conf("moe_decoder", **dims)
    with pytest.raises(ValueError, match=key):
        program.port_config(conf)
    with pytest.raises(ValueError, match=key):
        spec.reference_class(conf)(conf["dims"], conf["serving"], SEED,
                                   "cpu")


def test_a_covering_reference_takes_the_deepseek_v2_block(monkeypatch,
                                                          no_weights):
    """A reference module that declares the DeepSeek-V2 block is all a
    configuration of it needs from the harness: ``port_config`` and the
    leaves take it; the port's missing parts (no query LoRA-free MLA, no
    leading dense layer) show in ``build_model``, before a weight is
    made."""
    stub = types.ModuleType("perfbench.reference.dsv2_stub")
    stub.COVERS = {"family": ("moe",), "attn_kind": ("mla",),
                   "qkv_bias": (False,), "n_shared_experts": (2,),
                   "mlp_kind": ("swiglu",), "frontend": ("",),
                   "tie_embeddings": (False,), "router_norm_topk": (False,),
                   "first_k_dense": (1,)}
    stub.POLICIES = ("2t",)
    monkeypatch.setitem(sys.modules, stub.__name__, stub)
    conf = _dsv2_conf("dsv2_stub")
    cfg = program.port_config(conf)
    assert (cfg.attn_kind, cfg.n_shared_experts, cfg.router_norm_topk) == \
        ("mla", 2, False)
    assert sum(math.prod(s) for _, s, _ in W.leaves(conf["dims"])) == \
        15_706_484_224
    small = dataclasses.replace(_port_cfg("mla"), q_lora_rank=0,
                                n_shared_experts=2, router_norm_topk=False)
    dims = {**_dims_of(small), "first_k_dense": 1, "d_ff": small.d_ff}
    with pytest.raises(ValueError, match="the program holds no"):
        program.build_model(small, dims, SEED, "cpu")


@pytest.mark.parametrize("change,key", [
    ({"dims": {**tiny.DIMS, "first_k_dense": 1, "d_ff": 32}},
     "first_k_dense"),
    ({"serving": {**tiny.CONFIG["serving"], "policy": "1t"}}, "policy")])
def test_moe_decoder_refuses_a_dense_layer_or_another_policy(
        no_weights, change, key):
    with pytest.raises(ValueError, match=key):
        program.port_config({**tiny.CONFIG, **change})


def _run_keepall(mix):
    c = tiny.cell(mix, config=tiny.KEEPALL, limits=tiny.KEEPALL_LIMITS)
    return C.run(c, SEED, SECONDS, False, "cpu", time.perf_counter(),
                 clocked=tiny.VirtualTime())


@pytest.mark.parametrize("kind", ["chat", "long"])
def test_keepall_run_end_to_end_on_cpu(kind):
    metrics, verdict, extra = _run_keepall(MIXES[kind])
    assert "mismatch_share" in verdict and "mean_logit_gap" not in verdict
    assert all(v["ok"] for v in verdict.values()), verdict
    assert extra["failed"] == 0 and extra["attempted"] > 5
    for name in ("output_tok_s", "setup_s"):
        assert metrics[name]["value"] > 0


def test_keepall_counts_every_pair_kept():
    """Keep-all's MoE counters read no drop, and MFU a number."""
    c = tiny.cell(tiny.LONG, "tiny.long", config=tiny.KEEPALL)
    prog = C.setup(c, SEED, "cpu", time.perf_counter())
    rec = C.measure(prog, c, c.traffic, SEED, SECONDS, False, "cpu",
                    clocked=tiny.VirtualTime())
    assert rec.counters["kept_full"] > 0
    assert rec.counters["kept_major"] == rec.counters["dropped"] == 0
    assert spec.reader("moe_drop_pct.long")(rec) == 0
    assert spec.reader("mfu_pct.long")(rec) > 0


@pytest.mark.parametrize("kind", ["chat", "long"])
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_keepall_broken_timed_path_is_not_correct(monkeypatch, fault, kind):
    FAULTS[fault](monkeypatch)
    _, verdict, _ = _run_keepall(MIXES[kind])
    assert not verdict["mismatch_share"]["ok"], verdict


@pytest.mark.parametrize("precision", ["tf32", "lower"])
@pytest.mark.parametrize("kind", ["chat", "long"])
def test_keepall_control_fails_the_comparison(kind, precision):
    conf = tiny.KEEPALL
    rng = np.random.default_rng(6)
    picks = []
    for _ in range(64):
        p = rng.integers(1, 512, int(rng.integers(16, 80)), dtype=np.int32)
        s = check.Served(due_s=0.0, prompt=p, n_out=48)
        s.tokens = rng.integers(1, 512, 48).tolist()
        picks.append(s)
    readings = check.control(spec.reference_class(conf), conf["dims"],
                             conf["serving"], SEED, "cpu", picks,
                             MIXES[kind]["engine"]["kind"],
                             precision=precision)
    assert readings["compared"] > 1000
    verdict = check.verdict(readings, 0, tiny.KEEPALL_LIMITS)
    assert not verdict["mismatch_share"]["ok"], verdict
