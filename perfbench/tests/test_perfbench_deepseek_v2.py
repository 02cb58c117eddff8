"""The DeepSeek-V2 configuration in the harness: the tiny DeepSeek-V2 shape
(``tiny_deepseek.py``) through ``port_config``, ``build_model`` and the
plain reference (``reference/deepseek_v2.py``); the coverage the reference
declares refusing, before any weight is made, a YaRN the reference does
not compute; the benchmark's own file taken by the program at its
published sizes; and the tiny document cell served end to end on the CPU
through the paged latent cache: correct, not correct with its timed path
broken, its control failing the comparison, and the new readers reading
a number there and None in a GQA cell."""
import math
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path[:0] = [str(Path(__file__).resolve().parents[2]),
                str(Path(__file__).resolve().parents[2] / "src")]

from perfbench.harness import cell as C, check, program, spec  # noqa: E402
from perfbench.harness import weights as W  # noqa: E402
from perfbench.tests import tiny, tiny_deepseek as TD  # noqa: E402
from perfbench.tests.test_perfbench_run import FAULTS  # noqa: E402

SEED = 2 ** 31 + 2929
SECONDS = 4.0


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def no_weights(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a weight was made")
    monkeypatch.setattr(W, "make_leaf", refuse)


def test_tiny_shape_through_port_config_build_model_and_reference():
    cfg = program.port_config(TD.CONFIG)
    assert (cfg.attn_kind, cfg.q_lora_rank, cfg.leading_dense_layers,
            cfg.n_shared_experts, cfg.router_norm_topk) == \
        ("mla", 0, 1, 2, False)
    assert (cfg.rope_scaling_factor, cfg.rope_original_max_pos) == (40.0, 32)
    model = program.build_model(cfg, TD.DIMS, SEED, "cpu")
    named = dict(model.named_parameters())
    leaves = W.leaves(TD.DIMS)
    assert {program.port_param_name(n) for n, _, _ in leaves} == set(named)
    for name, shape, kind in leaves:
        assert torch.equal(named[program.port_param_name(name)],
                           W.make_leaf(name, shape, kind, SEED, "cpu")), name
    ref = spec.reference_class(TD.CONFIG)(TD.DIMS, TD.CONFIG["serving"],
                                          SEED, "cpu")
    assert ref.n_dense == 1 and not torch.backends.cuda.matmul.allow_tf32


@pytest.mark.parametrize("factor", [1.0, 20.0])
def test_uncovered_refuses_another_yarn(no_weights, factor):
    """A YaRN factor the reference does not compute is refused by
    ``spec.uncovered`` in the program's config and by the reference in
    its dims, before any weight is made."""
    conf = {**TD.CONFIG, "port": {
        "arch": "deepseek-v2-lite",
        "fields": {**TD.CONFIG["port"]["fields"],
                   "rope_scaling_factor": factor}}}
    with pytest.raises(ValueError, match="rope_scaling_factor"):
        program.port_config(conf)
    mod = spec.reference_module(TD.CONFIG)
    cfg = program.port_config(TD.CONFIG)
    assert spec.uncovered(mod, TD.DIMS, TD.CONFIG["serving"], cfg) == []
    dims = {**TD.DIMS, "rope_scaling_factor": factor}
    with pytest.raises(ValueError, match="rope_scaling_factor"):
        spec.reference_class(TD.CONFIG)(dims, TD.CONFIG["serving"], SEED,
                                        "cpu")


def test_moe_decoder_does_not_take_the_block(no_weights):
    conf = {**TD.CONFIG, "reference": "moe_decoder"}
    with pytest.raises(ValueError, match="attn_kind"):
        program.port_config(conf)


def test_benchmark_file_at_its_published_sizes(no_weights):
    """The cell's configuration: the program takes it as the file states
    it (YaRN, layer kinds and sizes equal), its leaves sum to
    DeepSeek-V2-Lite's 15,706,484,224 parameters, and its published keys
    are the harness's sizes."""
    c = spec.cell(spec.load_benchmark(), "deepseek-v2-lite.doc-qa")
    conf, dims = c.config, c.config["dims"]
    cfg = program.port_config(conf)
    for key in ("rope_scaling_factor", "rope_original_max_pos",
                "rope_beta_fast", "rope_beta_slow", "rope_mscale",
                "rope_mscale_all_dim", "n_layers", "d_model", "n_heads",
                "kv_lora_rank", "qk_nope_head_dim", "qk_rope_head_dim",
                "v_head_dim", "n_experts", "top_k", "d_expert", "d_ff",
                "n_shared_experts", "vocab_size", "norm_eps"):
        assert getattr(cfg, key) == dims[key], key
    assert cfg.leading_dense_layers == dims["first_k_dense"] == \
        conf["first_k_dense_replace"]
    assert sum(math.prod(s) for _, s, _ in W.leaves(dims)) == \
        15_706_484_224
    rs = conf["rope_scaling"]
    for mine, theirs in (("rope_scaling_factor", "factor"),
                         ("rope_original_max_pos",
                          "original_max_position_embeddings"),
                         ("rope_beta_fast", "beta_fast"),
                         ("rope_beta_slow", "beta_slow"),
                         ("rope_mscale", "mscale"),
                         ("rope_mscale_all_dim", "mscale_all_dim")):
        assert dims[mine] == rs[theirs], mine
    for key, dim in (("hidden_size", "d_model"),
                     ("num_attention_heads", "n_heads"),
                     ("num_hidden_layers", "n_layers"),
                     ("moe_intermediate_size", "d_expert"),
                     ("n_routed_experts", "n_experts"),
                     ("num_experts_per_tok", "top_k"),
                     ("intermediate_size", "d_ff"),
                     ("kv_lora_rank", "kv_lora_rank"),
                     ("qk_nope_head_dim", "qk_nope_head_dim"),
                     ("qk_rope_head_dim", "qk_rope_head_dim"),
                     ("v_head_dim", "v_head_dim"),
                     ("n_shared_experts", "n_shared_experts"),
                     ("vocab_size", "vocab_size"), ("rope_theta",
                                                    "rope_theta"),
                     ("rms_norm_eps", "norm_eps")):
        assert conf[key] == dims[key if key == dim else dim], key
    assert conf["q_lora_rank"] is None and dims["q_lora_rank"] == 0
    assert conf["norm_topk_prob"] is dims["router_norm_topk"] is False
    eng = c.traffic["engine"]
    assert (eng["kind"], eng["n_slots"], eng["max_prompt_len"]) == \
        ("paged", 32, 4608)


def _run(config=TD.CONFIG, limits=TD.LIMITS):
    c = TD.cell(config=config, limits=limits)
    return C.run(c, SEED, SECONDS, False, "cpu", time.perf_counter(),
                 clocked=tiny.VirtualTime())


@pytest.mark.parametrize("policy", ["2t", "none"])
def test_doc_cell_end_to_end_on_cpu(policy):
    config = TD.CONFIG if policy == "2t" else TD.KEEPALL
    metrics, verdict, extra = _run(config)
    assert all(v["ok"] for v in verdict.values()), verdict
    assert extra["failed"] == 0 and extra["attempted"] > 5
    for name in ("output_tok_s.chat", "setup_s", "itl_p95_ms"):
        assert metrics[name]["value"] > 0


def _latent_unwritten(monkeypatch):
    from repro_torch.models import attention
    monkeypatch.setattr(attention.PagedLayout, "append_rows",
                        lambda self, cache, *a, **k: cache)


@pytest.mark.parametrize("fault", ["token_altered", "half_batch_left_out",
                                   "latent_unwritten"])
def test_doc_cell_broken_timed_path_is_not_correct(monkeypatch, fault):
    faults = {**FAULTS, "latent_unwritten": _latent_unwritten}
    faults[fault](monkeypatch)
    _, verdict, _ = _run()
    assert not verdict["mean_logit_gap"]["ok"], verdict


@pytest.mark.parametrize("precision", ["tf32", "lower"])
def test_doc_control_fails_the_comparison(precision):
    rng = np.random.default_rng(8)
    picks = []
    for _ in range(48):
        p = rng.integers(1, 512, int(rng.integers(16, 80)), dtype=np.int32)
        s = check.Served(due_s=0.0, prompt=p, n_out=48)
        s.tokens = rng.integers(1, 512, 48).tolist()
        picks.append(s)
    conf = TD.CONFIG
    readings = check.control(spec.reference_class(conf), conf["dims"],
                             conf["serving"], SEED, "cpu", picks, "paged",
                             precision=precision)
    assert readings["compared"] > 1000
    assert not check.verdict(readings, 0, TD.LIMITS)["mean_logit_gap"]["ok"]


def test_new_readers_read_the_doc_cell_and_none_elsewhere():
    """``mla_attend_ms.doc`` and ``latent_pages_peak_pct.doc`` read a
    number on the tiny document cell (the decode steps' summed
    ``mla.attend`` spans; the pool's peak from the chunk spans) and None
    where what they read is absent: a GQA cell opens no ``mla.attend``
    span, and a program whose chunk spans carry no peak (as before the
    counter) gives the peak reader nothing."""
    c = TD.cell()
    prog = C.setup(c, SEED, "cpu", time.perf_counter())
    rec = C.measure(prog, c, c.traffic, SEED, SECONDS, False, "cpu",
                    clocked=tiny.VirtualTime())
    attend = spec.reader("mla_attend_ms.doc")(rec)
    assert 0 < attend < spec.reader("decode_step_ms.chat")(rec)
    pct = spec.reader("latent_pages_peak_pct.doc")(rec)
    assert 0 < pct <= 100
    assert spec.reader("prefix_hit_pct")(rec) > 0
    assert spec.reader("mfu_pct.chat")(rec) > 0
    chat = tiny.cell(tiny.CHAT)
    prog = C.setup(chat, SEED, "cpu", time.perf_counter())
    rec = C.measure(prog, chat, chat.traffic, SEED, SECONDS, False, "cpu",
                    clocked=tiny.VirtualTime())
    assert spec.reader("mla_attend_ms.doc")(rec) is None
    assert spec.reader("latent_pages_peak_pct.doc")(rec) > 0
    rec.spans = [(n, t, d, {k: v for k, v in (a or {}).items()
                            if k != "pages_peak"}) for n, t, d, a in rec.spans]
    assert spec.reader("latent_pages_peak_pct.doc")(rec) is None
