"""The port's three walkthroughs (``repro_torch.examples``) against the JAX
package's, on the JAX package's own weights loaded through the weight
bridge: quickstart's drop comparison (FLOPs saved and relative output
errors at rtol 1e-5: the same float32 arithmetic summed in another order)
and its 2T tokens, the serve example's baseline and 2T tokens (equal), and
the Fig. 4 fine-tune's claim that the P=2 twin computes the same function
at init (step-0 cross entropy at rtol 1e-5)."""
import copy
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.core import drop as jdrop
from repro.core import gating as jgating
from repro.core import moe as jmoe
from repro.core import reconstruct as jrec
from repro.core.policy import make_policy as jax_make_policy
from repro.data.pipeline import calibration_activations as jax_calib
from repro.launch.mesh import make_host_mesh
from repro.models import model as JM
from repro.models.transformer import DistContext
from repro.serving import GenerationConfig as JGen
from repro.serving import ServingEngine as JServing
from repro_torch.checkpoint.from_numpy import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.core.policy import make_policy
from repro_torch.data import pipeline
from repro_torch.examples import finetune_partitioned as ft
from repro_torch.examples import quickstart as qs
from repro_torch.examples import serve_dualsparse as sd
from repro_torch.models import model as M

RTOL = 1e-5
ARCH = "olmoe-lite"      # the default of quickstart and the serve example


@functools.lru_cache(maxsize=None)
def _setup():
    """JAX's weights as quickstart draws them, the calibration activations,
    the 2T-prepared weights and their EP-free serving context; the same
    weights in the port."""
    cfg, jcfg = get_config(ARCH), jax_config(ARCH)
    key = jax.random.PRNGKey(0)
    params = JM.init_params(key, jcfg)
    calib = jax_calib(jax.random.fold_in(key, 1), 512, jcfg.d_model)
    jpol = jax_make_policy("2t", jcfg.dualsparse)
    tparams, jpol = jpol.prepare(params, jcfg, calib)
    dist = DistContext(mesh=make_host_mesh(1), moe_impl="dispatch",
                       policy=jpol)
    as_np = functools.partial(jax.tree.map, np.asarray)
    return dict(cfg=cfg, jcfg=jcfg, params=params, calib=calib,
                tparams=tparams, dist=dist,
                model=params_from_numpy(as_np(params), cfg, device="cpu"),
                tmodel=params_from_numpy(as_np(tparams), cfg, device="cpu"))


def _jax_drop_comparison(s):
    """Quickstart's step 4 as the JAX example computes it."""
    cfg, calib = s["jcfg"], s["calib"]
    layer0 = jax.tree.map(lambda a: a[0], s["params"]["blocks"]["moe"])
    rec = jrec.partition_and_reconstruct(layer0, calib, cfg, p=2)
    x = calib[:256]
    y_full = jmoe.moe_forward_ref(layer0, x, cfg)
    r = jgating.route(x, layer0["wg"], cfg.top_k, cfg.router_norm_topk)
    t1 = float(jnp.quantile(r.norm_score, 0.25))
    rows = []
    for name, pairs in [
            ("1T-Drop", jdrop.expand_pairs_1t(r.idx, r.combine,
                                              r.norm_score, 2, t1)),
            ("2T-Drop", jdrop.expand_pairs_2t(r.idx, r.combine,
                                              r.norm_score, 2, t1 - 0.005,
                                              t1 + 0.005))]:
        y = jmoe.moe_forward_ref(rec, x, cfg, pairs=pairs)
        rows.append((name, float(jdrop.flops_saved_fraction(pairs.modes)),
                     float(jnp.sqrt(jnp.mean((y - y_full) ** 2)
                                    / jnp.mean(y_full ** 2)))))
    imp = jrec.neuron_importance(layer0, calib, cfg, "abs_gate")
    return rows, np.asarray(imp)


def test_quickstart_drop_comparison_matches_jax():
    s = _setup()
    want, want_imp = _jax_drop_comparison(s)
    calib = torch.from_numpy(np.array(s["calib"]))
    layer0 = s["model"].blocks[0].moe.weights()
    imp, rec = qs.profile_and_reconstruct(layer0, calib, s["cfg"])
    assert tuple(rec["w1"].shape) == (2 * s["cfg"].n_experts,
                                      s["cfg"].d_model,
                                      s["cfg"].d_expert // 2)
    np.testing.assert_allclose(imp.numpy(), want_imp, rtol=RTOL, atol=1e-6)
    got = qs.drop_comparison(layer0, rec, calib[:256], s["cfg"])
    assert [r[0] for r in got] == [r[0] for r in want]
    for (_, fs, err), (_, wfs, werr) in zip(got, want):
        np.testing.assert_allclose(fs, wfs, rtol=RTOL)
        np.testing.assert_allclose(err, werr, rtol=RTOL)
    # 2T keeps the major half of the pairs 1T drops near the threshold
    assert got[1][1] > got[0][1] > 0


def _jax_tokens(s, prompts, new_tokens, prepared: bool):
    cfg = s["jcfg"]
    kw = dict(batch_size=len(prompts), max_prompt_len=len(prompts[0]),
              max_new_tokens=new_tokens)
    eng = (JServing(cfg, s["tparams"], dist=s["dist"], **kw) if prepared
           else JServing(cfg, s["params"], **kw))
    return [r.tokens for r in eng.generate(
        prompts, JGen(max_new_tokens=new_tokens))]


def test_quickstart_2t_tokens_match_jax():
    s = _setup()
    cfg = s["cfg"]
    prompts = sd.make_prompts(cfg, 2, qs.PROMPT_LEN)
    policy = make_policy("2t", cfg.dualsparse)
    got = qs.generate_2t(cfg, s["tmodel"], policy, prompts, device="cpu")
    assert [r.tokens for r in got] == _jax_tokens(s, prompts, qs.NEW_TOKENS,
                                                  prepared=True)


@pytest.mark.parametrize("route", ["baseline", "2t"])
def test_serve_example_tokens_match_jax(route):
    s = _setup()
    cfg = s["cfg"]
    prompts = sd.make_prompts(cfg, 3, 12)
    new = 5
    if route == "baseline":
        eng = sd.sync_engine(cfg, s["model"], prompts, new, device="cpu")
    else:
        eng = sd.sync_engine(cfg, s["tmodel"], prompts, new,
                             make_policy("2t", cfg.dualsparse), "cpu")
    tps, res = sd.throughput(eng, prompts, new)
    assert tps > 0
    assert [r.tokens for r in res] == _jax_tokens(s, prompts, new,
                                                  prepared=route == "2t")
    if route == "2t":
        cont = sd.continuous_engine(cfg, s["tmodel"], prompts, new, 2,
                                    make_policy("2t", cfg.dualsparse), "cpu")
        _, cres = sd.throughput(cont, prompts, new)
        assert cont.n_admitted == len(prompts)
        assert all(len(r.tokens) == new for r in cres)


def test_quickstart_main_runs_on_the_cpu(capsys):
    out = qs.main(["--device", "cpu"])
    text = capsys.readouterr().out
    assert text.splitlines()[-1] == "OK"
    assert "2T-Drop: flops saved" in text
    assert len(out["tokens"]) == 2
    assert all(len(t) == qs.NEW_TOKENS for t in out["tokens"])


def test_serve_example_main_runs_on_the_cpu(capsys):
    out = sd.main(["--device", "cpu", "--requests", "3", "--prompt-len",
                   "12", "--new-tokens", "4", "--slots", "2"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("baseline (sync)")
    assert lines[-1].startswith("DualSparse 2T + continuous batching "
                                "(2 slots)")
    assert "admitted 3 requests" in lines[-1]
    assert all(len(r.tokens) == 4 for run in ("baseline", "2t", "continuous")
               for r in out[run])


def test_finetune_twin_same_function_at_init():
    """The P=2 complete-transformation twin computes the same function at
    init: the step-0 batch's cross entropy equals the original's. (The
    training loss adds 0.01 x the Switch aux term, which counts the twin's
    K x P selections and so is not part of the function.) Two steps run
    on each."""
    cfg = dataclasses.replace(ft.CFG_100M, n_layers=2, d_model=64,
                              n_heads=4, n_kv_heads=2, d_ff=64,
                              vocab_size=256, n_experts=4, top_k=2,
                              d_expert=32)
    model = M.init_params(cfg, seed=0, device="cpu")
    twin = ft.partition_model(copy.deepcopy(model), 2)
    cfg_p = ft.partitioned_config(cfg, 2)
    assert (cfg_p.n_experts, cfg_p.top_k, cfg_p.d_expert) == (8, 4, 16)
    assert tuple(twin.blocks[0].moe.w1.shape) == (8, 64, 16)
    batch = pipeline.make_loader(cfg, 2, 16).get_batch(0)
    with torch.no_grad():
        ce = float(M.loss_fn(model, batch, cfg))
        ce_p = float(M.loss_fn(twin, batch, cfg_p))
    np.testing.assert_allclose(ce_p, ce, rtol=RTOL)
    l_orig = ft.train(cfg, model, 2, 2, 16, 1e-3, "orig", log_every=1)
    l_part = ft.train(cfg_p, twin, 2, 2, 16, 1e-3, "P=2", log_every=1)
    assert len(l_orig) == len(l_part) == 2
    assert np.isfinite(l_orig + l_part).all()
    # the step-0 losses differ by the aux term alone
    assert l_part[0] > l_orig[0] > ce
