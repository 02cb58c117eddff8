"""Training in the port against the JAX package, on the CPU, on the same
numpy inputs: the JAX weights load through the weight bridge
(``repro_torch.checkpoint.from_numpy``) and both packages take the same
numpy batches.

Tolerances:
  * AdamW, the cosine schedule, global-norm clipping, the aux losses:
    rel 1e-6 (per leaf, norm-relative, for AdamW's params and moments) —
    the same float32 formulas, term for term; the clip's norm sums its
    leaves in another order, and ``cos`` may round one ulp apart, which
    can move an updated weight near 0 by more than 1e-6 of itself;
  * loss: rel 1e-5; each leaf's gradient: norm-relative 1e-4 — the same
    float32 arithmetic through every layer, products summed in another
    order;
  * three train steps: losses rel 1e-5, each leaf's update ``p3 - p0``
    norm-relative 1e-3 (Adam divides by sqrt(v): a gradient entry near 0
    moves its update by much more than its own error).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs.base import DualSparseConfig as JDualSparse
from repro.configs.base import ModelConfig as JModelConfig
from repro.core import gating as jgating
from repro.core import moe as jmoe
from repro.core import partition as jpartition
from repro.core.policy import make_policy as jax_make_policy
from repro.launch.mesh import make_host_mesh
from repro.models import model as JM
from repro.models.transformer import DistContext as JDist
from repro.optim import adamw as jadamw
from repro.optim import clip_by_global_norm as jclip
from repro.optim import cosine_schedule as jcosine
from repro_torch.checkpoint.from_numpy import (_unstack, params_from_numpy,
                                               params_to_numpy)
from repro_torch.configs import get_config
from repro_torch.configs.base import DualSparseConfig, ModelConfig
from repro_torch.core import gating, moe
from repro_torch.core import partition
from repro_torch.core.policy import NoDrop, TwoTDrop
from repro_torch.data import pipeline
from repro_torch.kernels import ops
from repro_torch.models import model as M
from repro_torch.models import transformer as TT
from repro_torch.optim import adamw, clip_by_global_norm, cosine_schedule

ARCHS = ["qwen3-moe-30b-a3b", "starcoder2-3b", "minicpm3-4b", "qwen2-vl-7b",
         "mamba2-370m", "zamba2-7b"]
MOE = "qwen3-moe-30b-a3b"


def _rel(a, b):
    a, b = float(a), float(b)
    return abs(a - b) / max(abs(b), 1e-30)


def _norm_rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _jnp(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def _jax_tree(arch):
    """Reduced configs of both packages and the JAX init as numpy."""
    jcfg = jax_config(arch).reduced()
    params = JM.init_params(jax.random.PRNGKey(0), jcfg)
    return get_config(arch).reduced(), jcfg, jax.tree.map(np.asarray, params)


def _tensors(rng, *shapes):
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------

def test_cosine_schedule_matches_jax():
    jfn, fn = jcosine(3e-3, 50, warmup=5), cosine_schedule(3e-3, 50, warmup=5)
    for step in (0, 1, 4, 5, 6, 17, 49, 50, 80):
        assert _rel(fn(torch.tensor(step, dtype=torch.int32)),
                    jfn(jnp.int32(step))) <= 1e-6, step


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clip_by_global_norm_matches_jax(max_norm):
    g = _tensors(np.random.default_rng(0), (8, 4), (3,), (2, 5, 2))
    jg, jgn = jclip({f"g{i}": jnp.asarray(a) for i, a in enumerate(g)},
                    max_norm)
    tg, gn = clip_by_global_norm(
        {f"g{i}": torch.from_numpy(a.copy()) for i, a in enumerate(g)},
        max_norm)
    assert _rel(gn, jgn) <= 1e-6
    for k in tg:
        np.testing.assert_allclose(tg[k].numpy(), np.asarray(jg[k]),
                                   rtol=1e-6, atol=0)


def test_adamw_five_updates_match_jax():
    """Five updates from the same params and grads, decay on every leaf,
    the clip active on some steps: params, moments and step equal JAX's."""
    rng = np.random.default_rng(1)
    p0 = dict(zip(("w", "norm", "emb"),
                  _tensors(rng, (6, 4), (4,), (10, 4))))
    grads = [dict(zip(p0, _tensors(rng, (6, 4), (4,), (10, 4))))
             for _ in range(5)]
    sched = dict(peak_lr=1e-2, total_steps=5, warmup=2)
    jopt = jadamw(jcosine(**sched), weight_decay=0.1, max_grad_norm=3.0)
    opt = adamw(cosine_schedule(**sched), weight_decay=0.1,
                max_grad_norm=3.0)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    jst = jopt.init(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    st = opt.init(tp)
    for g in grads:
        upd, jst = jopt.update({k: jnp.asarray(v) for k, v in g.items()},
                               jst, jp)
        jp = jax.tree.map(lambda a, u: a + u, jp, upd)
        opt.update({k: torch.from_numpy(v.copy()) for k, v in g.items()},
                   st, tp)
    assert int(st.step) == int(jst.step) == 5
    assert st.step.dtype == torch.int32
    for k in p0:
        for got, want in ((tp[k], jp[k]), (st.mu[k], jst.mu[k]),
                          (st.nu[k], jst.nu[k])):
            assert _norm_rel(got.numpy(), want) <= 1e-6, k


def test_loader_is_seeded_per_step():
    """``get_batch(step)`` draws from ``default_rng((seed, step))``: the
    same step gives the same batch, another step or seed another; targets
    are the tokens shifted by one."""
    cfg = get_config(MOE).reduced()
    loader = pipeline.make_loader(cfg, 3, 12, seed=2)
    a, b = loader.get_batch(5), loader.get_batch(5)
    for k in ("tokens", "targets"):
        assert a[k].dtype == np.int32 and a[k].shape == (3, 12)
        np.testing.assert_array_equal(a[k], b[k])
    np.testing.assert_array_equal(a["tokens"][:, 1:], a["targets"][:, :-1])
    assert (a["tokens"] < cfg.vocab_size).all() and (a["tokens"] >= 0).all()
    assert not np.array_equal(a["tokens"], loader.get_batch(6)["tokens"])
    other = pipeline.make_loader(cfg, 3, 12, seed=3).get_batch(5)
    assert not np.array_equal(a["tokens"], other["tokens"])
    it = iter(loader)
    np.testing.assert_array_equal(next(it)["tokens"],
                                  loader.get_batch(0)["tokens"])


# ---------------------------------------------------------------------------
# the MoE aux loss
# ---------------------------------------------------------------------------

def test_load_balance_aux_loss_matches_jax():
    rng = np.random.default_rng(2)
    logits = rng.standard_normal((64, 8)).astype(np.float32)
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    idx = np.argsort(-probs, -1)[:, :2].astype(np.int32)
    want = jgating.load_balance_aux_loss(jnp.asarray(probs),
                                         jnp.asarray(idx), 8)
    got = gating.load_balance_aux_loss(torch.from_numpy(probs),
                                       torch.from_numpy(idx), 8)
    assert _rel(got, want) <= 1e-6


def test_aux_loss_for_matches_jax():
    cfg, jcfg, tree = _jax_tree(MOE)
    layer = {k: v[0] for k, v in tree["blocks"]["moe"].items()}
    x = np.random.default_rng(3).standard_normal(
        (32, cfg.d_model)).astype(np.float32)
    want = jmoe.aux_loss_for({k: jnp.asarray(v) for k, v in layer.items()},
                             jnp.asarray(x), jcfg)
    got = moe.aux_loss_for({k: torch.from_numpy(v) for k, v in layer.items()},
                           torch.from_numpy(x), cfg)
    assert _rel(got, want) <= 1e-6


# ---------------------------------------------------------------------------
# loss and gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax(arch):
    """``loss_fn`` and every leaf's gradient against ``jax.value_and_grad``
    of JAX's ``loss_fn`` on the same weights (aux 0.01 on the MoE arch)."""
    cfg, jcfg, tree = _jax_tree(arch)
    batch = M.make_batch(np.random.default_rng(4), cfg, 2, 16, "train")
    aux = 0.01 if cfg.is_moe else 0.0
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: JM.loss_fn(p, b, jcfg, aux_coef=aux)))(
            jax.tree.map(jnp.asarray, tree), _jnp(batch))
    model = params_from_numpy(tree, cfg, device="cpu")
    params = M.set_trainable(model)
    loss = M.loss_fn(model, batch, cfg, aux_coef=aux)
    grads = torch.autograd.grad(loss, list(params.values()),
                                allow_unused=True, materialize_grads=True)
    assert _rel(loss.detach(), jloss) <= 1e-5
    want = _unstack(jax.tree.map(np.asarray, jgrads))
    assert sorted(want) == sorted(params)
    for name, g in zip(params, grads):
        assert _norm_rel(g.numpy(), want[name]) <= 1e-4, name


def test_train_steps_match_jax():
    """Three ``make_train_step`` steps (AdamW, cosine with warmup, aux
    0.01) against JAX's on the same loader batches."""
    cfg, jcfg, tree = _jax_tree(MOE)
    loader = pipeline.make_loader(cfg, 2, 16, seed=5)
    sched = dict(peak_lr=3e-3, total_steps=3, warmup=2)
    jopt = jadamw(jcosine(**sched))
    jstep = jax.jit(JM.make_train_step(jcfg, jopt, aux_coef=0.01))
    jp = jax.tree.map(jnp.asarray, tree)
    jst = jopt.init(jp)
    opt = adamw(cosine_schedule(**sched))
    model = params_from_numpy(tree, cfg, device="cpu")
    st = opt.init(M.trainable(model))
    step = M.make_train_step(cfg, opt, aux_coef=0.01)
    for i in range(3):
        batch = loader.get_batch(i)
        jp, jst, jloss = jstep(jp, jst, _jnp(batch))
        loss = step(model, st, batch)
        assert _rel(loss, jloss) <= 1e-5, i
        assert float(opt.last_grad_norm) > 0
    got = _unstack(params_to_numpy(model))
    want = _unstack(jax.tree.map(np.asarray, jp))
    start = _unstack(tree)
    for name in start:
        assert _norm_rel(got[name] - start[name],
                         want[name] - start[name]) <= 1e-3, name
    assert int(st.step) == int(jst.step) == 3


def test_train_step_refuses_ep_and_keeps_thresholds_frozen():
    """The name dates from when ``make_train_step`` refused an EP context.
    Training over EP is ported (``tests/test_torch_train_world.py``);
    the refusal left is a sparsity policy without an EP context (off EP
    the loss under a policy takes no gradient). A prepared layer's
    ``thresholds`` is no trainable leaf (it is not one of the JAX tree's
    gradients)."""
    cfg, _, tree = _jax_tree(MOE)
    from repro_torch.core.policy import NoDrop
    with pytest.raises(ValueError):
        M.make_train_step(cfg, adamw(), policy=NoDrop())
    model = params_from_numpy(tree, cfg, device="cpu")
    for b in model.blocks:
        b.moe.load_weights(dict(b.moe.weights(),
                                thresholds=torch.tensor([0.1, 0.2])))
    params = M.set_trainable(model)
    assert not any(k.endswith("thresholds") for k in params)
    assert not model.blocks[0].moe.thresholds.requires_grad
    assert len(params) == len(list(model.parameters())) - cfg.n_layers


def test_training_forward_launches_no_kernel():
    """The differentiable route calls no kernel wrapper (on the CPU, no
    plain version stands in for one either), on the MoE and Mamba2
    paths, and the loss under a policy takes no gradient."""
    names = ("fused_moe_pipeline", "grouped_swiglu", "ssd_chunk")
    before = {n: getattr(ops, n + "_ref").calls for n in names}
    for arch in ("mamba2-370m", MOE):
        cfg, _, tree = _jax_tree(arch)
        model = params_from_numpy(tree, cfg, device="cpu")
        M.set_trainable(model)
        batch = M.make_batch(np.random.default_rng(6), cfg, 2, 16, "train")
        loss = M.loss_fn(model, batch, cfg, aux_coef=0.01)
        assert loss.requires_grad
    assert {n: getattr(ops, n + "_ref").calls for n in names} == before
    assert not M.loss_fn(model, batch, cfg, policy=NoDrop()).requires_grad


def test_policy_loss_matches_jax():
    """``loss_fn`` under ``2t`` (calibrated to a 25% drop) on prepared
    weights, the paper's accuracy-side reading (as
    ``tests/test_system.py`` takes it in JAX): equal to JAX's, and off the
    unprepared model's loss."""
    cfg, jcfg, tree = _jax_tree(MOE)
    params = jax.tree.map(jnp.asarray, tree)
    calib = np.random.default_rng(7).standard_normal(
        (256, cfg.d_model)).astype(np.float32) * 0.7
    jpol = jax_make_policy("2t", jcfg.dualsparse, drop_target=0.25)
    tparams, jpol = jpol.prepare(params, jcfg, jnp.asarray(calib))
    dist = JDist(mesh=make_host_mesh(1), moe_impl="dispatch", policy=jpol)
    batch = M.make_batch(np.random.default_rng(8), cfg, 2, 32, "train")
    want = JM.loss_fn(tparams, _jnp(batch), jcfg, dist=dist)
    base = JM.loss_fn(params, _jnp(batch), jcfg)
    model = params_from_numpy(jax.tree.map(np.asarray, tparams), cfg,
                              device="cpu")
    tpol = TwoTDrop.from_config(cfg.dualsparse)
    tpol = TwoTDrop(partition_p=tpol.partition_p, importance=tpol.importance,
                    t_major=float(jpol.t_major), t_minor=float(jpol.t_minor))
    got = M.loss_fn(model, batch, cfg, policy=tpol)
    assert _rel(got, want) <= 1e-5
    assert _rel(got, base) > 1e-4


def _small_moe(cls, ds_cls):
    return cls(arch_id="moe-tiny", family="moe", source="tests",
               n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=64,
               vocab_size=256, n_experts=8, top_k=2, d_expert=64,
               dualsparse=ds_cls(enabled=True))


def test_complete_transform_same_ce_at_init_in_both_packages():
    """Fig. 4's twin: the P=2 complete transformation (2E experts,
    top-2K, half width) computes the same function at init, so its cross
    entropy equals the original's, in both packages, and the packages
    agree."""
    jcfg = _small_moe(JModelConfig, JDualSparse)
    cfg = _small_moe(ModelConfig, DualSparseConfig)
    wide = dict(n_experts=16, top_k=4, d_expert=32)
    jcfg_p, cfg_p = (dataclasses.replace(jcfg, **wide),
                     dataclasses.replace(cfg, **wide))
    params = JM.init_params(jax.random.PRNGKey(0), jcfg)
    blocks = dict(params["blocks"])
    blocks["moe"] = jax.vmap(
        lambda mp: jpartition.complete_transform(mp, 2))(blocks["moe"])
    params_p = dict(params, blocks=blocks)
    batch = M.make_batch(np.random.default_rng(9), cfg, 2, 16, "train")
    j_orig = JM.loss_fn(params, _jnp(batch), jcfg)
    j_part = JM.loss_fn(params_p, _jnp(batch), jcfg_p)

    model = params_from_numpy(jax.tree.map(np.asarray, params), cfg,
                              device="cpu")
    t_orig = M.loss_fn(model, batch, cfg)
    with torch.no_grad():
        for b in model.blocks:
            b.moe.load_weights(partition.complete_transform(b.moe.weights(),
                                                            2))
    t_part = M.loss_fn(model, batch, cfg_p)
    assert tuple(model.blocks[0].moe.w1.shape) == (16, 64, 32)
    assert _rel(t_part, t_orig) <= 1e-5
    assert _rel(j_part, j_orig) <= 1e-5
    assert _rel(t_orig, j_orig) <= 1e-5
    assert _rel(t_part, j_part) <= 1e-5


# ---------------------------------------------------------------------------
# the kernels have no backward
# ---------------------------------------------------------------------------

def _kernel_calls(grad_x):
    """One call of each wrapper on small CPU operands, x requiring grad
    when ``grad_x``."""
    g = torch.Generator().manual_seed(0)

    def rnd(*s):
        return torch.randn(*s, generator=g)
    E, C, d, f, T = 2, 4, 8, 8, 4
    w1, w3, w2 = rnd(E, d, f), rnd(E, d, f), rnd(E, f, d)
    i32 = dict(dtype=torch.int32)
    xf = rnd(T, d).requires_grad_(grad_x)
    xg = rnd(E, C, d).requires_grad_(grad_x)
    xs = rnd(2, 1, 4, 4).requires_grad_(grad_x)
    return {
        "fused_moe_pipeline": lambda: ops.fused_moe_pipeline(
            xf, w1, w3, w2, torch.tensor([0, 2], **i32),
            torch.tensor([2, 2], **i32), torch.zeros(2, **i32),
            torch.tensor([0, 1, 2, 3, 0, 0], **i32), torch.ones(6),
            capacity=2, block_c=2),
        "grouped_swiglu": lambda: ops.grouped_swiglu(
            xg, w1, w3, w2, torch.tensor([4, 2], **i32),
            torch.zeros(2, **i32)),
        "ssd_chunk": lambda: ops.ssd_chunk(
            xs, torch.rand(2, 1, 4, generator=g) + 0.1,
            -torch.rand(2, generator=g) - 0.5, rnd(1, 1, 4, 4),
            rnd(1, 1, 4, 4)),
    }


@pytest.mark.parametrize("name", ["fused_moe_pipeline", "grouped_swiglu",
                                  "ssd_chunk"])
def test_kernel_wrapper_raises_on_operand_requiring_grad(name):
    """A kernel has no backward: its wrapper refuses an operand that
    requires grad while autograd records, never running the plain version
    in its place; without grad mode (or grad) it runs."""
    ref = getattr(ops, name + "_ref")
    calls = ref.calls
    with pytest.raises(RuntimeError, match="no backward"):
        _kernel_calls(True)[name]()
    assert ref.calls == calls
    with torch.no_grad():
        _kernel_calls(True)[name]()
    _kernel_calls(False)[name]()
    assert ref.calls == calls + 2


def test_kernel_route_refuses_training_weights():
    """The serving route's MoE layer on weights that require grad raises
    (the fused pipeline's plain version stands in for the kernel on the
    CPU, behind the same guard), instead of returning an output with no
    gradient to the experts."""
    cfg, _, tree = _jax_tree(MOE)
    model = params_from_numpy(tree, cfg, device="cpu")
    M.set_trainable(model)
    x = torch.randn(1, 4, cfg.d_model)
    with pytest.raises(RuntimeError, match="no backward"):
        TT._moe_forward(model.blocks[0].moe, x, cfg,
                        NoDrop(use_kernel=True))


def test_quirk_reference_fused_pipeline_has_no_gradient():
    """A finding in the reference, not a port fault: ``pallas_call`` has
    no transpose rule and the JAX package defines no ``custom_vjp``, so
    ``jax.grad`` through the fused pipeline (the route
    ``prefer_fused_pipeline`` picks on every accelerator) raises
    ``NotImplementedError``; the JAX package trains only on the buffer
    path, the route the port's training takes. The port's kernel route
    raises instead of dropping the gradient; its training route matches
    JAX's buffer-path gradient."""
    cfg, jcfg, tree = _jax_tree(MOE)
    layer = {k: v[0] for k, v in tree["blocks"]["moe"].items()}
    x = np.random.default_rng(10).standard_normal(
        (8, cfg.d_model)).astype(np.float32)
    jlayer = {k: jnp.asarray(v) for k, v in layer.items()}

    def jloss(mp, fused):
        y = jmoe.moe_forward_dispatch(mp, jnp.asarray(x), jcfg,
                                      fused_pipeline=fused)
        return jnp.sum(y ** 2)
    with pytest.raises(NotImplementedError):
        jax.grad(functools.partial(jloss, fused=True))(jlayer)
    want = jax.grad(functools.partial(jloss, fused=False))(jlayer)

    tlayer = {k: torch.from_numpy(v.copy()).requires_grad_()
              for k, v in layer.items()}
    with pytest.raises(RuntimeError, match="no backward"):
        moe.moe_forward_dispatch(tlayer, torch.from_numpy(x), cfg,
                                 fused_pipeline=True)
    y = moe.moe_forward_dispatch(tlayer, torch.from_numpy(x), cfg,
                                 fused_pipeline=False)
    grads = torch.autograd.grad(torch.sum(y ** 2), list(tlayer.values()))
    for (k, _), g in zip(tlayer.items(), grads):
        assert _norm_rel(g.numpy(), np.asarray(want[k])) <= 1e-4, k
