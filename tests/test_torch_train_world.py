"""Training over expert parallelism: the port's gradients and train steps
in a world of 4 ranks against the JAX package's on a 4-device host mesh.

Two subprocesses, each with its own timeout: this file run as a program
in ``jax`` mode (XLA forced to 4 host devices) prepares layers and small
models from numpy seeds, takes ``jax.grad`` through ``setp_moe_forward``
/ ``etp_moe_forward``, runs ``loss_fn`` and two ``make_train_step`` steps
with an EP ``DistContext`` and Whisper's forward under one, and writes
the trees, its results and a checkpoint; in ``torch`` mode it spawns 4
ranks over gloo (a ``FileStore`` in the test's temporary directory, no
port) that load the same trees, each rank its own expert shard, and write
theirs. The tests compare:
  * layer level (olmoe-lite's layer, ``LAYER_CUT``), float32 wire: the
    gradients of S-ETP (x, the router,
    every expert, un-placed to id order) on (data 2, model 2) and (1, 4),
    prefill-shaped (sequence split over ``model``) and decode-shaped
    (replicated there), B = 1 on (2, 2) (replicated over ``data``),
    ``load_aware`` and keep-all; and of ETP on (ep 2, tp 2): within 1e-5
    of each gradient's largest magnitude. A boundary gather whose
    backward summed over ranks would be 4x off, a collective that cut the
    gradient would leave zeros;
  * model level, bf16 wire (the default), 2 such layers (olmoe-lite,
    ``MODEL_CUT``), placed for the EP size under ``NoDrop`` (JAX's default
    ``DistContext``), on
    (2, 2) and (1, 4): ``loss_fn`` with aux and every gradient, the clip's
    global norm (the expert shards' share summed over ``model`` only) and
    two AdamW steps with the clip active, within the bars below;
  * ``remat`` "none" and "dots" against no remat: the same gradients bit
    for bit;
  * the sharded checkpoint: the port's restores in JAX's
    ``restore_checkpoint`` (the global arrays, bitwise the port's), JAX's
    restores in the port (each rank its shard, bitwise), and the port's
    own round trip;
  * Whisper under a (1, 4) context with ``remat`` (a narrow config past
    1024 tokens too, the decoder's blockwise query block split per model
    rank): logits and gradients within 1e-5 of JAX's.

Model-level bars (``BARS``), measured on seed 0:
  * float32 wire, (1, 4): loss rel 1e-5 (measured 1.3e-7), every gradient
    norm-rel 1e-5 (1.2e-6), each leaf's update after two steps norm-rel
    1e-3 (4.4e-5, ``test_torch_train.py``'s bar): the same float32 math;
  * bf16 wire, (2, 2): loss rel 1e-4 (1.1e-6 at step 1, 5.6e-6 at step
    2), gradients norm-rel 1e-2 (5.8e-3), updates norm-rel 0.15 (6.3e-2)
    with at most 1% of a leaf's elements (0.39%) off by more than half
    its largest update. Both packages round x, the experts, each expert
    output and the cotangents flowing back through them to bf16 at the
    same points, from float32 values summed in other orders, so some
    elements land one bf16 ulp apart; AdamW's first steps move every
    element by about the learning rate whatever its gradient's size, so
    a gradient element near zero whose sign differs moves the other way.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

HERE = Path(__file__).resolve()
ROOT = HERE.parents[1]
WORLD = 4
TIMEOUT = 300
ARCH = "olmoe-lite"
F32_TOL = 1e-5
BARS = {"float32": dict(loss=1e-5, grad=1e-5, update=1e-3, moved=0.0),
        "bfloat16": dict(loss=1e-4, grad=1e-2, update=0.15, moved=0.01)}

# (name, mesh shape, (B, S), policy): the layer-level S-ETP cases
LAYER_CASES = [
    ("prefill_2x2", (2, 2), (2, 8), "load_aware"),
    ("decode_2x2", (2, 2), (4, 1), "load_aware"),
    ("prefill_1x4", (1, 4), (2, 8), "load_aware"),
    ("decode_1x4", (1, 4), (8, 1), "keep_all"),
    ("keep_all_prefill_1x4", (1, 4), (2, 8), "keep_all"),
    # B = 1 does not divide over data = 2: the batch is replicated there
    ("b1_2x2", (2, 2), (1, 8), "load_aware"),
]
LAYER_CAPS = dict(cap_factor=4.0, local_cap_factor=8.0)
# (mesh, wire): JAX's DistContext trains at the bf16 wire; the float32
# case (``setp_moe_forward``'s default wire patched in both packages' runs)
# shows the bf16 case's gap is that rounding
MODEL_CASES = [((2, 2), "bfloat16"), ((1, 4), "float32")]
MODEL_MESHES = [c[0] for c in MODEL_CASES]
# olmoe-lite's layer cut to 16 experts of 64 neurons (top-8 of 16; the
# sub-experts still split over 4 ranks), so that the trees, gradients and
# four checkpoints the two runs write stay a few MB; the model level is 2
# such layers
LAYER_CUT = dict(n_experts=16, d_expert=64)
MODEL_CUT = dict(n_layers=2)
MODEL_B, MODEL_S = 4, 16
AUX, LR, CLIP = 0.01, 1e-3, 0.1
# Whisper: the reduced config, and a narrow one past 1024 tokens
WHISPER = {"reduced": ({}, 2, 16),
           "blockwise": (dict(d_model=64, n_heads=2, n_kv_heads=2, d_ff=128,
                              vocab_size=64, n_layers=1, encoder_layers=1,
                              n_frontend_tokens=1100), 1, 1032)}
EXPERTS = ("w1", "w3", "w2")


def _inputs():
    """The layer (router sharpened so 2T drops), each case's tokens and
    output cotangent, the calibration rows, the ETP case and the model
    batches, from one numpy seed."""
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config(ARCH), **LAYER_CUT)
    rng = np.random.default_rng(0)
    d, E, f = cfg.d_model, cfg.n_experts, cfg.d_expert

    def normal(*shape, scale=0.02):
        return (rng.normal(size=shape) * scale).astype(np.float32)
    layer = dict(wg=normal(d, E, scale=0.4), w1=normal(E, d, f),
                 w3=normal(E, d, f), w2=normal(E, f, d))
    xs = {name: (normal(B, S, d, scale=0.5), normal(B, S, d, scale=1.0))
          for name, _, (B, S), _ in LAYER_CASES}
    xs["etp"] = (normal(4, 4, d, scale=0.5), normal(4, 4, d, scale=1.0))
    calib = normal(128, d, scale=0.5)
    batches = [{"tokens": rng.integers(0, cfg.vocab_size, (MODEL_B, MODEL_S),
                                       dtype=np.int32),
                "targets": rng.integers(0, cfg.vocab_size,
                                        (MODEL_B, MODEL_S), dtype=np.int32)}
               for _ in range(2)]
    return layer, xs, calib, batches


def _whisper_batch(cfg, B, S, seed=5):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, S),
                                   dtype=np.int32),
            "targets": rng.integers(0, cfg.vocab_size, (B, S),
                                    dtype=np.int32),
            "audio_embeds": (rng.standard_normal(
                (B, cfg.n_frontend_tokens, cfg.d_model)) * 0.1).astype(
                    np.float32)}


def _unplace(w, n_dev):
    """Placement order -> sub-expert id order."""
    L = w.shape[0] // n_dev
    return w.reshape((n_dev, L) + w.shape[1:]).swapaxes(0, 1).reshape(
        w.shape)


def _flat(tree, prefix):
    """A nested dict of arrays as {prefix.path: array}."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}.{k}"))
        else:
            out[f"{prefix}.{k}"] = np.asarray(v)
    return out


def _tree(arrays, prefix):
    """The nested dict under ``prefix.`` of a flat dict of arrays."""
    tree = {}
    for key in arrays:
        if key.startswith(prefix + "."):
            node = tree
            *path, leaf = key[len(prefix) + 1:].split(".")
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = arrays[key]
    return tree


def _named(arrays, prefix):
    """{port parameter name: array} of a flat JAX tree under ``prefix``:
    the stacked ``blocks`` / ``encoder`` / ``decoder`` leaves split into
    their layers."""
    out = {}
    for key in arrays:
        if not key.startswith(prefix + "."):
            continue
        name = key[len(prefix) + 1:]
        head, _, rest = name.partition(".")
        if head in ("blocks", "encoder", "decoder"):
            for i in range(arrays[key].shape[0]):
                out[f"{head}.{i}.{rest}"] = arrays[key][i]
        else:
            out[name] = arrays[key]
    return out


# ---------------------------------------------------------------------------
# jax mode
# ---------------------------------------------------------------------------

def jax_main(out: Path) -> None:
    import jax
    import jax.numpy as jnp

    from repro.checkpoint import save_checkpoint
    from repro.configs import get_config
    from repro.core import policy as P
    from repro.core import setp
    from repro.launch.mesh import make_mesh_auto, use_mesh
    from repro.models import model as M
    from repro.models import whisper as W
    from repro.models.transformer import DistContext
    from repro.optim import adamw

    cfg = dataclasses.replace(get_config(ARCH), **LAYER_CUT)
    layer, xs, calib, batches = _inputs()
    jl = {k: jnp.asarray(v) for k, v in layer.items()}
    arrays, res = {}, {}
    pols = {"load_aware": P.make_policy("load_aware", cfg.dualsparse),
            "keep_all": P.TwoTDrop(partition_p=2, t_major=-1.0,
                                   t_minor=-1.0)}
    prepared = {}
    for name, pol in list(pols.items()):
        prepared[name], pols[name] = pol.prepare(jl, cfg, jnp.asarray(calib))
        arrays.update({f"{name}.{k}": np.asarray(prepared[name][k])
                       for k in ("wg",) + EXPERTS})

    for name, shape, _, pol in LAYER_CASES:
        mesh = make_mesh_auto(shape, ("data", "model"))
        placed = setp.place_params_strided(
            {k: prepared[pol][k] for k in ("wg",) + EXPERTS}, shape[1])
        x, r = (jnp.asarray(a) for a in xs[name])

        def loss(x, wg, w1, w3, w2, mesh=mesh, pol=pol, r=r):
            y = setp.setp_moe_forward(
                {"wg": wg, "w1": w1, "w3": w3, "w2": w2}, x, cfg, mesh,
                policy=pols[pol], wire_dtype=jnp.float32, **LAYER_CAPS)
            return jnp.sum(y * r)
        with use_mesh(mesh):
            g = jax.jit(jax.grad(loss, argnums=(0, 1, 2, 3, 4)))(
                x, placed["wg"], *(placed[k] for k in EXPERTS))
        arrays[f"g.{name}.x"], arrays[f"g.{name}.wg"] = map(np.asarray,
                                                            g[:2])
        for k, gk in zip(EXPERTS, g[2:]):
            arrays[f"g.{name}.{k}"] = _unplace(np.asarray(gk), shape[1])

    mesh = make_mesh_auto((2, 2), ("ep", "tp"))
    x, r = (jnp.asarray(a) for a in xs["etp"])

    def etp_loss(x, wg, w1, w3, w2):
        y = setp.etp_moe_forward({"wg": wg, "w1": w1, "w3": w3, "w2": w2},
                                 x, cfg, mesh, **LAYER_CAPS)
        return jnp.sum(y * r)
    with use_mesh(mesh):
        g = jax.jit(jax.grad(etp_loss, argnums=(0, 1, 2, 3, 4)))(
            x, *(jl[k] for k in ("wg",) + EXPERTS))
    for k, gk in zip(("x", "wg") + EXPERTS, g):
        arrays[f"g.etp.{k}"] = np.asarray(gk)

    # the model level: NoDrop placed for the EP size
    mcfg = dataclasses.replace(cfg, **MODEL_CUT)
    params = M.init_params(jax.random.PRNGKey(0), mcfg)
    for shape, wire in MODEL_CASES:
        tag = f"{shape[0]}{shape[1]}"
        setp.setp_moe_forward.__kwdefaults__["wire_dtype"] = getattr(jnp,
                                                                     wire)
        tp, _ = P.NoDrop().prepare(params, mcfg, jnp.asarray(calib),
                                   n_ep_devices=shape[1])
        arrays.update(_flat(jax.tree.map(np.asarray, tp), f"model{tag}"))
        mesh = make_mesh_auto(shape, ("data", "model"))
        dist = DistContext(mesh=mesh, moe_impl="setp")
        jb = [{k: jnp.asarray(v) for k, v in b.items()} for b in batches]
        opt = adamw(LR, max_grad_norm=CLIP)
        with use_mesh(mesh):
            loss, grads = jax.jit(jax.value_and_grad(
                lambda p: M.loss_fn(p, jb[0], mcfg, dist=dist,
                                    aux_coef=AUX)))(tp)
            step = jax.jit(M.make_train_step(mcfg, opt, dist=dist,
                                             aux_coef=AUX))
            p, st, losses = tp, opt.init(tp), []
            for b in jb:
                p, st, loss_i = step(p, st, b)
                losses.append(float(loss_i))
        grads = jax.tree.map(np.asarray, grads)
        arrays.update(_flat(grads, f"grad{tag}"))
        res[f"loss{tag}"] = float(loss)
        res[f"gnorm{tag}"] = float(np.sqrt(sum(
            np.sum(np.square(g.astype(np.float64)))
            for g in jax.tree.leaves(grads))))
        res[f"losses{tag}"] = losses
        arrays.update(_flat(jax.tree.map(np.asarray, p), f"after{tag}"))
        arrays.update(_flat(jax.tree.map(np.asarray, st.mu), f"mu{tag}"))
        save_checkpoint(str(out / f"ckpt_jax{tag}"), 2,
                        {"params": p, "opt": st})
    setp.setp_moe_forward.__kwdefaults__["wire_dtype"] = jnp.bfloat16

    # Whisper under a (1, 4) context with remat
    mesh = make_mesh_auto((1, 4), ("data", "model"))
    dist = DistContext(mesh=mesh, moe_impl="setp", remat=True)
    for name, (narrow, B, S) in WHISPER.items():
        wcfg = dataclasses.replace(get_config("whisper-large-v3").reduced(),
                                   **narrow)
        wp = M.init_params(jax.random.PRNGKey(3), wcfg)
        arrays.update(_flat(jax.tree.map(np.asarray, wp), f"wparams.{name}"))
        b = {k: jnp.asarray(v) for k, v in _whisper_batch(wcfg, B, S).items()}
        with use_mesh(mesh):
            logits = jax.jit(lambda p: W.forward(p, b, wcfg, dist=dist))(wp)
            g = jax.jit(jax.grad(lambda p: M.loss_fn(p, b, wcfg,
                                                     dist=dist)))(wp)
        arrays[f"wlogits.{name}"] = np.asarray(logits)
        arrays.update(_flat(jax.tree.map(np.asarray, g), f"wgrad.{name}"))
    np.savez(out / "jax.npz", **arrays)
    (out / "jax.json").write_text(json.dumps(res))


# ---------------------------------------------------------------------------
# torch mode: 4 ranks over gloo
# ---------------------------------------------------------------------------

def _grads(loss, leaves):
    return [g.detach() for g in torch.autograd.grad(loss, leaves)]


def _layer_cases(ctxs, ref, xs, cfg, arrays) -> None:
    from repro_torch.core import policy as P
    from repro_torch.core import setp
    pols = {"load_aware": P.make_policy("load_aware", cfg.dualsparse),
            "keep_all": P.TwoTDrop(partition_p=2, t_major=-1.0,
                                   t_minor=-1.0)}
    for name, shape, _, pol in LAYER_CASES:
        ctx = ctxs[shape]
        n_dev = ctx.size("model")
        placed = setp.place_params_strided(
            {k: torch.from_numpy(ref[f"{pol}.{k}"])
             for k in ("wg",) + EXPERTS}, n_dev)
        shard = setp.expert_shard(placed, n_dev, ctx.coord("model"))
        x, r = (torch.from_numpy(a) for a in xs[name])
        leaves = [x.requires_grad_()] + [shard[k].requires_grad_()
                                         for k in ("wg",) + EXPERTS]
        y = setp.setp_moe_forward(dict(zip(("wg",) + EXPERTS, leaves[1:])),
                                  x, cfg, ctx, policy=pols[pol],
                                  wire_dtype=torch.float32, kernels=False,
                                  **LAYER_CAPS)
        c = f"{ctx.coord('data')}{ctx.coord('model')}"
        for k, g in zip(("x", "wg") + EXPERTS, _grads((y * r).sum(),
                                                      leaves)):
            arrays[f"g.{name}.{k}.{c}"] = g.numpy()


def _etp_case(ctx, layer, xs, cfg, arrays, rank) -> None:
    from repro_torch.core import setp
    full = {k: torch.from_numpy(layer[k]).requires_grad_()
            for k in ("wg",) + EXPERTS}
    x, r = (torch.from_numpy(a) for a in xs["etp"])
    x.requires_grad_()
    y = setp.etp_moe_forward(setp.etp_shard(full, ctx), x, cfg, ctx,
                             **LAYER_CAPS)
    leaves = [x] + [full[k] for k in ("wg",) + EXPERTS]
    for k, g in zip(("x", "wg") + EXPERTS, _grads((y * r).sum(), leaves)):
        arrays[f"g.etp.{k}.{rank}"] = g.numpy()


def _model_cases(ctxs, ref, batches, cfg, out, arrays, res) -> None:
    from repro_torch.checkpoint.from_numpy import (params_from_numpy,
                                                   params_to_numpy)
    from repro_torch.core import setp
    from repro_torch.core.policy import NoDrop
    from repro_torch.launch.train import restore_state, save_state
    from repro_torch.models import model as M
    from repro_torch.optim import adamw
    from repro_torch.optim.adamw import global_norm
    mcfg = dataclasses.replace(cfg, **MODEL_CUT)
    for shape, wire in MODEL_CASES:
        tag = f"{shape[0]}{shape[1]}"
        ctx = ctxs[shape]
        tree = _tree(ref, f"model{tag}")
        setp.setp_moe_forward.__kwdefaults__["wire_dtype"] = getattr(torch,
                                                                     wire)

        def fresh():
            return params_from_numpy(tree, mcfg, device="cpu", dist=ctx)
        model = fresh()
        names = M.expert_shard_names(model)
        params = M.set_trainable(model)
        grads = {}
        for remat in (None, "none", "dots"):
            d = ctx if remat is None else dataclasses.replace(
                ctx, remat=True, remat_policy=remat)
            with torch.enable_grad():
                loss = M.loss_fn(model, batches[0], mcfg, aux_coef=AUX,
                                 dist=d, policy=NoDrop())
                grads[remat] = dict(zip(params, _grads(
                    loss, list(params.values()))))
            res[f"loss{tag}.{remat}"] = float(loss.detach())
        res[f"remat_equal{tag}"] = {
            str(k): all(torch.equal(grads[k][n], grads[None][n])
                        for n in params) for k in ("none", "dots")}
        res[f"gnorm{tag}"] = float(global_norm(grads[None], ctx, names))
        c = res[f"coord{tag}"] = f"{ctx.coord('data')}{ctx.coord('model')}"
        for n, g in grads[None].items():
            arrays[f"grad{tag}.{n}.{c}"] = g.numpy()

        opt = adamw(LR, max_grad_norm=CLIP)
        st = opt.init(M.trainable(model))
        step = M.make_train_step(mcfg, opt, aux_coef=AUX, dist=ctx)
        res[f"losses{tag}"] = [float(step(model, st, b)) for b in batches]
        res[f"step_gnorm{tag}"] = float(opt.last_grad_norm)
        after = params_to_numpy(model, ctx)
        arrays.update({f"after{tag}.{k}.{c}": v
                       for k, v in _flat(after, "p").items()})
        # the sharded checkpoint: the port's round trip, then JAX's
        ckpt_dir = str(out / f"ckpt_port{tag}")
        save_state(ckpt_dir, 2, model, st, dist=ctx)
        m2 = fresh()
        st2 = opt.init(M.trainable(m2))
        restore_state(ckpt_dir, m2, st2, dist=ctx)
        res[f"round_trip{tag}"] = all(
            torch.equal(a, b) for a, b in zip(m2.parameters(),
                                              model.parameters())) and all(
            torch.equal(st2.mu[k], st.mu[k]) and torch.equal(st2.nu[k],
                                                             st.nu[k])
            for k in st.mu) and int(st2.step) == 2
        restore_state(str(out / f"ckpt_jax{tag}"), m2, st2, dist=ctx)
        for n, p in m2.named_parameters():
            arrays[f"restored{tag}.{n}.{c}"] = p.detach().numpy()
            arrays[f"restored_mu{tag}.{n}.{c}"] = st2.mu[n].numpy()
        res[f"restored_step{tag}"] = int(st2.step)
    setp.setp_moe_forward.__kwdefaults__["wire_dtype"] = torch.bfloat16


def _whisper_cases(ctx, ref, arrays) -> None:
    from repro_torch.checkpoint.from_numpy import params_from_numpy
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.models import whisper as W
    for name, (narrow, B, S) in WHISPER.items():
        wcfg = dataclasses.replace(get_config("whisper-large-v3").reduced(),
                                   **narrow)
        model = params_from_numpy(_tree(ref, f"wparams.{name}"), wcfg,
                                  device="cpu")
        batch = M.to_device(_whisper_batch(wcfg, B, S), "cpu")
        batch["tokens"] = batch["tokens"].long()
        params = M.set_trainable(model)
        with torch.enable_grad():
            logits = W.forward(model, batch, wcfg, dist=ctx)
            loss = M.cross_entropy(logits, batch["targets"])
            grads = _grads(loss, list(params.values()))
        arrays[f"wlogits.{name}.{ctx.coord('model')}"] = \
            logits.detach().numpy()
        for n, g in zip(params, grads):
            arrays[f"wgrad.{name}.{n}.{ctx.coord('model')}"] = g.numpy()


def _rank_main(rank: int, out: str) -> None:
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.distributed import DistContext, make_mesh

    torch.set_num_threads(1)
    out = Path(out)
    dist.init_process_group("gloo", store=dist.FileStore(
        str(out / "store"), WORLD), rank=rank, world_size=WORLD)
    cfg = dataclasses.replace(get_config(ARCH), **LAYER_CUT)
    layer, xs, _, batches = _inputs()
    ref = dict(np.load(out / "jax.npz"))
    ctxs = {shape: DistContext(make_mesh(shape, ("data", "model")))
            for shape in ((2, 2), (1, 4))}
    arrays, res = {}, {"rank": rank}
    _layer_cases(ctxs, ref, xs, cfg, arrays)
    _etp_case(DistContext(make_mesh((2, 2), ("ep", "tp"))), layer, xs, cfg,
              arrays, rank)
    _model_cases(ctxs, ref, batches, cfg, out, arrays, res)
    _whisper_cases(DistContext(ctxs[(1, 4)].mesh, remat=True), ref, arrays)
    np.savez(out / f"torch{rank}.npz", **arrays)
    (out / f"torch{rank}.json").write_text(json.dumps(res))
    dist.barrier()
    dist.destroy_process_group()


def torch_main(out: Path) -> None:
    import torch.multiprocessing as mp
    mp.spawn(_rank_main, args=(str(out),), nprocs=WORLD, join=True)


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------

def _run(mode: str, out: Path, **env) -> None:
    e = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
             **env)
    p = subprocess.run([sys.executable, str(HERE), mode, str(out)], env=e,
                       capture_output=True, text=True, timeout=TIMEOUT)
    assert p.returncode == 0, f"{mode} run failed:\n{p.stderr[-4000:]}"


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    out = tmp_path_factory.mktemp("train_world")
    _run("jax", out, XLA_FLAGS="--xla_force_host_platform_device_count=4")
    _run("torch", out)
    ranks = [(dict(np.load(out / f"torch{r}.npz")),
              json.loads((out / f"torch{r}.json").read_text()))
             for r in range(WORLD)]
    return (out, dict(np.load(out / "jax.npz")),
            json.loads((out / "jax.json").read_text()), ranks)


def _coords(shape):
    return [f"{d}{m}" for d in range(shape[0]) for m in range(shape[1])]


def _at(ranks, key):
    return next(a[key] for a, _ in ranks if key in a)


def _close(got, want, tol=F32_TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= tol, f"max error {err:.3e} of the largest magnitude"


def _norm_rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _assembled(ranks, prefix, shape):
    """The global expert stack (placement order) from the shards of the
    ranks at data coordinate 0; the other data rows hold the same shards
    (their gradients summed over data)."""
    rows = [[_at(ranks, f"{prefix}.{d}{m}") for m in range(shape[1])]
            for d in range(shape[0])]
    for row in rows[1:]:
        for a, b in zip(row, rows[0]):
            np.testing.assert_array_equal(a, b)
    return np.concatenate(rows[0])


@pytest.mark.parametrize("name,shape", [(c[0], c[1]) for c in LAYER_CASES],
                         ids=[c[0] for c in LAYER_CASES])
def test_setp_gradients_equal_jax(worlds, name, shape):
    """x's and the router's gradients on every rank, and every expert's
    (the shards assembled, un-placed to id order), against ``jax.grad``
    through JAX's ``shard_map``, float32 wire."""
    _, ja, _, ranks = worlds
    for c in _coords(shape):
        _close(_at(ranks, f"g.{name}.x.{c}"), ja[f"g.{name}.x"])
        _close(_at(ranks, f"g.{name}.wg.{c}"), ja[f"g.{name}.wg"])
    for k in EXPERTS:
        got = _unplace(_assembled(ranks, f"g.{name}.{k}", shape), shape[1])
        _close(got, ja[f"g.{name}.{k}"])
        assert np.abs(got).max() > 0


def test_etp_gradients_equal_jax(worlds):
    """ETP on (ep 2, tp 2): x's and the router's gradients on every rank,
    and the experts' summed over the ranks (each rank's is its slice of
    the full leaf), against ``jax.grad`` of JAX's ETP."""
    _, ja, _, ranks = worlds
    for r, (a, _) in enumerate(ranks):
        _close(a[f"g.etp.x.{r}"], ja["g.etp.x"])
        _close(a[f"g.etp.wg.{r}"], ja["g.etp.wg"])
    for k in EXPERTS:
        _close(sum(a[f"g.etp.{k}.{r}"] for r, (a, _) in enumerate(ranks)),
               ja[f"g.etp.{k}"])


def _model_grads(ja, ranks, tag, shape):
    want = _named(ja, f"grad{tag}")
    got = {}
    for n in want:
        if n.rsplit(".", 1)[-1] in EXPERTS and ".moe." in n:
            got[n] = _assembled(ranks, f"grad{tag}.{n}", shape)
        else:
            vals = [_at(ranks, f"grad{tag}.{n}.{c}") for c in _coords(shape)]
            for v in vals[1:]:
                np.testing.assert_array_equal(v, vals[0])
            got[n] = vals[0]
    return got, want


MODEL_IDS = [f"{s[0]}x{s[1]}_{w}" for s, w in MODEL_CASES]


@pytest.mark.parametrize("shape,wire", MODEL_CASES, ids=MODEL_IDS)
def test_model_loss_and_gradients_equal_jax(worlds, shape, wire):
    """``loss_fn`` with aux under the EP context and every gradient of the
    model (the expert shards assembled) against JAX's ``value_and_grad``
    of its ``loss_fn(dist=...)``; the replicated leaves' gradients equal
    on every rank; the clip's global norm JAX's."""
    _, ja, jr, ranks = worlds
    tag, bar = f"{shape[0]}{shape[1]}", BARS[wire]
    for _, r in ranks:
        assert abs(r[f"loss{tag}.None"] - jr[f"loss{tag}"]) <= \
            bar["loss"] * abs(jr[f"loss{tag}"])
        assert abs(r[f"gnorm{tag}"] - jr[f"gnorm{tag}"]) <= \
            bar["grad"] * jr[f"gnorm{tag}"]
    got, want = _model_grads(ja, ranks, tag, shape)
    assert sorted(got) == sorted(want)
    for n in want:
        assert _norm_rel(got[n], want[n]) <= bar["grad"], n


def _rank_named(a, prefix, c):
    """{port parameter name: array} of one rank's tree under ``prefix``
    written at coordinates ``c``."""
    return _named({k[:-3]: v for k, v in a.items()
                   if k.startswith(prefix + ".") and k.endswith("." + c)},
                  prefix)


@pytest.mark.parametrize("shape,wire", MODEL_CASES, ids=MODEL_IDS)
def test_two_train_steps_equal_jax(worlds, shape, wire):
    """Two ``make_train_step`` steps under the EP context (AdamW, the clip
    active: the global norm is above it) against JAX's
    ``make_train_step(dist=...)``: the losses, and each leaf's update
    after the two steps; every rank's losses and gathered leaves equal,
    bit for bit."""
    _, ja, jr, ranks = worlds
    tag, bar = f"{shape[0]}{shape[1]}", BARS[wire]
    assert jr[f"gnorm{tag}"] > CLIP
    start = _named(ja, f"model{tag}")
    want = _named(ja, f"after{tag}")
    trees = [_rank_named(a, f"after{tag}.p", r[f"coord{tag}"])
             for a, r in ranks]
    for (_, r), tree in zip(ranks, trees):
        assert r[f"losses{tag}"] == ranks[0][1][f"losses{tag}"]
        assert sorted(tree) == sorted(want)
        for n in want:
            np.testing.assert_array_equal(tree[n], trees[0][n])
    for a, b in zip(ranks[0][1][f"losses{tag}"], jr[f"losses{tag}"]):
        assert abs(a - b) <= bar["loss"] * abs(b)
    for n in want:
        got, ref = trees[0][n] - start[n], want[n] - start[n]
        assert _norm_rel(got, ref) <= bar["update"], n
        moved = np.abs(got - ref) > 0.5 * np.abs(ref).max()
        assert moved.mean() <= bar["moved"], n


@pytest.mark.parametrize("shape", MODEL_MESHES, ids=MODEL_IDS)
def test_remat_leaves_gradients_unchanged(worlds, shape):
    """``remat`` with "none" (whole blocks recomputed, the collectives
    again) and "dots" (the products without batch dims kept): the loss
    and every gradient equal those without remat, bit for bit, on every
    rank."""
    _, _, _, ranks = worlds
    tag = f"{shape[0]}{shape[1]}"
    for _, r in ranks:
        assert r[f"remat_equal{tag}"] == {"none": True, "dots": True}
        assert r[f"loss{tag}.none"] == r[f"loss{tag}.dots"] == \
            r[f"loss{tag}.None"]


@pytest.mark.parametrize("shape", MODEL_MESHES, ids=MODEL_IDS)
def test_sharded_checkpoint_restores_in_either_package(worlds, shape):
    """The port's sharded checkpoint (experts and their moments gathered
    over ``model``, written by the rank at coordinate 0) restores in JAX's
    ``restore_checkpoint`` as the port's global arrays, bitwise; JAX's
    restores in the port, each rank keeping its shard, bitwise; and the
    port's own round trip is bitwise."""
    from repro.checkpoint import restore_checkpoint
    from repro.optim.adamw import AdamWState
    out, ja, _, ranks = worlds
    tag = f"{shape[0]}{shape[1]}"
    for _, r in ranks:
        assert r[f"round_trip{tag}"] and r[f"restored_step{tag}"] == 2
    params = _tree(ja, f"model{tag}")
    target = {"params": params,
              "opt": AdamWState(step=np.zeros((), np.int32), mu=params,
                                nu=params)}
    tree = restore_checkpoint(str(out / f"ckpt_port{tag}"), target)
    got = _named(_flat(tree["params"], "p"), "p")
    port = _rank_named(ranks[0][0], f"after{tag}.p",
                       ranks[0][1][f"coord{tag}"])
    assert sorted(got) == sorted(port)
    for n in got:
        np.testing.assert_array_equal(np.asarray(got[n]), port[n])
    assert int(np.asarray(tree["opt"].step)) == 2
    # JAX's checkpoint in the port: each rank's shard of JAX's arrays
    for key, want in ((f"restored{tag}", _named(ja, f"after{tag}")),
                      (f"restored_mu{tag}", _named(ja, f"mu{tag}"))):
        for n, w in want.items():
            if n.rsplit(".", 1)[-1] in EXPERTS and ".moe." in n:
                got_n = _assembled(ranks, f"{key}.{n}", shape)
            else:
                got_n = _at(ranks, f"{key}.{n}.00")
            np.testing.assert_array_equal(got_n, w)


@pytest.mark.parametrize("name", list(WHISPER))
def test_whisper_under_a_context_equals_jax(worlds, name):
    """Whisper's forward and gradients under a (1, 4) context with
    ``remat`` against JAX's ``whisper.forward(dist=...)`` and the grad of
    its ``loss_fn``, on every rank; past 1024 tokens the decoder's
    blockwise attention takes a query block of S / 4."""
    _, ja, _, ranks = worlds
    want = _named(ja, f"wgrad.{name}")
    for m in range(WORLD):
        _close(_at(ranks, f"wlogits.{name}.{m}"), ja[f"wlogits.{name}"])
        for n, w in want.items():
            _close(_at(ranks, f"wgrad.{name}.{n}.{m}"), w)


if __name__ == "__main__":
    if sys.argv[1] == "jax":
        jax_main(Path(sys.argv[2]))
    else:
        torch_main(Path(sys.argv[2]))
