"""npz checkpoints of the port (``repro_torch.checkpoint.io``) against the
JAX package's (``repro.checkpoint``): one on-disk format, so a training
state written by either package restores in the other.

Bars: arrays restored bitwise (the files hold the float32 values as
written); a step taken after a restore equals the uninterrupted run
bitwise on the CPU within one package, and the other package's next loss
to rel 1e-5 (the float32 forward summed in another order).
"""
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as jckpt
from repro.configs import get_config as jax_config
from repro.models import model as JM
from repro.optim import adamw as jadamw
from repro_torch.checkpoint import io as ckpt
from repro_torch.checkpoint.from_numpy import (load_params,
                                               opt_state_to_numpy,
                                               params_from_numpy,
                                               params_to_numpy,
                                               train_state_spec)
from repro_torch.configs import get_config
from repro_torch.data import pipeline
from repro_torch.launch.train import restore_state, save_state
from repro_torch.models import model as M
from repro_torch.optim import adamw

MOE = "qwen3-moe-30b-a3b"
LR = 3e-3


def _flat(tree):
    """path -> numpy leaf, as JAX flattens the tree."""
    return {"/".join(str(getattr(k, "key", getattr(k, "name", k)))
                     for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port_flat(model, state):
    return _flat({"params": params_to_numpy(model),
                  "opt": opt_state_to_numpy(state)})


def _assert_equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@functools.lru_cache(maxsize=None)
def _jax_init(arch):
    jcfg = jax_config(arch).reduced()
    return jcfg, jax.tree.map(np.asarray,
                              JM.init_params(jax.random.PRNGKey(0), jcfg))


def _port(arch, n_steps=0, seed=0):
    """The port's model from the JAX init, its AdamW (constant lr), the
    train step and ``n_steps`` steps taken on the loader's batches."""
    cfg = get_config(arch).reduced()
    model = params_from_numpy(_jax_init(arch)[1], cfg, device="cpu")
    opt = adamw(LR)
    state = opt.init(M.trainable(model))
    step = M.make_train_step(cfg, opt, aux_coef=0.01 if cfg.is_moe else 0.0)
    loader = pipeline.make_loader(cfg, 2, 16, seed=seed)
    losses = [step(model, state, loader.get_batch(i)) for i in range(n_steps)]
    return cfg, model, state, step, loader, losses


def _jax_state(arch, n_steps, loader):
    """JAX's params and AdamW state after ``n_steps`` on the same batches,
    and its jitted train step."""
    jcfg, tree = _jax_init(arch)
    opt = jadamw(LR)
    params = jax.tree.map(jnp.asarray, tree)
    state = opt.init(params)
    step = jax.jit(JM.make_train_step(
        jcfg, opt, aux_coef=0.01 if jcfg.is_moe else 0.0))
    for i in range(n_steps):
        params, state, _ = step(params, state, _batch(loader, i))
    return params, state, step, opt


def _batch(loader, i):
    return {k: jnp.asarray(v) for k, v in loader.get_batch(i).items()}


@pytest.mark.parametrize("arch", [MOE, "zamba2-7b"])
def test_port_round_trip_is_bitwise(arch, tmp_path):
    """Params, mu, nu and step after two steps, saved and restored into a
    fresh model and optimizer state: bitwise (the hybrid tree's stacked
    ``mamba_blocks`` and unstacked ``shared_attn`` and the tied embedding
    included)."""
    _, model, state, *_ = _port(arch, n_steps=2)
    path = save_state(str(tmp_path), 2, model, state)
    assert os.path.basename(path) == "step_00000002"
    _, fresh, fresh_state, *_ = _port(arch)
    restore_state(str(tmp_path), fresh, fresh_state)
    _assert_equal(_port_flat(fresh, fresh_state), _port_flat(model, state))
    assert fresh_state.step.dtype == torch.int32
    assert int(fresh_state.step) == 2


def test_resume_equals_straight_run_bitwise(tmp_path):
    """2 steps + save + restore + 2 steps == 4 straight steps, bitwise on
    the CPU: losses and every leaf of the state."""
    _, model, state, step, loader, losses = _port(MOE, n_steps=4)
    _, m2, s2, step2, _, first = _port(MOE, n_steps=2)
    save_state(str(tmp_path), 2, m2, s2)
    _, m3, s3, step3, _, _ = _port(MOE)
    restore_state(str(tmp_path), m3, s3)
    resumed = first + [step3(m3, s3, loader.get_batch(i)) for i in (2, 3)]
    assert [float(x) for x in resumed] == [float(x) for x in losses]
    _assert_equal(_port_flat(m3, s3), _port_flat(model, state))


@pytest.mark.parametrize("arch", [MOE, "minicpm3-4b", "zamba2-7b"])
def test_port_checkpoint_restores_in_jax(arch, tmp_path):
    """A checkpoint the port writes restores in JAX's
    ``restore_checkpoint`` against ``init_params`` + ``adamw().init``:
    every array equal, and JAX's next step gives the port's next loss."""
    _, model, state, step, loader, _ = _port(arch, n_steps=2)
    save_state(str(tmp_path), 2, model, state)
    jcfg, tree = _jax_init(arch)
    opt = jadamw(LR)
    params = jax.tree.map(jnp.asarray, tree)
    target = {"params": params, "opt": opt.init(params)}
    restored = jckpt.restore_checkpoint(str(tmp_path), target)
    _assert_equal(_flat(restored), _port_flat(model, state))
    jstep = jax.jit(JM.make_train_step(
        jcfg, opt, aux_coef=0.01 if jcfg.is_moe else 0.0))
    _, _, jloss = jstep(restored["params"], restored["opt"],
                        _batch(loader, 2))
    loss = step(model, state, loader.get_batch(2))
    assert abs(float(loss) - float(jloss)) <= 1e-5 * abs(float(jloss))


@pytest.mark.parametrize("arch", [MOE, "zamba2-7b"])
def test_jax_checkpoint_restores_in_port(arch, tmp_path):
    """A checkpoint JAX writes after two steps restores into the port's
    model and AdamW state: every array equal, the next losses agree."""
    cfg, model, state, step, loader, _ = _port(arch)
    params, jstate, jstep, _ = _jax_state(arch, 2, loader)
    jckpt.save_checkpoint(str(tmp_path), 2, {"params": params,
                                             "opt": jstate})
    restore_state(str(tmp_path), model, state)
    _assert_equal(_port_flat(model, state),
                  _flat({"params": params, "opt": jstate}))
    _, _, jloss = jstep(params, jstate, _batch(loader, 2))
    loss = step(model, state, loader.get_batch(2))
    assert abs(float(loss) - float(jloss)) <= 1e-5 * abs(float(jloss))


def test_sharded_checkpoint_and_format(tmp_path):
    """A small ``max_shard_bytes`` spreads the leaves over several npz
    shards; both packages restore it. The manifest keys leaves as JAX's
    ``tree_flatten_with_path`` names them, with the same sanitised
    names and dtypes."""
    _, model, state, *_ = _port(MOE, n_steps=1)
    save_state(str(tmp_path), 1, model, state, max_shard_bytes=1 << 16)
    jax_dir = tmp_path / "jax"
    jckpt.save_checkpoint(str(jax_dir), 1, {
        "params": params_to_numpy(model), "opt": opt_state_to_numpy(state)},
        max_shard_bytes=1 << 16)
    step_dir = tmp_path / "step_00000001"
    manifest = json.loads((step_dir / "manifest.json").read_text())
    want = json.loads((jax_dir / "step_00000001" / "manifest.json")
                      .read_text())
    assert manifest == want
    assert len(manifest["shards"]) > 3
    assert sorted(os.listdir(step_dir)) == sorted(
        manifest["shards"] + ["manifest.json"])
    assert manifest["leaves"]["opt/step"] == {
        "shard": 0, "name": "opt/step", "dtype": "int32", "shape": []}
    assert "params/blocks/moe/w1" in manifest["leaves"]
    assert "opt/mu/blocks/moe/w1" in manifest["leaves"]
    _, fresh, fresh_state, *_ = _port(MOE)
    restore_state(str(tmp_path), fresh, fresh_state)
    _assert_equal(_port_flat(fresh, fresh_state), _port_flat(model, state))
    jcfg, tree = _jax_init(MOE)
    params = jax.tree.map(jnp.asarray, tree)
    restored = jckpt.restore_checkpoint(
        str(tmp_path), {"params": params, "opt": jadamw(LR).init(params)})
    _assert_equal(_flat(restored), _port_flat(model, state))


def test_latest_step(tmp_path):
    assert ckpt.latest_step(str(tmp_path / "none")) is None
    assert ckpt.latest_step(str(tmp_path)) is None
    tree = {"a": np.arange(3, dtype=np.float32)}
    for s in (3, 12, 7):
        ckpt.save_checkpoint(str(tmp_path), s, tree)
    (tmp_path / "step_00000099").mkdir()          # no manifest: not a step
    (tmp_path / "other").mkdir()
    assert ckpt.latest_step(str(tmp_path)) == 12
    assert jckpt.latest_step(str(tmp_path)) == 12
    with pytest.raises(FileNotFoundError):
        ckpt.restore_checkpoint(str(tmp_path / "none"), tree)
    out = ckpt.restore_checkpoint(str(tmp_path), tree, step=3)
    np.testing.assert_array_equal(out["a"], tree["a"])


def test_missing_leaf_and_bad_shape_raise(tmp_path):
    """``KeyError`` for a leaf the checkpoint lacks, ``ValueError`` for a
    shape that differs — in the port's restore as in JAX's."""
    _, model, state, *_ = _port(MOE)
    save_state(str(tmp_path), 0, model, state)
    spec = train_state_spec(model, state)
    spec["params"]["extra"] = torch.empty((2,), device="meta")
    with pytest.raises(KeyError, match="params/extra"):
        ckpt.restore_checkpoint(str(tmp_path), spec)
    spec = train_state_spec(model, state)
    w1 = spec["params"]["blocks"]["moe"]["w1"]
    spec["params"]["blocks"]["moe"]["w1"] = torch.empty(
        (w1.shape[0] + 1,) + tuple(w1.shape[1:]), device="meta")
    with pytest.raises(ValueError, match="params/blocks/moe/w1"):
        ckpt.restore_checkpoint(str(tmp_path), spec)
    # the bridge's in-place load checks the same: a tree without the
    # untied model's lm_head, and a leaf of another shape
    tree = params_to_numpy(model)
    del tree["embed"]["lm_head"]
    with pytest.raises(KeyError, match="lm_head"):
        load_params(model, tree)
    tree = params_to_numpy(model)
    tree["final_norm"] = tree["final_norm"][:-1]
    with pytest.raises(ValueError, match="final_norm"):
        load_params(model, tree)
    jcfg, tree = _jax_init(MOE)
    params = jax.tree.map(jnp.asarray, tree)
    bad = {"params": dict(params, extra=jnp.zeros(2)),
           "opt": jadamw(LR).init(params)}
    with pytest.raises(KeyError):
        jckpt.restore_checkpoint(str(tmp_path), bad)


def test_tied_and_hybrid_trees_have_the_jax_leaves():
    """The restacked trees hold exactly the JAX init's leaves and shapes:
    tied embeddings (no ``lm_head``), the hybrid's stacked
    ``mamba_blocks`` beside its one ``shared_attn``, MLA's leaves, the
    vision stub's ``frontend_proj``."""
    for arch in ("minicpm3-4b", "zamba2-7b", "qwen2-vl-7b", MOE):
        _, tree = _jax_init(arch)
        _, model, *_ = _port(arch)
        got, want = _flat(params_to_numpy(model)), _flat(tree)
        _assert_equal(got, want)


def test_train_cli_resumes_across_packages(tmp_path, capsys, monkeypatch):
    """The port's train CLI writes checkpoints that it resumes from, and
    that the JAX package's train CLI resumes from too."""
    from repro.launch import train as jtrain
    from repro_torch.launch import train
    args = ["--arch", MOE, "--reduced", "--batch", "2", "--seq", "16",
            "--ckpt-dir", str(tmp_path), "--ckpt-every", "2",
            "--log-every", "1"]
    train.main(args + ["--device", "cpu", "--steps", "2"])
    assert ckpt.latest_step(str(tmp_path)) == 2
    train.main(args + ["--device", "cpu", "--steps", "4"])
    out = capsys.readouterr().out
    assert "restored step 2" in out and "step     4" in out
    assert ckpt.latest_step(str(tmp_path)) == 4
    monkeypatch.setattr("sys.argv", ["train"] + args + ["--steps", "5"])
    jtrain.main()
    out = capsys.readouterr().out
    assert "restored step 4" in out and "step     5" in out
