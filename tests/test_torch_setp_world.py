"""S-ETP, ETP and load-aware EP of the port in a world of 4 ranks against
the JAX package's on a 4-device host mesh of the same shape.

Two subprocesses, each with its own timeout: this file run as a program
in ``jax`` mode (XLA forced to 4 host devices) prepares a layer and a small
model from numpy seeds, runs JAX's ``setp_moe_forward`` /
``etp_moe_forward`` and its engines, and writes the prepared trees, the
inputs and its results; in ``torch`` mode it spawns 4 ranks over gloo (a
``FileStore`` in the test's temporary directory, no port) that load the
same trees — each rank its own expert shard — and write theirs. The tests
compare:
  * the S-ETP output at the float32 wire on (data 2, model 2) and
    (1, 4) meshes, prefill (sequence split over ``model``) and decode
    (replicated there): within 1e-5 of its largest magnitude;
  * every rank's keep mask and all-reduced load histogram: exact;
  * the two accounting quirks of the reference, shown in both packages:
    decode overflow counted once per ``model`` rank, and loads counted
    once per ``data`` rank when the batch does not divide over ``data``;
  * ETP against the dense oracle (1e-5) and JAX's ETP;
  * the sync and continuous engines under ``load_aware`` S-ETP (bf16 wire,
    the default): JAX's greedy tokens;
  * the paged engine (chunked prefill, prefix cache) under ``load_aware``
    S-ETP, on (1, 4) and on (2, 2): JAX's greedy tokens, overflow and
    prefix hits on every rank; on (2, 2) every step's batch (a chunk's 1,
    a decode step's 3 slots) is replicated over ``data``, and the loads
    the policy reads are twice the true histogram in both packages;
  * the slot engines refusing, when built, a slot count that ``data``
    divides (2 or 4 on (2, 2)), where JAX fails on the first decode step.
"""
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

# (name, mesh shape, (B, S), policy, wire): the S-ETP cases both sides run
CASES = [
    ("prefill_2x2", (2, 2), (2, 8), "load_aware", "float32"),
    ("decode_2x2", (2, 2), (4, 1), "load_aware", "float32"),
    ("prefill_1x4", (1, 4), (2, 8), "load_aware", "float32"),
    ("decode_1x4", (1, 4), (8, 1), "load_aware", "float32"),
    ("prefill_1x4_2t", (1, 4), (2, 8), "2t", "float32"),
    # keep-all at ample capacity: the dense oracle's output
    ("keep_all_prefill_2x2", (2, 2), (2, 8), "keep_all", "float32"),
    # quirk 1: decode at starved device capacity, ample local capacity
    ("decode_overflow_1x4", (1, 4), (8, 1), "keep_all", "float32"),
    # quirk 2: B = 1 does not divide over data = 2
    ("loads_replicated_data_2x2", (2, 2), (1, 8), "load_aware", "float32"),
]
OVERFLOW_CAPS = dict(cap_factor=0.25, local_cap_factor=64.0)
ENGINE_LAYERS = 2
PROMPTS = [(12, 4), (9, 4), (5, 3)]          # (prompt length, new tokens)
# the paged engine: page 4, chunk 8; a 4th request shares prompt 0's first
# 8 tokens (two pages) and is admitted after prompt 0 registered them (a
# pool with room to spare: no cached page is evicted before that)
PAGED = dict(page_size=4, chunk_size=8, max_prompt_len=12, max_new_tokens=4,
             n_pages=17)
PAGED_SLOTS = {(1, 4): 2, (2, 2): 3}         # 3 slots: replicated on data


def _paged_prompts(prompts):
    shared = np.concatenate([prompts[0][:8], prompts[1][:2]])
    return list(prompts) + [shared.astype(prompts[0].dtype)], \
        [n for _, n in PROMPTS] + [3]


def _local_hist(sub_idx, n_dev):
    """The pre-drop load of one rank's own token block, per device."""
    return np.bincount(np.asarray(sub_idx).reshape(-1) % n_dev,
                       minlength=n_dev).astype(np.float32)


def _inputs():
    """The layer weights (router sharpened so 2T drops) and the tokens of
    every case, from one numpy seed."""
    from repro_torch.configs import get_config
    cfg = get_config(ARCH)
    rng = np.random.default_rng(0)
    d, E, f = cfg.d_model, cfg.n_experts, cfg.d_expert

    def normal(*shape, scale=0.02):
        return (rng.normal(size=shape) * scale).astype(np.float32)
    layer = dict(wg=normal(d, E, scale=0.4), w1=normal(E, d, f),
                 w3=normal(E, d, f), w2=normal(E, f, d))
    xs = {name: normal(B, S, d, scale=0.5)
          for name, _, (B, S), _, _ in CASES}
    xs["etp"] = normal(4, 4, d, scale=0.5)
    calib = normal(128, d, scale=0.5)
    return layer, xs, calib


def _case_kw(name):
    return OVERFLOW_CAPS if name.startswith("decode_overflow") else \
        dict(cap_factor=4.0, local_cap_factor=8.0)


# ---------------------------------------------------------------------------
# jax mode
# ---------------------------------------------------------------------------

def jax_main(out: Path) -> None:
    import dataclasses

    import jax
    import jax.numpy as jnp

    from repro.configs import get_config
    from repro.core import policy as P
    from repro.core import setp
    from repro.data.pipeline import SyntheticLM, calibration_activations
    from repro.launch.mesh import make_mesh_auto, use_mesh
    from repro.models import model as M
    from repro.models.transformer import DistContext
    from repro.serving import (ContinuousBatchingEngine, GenerationConfig,
                               ServingEngine)
    from repro.serving.paged import PagedEngine

    cfg = get_config(ARCH)
    layer, xs, calib = _inputs()
    jl = {k: jnp.asarray(v) for k, v in layer.items()}
    res, arrays = {}, {}
    pols = {}
    for name in ("load_aware", "2t"):
        pol = P.make_policy(name, cfg.dualsparse)
        prepared, pol = pol.prepare(jl, cfg, jnp.asarray(calib))
        pols[name] = pol
        arrays.update({f"{name}.{k}": np.asarray(v)
                       for k, v in prepared.items()})
    pols["keep_all"] = P.TwoTDrop(partition_p=2, t_major=-1.0, t_minor=-1.0)
    arrays.update({f"keep_all.{k}": arrays[f"2t.{k}"]
                   for k in ("wg", "w1", "w3", "w2")})
    res["t2"] = [float(pols["2t"].t_major), float(pols["2t"].t_minor)]

    recorded = []

    def recording(cls):
        orig = cls.sub_pair_keep

        def rec(self, score, is_major, sub_idx, cfg, *, n_dev=1, loads=None,
                thresholds=None):
            keep = orig(self, score, is_major, sub_idx, cfg, n_dev=n_dev,
                        loads=loads, thresholds=thresholds)
            coords = jnp.stack([jax.lax.axis_index("data"),
                                jax.lax.axis_index("model")])
            jax.debug.callback(
                lambda c, k, l: recorded.append(
                    (tuple(int(v) for v in c), np.asarray(k),
                     np.asarray(l))),
                coords, keep, loads if loads is not None
                else jnp.zeros((n_dev,), jnp.float32))
            return keep
        cls.sub_pair_keep = rec
        return orig

    originals = {cls: recording(cls) for cls in (P.LoadAwareTwoT, P.TwoTDrop)}
    for name, shape, _, pol, wire in CASES:
        mesh = make_mesh_auto(shape, ("data", "model"))
        params = setp.place_params_strided(
            {k: jnp.asarray(arrays[f"{pol}.{k}"])
             for k in ("wg", "w1", "w3", "w2")}, shape[1])
        recorded.clear()
        with use_mesh(mesh):
            y, of = jax.jit(lambda p, x: setp.setp_moe_forward(
                p, x, cfg, mesh, policy=pols[pol],
                wire_dtype=getattr(jnp, wire), return_overflow=True,
                **_case_kw(name)))(params, jnp.asarray(xs[name]))
            y.block_until_ready()
        jax.effects_barrier()
        arrays[f"y.{name}"] = np.asarray(y)
        res[f"overflow.{name}"] = int(of)
        for coords, keep, loads in recorded:
            arrays[f"keep.{name}.{coords[0]}{coords[1]}"] = keep
            arrays[f"loads.{name}.{coords[0]}{coords[1]}"] = loads
    for cls, orig in originals.items():
        cls.sub_pair_keep = orig

    mesh = make_mesh_auto((2, 2), ("ep", "tp"))
    with use_mesh(mesh):
        y = jax.jit(lambda p, x: setp.etp_moe_forward(
            p, x, cfg, mesh, cap_factor=4.0, local_cap_factor=8.0))(
                jl, jnp.asarray(xs["etp"]))
    arrays["y.etp"] = np.asarray(y)

    # the engines: a 2-layer olmoe-lite, load_aware prepared for 4 devices
    ecfg = dataclasses.replace(cfg, n_layers=ENGINE_LAYERS)
    key = jax.random.PRNGKey(0)
    params = M.init_params(key, ecfg)
    ecalib = calibration_activations(jax.random.fold_in(key, 7), 128,
                                     ecfg.d_model)
    pol = P.make_policy("load_aware", ecfg.dualsparse)
    tparams, pol = pol.prepare(params, ecfg, ecalib, n_ep_devices=4)
    flat = jax.tree_util.tree_flatten_with_path(tparams)[0]
    for path, leaf in flat:
        arrays["model." + ".".join(p.key for p in path)] = np.asarray(leaf)
    mesh = make_mesh_auto((1, 4), ("data", "model"))
    dist = DistContext(mesh=mesh, moe_impl="setp", policy=pol)
    src = SyntheticLM(ecfg.vocab_size)
    prompts = [np.asarray(src.sample_batch(jax.random.fold_in(key, i), 1,
                                           n)["tokens"][0])
               for i, (n, _) in enumerate(PROMPTS)]
    for i, p in enumerate(prompts):
        arrays[f"prompt.{i}"] = p
    with use_mesh(mesh):
        eng = ServingEngine(ecfg, tparams, batch_size=2, max_prompt_len=12,
                            max_new_tokens=4, dist=dist)
        served = eng.generate(prompts[:2],
                              GenerationConfig(max_new_tokens=4))
        res["sync_tokens"] = [r.tokens for r in served]
        res["sync_overflow"] = int(eng.overflow_pairs)
        ceng = ContinuousBatchingEngine(ecfg, tparams, n_slots=2,
                                        max_prompt_len=12, max_new_tokens=4,
                                        dist=dist)
        uids = [ceng.submit(p, GenerationConfig(max_new_tokens=n))
                for p, (_, n) in zip(prompts, PROMPTS)]
        ceng.drain()
        res["cont_tokens"] = [ceng.result(u).tokens for u in uids]

    # the paged engine over EP: (1, 4) on the weights above; (2, 2) on the
    # same init prepared for 2 EP devices, its loads recorded per call
    t2params, pol2 = P.make_policy("load_aware", ecfg.dualsparse).prepare(
        params, ecfg, ecalib, n_ep_devices=2)
    flat = jax.tree_util.tree_flatten_with_path(t2params)[0]
    for path, leaf in flat:
        arrays["model2." + ".".join(p.key for p in path)] = np.asarray(leaf)
    pprompts, pnew = _paged_prompts(prompts)
    calls = []
    orig = P.LoadAwareTwoT.sub_pair_keep

    def rec(self, score, is_major, sub_idx, cfg, *, n_dev=1, loads=None,
            thresholds=None):
        coords = jnp.stack([jax.lax.axis_index("data"),
                            jax.lax.axis_index("model")])
        jax.debug.callback(
            lambda c, l, s: calls.append(
                (tuple(int(v) for v in c), np.asarray(l),
                 _local_hist(s, n_dev), int(s.shape[0]))),
            coords, loads, sub_idx)
        return orig(self, score, is_major, sub_idx, cfg, n_dev=n_dev,
                    loads=loads, thresholds=thresholds)

    for shape, tp, tpol in (((1, 4), tparams, pol), ((2, 2), t2params, pol2)):
        tag = f"paged{shape[0]}{shape[1]}"
        mesh = make_mesh_auto(shape, ("data", "model"))
        pdist = DistContext(mesh=mesh, moe_impl="setp", policy=tpol)
        if shape == (2, 2):
            P.LoadAwareTwoT.sub_pair_keep = rec
        with use_mesh(mesh):
            peng = PagedEngine(ecfg, tp, n_slots=PAGED_SLOTS[shape],
                               dist=pdist, **PAGED)
            uids = [peng.submit(p, GenerationConfig(max_new_tokens=n))
                    for p, n in zip(pprompts, pnew)]
            peng.drain()
        jax.effects_barrier()
        P.LoadAwareTwoT.sub_pair_keep = orig
        res[f"{tag}_tokens"] = [peng.result(u).tokens for u in uids]
        res[f"{tag}_overflow"] = int(peng.overflow_pairs)
        res[f"{tag}_hits"] = int(peng.prefix_hits)
    for c in {c for c, *_ in calls}:
        mine = [x for x in calls if x[0] == c]
        key = f"{c[0]}{c[1]}"
        arrays[f"paged22.loads.{key}"] = np.stack([x[1] for x in mine])
        arrays[f"paged22.local.{key}"] = np.stack([x[2] for x in mine])
        arrays[f"paged22.ntok.{key}"] = np.asarray([x[3] for x in mine])
    np.savez(out / "jax.npz", **arrays)
    (out / "jax.json").write_text(json.dumps(res))


# ---------------------------------------------------------------------------
# torch mode: 4 ranks over gloo
# ---------------------------------------------------------------------------

def _rank_main(rank: int, out: str) -> None:
    import dataclasses

    import torch.distributed as dist

    from repro_torch.checkpoint.from_numpy import params_from_numpy
    from repro_torch.configs import get_config
    from repro_torch.core import policy as P
    from repro_torch.core import setp
    from repro_torch.distributed import DistContext, make_mesh
    from repro_torch.serving import (ContinuousBatchingEngine,
                                     GenerationConfig, PagedEngine,
                                     ServingEngine)

    torch.set_num_threads(1)
    out = Path(out)
    store = dist.FileStore(str(out / "store"), WORLD)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=WORLD)
    cfg = get_config(ARCH)
    _, xs, _ = _inputs()
    ref = np.load(out / "jax.npz")
    info = json.loads((out / "jax.json").read_text())
    meshes = {shape: DistContext(make_mesh(shape, ("data", "model")))
              for shape in ((2, 2), (1, 4))}
    pols = {"load_aware": P.make_policy("load_aware", cfg.dualsparse),
            "2t": dataclasses.replace(P.make_policy("2t", cfg.dualsparse),
                                      t_major=info["t2"][0],
                                      t_minor=info["t2"][1]),
            "keep_all": P.TwoTDrop(partition_p=2, t_major=-1.0,
                                   t_minor=-1.0)}
    res, arrays = {}, {}
    recorded = []

    def recording(cls):
        orig = cls.sub_pair_keep

        def rec(self, *a, **kw):
            keep = orig(self, *a, **kw)
            loads = kw.get("loads")
            recorded.append((keep.clone(), None if loads is None
                             else loads.clone()))
            return keep
        cls.sub_pair_keep = rec

    for cls in (P.LoadAwareTwoT, P.TwoTDrop):
        recording(cls)
    for name, shape, _, pol, wire in CASES:
        ctx = meshes[shape]
        n_dev = ctx.size("model")
        layer = setp.place_params_strided(
            {k: torch.from_numpy(ref[f"{pol}.{k}"])
             for k in ("wg", "w1", "w3", "w2")}, n_dev)
        shard = setp.expert_shard(layer, n_dev, ctx.coord("model"))
        recorded.clear()
        y, of = setp.setp_moe_forward(
            shard, torch.from_numpy(xs[name]), cfg, ctx, policy=pols[pol],
            wire_dtype=getattr(torch, wire), return_overflow=True,
            **_case_kw(name))
        c = f"{ctx.coord('data')}{ctx.coord('model')}"
        keep, loads = recorded[-1]
        arrays[f"keep.{name}.{c}"] = keep.numpy()
        if loads is not None:
            arrays[f"loads.{name}.{c}"] = loads.numpy()
        arrays[f"y.{name}.{c}"] = y.numpy()
        res[f"overflow.{name}"] = int(of)

    ctx = DistContext(make_mesh((2, 2), ("ep", "tp")))
    full = {k: torch.from_numpy(_inputs()[0][k])
            for k in ("wg", "w1", "w3", "w2")}
    y = setp.etp_moe_forward(setp.etp_shard(full, ctx),
                             torch.from_numpy(xs["etp"]), cfg, ctx,
                             cap_factor=4.0, local_cap_factor=8.0)
    arrays[f"y.etp.{rank}"] = y.numpy()

    ctx = meshes[(1, 4)]
    ecfg = dataclasses.replace(cfg, n_layers=ENGINE_LAYERS)
    def tree_of(prefix):
        tree = {}
        for key in ref.files:
            if key.startswith(prefix + "."):
                node = tree
                *path, leaf = key.split(".")[1:]
                for p in path:
                    node = node.setdefault(p, {})
                node[leaf] = ref[key]
        return tree
    model = params_from_numpy(tree_of("model"), ecfg, device="cpu", dist=ctx)
    pol = P.make_policy("load_aware", ecfg.dualsparse)
    prompts = [ref[f"prompt.{i}"] for i in range(len(PROMPTS))]
    eng = ServingEngine(ecfg, model, batch_size=2, max_prompt_len=12,
                        max_new_tokens=4, policy=pol, device="cpu", dist=ctx)
    got = eng.generate(prompts[:2], GenerationConfig(max_new_tokens=4))
    res["sync_tokens"] = [r.tokens for r in got]
    res["sync_overflow"] = int(eng.overflow_pairs)
    res["sync_subpairs"] = {
        k: v for k, v in eng.metrics().counters.items()
        if k.startswith("repro_moe_subpairs_total")}
    ceng = ContinuousBatchingEngine(ecfg, model, n_slots=2,
                                    max_prompt_len=12, max_new_tokens=4,
                                    policy=pol, device="cpu", dist=ctx)
    uids = [ceng.submit(p, GenerationConfig(max_new_tokens=n))
            for p, (_, n) in zip(prompts, PROMPTS)]
    ceng.drain()
    res["cont_tokens"] = [ceng.result(u).tokens for u in uids]
    res["expert_shape"] = list(model.blocks[0].moe.w1.shape)

    # the paged engine over EP, (1, 4) then (2, 2), loads recorded on (2, 2)
    pprompts, pnew = _paged_prompts(prompts)
    calls = []
    orig = P.LoadAwareTwoT.sub_pair_keep

    def rec(self, score, is_major, sub_idx, cfg, *, n_dev=1, loads=None,
            thresholds=None):
        calls.append((loads.clone().numpy(), _local_hist(sub_idx, n_dev),
                      int(sub_idx.shape[0])))
        return orig(self, score, is_major, sub_idx, cfg, n_dev=n_dev,
                    loads=loads, thresholds=thresholds)

    for shape, prefix in (((1, 4), "model"), ((2, 2), "model2")):
        tag = f"paged{shape[0]}{shape[1]}"
        pctx = meshes[shape]
        pmodel = model if prefix == "model" else params_from_numpy(
            tree_of(prefix), ecfg, device="cpu", dist=pctx)
        if shape == (2, 2):
            P.LoadAwareTwoT.sub_pair_keep = rec
        peng = PagedEngine(ecfg, pmodel, n_slots=PAGED_SLOTS[shape],
                           policy=pol, device="cpu", dist=pctx, **PAGED)
        uids = [peng.submit(p, GenerationConfig(max_new_tokens=n))
                for p, n in zip(pprompts, pnew)]
        peng.drain()
        P.LoadAwareTwoT.sub_pair_keep = orig
        res[f"{tag}_tokens"] = [peng.result(u).tokens for u in uids]
        res[f"{tag}_overflow"] = int(peng.overflow_pairs)
        res[f"{tag}_hits"] = int(peng.prefix_hits)
    c = f"{meshes[(2, 2)].coord('data')}{meshes[(2, 2)].coord('model')}"
    res["paged22_coords"] = c
    # slot counts that data = 2 divides: both slot engines refuse up front
    refused = {}
    for n_slots in (2, 4):
        for name, mk in (
                ("paged", lambda: PagedEngine(
                    ecfg, pmodel, n_slots=n_slots, policy=pol,
                    device="cpu", dist=meshes[(2, 2)], **PAGED)),
                ("continuous", lambda: ContinuousBatchingEngine(
                    ecfg, pmodel, n_slots=n_slots, max_prompt_len=12,
                    max_new_tokens=4, policy=pol, device="cpu",
                    dist=meshes[(2, 2)]))):
            try:
                mk()
                refused[f"{name}{n_slots}"] = "built"
            except NotImplementedError as e:
                refused[f"{name}{n_slots}"] = str(e)
    res["refused_on_data"] = refused
    arrays[f"paged22.loads.{c}"] = np.stack([x[0] for x in calls])
    arrays[f"paged22.local.{c}"] = np.stack([x[1] for x in calls])
    arrays[f"paged22.ntok.{c}"] = np.asarray([x[2] for x in calls])
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
    out = tmp_path_factory.mktemp("setp_world")
    _run("jax", out, XLA_FLAGS="--xla_force_host_platform_device_count=4")
    _run("torch", out)
    jax_arrays = dict(np.load(out / "jax.npz"))
    jax_res = json.loads((out / "jax.json").read_text())
    ranks = [(dict(np.load(out / f"torch{r}.npz")),
              json.loads((out / f"torch{r}.json").read_text()))
             for r in range(WORLD)]
    return jax_arrays, jax_res, ranks


def _coords(shape):
    return [f"{d}{m}" for d in range(shape[0]) for m in range(shape[1])]


def _close(got, want, tol=F32_TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= tol, f"max error {err:.3e} of the largest magnitude"


@pytest.mark.parametrize("name,shape", [(c[0], c[1]) for c in CASES],
                         ids=[c[0] for c in CASES])
def test_setp_output_equals_jax(worlds, name, shape):
    """Every rank's replicated S-ETP output against JAX's, float32 wire;
    the global overflow count equal on every rank and to JAX's."""
    ja, jr, ranks = worlds
    want = ja[f"y.{name}"]
    for c in _coords(shape):
        got = next(a[f"y.{name}.{c}"] for a, _ in ranks
                   if f"y.{name}.{c}" in a)
        assert got.shape == want.shape
        _close(got, want)
    assert {r[f"overflow.{name}"] for _, r in ranks} == \
        {jr[f"overflow.{name}"]}


@pytest.mark.parametrize("name,shape", [(c[0], c[1]) for c in CASES
                                        if c[3] == "load_aware"],
                         ids=[c[0] for c in CASES if c[3] == "load_aware"])
def test_keep_masks_and_loads_equal_jax(worlds, name, shape):
    """Each rank's keep mask over its own token block and the all-reduced
    load histogram its policy received: bit for bit JAX's, decode and
    prefill."""
    ja, _, ranks = worlds
    for c in _coords(shape):
        a = next(a for a, _ in ranks if f"keep.{name}.{c}" in a)
        np.testing.assert_array_equal(a[f"keep.{name}.{c}"],
                                      ja[f"keep.{name}.{c}"])
        np.testing.assert_array_equal(a[f"loads.{name}.{c}"],
                                      ja[f"loads.{name}.{c}"])
    keep = np.concatenate([ja[f"keep.{name}.{c}"] for c in _coords(shape)])
    assert 0 < keep.sum() < keep.size


def _device_histogram(x, layer_wg, n_dev=4):
    """Per-device pre-drop load of the strided sub-expert placement, every
    token counted once."""
    from repro_torch.configs import get_config
    from repro_torch.core import dispatch, gating
    cfg = get_config(ARCH)
    xt = torch.from_numpy(x.reshape(-1, x.shape[-1]))
    r = gating.route(xt, torch.from_numpy(layer_wg), cfg.top_k,
                     cfg.router_norm_topk)
    sub = (r.idx[:, :, None] * 2 + torch.arange(2, dtype=r.idx.dtype))
    return dispatch.group_histogram(sub.reshape(xt.shape[0], -1) % n_dev,
                                    n_dev, dtype=torch.float32).numpy(), \
        sub.reshape(xt.shape[0], -1)


def test_decode_loads_counted_once(worlds):
    """On decode the token block is replicated over ``model``: the loads
    all-reduce skips it, so each token counts once (prefill likewise)."""
    ja, _, ranks = worlds
    layer, xs, _ = _inputs()
    for name in ("decode_1x4", "prefill_1x4"):
        want, _ = _device_histogram(xs[name], ja["load_aware.wg"])
        np.testing.assert_array_equal(ranks[0][0][f"loads.{name}.00"], want)


def test_quirk_decode_overflow_counted_per_model_rank(worlds):
    """Reference quirk, mirrored: the overflow all-reduce runs over the
    ``model`` axis unconditionally, so on decode (tokens replicated there)
    the device-level overflow of the one token block is counted once per
    ``model`` rank — 4x the pairs that actually overflowed."""
    from repro_torch.core import dispatch
    from repro_torch.core.setp import _ceil_mult
    ja, jr, ranks = worlds
    name = "decode_overflow_1x4"
    x = _inputs()[1][name]
    _, sub = _device_histogram(x, ja["keep_all.wg"])
    T, Kp = sub.shape
    cap = _ceil_mult(OVERFLOW_CAPS["cap_factor"] * T * Kp / 4)
    plan = dispatch.sort_dispatch(sub % 4, n_groups=4, capacity=cap)
    once = int(plan.overflow)
    assert once > 0
    assert jr[f"overflow.{name}"] == 4 * once
    assert all(r[f"overflow.{name}"] == 4 * once for _, r in ranks)


def test_quirk_loads_counted_per_data_rank(worlds):
    """Reference quirk, mirrored: with B = 1 the batch is replicated over
    ``data`` (it does not divide), yet the loads all-reduce still sums over
    ``data``: every load is counted twice, in both packages."""
    ja, _, ranks = worlds
    name = "loads_replicated_data_2x2"
    true, _ = _device_histogram(_inputs()[1][name], ja["load_aware.wg"],
                                n_dev=2)
    for c in _coords((2, 2)):
        np.testing.assert_array_equal(ja[f"loads.{name}.{c}"], 2 * true)
        a = next(a for a, _ in ranks if f"loads.{name}.{c}" in a)
        np.testing.assert_array_equal(a[f"loads.{name}.{c}"], 2 * true)


def _dense_oracle(x):
    from repro_torch.configs import get_config
    from repro_torch.core import moe
    layer = _inputs()[0]
    y = moe.moe_forward_ref({k: torch.from_numpy(v) for k, v in layer.items()},
                            torch.from_numpy(x.reshape(-1, x.shape[-1])),
                            get_config(ARCH))
    return y.numpy().reshape(x.shape)


def test_setp_keep_all_equals_dense_oracle(worlds):
    """Keep-all 2T over the partitioned, reconstructed, strided-placed
    layer at ample capacity computes every expert whole: the dense
    oracle of the original layer, on every rank (Eq. 13)."""
    _, _, ranks = worlds
    name = "keep_all_prefill_2x2"
    want = _dense_oracle(_inputs()[1][name])
    for c in _coords((2, 2)):
        _close(next(a[f"y.{name}.{c}"] for a, _ in ranks
                    if f"y.{name}.{c}" in a), want)


def test_etp_equals_dense_oracle_and_jax(worlds):
    """ETP over (ep 2, tp 2) at ample capacity: the dense oracle's output
    (no drop, no overflow) and JAX's ETP, on every rank."""
    ja, _, ranks = worlds
    want = _dense_oracle(_inputs()[1]["etp"])
    for r, (a, _) in enumerate(ranks):
        _close(a[f"y.etp.{r}"], want)
        _close(a[f"y.etp.{r}"], ja["y.etp"])


def test_engines_serve_jax_tokens_under_setp(worlds):
    """A 2-layer olmoe-lite prepared by JAX's load_aware for 4 EP devices:
    every rank keeps 1/4 of the sub-experts, and the sync and continuous
    engines on S-ETP (bf16 wire) give JAX's greedy tokens on every rank,
    with its overflow count."""
    _, jr, ranks = worlds
    from repro_torch.configs import get_config
    cfg = get_config(ARCH)
    for _, r in ranks:
        assert r["expert_shape"] == [cfg.n_experts * 2 // WORLD,
                                     cfg.d_model, cfg.d_expert // 2]
        assert r["sync_tokens"] == jr["sync_tokens"]
        assert r["cont_tokens"] == jr["cont_tokens"]
        assert r["sync_overflow"] == jr["sync_overflow"]
        assert r["sync_subpairs"] == ranks[0][1]["sync_subpairs"]
    assert sum(ranks[0][1]["sync_subpairs"].values()) > 0


def test_paged_engine_serves_jax_tokens_under_setp(worlds):
    """The paged engine (chunked prefill, page 4, chunk 8, a shared 8-token
    prefix) with the EP context, load_aware at the bf16 wire: JAX's
    ``PagedEngine(dist=...)`` greedy tokens, overflow count and prefix
    hits on every rank, on (1, 4) and on (2, 2)."""
    _, jr, ranks = worlds
    for tag in ("paged14", "paged22"):
        assert jr[f"{tag}_hits"] == 2
        for _, r in ranks:
            assert r[f"{tag}_tokens"] == jr[f"{tag}_tokens"], tag
            assert r[f"{tag}_overflow"] == jr[f"{tag}_overflow"], tag
            assert r[f"{tag}_hits"] == jr[f"{tag}_hits"], tag
        assert [len(t) for t in jr[f"{tag}_tokens"]] == [4, 4, 3, 3]


def test_quirk_paged_loads_counted_per_data_rank(worlds):
    """Reference quirk, mirrored on the paged engine's every step: a
    chunk's batch of 1 and a decode step's 3 slots do not divide over
    ``data`` = 2, so the batch is replicated there, yet the loads
    all-reduce sums over ``data``: the loads the policy reads are twice the
    true histogram (each token counted once: the sum of the local blocks
    over ``model``), in both packages. Decode steps (3 tokens, replicated
    over ``model`` too) are checked per call, chunk steps (4 tokens, the
    chunk's halves over ``model``) in sum, the calls' order being the
    devices' own in JAX."""
    ja, _, ranks = worlds
    port = {}
    for a, r in ranks:
        c = r["paged22_coords"]
        port[c] = {k: a[f"paged22.{k}.{c}"] for k in ("loads", "local",
                                                       "ntok")}
    jax_side = {c: {k: ja[f"paged22.{k}.{c}"] for k in ("loads", "local",
                                                        "ntok")}
                for c in _coords((2, 2))}
    for side in (jax_side, port):
        assert sorted(side) == _coords((2, 2))
        for c, rec in side.items():
            dec, chk = rec["ntok"] == 3, rec["ntok"] == 4
            assert dec.sum() > 0 and chk.sum() > 0
            assert dec.sum() + chk.sum() == len(rec["ntok"])
            np.testing.assert_array_equal(rec["loads"][dec],
                                          2 * rec["local"][dec])
            both = sum(side[f"{c[0]}{m}"]["local"][
                side[f"{c[0]}{m}"]["ntok"] == 4].sum(0) for m in range(2))
            np.testing.assert_array_equal(rec["loads"][chk].sum(0),
                                          2 * both)


def test_slot_engines_refuse_slot_counts_split_over_data(worlds):
    """Under S-ETP a decode batch of n_slots splits over ``data`` when
    ``data`` divides it, while the per-slot thresholds enter whole; both
    slot engines refuse such a slot count when they are built (JAX fails
    on the first decode step instead), on every rank of (2, 2)."""
    _, _, ranks = worlds
    for _, r in ranks:
        got = r["refused_on_data"]
        assert sorted(got) == ["continuous2", "continuous4", "paged2",
                               "paged4"]
        for key, msg in got.items():
            assert "per-slot thresholds" in msg and "('data',)" in msg, key


if __name__ == "__main__":
    if sys.argv[1] == "jax":
        jax_main(Path(sys.argv[2]))
    else:
        torch_main(Path(sys.argv[2]))
