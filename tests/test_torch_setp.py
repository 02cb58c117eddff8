"""S-ETP pieces of the port against the JAX package's, on the same numpy
inputs, in one process: the policies' ``sub_pair_keep`` keep masks, the
strided placement, and ``setp_moe_forward`` in a world of one rank (gloo
over a ``FileStore`` in ``tmp_path``) against JAX's on a one-device mesh —
the counts_major and overflow checks of ``tests/test_dispatch.py``
mirrored — and its gradient (``kernels=False``) against ``jax.grad`` of
JAX's; on one rank the differentiable collectives' backward is plain
autograd. The 4-rank worlds are ``test_torch_setp_world.py`` and
``test_torch_train_world.py``.

Tolerances:
  * keep masks and the strided placement: exact (the same float32
    comparisons, thresholds formed in JAX's order);
  * S-ETP at the float32 wire, output and gradients: within 1e-5 of the
    largest magnitude (the same products summed in other orders), and within 2e-4
    / 1e-4 of the dense oracle as ``test_dispatch.py`` holds JAX's;
  * S-ETP at the bf16 wire (the default): within 2e-2 of the largest
    magnitude — both round x, the weights, h and each expert output to
    bf16, but at other points of their own float32 sums.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import get_config as jax_config
from repro.core import policy as jpolicy
from repro.core import setp as jsetp
from repro.launch.mesh import make_host_mesh
from repro_torch.configs import get_config
from repro_torch.core import moe as tmoe
from repro_torch.core import policy as tpolicy
from repro_torch.core import setp as tsetp
from repro_torch.distributed import DistContext, make_mesh
from repro_torch.kernels import ops as tops

ARCH = "olmoe-lite"
F32_TOL = 1e-5
BF16_TOL = 2e-2


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(tree):
    return {k: _t(v) if isinstance(v, dict) else torch.from_numpy(
        np.array(v)) for k, v in tree.items()}


def _jax_setp(params, x, cfg, mesh, **kw):
    """JAX's ``setp_moe_forward`` under ``jax.jit`` (outside jit every
    shard_map op runs eagerly: ~20 s a call on the CPU)."""
    return jax.jit(lambda p, xx: jsetp.setp_moe_forward(p, xx, cfg, mesh,
                                                        **kw))(params, x)


def _close(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= tol, f"max error {err:.3e} of the largest magnitude"


# ---------------------------------------------------------------------------
# Keep masks and placement
# ---------------------------------------------------------------------------

def _pair_block(seed, T=48, K=4, P=2, E=16, n_dev=4):
    """Expanded sub-pair routing of a random router: score (T, K*P),
    is_major, sub_idx, and a (n_dev,) pre-drop load histogram."""
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(T, E)).astype(np.float32) * 2
    idx = np.argsort(-logits, axis=1, kind="stable")[:, :K].astype(np.int32)
    top = np.take_along_axis(logits, idx, 1)
    score = np.exp(top) / np.exp(top).sum(1, keepdims=True)
    sub_idx = (idx[:, :, None] * P + np.arange(P)).reshape(T, K * P)
    score = np.repeat(score[:, :, None], P, 2).reshape(T, K * P)
    is_major = (sub_idx % P) == 0
    loads = np.bincount((sub_idx % n_dev).ravel(), minlength=n_dev)
    return (score.astype(np.float32), is_major, sub_idx.astype(np.int32),
            loads.astype(np.float32))


POLICIES = [
    ("none", {}),
    ("1t", dict(t_drop=0.12)),
    ("2t", dict(t_major=0.1, t_minor=0.16)),
    ("load_aware", dict(t_max=0.14, t_gap=0.02)),
    ("per_layer", {}),
]


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name,kw", POLICIES, ids=[n for n, _ in POLICIES])
def test_sub_pair_keep_equals_jax(name, kw, seed):
    """Every policy's S-ETP keep mask, bit for bit; load_aware on skewed
    per-device loads (scalar thresholds) and per-token ones."""
    cfg_j, cfg_t = jax_config(ARCH), get_config(ARCH)
    score, is_major, sub_idx, loads = _pair_block(seed)
    th = np.array([0.09, 0.15], np.float32) if name == "per_layer" else None
    pj = dataclasses.replace(jpolicy.make_policy(name), **kw)
    pt = dataclasses.replace(tpolicy.make_policy(name), **kw)
    cases = [(pj, pt)]
    if name == "load_aware":        # per-token threshold values
        tmax = np.linspace(0.08, 0.2, score.shape[0]).astype(np.float32)
        cases.append((dataclasses.replace(pj, t_max=jnp.asarray(tmax)),
                      dataclasses.replace(pt, t_max=torch.from_numpy(tmax))))
    for pj_, pt_ in cases:
        want = pj_.sub_pair_keep(
            jnp.asarray(score), jnp.asarray(is_major), jnp.asarray(sub_idx),
            cfg_j, n_dev=4, loads=jnp.asarray(loads),
            thresholds=None if th is None else jnp.asarray(th))
        got = pt_.sub_pair_keep(
            torch.from_numpy(score), torch.from_numpy(is_major),
            torch.from_numpy(sub_idx), cfg_t, n_dev=4,
            loads=torch.from_numpy(loads),
            thresholds=None if th is None else torch.from_numpy(th))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        if name not in ("none",):
            assert 0 < int(got.sum()) < got.numel()
    assert pt.needs_loads == pj.needs_loads


def test_load_aware_keep_needs_loads():
    score, is_major, sub_idx, _ = _pair_block(3)
    with pytest.raises(ValueError, match="load"):
        tpolicy.make_policy("load_aware").sub_pair_keep(
            torch.from_numpy(score), torch.from_numpy(is_major),
            torch.from_numpy(sub_idx), get_config(ARCH), n_dev=4)


@pytest.mark.parametrize("n_dev", [1, 2, 4])
def test_place_params_strided_equals_jax(n_dev):
    rng = np.random.default_rng(n_dev)
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in
              (("wg", (8, 4)), ("w1", (8, 8, 6)), ("w3", (8, 8, 6)),
               ("w2", (8, 6, 8)))}
    want = _np(jsetp.place_params_strided(
        {k: jnp.asarray(v) for k, v in params.items()}, n_dev))
    got = tsetp.place_params_strided(_t(params), n_dev)
    for k in params:
        np.testing.assert_array_equal(got[k].numpy(), want[k])
    # a rank's shard is its contiguous block of placed sub-experts: device
    # d holds sub-expert ids d, d + D, d + 2D, ...
    for coord in range(n_dev):
        shard = tsetp.expert_shard(got, n_dev, coord)
        ids = np.arange(coord, 8, n_dev)
        np.testing.assert_array_equal(shard["w1"].numpy(), params["w1"][ids])


def test_prepare_places_strided(tmp_path):
    """``prepare(..., n_ep_devices=D)`` = prepare, then strided placement."""
    cfg = get_config(ARCH)
    rng = np.random.default_rng(5)
    layer = _t(_layer_params(rng, cfg))
    calib = torch.from_numpy(rng.normal(size=(64, cfg.d_model))
                             .astype(np.float32))
    pol = tpolicy.make_policy("load_aware", cfg.dualsparse)
    placed, _ = pol.prepare(layer, cfg, calib, n_ep_devices=4)
    plain, _ = pol.prepare(layer, cfg, calib)
    for k in ("w1", "w3", "w2"):
        assert torch.equal(placed[k], tsetp.to_strided_order(plain[k], 4))


# ---------------------------------------------------------------------------
# A world of one rank
# ---------------------------------------------------------------------------

def _layer_params(rng, cfg, router_scale=1.0):
    d, E, f = cfg.d_model, cfg.n_experts, cfg.d_expert

    def normal(*shape, scale=0.02):
        return (rng.normal(size=shape) * scale).astype(np.float32)
    return dict(wg=normal(d, E, scale=0.02 * router_scale),
                w1=normal(E, d, f), w3=normal(E, d, f), w2=normal(E, f, d))


@pytest.fixture
def world1(tmp_path):
    """gloo over a FileStore in ``tmp_path``: rank 0 of 1; a (1, 1) mesh."""
    store = dist.FileStore(str(tmp_path / "store"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    try:
        yield DistContext(make_mesh((1, 1), ("data", "model")))
    finally:
        dist.destroy_process_group()


def _two_t_setup(seed=0):
    """Numpy layer with a sharpened router, prepared by JAX's 2T policy
    (the port loads JAX's reordering), thresholds that yield MAJOR-only
    pairs, and 64 tokens."""
    cfg = jax_config(ARCH)
    rng = np.random.default_rng(seed)
    params = _layer_params(rng, cfg, router_scale=20.0)
    x = (rng.normal(size=(64, cfg.d_model)) * 0.5).astype(np.float32)
    pol = jpolicy.TwoTDrop(partition_p=2, use_kernel=True)
    prepared, _ = pol.prepare({k: jnp.asarray(v) for k, v in params.items()},
                              cfg, jnp.asarray(x))
    from repro.core import gating
    r = gating.route(jnp.asarray(x), jnp.asarray(params["wg"]), cfg.top_k,
                     cfg.router_norm_topk)
    t1 = float(jnp.quantile(r.norm_score, 0.35))
    return _np(prepared), x, t1 - 0.02, t1 + 0.02


def _spying_grouped_swiglu(record):
    orig = tops.grouped_swiglu

    def spy(x, w1, w3, w2, counts_full=None, counts_major=None, **kw):
        if counts_major is not None:
            record.append((counts_full.clone(), counts_major.clone()))
        return orig(x, w1, w3, w2, counts_full, counts_major, **kw)
    return spy


def test_counts_major_reaches_kernel_setp_path(world1, monkeypatch):
    """The S-ETP body orders each local sub-expert's rows FULL-first /
    MAJOR-only-second and passes counts_major to the grouped kernel, while
    matching the dense oracle (``test_dispatch.py``'s JAX check)."""
    cfg = get_config(ARCH)
    prepared, x, tm, tn = _two_t_setup()
    pol = tpolicy.TwoTDrop(partition_p=2, use_kernel=True, t_major=tm,
                           t_minor=tn, fused_pipeline=False)
    record = []
    monkeypatch.setattr(tops, "grouped_swiglu", _spying_grouped_swiglu(record))
    layer = _t(prepared)
    placed = tsetp.place_params_strided(layer, 1)
    xt = torch.from_numpy(x)
    y, overflow = tsetp.setp_moe_forward(
        placed, xt[None], cfg, world1, policy=pol, cap_factor=4.0,
        local_cap_factor=4.0, wire_dtype=torch.float32, return_overflow=True)
    pairs = pol.route(layer, xt, cfg)
    y_ref = tmoe.moe_forward_ref(layer, xt, cfg, pairs=pairs)
    np.testing.assert_allclose(y[0].numpy(), y_ref.numpy(), atol=2e-4,
                               rtol=1e-4)
    assert int(overflow) == 0
    assert record, "the grouped kernel never saw counts_major on S-ETP"
    assert int(record[-1][1].sum()) > 0, "no MAJOR-only rows reached it"


def test_setp_overflow_counter_surfaces(world1):
    """Starved capacities report overflow > 0; ample capacity exactly 0 —
    and the counts equal JAX's."""
    cfg_t, cfg_j = get_config(ARCH), jax_config(ARCH)
    prepared, x, _, _ = _two_t_setup(1)
    pt = tpolicy.TwoTDrop(partition_p=2, t_major=-1.0, t_minor=-1.0)
    pj = jpolicy.TwoTDrop(partition_p=2, t_major=-1.0, t_minor=-1.0)
    mesh = make_host_mesh(1)
    placed_t = tsetp.place_params_strided(_t(prepared), 1)
    placed_j = jsetp.place_params_strided(
        {k: jnp.asarray(v) for k, v in prepared.items()}, 1)
    kws = [dict(cap_factor=4.0, local_cap_factor=4.0),
           dict(cap_factor=4.0, local_cap_factor=0.05, cap_multiple=1)]
    got = []
    for kw in kws:
        y, of = tsetp.setp_moe_forward(placed_t, torch.from_numpy(x)[None],
                                       cfg_t, world1, policy=pt,
                                       return_overflow=True, **kw)
        _, of_j = _jax_setp(placed_j, jnp.asarray(x)[None], cfg_j, mesh,
                            policy=pj, return_overflow=True, **kw)
        assert int(of) == int(of_j)
        assert bool(torch.isfinite(y).all())
        got.append(int(of))
    assert got[0] == 0 and got[1] > 0


@pytest.mark.parametrize("name", ["2t", "load_aware", "per_layer"])
@pytest.mark.parametrize("wire", ["float32", "bfloat16"])
def test_setp_world_of_one_equals_jax(world1, name, wire):
    """``setp_moe_forward`` in a world of one against JAX's on a one-device
    mesh: the same prepared layer and tokens, the buffer path (the CPU
    default), the float32 or the bf16 wire, overflow equal."""
    cfg_t, cfg_j = get_config(ARCH), jax_config(ARCH)
    rng = np.random.default_rng(2)
    params = _layer_params(rng, cfg_j, router_scale=20.0)
    x = (rng.normal(size=(2, 16, cfg_j.d_model)) * 0.5).astype(np.float32)
    pj = jpolicy.make_policy(name, cfg_j.dualsparse)
    prepared, pj = pj.prepare({k: jnp.asarray(v) for k, v in params.items()},
                              cfg_j, jnp.asarray(x.reshape(-1, x.shape[-1])),
                              n_ep_devices=1)
    pt = tpolicy.make_policy(name, cfg_t.dualsparse)
    if name == "2t":
        pt = dataclasses.replace(pt, t_major=float(pj.t_major),
                                 t_minor=float(pj.t_minor))
    mesh = make_host_mesh(1)
    y_j, of_j = _jax_setp(prepared, jnp.asarray(x), cfg_j, mesh, policy=pj,
                          wire_dtype=getattr(jnp, wire),
                          return_overflow=True)
    y_t, of_t = tsetp.setp_moe_forward(
        _t(_np(prepared)), torch.from_numpy(x), cfg_t, world1, policy=pt,
        wire_dtype=getattr(torch, wire), return_overflow=True)
    assert y_t.dtype == torch.float32 and y_t.shape == x.shape
    _close(y_t.numpy(), y_j, F32_TOL if wire == "float32" else BF16_TOL)
    assert int(of_t) == int(of_j)


def test_setp_stats_equal_jax(world1):
    """``return_stats``: the obs per-layer dict (kept-pair histogram over
    the global sub-expert ids, mode counts, overflow) equals JAX's."""
    cfg_t, cfg_j = get_config(ARCH), jax_config(ARCH)
    rng = np.random.default_rng(4)
    params = _layer_params(rng, cfg_j, router_scale=20.0)
    x = (rng.normal(size=(1, 32, cfg_j.d_model)) * 0.5).astype(np.float32)
    pj = jpolicy.make_policy("load_aware", cfg_j.dualsparse)
    prepared, pj = pj.prepare({k: jnp.asarray(v) for k, v in params.items()},
                              cfg_j, jnp.asarray(x[0]), n_ep_devices=1)
    _, st_j = _jax_setp(prepared, jnp.asarray(x), cfg_j, make_host_mesh(1),
                        policy=pj, return_stats=True)
    _, st_t = tsetp.setp_moe_forward(
        _t(_np(prepared)), torch.from_numpy(x), cfg_t, world1,
        policy=tpolicy.make_policy("load_aware", cfg_t.dualsparse),
        return_stats=True)
    for k, v in st_j.items():
        np.testing.assert_array_equal(st_t[k].numpy(), np.asarray(v))
    assert int(st_t["dropped_pairs"]) > 0


# ---------------------------------------------------------------------------
# The differentiable route on one rank
# ---------------------------------------------------------------------------

def test_boundary_backward_is_plain_autograd_on_one_rank(world1):
    """On one rank ``block_take`` / ``block_gather`` / ``replicate`` and the
    differentiable AlltoAll, all-gather and psum_scatter are the identity
    on values and gradients: the gradient through them equals plain
    autograd's bit for bit."""
    from repro_torch.distributed import context as C
    from repro_torch.distributed import token_block
    ctx = world1
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 8, 6, generator=g)
    w = torch.randn(6, 6, generator=g)
    r = torch.randn(2, 8, 6, generator=g)

    def plain(x, w):
        return torch.tanh(x @ w) * r

    def through(x, w):
        block = token_block(2, 8, ctx, "model")
        h = C.block_take(ctx, x, block)
        h = torch.tanh(h @ C.replicate(ctx, w, ctx.axes()))
        h = C.all_to_all(ctx, h[None], "model")[0]
        h = C.psum_scatter(ctx, C.all_gather(ctx, h, "data"), "data")
        return C.block_gather(ctx, h, block) * r

    want = torch.autograd.grad(plain(x.requires_grad_(), w.requires_grad_())
                               .sum(), (x, w))
    got = torch.autograd.grad(through(x, w).sum(), (x, w))
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_collectives_refuse_to_cut_a_gradient(world1):
    """``DistContext``'s collectives return tensors with no history: given
    a tensor that requires grad while autograd records they raise, rather
    than cut the gradient silently; ``psum`` detaches by design (loads,
    stats, overflow)."""
    t = torch.ones(1, 3, requires_grad=True)
    for name in ("all_to_all", "all_gather", "psum_scatter"):
        with pytest.raises(RuntimeError, match="cut the gradient"):
            getattr(world1, name)(t, "model")
        with torch.no_grad():
            getattr(world1, name)(t, "model")
    assert not world1.psum(t, "model").requires_grad


@pytest.mark.parametrize("name", ["load_aware", "keep_all"])
def test_setp_gradient_world_of_one_equals_jax(world1, name):
    """The gradient of ``setp_moe_forward`` (``kernels=False``, float32
    wire) in a world of one against ``jax.grad`` of JAX's on a one-device
    mesh: x, the router and every expert, within 1e-5 of each one's
    largest magnitude."""
    cfg_t, cfg_j = get_config(ARCH), jax_config(ARCH)
    rng = np.random.default_rng(6)
    params = _layer_params(rng, cfg_j, router_scale=20.0)
    x = (rng.normal(size=(2, 16, cfg_j.d_model)) * 0.5).astype(np.float32)
    r = rng.normal(size=x.shape).astype(np.float32)
    if name == "keep_all":
        pj = jpolicy.TwoTDrop(partition_p=2, t_major=-1.0, t_minor=-1.0)
        pt = tpolicy.TwoTDrop(partition_p=2, t_major=-1.0, t_minor=-1.0)
    else:
        pj = jpolicy.make_policy(name, cfg_j.dualsparse)
        pt = tpolicy.make_policy(name, cfg_t.dualsparse)
    prepared, pj = pj.prepare({k: jnp.asarray(v) for k, v in params.items()},
                              cfg_j, jnp.asarray(x.reshape(-1, x.shape[-1])),
                              n_ep_devices=1)
    keys = ("wg", "w1", "w3", "w2")
    mesh = make_host_mesh(1)

    def jloss(xx, *ws):
        p = dict(prepared, **dict(zip(keys, ws)))
        y = jsetp.setp_moe_forward(p, xx, cfg_j, mesh, policy=pj,
                                   wire_dtype=jnp.float32, cap_factor=4.0,
                                   local_cap_factor=8.0)
        return jnp.sum(y * r)
    want = jax.jit(jax.grad(jloss, argnums=tuple(range(5))))(
        jnp.asarray(x), *(prepared[k] for k in keys))
    tp = _t(_np(prepared))
    leaves = [torch.from_numpy(x).requires_grad_()] + [
        tp[k].requires_grad_() for k in keys]
    y = tsetp.setp_moe_forward(dict(tp, **dict(zip(keys, leaves[1:]))),
                               leaves[0], cfg_t, world1, policy=pt,
                               wire_dtype=torch.float32, cap_factor=4.0,
                               local_cap_factor=8.0, kernels=False)
    got = torch.autograd.grad((y * torch.from_numpy(r)).sum(), leaves)
    for g_t, g_j in zip(got, want):
        _close(g_t.numpy(), np.asarray(g_j), F32_TOL)
