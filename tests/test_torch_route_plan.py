"""The MoE layer call's routing, 2T-Drop keep mask and dispatch plan in one
launch pair (``repro_torch.kernels.ops.moe_route_plan``).

On the CPU: the plain version against the composed path it replaces on
the card (``policy.route`` -> ``core.moe.fused_pipeline_args`` ->
``drop.sub_pair_outcome_counts`` / ``gating.expert_histogram``), bit for
bit, at reduced Qwen3, Qwen3-30B-A3B's router width, a DBRX-like
width and DeepSeek-V2-Lite's (64 experts, top-6, not renormalised), under scalar, per-token and per-layer thresholds, an overflowing
capacity, every pair dropped and tied router scores; the CUDA kernel's
plan algorithm (per-warp runs of a counting sort, counters from the
bucket counts) emulated in numpy against the plain version; the MoE
forward through the new path against the composed one (which calls take
the path is ``test_torch_dispatch.py``'s table of ``core.moe.expert_path``);
and the benchmark's probe on ``kernels.ops.fused_moe_pipeline``
seeing every MoE call of a served run with the counts the plan gave.

The tests marked ``cuda`` run the kernel on the card against its plain
version at T in {1, 8, 64, 256, 2048} for both widths: idx, modes, the
plan, the overflow and the counters equal, combine (and the sorted
combine weights, exact zeros where dropped) within rtol 1e-6. The
router inputs lie on a coarse grid and the thresholds halfway between a
row's scores, so no score sits within rounding of a threshold. They skip
without a card; run them on one with ``PYTHONPATH=src python -m pytest -m
cuda --noconftest tests/test_torch_route_plan.py`` (this file imports no
JAX)."""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core import drop, gating
from repro_torch.core import moe as moe_mod
from repro_torch.core.policy import PerLayerCalibrated2T, TwoTDrop
from repro_torch.kernels import ops, route_plan
from repro_torch.models import transformer as TT

# name -> (E, K, d, renorm): reduced Qwen3, Qwen3-30B-A3B's router width,
# a DBRX-like one (16 experts top-4, no renormalisation)
WIDTHS = {"qwen3_reduced": (4, 2, 32, True), "qwen3": (128, 8, 32, True),
          "dbrx": (16, 4, 48, False),
          # DeepSeek-V2-Lite's router: 64 experts, top-6, not renormalised
          "deepseek": (64, 6, 32, False)}
P = 2
PLAN_FIELDS = ("idx", "modes", "combine", "group_offsets", "counts_full",
               "counts_major", "tok_sorted", "combine_sorted", "overflow",
               "kept_full", "kept_major", "dropped", "expert_load")


class _Cfg:
    def __init__(self, K, renorm):
        self.top_k, self.router_norm_topk = K, renorm


def _router(rng, T, d, E):
    """x (T, d) and wg (d, E) on grids of 1/8 and 1/64: the logits are
    exact in float32 whatever the order of the sums, and two logits of a
    row differ by 1/512 or not at all."""
    x = (rng.integers(-16, 17, (T, d)) / 8).astype(np.float32)
    wg = (rng.integers(-8, 9, (d, E)) / 64).astype(np.float32)
    return torch.from_numpy(x), torch.from_numpy(wg)


def _per_token(norm, rank):
    """Per-token thresholds halfway between each row's ``rank``-th largest
    normalized score and the next smaller distinct one (half the score
    when no smaller one), so no score lies within rounding of them."""
    out = []
    for row in torch.sort(norm, dim=-1, descending=True).values:
        top = row[rank - 1]
        below = row[row < top]
        out.append((top + below[0]) / 2 if below.numel() else top / 2)
    return torch.stack(out)


def _scalar(norm, q):
    """A scalar threshold near the ``q`` quantile of the scores: halfway
    across the widest gap between distinct scores in a window around it."""
    u = torch.unique(norm.reshape(-1))
    n = u.numel()
    lo, hi = int(max(q - 0.1, 0) * (n - 1)), int(min(q + 0.1, 1) * (n - 1))
    gaps = u[lo + 1:hi + 1] - u[lo:hi]
    i = lo + int(torch.argmax(gaps))
    return (u[i] + u[i + 1]) / 2


def _case(width, form, T, seed=3):
    """(params, x, logits, policy, thresholds, capacity, cfg) of one case,
    on the CPU."""
    E, K, d, renorm = WIDTHS[width]
    rng = np.random.default_rng(seed)
    x, wg = _router(rng, T, d, E)
    f = 8
    params = {"wg": wg, "w1": torch.zeros(E * P, d, f),
              "w3": torch.zeros(E * P, d, f), "w2": torch.zeros(E * P, f, d)}
    logits = gating.gate_logits(x, wg)
    norm = gating.top_k_routing(logits, K, renorm).norm_score
    policy = TwoTDrop(partition_p=P, t_major=float(_scalar(norm, 0.3)),
                      t_minor=float(_scalar(norm, 0.6)))
    capacity = T
    hi = max(1, K // 4)
    lo = max(hi + 1, K // 2)
    if form == "per_token":
        policy = TwoTDrop(partition_p=P, t_major=_per_token(norm, lo),
                          t_minor=_per_token(norm, hi))
    elif form == "per_layer":
        params["thresholds"] = torch.stack([_scalar(norm, 0.3),
                                            _scalar(norm, 0.6)])
        policy = PerLayerCalibrated2T(partition_p=P)
    elif form == "scalar_tensor":
        policy = TwoTDrop(partition_p=P, t_major=torch.tensor(0.05),
                          t_minor=torch.tensor(0.2))
    elif form == "overflow":
        capacity = max(1, T * K // (2 * E))
    elif form == "all_dropped":
        policy = TwoTDrop(partition_p=P, t_major=2.0, t_minor=3.0)
    return (params, x, logits, policy, policy.two_t_thresholds(params),
            capacity, _Cfg(K, renorm))


def _composed(params, x, cfg, policy, capacity):
    """Today's composed path: the pairs, the fused call's arguments, the
    overflow and the obs counters."""
    pairs = policy.route(params, x, cfg)
    kw, overflow = moe_mod.fused_pipeline_args(params, pairs, P, capacity,
                                               True)
    kf, km, dr = drop.sub_pair_outcome_counts(pairs.keep, P)
    load = gating.expert_histogram(pairs.idx, params["w1"].shape[0],
                                   keep=pairs.keep)
    return pairs, kw, overflow, (kf, km, dr, load)


def _plan(logits, th, cfg, capacity, block_c=128):
    return ops.moe_route_plan(logits, *th, top_k=cfg.top_k,
                              renorm=cfg.router_norm_topk, p_factor=P,
                              capacity=capacity, pad=min(block_c, capacity))


def _eq(a, b):
    a, b = torch.as_tensor(a).cpu(), torch.as_tensor(b).cpu()
    assert a.dtype == b.dtype and a.shape == b.shape
    assert torch.equal(a, b), (a, b)


CPU_CASES = [("qwen3_reduced", "scalar"), ("qwen3_reduced", "per_token"),
             ("qwen3_reduced", "per_layer"), ("qwen3_reduced", "overflow"),
             ("qwen3", "scalar"), ("qwen3", "per_token"),
             ("qwen3", "scalar_tensor"), ("qwen3", "overflow"),
             ("qwen3", "all_dropped"), ("dbrx", "scalar"),
             ("dbrx", "per_token"), ("dbrx", "per_layer"),
             ("dbrx", "overflow"), ("deepseek", "scalar"),
             ("deepseek", "per_token"), ("deepseek", "overflow")]


@pytest.mark.parametrize("width,form", CPU_CASES)
def test_plain_version_matches_composed_path(width, form):
    params, x, logits, policy, th, capacity, cfg = _case(width, form, T=48)
    pairs, kw, overflow, (kf, km, dr, load) = _composed(
        params, x, cfg, policy, capacity)
    got = _plan(logits, th, cfg, capacity)
    _eq(got.idx, pairs.idx.reshape(-1, cfg.top_k, P)[..., 0] // P)
    _eq(got.modes, pairs.modes)
    _eq(got.combine, pairs.combine.reshape(-1, cfg.top_k, P)[..., 0])
    for name in ("group_offsets", "counts_full", "counts_major",
                 "tok_sorted", "combine_sorted"):
        _eq(getattr(got, name), kw[name])
    for name, want in (("overflow", overflow), ("kept_full", kf),
                       ("kept_major", km), ("dropped", dr),
                       ("expert_load", load)):
        _eq(getattr(got, name), want)
    if form == "overflow":
        assert int(got.overflow) > 0
    if form == "all_dropped":
        assert int(got.dropped) == x.shape[0] * cfg.top_k * P
        assert int(got.counts_full.sum() + got.counts_major.sum()) == 0


def test_tied_router_scores_take_the_lower_index():
    """Equal probabilities go to the lower expert id first, as
    ``lax.top_k`` and ``gating.top_k``'s stable sort order them, and the
    plan keeps arrival order among a bucket's pairs."""
    logits = torch.tensor([[0.0, 1.0, 0.5, 1.0, 1.0, 0.5],
                           [2.0, 2.0, 2.0, 2.0, 0.0, 0.0],
                           [0.0] * 6], dtype=torch.float32)
    got = ops.moe_route_plan(logits, 0.05, 0.3, top_k=3, renorm=True,
                             p_factor=P, capacity=8, pad=2)
    _eq(got.idx, torch.tensor([[1, 3, 4], [0, 1, 2], [0, 1, 2]],
                              dtype=torch.int32))
    _eq(got.modes, torch.full((3, 3), drop.MODE_FULL, dtype=torch.int32))
    # expert 1's pairs: token 0 then token 1, then token 2
    off = int(got.group_offsets[1])
    _eq(got.tok_sorted[off:off + 3], torch.tensor([0, 1, 2],
                                                  dtype=torch.int32))


def _emulated_plan(idx, modes, comb, E, capacity, pad, n_warps):
    """The CUDA plan launch in numpy: each warp's contiguous run of pairs
    counted per bucket, the counts scanned bucket-major and warp-minor, each
    run walked again in 32-pair steps (a pair's rank: its warp's running
    base plus the lower lanes of its bucket in the step), and the group
    arrays and counters from the bucket totals alone."""
    K = idx.shape[1]
    idx, modes, comb = (np.asarray(a).reshape(-1) for a in (idx, modes,
                                                             comb))
    N, B = idx.shape[0], 2 * E + 1
    bucket = np.where(modes > 0, 2 * idx + (modes == 1), 2 * E)
    seg = -(-N // n_warps)
    runs = [(min(w * seg, N), min(min(w * seg, N) + seg, N))
            for w in range(n_warps)]
    cnt = np.array([np.bincount(bucket[lo:hi], minlength=B)
                    for lo, hi in runs])
    tot = cnt.sum(0)
    boff = np.concatenate([[0], np.cumsum(tot)[:-1]])
    base = boff[None, :] + np.cumsum(cnt, 0) - cnt
    tok = np.zeros(N + pad, np.int32)
    csort = np.zeros(N + pad, np.float32)
    for w, (lo, hi) in enumerate(runs):
        for step in range(lo, hi, 32):
            b = bucket[step:min(step + 32, hi)]
            for lane, bl in enumerate(b):
                pos = base[w, bl] + np.sum(b[:lane] == bl)
                i = step + lane
                tok[pos] = i // K
                csort[pos] = comb[i] if modes[i] > 0 else 0.0
            for bl in np.unique(b):
                base[w, bl] += np.sum(b == bl)
    full, major = tot[0:2 * E:2], tot[1:2 * E:2]
    cf = np.minimum(full, capacity)
    cm = np.minimum(full + major, capacity) - cf
    over = (P * np.maximum(full - capacity, 0)
            + major - np.minimum(np.maximum(capacity - full, 0), major))
    load = np.stack([full + major] + [full] * (P - 1), 1).reshape(-1)
    kf, km = P * full.sum(), major.sum()
    return dict(group_offsets=boff[0:2 * E:2], counts_full=cf,
                counts_major=cm, tok_sorted=tok, combine_sorted=csort,
                overflow=over.sum(), kept_full=kf, kept_major=km,
                dropped=N * P - kf - km, expert_load=load)


@pytest.mark.parametrize("n_warps", [1, 3, 32])
@pytest.mark.parametrize("width,form", [("qwen3", "overflow"),
                                        ("qwen3", "per_token"),
                                        ("dbrx", "overflow"),
                                        ("qwen3_reduced", "all_dropped")])
def test_emulated_kernel_plan_matches_plain(width, form, n_warps):
    E = WIDTHS[width][0]
    params, x, logits, policy, th, capacity, cfg = _case(width, form, T=70)
    want = _plan(logits, th, cfg, capacity, block_c=16)
    got = _emulated_plan(want.idx, want.modes, want.combine, E, capacity,
                         min(16, capacity), n_warps)
    for name, v in got.items():
        np.testing.assert_array_equal(
            np.asarray(v, dtype=np.asarray(getattr(want, name)).dtype),
            getattr(want, name).numpy(), err_msg=name)


def _route_plan_on_the_cpu(monkeypatch):
    """Let the one resolver (``core.moe.expert_path``) see a CUDA device, so
    that a CPU call takes the route plan where the rules allow it; the
    wrappers still run their plain versions on the CPU tensors."""
    real = moe_mod.expert_path
    monkeypatch.setattr(moe_mod, "expert_path", lambda policy, device, **kw:
                        real(policy, torch.device("cuda"), **kw))


def _served_layer():
    cfg = get_config("qwen3-moe-30b-a3b").reduced()
    gen = torch.Generator().manual_seed(0)
    layer = moe_mod.MoELayer(cfg, device=torch.device("cpu"), generator=gen)
    calib = torch.randn(96, cfg.d_model, generator=gen)
    policy = TwoTDrop(use_kernel=True, drop_target=0.3)
    params, policy = policy.prepare(layer.weights(), cfg, calib)
    layer.load_weights(params)
    return cfg, layer, policy, torch.randn(3, 5, cfg.d_model, generator=gen)


@pytest.mark.parametrize("collect", [False, True])
def test_route_plan_forward_matches_composed_forward(monkeypatch, collect):
    """``_moe_forward`` through the route plan (its plain version on the
    CPU) gives the composed path's output and counters, bit for bit."""
    cfg, layer, policy, x = _served_layer()
    with torch.no_grad():
        y0, _, out0 = TT._moe_forward(layer, x, cfg, policy, collect=collect)
        calls = ops.moe_route_plan_ref.calls
        _route_plan_on_the_cpu(monkeypatch)
        y1, _, out1 = TT._moe_forward(layer, x, cfg, policy, collect=collect)
    assert ops.moe_route_plan_ref.calls == calls + 1
    _eq(y1, y0)
    if collect:
        assert out1.keys() == out0.keys()
        for k in out0:
            _eq(out1[k], out0[k])
    else:
        _eq(out1, out0)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    logits = torch.zeros(4, 8)
    ok = dict(top_k=2, renorm=True, p_factor=2, capacity=4, pad=4)
    with pytest.raises(ValueError, match="p_factor"):
        ops.moe_route_plan(logits, 0.1, 0.2, **dict(ok, p_factor=1))
    with pytest.raises(ValueError, match="top_k"):
        ops.moe_route_plan(logits, 0.1, 0.2, **dict(ok, top_k=9))
    with pytest.raises(TypeError, match="float32"):
        ops.moe_route_plan(logits.double(), 0.1, 0.2, **ok)
    with pytest.raises(ValueError, match="threshold"):
        route_plan.threshold_arg(torch.zeros(3), 4, 2, "cpu")
    assert route_plan.threshold_arg(torch.zeros(4), 4, 2, "cpu")[1:3] == \
        (1, 0)
    assert route_plan.threshold_arg(torch.zeros(4, 2), 4, 2, "cpu")[1:3] \
        == (2, 1)
    assert route_plan.threshold_arg(0.25, 4, 2, "cpu") == (None, 0, 0, 0.25)


def test_fused_probe_sees_every_served_moe_call(monkeypatch):
    """The benchmark's probe on ``kernels.ops.fused_moe_pipeline``
    (``perfbench.harness.program.fused_calls``) records every MoE call of a
    served run through the route plan, each with the counts its plan gave
    (the probe looks the wrapper up on the module at call time)."""
    from perfbench.harness import program
    from repro_torch.models.model import init_params
    from repro_torch.serving import GenerationConfig, PagedEngine
    cfg = get_config("qwen3-moe-30b-a3b").reduced()
    model = init_params(cfg, seed=0, device="cpu")
    calib = torch.randn(128, cfg.d_model,
                        generator=torch.Generator().manual_seed(1))
    _, policy = TwoTDrop(use_kernel=True, drop_target=0.25).prepare(
        model, cfg, calib)
    _route_plan_on_the_cpu(monkeypatch)
    plans, moe_calls = [], [0]
    real_plan, real_forward = ops.moe_route_plan, TT._moe_forward

    def plan(*a, **kw):
        plans.append(real_plan(*a, **kw))
        return plans[-1]

    def forward(*a, **kw):
        moe_calls[0] += 1
        return real_forward(*a, **kw)
    monkeypatch.setattr(ops, "moe_route_plan", plan)
    monkeypatch.setattr(TT, "_moe_forward", forward)
    eng = PagedEngine(cfg, model, n_slots=2, page_size=16, chunk_size=16,
                      max_prompt_len=32, max_new_tokens=4, policy=policy,
                      device="cpu")
    gen = GenerationConfig(max_new_tokens=4, temperature=0.0, eos_token=-1)
    rng = np.random.default_rng(0)
    for n in (20, 9):
        eng.submit(rng.integers(1, cfg.vocab_size, n).tolist(), gen)
    calls = []
    with program.fused_calls(calls):
        eng.run()
    assert moe_calls[0] > 0
    assert len(calls) == len(plans) == moe_calls[0]
    for call, p in zip(calls, plans):
        _eq(call.counts_full, p.counts_full)
        _eq(call.counts_major, p.counts_major)
        assert call.n_pos == p.tok_sorted.shape[0]
        assert call.p_factor == P


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["scalar", "per_token", "overflow"])
@pytest.mark.parametrize("width", ["qwen3", "dbrx", "deepseek"])
@pytest.mark.parametrize("T", [1, 8, 64, 256, 2048])
def test_kernel_matches_plain(cuda, T, width, form):
    params, x, logits, policy, th, capacity, cfg = _case(width, form, T,
                                                         seed=T)
    want = _plan(logits, th, cfg, capacity)
    launches = ops.moe_route_plan.launches
    got = _plan(logits.to(cuda), tuple(
        t.to(cuda) if isinstance(t, torch.Tensor) else t for t in th), cfg,
        capacity)
    torch.cuda.synchronize()
    assert ops.moe_route_plan.launches == launches + 1
    for name in PLAN_FIELDS:
        if name not in ("combine", "combine_sorted"):
            _eq(getattr(got, name), getattr(want, name))
    for name in ("combine", "combine_sorted"):
        torch.testing.assert_close(getattr(got, name).cpu(),
                                   getattr(want, name), rtol=1e-6, atol=0)
