"""The port's fused MoE pipeline (its plain version, which the CPU path of
``repro_torch.kernels.ops.fused_moe_pipeline`` runs) against the JAX
package's ``fused_moe_pipeline`` in Pallas interpret mode, on the same
numpy inputs and plans.

Tolerance: rel_err <= 1e-6 in float32 — both sides compute the same rows
and the same per-token accumulation order; only the order of the sums
inside each matrix product differs. With bfloat16 operands (the S-ETP wire
type) both widen x and the weights to float32, round h to bf16 before the
down product and cast the float32 result to bf16: rel_err <= 1e-3 on the
outputs widened to float32 (an h element whose float32 sums land on two
sides of a bf16 rounding boundary differs by one bf16 ulp, 2**-8; measured
0 to 2.4e-5 on these cases). The ``skewed_rows`` case routes its
tokens so that the groups sit on both sides of the CUDA tiles' few-row
threshold R: exactly R and R+1 live rows, one group at capacity (with
overflow), an empty one, two with a few rows, MAJOR-only rows among
them."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dispatch as D
from repro.kernels import ops as jops
from repro_torch.kernels import dualsparse_ffn as tdsf
from repro_torch.kernels import ops as tops

REL_TOL = 1e-6

# name: (seed, T, K, E, P, d, f, capacity, keep_p, major_p, block_c,
#        block_f, n_minor_start)
CASES = {
    "p2_mode_grouped": (0, 48, 4, 6, 2, 32, 32, 64, 0.8, 0.4, 16, 128, None),
    "p1_sub_pairs": (1, 40, 3, 8, 1, 32, 48, 32, 0.9, 0.0, 16, 128, 48),
    "p1_half_split": (2, 40, 2, 5, 1, 32, 64, 48, 0.9, 0.5, 16, 128, None),
    "p1_ragged_f": (3, 40, 2, 3, 1, 32, 96, 48, 1.0, 0.0, 16, 64, 96),
    "p2_ragged_f": (4, 32, 2, 4, 2, 32, 96, 32, 0.9, 0.5, 16, 64, None),
    "p2_explicit_minor_start": (5, 32, 2, 4, 2, 32, 96, 32, 0.9, 0.5, 16,
                                64, 80),
    "overflow": (6, 64, 4, 4, 2, 32, 32, 8, 0.9, 0.3, 8, 128, None),
    # d not a multiple of the tensor-core tile's 16-element k step, f not
    # a multiple of one 16-byte copy of bf16 values
    "p1_odd_widths": (12, 40, 2, 5, 1, 40, 45, 32, 0.9, 0.5, 16, 128, 21),
    "p2_odd_widths": (13, 32, 2, 4, 2, 24, 21, 32, 0.9, 0.5, 16, 128, None),
    # T follows from the skewed group sizes (_skewed_groups)
    "skewed_rows": (11, None, 2, 6, 2, 32, 24, tdsf.FEW_ROWS + 8, 1.0, 0.4,
                    8, 128, None),
}


def _skewed_groups(R: int, cap: int):
    """(T, 2) expert choices, two distinct experts per token, giving groups
    0..5 R, R+1, cap+6 (past capacity), 0, 3 and 2-3 pairs."""
    sizes = [R, R + 1, cap + 6, 0, 3, 2]
    sizes[-1] += sum(sizes) % 2
    items = np.repeat(np.arange(len(sizes)), sizes)
    T = len(items) // 2
    group = np.stack([items[:T], items[T:]], axis=1).astype(np.int32)
    assert (group[:, 0] != group[:, 1]).all()
    return group


def _inputs(seed, T, K, E, P, d, f, cap, keep_p, major_p, block_c,
            empty_experts=False, group=None):
    rng = np.random.default_rng(seed)
    if group is not None:
        T, K = group.shape
    x = rng.standard_normal((T, d)).astype(np.float32)
    w1 = (rng.standard_normal((E * P, d, f)) * 0.1).astype(np.float32)
    w3 = (rng.standard_normal((E * P, d, f)) * 0.1).astype(np.float32)
    w2 = (rng.standard_normal((E * P, f, d)) * 0.1).astype(np.float32)
    hi = 1 if empty_experts else E
    if group is None:
        group = rng.integers(0, hi, (T, K)).astype(np.int32)
    keep = rng.random((T, K)) < keep_p
    major = (rng.random((T, K)) < major_p) & keep
    wts = (rng.random((T, K)) * keep).astype(np.float32)
    plan = D.sort_dispatch(jnp.asarray(group), jnp.asarray(keep),
                           n_groups=E, capacity=cap,
                           major_only=jnp.asarray(major))
    cf, cm = plan.kernel_counts(cap)
    tok_s, w_s = D.sorted_pair_arrays(plan, jnp.asarray(wts), index_div=K,
                                      pad=block_c)
    arrays = dict(x=x, w1=w1, w3=w3, w2=w2,
                  group_offsets=np.asarray(plan.group_offsets, np.int32),
                  counts_full=np.asarray(cf, np.int32),
                  counts_major=np.asarray(cm, np.int32),
                  tok_sorted=np.asarray(tok_s, np.int32),
                  combine_sorted=np.asarray(w_s, np.float32))
    return arrays, int(plan.overflow)


OPERANDS = ("x", "w1", "w3", "w2")


def _run_both(arrays, cap, P, block_c, block_f, nms, dtype="float32"):
    """Both packages' output, widened to float32; x and the weights in
    ``dtype`` (the plan arrays and combine weights as they are)."""
    kw = dict(capacity=cap, p_factor=P, n_minor_start=nms, block_c=block_c,
              block_f=block_f)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    y_jax = jops.fused_moe_pipeline(
        *(jnp.asarray(a).astype(jdt) if k in OPERANDS else jnp.asarray(a)
          for k, a in arrays.items()), **kw)
    y_torch = tops.fused_moe_pipeline(
        *(torch.from_numpy(np.array(a)).to(tdt) if k in OPERANDS
          else torch.from_numpy(np.array(a)) for k, a in arrays.items()),
        **kw)
    assert y_jax.dtype == jdt and y_torch.dtype == tdt
    return (np.asarray(y_jax.astype(jnp.float32)),
            y_torch.float().numpy())


def _rel_err(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("name", sorted(CASES))
def test_fused_pipeline_matches_jax(name):
    (seed, T, K, E, P, d, f, cap, keep_p, major_p, bc, bf,
     nms) = CASES[name]
    group = (_skewed_groups(tdsf.FEW_ROWS, cap) if name == "skewed_rows"
             else None)
    arrays, overflow = _inputs(seed, T, K, E, P, d, f, cap, keep_p, major_p,
                               bc, group=group)
    if name == "skewed_rows":
        live = arrays["counts_full"] + arrays["counts_major"]
        R = tdsf.FEW_ROWS
        assert live.tolist() == [R, R + 1, cap, 0, 3, live[5]]
        assert overflow > 0 and arrays["counts_major"][:3].min() > 0
    if name == "overflow":
        assert overflow > 0
    elif major_p > 0:
        assert arrays["counts_major"].sum() > 0
    y_jax, y_torch = _run_both(arrays, cap, P, bc, bf, nms)
    assert y_torch.shape == y_jax.shape and y_torch.dtype == np.float32
    assert _rel_err(y_torch, y_jax) <= REL_TOL


BF16_TOL = 1e-3


@pytest.mark.parametrize("name", ["p2_mode_grouped", "p1_sub_pairs",
                                  "p2_ragged_f", "overflow", "skewed_rows",
                                  "p1_odd_widths", "p2_odd_widths"])
def test_fused_pipeline_bf16_matches_jax(name):
    """bf16 operands, as the S-ETP body hands them to the kernel: the plain
    version against the Pallas kernel in interpret mode."""
    (seed, T, K, E, P, d, f, cap, keep_p, major_p, bc, bf,
     nms) = CASES[name]
    group = (_skewed_groups(tdsf.FEW_ROWS, cap) if name == "skewed_rows"
             else None)
    arrays, _ = _inputs(seed, T, K, E, P, d, f, cap, keep_p, major_p, bc,
                        group=group)
    y_jax, y_torch = _run_both(arrays, cap, P, bc, bf, nms, "bfloat16")
    assert _rel_err(y_torch, y_jax) <= BF16_TOL
    # the bf16 function is not the float32 one: h is rounded
    y32, _ = _run_both(arrays, cap, P, bc, bf, nms)
    assert _rel_err(y_torch, y32) > _rel_err(y_torch, y_jax)


def test_fused_pipeline_bf16_operands_must_share_a_type():
    arrays, _ = _inputs(8, 8, 2, 4, 2, 16, 16, 16, 1.0, 0.0, 8)
    args = {k: torch.from_numpy(v) for k, v in arrays.items()}
    mixed = dict(args, x=args["x"].bfloat16())
    with pytest.raises(TypeError, match="one type"):
        tops.fused_moe_pipeline(*mixed.values(), capacity=16, p_factor=2)
    bf = {k: v.bfloat16() if k in OPERANDS else v for k, v in args.items()}
    bad = dict(bf, combine_sorted=args["combine_sorted"].bfloat16())
    with pytest.raises(TypeError, match="float32"):
        tops.fused_moe_pipeline(*bad.values(), capacity=16, p_factor=2)
    y = tops.fused_moe_pipeline(*bf.values(), capacity=16, p_factor=2)
    assert y.dtype == torch.bfloat16


@pytest.mark.parametrize("P", [1, 2])
def test_fused_pipeline_empty_experts(P):
    """Experts with no rows contribute nothing; tokens whose pairs were all
    dropped get an exact zero row."""
    arrays, _ = _inputs(7, 12, 2, 6, P, 16, 32, 32, 0.7, 0.3, 8,
                        empty_experts=True)
    assert (arrays["counts_full"][1:] + arrays["counts_major"][1:]).sum() == 0
    y_jax, y_torch = _run_both(arrays, 32, P, 8, 128, None)
    assert _rel_err(y_torch, y_jax) <= REL_TOL
    np.testing.assert_array_equal(y_torch == 0, y_jax == 0)


@pytest.mark.parametrize("f,P,block_f,nms,expected", [
    (64, 1, 128, None, 32),     # f // 2 at P == 1
    (63, 1, 128, None, 63),     # odd f: no split
    (64, 1, 128, 64, 64),       # caller passes the full width
    (48, 2, 128, None, 48),     # sub-expert 0 at P > 1
    (96, 2, 64, None, 96),      # padded sub-expert width 128 -> 96 real
    (96, 2, 64, 160, 128),      # padded coords: 96 of sub 0 + 32 of sub 1
    (96, 4, 64, 256, 192),
])
def test_resolve_n_major(f, P, block_f, nms, expected):
    assert tdsf.resolve_n_major(f, P, nms, block_f) == expected


def test_combine_order_skips_uncomputed_positions():
    """Positions past a group's clamped rows (overflow, drops, padding) are
    left out; each token's positions come in increasing order."""
    tok = torch.tensor([2, 0, 2, 1, 0, 2, 1, 0, 0], dtype=torch.int32)
    offs = torch.tensor([0, 3, 3], dtype=torch.int32)     # group 1 empty
    cf = torch.tensor([2, 0, 2], dtype=torch.int32)
    cm = torch.tensor([1, 0, 1], dtype=torch.int32)
    # group 0 computes positions 0..2, group 2 positions 3..5; 6.. are not
    order, start, count = tdsf.combine_order(tok, offs, cf, cm, 3)
    lists = [order[s:s + c].tolist()
             for s, c in zip(start.tolist(), count.tolist())]
    assert lists == [[1, 4], [3], [0, 2, 5]]


def test_fused_pipeline_wrapper_rejects_bad_inputs():
    arrays, _ = _inputs(8, 8, 2, 4, 2, 16, 16, 16, 1.0, 0.0, 8)
    args = {k: torch.from_numpy(v) for k, v in arrays.items()}
    bad = dict(args, x=args["x"].double())
    with pytest.raises(TypeError):
        tops.fused_moe_pipeline(*bad.values(), capacity=16, p_factor=2)
    bad = dict(args, tok_sorted=args["tok_sorted"].long())
    with pytest.raises(TypeError):
        tops.fused_moe_pipeline(*bad.values(), capacity=16, p_factor=2)
    with pytest.raises(ValueError):
        tops.fused_moe_pipeline(*args.values(), capacity=16, p_factor=1)
    bad = dict(args, w2=args["w2"].transpose(1, 2))
    with pytest.raises(ValueError):
        tops.fused_moe_pipeline(*bad.values(), capacity=16, p_factor=2)


def test_cpu_tensors_take_the_plain_version():
    arrays, _ = _inputs(9, 8, 2, 4, 2, 16, 16, 16, 1.0, 0.0, 8)
    launches = tops.fused_moe_pipeline.launches
    calls = tops.fused_moe_pipeline_ref.calls
    tops.fused_moe_pipeline(*(torch.from_numpy(a) for a in arrays.values()),
                            capacity=16, p_factor=2)
    assert tops.fused_moe_pipeline.launches == launches
    assert tops.fused_moe_pipeline_ref.calls == calls + 1
