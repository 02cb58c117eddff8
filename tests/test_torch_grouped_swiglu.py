"""The port's grouped SwiGLU (its plain version, which the CPU path of
``repro_torch.kernels.ops.grouped_swiglu`` runs) against the JAX package's
``grouped_swiglu`` in Pallas interpret mode, on the same numpy inputs: P 1,
2 and 4, capacities and widths that are not multiples of the tiles, an
explicit ``n_minor_start`` (in the kernel's padded virtual coordinate),
zero counts and ``None`` counts, and a skewed case whose groups sit on
both sides of the CUDA tiles' few-row threshold R (exactly R and R+1 live
rows, one group at capacity, an empty one, MAJOR-only rows).

Tolerance: rel_err <= 1e-6 in float32 — both sides compute the same masked
rows; only the order of the sums inside each matrix product differs. Rows
at or past ``counts_full + counts_major`` are exact zeros on both sides.
With bfloat16 operands (the S-ETP wire type) h is rounded to bf16 before
the down product and the float32 result cast to bf16 on both sides:
rel_err <= 1e-3 on the outputs widened to float32 (one bf16 ulp where an
h element's float32 sums straddle a rounding boundary; measured 0 to
2.7e-4 on these cases).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import dualsparse_ffn as tdsf
from repro_torch.kernels import ops as tops

REL_TOL = 1e-6

# name: (seed, E, C, d, f, P, block_c, block_f, n_minor_start, counts)
# f is the sub-expert width; counts "rand" draws cf, cm <= C // 2,
# "none" passes None for both, "full_only" passes cf and None for cm
CASES = {
    "p1_blocks": (0, 4, 64, 128, 256, 1, 32, 64, None, "rand"),
    "p1_half_unaligned": (1, 2, 100, 96, 160, 1, 32, 32, None, "rand"),
    "p1_tiny_padding": (2, 1, 7, 64, 96, 1, 8, 16, None, "rand"),
    "p1_ragged_c": (3, 8, 33, 64, 128, 1, 16, 64, None, "rand"),
    "p1_odd_f": (4, 3, 12, 32, 45, 1, 8, 16, None, "rand"),
    "p2": (5, 2, 32, 32, 32, 2, 16, 16, None, "rand"),
    "p2_ragged_c": (6, 3, 17, 16, 24, 2, 8, 8, None, "rand"),
    "p4": (7, 2, 16, 16, 16, 4, 8, 8, None, "rand"),
    "p2_sub_padding": (8, 1, 8, 8, 12, 2, 8, 8, None, "rand"),
    "p1_split_disabled": (9, 2, 16, 16, 32, 1, 8, 16, 32, "rand"),
    "p2_explicit_minor_start": (10, 2, 16, 16, 12, 2, 8, 8, 21, "rand"),
    "p2_none_counts": (11, 2, 16, 16, 16, 2, 8, 8, None, "none"),
    "p1_full_counts_only": (12, 3, 16, 32, 64, 1, 16, 32, None,
                            "full_only"),
    "zero_counts": (13, 2, 32, 64, 128, 1, 32, 128, None, "zero"),
    "counts_past_capacity": (14, 3, 16, 32, 64, 2, 8, 32, None, "over"),
    "skewed_rows": (15, 6, tdsf.FEW_ROWS + 8, 32, 24, 2, 8, 8, None,
                    "skewed"),
    # d not a multiple of the tensor-core tile's 16-element k step, f not
    # a multiple of one 16-byte copy of bf16 values
    "p1_odd_widths": (16, 3, 20, 40, 45, 1, 8, 16, 21, "rand"),
    "p2_odd_widths": (17, 2, 16, 24, 21, 2, 8, 8, None, "rand"),
}


def _inputs(seed, E, C, d, f, P, counts):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((E, C, d)) * 0.5).astype(np.float32)
    w1 = (rng.standard_normal((E * P, d, f)) * 0.1).astype(np.float32)
    w3 = (rng.standard_normal((E * P, d, f)) * 0.1).astype(np.float32)
    w2 = (rng.standard_normal((E * P, f, d)) * 0.1).astype(np.float32)
    cf = rng.integers(0, C // 2 + 1, E).astype(np.int32)
    cm = rng.integers(0, C // 2 + 1, E).astype(np.int32)
    if counts == "none":
        cf = cm = None
    elif counts == "full_only":
        cm = None
    elif counts == "zero":
        cf = np.zeros(E, np.int32)
        cm = np.zeros(E, np.int32)
    elif counts == "over":          # cf + cm past C, and cf past C once
        cf = np.asarray([C + 3, C - 2, 5][:E], np.int32)
        cm = np.asarray([4, 6, C][:E], np.int32)
    elif counts == "skewed":        # live rows R, R+1, C, 0, 3, 1
        R = tdsf.FEW_ROWS
        live = np.asarray([R, R + 1, C, 0, 3, 1], np.int32)
        cf = np.asarray([R - 5, R + 1, C - 7, 0, 0, 1], np.int32)
        cm = live - cf
    return x, w1, w3, w2, cf, cm


@pytest.mark.parametrize("name", list(CASES))
def test_grouped_swiglu_matches_jax(name):
    seed, E, C, d, f, P, bc, bf, nms, counts = CASES[name]
    x, w1, w3, w2, cf, cm = _inputs(seed, E, C, d, f, P, counts)
    kw = dict(p_factor=P, n_minor_start=nms, block_c=bc, block_f=bf)

    def jarr(a):
        return None if a is None else jnp.asarray(a)

    def tarr(a):
        return None if a is None else torch.from_numpy(a)
    want = np.asarray(jops.grouped_swiglu(
        *map(jarr, (x, w1, w3, w2, cf, cm)), **kw))
    calls = tops.grouped_swiglu_ref.calls
    got = tops.grouped_swiglu(*map(tarr, (x, w1, w3, w2, cf, cm)),
                              **kw).numpy()
    assert tops.grouped_swiglu_ref.calls == calls + 1
    assert got.shape == want.shape == (E, C, d) and got.dtype == np.float32
    live = np.full(E, C) if cf is None else \
        cf + (0 if cm is None else cm)
    dead = np.arange(C)[None, :] >= live[:, None]                 # (E, C)
    assert (got[dead] == 0).all() and (want[dead] == 0).all()
    if counts == "zero":
        assert dead.all()
        return
    err = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert err <= REL_TOL, f"rel_err {err:.3e}"


BF16_TOL = 1e-3


@pytest.mark.parametrize("name", ["p1_blocks", "p1_odd_f", "p2", "p4",
                                  "counts_past_capacity", "skewed_rows",
                                  "p1_odd_widths", "p2_odd_widths"])
def test_grouped_swiglu_bf16_matches_jax(name):
    """bf16 operands (the S-ETP buffer path's): the plain version against
    the Pallas kernel in interpret mode; dead rows exact zeros."""
    seed, E, C, d, f, P, bc, bf, nms, counts = CASES[name]
    x, w1, w3, w2, cf, cm = _inputs(seed, E, C, d, f, P, counts)
    kw = dict(p_factor=P, n_minor_start=nms, block_c=bc, block_f=bf)
    want = jops.grouped_swiglu(
        *(jnp.asarray(a).astype(jnp.bfloat16) for a in (x, w1, w3, w2)),
        jnp.asarray(cf), jnp.asarray(cm), **kw)
    got = tops.grouped_swiglu(
        *(torch.from_numpy(a).bfloat16() for a in (x, w1, w3, w2)),
        torch.from_numpy(cf), torch.from_numpy(cm), **kw)
    assert want.dtype == jnp.bfloat16 and got.dtype == torch.bfloat16
    want = np.asarray(want.astype(jnp.float32))
    got = got.float().numpy()
    live = np.minimum(cf + cm, C)
    dead = np.arange(C)[None, :] >= live[:, None]
    assert (got[dead] == 0).all() and (want[dead] == 0).all()
    err = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert err <= BF16_TOL, f"rel_err {err:.3e}"


def test_grouped_swiglu_major_rows_skip_minor_neurons():
    """MAJOR-only rows equal FULL rows of weights whose MINOR neurons are
    zeroed (the default split at f // 2)."""
    x, w1, w3, w2, _, _ = _inputs(20, 2, 16, 32, 64, 1, "rand")
    z = torch.zeros(2, dtype=torch.int32)
    full = torch.full((2,), 16, dtype=torch.int32)
    t = {k: torch.from_numpy(v) for k, v in dict(x=x, w1=w1, w3=w3,
                                                 w2=w2).items()}
    got = tops.grouped_swiglu(t["x"], t["w1"], t["w3"], t["w2"], z, full)
    w1m, w3m = t["w1"].clone(), t["w3"].clone()
    w1m[:, :, 32:] = 0
    w3m[:, :, 32:] = 0
    want = tops.grouped_swiglu(t["x"], w1m, w3m, t["w2"])
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


def test_clamped_counts_keep_the_function():
    """The counts the CUDA tiles clamp to the capacity on the device
    (``swiglu_tiles.cuh::group_rows``: ``min(cf, C)`` FULL rows,
    ``min(cf + cm, C)`` live rows) give the plain version's result bit for
    bit."""
    seed, E, C, d, f, P, _, _, _, counts = CASES["counts_past_capacity"]
    x, w1, w3, w2, cf, cm = (None if a is None else torch.from_numpy(a)
                             for a in _inputs(seed, E, C, d, f, P, counts))
    cf_c = cf.clamp(max=C)
    cm_c = (cf + cm).clamp(max=C) - cf_c
    assert ((cf_c + cm_c) <= C).all() and (cm_c >= 0).all()
    want = tops.grouped_swiglu(x, w1, w3, w2, cf, cm, p_factor=P)
    got = tops.grouped_swiglu(x, w1, w3, w2, cf_c, cm_c, p_factor=P)
    assert torch.equal(got, want)


def test_grouped_swiglu_rejects_bad_inputs():
    x = torch.zeros((2, 4, 8))
    w = torch.zeros((4, 8, 6))
    w2 = torch.zeros((4, 6, 8))
    c = torch.zeros((2,), dtype=torch.int32)
    with pytest.raises(ValueError, match="sub-experts"):
        tops.grouped_swiglu(x, w, w, w2, c, c, p_factor=1)
    with pytest.raises(TypeError, match="int32"):
        tops.grouped_swiglu(x, w, w, w2, c.long(), c, p_factor=2)
    with pytest.raises(TypeError, match="float32"):
        tops.grouped_swiglu(x.double(), w, w, w2, c, c, p_factor=2)
    with pytest.raises(ValueError, match="counts"):
        tops.grouped_swiglu(x, w, w, w2, c[:1], c, p_factor=2)
