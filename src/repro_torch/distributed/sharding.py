"""Which rows of a replicated (B, S, d) activation a rank works on.

The JAX package places activations with PartitionSpecs
(``repro/distributed/sharding.py::batch_spec``): the batch is split over
the (pod, data) prefix whose sizes divide it, the rest of the shape as the
caller asks; ``setp_moe_forward`` asks for the sequence split over the
expert axis when the expert axis divides S (prefill), and leaves it
replicated otherwise (decode, S = 1). Here each rank takes its block of
the replicated tensor by its mesh coordinates. The JAX package's
``spec_for``/``tree_shardings`` (parameter placement by logical axes) have
no counterpart: the port's model is replicated apart from the S-ETP
expert shards, which ``core.setp.shard_experts`` cuts.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

BATCH_AXES = ("pod", "data")


def batch_axes(batch_size: int, ctx) -> Tuple[str, ...]:
    """The (pod, data) prefix of mesh axes the batch is split over: each
    axis is taken while the product of the sizes taken divides
    ``batch_size`` (``batch_spec``'s rule)."""
    picked, prod = [], 1
    for axis in BATCH_AXES:
        n = ctx.size(axis) if ctx.has(axis) else 0
        if n and batch_size % (prod * n) == 0:
            picked.append(axis)
            prod *= n
    return tuple(picked)


class TokenBlock(NamedTuple):
    """One rank's block of a (B, S, d) activation: rows ``b0:b1`` of the
    batch and ``s0:s1`` of the sequence; ``batch_axes`` / ``seq_axis`` are
    the mesh axes each is split over (empty / None: replicated)."""
    b0: int
    b1: int
    s0: int
    s1: int
    batch_axes: Tuple[str, ...]
    seq_axis: Optional[str]

    def take(self, x):
        return x[self.b0:self.b1, self.s0:self.s1]


def token_block(B: int, S: int, ctx, seq_axis: Optional[str]) -> TokenBlock:
    """This rank's block: the batch split over ``batch_axes(B)`` (the
    coordinates of the axes taken, first axis major), the sequence over
    ``seq_axis`` when its size divides S, else replicated."""
    axes = batch_axes(B, ctx)
    n_b, idx = 1, 0
    for axis in axes:
        idx = idx * ctx.size(axis) + ctx.coord(axis)
        n_b *= ctx.size(axis)
    bl = B // n_b
    if seq_axis is not None and S % ctx.size(seq_axis) == 0:
        sl = S // ctx.size(seq_axis)
        s0 = ctx.coord(seq_axis) * sl
    else:
        seq_axis, sl, s0 = None, S, 0
    return TokenBlock(idx * bl, (idx + 1) * bl, s0, s0 + sl, axes, seq_axis)
