"""The EP context: a ``DeviceMesh`` with named axes and the collectives of
the S-ETP and ETP bodies over its axes.

The JAX package runs those bodies under ``shard_map`` with ``jax.lax``
collectives on named mesh axes; here every rank runs the body on its own
block and each collective runs over the process group of one mesh axis
(``DeviceMesh.get_group``), whose group ranks follow the axis coordinate.

Where the tensors travel: NCCL moves CUDA tensors itself; gloo moves host
tensors. A group whose backend is gloo therefore always has a CUDA tensor
copied to host memory before the collective and the result copied back
(``_host_route``) — the one place this happens, chosen by the group's
backend. That is how several ranks share one card (NCCL refuses two ranks
on one GPU): every expert product still runs on the card, only the wire is
host memory.

The ``DistContext`` methods copy into fresh buffers: their results carry
no autograd history. Training goes through the differentiable forms below
(``all_to_all``, ``all_gather``, ``psum_scatter``, ``block_take``,
``block_gather``, ``replicate``), whose backward passes call the same
methods, so they keep the host route. They reproduce the gradient JAX
takes through a ``shard_map`` with ``check_vma=False``: inside the body
each collective transposes to its own transpose (``all_to_all`` to
itself, ``all_gather`` and ``psum_scatter`` to each other); at the
boundary, which the port emulates with a replicated model, an input's
gradient is summed over the mesh axes its block is replicated on, and an
output's gradient is divided by the sizes of those axes. ``psum`` stays
outside the graph (loads, stats and overflow carry no gradient).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

_reduce_scatter = getattr(dist, "reduce_scatter_single", None) or \
    dist.reduce_scatter_tensor


def make_mesh(shape: Sequence[int], names: Sequence[str],
              device_type: str = "cpu") -> DeviceMesh:
    """A mesh over the ranks of the initialised default process group,
    row-major in ``shape`` (e.g. (1, 4) named ("data", "model"), or (2, 2)
    named ("ep", "tp") for ETP). ``device_type`` is where the groups'
    collectives run: "cpu" for gloo (CUDA tensors are routed through host
    memory), "cuda" for NCCL."""
    n = 1
    for s in shape:
        n *= s
    if n != dist.get_world_size():
        raise ValueError(f"mesh {tuple(shape)} needs {n} ranks; the world "
                         f"has {dist.get_world_size()}")
    return DeviceMesh(device_type, torch.arange(n).reshape(tuple(shape)),
                      mesh_dim_names=tuple(names))


@dataclasses.dataclass(frozen=True)
class DistContext:
    """How to distribute the MoE layers: the ``mesh`` and ``moe_impl``
    ("setp": the S-ETP AlltoAll path, ``core.setp``; the sparsity policy
    travels beside the context, as everywhere in the port). ``remat``
    checkpoints every block of a training forward
    (``torch.utils.checkpoint``); ``remat_policy`` "dots" keeps the
    outputs of the matrix products without batch dims and recomputes the
    rest, "none" recomputes the whole block."""
    mesh: DeviceMesh
    moe_impl: str = "setp"
    remat: bool = False
    remat_policy: str = "none"

    def __post_init__(self):
        if self.remat_policy not in ("none", "dots"):
            raise ValueError(f"remat_policy {self.remat_policy!r}: "
                             "'none' or 'dots'")
        # each axis' size and this rank's coordinate, read once: the mesh
        # computes them anew on every access (~60 us for a size)
        names = tuple(self.mesh.mesh_dim_names or ())
        object.__setattr__(self, "_sizes", dict(zip(
            names, (int(n) for n in self.mesh.mesh.shape))))
        object.__setattr__(self, "_coords", {
            a: self.mesh.get_local_rank(a) for a in names})

    # -- the mesh ---------------------------------------------------------

    def has(self, axis: str) -> bool:
        return axis in self._sizes

    def size(self, axis: str) -> int:
        return self._sizes.get(axis, 1)

    def coord(self, axis: str) -> int:
        return self._coords.get(axis, 0)

    def group(self, axis: str):
        return self.mesh.get_group(axis)

    def axes(self) -> Tuple[str, ...]:
        return tuple(self._sizes)

    def is_origin(self) -> bool:
        """Whether this rank sits at coordinate 0 of every axis."""
        return all(self.coord(a) == 0 for a in self.axes())

    # -- collectives (each returns a new tensor on the input's device) ----

    def _host_route(self, axis: str, t: torch.Tensor) -> bool:
        return t.is_cuda and dist.get_backend(self.group(axis)) == "gloo"

    @staticmethod
    def _no_history(t: torch.Tensor, name: str) -> None:
        """Refuse to cut a gradient: the result of these methods has no
        autograd history."""
        if torch.is_grad_enabled() and t.requires_grad:
            raise RuntimeError(
                f"DistContext.{name} would cut the gradient of a tensor "
                f"that requires grad: use distributed.context.{name}")

    def psum(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """Sum over the ranks of ``axis`` (``jax.lax.psum``); outside the
        autograd graph: the result has no history."""
        t = t.detach()
        if self.size(axis) == 1:
            return t.clone()
        host = self._host_route(axis, t)
        buf = t.cpu() if host else t.clone()
        dist.all_reduce(buf, group=self.group(axis))
        return buf.to(t.device) if host else buf

    def all_to_all(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """(n, ...) -> (n, ...): chunk i goes to the rank at coordinate i of
        ``axis``, and the result's chunk j came from coordinate j
        (``jax.lax.all_to_all(t, axis, 0, 0)``)."""
        self._no_history(t, "all_to_all")
        n = self.size(axis)
        if t.shape[0] != n:
            raise ValueError(f"all_to_all over {axis!r} needs a leading "
                             f"axis of {n}, got {tuple(t.shape)}")
        if n == 1:
            return t.clone()
        host = self._host_route(axis, t)
        src = t.contiguous().cpu() if host else t.contiguous()
        out = torch.empty_like(src)
        dist.all_to_all_single(out, src, group=self.group(axis))
        return out.to(t.device) if host else out

    def all_gather(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """(...) -> (n, ...): every rank's tensor, stacked by coordinate
        (``jax.lax.all_gather(t, axis, tiled=False)``)."""
        self._no_history(t, "all_gather")
        n = self.size(axis)
        if n == 1:
            return t[None].clone()
        host = self._host_route(axis, t)
        src = t.contiguous().cpu() if host else t.contiguous()
        parts = [torch.empty_like(src) for _ in range(n)]
        dist.all_gather(parts, src, group=self.group(axis))
        out = torch.stack(parts)
        return out.to(t.device) if host else out

    def host_view(self, t: torch.Tensor, axis: str = "model"
                  ) -> torch.Tensor:
        """The copy at coordinate 0 of ``axis``, on every rank: what the
        JAX package's host reads back from an array replicated over
        ``axis`` (its first device's shard). Replicated is not identical
        there — on decode each model rank computes the same tokens, and
        capacity overflow can drop different pairs on each — so the
        engines take their next tokens from this view, as JAX's host does
        before it feeds them to every device."""
        if self.size(axis) == 1:
            return t
        group = self.group(axis)
        host = self._host_route(axis, t)
        buf = t.contiguous().cpu() if host else t.clone()
        dist.broadcast(buf, src=dist.get_global_rank(group, 0), group=group)
        return buf.to(t.device) if host else buf

    def psum_scatter(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """(n, ...) -> (...): the sum over the ranks of ``axis``, chunk
        ``coord(axis)`` kept (``jax.lax.psum_scatter(t, axis,
        scatter_dimension=0, tiled=False)``)."""
        self._no_history(t, "psum_scatter")
        n = self.size(axis)
        if t.shape[0] != n:
            raise ValueError(f"psum_scatter over {axis!r} needs a leading "
                             f"axis of {n}, got {tuple(t.shape)}")
        if n == 1:
            return t[0].clone()
        host = self._host_route(axis, t)
        src = t.contiguous().cpu() if host else t.contiguous()
        # the collective scatters along dim 0 in blocks of out.shape[0]
        out = torch.empty((1,) + tuple(src.shape[1:]), dtype=src.dtype,
                          device=src.device)
        _reduce_scatter(out, src, group=self.group(axis))
        return out[0].to(t.device) if host else out[0]


# ---------------------------------------------------------------------------
# Differentiable collectives: the transposes of JAX's shard_map gradient
# ---------------------------------------------------------------------------

class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(fc, t, ctx, axis):
        fc.ctx, fc.axis = ctx, axis
        return ctx.all_to_all(t, axis)

    @staticmethod
    def backward(fc, g):
        return fc.ctx.all_to_all(g, fc.axis), None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(fc, t, ctx, axis):
        fc.ctx, fc.axis = ctx, axis
        return ctx.all_gather(t, axis)

    @staticmethod
    def backward(fc, g):
        return fc.ctx.psum_scatter(g, fc.axis), None, None


class _PsumScatter(torch.autograd.Function):
    @staticmethod
    def forward(fc, t, ctx, axis):
        fc.ctx, fc.axis = ctx, axis
        return ctx.psum_scatter(t, axis)

    @staticmethod
    def backward(fc, g):
        return fc.ctx.all_gather(g, fc.axis), None, None


def all_to_all(ctx: DistContext, t: torch.Tensor, axis: str) -> torch.Tensor:
    """``ctx.all_to_all`` whose backward is the same AlltoAll of the
    gradient."""
    return _AllToAll.apply(t, ctx, axis)


def all_gather(ctx: DistContext, t: torch.Tensor, axis: str) -> torch.Tensor:
    """``ctx.all_gather`` whose backward is ``psum_scatter``."""
    return _AllGather.apply(t, ctx, axis)


def psum_scatter(ctx: DistContext, t: torch.Tensor,
                 axis: str) -> torch.Tensor:
    """``ctx.psum_scatter`` whose backward is ``all_gather``."""
    return _PsumScatter.apply(t, ctx, axis)


def _psum_over(ctx: DistContext, t: torch.Tensor, axes) -> torch.Tensor:
    for ax in axes:
        t = ctx.psum(t, ax)
    return t


def _assemble(ctx: DistContext, t: torch.Tensor, block) -> torch.Tensor:
    """The replicated (B, S, ...) tensor from every rank's block: gathered
    over the sequence axis, then over the batch axes (last axis minor)."""
    if block.seq_axis is not None:
        t = torch.cat(list(ctx.all_gather(t, block.seq_axis)), dim=1)
    for axis in reversed(block.batch_axes):
        t = torch.cat(list(ctx.all_gather(t, axis)), dim=0)
    return t


def replicated_axes(ctx: DistContext, block=None,
                    split: Tuple[str, ...] = ()) -> Tuple[str, ...]:
    """The mesh axes a block is replicated on: every axis but those it is
    split on (``block``'s batch and sequence axes, or ``split``)."""
    if block is not None:
        split = tuple(block.batch_axes) + (
            (block.seq_axis,) if block.seq_axis is not None else ())
    return tuple(a for a in ctx.axes() if a not in split)


class _BlockTake(torch.autograd.Function):
    @staticmethod
    def forward(fc, x, ctx, block):
        fc.ctx, fc.block = ctx, block
        return block.take(x).clone()

    @staticmethod
    def backward(fc, g):
        ctx, block = fc.ctx, fc.block
        g = _assemble(ctx, g.contiguous(), block)
        return _psum_over(ctx, g, replicated_axes(ctx, block)), None, None


class _BlockGather(torch.autograd.Function):
    @staticmethod
    def forward(fc, y, ctx, block):
        fc.ctx, fc.block = ctx, block
        return _assemble(ctx, y, block)

    @staticmethod
    def backward(fc, g):
        ctx, block = fc.ctx, fc.block
        n = math.prod(ctx.size(a) for a in replicated_axes(ctx, block))
        g = block.take(g)
        return (g / n if n > 1 else g), None, None


class _Replicate(torch.autograd.Function):
    @staticmethod
    def forward(fc, w, ctx, axes):
        fc.ctx, fc.axes = ctx, axes
        return w.view_as(w)

    @staticmethod
    def backward(fc, g):
        return _psum_over(fc.ctx, g, fc.axes), None, None


def block_take(ctx: DistContext, x: torch.Tensor, block) -> torch.Tensor:
    """A shard_map input: this rank's block of the replicated ``x``
    (``block.take``). Backward: the blocks' gradients assembled over the
    axes the block is split on, then summed over the axes it is replicated
    on, so every rank holds the gradient of the whole ``x``."""
    return _BlockTake.apply(x, ctx, block)


def block_gather(ctx: DistContext, y: torch.Tensor, block) -> torch.Tensor:
    """A shard_map output: the replicated tensor from every rank's block.
    Backward: this rank's block of the gradient, divided by the product of
    the sizes of the axes the block is replicated on (each of those ranks
    computed the same block). Not ``torch.distributed.nn``'s all-gather,
    whose backward sums over ranks: here every rank holds the same full
    loss, so that sum would multiply the gradient by the world size."""
    return _BlockGather.apply(y, ctx, block)


def replicate(ctx: DistContext, w: torch.Tensor, axes) -> torch.Tensor:
    """A weight entering the body replicated over ``axes`` (the router on
    every axis, an expert shard on the token axes): the identity forward,
    its gradient summed over ``axes`` backward."""
    axes = tuple(a for a in axes if ctx.size(a) > 1)
    if not axes:
        return w
    return _Replicate.apply(w, ctx, axes)
