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
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

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
    travels beside the context, as everywhere in the port)."""
    mesh: DeviceMesh
    moe_impl: str = "setp"

    # -- the mesh ---------------------------------------------------------

    def has(self, axis: str) -> bool:
        return axis in (self.mesh.mesh_dim_names or ())

    def size(self, axis: str) -> int:
        if not self.has(axis):
            return 1
        return int(self.mesh.mesh.shape[
            self.mesh.mesh_dim_names.index(axis)])

    def coord(self, axis: str) -> int:
        return self.mesh.get_local_rank(axis) if self.has(axis) else 0

    def group(self, axis: str):
        return self.mesh.get_group(axis)

    # -- collectives (each returns a new tensor on the input's device) ----

    def _host_route(self, axis: str, t: torch.Tensor) -> bool:
        return t.is_cuda and dist.get_backend(self.group(axis)) == "gloo"

    def psum(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """Sum over the ranks of ``axis`` (``jax.lax.psum``)."""
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
