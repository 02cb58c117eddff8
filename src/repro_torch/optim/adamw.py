"""AdamW + cosine schedule + global-norm clipping on plain tensors.

The update is the JAX package's, term for term: float32 moments, bias
correction by ``1 - b^step``, ``u = -lr_t * (m̂ / (√v̂ + eps) + wd * p)``
with decay on every leaf (norms and embeddings included), and the clip
scale ``min(1, max_norm / max(gn, 1e-9))``. ``torch.optim.AdamW`` and
``clip_grad_norm_`` place eps and the clip's guard otherwise, so they are
not used. Params, grads and moments are name -> tensor dicts (the
trainable leaves of a model, ``models.model.trainable``); the state's
``step`` is an int32 scalar tensor, as the reference's, so checkpoints of
either package hold the same leaves.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Iterable, NamedTuple, Union

import torch

Tensors = Dict[str, torch.Tensor]


class AdamWState(NamedTuple):
    step: torch.Tensor     # () int32: updates taken
    mu: Tensors            # float32 first moments, by leaf name
    nu: Tensors            # float32 second moments, by leaf name


def cosine_schedule(peak_lr: float, total_steps: int, warmup: int = 100,
                    final_frac: float = 0.1) -> Callable:
    """step -> float32 learning rate: linear warmup to ``peak_lr``, then a
    cosine down to ``final_frac * peak_lr`` at ``total_steps``."""
    def lr(step):
        step = torch.as_tensor(step).to(torch.float32)
        warm = peak_lr * step / max(warmup, 1)
        prog = torch.clamp((step - warmup) / max(total_steps - warmup, 1),
                           0, 1)
        cos = final_frac + (1 - final_frac) * 0.5 * (
            1 + torch.cos(math.pi * prog))
        return torch.where(step < warmup, warm, peak_lr * cos)
    return lr


def _sum_squares(leaves) -> torch.Tensor:
    sums = [torch.sum(torch.square(g.float())) for g in leaves]
    return sum(sums[1:], sums[0])


def global_norm(grads: Tensors, dist=None,
                sharded: Iterable[str] = ()) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's float32 sum of squares:
    the norm of the global arrays. ``sharded`` names the leaves that hold
    one rank's slice of a stack split over ``dist``'s ``model`` axis (the
    S-ETP expert shards): their share is summed over ``model`` (not over
    ``data``, where the shards are replicas); every other leaf is
    replicated and counted once."""
    sharded = set(sharded)
    rep = [g for k, g in grads.items() if k not in sharded]
    total = _sum_squares(rep) if rep else None
    if sharded:
        if dist is None:
            raise ValueError("the norm over expert shards needs their EP "
                             "context")
        part = dist.psum(_sum_squares([grads[k] for k in grads
                                       if k in sharded]), "model")
        total = part if total is None else total + part
    return torch.sqrt(total)


def clip_by_global_norm(grads: Tensors, max_norm: float, dist=None,
                        sharded: Iterable[str] = ()):
    """Scale every leaf by ``min(1, max_norm / max(gn, 1e-9))`` IN PLACE;
    returns ``(grads, gn)`` with gn the norm before clipping
    (``global_norm`` over ``dist``'s expert shards ``sharded``)."""
    gn = global_norm(grads, dist, sharded)
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    for g in grads.values():
        g.mul_(scale.to(g.dtype))
    return grads, gn


@dataclasses.dataclass
class Optimizer:
    """``init(params) -> AdamWState``; ``update(grads, state, params,
    dist=None, sharded=())`` clips ``grads``, advances ``state`` and adds
    the update to ``params``, all in place, and returns the global grad
    norm before clipping (also kept as ``last_grad_norm``); ``sharded``
    names the leaves that are expert shards over ``dist``'s ``model``
    axis (``global_norm``)."""
    init: Callable
    update: Callable
    last_grad_norm: Union[torch.Tensor, None] = None


def adamw(lr: Union[float, Callable] = 1e-3, b1: float = 0.9,
          b2: float = 0.95, eps: float = 1e-8, weight_decay: float = 0.01,
          max_grad_norm: float = 1.0) -> Optimizer:
    lr_fn = lr if callable(lr) else (lambda _: lr)

    def init(params: Tensors) -> AdamWState:
        def zeros():
            return {k: torch.zeros_like(p, dtype=torch.float32)
                    for k, p in params.items()}
        step = torch.zeros((), dtype=torch.int32,
                           device=next(iter(params.values())).device)
        return AdamWState(step=step, mu=zeros(), nu=zeros())

    @torch.no_grad()
    def update(grads: Tensors, state: AdamWState, params: Tensors,
               dist=None, sharded: Iterable[str] = ()):
        if max_grad_norm:
            grads, gn = clip_by_global_norm(grads, max_grad_norm, dist,
                                            sharded)
        else:
            gn = global_norm(grads, dist, sharded)
        state.step.add_(1)
        stepf = state.step.to(torch.float32)
        b1t = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                         device=stepf.device), stepf)
        b2t = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                         device=stepf.device), stepf)
        lr_t = lr_fn(state.step)
        for k, p in params.items():
            g = grads[k].float()
            m, v = state.mu[k], state.nu[k]
            # the reference's expressions, every product and sum rounded
            # as there, in place on at most three leaf-sized temporaries
            # (written out of place, a large leaf's update holds ~6)
            m.mul_(b1).add_(g * (1 - b1))
            v.mul_(b2).add_(torch.square(g).mul_(1 - b2))
            u = torch.div(v, b2t).sqrt_().add_(eps)       # sqrt(v̂) + eps
            u = torch.div(m, b1t).div_(u)                 # m̂ / (...)
            u.add_(p.float() * weight_decay).mul_(-lr_t)
            p.add_(u.to(p.dtype))
            del g, u
        opt.last_grad_norm = gn
        return gn

    opt = Optimizer(init=init, update=update)
    return opt
