"""Shared building blocks: RMSNorm, RoPE and M-RoPE, the SwiGLU and GELU
MLPs, embed/unembed, the seeded normal init (scale 0.02, float32) the
JAX package uses, and the per-block activation checkpointing of an EP
context (``remat``)."""
from __future__ import annotations

import functools
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def normal(shape: Sequence[int], *, generator: Optional[torch.Generator],
           device: torch.device, scale: float = 0.02,
           dtype=torch.float32) -> nn.Parameter:
    """``scale * N(0, 1)`` of ``shape`` drawn from ``generator`` (float32).
    ``generator=None`` allocates without drawing (weights loaded later)."""
    if generator is None:
        t = torch.empty(tuple(shape), dtype=dtype, device=device)
    else:
        t = torch.randn(tuple(shape), generator=generator, device=device,
                        dtype=torch.float32).mul_(scale).to(dtype)
    return nn.Parameter(t, requires_grad=False)


def ones(shape: Sequence[int], *, device: torch.device) -> nn.Parameter:
    return nn.Parameter(torch.ones(tuple(shape), dtype=torch.float32,
                                   device=device), requires_grad=False)


def zeros(shape: Sequence[int], *, device: torch.device) -> nn.Parameter:
    return nn.Parameter(torch.zeros(tuple(shape), dtype=torch.float32,
                                    device=device), requires_grad=False)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rms_norm(x, weight, eps: float = 1e-5):
    dt = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * weight.float()).to(dt)


def layer_norm(x, weight, bias, eps: float = 1e-5):
    """LayerNorm with bias, in float32 inside, cast back to x's dtype."""
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.var(x, dim=-1, keepdim=True, unbiased=False)
    x = (x - mu) * torch.rsqrt(var + eps)
    return (x * weight.float() + bias.float()).to(dt)


# ---------------------------------------------------------------------------
# Rotary embeddings (RoPE + M-RoPE)
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float):
    return 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float32)
                            / head_dim))


def apply_rope(x, positions, theta: float = 1e4,
               mrope_sections: Sequence[int] = ()):
    """Rotate-half rotary embedding. x: (B, S, H, D); positions: (B, S), or
    (3, B, S) under M-RoPE, where ``mrope_sections`` (summing to D/2) picks
    the position stream of each frequency index (Qwen2-VL §2)."""
    d = x.shape[-1]
    inv = torch.as_tensor(rope_freqs(d, theta), device=x.device)   # (D/2,)
    if mrope_sections:
        if positions.ndim != 3:
            raise ValueError("M-RoPE needs (3, B, S) positions")
        ang3 = positions[..., None].float() * inv              # (3,B,S,D/2)
        n = len(mrope_sections)
        sec = np.repeat(np.arange(n), list(mrope_sections))     # (D/2,)
        sel = torch.as_tensor(sec[None, :] == np.arange(n)[:, None],
                              dtype=torch.float32, device=x.device)
        ang = torch.einsum("kbsd,kd->bsd", ang3, sel)
    else:
        ang = positions[..., None].float() * inv               # (B,S,D/2)
    cos = torch.cos(ang)[..., None, :]                          # (B,S,1,D/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def swiglu(x, w1, w3, w2):
    """SwiGLU FFN (paper Eq. 4): (Swish(x·W1) ⊙ (x·W3)) · W2."""
    h = F.silu(x @ w1) * (x @ w3)
    return h @ w2


def gelu_mlp(x, w_in, w_out):
    """GELU FFN with the tanh approximation, as the JAX package computes it
    (``jax.nn.gelu(approximate=True)``)."""
    return F.gelu(x @ w_in, approximate="tanh") @ w_out


class MLP(nn.Module):
    """Dense FFN: SwiGLU w1/w3 (d, f), w2 (f, d); or, for ``kind="gelu"``,
    w_in (d, f), w_out (f, d)."""

    def __init__(self, d_model: int, d_ff: int, *, device: torch.device,
                 generator: Optional[torch.Generator],
                 kind: str = "swiglu"):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.kind = kind
        if kind == "swiglu":
            self.w1 = normal((d_model, d_ff), **kw)
            self.w3 = normal((d_model, d_ff), **kw)
            self.w2 = normal((d_ff, d_model), **kw)
        else:
            self.w_in = normal((d_model, d_ff), **kw)
            self.w_out = normal((d_ff, d_model), **kw)

    def forward(self, x):
        if self.kind == "swiglu":
            return swiglu(x, self.w1, self.w3, self.w2)
        return gelu_mlp(x, self.w_in, self.w_out)


def apply_mlp(mlp: MLP, x, kind: str = "swiglu"):
    if kind != mlp.kind:
        raise ValueError(f"mlp kind {kind!r} does not match the module's "
                         f"{mlp.kind!r}")
    return mlp(x)


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------

class Embed(nn.Module):
    """Token embedding (vocab, d) and, unless tied, an lm_head (d, vocab)."""

    def __init__(self, vocab: int, d_model: int, tie: bool, *,
                 device: torch.device, generator: Optional[torch.Generator]):
        super().__init__()
        self.embedding = normal((vocab, d_model), generator=generator,
                                device=device)
        self.lm_head = None if tie else normal(
            (d_model, vocab), generator=generator, device=device)


def embed(emb: Embed, tokens):
    return emb.embedding[tokens]


def unembed(emb: Embed, x):
    if emb.lm_head is not None:
        return x @ emb.lm_head
    return x @ emb.embedding.T


def tensors_of(module: nn.Module) -> Dict[str, torch.Tensor]:
    """A module's direct parameters as a name -> tensor dict (the form the
    ``core`` functions take, mirroring the JAX param dicts)."""
    return {k: v for k, v in module.named_parameters(recurse=False)}


def _save_dots(ctx, op, *args, **kwargs):
    """``jax.checkpoint_policies.dots_with_no_batch_dims_saveable``: keep
    the outputs of matrix products without batch dims (``mm`` / ``addmm``,
    and the ``bmm`` of batch 1 that ``einsum`` lowers such a product to),
    recompute everything else."""
    from torch.utils.checkpoint import CheckpointPolicy
    aten = torch.ops.aten
    if op in (aten.mm.default, aten.addmm.default) or (
            op is aten.bmm.default and args[0].shape[0] == 1):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def remat(fn: Callable, dist, policy: Optional[str] = None) -> Callable:
    """``fn`` checkpointed as the JAX package's ``jax.checkpoint`` of a
    block when the EP context ``dist`` asks for it (``dist.remat``): its
    activations are recomputed in the backward pass, the collectives
    inside it again, in the same order on every rank. ``policy``
    (default ``dist.remat_policy``): "none" recomputes the whole block,
    "dots" keeps the products without batch dims. ``fn`` itself without
    a context or without ``remat``."""
    if dist is None or not dist.remat:
        return fn
    from torch.utils import checkpoint as ckpt
    policy = dist.remat_policy if policy is None else policy
    kw = {}
    if policy == "dots":
        kw["context_fn"] = functools.partial(
            ckpt.create_selective_checkpoint_contexts, _save_dots)

    def run(*args, **kwargs):
        return ckpt.checkpoint(fn, *args, use_reentrant=False, **kw,
                               **kwargs)
    return run
