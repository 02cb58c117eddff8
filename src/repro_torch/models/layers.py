"""Shared building blocks: RMSNorm, RoPE, M-RoPE and YaRN, the SwiGLU and GELU
MLPs, embed/unembed, the seeded normal init (scale 0.02, float32) the
JAX package uses, and the per-block activation checkpointing of an EP
context (``remat``)."""
from __future__ import annotations

import functools
import math
from typing import Callable, Dict, NamedTuple, Optional, Sequence

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


class Yarn(NamedTuple):
    """YaRN rotary scaling as DeepSeek-V2 publishes it: ``factor`` over
    ``original_max_pos`` positions, the correction range from
    ``beta_fast`` / ``beta_slow`` rotations, and the two mscale
    coefficients (of the cos / sin tables and of the softmax scale)."""
    factor: float
    original_max_pos: int
    beta_fast: float
    beta_slow: float
    mscale: float
    mscale_all_dim: float


def yarn_of(cfg) -> Optional[Yarn]:
    """The config's YaRN settings, or None for plain RoPE (factor 1)."""
    if cfg.rope_scaling_factor == 1.0:
        return None
    return Yarn(cfg.rope_scaling_factor, cfg.rope_original_max_pos,
                cfg.rope_beta_fast, cfg.rope_beta_slow, cfg.rope_mscale,
                cfg.rope_mscale_all_dim)


def yarn_mscale(scale: float, mscale: float = 1.0) -> float:
    """0.1 m ln(s) + 1 (1 for s <= 1)."""
    if scale <= 1:
        return 1.0
    return 0.1 * mscale * math.log(scale) + 1.0


def yarn_correction_range(head_dim: int, theta: float, yarn: Yarn):
    """(low, high) frequency indices between which the ramp runs: floor /
    ceil of D ln(L0 / (2 pi beta)) / (2 ln theta) at beta_fast and
    beta_slow, clamped to [0, D - 1]."""
    def dim_of(rot):
        return (head_dim * math.log(yarn.original_max_pos
                                    / (rot * 2 * math.pi))
                / (2 * math.log(theta)))
    low = math.floor(dim_of(yarn.beta_fast))
    high = math.ceil(dim_of(yarn.beta_slow))
    return max(low, 0), min(high, head_dim - 1)


def yarn_freqs(head_dim: int, theta: float, yarn: Yarn):
    """(D/2,) float32 inverse frequencies: theta^(-2i/D) (extrapolated)
    below the correction range, those over ``factor`` (interpolated) above
    it, a linear ramp between."""
    extra = rope_freqs(head_dim, theta)
    inter = np.float32(1.0) / (np.float32(yarn.factor) * (
        theta ** (np.arange(0, head_dim, 2, dtype=np.float32) / head_dim)))
    low, high = yarn_correction_range(head_dim, theta, yarn)
    if low == high:
        high += 0.001
    ramp = np.clip((np.arange(head_dim // 2, dtype=np.float32) - low)
                   / np.float32(high - low), 0, 1).astype(np.float32)
    return (inter * ramp + extra * (np.float32(1) - ramp)).astype(np.float32)


def yarn_attention_scale(qk_head_dim: int, yarn: Optional[Yarn]) -> float:
    """The softmax scale: qk_head_dim^-0.5, times mscale(factor,
    mscale_all_dim)^2 under YaRN."""
    scale = 1.0 / math.sqrt(qk_head_dim)
    if yarn is not None and yarn.mscale_all_dim:
        scale *= yarn_mscale(yarn.factor, yarn.mscale_all_dim) ** 2
    return scale


@functools.lru_cache(maxsize=64)
def rope_inv_freq(head_dim: int, theta: float, yarn: Optional[Yarn],
                  device: torch.device) -> torch.Tensor:
    """The (D/2,) inverse frequencies on ``device``, uploaded once: a
    blocking host-to-device copy waits for the stream, so a copy per
    call would hold the card idle at every call. Read only."""
    freqs = rope_freqs(head_dim, theta) if yarn is None else \
        yarn_freqs(head_dim, theta, yarn)
    return torch.as_tensor(freqs, device=device)


def apply_rope(x, positions, theta: float = 1e4,
               mrope_sections: Sequence[int] = (),
               yarn: Optional[Yarn] = None):
    """Rotate-half rotary embedding. x: (B, S, H, D); positions: (B, S), or
    (3, B, S) under M-RoPE, where ``mrope_sections`` (summing to D/2) picks
    the position stream of each frequency index (Qwen2-VL §2). ``yarn``:
    YaRN's frequencies (``yarn_freqs``), cos and sin scaled by
    mscale(factor, mscale) / mscale(factor, mscale_all_dim). The
    frequencies come from ``rope_inv_freq``, uploaded once per device."""
    d = x.shape[-1]
    inv = rope_inv_freq(d, float(theta), yarn, x.device)          # (D/2,)
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
    if yarn is not None:
        m = yarn_mscale(yarn.factor, yarn.mscale) / \
            yarn_mscale(yarn.factor, yarn.mscale_all_dim)
        if m != 1.0:
            cos, sin = cos * m, sin * m
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
