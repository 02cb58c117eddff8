"""GQA attention and the contiguous KV cache.

Attention has no TPU kernel in the JAX package, so plain PyTorch matmuls
compute it here. Layouts follow the JAX package: q (B, S, Hkv, G, D),
k/v (B, S, Hkv, D), the KV cache {"k", "v"}: (B, cap, Hkv, D).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
from torch import nn

from . import layers

NEG_INF = -1e30


class Attention(nn.Module):
    """GQA projections: wq (d, Hkv, G, D), wk/wv (d, Hkv, D),
    wo (Hkv, G, D, d), optional q/k/v biases."""

    def __init__(self, cfg, *, device: torch.device,
                 generator: Optional[torch.Generator]):
        super().__init__()
        d, hd = cfg.d_model, cfg.resolved_head_dim
        hq, hkv = cfg.n_heads, cfg.n_kv_heads
        kw = dict(device=device, generator=generator)
        self.wq = layers.normal((d, hkv, hq // hkv, hd), **kw)
        self.wk = layers.normal((d, hkv, hd), **kw)
        self.wv = layers.normal((d, hkv, hd), **kw)
        self.wo = layers.normal((hkv, hq // hkv, hd, d), **kw)
        if cfg.qkv_bias:
            z = dict(dtype=torch.float32, device=device)
            self.bq = nn.Parameter(torch.zeros((hkv, hq // hkv, hd), **z),
                                   requires_grad=False)
            self.bk = nn.Parameter(torch.zeros((hkv, hd), **z),
                                   requires_grad=False)
            self.bv = nn.Parameter(torch.zeros((hkv, hd), **z),
                                   requires_grad=False)
        else:
            self.bq = self.bk = self.bv = None


def gqa_project_qkv(attn: Attention, x, positions, cfg):
    """x: (B,S,d) -> q (B,S,Hkv,G,D), k/v (B,S,Hkv,D), with RoPE applied."""
    if cfg.mrope_sections:
        raise NotImplementedError("M-RoPE is not ported yet")
    q = torch.einsum("bsd,dhgk->bshgk", x, attn.wq)
    k = torch.einsum("bsd,dhk->bshk", x, attn.wk)
    v = torch.einsum("bsd,dhk->bshk", x, attn.wv)
    if attn.bq is not None:
        q = q + attn.bq
        k = k + attn.bk
        v = v + attn.bv
    B, S, Hkv, G, D = q.shape
    q = layers.apply_rope(q.reshape(B, S, Hkv * G, D), positions,
                          cfg.rope_theta).reshape(B, S, Hkv, G, D)
    k = layers.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def plain_attention(q, k, v, *, causal=True, window=0, q_offset=0,
                    kv_valid_len=None):
    """O(S^2)-memory attention for short sequences."""
    Sq, Skv, D = q.shape[1], k.shape[1], q.shape[-1]
    s = torch.einsum("bqhgd,bkhd->bqhgk", q, k.to(q.dtype)) / np.sqrt(D)
    q_pos = q_offset + torch.arange(Sq, device=q.device)
    k_pos = torch.arange(Skv, device=q.device)
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= q_pos[:, None] >= k_pos[None, :]
    if window:
        mask &= (q_pos[:, None] - k_pos[None, :]) < window
    if kv_valid_len is not None:
        mask &= (k_pos < kv_valid_len)[None, :]
    s = torch.where(mask[None, :, None, None, :], s,
                    torch.tensor(NEG_INF, dtype=s.dtype, device=s.device))
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.einsum("bqhgk,bkhd->bqhgd", p, v)


def _check_plain_length(S: int):
    if S > 1024:
        raise NotImplementedError(
            f"sequence length {S} > 1024 needs blockwise attention, which "
            "is not ported yet")


def gqa_attention(attn: Attention, x, positions, cfg, *, causal=True,
                  window=0):
    q, k, v = gqa_project_qkv(attn, x, positions, cfg)
    _check_plain_length(x.shape[1])
    o = plain_attention(q, k, v, causal=causal, window=window)
    return torch.einsum("bshgk,hgkd->bsd", o, attn.wo)


def gqa_prefill_attention(attn: Attention, x, positions, cfg, *, window=0,
                          cap=None, cache_dtype=torch.bfloat16):
    """Full-sequence attention that also returns the populated KV cache."""
    q, k, v = gqa_project_qkv(attn, x, positions, cfg)
    S = x.shape[1]
    _check_plain_length(S)
    o = plain_attention(q, k, v, causal=True, window=window)
    out = torch.einsum("bshgk,hgkd->bsd", o, attn.wo)
    cache = ContiguousLayout(window).from_seq(k, v, cap if cap else S,
                                              cache_dtype)
    return out, cache


@dataclasses.dataclass(frozen=True)
class ContiguousLayout:
    """Per-slot contiguous KV rows {"k", "v"}: (B, cap, Hkv, D); a ring
    buffer when ``window`` > 0. Writes update the cache tensors in place
    (the JAX layout returns new arrays); nothing keeps the old ones."""
    window: int = 0

    def init(self, batch: int, length: int, n_kv: int, head_dim: int,
             dtype=torch.bfloat16, device="cpu"):
        shape = (batch, length, n_kv, head_dim)
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}

    def from_seq(self, k, v, cap: int, dtype=torch.bfloat16):
        """Full-sequence K/V (B,S,H,D) -> decode cache of capacity ``cap``."""
        B, S, H, D = k.shape
        kc = torch.zeros((B, cap, H, D), dtype=dtype, device=k.device)
        vc = torch.zeros((B, cap, H, D), dtype=dtype, device=k.device)
        if self.window > 0:
            w = min(cap, S)
            slots = (S - w + torch.arange(w, device=k.device)) % cap
            kc[:, slots] = k[:, S - w:].to(dtype)
            vc[:, slots] = v[:, S - w:].to(dtype)
        else:
            if cap < S:
                raise ValueError(f"cache capacity {cap} < prefill length {S}")
            kc[:, :S] = k.to(dtype)
            vc[:, :S] = v.to(dtype)
        return {"k": kc, "v": vc}

    def slot_index(self, pos: int, capacity: int) -> int:
        """Physical row of absolute position ``pos`` (ring when windowed)."""
        return pos % capacity if self.window > 0 else pos

    def append(self, cache, k_new, v_new, pos: int):
        """Insert one step (B,1,Hkv,D) at absolute position ``pos`` (a host
        int shared by the batch)."""
        cap = cache["k"].shape[1]
        idx = self.slot_index(pos, cap)
        if not 0 <= idx < cap:
            raise ValueError(f"decode position {pos} is past the cache "
                             f"capacity {cap}")
        cache["k"][:, idx] = k_new[:, 0].to(cache["k"].dtype)
        cache["v"][:, idx] = v_new[:, 0].to(cache["v"].dtype)
        return cache

    def validity(self, pos_after: int, capacity: int, device):
        """(capacity,) bool: the cache slots that hold a position before
        ``pos_after`` (and inside the window when windowed)."""
        slots = torch.arange(capacity, device=device)
        if self.window > 0:
            abs_pos = pos_after - 1 - ((pos_after - 1 - slots) % capacity)
            return (abs_pos >= 0) & (abs_pos > pos_after - 1 - self.window)
        return slots < pos_after


def _attend_cache(q, k_view, v_view, mask):
    """Softmax attention of q (B,Sq,Hkv,G,D) over cache views (B,T,Hkv,D)
    under ``mask`` broadcastable to the (B,Sq,Hkv,G,T) scores. Scores are
    float32; the softmax is cast to the cache dtype before ``p @ v``, as in
    the JAX package."""
    s = torch.einsum("bqhgd,bkhd->bqhgk", q, k_view.to(q.dtype)) \
        / np.sqrt(q.shape[-1])
    s = torch.where(mask, s, torch.tensor(NEG_INF, dtype=s.dtype,
                                          device=s.device))
    p = torch.softmax(s, dim=-1).to(v_view.dtype)
    return torch.einsum("bqhgk,bkhd->bqhgd", p, v_view)


def gqa_decode_attention(attn: Attention, x, cache, pos: int, cfg,
                         window: int = 0):
    """One-token decode: x (B,1,d) against the cache at absolute position
    ``pos``. Returns (out, cache) — the cache updated in place."""
    layout = ContiguousLayout(window)
    B = x.shape[0]
    posb = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q, k_new, v_new = gqa_project_qkv(attn, x, posb, cfg)
    cache = layout.append(cache, k_new, v_new, pos)
    valid = layout.validity(pos + 1, cache["k"].shape[1], x.device)
    o = _attend_cache(q, cache["k"], cache["v"],
                      valid.reshape(1, 1, 1, 1, -1))
    o = o.to(attn.wo.dtype)
    return torch.einsum("bshgk,hgkd->bsd", o, attn.wo), cache
