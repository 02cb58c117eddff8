"""Whisper-style encoder-decoder (``audio`` family); the audio frontend is a
STUB: the batch carries precomputed frame embeddings ``audio_embeds``
(B, n_frames, d_model) in place of the mel + conv frontend.

The encoder is a non-causal transformer over the frames (absolute
sinusoid positions; its RoPE runs at position 0, the identity), the
decoder a causal one that adds RoPE at its positions on top of the
sinusoid, with cross-attention (no RoPE) to the encoder output. Layers run
in a Python loop over ``encoder`` / ``decoder`` module lists (the JAX
package scans a layer-stacked tree of the same names).

The decode cache: ``"layers"`` (one contiguous {"k", "v"} dict per decoder
layer, updated in place), ``"cross_k"`` / ``"cross_v"`` (L, B, n_frames,
Hkv, D) in the cache dtype, and ``"pos"``, a host int shared by the batch.
It has no MoE metrics seam. Prefill and ``forward`` attend over float32
cross K/V; decode over the cache's (bf16 by default), so their logits
carry different rounding, as in the JAX package.

The entry points take the keywords ``models.model`` hands every family
(``policy``, ``metrics``, ``kernels``, ``metrics_spec``) and ignore them:
Whisper has no MoE layer, no kernel on its path and no metrics seam.

Under an EP context ``dist`` (as the JAX package's ``dist``) ``forward``
checkpoints each encoder and decoder block when ``dist.remat`` (the whole
block: the JAX package applies no ``remat_policy`` here), and the
decoder's self- and cross-attention take their blockwise query block
from ``attention.context_q_block``. Its other effect in the JAX package,
a sharding constraint on those query blocks, places data and does no
arithmetic: here every rank computes every block.
"""
from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
from torch import nn

from ..device import resolve_device
from . import attention as attn
from . import layers as L


class EncoderBlock(nn.Module):
    """Pre-norm encoder block: ``ln1``, ``attn``, ``ln2``, ``mlp``."""

    def __init__(self, cfg, *, device: torch.device,
                 generator: Optional[torch.Generator]):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.ln1 = L.ones((cfg.d_model,), device=device)
        self.attn = attn.Attention(cfg, **kw)
        self.ln2 = L.ones((cfg.d_model,), device=device)
        self.mlp = L.MLP(cfg.d_model, cfg.d_ff, kind=cfg.mlp_kind, **kw)


class DecoderBlock(nn.Module):
    """Pre-norm decoder block: ``ln1``, ``attn`` (causal self-attention),
    ``ln_x``, ``xattn`` (cross-attention), ``ln2``, ``mlp``."""

    def __init__(self, cfg, *, device: torch.device,
                 generator: Optional[torch.Generator]):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.ln1 = L.ones((cfg.d_model,), device=device)
        self.attn = attn.Attention(cfg, **kw)
        self.ln_x = L.ones((cfg.d_model,), device=device)
        self.xattn = attn.Attention(cfg, **kw)
        self.ln2 = L.ones((cfg.d_model,), device=device)
        self.mlp = L.MLP(cfg.d_model, cfg.d_ff, kind=cfg.mlp_kind, **kw)


class Whisper(nn.Module):
    """``embed``, ``frontend_proj`` (d, d), the ``encoder`` blocks and
    ``enc_norm``, the ``decoder`` blocks and ``final_norm``: the JAX tree's
    parts, in its order and by its names."""

    def __init__(self, cfg, *, device: torch.device,
                 generator: Optional[torch.Generator]):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.cfg = cfg
        self.embed = L.Embed(cfg.vocab_size, cfg.d_model, cfg.tie_embeddings,
                             **kw)
        self.frontend_proj = L.normal((cfg.d_model, cfg.d_model), **kw)
        self.encoder = nn.ModuleList(EncoderBlock(cfg, **kw)
                                     for _ in range(cfg.encoder_layers))
        self.enc_norm = L.ones((cfg.d_model,), device=device)
        self.decoder = nn.ModuleList(DecoderBlock(cfg, **kw)
                                     for _ in range(cfg.n_layers))
        self.final_norm = L.ones((cfg.d_model,), device=device)

    @property
    def device(self) -> torch.device:
        return self.final_norm.device


@functools.lru_cache(maxsize=8)
def _sinusoid(n: int, d: int, device) -> torch.Tensor:
    """(n, d) absolute positions ``[sin | cos]`` for prefill and training:
    computed in float64, then rounded to float32; built once per (n, d,
    device) and kept there."""
    pos = np.arange(n)[:, None]
    i = np.arange(d // 2)[None, :]
    ang = pos / (10000 ** (2 * i / d))
    table = np.concatenate([np.sin(ang), np.cos(ang)], -1).astype(np.float32)
    return torch.from_numpy(table).to(device)


@functools.lru_cache(maxsize=8)
def _step_denominators(d: int, device) -> torch.Tensor:
    """(d // 2,) float32 ``10000 ** (2 i / d)``, rounded from float64."""
    den = (10000 ** (2 * np.arange(d // 2) / d)).astype(np.float32)
    return torch.from_numpy(den).to(device)


def _step_sinusoid(pos: int, d: int, device) -> torch.Tensor:
    """(d,) ``[sin | cos]`` of one decode position, computed in float32
    from float32-rounded denominators: the JAX decode step's arithmetic,
    which embeds a position slightly differently from ``_sinusoid``."""
    den = _step_denominators(d, device)
    ang = torch.full_like(den, float(pos)) / den
    return torch.cat([torch.sin(ang), torch.cos(ang)])


def _full_attention(q, k, v, *, causal: bool, q_block: int = 512):
    """Blockwise past 1024 queries (``q_block`` / 1024 blocks), else
    plain."""
    if q.shape[1] > 1024:
        return attn.blockwise_attention(q, k, v, causal=causal,
                                        q_block=q_block)
    return attn.plain_attention(q, k, v, causal=causal)


def _out_proj(a: attn.Attention, o):
    return torch.einsum("bshgk,hgkd->bsd", o.to(a.wo.dtype), a.wo)


def _cross_attn(a: attn.Attention, x, k, v, dist=None):
    """x (B,S,d) queries over pre-projected encoder K/V (B,T,Hkv,D); no
    RoPE."""
    q = torch.einsum("bsd,dhgk->bshgk", x, a.wq)
    if a.bq is not None:
        q = q + a.bq
    return _out_proj(a, _full_attention(
        q, k, v, causal=False,
        q_block=attn.context_q_block(dist, x.shape[1])))


def _enc_block(bp: EncoderBlock, x, zero, cfg):
    a = L.rms_norm(x, bp.ln1, cfg.norm_eps)
    # non-causal over absolute-position embeddings; RoPE at position 0 is
    # the identity
    q, k, v = attn.gqa_project_qkv(bp.attn, a, zero, cfg)
    x = x + _out_proj(bp.attn, _full_attention(q, k, v, causal=False))
    a = L.rms_norm(x, bp.ln2, cfg.norm_eps)
    return x + L.apply_mlp(bp.mlp, a, cfg.mlp_kind)


def encode(model: Whisper, audio_embeds, cfg, dist=None):
    """audio_embeds (B, T, d), the stub frontend's output -> the encoder
    output (B, T, d); each block checkpointed under ``dist.remat``."""
    x = audio_embeds @ model.frontend_proj
    B, T = x.shape[:2]
    x = x + _sinusoid(T, cfg.d_model, x.device).to(x.dtype)
    zero = torch.zeros((B, T), dtype=torch.int32, device=x.device)
    block = L.remat(_enc_block, dist, policy="none")
    for bp in model.encoder:
        x = block(bp, x, zero, cfg)
    return L.rms_norm(x, model.enc_norm, cfg.norm_eps)


def _enc_kv_layer(bp: DecoderBlock, enc_out):
    """One decoder layer's cross K/V (B, T, Hkv, D) each, float32."""
    k = torch.einsum("btd,dhk->bthk", enc_out, bp.xattn.wk)
    v = torch.einsum("btd,dhk->bthk", enc_out, bp.xattn.wv)
    if bp.xattn.bk is not None:
        k = k + bp.xattn.bk
        v = v + bp.xattn.bv
    return k, v


def _enc_kv(model: Whisper, enc_out, cfg):
    """Cross K/V of every decoder layer: (L, B, T, Hkv, D) x 2."""
    kv = [_enc_kv_layer(bp, enc_out) for bp in model.decoder]
    return (torch.stack([k for k, _ in kv]), torch.stack([v for _, v in kv]))


def _embed_tokens(model: Whisper, tokens, cfg):
    x = L.embed(model.embed, tokens)
    B, S = tokens.shape
    x = x + _sinusoid(S, cfg.d_model, x.device).to(x.dtype)
    pos = torch.arange(S, dtype=torch.int32, device=x.device)[None]
    return x, pos.expand(B, S)


def _dec_block(bp: DecoderBlock, x, pos, k_l, v_l, cfg, dist):
    a = L.rms_norm(x, bp.ln1, cfg.norm_eps)
    x = x + attn.gqa_attention(bp.attn, a, pos, cfg, causal=True, dist=dist)
    a = L.rms_norm(x, bp.ln_x, cfg.norm_eps)
    x = x + _cross_attn(bp.xattn, a, k_l, v_l, dist)
    a = L.rms_norm(x, bp.ln2, cfg.norm_eps)
    return x + L.apply_mlp(bp.mlp, a, cfg.mlp_kind)


def forward(model: Whisper, batch, cfg, *, window: int = 0, policy=None,
            kernels: bool = False, dist=None):
    """Training / scoring: batch {"tokens" (B,S), "audio_embeds" (B,T,d)}
    -> logits (B, S, vocab). Differentiable (no kernel on this path).
    Under an EP context ``dist``: the blocks checkpointed under
    ``dist.remat``, the decoder's blockwise query block from
    ``attention.context_q_block`` (as the JAX package's ``dist``; each
    layer's cross K/V are projected outside its block, as JAX's
    ``_enc_kv`` does)."""
    enc_out = encode(model, batch["audio_embeds"], cfg, dist=dist)
    x, pos = _embed_tokens(model, batch["tokens"], cfg)
    block = L.remat(_dec_block, dist, policy="none")
    for bp in model.decoder:
        k_l, v_l = _enc_kv_layer(bp, enc_out)
        x = block(bp, x, pos, k_l, v_l, cfg, dist)
    x = L.rms_norm(x, model.final_norm, cfg.norm_eps)
    return L.unembed(model.embed, x)


def prefill(model: Whisper, batch, cfg, *, cache_len: int = 0,
            window: int = 0, policy=None, cache_dtype=torch.bfloat16,
            metrics: bool = True, dist=None):
    """Encoder pass + decoder pass over the prompt: ``(logits (B,S,vocab),
    cache)`` with the self-attention K/V and the cross K/V filled and
    ``cache["pos"]`` = S. ``dist`` sets the decoder's blockwise query
    block (``attention.context_q_block``)."""
    enc_out = encode(model, batch["audio_embeds"], cfg)
    tokens = batch["tokens"]
    B, S = tokens.shape
    cap = cache_len if cache_len else S
    if window:
        cap = min(cap, window)
    x, pos = _embed_tokens(model, tokens, cfg)
    n_l, T = len(model.decoder), enc_out.shape[1]
    hkv, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    cross_k = torch.empty((n_l, B, T, hkv, hd), dtype=cache_dtype,
                          device=x.device)
    cross_v = torch.empty_like(cross_k)
    layers = []
    for i, bp in enumerate(model.decoder):
        k_l, v_l = _enc_kv_layer(bp, enc_out)
        cross_k[i], cross_v[i] = k_l, v_l
        a = L.rms_norm(x, bp.ln1, cfg.norm_eps)
        y, cl = attn.gqa_prefill_attention(
            bp.attn, a, pos, cfg, window=window, cap=cap,
            cache_dtype=cache_dtype, dist=dist)
        layers.append(cl)
        x = x + y
        a = L.rms_norm(x, bp.ln_x, cfg.norm_eps)
        x = x + _cross_attn(bp.xattn, a, k_l, v_l, dist)
        a = L.rms_norm(x, bp.ln2, cfg.norm_eps)
        x = x + L.apply_mlp(bp.mlp, a, cfg.mlp_kind)
    x = L.rms_norm(x, model.final_norm, cfg.norm_eps)
    logits = L.unembed(model.embed, x)
    return logits, {"layers": layers, "cross_k": cross_k, "cross_v": cross_v,
                    "pos": S}


def init_cache(cfg, batch: int, context_len: int, *, window: int = 0,
               dtype=torch.bfloat16, per_slot_pos: bool = False,
               metrics_spec=None, device="cuda"):
    """Empty decode cache on ``device`` (default the card): self-attention
    K/V of capacity ``context_len`` (``window`` when windowed) per decoder
    layer and zero cross K/V for ``cfg.n_frontend_tokens`` frames. One
    position for the batch: ``per_slot_pos`` raises."""
    if per_slot_pos:
        raise NotImplementedError("a Whisper cache has one position for "
                                  "the batch")
    dev = resolve_device(device)
    cap = min(window, context_len) if window else context_len
    hkv, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    layout = attn.ContiguousLayout(window)
    cross = (cfg.n_layers, batch, cfg.n_frontend_tokens, hkv, hd)
    return {"layers": [layout.init(batch, cap, hkv, hd, dtype, dev)
                       for _ in range(cfg.n_layers)],
            "cross_k": torch.zeros(cross, dtype=dtype, device=dev),
            "cross_v": torch.zeros(cross, dtype=dtype, device=dev),
            "pos": 0}


def prefill_cache(model: Whisper, batch, cfg, cache):
    """The cache with its cross K/V filled from the encoder (decode then
    starts from ``cache["pos"]``, 0 for a fresh cache)."""
    enc_out = encode(model, batch["audio_embeds"], cfg)
    ck, cv = _enc_kv(model, enc_out, cfg)
    cache = dict(cache)
    cache["cross_k"] = ck.to(cache["cross_k"].dtype)
    cache["cross_v"] = cv.to(cache["cross_v"].dtype)
    return cache


def decode_step(model: Whisper, token, cache, cfg, *, window: int = 0,
                policy=None, dist=None):
    """token (B,1) -> (logits (B,1,vocab), cache): one decoder step at the
    host position ``cache["pos"]``, self-attention K/V appended in
    place, cross-attention over the cached cross K/V. ``dist`` changes
    nothing here: one query per request takes no blockwise attention."""
    pos = int(cache["pos"])
    x = L.embed(model.embed, token)
    x = x + _step_sinusoid(pos, cfg.d_model, x.device)[None, None].to(x.dtype)
    layers = []
    for i, bp in enumerate(model.decoder):
        a = L.rms_norm(x, bp.ln1, cfg.norm_eps)
        y, cl = attn.gqa_decode_attention(bp.attn, a, cache["layers"][i],
                                          pos, cfg, window)
        layers.append(cl)
        x = x + y
        a = L.rms_norm(x, bp.ln_x, cfg.norm_eps)
        x = x + _cross_attn(bp.xattn, a, cache["cross_k"][i],
                            cache["cross_v"][i])
        a = L.rms_norm(x, bp.ln2, cfg.norm_eps)
        x = x + L.apply_mlp(bp.mlp, a, cfg.mlp_kind)
    x = L.rms_norm(x, model.final_norm, cfg.norm_eps)
    logits = L.unembed(model.embed, x)
    return logits, {"layers": layers, "cross_k": cache["cross_k"],
                    "cross_v": cache["cross_v"], "pos": pos + 1}
