"""Decoder-only transformer for the ``moe`` and ``dense`` families.

Two entry modes, as in the JAX package: a full-sequence prefill that also
fills the decode cache, and a one-token decode step against that cache.
Layers run in a Python loop (the JAX package scans a layer-stacked tree).

The decode cache is a dict: ``"layers"`` (one {"k", "v"} (B, cap, Hkv, D)
dict per layer, updated in place by decode steps), ``"pos"`` (a host int:
the synchronized engine decodes the whole batch at one position) and
``"metrics"`` (an ``obs.MetricsState``) or, with metrics off, a
``"moe_overflow"`` running count.

MoE sparsity is configured by one ``core.policy.SparsityPolicy`` argument
(``None`` means ``NoDrop``); the JAX package carries it in a DistContext.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..core import drop as drop_mod
from ..core import gating
from ..core import moe as moe_mod
from ..obs import MetricsState
from . import attention as attn
from . import layers as L


class Block(nn.Module):
    """Pre-norm decoder block: attention + MoE (``moe``) or MLP (``dense``)."""

    def __init__(self, cfg, *, device: torch.device,
                 generator: Optional[torch.Generator]):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.ln1 = L.ones((cfg.d_model,), device=device)
        self.ln2 = L.ones((cfg.d_model,), device=device)
        self.attn = attn.Attention(cfg, **kw)
        if cfg.is_moe:
            self.moe = moe_mod.MoELayer(cfg, **kw)
            self.mlp = None
        else:
            self.moe = None
            self.mlp = L.MLP(cfg.d_model, cfg.d_ff, **kw)


class Transformer(nn.Module):
    """Embedding, the decoder blocks and the final norm."""

    def __init__(self, cfg, *, device: torch.device,
                 generator: Optional[torch.Generator]):
        super().__init__()
        if cfg.family not in ("moe", "dense") or cfg.attn_kind != "gqa" \
                or cfg.frontend or cfg.mrope_sections:
            raise NotImplementedError(
                f"{cfg.arch_id}: only gqa decoders of the moe/dense families "
                "are ported yet")
        kw = dict(device=device, generator=generator)
        self.cfg = cfg
        self.embed = L.Embed(cfg.vocab_size, cfg.d_model, cfg.tie_embeddings,
                             **kw)
        self.blocks = nn.ModuleList(Block(cfg, **kw)
                                    for _ in range(cfg.n_layers))
        self.final_norm = L.ones((cfg.d_model,), device=device)

    @property
    def device(self) -> torch.device:
        return self.final_norm.device


def _policy_of(policy):
    if policy is not None:
        return policy
    from ..core.policy import NoDrop
    return NoDrop()


def _moe_forward(moe: moe_mod.MoELayer, x, cfg, policy=None,
                 collect: bool = False):
    """MoE layer forward under ``policy`` (default ``NoDrop``).

    Returns ``(y, None, overflow)``; with ``collect`` the third value is the
    per-layer obs stats dict (kept-pair expert_load histogram over
    sub-expert ids plus kept_full/kept_major/dropped_pairs/overflow_pairs)
    — same routing, same ``y``."""
    B, S, d = x.shape
    params = moe.weights()
    xt = x.reshape(-1, d)
    # per-request (B,) threshold values -> per-token over the (B*S, d) block
    policy = _policy_of(policy).per_token(B, S)
    pairs = policy.route(params, xt, cfg)
    y, overflow = moe_mod.moe_forward_dispatch(
        params, xt, cfg, pairs=pairs, capacity_factor=policy.capacity_factor,
        capacity=policy.dispatch_capacity(xt.shape[0]),
        use_kernel=policy.use_kernel, return_overflow=True,
        mode_grouped=policy.kernel_mode_grouping,
        fused_pipeline=policy.fused_pipeline)
    if collect:
        n_sub = params["w1"].shape[0]
        p_factor = pairs.idx.shape[1] // pairs.modes.shape[1]
        kf, km, dr = drop_mod.sub_pair_outcome_counts(pairs.keep, p_factor)
        stats = {"expert_load": gating.expert_histogram(pairs.idx, n_sub,
                                                        keep=pairs.keep),
                 "kept_full": kf, "kept_major": km, "dropped_pairs": dr,
                 "overflow_pairs": overflow}
        return y.reshape(B, S, d), None, stats
    return y.reshape(B, S, d), None, overflow


def _no_overflow(x):
    return torch.zeros((), dtype=torch.int32, device=x.device)


def block_forward(bp: Block, x, positions, cfg, *, window: int = 0,
                  policy=None, capture_cap: int = 0,
                  cache_dtype=torch.bfloat16, collect_stats: bool = False):
    """Full-sequence block forward. With ``capture_cap`` returns
    ``(x, cache_layer, moe_overflow)`` for the prefill -> decode handoff
    (the obs stats dict in the third slot under ``collect_stats``)."""
    h = L.rms_norm(x, bp.ln1, cfg.norm_eps)
    cache_layer = None
    if capture_cap:
        y, cache_layer = attn.gqa_prefill_attention(
            bp.attn, h, positions, cfg, window=window, cap=capture_cap,
            cache_dtype=cache_dtype)
    else:
        y = attn.gqa_attention(bp.attn, h, positions, cfg, window=window)
    x = x + y
    h = L.rms_norm(x, bp.ln2, cfg.norm_eps)
    overflow = _no_overflow(x)
    if bp.moe is not None:
        y, _, overflow = _moe_forward(bp.moe, h, cfg, policy,
                                      collect=collect_stats)
        x = x + y
    else:
        x = x + L.apply_mlp(bp.mlp, h, cfg.mlp_kind)
    return (x, cache_layer, overflow) if capture_cap else x


def block_decode(bp: Block, x, cache_layer, pos: int, cfg, *,
                 window: int = 0, policy=None, collect_stats: bool = False):
    """One-token decode. Returns ``(x, cache_layer, moe_overflow)`` — the
    obs stats dict in the third slot under ``collect_stats``."""
    h = L.rms_norm(x, bp.ln1, cfg.norm_eps)
    y, cache_layer = attn.gqa_decode_attention(bp.attn, h, cache_layer, pos,
                                               cfg, window)
    x = x + y
    h = L.rms_norm(x, bp.ln2, cfg.norm_eps)
    overflow = _no_overflow(x)
    if bp.moe is not None:
        y, _, overflow = _moe_forward(bp.moe, h, cfg, policy,
                                      collect=collect_stats)
        x = x + y
    else:
        x = x + L.apply_mlp(bp.mlp, h, cfg.mlp_kind)
    return x, cache_layer, overflow


def stack_forward(model: Transformer, x, positions, cfg, *, window: int = 0,
                  policy=None, capture_cap: int = 0,
                  cache_dtype=torch.bfloat16, metrics: bool = True):
    """x: (B,S,d) -> (B,S,d) through all blocks. With ``capture_cap`` also
    returns the decode cache; ``metrics`` (MoE + capture only) puts a
    ``MetricsState`` in it in place of the ``moe_overflow`` scalar."""
    collect = bool(metrics and capture_cap and cfg.is_moe)
    layers, outs = [], []
    for bp in model.blocks:
        if capture_cap:
            x, cl, of = block_forward(bp, x, positions, cfg, window=window,
                                      policy=policy, capture_cap=capture_cap,
                                      cache_dtype=cache_dtype,
                                      collect_stats=collect)
            layers.append(cl)
            outs.append(of)
        else:
            x = block_forward(bp, x, positions, cfg, window=window,
                              policy=policy)
    if not capture_cap:
        return x
    cache = {"layers": layers}
    if collect:
        cache["metrics"] = MetricsState.from_stacked(outs)
    else:
        cache["moe_overflow"] = torch.stack(outs).sum(dtype=torch.int32)
    return x, cache


def stack_decode(model: Transformer, x, cache, pos: int, cfg, *,
                 window: int = 0, policy=None):
    """One-token decode through all blocks."""
    collect = "metrics" in cache
    new_layers, outs = [], []
    for bp, cl in zip(model.blocks, cache["layers"]):
        x, cl, of = block_decode(bp, x, cl, pos, cfg, window=window,
                                 policy=policy, collect_stats=collect)
        new_layers.append(cl)
        outs.append(of)
    new = {"layers": new_layers}
    if collect:                   # device-side accumulation, no host sync
        new["metrics"] = cache["metrics"].accumulate(outs)
    elif "moe_overflow" in cache:
        new["moe_overflow"] = cache["moe_overflow"] + \
            torch.stack(outs).sum(dtype=torch.int32)
    return x, new


def _positions_for(B: int, S: int, offset: int, device):
    pos = torch.arange(S, dtype=torch.int32, device=device)[None, :] + offset
    return pos.expand(B, S)


def embed_inputs(model: Transformer, batch, cfg, offset: int = 0):
    """Token embeddings and positions. Returns (x, positions)."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = L.embed(model.embed, tokens)
    positions = batch.get("positions")
    if positions is None:
        positions = _positions_for(B, S, offset, x.device)
    return x, positions


def prefill(model: Transformer, batch, cfg, *, cache_len: int = 0,
            window: int = 0, policy=None, cache_dtype=torch.bfloat16,
            metrics: bool = True):
    """Full forward AND the populated decode cache: returns
    ``(logits (B,S,vocab), cache)`` with ``cache["pos"]`` past the prompt."""
    x, positions = embed_inputs(model, batch, cfg)
    S_total = x.shape[1]
    cap = max(cache_len, S_total) if not window else \
        min(cache_len if cache_len else S_total, window)
    x, cache = stack_forward(model, x, positions, cfg, window=window,
                             policy=policy, capture_cap=cap,
                             cache_dtype=cache_dtype, metrics=metrics)
    x = L.rms_norm(x, model.final_norm, cfg.norm_eps)
    logits = L.unembed(model.embed, x)
    cache["pos"] = S_total
    return logits, cache


def decode_step(model: Transformer, token, cache, cfg, *, window: int = 0,
                policy=None):
    """token: (B,1) -> (logits (B,1,vocab), new cache)."""
    pos = cache["pos"]
    x = L.embed(model.embed, token)
    x, new_cache = stack_decode(model, x, cache, pos, cfg, window=window,
                                policy=policy)
    x = L.rms_norm(x, model.final_norm, cfg.norm_eps)
    logits = L.unembed(model.embed, x)
    new_cache["pos"] = pos + 1
    return logits, new_cache


def init_cache(cfg, batch: int, context_len: int, *, window: int = 0,
               dtype=torch.bfloat16, metrics_spec=None, device="cpu"):
    """Empty decode cache of KV capacity ``context_len`` (== window when
    windowed); ``metrics_spec`` = (n_layers, n_sub_experts) adds a zeroed
    ``MetricsState``."""
    cap = min(window, context_len) if window else context_len
    layout = attn.ContiguousLayout(window)
    cache = {"layers": [layout.init(batch, cap, cfg.n_kv_heads,
                                    cfg.resolved_head_dim, dtype, device)
                        for _ in range(cfg.n_layers)],
             "pos": 0}
    if metrics_spec is not None:
        cache["metrics"] = MetricsState.zeros(*metrics_spec, device=device)
    else:
        cache["moe_overflow"] = torch.zeros((), dtype=torch.int32,
                                            device=device)
    return cache
