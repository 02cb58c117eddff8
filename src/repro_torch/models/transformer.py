"""Decoder-only stack for the ``moe``, ``dense``, ``vlm`` (Qwen2-VL: a
stub vision frontend whose patch embeddings, projected by
``frontend_proj``, are prepended to the tokens; M-RoPE), ``ssm`` (Mamba2)
and ``hybrid`` (Zamba2: Mamba2 blocks with one shared attention + MLP
block applied before every ``attn_every``-th of them) families.

Three entry modes, as in the JAX package: a full-sequence prefill that
also fills the decode cache, a one-token decode step against that cache,
and a fixed-size prompt chunk of one slot (chunked prefill, attention
families only). Layers run in a Python loop (the JAX package scans a
layer-stacked tree).

The decode cache is a dict: ``"layers"`` (one {"k", "v"} dict per layer in
the layout's storage, updated in place by decode and chunk steps; one
float32 {"conv", "ssm"} Mamba state per layer for ``ssm``; the hybrid
holds ``"mamba"``, one state per Mamba layer, and ``"attn"``, one
{"k", "v"} cache per shared-block occurrence),
``"pos"`` (a host int when the whole batch decodes at one position, or a
(B,) int32 tensor of per-slot positions on the device for continuous
batching) and ``"metrics"`` (an ``obs.MetricsState``) or, with metrics
off, a ``"moe_overflow"`` running count.

MoE sparsity is configured by one ``core.policy.SparsityPolicy`` argument
(``None`` means ``NoDrop``); the JAX package carries it in a DistContext.
An EP context (``dist``: a ``distributed.DistContext`` with ``moe_impl``
"setp") sends every MoE layer through ``core.setp.setp_moe_forward``, as
the JAX package's ``_moe_forward`` does: each rank holds its shard of the
experts and the rest of the model replicated, and runs the steps on the
same inputs (SPMD). The training forward takes it too (``kernels=False``:
the differentiable S-ETP route), and checkpoints every block when the
context asks for ``remat``.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..core import moe as moe_mod
from ..device import resolve_device
from ..obs import MetricsState
from ..obs.tracing import layer
from . import attention as attn
from . import layers as L
from . import mamba2 as mm


class Block(nn.Module):
    """Pre-norm decoder block: attention + MoE (``moe``) or MLP (``dense``,
    and a MoE model's leading ``dense`` layers: a SwiGLU of ``d_ff``)."""

    def __init__(self, cfg, *, device: torch.device,
                 generator: Optional[torch.Generator], dense: bool = False):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.ln1 = L.ones((cfg.d_model,), device=device)
        self.ln2 = L.ones((cfg.d_model,), device=device)
        self.attn = (attn.MLAttention(cfg, **kw) if cfg.attn_kind == "mla"
                     else attn.Attention(cfg, **kw))
        if cfg.is_moe and not dense:
            self.moe = moe_mod.MoELayer(cfg, **kw)
            self.mlp = None
        else:
            self.moe = None
            self.mlp = L.MLP(cfg.d_model, cfg.d_ff, kind=cfg.mlp_kind, **kw)


class MambaBlock(nn.Module):
    """Pre-norm Mamba2 block (``ssm`` layers, the hybrid's backbone)."""

    def __init__(self, cfg, *, device: torch.device,
                 generator: Optional[torch.Generator]):
        super().__init__()
        self.ln1 = L.ones((cfg.d_model,), device=device)
        self.mamba = mm.Mamba2(cfg, device=device, generator=generator)


def _has_moe(bp) -> bool:
    """Whether a block has a MoE layer (whose per-layer outputs fill the
    MoE-layer rows of the obs stats and overflow counts)."""
    return getattr(bp, "moe", None) is not None


def _ported(cfg) -> bool:
    if cfg.family == "ssm":
        return True
    if cfg.attn_kind == "mla":
        return cfg.family in ("moe", "dense") and not cfg.frontend
    return (cfg.family in ("moe", "dense", "vlm", "hybrid")
            and cfg.attn_kind == "gqa" and cfg.frontend in ("", "vision")
            and cfg.mlp_kind in ("swiglu", "gelu"))


def n_shared_occurrences(cfg) -> int:
    """How often the hybrid's shared block runs: before every
    ``attn_every``-th Mamba layer."""
    return -(-cfg.n_layers // cfg.attn_every)


class Transformer(nn.Module):
    """Embedding, the blocks and the final norm. ``blocks`` holds the
    decoder blocks (``Block``: the first ``cfg.leading_dense_layers`` of a
    MoE model dense; or ``MambaBlock`` for ``ssm``); the hybrid
    holds ``mamba_blocks`` and one ``shared_attn`` ``Block`` (attention +
    MLP), as the JAX tree does; a vision frontend adds ``frontend_proj``
    (d, d)."""

    def __init__(self, cfg, *, device: torch.device,
                 generator: Optional[torch.Generator]):
        super().__init__()
        if not _ported(cfg):
            raise NotImplementedError(
                f"{cfg.arch_id}: this stack builds the gqa decoders of the "
                "moe/dense/vlm/hybrid families, the mla decoders of the "
                "moe/dense families and the ssm family; the audio family "
                "(Whisper) is models.whisper.Whisper")
        kw = dict(device=device, generator=generator)
        self.cfg = cfg
        self.embed = L.Embed(cfg.vocab_size, cfg.d_model, cfg.tie_embeddings,
                             **kw)
        if cfg.family == "hybrid":
            self.mamba_blocks = nn.ModuleList(MambaBlock(cfg, **kw)
                                              for _ in range(cfg.n_layers))
            self.shared_attn = Block(cfg, **kw)
        elif cfg.family == "ssm":
            self.blocks = nn.ModuleList(MambaBlock(cfg, **kw)
                                        for _ in range(cfg.n_layers))
        else:
            self.blocks = nn.ModuleList(
                Block(cfg, dense=i < cfg.leading_dense_layers, **kw)
                for i in range(cfg.n_layers))
        self.final_norm = L.ones((cfg.d_model,), device=device)
        # the stub frontend provides embeddings directly; a linear projector
        # adapts them to d_model (the one real parameter of the stub)
        self.frontend_proj = (L.normal((cfg.d_model, cfg.d_model), **kw)
                              if cfg.frontend else None)

    @property
    def device(self) -> torch.device:
        return self.final_norm.device


def _policy_of(policy):
    if policy is not None:
        return policy
    from ..core.policy import NoDrop
    return NoDrop()


def _moe_forward(moe: moe_mod.MoELayer, x, cfg, policy=None,
                 collect: bool = False, dist=None, aux: bool = False,
                 kernels: bool = True):
    """MoE layer forward under ``policy`` (default ``NoDrop``): on the
    S-ETP path when ``dist`` is an EP context with ``moe_impl`` "setp",
    else ``core.moe.moe_layer_forward``, which picks the layer's path.

    Returns ``(y, aux_loss, overflow)``: aux_loss is None unless ``aux``
    (training); with ``collect`` the third value is the per-layer obs
    stats dict (``core.moe.layer_stats``) — same routing, same ``y``. On
    the S-ETP path overflow and stats are summed over the mesh.
    ``kernels=False`` takes the differentiable route the reference trains
    through: the einsum expert FFN, on the S-ETP path too (its local
    seating)."""
    params = moe.weights()
    aux_val = moe_mod.aux_loss_for(params, x.reshape(-1, x.shape[-1]),
                                   cfg) if aux else None
    policy = _policy_of(policy)
    if dist is not None and dist.moe_impl == "setp":
        from ..core import setp as setp_mod
        # the wire type is setp_moe_forward's default (bf16), as in JAX
        y, of = setp_mod.setp_moe_forward(
            params, x, cfg, dist, policy=policy, return_overflow=True,
            return_stats=collect, kernels=kernels)
        return y, aux_val, of
    y, out = moe_mod.moe_layer_forward(params, x, cfg, policy,
                                       collect=collect, kernels=kernels)
    return y, aux_val, out


def _no_overflow(x):
    return torch.zeros((), dtype=torch.int32, device=x.device)


def _attn_forward(bp: Block, h, positions, cfg, *, window: int, dist,
                  capture_cap: int = 0, cache_dtype=torch.bfloat16):
    """The block's attention (GQA or MLA); with ``capture_cap`` also the
    populated cache layer."""
    mla = cfg.attn_kind == "mla"
    if capture_cap:
        fn = attn.mla_prefill_attention if mla else \
            attn.gqa_prefill_attention
        return fn(bp.attn, h, positions, cfg, window=window, cap=capture_cap,
                  cache_dtype=cache_dtype, dist=dist)
    fn = attn.mla_attention if mla else attn.gqa_attention
    return fn(bp.attn, h, positions, cfg, window=window, dist=dist)


def block_forward(bp: Block, x, positions, cfg, *, window: int = 0,
                  policy=None, capture_cap: int = 0,
                  cache_dtype=torch.bfloat16, collect_stats: bool = False,
                  dist=None, with_aux: bool = False, kernels: bool = True):
    """Full-sequence block forward. With ``capture_cap`` returns
    ``(x, cache_layer, moe_overflow)`` for the prefill -> decode handoff
    (the obs stats dict in the third slot under ``collect_stats``; a Mamba
    block's cache layer is its {"conv", "ssm"} state); ``with_aux`` returns
    ``(x, load-balance aux loss)`` (0 without a MoE layer) for training.
    ``kernels=False`` takes the differentiable route (no kernel)."""
    if isinstance(bp, MambaBlock):
        h = L.rms_norm(x, bp.ln1, cfg.norm_eps)
        if capture_cap:
            y, st = mm.mamba2_forward(bp.mamba, h, cfg, return_state=True,
                                      kernel=kernels)
            return x + y, st, _no_overflow(x)
        x = x + mm.mamba2_forward(bp.mamba, h, cfg, kernel=kernels)
        return (x, _zero_aux(x)) if with_aux else x
    cache_layer = None
    with layer("model.attention"):
        h = L.rms_norm(x, bp.ln1, cfg.norm_eps)
        if capture_cap:
            y, cache_layer = _attn_forward(
                bp, h, positions, cfg, window=window, dist=dist,
                capture_cap=capture_cap, cache_dtype=cache_dtype)
        else:
            y = _attn_forward(bp, h, positions, cfg, window=window,
                              dist=dist)
    if with_aux:
        return _ffn(bp, x + y, cfg, policy, False, dist, kernels=kernels,
                    aux=True)
    x, overflow = _ffn(bp, x + y, cfg, policy, collect_stats, dist,
                       kernels=kernels)
    return (x, cache_layer, overflow) if capture_cap else x


def _zero_aux(x):
    return torch.zeros((), dtype=torch.float32, device=x.device)


def _ffn(bp: Block, x, cfg, policy, collect_stats: bool, dist=None,
         kernels: bool = True, aux: bool = False):
    """The block's second half: norm, then MoE or MLP, residual added.
    Returns ``(x, moe_overflow or obs stats dict)``, or with ``aux``
    ``(x, load-balance aux loss)`` (0 without a MoE layer)."""
    if bp.moe is None:
        # a MoE model's leading dense layer, or a dense model's MLP
        with layer("model.dense" if cfg.is_moe else "model.mlp"):
            h = L.rms_norm(x, bp.ln2, cfg.norm_eps)
            out = x + L.apply_mlp(bp.mlp, h, cfg.mlp_kind)
        return out, _zero_aux(x) if aux else _no_overflow(x)
    with layer("moe"):
        h = L.rms_norm(x, bp.ln2, cfg.norm_eps)
        y, aux_val, overflow = _moe_forward(bp.moe, h, cfg, policy,
                                            collect=collect_stats, dist=dist,
                                            aux=aux, kernels=kernels)
        out = x + y
    return out, aux_val if aux else overflow


def block_decode(bp: Block, x, cache_layer, pos, cfg, *, window: int = 0,
                 policy=None, layout=None, page_table=None, write_mask=None,
                 read_len=None, collect_stats: bool = False, dist=None):
    """One-token decode at ``pos`` (host int or (B,) tensor). Returns
    ``(x, cache_layer, moe_overflow)`` — the obs stats dict in the third
    slot under ``collect_stats``. ``layout``/``page_table``/``write_mask``/
    ``read_len`` select the KV storage (see ``gqa_decode_attention``)."""
    if isinstance(bp, MambaBlock):
        h = L.rms_norm(x, bp.ln1, cfg.norm_eps)
        state = mm.MambaState(cache_layer["conv"], cache_layer["ssm"])
        y, st = mm.mamba2_decode(bp.mamba, h, state, cfg)
        return x + y, st._asdict(), _no_overflow(x)
    with layer("model.attention"):
        h = L.rms_norm(x, bp.ln1, cfg.norm_eps)
        if cfg.attn_kind == "mla" and isinstance(layout, attn.PagedLayout):
            y, cache_layer = attn.mla_paged_decode_attention(
                bp.attn, h, cache_layer, pos, cfg, layout=layout,
                page_table=page_table, write_mask=write_mask,
                read_len=read_len)
        elif cfg.attn_kind == "mla":
            y, cache_layer = attn.mla_decode_attention(
                bp.attn, h, cache_layer, pos, cfg, window)
        else:
            y, cache_layer = attn.gqa_decode_attention(
                bp.attn, h, cache_layer, pos, cfg, window, layout=layout,
                page_table=page_table, write_mask=write_mask,
                read_len=read_len)
    x, overflow = _ffn(bp, x + y, cfg, policy, collect_stats, dist)
    return x, cache_layer, overflow


def stack_forward(model: Transformer, x, positions, cfg, *, window: int = 0,
                  policy=None, capture_cap: int = 0,
                  cache_dtype=torch.bfloat16, metrics: bool = True,
                  dist=None, with_aux: bool = False, kernels: bool = True):
    """x: (B,S,d) -> (B,S,d) through all blocks. With ``capture_cap`` also
    returns the decode cache; ``metrics`` (MoE + capture only) puts a
    ``MetricsState`` in it in place of the ``moe_overflow`` scalar;
    ``with_aux`` returns ``(x, summed MoE load-balance aux loss)``. Under
    an EP context with ``remat`` each block is checkpointed (never when
    capturing a cache), as the JAX package's ``jax.checkpoint`` of the
    scanned block."""
    if cfg.family == "hybrid":
        out = _hybrid_forward(model, x, positions, cfg, window=window,
                              capture_cap=capture_cap,
                              cache_dtype=cache_dtype, kernels=kernels,
                              dist=dist)
        return (out, _zero_aux(x)) if with_aux else out
    fwd = block_forward if capture_cap else L.remat(block_forward, dist)
    if with_aux:
        auxes = []
        for bp in model.blocks:
            x, aux = fwd(bp, x, positions, cfg, window=window,
                         policy=policy, dist=dist, with_aux=True,
                         kernels=kernels)
            auxes.append(aux)
        return x, torch.stack(auxes).sum()
    collect = bool(metrics and capture_cap and cfg.is_moe)
    layers, outs = [], []
    for bp in model.blocks:
        if capture_cap:
            x, cl, of = block_forward(bp, x, positions, cfg, window=window,
                                      policy=policy, capture_cap=capture_cap,
                                      cache_dtype=cache_dtype,
                                      collect_stats=collect, dist=dist)
            layers.append(cl)
            if _has_moe(bp):
                outs.append(of)
        else:
            x = fwd(bp, x, positions, cfg, window=window, policy=policy,
                    dist=dist, kernels=kernels)
    if not capture_cap:
        return x
    cache = {"layers": layers}
    with layer("model.stats"):
        if collect:
            cache["metrics"] = MetricsState.from_stacked(outs)
        else:
            cache["moe_overflow"] = _overflow_sum(outs, x)
    return x, cache


def _hybrid_forward(model: Transformer, x, positions, cfg, *, window: int = 0,
                    capture_cap: int = 0, cache_dtype=torch.bfloat16,
                    kernels: bool = True, dist=None):
    """Zamba2: the shared attention + MLP block before every
    ``attn_every``-th Mamba layer. With ``capture_cap`` also returns the
    decode cache ({"mamba", "attn", "moe_overflow"}, as the JAX one).
    Under ``dist.remat`` the Mamba blocks are checkpointed whole (the JAX
    package applies no ``remat_policy`` here), the shared block not."""
    every, shared = cfg.attn_every, model.shared_attn
    mamba_fwd = L.remat(block_forward, dist, policy="none")
    attn_caches, mamba_caches = [], []
    for occ in range(n_shared_occurrences(cfg)):
        h = L.rms_norm(x, shared.ln1, cfg.norm_eps)
        if capture_cap:
            y, ac = attn.gqa_prefill_attention(
                shared.attn, h, positions, cfg, window=window,
                cap=capture_cap, cache_dtype=cache_dtype)
            attn_caches.append(ac)
        else:
            y = attn.gqa_attention(shared.attn, h, positions, cfg,
                                   window=window)
        x, _ = _ffn(shared, x + y, cfg, None, False)
        for bp in model.mamba_blocks[occ * every:(occ + 1) * every]:
            if capture_cap:
                x, st, _ = block_forward(bp, x, positions, cfg,
                                         capture_cap=capture_cap)
                mamba_caches.append(st)
            else:
                x = mamba_fwd(bp, x, positions, cfg, kernels=kernels)
    if not capture_cap:
        return x
    return x, {"mamba": mamba_caches, "attn": attn_caches,
               "moe_overflow": _no_overflow(x)}


def _hybrid_decode(model: Transformer, x, cache, pos, cfg, *,
                   window: int = 0):
    """One-token decode of the hybrid: each shared-block occurrence
    attends over its own KV cache at the host position ``pos``."""
    every, shared = cfg.attn_every, model.shared_attn
    new_attn, new_mamba = [], []
    for occ in range(n_shared_occurrences(cfg)):
        h = L.rms_norm(x, shared.ln1, cfg.norm_eps)
        y, ac = attn.gqa_decode_attention(shared.attn, h, cache["attn"][occ],
                                          pos, cfg, window)
        new_attn.append(ac)
        x, _ = _ffn(shared, x + y, cfg, None, False)
        lo, hi = occ * every, (occ + 1) * every
        for bp, cl in zip(model.mamba_blocks[lo:hi], cache["mamba"][lo:hi]):
            x, cl, _ = block_decode(bp, x, cl, pos, cfg)
            new_mamba.append(cl)
    new = {"mamba": new_mamba, "attn": new_attn}
    if "moe_overflow" in cache:
        new["moe_overflow"] = cache["moe_overflow"]
    return x, new


def _with_step_stats(cache, new, outs):
    """Fold one step's per-MoE-layer outputs (obs stats dicts or overflow
    counts, in MoE-layer order: a leading dense layer has none) into the
    running total ``new`` carries on from ``cache`` — device-side adds, no
    host sync."""
    with layer("model.stats"):
        if "metrics" in cache:
            new["metrics"] = cache["metrics"].accumulate(outs)
        elif "moe_overflow" in cache:
            new["moe_overflow"] = cache["moe_overflow"] + \
                _overflow_sum(outs, cache["moe_overflow"])
    return new


def _overflow_sum(outs, like):
    """The summed overflow counts of a step's MoE layers (0 with none)."""
    if not outs:
        return torch.zeros((), dtype=torch.int32, device=like.device)
    return torch.stack(outs).sum(dtype=torch.int32)


def stack_decode(model: Transformer, x, cache, pos, cfg, *,
                 window: int = 0, policy=None, layout=None, page_table=None,
                 write_mask=None, read_len=None, dist=None):
    """One-token decode through all blocks."""
    if cfg.family == "hybrid":
        return _hybrid_decode(model, x, cache, pos, cfg, window=window)
    collect = "metrics" in cache
    new_layers, outs = [], []
    for bp, cl in zip(model.blocks, cache["layers"]):
        x, cl, of = block_decode(bp, x, cl, pos, cfg, window=window,
                                 policy=policy, layout=layout,
                                 page_table=page_table,
                                 write_mask=write_mask, read_len=read_len,
                                 collect_stats=collect, dist=dist)
        new_layers.append(cl)
        if _has_moe(bp):
            outs.append(of)
    return x, _with_step_stats(cache, {"layers": new_layers}, outs)


def _positions_for(cfg, B: int, S: int, offset: int, device):
    """(B, S) positions from ``offset``; under M-RoPE the text-style
    (3, B, S) streams (t == h == w), as the JAX stub does."""
    pos = torch.arange(S, dtype=torch.int32, device=device)[None, :] + offset
    pos = pos.expand(B, S)
    if cfg.mrope_sections:
        pos = pos[None].expand(3, B, S)
    return pos


def embed_inputs(model: Transformer, batch, cfg, offset: int = 0):
    """Token embeddings, with the vision stub's projected embeddings
    ``batch["frontend"]`` (B, n_frontend_tokens, d) prepended when the
    model has a vision frontend. Returns (x, positions, n_prefix)."""
    tokens = batch["tokens"]
    B = tokens.shape[0]
    x = L.embed(model.embed, tokens)
    n_prefix = 0
    if cfg.frontend == "vision" and "frontend" in batch:
        fe = batch["frontend"] @ model.frontend_proj
        x = torch.cat([fe.to(x.dtype), x], dim=1)
        n_prefix = fe.shape[1]
    positions = batch.get("positions")
    if positions is None:
        positions = _positions_for(cfg, B, x.shape[1], offset, x.device)
    return x, positions, n_prefix


def forward(model: Transformer, batch, cfg, *, window: int = 0, policy=None,
            with_aux: bool = False, kernels: bool = True, dist=None):
    """Full-sequence forward with no cache -> logits (B, S, vocab) over the
    token part; ``with_aux`` also returns the summed MoE load-balance aux
    loss. ``kernels=False`` is the differentiable route the reference's
    ``loss_fn`` trains through (the MoE buffer path's einsum, the plain
    chunked SSD), for a backward pass: the kernels have none. ``dist``: an
    EP context (S-ETP MoE layers, ``remat``)."""
    x, positions, n_prefix = embed_inputs(model, batch, cfg)
    aux = None
    if with_aux:
        x, aux = stack_forward(model, x, positions, cfg, window=window,
                               policy=policy, with_aux=True, kernels=kernels,
                               dist=dist)
    else:
        x = stack_forward(model, x, positions, cfg, window=window,
                          policy=policy, kernels=kernels, dist=dist)
    x = L.rms_norm(x, model.final_norm, cfg.norm_eps)
    if n_prefix:
        x = x[:, n_prefix:]
    logits = L.unembed(model.embed, x)
    return (logits, aux) if with_aux else logits


def prefill(model: Transformer, batch, cfg, *, cache_len: int = 0,
            window: int = 0, policy=None, cache_dtype=torch.bfloat16,
            metrics: bool = True, dist=None):
    """Full forward AND the populated decode cache: returns
    ``(logits (B,S,vocab), cache)`` — logits over the token part only —
    with ``cache["pos"]`` past the prompt, frontend prefix included."""
    with layer("model.embed"):
        x, positions, n_prefix = embed_inputs(model, batch, cfg)
    S_total = x.shape[1]
    cap = max(cache_len, S_total) if not window else \
        min(cache_len if cache_len else S_total, window)
    x, cache = stack_forward(model, x, positions, cfg, window=window,
                             policy=policy, capture_cap=cap,
                             cache_dtype=cache_dtype, metrics=metrics,
                             dist=dist)
    with layer("model.head"):
        x = L.rms_norm(x, model.final_norm, cfg.norm_eps)
        if n_prefix:
            x = x[:, n_prefix:]
        logits = L.unembed(model.embed, x)
    cache["pos"] = S_total
    return logits, cache


def decode_step(model: Transformer, token, cache, cfg, *, window: int = 0,
                policy=None, layout=None, page_table=None, write_mask=None,
                read_len=None, dist=None):
    """token: (B,1) -> (logits (B,1,vocab), new cache). ``cache["pos"]`` is
    a host int shared by the batch or a (B,) tensor of per-slot positions;
    ``layout``/``page_table`` select the KV storage and ``write_mask`` (B,)
    suppresses the KV writes of inactive slots (their ``pos`` still
    advances here: the engine owns per-slot positions)."""
    pos = cache["pos"]
    with layer("model.embed"):
        x = L.embed(model.embed, token)
    x, new_cache = stack_decode(model, x, cache, pos, cfg, window=window,
                                policy=policy, layout=layout,
                                page_table=page_table, write_mask=write_mask,
                                read_len=read_len, dist=dist)
    with layer("model.head"):
        x = L.rms_norm(x, model.final_norm, cfg.norm_eps)
        logits = L.unembed(model.embed, x)
        new_cache["pos"] = pos + 1
    return logits, new_cache


def chunk_block(bp: Block, x, cache_layer, slot: int, start: int,
                valid_len: int, cfg, *, layout, page_table=None,
                read_len=None, policy=None, collect_stats: bool = False,
                dist=None):
    """One block over a (1,C,d) prompt chunk of one slot, appending its K/V
    to the cache. Returns ``(x, cache_layer, moe_overflow)`` — the obs
    stats dict in the third slot under ``collect_stats``. Padding rows pass
    through the MoE layer as in the JAX package (they route and count).
    ``dist``: an EP context sends the MoE layer through S-ETP."""
    with layer("model.attention"):
        h = L.rms_norm(x, bp.ln1, cfg.norm_eps)
        fn = attn.mla_chunk_attention if cfg.attn_kind == "mla" else \
            attn.gqa_chunk_attention
        y, cache_layer = fn(bp.attn, h, cache_layer, slot, start, valid_len,
                            cfg, layout=layout, page_table=page_table,
                            read_len=read_len)
    x, overflow = _ffn(bp, x + y, cfg, policy, collect_stats, dist)
    return x, cache_layer, overflow


def chunk_step(model: Transformer, tokens, slot: int, start: int,
               valid_len: int, cache, cfg, *, layout, page_table=None,
               read_len=None, policy=None, dist=None):
    """Advance ONE slot's prompt by a fixed-size chunk.

    tokens: (1, C) prompt tokens at absolute positions ``start..start+C-1``
    (rows at or past ``valid_len`` are padding: their K/V writes are
    dropped, their logits are garbage the caller ignores). Returns
    ``(logits (1, C, vocab), cache)`` with ``cache["pos"][slot]`` set to
    ``start + valid_len`` (a device-side write). gqa attention, or mla
    over a paged latent cache.
    Under an EP context ``dist`` the chunk's batch of 1 is replicated over
    the (pod, data) axes and its sequence split over ``model`` where that
    divides it (``core.setp``'s token-block rule)."""
    if cfg.attn_kind not in ("gqa", "mla") or cfg.family in ("ssm",
                                                               "hybrid"):
        raise NotImplementedError("chunked prefill requires gqa or mla "
                                  "attention")
    collect = "metrics" in cache
    with layer("model.embed"):
        x = L.embed(model.embed, tokens)
    new_layers, outs = [], []
    for bp, cl in zip(model.blocks, cache["layers"]):
        x, cl, of = chunk_block(bp, x, cl, slot, start, valid_len, cfg,
                                layout=layout, page_table=page_table,
                                read_len=read_len, policy=policy,
                                collect_stats=collect, dist=dist)
        new_layers.append(cl)
        if _has_moe(bp):
            outs.append(of)
    with layer("model.head"):
        x = L.rms_norm(x, model.final_norm, cfg.norm_eps)
        logits = L.unembed(model.embed, x)
        cache["pos"][slot] = start + valid_len
    new = _with_step_stats(cache, {"layers": new_layers, "pos": cache["pos"]},
                           outs)
    return logits, new


def _obs_seam(cache, metrics_spec, device):
    """A zeroed ``MetricsState`` (``metrics_spec`` = (n_layers, n_sub)) or,
    without one, the ``moe_overflow`` running count."""
    if metrics_spec is not None:
        cache["metrics"] = MetricsState.zeros(*metrics_spec, device=device)
    else:
        cache["moe_overflow"] = torch.zeros((), dtype=torch.int32,
                                            device=device)
    return cache


def init_cache(cfg, batch: int, context_len: int, *, window: int = 0,
               dtype=torch.bfloat16, per_slot_pos: bool = False,
               metrics_spec=None, device="cuda"):
    """Empty decode cache of KV capacity ``context_len`` (== window when
    windowed) on ``device`` (default the card). ``per_slot_pos`` makes
    ``cache["pos"]`` a (batch,) int32 tensor so each slot decodes at its
    own position, and gives each slot the layout's sink row (see
    ``ContiguousLayout``); ``metrics_spec`` = (n_layers, n_sub_experts)
    adds a zeroed ``MetricsState``. Mamba states are float32 whatever
    ``dtype`` the KV cache has."""
    dev = resolve_device(device)
    cap = min(window, context_len) if window else context_len
    layout = attn.ContiguousLayout(window, sink=per_slot_pos)

    def attn_caches(n):
        if cfg.attn_kind == "mla":
            return [attn.init_mla_cache(batch, cap, cfg, dtype, dev,
                                        sink=layout.sink) for _ in range(n)]
        return [layout.init(batch, cap, cfg.n_kv_heads, cfg.resolved_head_dim,
                            dtype, dev) for _ in range(n)]

    def mamba_states():
        return [mm.init_mamba_state(batch, cfg, device=dev)._asdict()
                for _ in range(cfg.n_layers)]
    if cfg.family == "hybrid":
        cache = {"mamba": mamba_states(),
                 "attn": attn_caches(n_shared_occurrences(cfg))}
    elif cfg.family == "ssm":
        cache = {"layers": mamba_states()}
    else:
        cache = {"layers": attn_caches(cfg.n_layers)}
    cache["pos"] = (torch.zeros((batch,), dtype=torch.int32, device=dev)
                    if per_slot_pos else 0)
    return _obs_seam(cache, metrics_spec, dev)


def init_paged_cache(cfg, n_pages: int, page_size: int, n_slots: int, *,
                     dtype=torch.bfloat16, metrics_spec=None, device="cuda"):
    """Empty PAGED decode cache on ``device`` (default the card): one
    ``PagedLayout`` pool of ``n_pages`` pages (plus its sink page) per
    layer, shared by all slots through the engine's page table (one
    logical -> physical mapping for every layer). Page 0 is the
    retired-slot page, never handed out. ``cache["pos"]`` is per slot.
    An MLA model's pools hold the latent and the rope key
    (``PagedLayout.init_latent``)."""
    if cfg.attn_kind not in ("gqa", "mla") or cfg.family in ("ssm",
                                                               "hybrid"):
        raise NotImplementedError("paged KV requires gqa or mla attention")
    dev = resolve_device(device)
    layout = attn.PagedLayout(page_size)

    def pool():
        if cfg.attn_kind == "mla":
            return layout.init_latent(n_pages, cfg.kv_lora_rank,
                                      cfg.qk_rope_head_dim, dtype, dev)
        return layout.init(n_pages, cfg.n_kv_heads, cfg.resolved_head_dim,
                           dtype, dev)
    cache = {"layers": [pool() for _ in range(cfg.n_layers)],
             "pos": torch.zeros((n_slots,), dtype=torch.int32, device=dev)}
    return _obs_seam(cache, metrics_spec, dev)
