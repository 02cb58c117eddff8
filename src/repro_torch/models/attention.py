"""GQA and MLA attention and the KV cache layouts.

Attention has no TPU kernel in the JAX package, so plain PyTorch matmuls
compute it here: the O(S²) ``plain_attention`` up to 1024 tokens, and the
online-softmax ``blockwise_attention`` past that, as in the JAX package.
The paged MLA paths' latent attention is the one exception: on the card
it runs a hand-written kernel over the pool's pages in place
(``kernels.ops.mla_latent_attend``; its plain version on the CPU).
Layouts follow the JAX package: q (B, S, Hkv, G, D),
k/v (B, S, Hkv, D); the cache is per-slot contiguous rows
(``ContiguousLayout``, {"k", "v"}: (B, cap, Hkv, D)) or a shared page pool
behind a per-slot page table (``PagedLayout``). MLA (multi-head latent
attention, MiniCPM3 / DeepSeek-V2) caches the compressed latent
{"c": (B, cap, kv_lora_rank), "kr": (B, cap, qk_rope_head_dim)}, or in
pages {"c": (n_pages + 1, page, kv_lora_rank), "kr": (n_pages + 1, page,
qk_rope_head_dim)}, and decodes (and, paged, prefills a chunk) with the
up-projections absorbed: scores against the latent, the output taken in
latent space and then through ``wv_b``. Its parts run in the ``mla.latent``
(projections, kv_norm, RoPE / YaRN, cache write) and ``mla.attend`` (cache
read, scores, softmax, output, ``wv_b``, ``wo``) layer spans.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from ..kernels import ops as kops
from ..kernels import ref as kref
from ..obs.tracing import layer
from . import layers

NEG_INF = kref.NEG_INF


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
    """x: (B,S,d) -> q (B,S,Hkv,G,D), k/v (B,S,Hkv,D), with RoPE applied
    (M-RoPE over (3, B, S) positions when the config has sections)."""
    q = torch.einsum("bsd,dhgk->bshgk", x, attn.wq)
    k = torch.einsum("bsd,dhk->bshk", x, attn.wk)
    v = torch.einsum("bsd,dhk->bshk", x, attn.wv)
    if attn.bq is not None:
        q = q + attn.bq
        k = k + attn.bk
        v = v + attn.bv
    B, S, Hkv, G, D = q.shape
    sect = tuple(cfg.mrope_sections)
    q = layers.apply_rope(q.reshape(B, S, Hkv * G, D), positions,
                          cfg.rope_theta, sect).reshape(B, S, Hkv, G, D)
    k = layers.apply_rope(k, positions, cfg.rope_theta, sect)
    return q, k, v


def _mrope_positions(positions, cfg):
    """(B, S) positions -> the (3, B, S) text-style streams (t == h == w)
    under M-RoPE; unchanged otherwise."""
    if cfg.mrope_sections:
        return positions[None].expand((3,) + tuple(positions.shape))
    return positions


def blockwise_attention(q, k, v, *, causal: bool = True, window: int = 0,
                        q_offset=0, kv_valid_len=None, q_block: int = 512,
                        kv_block: int = 1024):
    """Online-softmax attention over KV blocks, the (S, S) scores never
    formed: q (B, Sq, Hkv, G, D), k/v (B, Skv, Hkv, D) -> (B, Sq, Hkv, G, D).

    Sq and Skv are padded to multiples of the blocks; all query blocks run
    together, and a loop over KV blocks carries the float32 running max
    ``m``, normaliser ``l`` and output ``o``. ``q_offset`` is the absolute
    position of q[0]; with ``window`` > 0 query i attends keys j with
    i - window < j <= i; keys at or past ``kv_valid_len`` are masked (the
    KV padding always is)."""
    B, Sq, H, G, D = q.shape
    Skv = k.shape[1]
    orig_sq = Sq
    qb, kb = min(q_block, Sq), min(kv_block, Skv)
    pq, pk = (-Sq) % qb, (-Skv) % kb
    if pq:
        q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, 0, 0, pq))
        Sq += pq
    if pk:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pk))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pk))
        if kv_valid_len is None:
            kv_valid_len = Skv
        Skv += pk
    nq, nk = Sq // qb, Skv // kb
    scale = float(1.0 / np.sqrt(D))
    dev = q.device
    q = q.reshape(B, nq, qb, H, G, D)
    q_pos = (q_offset + torch.arange(Sq, device=dev)).reshape(nq, qb)
    m = torch.full((B, nq, qb, H, G), NEG_INF, dtype=torch.float32,
                   device=dev)
    l = torch.zeros((B, nq, qb, H, G), dtype=torch.float32, device=dev)
    o = torch.zeros((B, nq, qb, H, G, D), dtype=torch.float32, device=dev)
    for j in range(nk):
        k_blk = k[:, j * kb:(j + 1) * kb]
        v_blk = v[:, j * kb:(j + 1) * kb]
        k_pos = torch.arange(j * kb, (j + 1) * kb, device=dev)
        s = torch.einsum("bnqhgd,bkhd->bnqhgk", q,
                         k_blk.to(q.dtype)).float() * scale
        mask = torch.ones((nq, qb, kb), dtype=torch.bool, device=dev)
        if causal:
            mask &= q_pos[:, :, None] >= k_pos
        if window:
            mask &= (q_pos[:, :, None] - k_pos) < window
        if kv_valid_len is not None:
            mask &= k_pos < kv_valid_len
        s = torch.where(mask[None, :, :, None, None, :], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        pv = torch.einsum("bnqhgk,bkhd->bnqhgd", p.to(v_blk.dtype),
                          v_blk).float()
        o = o * corr[..., None] + pv
        m = m_new
    out = o / torch.clamp(l[..., None], min=1e-30)
    return out.reshape(B, Sq, H, G, D)[:, :orig_sq].to(v.dtype)


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
    s = torch.where(mask[None, :, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.einsum("bqhgk,bkhd->bqhgd", p, v)


def context_q_block(dist, seq_len: int, q_block: int = 512) -> int:
    """The query block of blockwise attention under an EP context: the
    sequence split into one block per ``model`` rank when that divides it
    into blocks of at least 128 (the JAX package's ``make_shard_blocks``;
    there the blocks are also constrained to the model axis, here every
    rank computes them all)."""
    if dist is None:
        return q_block
    model_n = dist.size("model")
    if model_n > 1 and seq_len % model_n == 0 and seq_len // model_n >= 128:
        return seq_len // model_n
    return q_block


def _self_attention(q, k, v, *, causal=True, window=0, dist=None):
    """Full-sequence attention: blockwise past 1024 tokens, as the JAX
    package selects it."""
    S = q.shape[1]
    if S > 1024:
        return blockwise_attention(q, k, v, causal=causal, window=window,
                                   q_block=context_q_block(dist, S))
    return plain_attention(q, k, v, causal=causal, window=window)


def gqa_attention(attn: Attention, x, positions, cfg, *, causal=True,
                  window=0, dist=None):
    q, k, v = gqa_project_qkv(attn, x, positions, cfg)
    o = _self_attention(q, k, v, causal=causal, window=window, dist=dist)
    return torch.einsum("bshgk,hgkd->bsd", o, attn.wo)


def gqa_prefill_attention(attn: Attention, x, positions, cfg, *, window=0,
                          cap=None, cache_dtype=torch.bfloat16, dist=None):
    """Full-sequence attention that also returns the populated KV cache."""
    q, k, v = gqa_project_qkv(attn, x, positions, cfg)
    S = x.shape[1]
    o = _self_attention(q, k, v, causal=True, window=window, dist=dist)
    out = torch.einsum("bshgk,hgkd->bsd", o, attn.wo)
    cache = ContiguousLayout(window).from_seq(k, v, cap if cap else S,
                                              cache_dtype)
    return out, cache


@dataclasses.dataclass(frozen=True)
class ContiguousLayout:
    """Per-slot contiguous KV rows {"k", "v"}: (B, cap, Hkv, D); a ring
    buffer when ``window`` > 0. Writes update the cache tensors in place
    (the JAX layout returns new arrays); nothing keeps the old ones.

    ``pos`` is a host int (the whole batch at one position) or a (B,) int
    tensor of per-slot positions on the cache's device (continuous
    batching). A per-slot cache (``sink``) ends each slot's rows with one
    extra SINK row at index cap that reads never see: writes the JAX layout
    drops (past the capacity, masked off by ``write_mask``, chunk rows past
    ``valid_len``) land there, so nothing is range-checked on the host."""
    window: int = 0
    sink: bool = False

    def init(self, batch: int, length: int, n_kv: int, head_dim: int,
             dtype=torch.bfloat16, device="cuda"):
        shape = (batch, length + self.sink, n_kv, head_dim)
        dev = resolve_device(device)
        return {"k": torch.zeros(shape, dtype=dtype, device=dev),
                "v": torch.zeros(shape, dtype=dtype, device=dev)}

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

    def capacity(self, cache) -> int:
        """Rows per slot, the sink row not counted."""
        return cache["k"].shape[1] - self.sink

    def slot_index(self, pos, capacity: int):
        """Physical row of absolute position ``pos`` (ring when windowed)."""
        return pos % capacity if self.window > 0 else pos

    def read(self, cache, page_table=None, read_len=None):
        """(B, cap, Hkv, D) views, trimmed to ``read_len`` rows when given."""
        n = self.capacity(cache) if read_len is None else read_len
        if n == cache["k"].shape[1]:
            return cache["k"], cache["v"]
        return cache["k"][:, :n], cache["v"][:, :n]

    def read_slot(self, cache, slot: int, page_table=None, read_len=None):
        """One slot's (cap, Hkv, D) views (chunked prefill)."""
        n = self.capacity(cache) if read_len is None else read_len
        return cache["k"][slot, :n], cache["v"][slot, :n]

    def _check_sink(self):
        if not self.sink:
            raise ValueError("per-slot writes need a cache with a sink row "
                             "(ContiguousLayout(sink=True))")

    def append(self, cache, k_new, v_new, pos, page_table=None,
               write_mask=None):
        """Insert one step (B,1,Hkv,D) at absolute position ``pos``."""
        cap = self.capacity(cache)
        if not isinstance(pos, torch.Tensor):
            idx = self.slot_index(pos, cap)
            if not 0 <= idx < cap:
                raise ValueError(f"decode position {pos} is past the cache "
                                 f"capacity {cap}")
            cache["k"][:, idx] = k_new[:, 0].to(cache["k"].dtype)
            cache["v"][:, idx] = v_new[:, 0].to(cache["v"].dtype)
            return cache
        self._check_sink()
        idx = self.slot_index(pos.long(), cap)
        ok = idx < cap
        if write_mask is not None:
            ok = ok & write_mask
        rows = torch.where(ok, idx, torch.full_like(idx, cap))
        b = torch.arange(k_new.shape[0], device=idx.device)
        cache["k"][b, rows] = k_new[:, 0].to(cache["k"].dtype)
        cache["v"][b, rows] = v_new[:, 0].to(cache["v"].dtype)
        return cache

    def append_chunk(self, cache, k_chunk, v_chunk, slot: int, start: int,
                     valid_len: int, page_table=None):
        """Insert a (C,Hkv,D) prompt chunk of one slot at absolute positions
        ``start..start+C-1``; rows at or past ``valid_len`` (or the
        capacity) write to the sink row."""
        if self.window:
            raise ValueError("chunked prefill needs a non-ring layout")
        self._check_sink()
        cap = self.capacity(cache)
        i = torch.arange(k_chunk.shape[0], device=k_chunk.device)
        ok = (i < valid_len) & (start + i < cap)
        rows = torch.where(ok, start + i, torch.full_like(i, cap))
        cache["k"][slot, rows] = k_chunk.to(cache["k"].dtype)
        cache["v"][slot, rows] = v_chunk.to(cache["v"].dtype)
        return cache

    def validity(self, pos_after, capacity: int, device):
        """Bool mask of the cache rows that hold a position before
        ``pos_after`` (inside the window when windowed): (capacity,) for a
        host int, (B, capacity) for a (B,) tensor of per-slot positions."""
        slots = torch.arange(capacity, device=device)
        return _cache_validity(pos_after, slots, capacity, self.window)


@dataclasses.dataclass(frozen=True)
class PagedLayout:
    """Block-granular KV cache: a pool of ``page_size``-token pages shared
    by all slots, addressed through a per-slot page table (B, pages_per_slot)
    of physical page ids on the device.

    The pool {"k", "v"}: (n_pages + 1, page_size, Hkv, D) (an MLA model's:
    {"c", "kr"}, ``init_latent``) holds one extra
    SINK page at index ``n_pages`` that no page table maps: writes the JAX
    layout drops (slots past their table, ``write_mask``-ed slots, chunk
    rows past ``valid_len``) land there, so nothing is range-checked on the
    host. Page 0 is the engine's retired-slot page and is never handed out.
    Windowed (ring) caches are not supported — paging already bounds
    memory."""
    page_size: int

    def init(self, n_pages: int, n_kv: int, head_dim: int,
             dtype=torch.bfloat16, device="cuda"):
        shape = (n_pages + 1, self.page_size, n_kv, head_dim)
        dev = resolve_device(device)
        return {"k": torch.zeros(shape, dtype=dtype, device=dev),
                "v": torch.zeros(shape, dtype=dtype, device=dev)}

    def init_latent(self, n_pages: int, kv_lora_rank: int, rope_dim: int,
                    dtype=torch.bfloat16, device="cuda"):
        """An MLA pool: the latent {"c": (n_pages + 1, page, kv_lora)} and
        the shared rope key {"kr": (n_pages + 1, page, rope)}."""
        dev = resolve_device(device)
        return {key: torch.zeros((n_pages + 1, self.page_size, width),
                                 dtype=dtype, device=dev)
                for key, width in (("c", kv_lora_rank), ("kr", rope_dim))}

    def slot_index(self, pos):
        """(logical page, in-page offset) of absolute position ``pos``."""
        return pos // self.page_size, pos % self.page_size

    def read(self, cache, page_table=None, read_len=None):
        """(B, pages_per_slot * page_size, Hkv, D) gathered views, trimmed to
        ``read_len`` rows when given (so the softmax reduces over the same
        width as a contiguous cache of that capacity)."""
        return tuple(kref.gather_pages(cache[k], page_table, read_len)
                     for k in ("k", "v"))

    def read_slot(self, cache, slot: int, page_table=None, read_len=None):
        return self.read(cache, page_table[slot], read_len)

    def _sink(self, cache) -> int:
        return next(iter(cache.values())).shape[0] - 1

    def append(self, cache, k_new, v_new, pos, page_table=None,
               write_mask=None):
        """One decode step at per-slot positions ``pos`` (B,): the write
        lands at ``page_table[b, pos // ps]`` row ``pos % ps``; slots past
        their table or outside ``write_mask`` write to the sink page."""
        return self.append_rows(cache, {"k": k_new[:, 0], "v": v_new[:, 0]},
                                pos, page_table, write_mask)

    def append_rows(self, cache, rows, pos, page_table, write_mask=None):
        """``append`` of one (B, ...) row per pool in ``rows`` (key ->
        rows), e.g. MLA's {"c", "kr"}."""
        n_logical = page_table.shape[1]
        page, off = self.slot_index(pos.long())
        phys = torch.gather(page_table.long(), 1,
                            page.clamp(max=n_logical - 1)[:, None])[:, 0]
        ok = page < n_logical
        if write_mask is not None:
            ok = ok & write_mask
        phys = torch.where(ok, phys, torch.full_like(phys, self._sink(cache)))
        for key, new in rows.items():
            cache[key][phys, off] = new.to(cache[key].dtype)
        return cache

    def append_chunk(self, cache, k_chunk, v_chunk, slot: int, start: int,
                     valid_len: int, page_table=None):
        """A (C,Hkv,D) prompt chunk of one slot at positions
        ``start..start+C-1``; rows at or past ``valid_len`` (or past the
        slot's table) write to the sink page."""
        return self.append_chunk_rows(cache, {"k": k_chunk, "v": v_chunk},
                                      slot, start, valid_len, page_table)

    def append_chunk_rows(self, cache, rows, slot: int, start: int,
                          valid_len: int, page_table):
        """``append_chunk`` of a (C, ...) chunk per pool in ``rows``."""
        row = page_table[slot].long()
        n_logical = row.shape[0]
        n = next(iter(rows.values())).shape[0]
        i = torch.arange(n, device=row.device)
        page, off = self.slot_index(start + i)
        phys = row[page.clamp(max=n_logical - 1)]
        ok = (i < valid_len) & (page < n_logical)
        phys = torch.where(ok, phys, torch.full_like(phys, self._sink(cache)))
        for key, new in rows.items():
            cache[key][phys, off] = new.to(cache[key].dtype)
        return cache

    def validity(self, pos_after, capacity: int, device):
        slots = torch.arange(capacity, device=device)
        return _cache_validity(pos_after, slots, capacity, 0)


def _cache_validity(pos_after, slots, capacity: int, window: int):
    """Rows holding a position before ``pos_after`` (ring when windowed);
    a (B,) tensor of per-slot positions gives a (B, capacity) mask."""
    if isinstance(pos_after, torch.Tensor):
        pos_after = pos_after.long()[:, None]
    if window > 0:
        abs_pos = pos_after - 1 - ((pos_after - 1 - slots) % capacity)
        return (abs_pos >= 0) & (abs_pos > pos_after - 1 - window)
    return slots < pos_after


def _valid_mask(valid, rank: int):
    """(cap,) or (B,cap) validity -> a mask broadcastable against a score
    tensor of ``rank`` dims whose first axis is batch and last the cache."""
    lead = valid.shape[:1] if valid.ndim == 2 else (1,)
    return valid.reshape(lead + (1,) * (rank - 2) + valid.shape[-1:])


def _attend_cache(q, k_view, v_view, mask):
    """Softmax attention of q (B,Sq,Hkv,G,D) over cache views (B,T,Hkv,D)
    under ``mask`` broadcastable to the (B,Sq,Hkv,G,T) scores. Scores are
    float32; the softmax is cast to the cache dtype before ``p @ v``, as in
    the JAX package."""
    s = torch.einsum("bqhgd,bkhd->bqhgk", q, k_view.to(q.dtype)) \
        / np.sqrt(q.shape[-1])
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1).to(v_view.dtype)
    return torch.einsum("bqhgk,bkhd->bqhgd", p, v_view)


def gqa_decode_attention(attn: Attention, x, cache, pos, cfg,
                         window: int = 0, *, layout=None, page_table=None,
                         write_mask=None, read_len=None):
    """One-token decode: x (B,1,d) against the cache at absolute position
    ``pos`` — a host int, or a (B,) tensor of per-slot positions. Returns
    (out, cache) — the cache updated in place.

    ``layout`` selects the storage (default ``ContiguousLayout(window)``,
    with the sink row for per-slot positions);
    a ``PagedLayout`` needs ``page_table`` (B, pages_per_slot). ``write_mask``
    (B,) bool suppresses the KV write of inactive slots; ``read_len`` trims
    the attended width (see ``PagedLayout.read``)."""
    if layout is None:
        layout = ContiguousLayout(window, sink=isinstance(pos, torch.Tensor))
    B = x.shape[0]
    if isinstance(pos, torch.Tensor):
        posb = pos[:, None]
    else:
        posb = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q, k_new, v_new = gqa_project_qkv(attn, x, _mrope_positions(posb, cfg),
                                      cfg)
    cache = layout.append(cache, k_new, v_new, pos, page_table=page_table,
                          write_mask=write_mask)
    k_view, v_view = layout.read(cache, page_table=page_table,
                                 read_len=read_len)
    valid = layout.validity(pos + 1, k_view.shape[1], x.device)
    o = _attend_cache(q, k_view, v_view, _valid_mask(valid, 5))
    o = o.to(attn.wo.dtype)
    return torch.einsum("bshgk,hgkd->bsd", o, attn.wo), cache


def gqa_chunk_attention(attn: Attention, x, cache, slot: int, start: int,
                        valid_len: int, cfg, *, layout, page_table=None,
                        read_len=None):
    """Chunked-prefill attention for ONE slot: x (1,C,d) holds prompt tokens
    at absolute positions ``start..start+C-1`` (rows at or past
    ``valid_len`` are padding). Appends the chunk's K/V to the cache, then
    attends each chunk query over the slot's cache prefix (earlier chunks
    and this one, causally). Returns (out (1,C,d), cache)."""
    C = x.shape[1]
    positions = start + torch.arange(C, dtype=torch.int32,
                                     device=x.device)[None, :]
    q, k_new, v_new = gqa_project_qkv(attn, x,
                                      _mrope_positions(positions, cfg), cfg)
    cache = layout.append_chunk(cache, k_new[0], v_new[0], slot, start,
                                valid_len, page_table=page_table)
    k_slot, v_slot = layout.read_slot(cache, slot, page_table=page_table,
                                      read_len=read_len)
    # query i (position start+i) sees the rows at positions <= start+i;
    # rows of this chunk past valid_len were dropped, so the query's own
    # position bounds what it reads
    q_abs = positions[0].long()
    k_abs = torch.arange(k_slot.shape[0], device=x.device)
    mask = (k_abs[None, :] <= q_abs[:, None])[None, :, None, None, :]
    o = _attend_cache(q, k_slot[None], v_slot[None], mask)
    o = o.to(attn.wo.dtype)
    return torch.einsum("bshgk,hgkd->bsd", o, attn.wo), cache


# ---------------------------------------------------------------------------
# MLA (multi-head latent attention; MiniCPM3 / DeepSeek-V2 style)
# ---------------------------------------------------------------------------

class MLAttention(nn.Module):
    """MLA projections, in the JAX package's layouts: wq_a (d, q_lora),
    q_norm (q_lora,), wq_b (q_lora, H, nope + rope) — or, with no query
    LoRA (``q_lora_rank`` 0, DeepSeek-V2-Lite), wq (d, H, nope + rope) —
    wkv_a (d, kv_lora + rope), kv_norm (kv_lora,), wk_b (kv_lora, H,
    nope), wv_b (kv_lora, H, v_head), wo (H, v_head, d)."""

    def __init__(self, cfg, *, device: torch.device,
                 generator: Optional[torch.Generator]):
        super().__init__()
        d, H = cfg.d_model, cfg.n_heads
        rq, rkv = cfg.q_lora_rank, cfg.kv_lora_rank
        dn, dr = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
        dv = cfg.v_head_dim
        kw = dict(device=device, generator=generator)
        if rq:
            self.wq_a = layers.normal((d, rq), **kw)
            self.q_norm = layers.ones((rq,), device=device)
            self.wq_b = layers.normal((rq, H, dn + dr), **kw)
        else:
            self.wq = layers.normal((d, H, dn + dr), **kw)
        self.wkv_a = layers.normal((d, rkv + dr), **kw)
        self.kv_norm = layers.ones((rkv,), device=device)
        self.wk_b = layers.normal((rkv, H, dn), **kw)
        self.wv_b = layers.normal((rkv, H, dv), **kw)
        self.wo = layers.normal((H, dv, d), **kw)


def mla_project_latent(attn: MLAttention, x, cfg):
    """Compressed KV latent: (c_kv (B,S,kv_lora), k_rope (B,S,rope)),
    before RoPE."""
    rkv = cfg.kv_lora_rank
    kv_a = x @ attn.wkv_a
    c_kv = layers.rms_norm(kv_a[..., :rkv], attn.kv_norm, cfg.norm_eps)
    return c_kv, kv_a[..., rkv:]


def mla_queries(attn: MLAttention, x, positions, cfg):
    """(q_nope (B,S,H,nope), q_rope (B,S,H,rope)), RoPE applied (YaRN's
    where the config has it)."""
    dn = cfg.qk_nope_head_dim
    if cfg.q_lora_rank:
        q_lat = layers.rms_norm(x @ attn.wq_a, attn.q_norm, cfg.norm_eps)
        q = torch.einsum("bsr,rhk->bshk", q_lat, attn.wq_b)
    else:
        q = torch.einsum("bsd,dhk->bshk", x, attn.wq)
    return q[..., :dn], layers.apply_rope(q[..., dn:], positions,
                                          cfg.rope_theta,
                                          yarn=layers.yarn_of(cfg))


def _rope_latent(k_rope, positions, cfg):
    """RoPE on the one shared (B,S,rope) key head."""
    return layers.apply_rope(k_rope[..., None, :], positions,
                             cfg.rope_theta,
                             yarn=layers.yarn_of(cfg))[..., 0, :]


def mla_scale(cfg) -> float:
    """The softmax scale, (nope + rope)^-0.5 times YaRN's mscale^2."""
    return layers.yarn_attention_scale(
        cfg.qk_nope_head_dim + cfg.qk_rope_head_dim, layers.yarn_of(cfg))


def _yarn_query_scale(cfg) -> float:
    """The factor the shared attention functions' (nope + rope)^-0.5 scale
    misses under YaRN: mscale(factor, mscale_all_dim)^2 (1 without it)."""
    return mla_scale(cfg) * np.sqrt(cfg.qk_nope_head_dim
                                    + cfg.qk_rope_head_dim)


def mla_attention(attn: MLAttention, x, positions, cfg, *, causal=True,
                  window=0, dist=None):
    """Prefill path: per-head K/V decompressed from the latent, plain
    attention up to 1024 tokens and blockwise past that (V padded to the
    QK width for the shared attention functions, sliced after)."""
    B, S, _ = x.shape
    dn, dr = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    H = cfg.n_heads
    with layer("mla.latent"):
        q_nope, q_rope = mla_queries(attn, x, positions, cfg)
        c_kv, k_rope = mla_project_latent(attn, x, cfg)
        k_rope = _rope_latent(k_rope, positions, cfg)
    with layer("mla.attend"):
        k_nope = torch.einsum("bsr,rhk->bshk", c_kv, attn.wk_b)
        v = torch.einsum("bsr,rhk->bshk", c_kv, attn.wv_b)
        q = torch.cat([q_nope, q_rope], dim=-1)[:, :, :, None, :]
        if layers.yarn_of(cfg) is not None:
            q = q * _yarn_query_scale(cfg)
        k = torch.cat([k_nope, k_rope[:, :, None, :].expand(B, S, H, dr)],
                      dim=-1)
        dv = v.shape[-1]
        v_pad = F.pad(v, (0, dn + dr - dv))
        o = _self_attention(q, k, v_pad, causal=causal, window=window,
                            dist=dist)
        o = o[..., 0, :dv]
        return torch.einsum("bshk,hkd->bsd", o, attn.wo)


def init_mla_cache(batch: int, length: int, cfg, dtype=torch.bfloat16,
                   device="cuda", sink: bool = False):
    """An empty latent cache {"c", "kr"} of ``length`` rows per slot (plus
    the sink row of ``ContiguousLayout`` when ``sink``)."""
    dev = resolve_device(device)
    n = length + sink
    return {"c": torch.zeros((batch, n, cfg.kv_lora_rank), dtype=dtype,
                             device=dev),
            "kr": torch.zeros((batch, n, cfg.qk_rope_head_dim), dtype=dtype,
                              device=dev)}


def mla_prefill_attention(attn: MLAttention, x, positions, cfg, *, window=0,
                          cap=None, cache_dtype=torch.bfloat16, dist=None):
    """MLA prefill that also returns the populated latent cache."""
    out = mla_attention(attn, x, positions, cfg, window=window, dist=dist)
    with layer("mla.latent"):
        c_kv, k_rope = mla_project_latent(attn, x, cfg)
        k_rope = _rope_latent(k_rope, positions, cfg)
    B, S, _ = x.shape
    cap = cap if cap else S

    def ring(a):                                    # (B,S,F) -> (B,cap,F)
        buf = torch.zeros((B, cap, a.shape[-1]), dtype=cache_dtype,
                          device=a.device)
        if window > 0:
            w = min(cap, S)
            slots = (S - w + torch.arange(w, device=a.device)) % cap
            buf[:, slots] = a[:, S - w:].to(cache_dtype)
        else:
            buf[:, :S] = a.to(cache_dtype)
        return buf

    return out, {"c": ring(c_kv), "kr": ring(k_rope)}


def mla_decode_attention(attn: MLAttention, x, cache, pos, cfg,
                         window: int = 0):
    """Absorbed one-token decode against the latent cache: q_nope goes
    through wk_b into latent space, so scores are taken against c_kv
    directly. ``pos``: a host int, or a (B,) tensor of per-slot positions
    (the cache then has the sink row that takes the writes the JAX package
    drops). Returns (out, cache) — the cache updated in place."""
    B = x.shape[0]
    per_slot = isinstance(pos, torch.Tensor)
    posb = pos[:, None] if per_slot else \
        torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    layout = ContiguousLayout(window, sink=per_slot)
    cap = cache["c"].shape[1] - layout.sink
    with layer("mla.latent"):
        q_nope, q_rope = mla_queries(attn, x, posb, cfg)     # (B,1,H,.)
        c_new, kr_new = mla_project_latent(attn, x, cfg)     # (B,1,.)
        kr_new = _rope_latent(kr_new, posb, cfg)
        if per_slot:
            idx = layout.slot_index(pos.long(), cap)
            rows = torch.where(idx < cap, idx, torch.full_like(idx, cap))
            b = torch.arange(B, device=x.device)
            cache["c"][b, rows] = c_new[:, 0].to(cache["c"].dtype)
            cache["kr"][b, rows] = kr_new[:, 0].to(cache["kr"].dtype)
        else:
            idx = layout.slot_index(pos, cap)
            if not 0 <= idx < cap:
                raise ValueError(f"decode position {pos} is past the cache "
                                 f"capacity {cap}")
            cache["c"][:, idx] = c_new[:, 0].to(cache["c"].dtype)
            cache["kr"][:, idx] = kr_new[:, 0].to(cache["kr"].dtype)
    with layer("mla.attend"):
        valid = layout.validity(pos + 1, cap, x.device)
        return _attend_latent(attn, q_nope, q_rope, cache["c"][:, :cap],
                              cache["kr"][:, :cap], _valid_mask(valid, 4),
                              cfg, latent_out_in_cache_dtype=True), cache


def _absorbed_query(attn: MLAttention, q_nope):
    """q_nope (B,S,H,nope) through wk_b into latent space: (B*S,H,kv_lora),
    one product batched over the heads (a view of its (H, B*S, kv_lora)
    result: rows strided, each contiguous)."""
    B, S, H, dn = q_nope.shape
    return torch.bmm(q_nope.reshape(B * S, H, dn).transpose(0, 1),
                     attn.wk_b.permute(1, 2, 0)).transpose(0, 1)


def _latent_out(attn: MLAttention, o_lat, B: int):
    """The latent-space output (N,H,kv_lora) of B batch rows through wv_b
    (a product batched over the heads) and wo (one product over the heads
    and the value width): (B,N/B,d)."""
    N = o_lat.shape[0]
    o = torch.bmm(o_lat.transpose(0, 1), attn.wv_b.transpose(0, 1))
    out = torch.mm(o.transpose(0, 1).reshape(N, -1),
                   attn.wo.reshape(-1, attn.wo.shape[-1]))
    return out.view(B, N // B, -1)


def _attend_latent(attn: MLAttention, q_nope, q_rope, c, kr, mask, cfg, *,
                   latent_out_in_cache_dtype: bool = False):
    """Absorbed attention of queries (B,S,H,.) over latent rows c
    (B,T,kv_lora) and kr (B,T,rope) under ``mask`` (broadcastable to the
    (B,S,H,T) scores): q_nope through wk_b into latent space, float32
    scores at ``mla_scale``, the softmax rounded to the cache dtype (as
    the GQA paths round it before p @ V), the output taken in latent space
    in float32 — in the cache dtype with ``latent_out_in_cache_dtype``, as
    the JAX package's contiguous decode takes it — and then through wv_b
    and wo. Returns (B,S,d)."""
    B, S, H, _ = q_nope.shape
    o_lat = kref.attend_latent_rows(
        _absorbed_query(attn, q_nope).reshape(B, S, H, -1), q_rope, c, kr,
        mask, mla_scale(cfg),
        latent_out_in_cache_dtype=latent_out_in_cache_dtype)
    return _latent_out(attn, o_lat.to(attn.wv_b.dtype).reshape(B * S, H, -1),
                       B)


def mla_paged_decode_attention(attn: MLAttention, x, cache, pos, cfg, *,
                               layout: PagedLayout, page_table,
                               write_mask=None, read_len=None):
    """One-token absorbed decode of every slot against the paged latent
    pool at per-slot positions ``pos`` (B,): the new latent and rope key
    written through ``page_table`` (``write_mask``-ed slots to the sink),
    then each query over its slot's rows up to its position (``read_len``
    trims the read as in ``PagedLayout.read``), in place in the pool
    (``kernels.ops.mla_latent_attend``). Returns (out, cache)."""
    posb = pos[:, None]
    with layer("mla.latent"):
        q_nope, q_rope = mla_queries(attn, x, posb, cfg)     # (B,1,H,.)
        c_new, kr_new = mla_project_latent(attn, x, cfg)     # (B,1,.)
        kr_new = _rope_latent(kr_new, posb, cfg)
        cache = layout.append_rows(cache, {"c": c_new[:, 0],
                                           "kr": kr_new[:, 0]},
                                   pos, page_table, write_mask)
    with layer("mla.attend"):
        o_lat = kops.mla_latent_attend(
            _absorbed_query(attn, q_nope), q_rope[:, 0].float(), cache["c"],
            cache["kr"], page_table, pos, mla_scale(cfg), read_len)
        return _latent_out(attn, o_lat, x.shape[0]), cache


def mla_chunk_attention(attn: MLAttention, x, cache, slot: int, start: int,
                        valid_len: int, cfg, *, layout: PagedLayout,
                        page_table, read_len=None):
    """Chunked-prefill MLA for ONE slot of a paged latent pool: x (1,C,d)
    holds prompt tokens at positions ``start..start+C-1`` (rows at or past
    ``valid_len`` are padding, written to the sink). The chunk's latent
    rows are written to the slot's pages, then each query attends,
    absorbed, over the slot's rows at positions up to its own: the
    prefix (earlier chunks, or pages shared from the prefix cache) and
    the chunk, all as the cache holds them, read in place in the pool
    (``kernels.ops.mla_latent_attend``). Returns (out (1,C,d), cache)."""
    if not isinstance(layout, PagedLayout):
        raise NotImplementedError("chunked MLA prefill needs the paged "
                                  "latent cache")
    C = x.shape[1]
    positions = start + torch.arange(C, dtype=torch.int32,
                                     device=x.device)[None, :]
    with layer("mla.latent"):
        q_nope, q_rope = mla_queries(attn, x, positions, cfg)
        c_new, kr_new = mla_project_latent(attn, x, cfg)
        kr_new = _rope_latent(kr_new, positions, cfg)
        cache = layout.append_chunk_rows(cache, {"c": c_new[0],
                                                 "kr": kr_new[0]},
                                         slot, start, valid_len, page_table)
    with layer("mla.attend"):
        o_lat = kops.mla_latent_attend(
            _absorbed_query(attn, q_nope), q_rope[0].float(), cache["c"],
            cache["kr"], page_table[slot:slot + 1], positions[0],
            mla_scale(cfg), read_len)
        return _latent_out(attn, o_lat, 1), cache
