"""Paged-KV serving engine: block-granular KV cache, chunked prefill and
prefix caching (paper §4).

The KV cache is ONE page pool per layer (``PagedLayout``); each decode slot
owns a row of a page table mapping logical page -> physical page. The table
lives on the device and is updated by row writes when a slot is admitted
or retired; a host copy serves the allocator's bookkeeping.

* **Chunked prefill** — a prompt advances ``chunk_size`` tokens per engine
  ``step()``, interleaved with decode for the active slots, so a long
  prompt does not stall token generation for everyone else. Chunk reads
  are trimmed to ``max_prompt_len`` rows and decode reads to the
  contiguous engine's ``context_len``, so every softmax reduces over the
  width the contiguous engine uses.
* **Prefix caching** — filled prompt pages are registered under a hash of
  (prompt prefix tokens, policy threshold values); a later request with
  the same prefix maps the cached pages into its page table (refcounted,
  zero-copy) and starts prefill after them. The last prompt token is
  always recomputed (hits are capped at ``h * page_size <= plen - 1``) so
  the first token has logits. Unreferenced cached pages park in an LRU
  and are evicted only when the free list runs dry.
* **Sinks** — page 0 is never allocated (retired slots' rows point at it);
  writes the layout drops (masked slots, chunk padding) go to the pool's
  extra sink page, and reads past a slot's position are masked, so stale
  data is never observed.
"""
from __future__ import annotations

import dataclasses
import hashlib
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..core.policy import SparsityPolicy
from ..kernels import ops as kops
from ..models import attention as attn
from ..models import model as M
from ..models import transformer
from ..obs import MetricsSnapshot
from .api import GenerationConfig
from .engine import SlotEngineBase, _host_view


class PageAllocator:
    """Refcounted physical-page allocator with a prefix-cache directory.

    Page 0 is reserved for retired slots and is never handed out. A page is
    in exactly one of three states: *free* (on the free stack), *held*
    (refcount > 0), or *parked* (refcount 0 but still registered in the
    prefix cache — reusable via ``acquire_cached`` and evictable in LRU
    order when the free stack empties)."""

    def __init__(self, n_pages: int):
        self.n_pages = n_pages
        self._free: List[int] = list(range(n_pages - 1, 0, -1))
        self._ref = np.zeros(n_pages, np.int32)
        self._cached: Dict[bytes, int] = {}    # prefix key -> physical page
        self._page_key: Dict[int, bytes] = {}  # reverse map
        self._lru: Dict[int, int] = {}         # parked page -> last-use tick
        self._tick = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.peak_in_use = 0          # most pages ever off the free stack

    def available(self) -> int:
        return len(self._free) + len(self._lru)

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_parked(self) -> int:
        return len(self._lru)

    @property
    def n_held(self) -> int:
        return self.n_pages - 1 - self.n_free - self.n_parked

    @property
    def n_in_use(self) -> int:
        """Pages held by slots or parked in the prefix cache."""
        return self.n_pages - 1 - self.n_free

    def alloc(self) -> int:
        """Take a fresh page (refcount 1), evicting the LRU-oldest parked
        cached page if the free stack is empty."""
        if self._free:
            page = self._free.pop()
            self.peak_in_use = max(self.peak_in_use, self.n_in_use)
        else:
            page = min(self._lru, key=self._lru.get)
            del self._lru[page]
            del self._cached[self._page_key.pop(page)]
            self.evictions += 1
        self._ref[page] = 1
        return page

    def lookup(self, key: bytes) -> Optional[int]:
        return self._cached.get(key)

    def acquire_cached(self, key: bytes) -> int:
        """Take a reference on the cached page for ``key`` (prefix hit)."""
        page = self._cached[key]
        self._ref[page] += 1
        self._lru.pop(page, None)
        self.hits += 1
        return page

    def register(self, key: bytes, page: int) -> None:
        """Publish a filled, held page under a prefix key. First writer
        wins: an existing registration (same content by construction) is
        kept; a page carries at most one key."""
        if key in self._cached or page in self._page_key:
            return
        self._cached[key] = page
        self._page_key[page] = key

    def release(self, page: int) -> None:
        """Drop one reference; at zero the page parks (if registered) or
        returns to the free stack."""
        if self._ref[page] <= 0:
            raise ValueError(f"page {page} released more often than held")
        self._ref[page] -= 1
        if self._ref[page] == 0:
            if page in self._page_key:
                self._tick += 1
                self._lru[page] = self._tick
            else:
                self._free.append(page)


@dataclasses.dataclass
class _SlotState:
    uid: int
    gen: GenerationConfig
    prompt: np.ndarray
    next_start: int = 0               # next prompt token to prefill
    prefilling: bool = True
    n_emitted: int = 0


class PagedEngine(SlotEngineBase):
    """Paged-KV continuous-batching engine with chunked prefill and prefix
    caching on ``device`` (default the card; the model must live there).
    Speaks the unified ``submit()``/``step()``/``drain()`` API. Decoder-only
    text models with GQA attention (a K/V pool) or MLA (a latent pool; off
    the CPU only at the widths and page sizes ``kernels.ops.
    mla_latent_attend`` takes, which a build elsewhere refuses).

    Given an EP context (``dist``), every rank builds the engine over its
    shard of the model and serves the same requests in SPMD: each MoE
    layer of a chunk step or a decode step runs S-ETP across the ranks,
    and every rank feeds the tokens of the ``model`` axis' first rank, as
    ``ContinuousBatchingEngine`` does."""

    def __init__(self, cfg: ModelConfig, model, *, n_slots: int = 8,
                 page_size: int = 16, chunk_size: int = 64,
                 max_prompt_len: int = 512, max_new_tokens: int = 128,
                 n_pages: Optional[int] = None, pad_token: int = 0,
                 policy: Optional[SparsityPolicy] = None,
                 exact_moe: bool = True, cache_dtype=torch.bfloat16,
                 prefix_cache: bool = True, metrics: bool = True,
                 device="cuda", dist=None):
        if (cfg.attn_kind not in ("gqa", "mla")
                or cfg.family in ("audio", "ssm", "hybrid") or cfg.frontend):
            raise NotImplementedError(
                "paged serving supports GQA or MLA attention decoder-only "
                "text models (chunked prefill has no recurrent-state or "
                "frontend-token analog yet)")
        if cfg.attn_kind == "mla":
            kops.check_mla_latent_attend_shape(
                cfg.kv_lora_rank, cfg.qk_rope_head_dim, page_size,
                "cuda" if device is None else device)
        super().__init__(cfg, model, n_slots=n_slots,
                         max_prompt_len=max_prompt_len,
                         max_new_tokens=max_new_tokens, pad_token=pad_token,
                         policy=policy, exact_moe=exact_moe, metrics=metrics,
                         device=device, dist=dist)
        self.page_size = page_size
        self.chunk_size = chunk_size
        self.prefix_cache = prefix_cache
        # one slot's logical pages cover prompt + decode budget; the decode
        # read is trimmed to exactly the contiguous engine's context_len
        self.context_len = max_prompt_len + max_new_tokens
        self.pages_per_slot = -(-self.context_len // page_size)
        if n_pages is None:
            n_pages = 1 + n_slots * self.pages_per_slot
        self.n_pages = n_pages
        self._alloc = PageAllocator(n_pages)
        self._layout = attn.PagedLayout(page_size)
        self._page_table = np.zeros((n_slots, self.pages_per_slot), np.int32)
        self._pt_dev = torch.zeros((n_slots, self.pages_per_slot),
                                   dtype=torch.int32, device=self.device)
        self._cache = M.init_paged_cache(
            cfg, n_pages, page_size, n_slots, dtype=cache_dtype,
            metrics_spec=self._metrics_spec, device=self.device)
        self.chunk_steps = 0              # chunk_step calls
        self.prefill_tokens = 0           # prompt tokens actually prefilled

    def _has_work(self) -> bool:
        return bool(self._queue) or any(s is not None for s in self._slots)

    # -- prefix-cache keys ----------------------------------------------

    def _prefix_key(self, prompt: np.ndarray, n_tokens: int,
                    gen: GenerationConfig) -> bytes:
        """Hash of the prompt's first ``n_tokens`` tokens and the request's
        threshold values: KV content depends on MoE routing (an earlier
        layer's MoE feeds a later layer's K/V), so the policy is part of
        the key."""
        h = hashlib.sha256()
        h.update(np.ascontiguousarray(prompt[:n_tokens]).tobytes())
        if self._slot_pol is not None:
            h.update(self._slot_pol.values(gen).tobytes())
        return h.digest()

    # -- admission / retirement ------------------------------------------

    def _set_page_row(self, slot: int, row: np.ndarray) -> None:
        self._page_table[slot] = row
        self._pt_dev[slot] = torch.from_numpy(row).to(self.device)

    def _admit(self) -> int:
        """FIFO admission with head-of-line blocking: a request enters a
        free slot only if the allocator can cover its FULL page demand
        (prompt + decode budget) after prefix-cache reuse. Hit pages map
        straight into the slot's page table; prefill starts after them."""
        admitted = 0
        ps = self.page_size
        for slot in range(self.n_slots):
            if not self._queue:
                break
            if self._slots[slot] is not None:
                continue
            uid, req = self._queue[0]
            plen = len(req.prompt)
            need_total = -(-(plen + req.gen.max_new_tokens) // ps)
            # longest run of cached full prompt pages, capped so the last
            # prompt token is recomputed (its logits give the first token)
            hit_keys: List[bytes] = []
            if self.prefix_cache:
                h = 1
                while h * ps <= plen - 1:
                    key = self._prefix_key(req.prompt, h * ps, req.gen)
                    if self._alloc.lookup(key) is None:
                        break
                    hit_keys.append(key)
                    h += 1
            if self._alloc.available() < need_total - len(hit_keys):
                break                      # head-of-line: keep FIFO order
            self._queue.popleft()
            pages = [self._alloc.acquire_cached(k) for k in hit_keys]
            # the hit rate is over lookup-eligible prompt pages
            self._alloc.misses += max(0, (plen - 1) // ps - len(hit_keys))
            pages += [self._alloc.alloc()
                      for _ in range(need_total - len(hit_keys))]
            row = np.zeros(self.pages_per_slot, np.int32)
            row[:len(pages)] = pages
            self._set_page_row(slot, row)
            if self._slot_pol is not None:
                self._slot_pol.assign(slot, req.gen)
            start = len(hit_keys) * ps
            self._slots[slot] = _SlotState(uid=uid, gen=req.gen,
                                           prompt=req.prompt,
                                           next_start=start)
            self._cache["pos"][slot] = start
            admitted += 1
            self.n_admitted += 1
        return admitted

    def _free_slot_hook(self, slot: int) -> None:
        for page in self._page_table[slot]:
            if page:
                self._alloc.release(int(page))
        self._set_page_row(slot, np.zeros(self.pages_per_slot, np.int32))

    # -- prefill / decode ------------------------------------------------

    def _chunk_insert(self, chunk: np.ndarray, slot: int, start: int,
                      gen: GenerationConfig):
        """One chunk of one slot's prompt (``chunk``: its tokens, padded
        here to ``chunk_size``); returns the greedy token after its last
        valid row (a device scalar)."""
        self._warm("chunk")
        valid = len(chunk)
        with self.tracer.layer("scheduler.inputs"):
            toks = np.full((1, self.chunk_size), self.pad_token, np.int32)
            toks[0, :valid] = chunk
            tokens = self._tokens(toks)
            policy = self._request_policy(gen)
        with torch.no_grad():
            logits, self._cache = transformer.chunk_step(
                self.model, tokens, slot, start, valid, self._cache,
                self.cfg, layout=self._layout, page_table=self._pt_dev,
                read_len=self.max_prompt_len, policy=policy, dist=self.dist)
        with self.tracer.layer("model.head"):
            return _host_view(
                self.dist, torch.argmax(logits[0, valid - 1]).reshape(1))[0]

    def _advance_prefill(self) -> bool:
        """Advance ONE prefilling slot by ONE chunk. On the final chunk the
        slot activates for decode, its first greedy token is emitted (the
        only read-back of prefill) and its full prompt pages are registered
        in the prefix cache."""
        slot = next((i for i, s in enumerate(self._slots)
                     if s is not None and s.prefilling), None)
        if slot is None:
            return False
        st = self._slots[slot]
        plen = len(st.prompt)
        start = st.next_start
        valid = min(self.chunk_size, plen - start)
        t0 = time.perf_counter()
        # positions: the chunk's rows run, padding included; device_s: the
        # stream's time over the chunk, read once its end has passed;
        # pages_peak: the most pool pages held so far (of pool_pages)
        with self.tracer.span("prefill_chunk", uid=st.uid, slot=slot,
                              start=start, n_tokens=valid,
                              positions=self.chunk_size,
                              pages_peak=self.pages_peak,
                              pool_pages=self.n_pages - 1,
                              device_clock=self.device):
            first = self._chunk_insert(st.prompt[start:start + valid], slot,
                                       start, st.gen)
        self.chunk_steps += 1
        self.prefill_tokens += valid
        st.next_start = start + valid
        if st.next_start < plen:
            self._results[st.uid].prefill_s += time.perf_counter() - t0
            return True
        with self.tracer.layer("scheduler.readback"):
            first = int(first)
        self._results[st.uid].prefill_s += time.perf_counter() - t0
        with self.tracer.layer("scheduler.emit"):
            if self.prefix_cache:
                ps = self.page_size
                for h in range(1, plen // ps + 1):
                    self._alloc.register(
                        self._prefix_key(st.prompt, h * ps, st.gen),
                        int(self._page_table[slot, h - 1]))
            st.prefilling = False
            self._active[slot] = True
            self._last[slot, 0] = first
            self._emit(slot, first)
            self.max_concurrency = max(self.max_concurrency,
                                       int(self._active.sum()))
        return True

    def _step(self) -> bool:
        """One scheduler iteration: admit queued requests into free slots,
        advance one prefilling slot by one chunk, then one batched decode
        step over all slots (writes masked to the active ones). Returns
        True while work may remain."""
        with self.tracer.layer("scheduler.admit"):
            self._admit()
        self._advance_prefill()
        if not self._active.any():
            return self._has_work()
        self._decode_active(
            [s for s, st in enumerate(self._slots)
             if st is not None and not st.prefilling],
            layout=self._layout, page_table=self._pt_dev, write_mask=True,
            read_len=self.context_len)
        return True

    # -- stats -----------------------------------------------------------

    @property
    def prefix_hits(self) -> int:
        return self._alloc.hits

    @property
    def prefix_misses(self) -> int:
        return self._alloc.misses

    @property
    def pages_peak(self) -> int:
        """The most pool pages ever held at once, by slots and the prefix
        cache together (page 0 and the sink not counted), since the
        engine was built."""
        return self._alloc.peak_in_use

    @property
    def prefix_hit_rate(self) -> float:
        tot = self._alloc.hits + self._alloc.misses
        return self._alloc.hits / tot if tot else 0.0

    def _metrics_hook(self, snap: MetricsSnapshot) -> None:
        snap.counter("repro_prefix_cache_total", float(self._alloc.hits),
                     event="hit")
        snap.counter("repro_prefix_cache_total", float(self._alloc.misses),
                     event="miss")
        snap.counter("repro_prefix_cache_total", float(self._alloc.evictions),
                     event="eviction")
        snap.gauge("repro_page_pool_pages", float(self._alloc.n_free),
                   state="free")
        snap.gauge("repro_page_pool_pages", float(self._alloc.n_held),
                   state="held")
        snap.gauge("repro_page_pool_pages", float(self._alloc.n_parked),
                   state="parked")
        snap.gauge("repro_page_pool_pages_peak", float(self.pages_peak))
        snap.gauge("repro_engine_slots", float(self.n_slots))
        snap.gauge("repro_engine_free_slots", float(self.free_slots))
        snap.counter("repro_engine_decode_steps_total",
                     float(self.decode_steps))
        snap.counter("repro_engine_chunk_steps_total",
                     float(self.chunk_steps))
        snap.counter("repro_requests_admitted_total", float(self.n_admitted))
        snap.counter("repro_requests_retired_total", float(self.n_retired))

    def reset_stats(self):
        """Zero scheduler statistics (allocator hit/miss counters are kept:
        the prefix cache's state survives across runs)."""
        super().reset_stats()
        self.chunk_steps = 0
        self.prefill_tokens = 0
