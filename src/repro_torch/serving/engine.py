"""Serving engines for the DualSparse-MoE inference system (paper §4).

``ServingEngine`` — the synchronized-batch baseline: requests are grouped
to a common (left-padded) prompt length, prefilled in one call, then
decoded together at ONE shared absolute position. One ``step()`` serves
one convoy batch to completion — the setting of the paper's efficiency
evaluation.

``ContinuousBatchingEngine`` — slot-based continuous batching: a fixed
number of decode slots (the batch dimension of one decode step), an
admission queue, per-slot positions (``cache["pos"]`` is an (n_slots,)
tensor on the device), a prefill-insert that writes a new request's KV
into a free slot, and per-request EOS/budget retirement that frees slots
mid-decode for waiting requests. One ``step()`` is one admit + decode
iteration. (``serving.paged.PagedEngine`` adds a paged KV cache, chunked
prefill and prefix caching.)

MoE sparsity is configured by one ``SparsityPolicy`` (``core.policy``:
none/1t/2t/load_aware/per_layer); requests may override threshold values
per request via
``GenerationConfig.policy`` (same policy family). The slot engines stack
each slot's threshold values into (n_slots,) tensors, so mixed-threshold
traffic decodes in one step. With ``exact_moe`` (the slot engines'
default) the MoE dispatch capacity is the token count, so no token-expert
pair is ever dropped by overflow and each request's tokens are independent
of what it is batched with; overflow drops that do occur are counted and
surfaced via ``engine.overflow_pairs``.

PyTorch runs eagerly, so there are no traces to count: the first call of
each step kind (warm-up: kernel build and load, allocator growth) makes
``timing`` report its step as warm-up (``compile_s``), the rest as steady
state. Decode steps read back only the greedy tokens; positions, page
tables and metrics stay on the device.

Expert parallelism: ``ServingEngine``, ``ContinuousBatchingEngine`` and
``serving.paged.PagedEngine`` take an EP context (``dist``, a
``distributed.DistContext``); every rank builds
the engine over its shard of the model and serves the same requests in
SPMD while each MoE layer runs S-ETP across the ranks (``core.setp``).
Every rank takes its next tokens from the ``model`` axis' first rank
(``DistContext.host_view``), as the JAX package's host reads a replicated
array, so the ranks stay in step even where capacity overflow made their
outputs differ.
"""
from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..core.policy import NoDrop, SparsityPolicy, merge_policy_override
from ..device import resolve_device
from ..models import model as M
from ..models import transformer
from ..obs import MetricsSnapshot, metrics_spec
from .api import EngineBase, GenerationConfig, Request, Result  # noqa: F401

__all__ = ["ServingEngine", "ContinuousBatchingEngine", "exact_moe_policy",
           "merge_policy_override", "SlotPolicies", "sample_token"]


def exact_moe_policy(policy: Optional[SparsityPolicy]) -> SparsityPolicy:
    """``policy`` (``NoDrop`` when None) with its ``exact_capacity`` hint
    set: the dispatch capacity is the token count, so no token-expert pair
    is dropped by overflow and outputs are batch-composition-invariant."""
    return dataclasses.replace(policy if policy is not None else NoDrop(),
                               exact_capacity=True)


def _host_view(dist, tokens):
    """The tokens every rank feeds its next step: under an EP context the
    copy of the ``model`` axis' first rank (``DistContext.host_view``),
    else ``tokens`` as they are."""
    return tokens if dist is None else dist.host_view(tokens)


def sample_token(logits_row, gen: GenerationConfig, uid: int, n: int) -> int:
    """A token sampled at ``gen.temperature`` from one row of logits, with a
    generator seeded by (seed, uid, n): the same request samples the same
    tokens in every run (the JAX package's draws differ)."""
    g = torch.Generator(device=logits_row.device)
    g.manual_seed(hash((gen.seed, uid, n)) & (2 ** 63 - 1))
    probs = torch.softmax(logits_row.float() / gen.temperature, dim=-1)
    return int(torch.multinomial(probs, 1, generator=g)[0])


class SlotPolicies:
    """Per-slot threshold values of an engine's base policy: an
    (n_thresholds, n_slots) float32 table on the host, uploaded to the
    device only after a slot's values change (``load_aware``: t_max and
    t_gap per slot; ``per_layer`` holds none, its thresholds live in each
    MoE layer's params). Requests may override the values (same policy
    family), never the base policy's hints."""

    def __init__(self, base: SparsityPolicy, n_slots: int,
                 device: torch.device):
        self.base = base
        self.device = device
        self._base_vals = self._values(base)
        self._vals = np.tile(self._base_vals[:, None], (1, n_slots))
        self._dev = None

    @staticmethod
    def _values(policy: SparsityPolicy) -> np.ndarray:
        return np.asarray([float(v) for v in policy.thresholds()],
                          np.float32)

    def validate(self, gen: GenerationConfig) -> None:
        if gen.policy is not None:
            merge_policy_override(self.base, gen.policy)   # same family

    def values(self, gen: GenerationConfig) -> np.ndarray:
        """A request's threshold values (the base values without an
        override)."""
        if gen.policy is None:
            return self._base_vals
        return self._values(gen.policy)

    def _with(self, leaves) -> SparsityPolicy:
        return dataclasses.replace(self.base, **dict(zip(
            self.base._dynamic, leaves)))

    def request_policy(self, gen: GenerationConfig) -> SparsityPolicy:
        """The base policy with the request's values as 0-d device tensors
        (prefill of one request)."""
        vals = torch.from_numpy(self.values(gen)).to(self.device)
        return self._with(list(vals))

    def assign(self, slot: int, gen: Optional[GenerationConfig]) -> None:
        """Set a slot's values to a request's (the base values for None)."""
        self._vals[:, slot] = (self._base_vals if gen is None
                               else self.values(gen))
        self._dev = None

    def stacked(self) -> SparsityPolicy:
        """The base policy with (n_slots,) threshold tensors (decode)."""
        if self._dev is None:
            self._dev = torch.from_numpy(self._vals.copy()).to(self.device)
        return self._with(list(self._dev))


class ServingEngine(EngineBase):
    """Synchronized-batch engine around the prefill/serve steps, on
    ``device`` (default the card; the model must live there)."""

    def __init__(self, cfg: ModelConfig, model, *, batch_size: int = 8,
                 max_prompt_len: int = 512, max_new_tokens: int = 128,
                 window: int = 0, pad_token: int = 0,
                 policy: Optional[SparsityPolicy] = None,
                 exact_moe: bool = False, cache_dtype=torch.bfloat16,
                 metrics: bool = True, device="cuda", dist=None):
        super().__init__(metrics=metrics)
        self.device = resolve_device(device)
        _check_model_device(model, self.device)
        self.cfg = cfg
        self.model = model
        self.dist = dist
        self.batch_size = batch_size
        self.window = window
        self.pad_token = pad_token
        if exact_moe and cfg.is_moe:
            policy = exact_moe_policy(policy)
        self.policy = policy
        self.cache_dtype = cache_dtype
        # device-resident MetricsState summed over served batches (one add
        # per batch, read only by engine.metrics()); None until the first
        # metrics-enabled batch finishes
        self._dev_metrics = None
        self.context_len = M.context_len_for(cfg, max_prompt_len,
                                             max_new_tokens)

    def _prefill(self, batch, policy):
        self._warm("prefill")
        return M.make_prefill_step(
            self.cfg, cache_len=self.context_len, window=self.window,
            policy=policy, cache_dtype=self.cache_dtype,
            metrics=self.metrics_enabled, dist=self.dist)(self.model, batch)

    def _serve(self, token, cache, policy):
        self._warm("decode")
        return M.make_serve_step(self.cfg, window=self.window, policy=policy,
                                 dist=self.dist)(self.model, token, cache)

    def _policy_for(self, gen: GenerationConfig) -> Optional[SparsityPolicy]:
        if gen.policy is None:
            return self.policy
        # keep the engine's execution hints (e.g. exact_moe's exact
        # capacity); the request only chooses threshold values
        return merge_policy_override(self.policy, gen.policy)

    def _make_batch(self, prompts: List[np.ndarray]) -> Dict[str, torch.Tensor]:
        """Right-align (left-pad) prompts to the common max length so every
        real token sits at the end — causal attention then gives each request
        a correct suffix context (pads influence only via their K/V, which we
        accept for pad-light batches; equal-length prompts are exact)."""
        L = max(len(p) for p in prompts)
        toks = np.full((len(prompts), L), self.pad_token, np.int32)
        for i, p in enumerate(prompts):
            toks[i, L - len(p):] = p
        return {"tokens": torch.from_numpy(toks).long().to(self.device),
                **M.frontend_inputs(self.cfg, len(prompts), self.device)}

    # -- unified request API --------------------------------------------

    def _validate(self, req: Request) -> None:
        self._policy_for(req.gen)        # raises on family mismatch

    def _ready(self) -> bool:
        """Convoy semantics: wait for a full batch while more traffic is
        still arriving; a flush (``run``/end of trace) serves partials."""
        if not self._queue:
            return False
        return self._flush or len(self._queue) >= self.batch_size

    @staticmethod
    def _policy_sig(gen: GenerationConfig):
        if gen.policy is None:
            return None
        return (type(gen.policy),
                tuple(torch.as_tensor(v).tolist()
                      for v in gen.policy.thresholds()))

    def _device_metrics(self):
        return self._dev_metrics

    def _metrics_hook(self, snap: MetricsSnapshot) -> None:
        snap.gauge("repro_engine_batch_size", self.batch_size)

    def _step(self) -> bool:
        """Serve ONE convoy batch to completion: pop up to ``batch_size``
        queued requests (cut early at a per-request policy-override change),
        prefill them together, decode with per-request EOS/budget/sampling.
        Returns True while more requests are queued."""
        if not self._queue:
            return False
        batch = [self._queue.popleft()]
        sig = self._policy_sig(batch[0][1].gen)
        while (len(batch) < self.batch_size and self._queue
               and self._policy_sig(self._queue[0][1].gen) == sig):
            batch.append(self._queue.popleft())
        self._run_batch(batch)
        return bool(self._queue)

    def _run_batch(self, batch: List[Tuple[int, Request]]) -> None:
        uids = [u for u, _ in batch]
        gens = [r.gen for _, r in batch]
        B = len(batch)
        b = self._make_batch([r.prompt for _, r in batch])
        policy = self._policy_for(gens[0])
        t0 = time.perf_counter()
        with self.tracer.span("prefill", batch=B):
            logits, cache = self._prefill(b, policy)
            last = _host_view(self.dist, torch.argmax(logits[:, -1:], dim=-1))
            last_np = last.cpu().numpy()          # waits for the prefill
        t_prefill = time.perf_counter() - t0
        done = np.zeros(B, bool)
        max_steps = max(g.max_new_tokens for g in gens)
        t0 = time.perf_counter()
        with self.tracer.span("decode_loop", batch=B):
            for step in range(max_steps):
                for i in range(B):
                    if done[i]:
                        continue
                    self._record_token(uids[i], int(last_np[i, 0]))
                    res = self._results[uids[i]]
                    if (last_np[i, 0] == gens[i].eos_token
                            or len(res.tokens) >= gens[i].max_new_tokens):
                        done[i] = True
                if done.all():
                    break
                logits, cache = self._serve(last, cache, policy)
                last = _host_view(self.dist,
                                  self._next_tokens(logits, gens, uids, step))
                last_np = last.cpu().numpy()
        t_decode = time.perf_counter() - t0
        # fold the batch's device metrics into the engine total with ONE
        # device-side add — no host transfer until .metrics()
        m = cache.get("metrics")
        if m is not None:
            self._dev_metrics = m if self._dev_metrics is None \
                else self._dev_metrics + m
        now = self._now()
        for u in uids:
            self._results[u].prefill_s = t_prefill
            self._results[u].decode_s = t_decode
            self._results[u].finished_s = now
            self.tracer.instant("retire", uid=u)

    @property
    def overflow_pairs(self) -> int:
        """Total MoE capacity-overflow drops across every batch served."""
        if self._dev_metrics is None:
            return 0
        return int(self._dev_metrics.overflow_pairs)

    def _next_tokens(self, logits, gens, uids, step):
        """(B, 1) next tokens: greedy, or sampled at a request's temperature
        from a generator seeded by (seed, uid, step)."""
        greedy = torch.argmax(logits[:, -1:], dim=-1)
        if all(g.temperature == 0 for g in gens):
            return greedy
        toks = greedy.clone()
        for i, g in enumerate(gens):
            if g.temperature > 0:
                toks[i, 0] = sample_token(logits[i, -1], g, uids[i], step)
        return toks


def _check_model_device(model, device: torch.device) -> None:
    if model.device != device:
        raise ValueError(f"model is on {model.device}, engine device is "
                         f"{device}")


@dataclasses.dataclass
class _SlotState:
    uid: int
    gen: GenerationConfig
    n_emitted: int = 0


def _check_setp_slots(cfg, dist, n_slots: int, policy) -> None:
    """Refuse a slot count that S-ETP would split over the batch axes while
    the policy carries per-slot thresholds: the (n_slots,) threshold
    tensors enter every rank's S-ETP body whole while its decode block
    holds only its share of the slots, so the first decode step fails to
    broadcast (as in the JAX package; ROADMAP.md §C)."""
    if dist is None or dist.moe_impl != "setp" or not cfg.is_moe \
            or policy is None or not len(policy.thresholds()):
        return
    from ..distributed.sharding import batch_axes
    split = 1
    for axis in batch_axes(n_slots, dist):
        split *= dist.size(axis)
    if split > 1:
        raise NotImplementedError(
            f"{n_slots} slots split over the batch axes "
            f"{batch_axes(n_slots, dist)} ({split} blocks), but the "
            "policy's per-slot thresholds cannot be split with them under "
            "S-ETP yet; pick a slot count those axes do not divide")


class SlotEngineBase(EngineBase):
    """What the slot engines share: slots, per-slot policies, emission,
    retirement, the batched decode step and its sampling."""

    def __init__(self, cfg: ModelConfig, model, *, n_slots: int,
                 max_prompt_len: int, max_new_tokens: int, pad_token: int,
                 policy: Optional[SparsityPolicy], exact_moe: bool,
                 metrics: bool, device, dist=None):
        super().__init__(metrics=metrics)
        self.device = resolve_device(device)
        _check_model_device(model, self.device)
        self.cfg = cfg
        self.model = model
        self.dist = dist
        self.n_slots = n_slots
        self.pad_token = pad_token
        self.max_prompt_len = max_prompt_len
        self.max_new_tokens = max_new_tokens
        if exact_moe and cfg.is_moe:
            policy = exact_moe_policy(policy)
            if dist is not None and dist.moe_impl == "setp":
                warnings.warn(
                    "exact_moe only governs the dispatch MoE path; the setp "
                    "(EP) path uses its own capacity factors, so outputs "
                    "may depend on co-batched traffic", stacklevel=3)
        self.policy = policy
        self._slot_pol = (SlotPolicies(policy, n_slots, self.device)
                          if policy is not None else None)
        _check_setp_slots(cfg, dist, n_slots, policy)
        self._metrics_spec = metrics_spec(cfg, model) if metrics else None
        self._slots: List = [None] * n_slots
        self._last = np.full((n_slots, 1), pad_token, np.int32)
        self._active = np.zeros((n_slots,), bool)
        # scheduler stats
        self.n_admitted = 0
        self.n_retired = 0
        self.max_concurrency = 0
        self.decode_steps = 0

    def _validate(self, req: Request) -> None:
        if len(np.asarray(req.prompt)) > self.max_prompt_len:
            raise ValueError(
                f"prompt length {len(np.asarray(req.prompt))} exceeds engine "
                f"max_prompt_len {self.max_prompt_len}")
        if req.gen.max_new_tokens > self.max_new_tokens:
            raise ValueError(
                f"request max_new_tokens {req.gen.max_new_tokens} "
                f"exceeds engine budget {self.max_new_tokens}")
        if req.gen.policy is not None:
            if self._slot_pol is None:
                raise ValueError("per-request policy override requires an "
                                 "engine built with a base policy")
            self._slot_pol.validate(req.gen)

    def _request_policy(self, gen: GenerationConfig):
        if self._slot_pol is None:
            return self.policy
        return self._slot_pol.request_policy(gen)

    def _stacked_policy(self):
        if self._slot_pol is None:
            return self.policy
        return self._slot_pol.stacked()

    def _tokens(self, values) -> torch.Tensor:
        return torch.from_numpy(np.asarray(values)).long().to(self.device)

    def _free_slot_hook(self, slot: int) -> None:
        """Release a retiring slot's engine-specific resources."""

    def _retire(self, slot: int) -> None:
        st = self._slots[slot]
        self._results[st.uid].finished_s = self._now()
        self.tracer.instant("retire", uid=st.uid, slot=slot,
                            n_tokens=st.n_emitted)
        self._free_slot_hook(slot)
        self._slots[slot] = None
        self._active[slot] = False
        self._last[slot, 0] = self.pad_token
        if self._slot_pol is not None:
            self._slot_pol.assign(slot, None)
        self.n_retired += 1

    def _emit(self, slot: int, token: int) -> None:
        """Record one generated token for the slot's request; retire on EOS
        or budget exhaustion (the EOS token itself is emitted)."""
        st = self._slots[slot]
        self._record_token(st.uid, token)
        st.n_emitted += 1
        if token == st.gen.eos_token or st.n_emitted >= st.gen.max_new_tokens:
            self._retire(slot)

    def _decode_call(self, write_mask: bool = False, **layout_kw):
        """One batched decode step over every slot (inactive slots hold
        their position; with ``write_mask`` their KV writes are dropped
        too). Returns (last logits (n_slots, vocab), greedy)."""
        self._warm("decode")
        cache = self._cache
        with self.tracer.layer("scheduler.inputs"):
            active = torch.from_numpy(self._active).to(self.device)
            tokens = self._tokens(self._last)
            policy = self._stacked_policy()
        if write_mask:
            layout_kw["write_mask"] = active
        with torch.no_grad():
            logits, new = transformer.decode_step(
                self.model, tokens, cache, self.cfg, policy=policy,
                dist=self.dist, **layout_kw)
        with self.tracer.layer("model.head"):
            new["pos"] = torch.where(active, new["pos"], cache["pos"])
            self._cache = new
            return logits[:, -1], torch.argmax(logits[:, -1], dim=-1)

    def _decode_active(self, decoding, **layout_kw) -> None:
        """Decode one step and emit a token for every slot in
        ``decoding`` — greedy, or sampled at the request's temperature."""
        with self.tracer.span("decode", batch=int(self._active.sum())):
            logits, toks = self._decode_call(**layout_kw)
            for slot in decoding:
                st = self._slots[slot]
                if st.gen.temperature > 0:
                    toks[slot] = sample_token(logits[slot], st.gen, st.uid,
                                              st.n_emitted)
            with self.tracer.layer("scheduler.readback"):
                # the step's one read-back
                toks = _host_view(self.dist, toks).cpu().numpy()
        self.decode_steps += 1
        with self.tracer.layer("scheduler.emit"):
            for slot in decoding:
                tok = int(toks[slot])
                self._last[slot, 0] = tok
                self._emit(slot, tok)

    def reset_stats(self):
        """Zero the scheduler statistics (after a warm-up run, say)."""
        self.n_admitted = self.n_retired = 0
        self.max_concurrency = 0
        self.decode_steps = 0

    def _device_metrics(self):
        return self._cache.get("metrics")

    @property
    def overflow_pairs(self) -> int:
        """Token-expert pairs dropped by capacity overflow since the engine
        was built (0 under ``exact_moe``): one scalar read-back."""
        m = self._device_metrics()
        if m is not None:
            return int(m.overflow_pairs)
        if "moe_overflow" in self._cache:
            return int(self._cache["moe_overflow"])
        return 0

    @property
    def free_slots(self) -> int:
        return sum(s is None for s in self._slots)

    @property
    def queued(self) -> int:
        return len(self._queue)


class ContinuousBatchingEngine(SlotEngineBase):
    """Slot-based continuous-batching engine on ``device`` (default the
    card; the model must live there).

    * ``n_slots`` decode slots form the fixed batch of one decode step.
    * Prompts are right-padded to ``max_prompt_len`` and prefilled one
      request at a time by a prefill-insert that writes the request's KV
      into a free slot's rows of the shared cache and emits its first
      greedy token; ``cache["pos"]`` holds per-slot positions, so requests
      at different depths decode together.
    * A request retires on EOS or budget exhaustion, freeing its slot for
      the next queued request — mid-decode admission.

    Right-padding is exact for causal attention (pad K/V sits after every
    real token and is masked by per-slot validity until overwritten), so
    sliding-window (ring) caches are not supported here.
    """

    def __init__(self, cfg: ModelConfig, model, *, n_slots: int = 8,
                 max_prompt_len: int = 512, max_new_tokens: int = 128,
                 pad_token: int = 0, policy: Optional[SparsityPolicy] = None,
                 exact_moe: bool = True, cache_dtype=torch.bfloat16,
                 metrics: bool = True, device="cuda", dist=None):
        if cfg.family in ("audio", "ssm", "hybrid"):
            # ssm/hybrid: the Mamba recurrence runs over the trailing pads
            # of a right-padded prefill and pollutes the captured decode
            # state; per-slot validity masking has no recurrent analog
            raise NotImplementedError(
                f"continuous batching supports attention-based decoder-only "
                f"families, not {cfg.family!r}")
        super().__init__(cfg, model, n_slots=n_slots,
                         max_prompt_len=max_prompt_len,
                         max_new_tokens=max_new_tokens, pad_token=pad_token,
                         policy=policy, exact_moe=exact_moe, metrics=metrics,
                         device=device, dist=dist)
        self.cache_dtype = cache_dtype
        self.context_len = M.context_len_for(cfg, max_prompt_len,
                                             max_new_tokens)
        self._cache = M.init_cache(cfg, n_slots, self.context_len,
                                   per_slot_pos=True, dtype=cache_dtype,
                                   metrics_spec=self._metrics_spec,
                                   device=self.device)

    def _has_work(self) -> bool:
        return bool(self._queue) or bool(self._active.any())

    def _prefill_insert(self, prompt: np.ndarray, slot: int,
                        gen: GenerationConfig) -> int:
        """Prefill one prompt, right-padded to ``max_prompt_len`` (after
        the frontend prefix, if any), and insert its KV rows into
        ``slot``; the request's MoE stats add into the engine's. Returns
        the first greedy token (read back: the prefill's one sync)."""
        self._warm("prefill")
        valid_len = len(prompt)
        with self.tracer.layer("scheduler.inputs"):
            toks = np.full((1, self.max_prompt_len), self.pad_token,
                           np.int32)
            toks[0, :valid_len] = prompt
            batch = {"tokens": self._tokens(toks),
                     **M.frontend_inputs(self.cfg, 1, self.device)}
            policy = self._request_policy(gen)
        with torch.no_grad():
            logits, small = transformer.prefill(
                self.model, batch, self.cfg,
                cache_len=self.context_len, policy=policy,
                cache_dtype=self.cache_dtype, metrics=self.metrics_enabled,
                dist=self.dist)
        with self.tracer.layer("scheduler.insert"):
            cache = self._cache
            n = self.context_len             # the slot's rows, sink row off
            for big, sm in zip(cache["layers"], small["layers"]):
                for key, rows in sm.items():  # {"k", "v"} or MLA's {"c", "kr"}
                    big[key][slot, :n] = rows[0]
            cache["pos"][slot] = M.frontend_len(self.cfg) + valid_len
            if "metrics" in cache and "metrics" in small:
                cache["metrics"] = cache["metrics"] + small["metrics"]
            elif "moe_overflow" in cache and "moe_overflow" in small:
                cache["moe_overflow"] = cache["moe_overflow"] + \
                    small["moe_overflow"]
        with self.tracer.layer("model.head"):
            first = _host_view(
                self.dist, torch.argmax(logits[0, valid_len - 1]).reshape(1))
        with self.tracer.layer("scheduler.readback"):
            return int(first[0])

    def _admit(self) -> int:
        """Move queued requests into free slots (one prefill-insert each).
        A request whose first token already ends it retires at once."""
        admitted = 0
        for slot in range(self.n_slots):
            if not self._queue:
                break
            if self._slots[slot] is not None:
                continue
            uid, req = self._queue.popleft()
            if self._slot_pol is not None:
                self._slot_pol.assign(slot, req.gen)
            t0 = time.perf_counter()
            # positions: the prompt rows run, padding included
            with self.tracer.span("prefill_insert", uid=uid, slot=slot,
                                  prompt_len=len(req.prompt),
                                  positions=self.max_prompt_len,
                                  device_clock=self.device):
                first = self._prefill_insert(req.prompt, slot, req.gen)
            self._results[uid].prefill_s = time.perf_counter() - t0
            with self.tracer.layer("scheduler.emit"):
                self._slots[slot] = _SlotState(uid=uid, gen=req.gen)
                self._active[slot] = True
                self._last[slot, 0] = first
                self._emit(slot, first)
            admitted += 1
            self.n_admitted += 1
        self.max_concurrency = max(self.max_concurrency,
                                   int(self._active.sum()))
        return admitted

    def _step(self) -> bool:
        """One scheduler iteration: admit waiting requests into free slots,
        then one batched decode step over all slots. Returns True while
        there is (or may be) work left."""
        with self.tracer.layer("scheduler.admit"):
            self._admit()
        if not self._active.any():
            return bool(self._queue)
        self._decode_active([s for s in range(self.n_slots)
                             if self._slots[s] is not None])
        return True

    def _metrics_hook(self, snap) -> None:
        snap.gauge("repro_engine_slots", float(self.n_slots))
        snap.gauge("repro_engine_free_slots", float(self.free_slots))
        snap.counter("repro_engine_decode_steps_total",
                     float(self.decode_steps))
        snap.counter("repro_requests_admitted_total", float(self.n_admitted))
        snap.counter("repro_requests_retired_total", float(self.n_retired))
