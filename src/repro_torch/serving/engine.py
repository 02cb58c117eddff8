"""The synchronized-batch serving engine (paper §4).

``ServingEngine``: requests are grouped to a common (left-padded) prompt
length, prefilled in one call, then decoded together at ONE shared
absolute position. One ``step()`` serves one convoy batch to completion —
the setting of the paper's efficiency evaluation.

MoE sparsity is configured by one ``SparsityPolicy`` (``core.policy``:
none/1t/2t); requests may override threshold values per request via
``GenerationConfig.policy`` (same policy family). With ``exact_moe`` the
MoE dispatch capacity is the token count, so no token-expert pair is ever
dropped by overflow; overflow drops that do occur are counted and surfaced
via ``engine.overflow_pairs``.

PyTorch runs eagerly, so there are no traces to count: the engine's
``prefill_traces``/``decode_traces`` count first calls (warm-up: kernel
build and load, allocator growth), so ``timing`` reports the first step as
warm-up (``compile_s``) and the rest as steady state.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..core.policy import NoDrop, SparsityPolicy, merge_policy_override
from ..device import resolve_device
from ..models import model as M
from ..obs import MetricsSnapshot
from .api import EngineBase, GenerationConfig, Request, Result  # noqa: F401


class ServingEngine(EngineBase):
    """Synchronized-batch engine around the prefill/serve steps, on
    ``device`` (default the card; the model must live there)."""

    def __init__(self, cfg: ModelConfig, model, *, batch_size: int = 8,
                 max_prompt_len: int = 512, max_new_tokens: int = 128,
                 window: int = 0, pad_token: int = 0,
                 policy: Optional[SparsityPolicy] = None,
                 exact_moe: bool = False, cache_dtype=torch.bfloat16,
                 metrics: bool = True, device="cuda"):
        super().__init__(metrics=metrics)
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"model is on {model.device}, engine device is "
                             f"{self.device}")
        self.cfg = cfg
        self.model = model
        self.batch_size = batch_size
        self.window = window
        self.pad_token = pad_token
        if exact_moe and cfg.is_moe:
            policy = dataclasses.replace(
                policy if policy is not None else NoDrop(),
                exact_capacity=True)
        self.policy = policy
        self.cache_dtype = cache_dtype
        # device-resident MetricsState summed over served batches (one add
        # per batch, read only by engine.metrics()); None until the first
        # metrics-enabled batch finishes
        self._dev_metrics = None
        self.context_len = M.context_len_for(cfg, max_prompt_len,
                                             max_new_tokens)
        # first-call (warm-up) counters; see the module docstring
        self.prefill_traces = 0
        self.decode_traces = 0

    def _prefill(self, batch, policy):
        if self.prefill_traces == 0:
            self.prefill_traces = 1
        return M.make_prefill_step(
            self.cfg, cache_len=self.context_len, window=self.window,
            policy=policy, cache_dtype=self.cache_dtype,
            metrics=self.metrics_enabled)(self.model, batch)

    def _serve(self, token, cache, policy):
        if self.decode_traces == 0:
            self.decode_traces = 1
        return M.make_serve_step(self.cfg, window=self.window,
                                 policy=policy)(self.model, token, cache)

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
        return {"tokens": torch.from_numpy(toks).long().to(self.device)}

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

    def _trace_count(self) -> int:
        return self.prefill_traces + self.decode_traces

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
            last = torch.argmax(logits[:, -1:], dim=-1)
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
                last = self._next_tokens(logits, gens, uids, step)
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
                gen = torch.Generator(device=logits.device)
                gen.manual_seed(hash((g.seed, uids[i], step)) & (2 ** 63 - 1))
                probs = torch.softmax(logits[i, -1].float() / g.temperature,
                                      dim=-1)
                toks[i, 0] = torch.multinomial(probs, 1, generator=gen)[0]
        return toks
