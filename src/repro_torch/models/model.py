"""Model entry points: construction with the port's seeded init, the
loss and the train step, and the prefill / serve step builders the engines
call. Family routing, as in the JAX package: ``audio`` -> ``models.whisper``
(encoder-decoder), every other family -> ``models.transformer``."""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..device import resolve_device
from . import transformer, whisper
from .transformer import Transformer
from .whisper import Whisper


def _mod(cfg: ModelConfig):
    """The family's model module (the JAX package's ``_mod``)."""
    return whisper if cfg.family == "audio" else transformer


def _model_class(cfg: ModelConfig):
    return {whisper: Whisper, transformer: Transformer}[_mod(cfg)]


# the batch key of each stub frontend's (B, n_frontend_tokens, d) inputs
_FRONTEND_KEY = {"vision": "frontend", "audio": "audio_embeds"}


def init_params(cfg: ModelConfig, *, seed: int = 0, device="cuda"):
    """The model with weights drawn from ``seed`` on ``device`` (default the
    card), in float32 from the JAX package's distributions: every matrix
    ``0.02 * N(0, 1)``, norms ones, the Mamba2 leaves as
    ``models.mamba2.Mamba2`` lists them. The draws are PyTorch's, so they
    differ from the JAX package's init of the same seed;
    ``checkpoint.from_numpy`` loads the JAX weights instead."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    with torch.no_grad():
        return _model_class(cfg)(cfg, device=dev, generator=gen)


def empty_model(cfg: ModelConfig, *, device="cuda"):
    """The model with allocated, undrawn weights (to be loaded)."""
    dev = resolve_device(device)
    with torch.no_grad():
        return _model_class(cfg)(cfg, device=dev, generator=None)


def trainable(model) -> Dict[str, torch.Tensor]:
    """The model's leaves of the JAX parameter tree, by parameter name:
    every parameter but a prepared MoE layer's ``thresholds``."""
    return {k: p for k, p in model.named_parameters()
            if k.rsplit(".", 1)[-1] != "thresholds"}


def expert_shard_names(model) -> Tuple[str, ...]:
    """The parameter names of the S-ETP expert shards the model holds (the
    w1 / w3 / w2 of every MoE layer ``core.setp.shard_experts`` cut): the
    leaves that are one rank's slice of a stack split over ``model``."""
    return tuple(f"{name}.{k}" for name, m in model.named_modules()
                 if getattr(m, "ep_shards", 1) > 1
                 for k in ("w1", "w3", "w2"))


def set_trainable(model) -> Dict[str, torch.Tensor]:
    """Turn on ``requires_grad`` for exactly ``trainable(model)``; returns
    that dict."""
    params = trainable(model)
    for p in params.values():
        p.requires_grad_(True)
    return params


def to_device(batch: Dict, device) -> Dict[str, torch.Tensor]:
    """A batch of numpy arrays or tensors as tensors on ``device``."""
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def cross_entropy(logits, targets):
    """Mean token negative log-likelihood, in float32."""
    logp = F.log_softmax(logits.float(), dim=-1)
    ll = torch.gather(logp, -1, targets.long()[..., None])[..., 0]
    return -torch.mean(ll)


def loss_fn(model, batch, cfg: ModelConfig, *, window: int = 0,
            policy=None, aux_coef: float = 0.0, dist=None):
    """Cross entropy (+ ``aux_coef`` times the Switch-style MoE
    load-balance aux loss). Without a ``policy`` this is the training
    loss: the differentiable route (``transformer.forward(kernels=False)``),
    under whatever grad mode the caller set. Under a sparsity ``policy``
    (prepared weights) it is the accuracy-side reading of that policy: no
    gradient, the serving route with its kernels. Whisper has no MoE layer:
    its loss is the cross entropy alone, never the aux term, and no kernel
    runs on its path.

    Under an EP context ``dist`` the loss is the training loss over the
    S-ETP layers (``kernels=False``), with ``policy`` the one the JAX
    package's ``DistContext`` carries (weights prepared for the EP size):
    every rank computes the same full loss, the mean over the whole
    batch."""
    batch = to_device(batch, model.device)
    if dist is not None:
        return _loss(model, batch, cfg, window, policy, aux_coef, False,
                     dist)
    if policy is not None:
        with torch.no_grad():
            return _loss(model, batch, cfg, window, policy, aux_coef, True)
    return _loss(model, batch, cfg, window, None, aux_coef, False)


def _loss(model, batch, cfg, window, policy, aux_coef, kernels, dist=None):
    if aux_coef and cfg.is_moe:
        logits, aux = transformer.forward(model, batch, cfg, window=window,
                                          policy=policy, with_aux=True,
                                          kernels=kernels, dist=dist)
        return cross_entropy(logits, batch["targets"]) + aux_coef * aux
    logits = _mod(cfg).forward(model, batch, cfg, window=window,
                               policy=policy, kernels=kernels, dist=dist)
    return cross_entropy(logits, batch["targets"])


def make_train_step(cfg: ModelConfig, optimizer, *, window: int = 0,
                    aux_coef: float = 0.0, dist=None, policy=None):
    """(model, opt_state, batch) -> loss, after updating the model's
    trainable leaves and ``opt_state`` in place (``optimizer`` from
    ``optim.adamw``; its ``last_grad_norm`` holds the step's grad norm).
    Turns on ``requires_grad`` for the trainable leaves.

    ``dist``: an EP context (``distributed.DistContext``, the JAX
    package's ``make_train_step(dist=...)``): every rank runs the step on
    the same batch, its MoE layers through S-ETP on its expert shard,
    checkpointing blocks under ``dist.remat``; ``policy`` is the sparsity
    policy beside it (default ``NoDrop``). The gradient is JAX's through
    the ``shard_map``, so no rank rescales it; the clip's global norm sums
    each expert shard's share over ``model``."""
    if policy is not None and dist is None:
        raise ValueError("a policy trains beside an EP context only; off "
                         "EP, loss_fn under a policy takes no gradient")

    def step(model, opt_state, batch):
        params = set_trainable(model)
        with torch.enable_grad():
            loss = loss_fn(model, batch, cfg, window=window,
                           aux_coef=aux_coef, dist=dist, policy=policy)
            # a leaf the batch does not reach (the vision stub's projection
            # on text-only batches) gets zeros, as JAX's grad gives it
            grads = torch.autograd.grad(loss, list(params.values()),
                                        allow_unused=True,
                                        materialize_grads=True)
        optimizer.update(dict(zip(params, grads)), opt_state, params,
                         dist=dist, sharded=expert_shard_names(model))
        return loss.detach()
    return step


def make_batch(rng: np.random.Generator, cfg: ModelConfig, batch: int,
               seq: int, kind: str) -> Dict[str, np.ndarray]:
    """Random numpy batch for smoke tests / examples: int32 ``tokens``
    (and ``targets`` when ``kind == "train"``), and the vision stub's
    float32 ``frontend`` embeddings or the audio stub's float32
    ``audio_embeds``, each ``0.1 * N(0, 1)`` of (batch, n_frontend_tokens,
    d_model)."""
    out = {"tokens": rng.integers(0, cfg.vocab_size, (batch, seq),
                                  dtype=np.int32)}
    if kind == "train":
        out["targets"] = rng.integers(0, cfg.vocab_size, (batch, seq),
                                      dtype=np.int32)
    key = _FRONTEND_KEY.get(cfg.frontend)
    if key is not None:
        out[key] = (rng.standard_normal(
            (batch, cfg.n_frontend_tokens, cfg.d_model)) * 0.1).astype(
                np.float32)
    return out


def make_prefill_step(cfg: ModelConfig, *, cache_len: int = 0,
                      window: int = 0, policy=None,
                      cache_dtype=torch.bfloat16, metrics: bool = True,
                      dist=None):
    """(model, batch) -> (logits (B,S,vocab), populated decode cache).
    ``dist``: an EP context (``distributed.DistContext``) for S-ETP.
    ``policy`` and ``metrics`` do not apply to Whisper (no MoE, no
    metrics seam in its cache)."""
    def step(model, batch):
        with torch.no_grad():
            return _mod(cfg).prefill(model, batch, cfg, cache_len=cache_len,
                                     window=window, policy=policy,
                                     cache_dtype=cache_dtype,
                                     metrics=metrics, dist=dist)
    return step


def make_serve_step(cfg: ModelConfig, *, window: int = 0, policy=None,
                    dist=None):
    """(model, token (B,1), cache) -> (logits, cache) — ONE new token."""
    def step(model, token, cache):
        with torch.no_grad():
            return _mod(cfg).decode_step(model, token, cache, cfg,
                                         window=window, policy=policy,
                                         dist=dist)
    return step


def frontend_len(cfg: ModelConfig) -> int:
    """Positions the vision stub's patch embeddings take before a prompt's
    tokens. 0 for any other model, the audio stub's too: its frames live in
    the cross-attention cache, not in the self-attention positions."""
    return cfg.n_frontend_tokens if cfg.frontend == "vision" else 0


def frontend_inputs(cfg: ModelConfig, batch: int, device) -> dict:
    """The stub frontend's zero inputs the serving engines feed: the vision
    stub's patch embeddings ``{"frontend": ...}`` or the audio stub's frame
    embeddings ``{"audio_embeds": ...}``, each (batch, n_frontend_tokens,
    d_model); {} without a frontend."""
    key = _FRONTEND_KEY.get(cfg.frontend)
    if key is None:
        return {}
    return {key: torch.zeros((batch, cfg.n_frontend_tokens, cfg.d_model),
                             device=device)}


def context_len_for(cfg: ModelConfig, prompt_len: int,
                    new_tokens: int) -> int:
    """KV capacity needed to prefill ``prompt_len`` tokens (after the
    frontend prefix) and then generate ``new_tokens``."""
    return prompt_len + frontend_len(cfg) + new_tokens


def init_cache(cfg: ModelConfig, batch: int, context_len: int, *,
               window: int = 0, dtype=torch.bfloat16,
               per_slot_pos: bool = False,
               metrics_spec: Optional[tuple] = None, device="cuda"):
    """Empty contiguous decode cache on ``device`` (default the card);
    ``per_slot_pos`` gives each of the ``batch`` slots its own position.
    A Whisper cache holds the cross K/V as well and has neither per-slot
    positions nor a metrics seam."""
    return _mod(cfg).init_cache(cfg, batch, context_len, window=window,
                                dtype=dtype, per_slot_pos=per_slot_pos,
                                metrics_spec=metrics_spec, device=device)


def init_paged_cache(cfg: ModelConfig, n_pages: int, page_size: int,
                     n_slots: int, *, dtype=torch.bfloat16,
                     metrics_spec: Optional[tuple] = None, device="cuda"):
    """Empty paged decode cache on ``device`` (default the card)."""
    return transformer.init_paged_cache(cfg, n_pages, page_size, n_slots,
                                        dtype=dtype,
                                        metrics_spec=metrics_spec,
                                        device=device)
