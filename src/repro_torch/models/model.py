"""Model entry points: construction with the port's seeded init, the
loss and the train step, and the prefill / serve step builders the engines
call."""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..device import resolve_device
from . import transformer
from .transformer import Transformer


def init_params(cfg: ModelConfig, *, seed: int = 0,
                device="cuda") -> Transformer:
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
        return Transformer(cfg, device=dev, generator=gen)


def empty_model(cfg: ModelConfig, *, device="cuda") -> Transformer:
    """The model with allocated, undrawn weights (to be loaded)."""
    dev = resolve_device(device)
    with torch.no_grad():
        return Transformer(cfg, device=dev, generator=None)


def trainable(model: Transformer) -> Dict[str, torch.Tensor]:
    """The model's leaves of the JAX parameter tree, by parameter name:
    every parameter but a prepared MoE layer's ``thresholds``."""
    return {k: p for k, p in model.named_parameters()
            if k.rsplit(".", 1)[-1] != "thresholds"}


def set_trainable(model: Transformer) -> Dict[str, torch.Tensor]:
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


def loss_fn(model: Transformer, batch, cfg: ModelConfig, *, window: int = 0,
            policy=None, aux_coef: float = 0.0):
    """Cross entropy (+ ``aux_coef`` times the Switch-style MoE
    load-balance aux loss). Without a ``policy`` this is the training
    loss: the differentiable route (``transformer.forward(kernels=False)``),
    under whatever grad mode the caller set. Under a sparsity ``policy``
    (prepared weights) it is the accuracy-side reading of that policy: no
    gradient, the serving route with its kernels."""
    batch = to_device(batch, model.device)
    if policy is not None:
        with torch.no_grad():
            return _loss(model, batch, cfg, window, policy, aux_coef, True)
    return _loss(model, batch, cfg, window, None, aux_coef, False)


def _loss(model, batch, cfg, window, policy, aux_coef, kernels):
    if aux_coef and cfg.is_moe:
        logits, aux = transformer.forward(model, batch, cfg, window=window,
                                          policy=policy, with_aux=True,
                                          kernels=kernels)
        return cross_entropy(logits, batch["targets"]) + aux_coef * aux
    logits = transformer.forward(model, batch, cfg, window=window,
                                 policy=policy, kernels=kernels)
    return cross_entropy(logits, batch["targets"])


def make_train_step(cfg: ModelConfig, optimizer, *, window: int = 0,
                    aux_coef: float = 0.0, dist=None):
    """(model, opt_state, batch) -> loss, after updating the model's
    trainable leaves and ``opt_state`` in place (``optimizer`` from
    ``optim.adamw``; its ``last_grad_norm`` holds the step's grad norm).
    Turns on ``requires_grad`` for the trainable leaves. Training over EP
    (a ``dist`` context) is not ported yet."""
    if dist is not None:
        raise NotImplementedError("training over expert parallelism is not "
                                  "ported yet")

    def step(model, opt_state, batch):
        params = set_trainable(model)
        with torch.enable_grad():
            loss = loss_fn(model, batch, cfg, window=window,
                           aux_coef=aux_coef)
            # a leaf the batch does not reach (the vision stub's projection
            # on text-only batches) gets zeros, as JAX's grad gives it
            grads = torch.autograd.grad(loss, list(params.values()),
                                        allow_unused=True,
                                        materialize_grads=True)
        optimizer.update(dict(zip(params, grads)), opt_state, params)
        return loss.detach()
    return step


def make_batch(rng: np.random.Generator, cfg: ModelConfig, batch: int,
               seq: int, kind: str) -> Dict[str, np.ndarray]:
    """Random numpy batch for smoke tests / examples: int32 ``tokens``
    (and ``targets`` when ``kind == "train"``), and the vision stub's
    float32 ``frontend`` embeddings ``0.1 * N(0, 1)``."""
    out = {"tokens": rng.integers(0, cfg.vocab_size, (batch, seq),
                                  dtype=np.int32)}
    if kind == "train":
        out["targets"] = rng.integers(0, cfg.vocab_size, (batch, seq),
                                      dtype=np.int32)
    if cfg.frontend == "vision":
        out["frontend"] = (rng.standard_normal(
            (batch, cfg.n_frontend_tokens, cfg.d_model)) * 0.1).astype(
                np.float32)
    return out


def make_prefill_step(cfg: ModelConfig, *, cache_len: int = 0,
                      window: int = 0, policy=None,
                      cache_dtype=torch.bfloat16, metrics: bool = True,
                      dist=None):
    """(model, batch) -> (logits (B,S,vocab), populated decode cache).
    ``dist``: an EP context (``distributed.DistContext``) for S-ETP."""
    def step(model, batch):
        with torch.no_grad():
            return transformer.prefill(model, batch, cfg,
                                       cache_len=cache_len, window=window,
                                       policy=policy, cache_dtype=cache_dtype,
                                       metrics=metrics, dist=dist)
    return step


def make_serve_step(cfg: ModelConfig, *, window: int = 0, policy=None,
                    dist=None):
    """(model, token (B,1), cache) -> (logits, cache) — ONE new token."""
    def step(model, token, cache):
        with torch.no_grad():
            return transformer.decode_step(model, token, cache, cfg,
                                           window=window, policy=policy,
                                           dist=dist)
    return step


def frontend_len(cfg: ModelConfig) -> int:
    """Positions the vision stub's patch embeddings take before a prompt's
    tokens (0 without a vision frontend)."""
    return cfg.n_frontend_tokens if cfg.frontend == "vision" else 0


def frontend_inputs(cfg: ModelConfig, batch: int, device) -> dict:
    """The vision stub's zero patch embeddings ``{"frontend": (batch,
    n_frontend_tokens, d_model)}`` the serving engines feed a
    vision-frontend model ({} for any other)."""
    if not frontend_len(cfg):
        return {}
    return {"frontend": torch.zeros((batch, cfg.n_frontend_tokens,
                                     cfg.d_model), device=device)}


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
    ``per_slot_pos`` gives each of the ``batch`` slots its own position."""
    return transformer.init_cache(cfg, batch, context_len, window=window,
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
