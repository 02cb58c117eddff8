"""Model entry points: construction with the port's seeded init, and the
prefill / serve step builders the engines call."""
from __future__ import annotations

from typing import Optional

import torch

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
