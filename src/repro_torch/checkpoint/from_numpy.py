"""Weight bridge: load the JAX package's parameter tree, given as numpy
arrays, into the port's modules.

The tree is ``repro.models.model.init_params`` output after
``jax.tree.map(np.asarray, ...)``: ``{"embed": {"embedding", "lm_head"},
"final_norm", "blocks": {...}}`` with every block leaf stacked over a
leading layers axis, which this splits into the per-layer modules (for
``ssm`` a block is ``{"ln1", "mamba": {...}}``). The hybrid tree holds
``"mamba_blocks"`` (stacked) and ``"shared_attn"`` (one block, unstacked)
in place of ``"blocks"``; a vision-frontend tree adds
``"frontend_proj"``. Trees of prepared (partitioned) MoE weights load as
well: the expert tensors take the tree's shapes, and a ``per_layer``
policy's ``moe["thresholds"]`` (layers, 2) loads into each layer. An MLA
block's attention leaves (``wq_a``, ``q_norm``, ``wq_b``, ``wkv_a``,
``kv_norm``, ``wk_b``, ``wv_b``, ``wo``) load by the same names. Given an
EP context, a tree prepared with ``n_ep_devices`` (strided placement)
loads as this rank's S-ETP shard: each MoE layer keeps only the rank's
sub-experts (``core.setp.expert_shard``). Nothing here imports JAX.
"""
from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch
from torch import nn

from ..models.model import empty_model
from ..models.transformer import Transformer


def _param(a, device) -> nn.Parameter:
    return nn.Parameter(torch.from_numpy(np.array(a, dtype=np.float32))
                        .to(device), requires_grad=False)


def _load(module: nn.Module, tree: Mapping, layer: Optional[int],
          device) -> None:
    """Load ``tree`` into ``module``: each leaf's slice ``layer`` of its
    stacked layers axis, or the whole leaf when ``layer`` is None."""
    for name, value in tree.items():
        if isinstance(value, Mapping):
            _load(getattr(module, name), value, layer, device)
            continue
        if name not in module._parameters:
            raise KeyError(f"{type(module).__name__} has no weight {name!r}")
        setattr(module, name,
                _param(value if layer is None else value[layer], device))


def params_from_numpy(tree: Mapping, cfg, device="cuda",
                      dist=None) -> Transformer:
    """A ``Transformer`` holding the weights of the numpy tree; with an EP
    context ``dist``, only this rank's shard of every MoE layer's placed
    experts (over the ``model`` axis)."""
    model = empty_model(cfg, device=device)
    dev = model.device
    model.embed.embedding = _param(tree["embed"]["embedding"], dev)
    if "lm_head" in tree["embed"]:
        model.embed.lm_head = _param(tree["embed"]["lm_head"], dev)
    model.final_norm = _param(tree["final_norm"], dev)
    if cfg.frontend:
        model.frontend_proj = _param(tree["frontend_proj"], dev)
    if cfg.family == "hybrid":
        for i, block in enumerate(model.mamba_blocks):
            _load(block, tree["mamba_blocks"], i, dev)
        _load(model.shared_attn, tree["shared_attn"], None, dev)
        return model
    for i, block in enumerate(model.blocks):
        _load(block, tree["blocks"], i, dev)
    if dist is not None:
        from ..core import setp
        setp.shard_experts(model, dist)
    return model
