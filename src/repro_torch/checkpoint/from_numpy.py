"""Weight bridge: load the JAX package's parameter tree, given as numpy
arrays, into the port's modules.

The tree is ``repro.models.model.init_params`` output after
``jax.tree.map(np.asarray, ...)``: ``{"embed": {"embedding", "lm_head"},
"final_norm", "blocks": {...}}`` with every block leaf stacked over a
leading layers axis, which this splits into the per-layer modules (for
``ssm`` a block is ``{"ln1", "mamba": {...}}``). The hybrid tree holds
``"mamba_blocks"`` (stacked) and ``"shared_attn"`` (one block, unstacked)
in place of ``"blocks"``; a vision-frontend tree adds
``"frontend_proj"``. The Whisper tree (``audio``) holds ``"encoder"`` and
``"decoder"`` (stacked, like ``"blocks"``) and the single leaves
``"enc_norm"`` and ``"frontend_proj"``. Trees of prepared (partitioned) MoE weights load as
well: the expert tensors take the tree's shapes, and a ``per_layer``
policy's ``moe["thresholds"]`` (layers, 2) loads into each layer. An MLA
block's attention leaves (``wq_a``, ``q_norm``, ``wq_b``, ``wkv_a``,
``kv_norm``, ``wk_b``, ``wv_b``, ``wo``) load by the same names. Given an
EP context, a tree prepared with ``n_ep_devices`` (strided placement)
loads as this rank's S-ETP shard: each MoE layer keeps only the rank's
sub-experts (``core.setp.expert_shard``). Nothing here imports JAX.

The inverse maps restack a model's per-layer modules into that tree
(``params_to_numpy``), and the AdamW state's moments likewise
(``opt_state_to_numpy``: an ``optim.AdamWState`` of numpy leaves, whose
fields flatten to ``step``, ``mu/...``, ``nu/...`` as JAX's ``AdamWState``
does); ``load_params`` / ``load_opt_state`` copy such trees back into an
existing model and state in place. A model holding its rank's S-ETP
expert shards maps to the JAX package's global arrays given its EP
context: each expert leaf (and its moments) is all-gathered over
``model`` into the full stack in placement order, and loading keeps the
rank's slice of it again.
"""
from __future__ import annotations

from typing import Callable, Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..models.model import empty_model, expert_shard_names
from ..models.transformer import Transformer
from ..optim import AdamWState

# the modules whose leaves the JAX tree stacks over a leading layers axis
_STACKED = ("blocks", "mamba_blocks", "encoder", "decoder")


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


def params_from_numpy(tree: Mapping, cfg, device="cuda", dist=None):
    """A ``Transformer`` (a ``Whisper`` for the audio family) holding the
    weights of the numpy tree; with an EP context ``dist``, only this
    rank's shard of every MoE layer's placed experts (over the ``model``
    axis)."""
    model = empty_model(cfg, device=device)
    dev = model.device
    if cfg.family == "audio":
        if dist is not None:
            raise NotImplementedError("Whisper has no expert shard")
        load_params(model, tree)
        return model
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


# ---------------------------------------------------------------------------
# The inverse: port modules / optimizer state -> the JAX tree
# ---------------------------------------------------------------------------

def _tree_path(name: str) -> Tuple[Tuple[str, ...], Optional[int]]:
    """A parameter name's path in the JAX tree and its layer (None for a
    leaf the tree does not stack): ``blocks.3.moe.w1`` -> (("blocks",
    "moe", "w1"), 3)."""
    parts = name.split(".")
    if parts[0] in _STACKED:
        return (parts[0],) + tuple(parts[2:]), int(parts[1])
    return tuple(parts), None


def _nest(tree: Dict, path: Tuple[str, ...], value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def _restack(named: Mapping[str, torch.Tensor], leaf: Callable,
             stack: Callable) -> Dict:
    """The nested JAX tree of ``named`` (parameter name -> tensor): each
    per-layer leaf stacked over its layers by ``stack``, the others mapped
    by ``leaf``."""
    out: Dict = {}
    layers: Dict[Tuple[str, ...], Dict[int, torch.Tensor]] = {}
    for name, t in named.items():
        path, layer = _tree_path(name)
        if layer is None:
            _nest(out, path, leaf(t))
        else:
            layers.setdefault(path, {})[layer] = t
    for path, by_layer in layers.items():
        if sorted(by_layer) != list(range(len(by_layer))):
            raise ValueError(f"{'/'.join(path)}: layers {sorted(by_layer)} "
                             "are not 0..n-1")
        _nest(out, path, stack([by_layer[i] for i in range(len(by_layer))]))
    return out


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().to("cpu", copy=True).numpy()


def _to_numpy_tree(named: Mapping[str, torch.Tensor]) -> Dict:
    return _restack(named, _host, lambda ts: _host(torch.stack(ts)))


def _shards(model: Transformer, dist) -> Tuple[str, ...]:
    """The model's expert-shard leaves; they need the EP context."""
    names = expert_shard_names(model)
    if names and dist is None:
        raise ValueError("a model holding one rank's S-ETP shard of the "
                         "experts has no JAX tree of its own: pass its EP "
                         "context")
    return names


def _gathered(named: Mapping[str, torch.Tensor], shards, dist
              ) -> Dict[str, torch.Tensor]:
    """``named`` with each leaf of ``shards`` all-gathered over ``model``
    into the full stack in placement order, on the host (every rank joins
    each gather, in the same order)."""
    out = dict(named)
    for k in shards:
        if k in out:
            t = out[k].detach()
            out[k] = dist.all_gather(t, "model").cpu().reshape(
                (-1,) + tuple(t.shape[1:]))
    return out


def join_gathers(model: Transformer, state: AdamWState, dist) -> None:
    """What a rank that writes no checkpoint runs while the writing rank
    builds ``params_to_numpy`` and ``opt_state_to_numpy``: the same
    all-gathers in the same order, their results dropped."""
    shards = _shards(model, dist)
    for named in (dict(model.named_parameters()), state.mu, state.nu):
        for k in shards:
            if k in named:
                dist.all_gather(named[k].detach(), "model")


def params_to_numpy(model: Transformer, dist=None) -> Dict:
    """The model's weights as the JAX package's parameter tree of numpy
    arrays (the layout ``params_from_numpy`` loads); a model of expert
    shards needs its EP context ``dist`` (every rank joins the gathers)."""
    named = dict(model.named_parameters())
    return _to_numpy_tree(_gathered(named, _shards(model, dist), dist))


def opt_state_to_numpy(state: AdamWState, model: Optional[Transformer] = None,
                       dist=None) -> AdamWState:
    """The AdamW state with its moments restacked into the JAX tree, numpy
    leaves throughout (``step`` an int32 scalar array). The moments of a
    model of expert shards (``model``, with its EP context ``dist``) are
    gathered as the weights are."""
    shards = _shards(model, dist) if model is not None else ()
    return AdamWState(step=_host(state.step),
                      mu=_to_numpy_tree(_gathered(state.mu, shards, dist)),
                      nu=_to_numpy_tree(_gathered(state.nu, shards, dist)))


def _spec_tree(named: Mapping[str, torch.Tensor], shards=(), n_dev: int = 1
               ) -> Dict:
    """The tree of ``named`` as shape/dtype-only (meta) tensors: a restore
    target that allocates nothing (the leaves of ``shards`` at their
    gathered size, ``n_dev`` shards)."""
    def meta(shape, t):
        return torch.empty(shape, dtype=t.dtype, device="meta")
    named = {k: meta((n_dev * t.shape[0],) + tuple(t.shape[1:]), t)
             if k in shards else t for k, t in named.items()}
    return _restack(named, lambda t: meta(t.shape, t),
                    lambda ts: meta((len(ts),) + tuple(ts[0].shape), ts[0]))


def train_state_spec(model: Transformer, state: AdamWState,
                     dist=None) -> Dict:
    """``{"params": ..., "opt": AdamWState}`` of meta tensors shaped as the
    JAX trees of the model and its AdamW state: the target
    ``checkpoint.io.restore_checkpoint`` checks a training checkpoint
    against (a model of expert shards, with its EP context: the global
    arrays' shapes)."""
    shards = _shards(model, dist)
    n_dev = dist.size("model") if shards else 1
    return {"params": _spec_tree(dict(model.named_parameters()), shards,
                                 n_dev),
            "opt": AdamWState(step=torch.empty((), dtype=state.step.dtype,
                                               device="meta"),
                              mu=_spec_tree(state.mu, shards, n_dev),
                              nu=_spec_tree(state.nu, shards, n_dev))}


def _leaves(tree: Mapping, prefix: Tuple[str, ...] = ()
            ) -> Iterator[Tuple[Tuple[str, ...], object]]:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _unstack(tree: Mapping) -> Dict[str, np.ndarray]:
    """Parameter name -> array for every leaf of a JAX tree, the stacked
    leaves split into their layers."""
    out = {}
    for path, v in _leaves(tree):
        if path[0] in _STACKED:
            for i in range(np.shape(v)[0]):
                out[".".join((path[0], str(i)) + path[1:])] = v[i]
        else:
            out[".".join(path)] = v
    return out


@torch.no_grad()
def _copy_into(dst: Mapping[str, torch.Tensor], tree: Mapping, shards=(),
               dist=None) -> None:
    """Copy the leaves of ``tree`` into ``dst``; each leaf of ``shards``
    is a global stack of which ``dst`` keeps the rank's slice at its
    ``model`` coordinate (``core.setp.expert_shard``)."""
    src = _unstack(tree)
    missing, extra = sorted(set(dst) - set(src)), sorted(set(src) - set(dst))
    if missing or extra:
        raise KeyError(f"tree and target differ: missing {missing}, "
                       f"unexpected {extra}")
    for k, t in dst.items():
        a = np.asarray(src[k])
        if k in shards:
            n = a.shape[0] // dist.size("model")
            a = a[dist.coord("model") * n:(dist.coord("model") + 1) * n]
        if tuple(a.shape) != tuple(t.shape):
            raise ValueError(f"shape mismatch for {k}: {a.shape} vs "
                             f"{tuple(t.shape)}")
        t.copy_(torch.from_numpy(a).to(t.dtype))


def load_params(model: Transformer, tree: Mapping, dist=None) -> None:
    """Copy a JAX-layout parameter tree into the model's weights in place
    (same leaves, same shapes; a model of expert shards keeps its slice of
    each global expert stack, given its EP context ``dist``)."""
    _copy_into(dict(model.named_parameters()), tree, _shards(model, dist),
               dist)


def load_opt_state(state: AdamWState, tree: AdamWState,
                   model: Optional[Transformer] = None, dist=None) -> None:
    """Copy an AdamW state tree (JAX layout) into ``state`` in place (the
    moments of a model of expert shards as ``load_params`` slices its
    weights)."""
    shards = _shards(model, dist) if model is not None else ()
    with torch.no_grad():
        state.step.copy_(torch.as_tensor(np.asarray(tree.step)))
    _copy_into(state.mu, tree.mu, shards, dist)
    _copy_into(state.nu, tree.nu, shards, dist)
