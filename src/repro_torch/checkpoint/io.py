"""Tree checkpointing: npz shards + a JSON manifest, in the JAX package's
on-disk format, so a checkpoint written by either package restores in the
other.

``{ckpt_dir}/step_{step:08d}/`` holds ``manifest.json`` and
``shard_NNNN.npz`` files (a shard closes once it holds
``max_shard_bytes``). Leaves are keyed by their path as JAX's
``tree_flatten_with_path`` names it: dict keys in sorted order, a
NamedTuple's fields by name in field order, list / tuple items as
``[i]``, ``None`` no leaf; so ``{"params": ..., "opt": AdamWState}`` gives
``params/blocks/moe/w1``, ``opt/step``, ``opt/mu/...``. Leaves may be
numpy arrays or tensors (copied to the host one at a time);
``checkpoint.from_numpy`` maps a model and its optimizer state to and
from these trees.
"""
from __future__ import annotations

import json
import os
import re
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(type(x), "_fields")


def _children(tree) -> Optional[Iterator[Tuple[str, Any]]]:
    """(path entry, child) pairs of an inner node; None for a leaf."""
    if isinstance(tree, dict):
        return ((str(k), tree[k]) for k in sorted(tree))
    if _is_namedtuple(tree):
        return zip(type(tree)._fields, tree)
    if isinstance(tree, (list, tuple)):
        return ((f"[{i}]", v) for i, v in enumerate(tree))
    return None


def _flatten_with_paths(tree, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    children = _children(tree)
    if children is None:
        if tree is not None:
            yield prefix, tree
        return
    for name, child in children:
        yield from _flatten_with_paths(
            child, f"{prefix}/{name}" if prefix else name)


def _map_with_paths(fn: Callable, tree, prefix: str = ""):
    """``tree`` with each leaf replaced by ``fn(path, leaf)``."""
    def sub(name):
        return f"{prefix}/{name}" if prefix else name
    if isinstance(tree, dict):
        return {k: _map_with_paths(fn, v, sub(str(k)))
                for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(_map_with_paths(fn, v, sub(f))
                            for f, v in zip(type(tree)._fields, tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_paths(fn, v, sub(f"[{i}]"))
                          for i, v in enumerate(tree))
    return None if tree is None else fn(prefix, tree)


def _host_array(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _np_dtype(leaf):
    if isinstance(leaf, torch.Tensor):
        return torch.empty((), dtype=leaf.dtype).numpy().dtype
    return np.asarray(leaf).dtype


def save_checkpoint(ckpt_dir: str, step: int, tree: Any,
                    max_shard_bytes: int = 1 << 30) -> str:
    """Write tree to ``{ckpt_dir}/step_{step:08d}/`` and return that path."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    os.makedirs(path, exist_ok=True)
    manifest: Dict[str, Any] = {"step": step, "leaves": {}, "shards": []}
    shard: Dict[str, np.ndarray] = {}
    shard_bytes = 0
    shard_id = 0

    def flush():
        nonlocal shard, shard_bytes, shard_id
        if not shard:
            return
        fn = f"shard_{shard_id:04d}.npz"
        np.savez(os.path.join(path, fn), **shard)
        manifest["shards"].append(fn)
        shard = {}
        shard_bytes = 0
        shard_id += 1

    for key, leaf in _flatten_with_paths(tree):
        arr = _host_array(leaf)
        safe = re.sub(r"[^A-Za-z0-9_./\[\]-]", "_", key)
        manifest["leaves"][key] = {
            "shard": shard_id, "name": safe,
            "dtype": str(arr.dtype), "shape": list(arr.shape),
        }
        shard[safe] = arr
        shard_bytes += arr.nbytes
        if shard_bytes >= max_shard_bytes:
            flush()
    flush()
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    return path


def restore_checkpoint(ckpt_dir: str, target: Any,
                       step: Optional[int] = None) -> Any:
    """Restore into the structure of ``target`` (shape checked, cast to
    each target leaf's dtype): numpy leaves in ``target``'s structure.
    Target leaves may be arrays or tensors, meta tensors included.
    Raises ``KeyError`` for a leaf the checkpoint lacks and ``ValueError``
    for a shape that differs."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    shards = [np.load(os.path.join(path, fn), allow_pickle=False)
              for fn in manifest["shards"]]
    restored = {key: shards[spec["shard"]][spec["name"]]
                for key, spec in manifest["leaves"].items()}

    def restore(key, tgt):
        if key not in restored:
            raise KeyError(f"checkpoint missing leaf {key}")
        arr = restored[key]
        shape = tuple(tgt.shape) if isinstance(tgt, torch.Tensor) \
            else np.shape(tgt)
        if tuple(arr.shape) != shape:
            raise ValueError(f"shape mismatch for {key}: "
                             f"{arr.shape} vs {shape}")
        return arr.astype(_np_dtype(tgt))
    return _map_with_paths(restore, target)


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for name in os.listdir(ckpt_dir):
        m = re.fullmatch(r"step_(\d+)", name)
        if m and os.path.exists(os.path.join(ckpt_dir, name, "manifest.json")):
            steps.append(int(m.group(1)))
    return max(steps) if steps else None
