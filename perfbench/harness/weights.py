"""Weights and calibration activations made by the benchmark from
``--seed``, on the device, and handed alike to the program (copied into
its parameters) and to the plain reference (made again, layer by layer).

Every leaf has a seed of its own, derived from the run's seed and the
leaf's name, so one leaf can be made again without the others. The
values are float32: matrices ``0.02 * N(0, 1)``, norm weights
``1 + 0.1 * N(0, 1)`` (not ones, so that a norm whose weight is dropped
shows in the comparison).
"""
from __future__ import annotations

import hashlib
from typing import Dict, List, Tuple

import torch

MATRIX_SCALE = 0.02
NORM_SPREAD = 0.1

Leaf = Tuple[str, Tuple[int, ...], str]     # (name, shape, kind)


def leaf_seed(seed: int, name: str) -> int:
    """A 63-bit generator seed for one leaf of one run."""
    digest = hashlib.blake2b(f"{int(seed)}:{name}".encode(),
                             digest_size=8).digest()
    return int.from_bytes(digest, "little") & (2 ** 63 - 1)


def layer_leaves(dims: Dict, i: int) -> List[Leaf]:
    """One decoder layer's leaves, in the program's layouts: attention
    wq (d, Hkv, G, D), wk / wv (d, Hkv, D), wo (Hkv, G, D, d); router
    wg (d, E); experts w1 / w3 (E, d, f), w2 (E, f, d)."""
    d, D = dims["d_model"], dims["head_dim"]
    hq, hkv = dims["n_heads"], dims["n_kv_heads"]
    g = hq // hkv
    e, f = dims["n_experts"], dims["d_expert"]
    p = f"layers.{i}."
    return [(p + "ln1", (d,), "norm"),
            (p + "wq", (d, hkv, g, D), "matrix"),
            (p + "wk", (d, hkv, D), "matrix"),
            (p + "wv", (d, hkv, D), "matrix"),
            (p + "wo", (hkv, g, D, d), "matrix"),
            (p + "ln2", (d,), "norm"),
            (p + "wg", (d, e), "matrix"),
            (p + "w1", (e, d, f), "matrix"),
            (p + "w3", (e, d, f), "matrix"),
            (p + "w2", (e, f, d), "matrix")]


def leaves(dims: Dict) -> List[Leaf]:
    """Every leaf of the model: embedding (V, d), head (d, V), final norm
    and the layers."""
    d, v = dims["d_model"], dims["vocab_size"]
    out = [("embed", (v, d), "matrix"), ("lm_head", (d, v), "matrix"),
           ("final_norm", (d,), "norm")]
    for i in range(dims["n_layers"]):
        out += layer_leaves(dims, i)
    return out


def make_leaf(name: str, shape, kind: str, seed: int,
              device) -> torch.Tensor:
    """The leaf's float32 values, drawn on ``device`` in one call
    (``kind``: "matrix", "norm" or "unit", the last N(0, 1) as drawn)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(leaf_seed(seed, name))
    t = torch.randn(tuple(shape), generator=gen, device=device,
                    dtype=torch.float32)
    if kind == "norm":
        return t.mul_(NORM_SPREAD).add_(1.0)
    if kind == "unit":
        return t
    return t.mul_(MATRIX_SCALE)


def layer_weights(dims: Dict, i: int, seed: int, device,
                  only=None) -> Dict[str, torch.Tensor]:
    """Layer ``i``'s leaves by short name (``wq``, ``w1``, ...);
    ``only`` restricts them to a few names."""
    out = {}
    for name, shape, kind in layer_leaves(dims, i):
        short = name.rsplit(".", 1)[-1]
        if only is None or short in only:
            out[short] = make_leaf(name, shape, kind, seed, device)
    return out


def calibration(dims: Dict, n_tokens: int, seed: int,
                device) -> torch.Tensor:
    """(n_tokens, d) float32 activations, N(0, 1), on which the 2T
    preparation profiles neuron importance and calibrates thresholds."""
    return make_leaf("calibration", (n_tokens, dims["d_model"]), "unit",
                     seed, device)
