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


# the ``dims`` keys that set a layer's kind, and their defaults: absent,
# a layer is GQA attention (``head_dim``, ``n_kv_heads``) and routed
# SwiGLU experts whose k scores are renormalised. ``attn_kind`` "mla":
# latent attention, with a query LoRA of rank ``q_lora_rank`` (0: none);
# ``n_shared_experts``: that many experts of ``d_expert`` every token
# runs; the first ``first_k_dense`` layers: a dense SwiGLU of ``d_ff``
# with no router and no experts.
LAYER_KIND = {"attn_kind": "gqa", "q_lora_rank": 0, "kv_lora_rank": 0,
              "qk_nope_head_dim": 0, "qk_rope_head_dim": 0, "v_head_dim": 0,
              "n_shared_experts": 0, "first_k_dense": 0, "d_ff": 0,
              "router_norm_topk": True}


def layer_kind(dims: Dict, key: str):
    """A layer-kind key of ``dims``, or its default (``LAYER_KIND``)."""
    return dims.get(key, LAYER_KIND[key])


def attention_leaves(dims: Dict, p: str) -> List[Leaf]:
    """GQA: wq (d, Hkv, G, D), wk / wv (d, Hkv, D), wo (Hkv, G, D, d).
    MLA: wq_a (d, r_q), q_norm (r_q,), wq_b (r_q, H, nope + rope), or wq
    (d, H, nope + rope) without a query LoRA; wkv_a (d, r_kv + rope),
    kv_norm (r_kv,), wk_b (r_kv, H, nope), wv_b (r_kv, H, v), wo (H, v,
    d)."""
    d, h = dims["d_model"], dims["n_heads"]
    attn = layer_kind(dims, "attn_kind")
    if attn == "gqa":
        D, hkv = dims["head_dim"], dims["n_kv_heads"]
        g = h // hkv
        return [(p + "wq", (d, hkv, g, D), "matrix"),
                (p + "wk", (d, hkv, D), "matrix"),
                (p + "wv", (d, hkv, D), "matrix"),
                (p + "wo", (hkv, g, D, d), "matrix")]
    if attn != "mla":
        raise ValueError(f"attn_kind {attn!r}: the harness makes gqa and "
                         "mla attention")
    rq, rkv, dn, dr, dv = (layer_kind(dims, k) for k in (
        "q_lora_rank", "kv_lora_rank", "qk_nope_head_dim",
        "qk_rope_head_dim", "v_head_dim"))
    q = [(p + "wq_a", (d, rq), "matrix"), (p + "q_norm", (rq,), "norm"),
         (p + "wq_b", (rq, h, dn + dr), "matrix")] if rq else \
        [(p + "wq", (d, h, dn + dr), "matrix")]
    return q + [(p + "wkv_a", (d, rkv + dr), "matrix"),
                (p + "kv_norm", (rkv,), "norm"),
                (p + "wk_b", (rkv, h, dn), "matrix"),
                (p + "wv_b", (rkv, h, dv), "matrix"),
                (p + "wo", (h, dv, d), "matrix")]


def ffn_leaves(dims: Dict, i: int, p: str) -> List[Leaf]:
    """A dense layer (``i < first_k_dense``): mlp_w1 / mlp_w3 (d, d_ff),
    mlp_w2 (d_ff, d). Otherwise router wg (d, E), experts w1 / w3 (E, d,
    f), w2 (E, f, d) and, with shared experts, shared_w1 / shared_w3 (d,
    n_shared f), shared_w2 (n_shared f, d)."""
    d = dims["d_model"]
    if i < layer_kind(dims, "first_k_dense"):
        f = dims["d_ff"]
        return [(p + "mlp_w1", (d, f), "matrix"),
                (p + "mlp_w3", (d, f), "matrix"),
                (p + "mlp_w2", (f, d), "matrix")]
    e, f = dims["n_experts"], dims["d_expert"]
    out = [(p + "wg", (d, e), "matrix"),
           (p + "w1", (e, d, f), "matrix"),
           (p + "w3", (e, d, f), "matrix"),
           (p + "w2", (e, f, d), "matrix")]
    fs = layer_kind(dims, "n_shared_experts") * f
    if fs:
        out += [(p + "shared_w1", (d, fs), "matrix"),
                (p + "shared_w3", (d, fs), "matrix"),
                (p + "shared_w2", (fs, d), "matrix")]
    return out


def layer_leaves(dims: Dict, i: int) -> List[Leaf]:
    """One decoder layer's leaves, in the program's layouts, named
    ``layers.{i}.<leaf>``: ln1, the attention's (``attention_leaves``),
    ln2, the feed-forward's (``ffn_leaves``)."""
    d = dims["d_model"]
    p = f"layers.{i}."
    return [(p + "ln1", (d,), "norm"), *attention_leaves(dims, p),
            (p + "ln2", (d,), "norm"), *ffn_leaves(dims, i, p)]


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
