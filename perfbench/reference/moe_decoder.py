"""Plain PyTorch reference of a GQA decoder with top-k MoE layers served
under 2T-Drop (DualSparse-MoE, P = 2) or keep-all (policy ``none``),
written from the layer equations:

* pre-norm blocks: RMSNorm (float32, weight after the scale), GQA
  attention with rotate-half RoPE (inverse frequencies and angles in
  float32), a top-k softmax router whose k scores are renormalised to sum
  to 1 (the combine weights and the 2T scores), SwiGLU experts, residual
  adds; final RMSNorm and an untied head;
* 2T preparation: each expert's neurons ranked by the summed |Swish(x W1)|
  over the calibration tokens routed to it (stable order), the top half
  the MAJOR sub-expert; thresholds T_major / T_minor the calibration
  scores of every layer, sorted, at floor(q * n) for q = target -/+ 0.05;
* 2T drop: a pair runs the whole expert when its score > T_minor, the
  MAJOR half when > T_major, nothing otherwise;
* keep-all (``none``): no preparation, no partition; every top-k pair
  runs its whole expert;
* the bf16 KV cache: a query that reads the cache sees K and V rounded to
  bf16, its softmax rounded to bf16 before p @ V, and that product
  rounded to bf16. Which positions read the cache is the engine's:
  ``n_float`` leading positions attend in float32 (a whole-prompt
  prefill), the rest through the cache (decode, chunked prefill).

It imports nothing of the program and takes nothing it made: the weights
and calibration inputs come from the benchmark's seeded maker. Every
matrix product goes through ``mm``. ``precision`` steps the arithmetic
down for the control: "tf32" rounds both operands of every float32
product to TF32 (10-bit mantissa, nearest, ties away, as the tensor cores
convert); "lower" does that and also stores the KV cache in fp8 (e4m3),
one step below each precision the configurations state. Work is done
layer by layer over all sequences, so only one layer's weights are
resident.
"""
from __future__ import annotations

import sys
from typing import Dict, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..harness import spec
from ..harness import weights as W

NEG_INF = -1e30
Q_BLOCK = 256
PRECISIONS = ("float32", "tf32", "lower")
# what this reference computes (``harness.spec.uncovered``): the program's
# architecture keys and their values, and the serving policies
COVERS = {"family": ("moe",), "attn_kind": ("gqa",), "qkv_bias": (False,),
          "n_shared_experts": (0,), "mlp_kind": ("swiglu",),
          "frontend": ("",), "tie_embeddings": (False,),
          "router_norm_topk": (True,)}
POLICIES = ("2t", "none")


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32: the low 13 mantissa bits cleared after
    adding half of their weight (round to nearest, ties away)."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0x1000) & -0x2000
    return bits.view(torch.float32)


class Reference:
    """The reference for one configuration (``dims``: the harness's
    sizes), seed and precision ("float32" or "tf32")."""

    def __init__(self, dims: Dict, serving: Dict, seed: int, device,
                 precision: str = "float32"):
        if precision not in PRECISIONS:
            raise ValueError(f"unknown precision {precision!r}")
        missing = spec.uncovered(sys.modules[__name__], dims, serving)
        if missing:
            raise ValueError("; ".join(missing))
        self.dims = dims
        self.serving = serving
        self.seed = seed
        self.device = torch.device(device)
        self.tf32 = precision in ("tf32", "lower")
        self.cache_dtype = torch.float8_e4m3fn if precision == "lower" \
            else torch.bfloat16

    # -- arithmetic ------------------------------------------------------

    def mm(self, a, b):
        if self.tf32:
            a, b = to_tf32(a), to_tf32(b)
        return torch.matmul(a, b)

    def rms(self, x, w):
        var = torch.mean(torch.square(x), dim=-1, keepdim=True)
        return x * torch.rsqrt(var + self.dims["norm_eps"]) * w

    def rope(self, x, pos):
        """x (L, H, D), pos (L,) int64."""
        d = x.shape[-1]
        inv = 1.0 / (self.dims["rope_theta"] ** (
            np.arange(0, d, 2, dtype=np.float32) / d))
        ang = pos[:, None].float() * torch.as_tensor(inv, device=x.device)
        cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
        x1, x2 = x[..., :d // 2], x[..., d // 2:]
        return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)

    def route(self, x, wg):
        """(probs sorted descending (N, E), their expert ids, top-k scores
        renormalised (N, K))."""
        probs = torch.softmax(self.mm(x, wg), dim=-1)
        vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
        k = self.dims["top_k"]
        top = vals[:, :k]
        norm = top / torch.clamp(top.sum(-1, keepdim=True), min=1e-20)
        return vals, idx, norm

    # -- 2T preparation ----------------------------------------------------

    def calibration(self):
        return W.calibration(self.dims, self.serving["calibration_tokens"],
                             self.seed, self.device)

    def thresholds(self, calib) -> Tuple[torch.Tensor, torch.Tensor]:
        scores = []
        for i in range(self.dims["n_layers"]):
            wg = W.layer_weights(self.dims, i, self.seed, self.device,
                                 only=("wg",))["wg"]
            scores.append(self.route(calib, wg)[2])
        flat = torch.sort(torch.stack(scores).reshape(-1)).values
        n = flat.numel()
        target, delta = self.serving["drop_target"], self.serving["delta"]

        def at(q):
            i = int(np.floor(np.float32(q) * np.float32(n)))
            return flat[min(max(i, 0), n - 1)]
        return at(max(target - delta, 0.0)), at(min(target + delta, 1.0))

    def major_neurons(self, calib, lw) -> torch.Tensor:
        """(E, f/2) ids of each expert's MAJOR neurons."""
        e, f = self.dims["n_experts"], self.dims["d_expert"]
        _, idx, _ = self.route(calib, lw["wg"])
        sel = torch.zeros((calib.shape[0], e), device=calib.device)
        sel.scatter_add_(1, idx[:, :self.dims["top_k"]],
                         torch.ones_like(idx[:, :self.dims["top_k"]],
                                         dtype=sel.dtype))
        g = torch.abs(F.silu(self.mm(calib[None], lw["w1"])))   # (E,T,f)
        imp = (g * sel.T[:, :, None]).sum(dim=1)
        order = torch.argsort(-imp, dim=-1, stable=True)
        return order[:, :f // 2]

    # -- layers ----------------------------------------------------------

    def attention(self, x, lw, n_float: int):
        """One sequence's attention block output, x (L, d)."""
        dm = self.dims
        L, D = x.shape[0], dm["head_dim"]
        hkv, g = dm["n_kv_heads"], dm["n_heads"] // dm["n_kv_heads"]
        pos = torch.arange(L, device=x.device)
        q = self.mm(x, lw["wq"].reshape(dm["d_model"], -1))
        k = self.mm(x, lw["wk"].reshape(dm["d_model"], -1))
        v = self.mm(x, lw["wv"].reshape(dm["d_model"], -1))
        q = self.rope(q.reshape(L, hkv * g, D), pos).reshape(L, hkv, g, D)
        k = self.rope(k.reshape(L, hkv, D), pos)
        v = v.reshape(L, hkv, D)
        kc = k.to(self.cache_dtype).float()
        vc = v.to(self.cache_dtype).float()
        out = torch.empty((L, hkv, g, D), device=x.device)
        bounds = sorted({0, L, min(n_float, L)} | set(range(0, L, Q_BLOCK)))
        for a, b in zip(bounds[:-1], bounds[1:]):
            cache = a >= n_float
            kk, vv = (kc, vc) if cache else (k, v)
            qb = q[a:b].permute(1, 2, 0, 3).reshape(hkv, g * (b - a), D)
            s = self.mm(qb, kk[:b].permute(1, 2, 0)) / np.sqrt(D)
            qpos = torch.arange(a, b, device=x.device).repeat(g)
            mask = torch.arange(b, device=x.device)[None, :] <= qpos[:, None]
            s = torch.where(mask[None], s, torch.tensor(NEG_INF,
                                                        device=x.device))
            p = torch.softmax(s, dim=-1)
            if cache:
                p = p.to(torch.bfloat16).float()
            o = self.mm(p, vv[:b].permute(1, 0, 2))       # (hkv, g*n, D)
            if cache:
                o = o.to(torch.bfloat16).float()
            out[a:b] = o.reshape(hkv, g, b - a, D).permute(2, 0, 1, 3)
        return self.mm(out.reshape(L, -1), lw["wo"].reshape(-1, dm["d_model"]))

    def moe(self, x, lw, major, tm, tn):
        """(y (N, d), margins (N, 2)) for tokens x (N, d): how near each
        token's routing came to another outcome — the least distance of a
        kept score to a threshold (+inf under keep-all: ``major`` None),
        and the gap between the k-th and (k+1)-th router probabilities
        relative to the k-th."""
        k = self.dims["top_k"]
        vals, idx, norm = self.route(x, lw["wg"])
        top = idx[:, :k]
        topk_margin = (vals[:, k - 1] - vals[:, k]) / vals[:, k - 1]
        if major is None:
            margins = torch.stack([torch.full_like(topk_margin, np.inf),
                                   topk_margin], dim=-1)
            modes = [(torch.ones_like(top, dtype=torch.bool), None)]
        else:
            margins = torch.stack([
                torch.minimum((norm - tm).abs(), (norm - tn).abs()).amin(-1),
                topk_margin], dim=-1)
            full = norm > tn
            modes = [(full, None), ((norm > tm) & ~full, major)]
        y = torch.zeros_like(x)
        for e in range(self.dims["n_experts"]):
            for mode, cols in modes:
                rows, slots = torch.nonzero((top == e) & mode, as_tuple=True)
                if rows.numel() == 0:
                    continue
                w1, w3, w2 = lw["w1"][e], lw["w3"][e], lw["w2"][e]
                if cols is not None:
                    w1, w3, w2 = w1[:, cols[e]], w3[:, cols[e]], w2[cols[e]]
                xr = x[rows]
                h = F.silu(self.mm(xr, w1)) * self.mm(xr, w3)
                y.index_add_(0, rows, self.mm(h, w2) * norm[rows, slots, None])
        return y, margins

    # -- the whole model ---------------------------------------------------

    def run(self, seqs: Sequence[np.ndarray], n_float: Sequence[int],
            score_pos: Sequence[Sequence[int]]):
        """Teacher-forced pass over ``seqs`` (token ids). Returns the final
        normed hidden states at ``score_pos`` of every sequence,
        concatenated (n, d), and each of those positions' routing margins
        (n, 2), the least over the layers (see ``moe``)."""
        dm, dev = self.dims, self.device
        two_t = self.serving["policy"] == "2t"
        calib = self.calibration() if two_t else None
        tm, tn = self.thresholds(calib) if two_t else (None, None)
        emb = W.make_leaf("embed", (dm["vocab_size"], dm["d_model"]),
                          "matrix", self.seed, dev)
        toks = [torch.as_tensor(np.asarray(s, np.int64), device=dev)
                for s in seqs]
        hs = [emb[t] for t in toks]
        del emb
        lens = [len(s) for s in seqs]
        margins = torch.full((sum(lens), 2), float("inf"), device=dev)
        for i in range(dm["n_layers"]):
            lw = W.layer_weights(dm, i, self.seed, dev)
            major = self.major_neurons(calib, lw) if two_t else None
            hs = [h + self.attention(self.rms(h, lw["ln1"]), lw, nf)
                  for h, nf in zip(hs, n_float)]
            h = torch.cat(hs)
            y, m = self.moe(self.rms(h, lw["ln2"]), lw, major, tm, tn)
            margins = torch.minimum(margins, m)
            hs = list(torch.split(h + y, lens))
            del lw, major, h, y
        fn = W.make_leaf("final_norm", (dm["d_model"],), "norm", self.seed,
                         dev)
        out, flags, start = [], [], 0
        for h, sp, n in zip(hs, score_pos, lens):
            sp = torch.as_tensor(list(sp), dtype=torch.long, device=dev)
            out.append(self.rms(h[sp], fn))
            flags.append(margins[start:start + n][sp])
            start += n
        return torch.cat(out), torch.cat(flags)

    def head(self):
        return W.make_leaf("lm_head", (self.dims["d_model"],
                                       self.dims["vocab_size"]), "matrix",
                           self.seed, self.device)

    def logits(self, hidden, head):
        return self.mm(hidden, head)
