"""Plain PyTorch reference of a DeepSeek-V2 decoder served under 2T-Drop
(DualSparse-MoE, P = 2) or keep-all (policy ``none``), written from the
published equations (DeepSeek-V2, arXiv:2405.04434, §2.1 and its YaRN
rotary embedding):

* pre-norm blocks: RMSNorm (float32, weight after the scale), residual
  adds; final RMSNorm and an untied head;
* MLA without a query LoRA, not absorbed: q = x Wq split into a no-rope
  and a rope part per head; the latent c = RMSNorm((x Wkv_a)[:r_kv]) and
  one rope key k_r = (x Wkv_a)[r_kv:] shared by every head; each head's
  key [c Wk_b, k_r] and value c Wv_b decompressed from the latent; causal
  softmax of q k^T at (nope + rope)^-0.5 mscale(factor, mscale_all_dim)^2;
  the heads' outputs through Wo;
* YaRN on the rope parts (rotate-half, angles in float32): inverse
  frequencies theta^(-2i/D) below the correction range, those over the
  factor above it, a linear ramp between (floor / ceil of D ln(L0 / (2 pi
  beta)) / (2 ln theta) at beta_fast / beta_slow, clamped to [0, D - 1]);
  cos and sin times mscale(factor, mscale) / mscale(factor,
  mscale_all_dim), mscale(s, m) = 0.1 m ln s + 1;
* the first ``first_k_dense`` layers a dense SwiGLU of ``d_ff``; the
  others a softmax router over ``n_experts`` whose top-k probabilities,
  not renormalised, weight the routed SwiGLU experts, plus
  ``n_shared_experts`` experts of ``d_expert`` (one SwiGLU of their summed
  width) that every token runs, never dropped;
* 2T-Drop on the top-k scores normalised over the selected k (the
  paper's §4.1; ``moe_decoder``'s preparation, thresholds and drop, over
  the MoE layers only): a pair runs the whole expert when its score >
  T_minor, the MAJOR half when > T_major, nothing otherwise; keep-all:
  every top-k pair runs its whole expert;
* the bf16 latent cache: a query that reads the cache sees c and k_r
  rounded to bf16 and its softmax rounded to bf16 before it weights the
  values. Which positions read the cache is the engine's (``n_float``
  leading positions attend in float32, as in ``moe_decoder``).

It imports nothing of the program and takes nothing it made. Every
matrix product goes through ``mm`` (TF32 off; ``precision`` steps it down
for the control as ``moe_decoder`` does, "lower" with an fp8 latent
cache as well). Work is done layer by layer over all sequences.
"""
from __future__ import annotations

import math
import sys
from typing import Dict, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..harness import spec
from ..harness import weights as W
from . import moe_decoder

NEG_INF = moe_decoder.NEG_INF
Q_BLOCK = moe_decoder.Q_BLOCK
# the YaRN keys of ``dims``, as the program's config names them
YARN_KEYS = ("rope_scaling_factor", "rope_original_max_pos",
             "rope_beta_fast", "rope_beta_slow", "rope_mscale",
             "rope_mscale_all_dim")
# what this reference computes (``harness.spec.uncovered``); the YaRN
# coefficients are those DeepSeek-V2-Lite publishes (its original length
# is read from ``dims``)
COVERS = {"family": ("moe",), "attn_kind": ("mla",), "q_lora_rank": (0,),
          "n_shared_experts": (2,), "first_k_dense": (1,),
          "leading_dense_layers": (1,),
          "router_norm_topk": (False,), "mlp_kind": ("swiglu",),
          "frontend": ("",), "tie_embeddings": (False,),
          "qkv_bias": (False,), "rope_scaling_factor": (40.0,),
          "rope_beta_fast": (32.0,), "rope_beta_slow": (1.0,),
          "rope_mscale": (0.707,), "rope_mscale_all_dim": (0.707,)}
POLICIES = ("2t", "none")


def _yarn_mscale(scale: float, m: float) -> float:
    return 1.0 if scale <= 1 else 0.1 * m * math.log(scale) + 1.0


def yarn_inv_freq(dims: Dict, d: int) -> np.ndarray:
    """(d/2,) float32 YaRN inverse frequencies of a rope part of width d."""
    theta, s = dims["rope_theta"], dims["rope_scaling_factor"]
    l0 = dims["rope_original_max_pos"]
    expo = np.arange(0, d, 2, dtype=np.float32) / d
    extra = 1.0 / (theta ** expo)
    inter = np.float32(1.0) / (np.float32(s) * theta ** expo)

    def dim_of(rot):
        return d * math.log(l0 / (rot * 2 * math.pi)) / (2 * math.log(theta))
    low = max(math.floor(dim_of(dims["rope_beta_fast"])), 0)
    high = min(math.ceil(dim_of(dims["rope_beta_slow"])), d - 1)
    if low == high:
        high += 0.001
    ramp = np.clip((np.arange(d // 2, dtype=np.float32) - low)
                   / np.float32(high - low), 0, 1).astype(np.float32)
    return (inter * ramp + extra * (np.float32(1) - ramp)).astype(np.float32)


def softmax_scale(dims: Dict) -> float:
    """(nope + rope)^-0.5 times mscale(factor, mscale_all_dim)^2."""
    m = _yarn_mscale(dims["rope_scaling_factor"], dims["rope_mscale_all_dim"])
    return m * m / math.sqrt(dims["qk_nope_head_dim"]
                             + dims["qk_rope_head_dim"])


class Reference(moe_decoder.Reference):
    """The reference for one configuration (``dims``: the harness's sizes
    and layer kinds, YaRN's values), seed and precision."""

    def __init__(self, dims: Dict, serving: Dict, seed: int, device,
                 precision: str = "float32"):
        if precision not in moe_decoder.PRECISIONS:
            raise ValueError(f"unknown precision {precision!r}")
        mod = sys.modules[__name__]
        missing = spec.uncovered(mod, dims, serving)
        missing += [f"{k} is {dims.get(k)!r} in dims, {__name__} covers "
                    f"{list(COVERS[k])}" for k in YARN_KEYS
                    if k in COVERS and dims.get(k) not in COVERS[k]]
        if missing:
            raise ValueError("; ".join(missing))
        # float32 products in float32 (the control rounds its own operands)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.dims = dims
        self.serving = serving
        self.seed = seed
        self.device = torch.device(device)
        self.tf32 = precision in ("tf32", "lower")
        self.cache_dtype = torch.float8_e4m3fn if precision == "lower" \
            else torch.bfloat16
        self.n_dense = dims["first_k_dense"]

    # -- arithmetic ------------------------------------------------------

    def rope(self, x, pos):
        """YaRN on x (L, H, D), pos (L,) int64."""
        d = x.shape[-1]
        inv = torch.as_tensor(yarn_inv_freq(self.dims, d), device=x.device)
        ang = pos[:, None].float() * inv
        m = _yarn_mscale(self.dims["rope_scaling_factor"],
                         self.dims["rope_mscale"]) / _yarn_mscale(
            self.dims["rope_scaling_factor"], self.dims["rope_mscale_all_dim"])
        cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
        if m != 1.0:
            cos, sin = cos * m, sin * m
        x1, x2 = x[..., :d // 2], x[..., d // 2:]
        return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)

    def moe_layers(self):
        return range(self.n_dense, self.dims["n_layers"])

    def thresholds(self, calib):
        """``moe_decoder``'s thresholds over the MoE layers' routers."""
        scores = []
        for i in self.moe_layers():
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

    # -- layers ----------------------------------------------------------

    def attention(self, x, lw, n_float: int):
        """One sequence's MLA output, x (L, d), un-absorbed."""
        dm = self.dims
        L, d, H = x.shape[0], dm["d_model"], dm["n_heads"]
        rkv, dn, dr, dv = (dm[k] for k in ("kv_lora_rank", "qk_nope_head_dim",
                                           "qk_rope_head_dim", "v_head_dim"))
        pos = torch.arange(L, device=x.device)
        q = self.mm(x, lw["wq"].reshape(d, -1)).reshape(L, H, dn + dr)
        q_nope, q_rope = q[..., :dn], self.rope(q[..., dn:], pos)
        kv_a = self.mm(x, lw["wkv_a"])
        c = self.rms(kv_a[:, :rkv], lw["kv_norm"])
        kr = self.rope(kv_a[:, None, rkv:], pos)[:, 0]
        cached = (c.to(self.cache_dtype).float(),
                  kr.to(self.cache_dtype).float())
        scale = softmax_scale(dm)
        out = torch.empty((L, H, dv), device=x.device)
        kv = {}
        bounds = sorted({0, L, min(n_float, L)} | set(range(0, L, Q_BLOCK)))
        for a, b in zip(bounds[:-1], bounds[1:]):
            cache = a >= n_float
            if cache not in kv:
                cc, kk = cached if cache else (c, kr)
                kv[cache] = (
                    self.mm(cc, lw["wk_b"].reshape(rkv, -1)).reshape(L, H, dn),
                    kk, self.mm(cc, lw["wv_b"].reshape(rkv, -1)
                                ).reshape(L, H, dv))
            k_nope, k_rope, v = kv[cache]
            s = (self.mm(q_nope[a:b].permute(1, 0, 2),
                         k_nope[:b].permute(1, 2, 0))
                 + self.mm(q_rope[a:b].permute(1, 0, 2),
                           k_rope[:b].T[None])) * scale       # (H, n, b)
            mask = torch.arange(b, device=x.device)[None, :] <= \
                torch.arange(a, b, device=x.device)[:, None]
            s = torch.where(mask[None], s, torch.tensor(NEG_INF,
                                                        device=x.device))
            p = torch.softmax(s, dim=-1)
            if cache:
                p = p.to(torch.bfloat16).float()
            out[a:b] = self.mm(p, v[:b].permute(1, 0, 2)).permute(1, 0, 2)
        return self.mm(out.reshape(L, -1), lw["wo"].reshape(-1, d))

    def swiglu(self, x, w1, w3, w2):
        return self.mm(F.silu(self.mm(x, w1)) * self.mm(x, w3), w2)

    def moe(self, x, lw, major, tm, tn):
        """(y (N, d), margins (N, 2)) for tokens x (N, d): the routed
        experts weighted by their router probabilities (not renormalised;
        the 2T decision on the normalised scores), the shared experts on
        every token; margins as in ``moe_decoder``."""
        k = self.dims["top_k"]
        vals, idx, norm = self.route(x, lw["wg"])
        top, combine = idx[:, :k], vals[:, :k]
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
        y = self.swiglu(x, lw["shared_w1"], lw["shared_w3"], lw["shared_w2"])
        for e in range(self.dims["n_experts"]):
            for mode, cols in modes:
                rows, slots = torch.nonzero((top == e) & mode, as_tuple=True)
                if rows.numel() == 0:
                    continue
                w1, w3, w2 = lw["w1"][e], lw["w3"][e], lw["w2"][e]
                if cols is not None:
                    w1, w3, w2 = w1[:, cols[e]], w3[:, cols[e]], w2[cols[e]]
                y.index_add_(0, rows, self.swiglu(x[rows], w1, w3, w2)
                             * combine[rows, slots, None])
        return y, margins

    # -- the whole model ---------------------------------------------------

    def run(self, seqs: Sequence[np.ndarray], n_float: Sequence[int],
            score_pos: Sequence[Sequence[int]]):
        """As ``moe_decoder.Reference.run``: the final normed hidden states
        at ``score_pos`` (n, d) and their routing margins (n, 2), the least
        over the MoE layers."""
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
            hs = [h + self.attention(self.rms(h, lw["ln1"]), lw, nf)
                  for h, nf in zip(hs, n_float)]
            h = torch.cat(hs)
            hn = self.rms(h, lw["ln2"])
            if i < self.n_dense:
                y = self.swiglu(hn, lw["mlp_w1"], lw["mlp_w3"], lw["mlp_w2"])
            else:
                major = self.major_neurons(calib, lw) if two_t else None
                y, m = self.moe(hn, lw, major, tm, tn)
                margins = torch.minimum(margins, m)
                del major
            hs = list(torch.split(h + y, lens))
            del lw, h, hn, y
        fn = W.make_leaf("final_norm", (dm["d_model"],), "norm", self.seed,
                         dev)
        out, flags, start = [], [], 0
        for h, sp, n in zip(hs, score_pos, lens):
            sp = torch.as_tensor(list(sp), dtype=torch.long, device=dev)
            out.append(self.rms(h[sp], fn))
            flags.append(margins[start:start + n][sp])
            start += n
        return torch.cat(out), torch.cat(flags)
