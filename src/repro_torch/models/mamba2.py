"""Mamba2 / SSD (state-space duality) layer [arXiv:2405.21060].

Prefill runs SSD in its chunked matmul form: the intra-chunk quadratic
terms go through ``kernels.ops.ssd_chunk`` (the CUDA kernel on the card,
its plain version on the CPU), and the inter-chunk state recurrence is a
loop over the chunks (the JAX package uses a log-depth
``associative_scan``; the rounding differs in the last bits). Decode is
the O(1) state update in plain torch. Layouts follow the JAX package:
x (b, S, H, P), dt (b, S, H), B/C (b, S, G, N), state (b, H, P, N).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels import ops
from ..kernels.ref import chunk_cumsum
from . import layers


def _uniform(shape, lo: float, hi: float, *,
             generator: Optional[torch.Generator], device) -> torch.Tensor:
    """U(lo, hi) of ``shape`` from ``generator`` (float32); undrawn when
    ``generator`` is None (weights loaded later)."""
    if generator is None:
        return torch.empty(shape, dtype=torch.float32, device=device)
    u = torch.rand(shape, generator=generator, device=device,
                   dtype=torch.float32)
    return u * (hi - lo) + lo


class Mamba2(nn.Module):
    """The layer's weights, with the JAX leaf names and distributions:
    in_proj (d, 2·di + 2·G·N + H) and out_proj (di, d) ``0.02·N(0, 1)``,
    conv_w (W, di + 2·G·N) ``0.1·N(0, 1)``, conv_b zeros, dt_bias the
    inverse softplus of a log-uniform dt in [1e-3, 1e-1], A_log
    ``log U(1, 16)``, D and norm ones."""

    def __init__(self, cfg, *, device: torch.device,
                 generator: Optional[torch.Generator]):
        super().__init__()
        d, di = cfg.d_model, cfg.d_inner
        G, N, H = cfg.ssm_n_groups, cfg.ssm_state, cfg.ssm_heads
        conv_ch = di + 2 * G * N
        kw = dict(device=device, generator=generator)
        self.in_proj = layers.normal((d, 2 * di + 2 * G * N + H), **kw)
        self.conv_w = layers.normal((cfg.ssm_conv_width, conv_ch), scale=0.1,
                                    **kw)
        self.conv_b = layers.zeros((conv_ch,), device=device)
        log_dt = _uniform((H,), math.log(1e-3), math.log(0.1), **kw)
        self.dt_bias = nn.Parameter(torch.log(torch.expm1(torch.exp(log_dt))),
                                    requires_grad=False)
        self.A_log = nn.Parameter(torch.log(_uniform((H,), 1.0, 16.0, **kw)),
                                  requires_grad=False)
        self.D = layers.ones((H,), device=device)
        self.norm = layers.ones((di,), device=device)
        self.out_proj = layers.normal((di, d), **kw)


def _split_in_proj(cfg, zxbcdt):
    di, G, N, H = cfg.d_inner, cfg.ssm_n_groups, cfg.ssm_state, cfg.ssm_heads
    return torch.split(zxbcdt, [di, di + 2 * G * N, H], dim=-1)


def _split_xbc(cfg, xbc):
    di, G, N = cfg.d_inner, cfg.ssm_n_groups, cfg.ssm_state
    return torch.split(xbc, [di, G * N, G * N], dim=-1)


# ---------------------------------------------------------------------------
# Chunked SSD core
# ---------------------------------------------------------------------------

def _segsum(x):
    """x: (..., Q) -> (..., Q, Q) with out[i,j] = sum_{j<k<=i} x[k], -inf
    above the diagonal."""
    Q = x.shape[-1]
    cs = chunk_cumsum(x)
    out = cs[..., :, None] - cs[..., None, :]
    mask = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    return torch.where(mask, out, torch.tensor(-math.inf, device=x.device))


def _pad_seq(chunk: int, x, dt, B, C):
    """Zero-pad the sequence axis (1) of every input to a whole chunk."""
    pad = (-x.shape[1]) % chunk
    if not pad:
        return x, dt, B, C

    def p(t):
        return F.pad(t, (0, 0) * (t.ndim - 2) + (0, pad))
    return p(x), p(dt), p(B), p(C)


def _chunk_recurrence(chunk_decay, states):
    """h_c = decay_c · h_{c-1} + states_c over the chunk axis 1, from 0.
    chunk_decay (n, nc, ...), states (n, nc, ..., X, Y). Returns the state
    entering each chunk (n, nc, ..., X, Y) and the final state."""
    h = torch.zeros_like(states[:, 0])
    h_prev = []
    for c in range(states.shape[1]):
        h_prev.append(h)
        h = h * chunk_decay[:, c, ..., None, None] + states[:, c]
    return torch.stack(h_prev, dim=1), h


def ssd_chunked(x, dt, A, B, C, chunk: int = 256):
    """SSD in chunked (matmul) form, plainly.

    x: (b, S, H, P); dt: (b, S, H) (already softplus'd, > 0); A: (H,)
    (< 0); B, C: (b, S, G, N) with H divisible by G. Returns y (b, S, H, P)
    and the final state (b, H, P, N)."""
    b, S, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    x, dt, B, C = _pad_seq(chunk, x, dt, B, C)
    nc = x.shape[1] // chunk
    rep = H // G

    xc = x.reshape(b, nc, chunk, H, P)
    dtc = dt.reshape(b, nc, chunk, H)
    Bh = B.reshape(b, nc, chunk, G, N).repeat_interleave(rep, dim=3)
    Ch = C.reshape(b, nc, chunk, G, N).repeat_interleave(rep, dim=3)

    dA = dtc * A                                           # (b,nc,Q,H)
    dA_cum = chunk_cumsum(dA.movedim(2, -1)).movedim(-1, 2)

    # 1) intra-chunk (quadratic within the chunk, matmul form)
    L = torch.exp(_segsum(dA.movedim(-1, -2)))             # (b,nc,H,Q,Q)
    scores = torch.einsum("bcqhn,bckhn->bchqk", Ch, Bh)
    y_intra = torch.einsum("bchqk,bckh,bckhp->bcqhp", scores * L, dtc, xc)

    # 2) each chunk's contribution to the running state
    decay_to_end = torch.exp(dA_cum[:, :, -1:, :] - dA_cum)
    states = torch.einsum("bcqhn,bcqh,bcqh,bcqhp->bchpn",
                          Bh, dtc, decay_to_end, xc)       # (b,nc,H,P,N)

    # 3) inter-chunk recurrence, 4) inter-chunk output
    h_prev, h_final = _chunk_recurrence(torch.exp(dA_cum[:, :, -1, :]),
                                        states)
    y_inter = torch.einsum("bcqhn,bcqh,bchpn->bcqhp", Ch, torch.exp(dA_cum),
                           h_prev)
    y = (y_intra + y_inter).reshape(b, nc * chunk, H, P)[:, :S]
    return y, h_final


def ssd_chunked_kernel(x, dt, A, B, C, chunk: int = 128):
    """``ssd_chunked`` with the intra-chunk terms through
    ``kernels.ops.ssd_chunk``; the recurrence and the inter-chunk term in
    torch. Same signature and semantics as ``ssd_chunked``. B and C go to
    the kernel once per group of heads, not repeated per head."""
    b, S, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    x, dt, B, C = _pad_seq(chunk, x, dt, B, C)
    nc = x.shape[1] // chunk
    rep = H // G
    # (b, S, H, *) -> (b*H, nc, Q, *), bh = batch * H + head; B/C (b, S, G,
    # N) -> (b*G, nc, Q, N), bg = batch * G + group = bh // rep
    xk = x.transpose(1, 2).reshape(b * H, nc, chunk, P).contiguous()
    dtk = dt.transpose(1, 2).reshape(b * H, nc, chunk).contiguous()
    Bk = B.transpose(1, 2).reshape(b * G, nc, chunk, N).contiguous()
    Ck = C.transpose(1, 2).reshape(b * G, nc, chunk, N).contiguous()
    ak = A.repeat(b).contiguous()

    y_intra, states, chunk_decay = ops.ssd_chunk(xk, dtk, ak, Bk, Ck)

    h_prev, h_final = _chunk_recurrence(chunk_decay, states)  # (BH,nc,N,P)
    in_decay = torch.exp(chunk_cumsum(dtk * ak[:, None, None]))
    # C·h_prev of the group's rep heads in one product per (bg, chunk)
    y_inter = torch.einsum("gcqn,grcnp->grcqp", Ck,
                           h_prev.reshape(b * G, rep, nc, N, P))
    y_inter = y_inter.reshape(b * H, nc, chunk, P) * in_decay[..., None]
    y = (y_intra + y_inter).reshape(b, H, nc * chunk, P).transpose(1, 2)
    return y[:, :S], h_final.transpose(-1, -2).reshape(b, H, P, N)


def ssd_reference(x, dt, A, B, C):
    """Sequential-scan oracle (O(S) steps)."""
    b, S, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    Bh = B.repeat_interleave(H // G, dim=2)
    Ch = C.repeat_interleave(H // G, dim=2)
    h = torch.zeros((b, H, P, N), dtype=x.dtype, device=x.device)
    ys = []
    for t in range(S):
        decay = torch.exp(dt[:, t] * A)[..., None, None]        # (b,H,1,1)
        dBx = torch.einsum("bh,bhn,bhp->bhpn", dt[:, t], Bh[:, t], x[:, t])
        h = h * decay + dBx
        ys.append(torch.einsum("bhn,bhpn->bhp", Ch[:, t], h))
    return torch.stack(ys, dim=1), h


# ---------------------------------------------------------------------------
# Full layer forward (prefill) and decode step
# ---------------------------------------------------------------------------

class MambaState(NamedTuple):
    conv: torch.Tensor    # (B, W-1, conv_ch) last raw inputs
    ssm: torch.Tensor     # (B, H, P, N)


def init_mamba_state(batch: int, cfg, dtype=torch.float32,
                     device="cuda") -> MambaState:
    conv_ch = cfg.d_inner + 2 * cfg.ssm_n_groups * cfg.ssm_state
    kw = dict(dtype=dtype, device=device)
    return MambaState(
        conv=torch.zeros((batch, cfg.ssm_conv_width - 1, conv_ch), **kw),
        ssm=torch.zeros((batch, cfg.ssm_heads, cfg.ssm_head_dim,
                         cfg.ssm_state), **kw))


def _causal_conv(xbc, w, b):
    """Depthwise causal conv, xbc: (B, S, C), w: (W, C)."""
    W, S = w.shape[0], xbc.shape[1]
    pad = F.pad(xbc, (0, 0, W - 1, 0))
    out = sum(pad[:, i:i + S, :] * w[i] for i in range(W))
    return out + b


def ssd_inputs(m: Mamba2, x_in, cfg):
    """The layer's projections of x_in (B, S, d_model): ``(z, xbc_raw,
    (x, dt, A, B, C))`` with the last five the float32 SSD inputs in the
    layout ``ssd_chunked`` takes."""
    B_, S, _ = x_in.shape
    H, P = cfg.ssm_heads, cfg.ssm_head_dim
    G, N = cfg.ssm_n_groups, cfg.ssm_state
    z, xbc_raw, dt = _split_in_proj(cfg, x_in @ m.in_proj)
    xbc = F.silu(_causal_conv(xbc_raw, m.conv_w, m.conv_b))
    x, Bmat, Cmat = _split_xbc(cfg, xbc)
    dt = F.softplus(dt.float() + m.dt_bias)
    A = -torch.exp(m.A_log.float())
    return z, xbc_raw, (x.reshape(B_, S, H, P).float(), dt, A,
                        Bmat.reshape(B_, S, G, N).float(),
                        Cmat.reshape(B_, S, G, N).float())


def mamba2_forward(m: Mamba2, x_in, cfg, chunk: int = 256,
                   return_state: bool = False, kernel: bool = True):
    """x_in: (B, S, d_model) -> (B, S, d_model), the prefill path. With
    ``return_state`` also returns the decode state after the sequence (the
    prefill -> decode handoff). ``kernel=False`` runs the plain
    ``ssd_chunked`` (the differentiable route training takes, as the
    reference's ``mamba2_forward`` always does)."""
    B_, S, _ = x_in.shape
    z, xbc_raw, ssd_args = ssd_inputs(m, x_in, cfg)
    x = ssd_args[0]
    ssd = ssd_chunked_kernel if kernel else ssd_chunked
    y, h_final = ssd(*ssd_args, chunk=chunk)
    y = y + x * m.D[None, None, :, None]
    y = y.reshape(B_, S, cfg.d_inner).to(x_in.dtype)
    y = layers.rms_norm(y * F.silu(z), m.norm, cfg.norm_eps)
    out = y @ m.out_proj
    if not return_state:
        return out
    # conv state: the last W-1 raw xbc inputs, left-padded for short prompts
    W = cfg.ssm_conv_width
    pad = F.pad(xbc_raw, (0, 0, W - 1, 0))
    conv_state = pad[:, pad.shape[1] - (W - 1):, :].float()
    return out, {"conv": conv_state, "ssm": h_final}


def mamba2_decode(m: Mamba2, x_in, state: MambaState, cfg):
    """One-token decode: x_in (B, 1, d) -> (out (B, 1, d), new state)."""
    B_ = x_in.shape[0]
    H, P = cfg.ssm_heads, cfg.ssm_head_dim
    G, N = cfg.ssm_n_groups, cfg.ssm_state
    z, xbc, dt = _split_in_proj(cfg, x_in @ m.in_proj)
    win = torch.cat([state.conv, xbc], dim=1)                  # (B, W, C)
    conv_out = torch.einsum("bwc,wc->bc", win, m.conv_w) + m.conv_b
    xbc_t = F.silu(conv_out)[:, None, :]
    x, Bmat, Cmat = _split_xbc(cfg, xbc_t)
    x = x.reshape(B_, H, P)
    Bmat = Bmat.reshape(B_, G, N).repeat_interleave(H // G, dim=1)
    Cmat = Cmat.reshape(B_, G, N).repeat_interleave(H // G, dim=1)
    dt = F.softplus(dt[:, 0].float() + m.dt_bias)               # (B, H)
    A = -torch.exp(m.A_log.float())
    decay = torch.exp(dt * A)[..., None, None]
    dBx = torch.einsum("bh,bhn,bhp->bhpn", dt, Bmat.float(), x.float())
    h = state.ssm * decay + dBx
    y = torch.einsum("bhn,bhpn->bhp", Cmat.float(), h)
    y = y + x.float() * m.D[None, :, None]
    y = y.reshape(B_, 1, cfg.d_inner).to(x_in.dtype)
    y = layers.rms_norm(y * F.silu(z), m.norm, cfg.norm_eps)
    return y @ m.out_proj, MambaState(win[:, 1:, :], h)
