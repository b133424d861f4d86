"""Mamba2 / SSD (state-space duality) block.

Counterpart of ``repro.models.ssm``: the chunked matmul form of SSD.  The
sequence is split into chunks of Q tokens; intra-chunk terms are dense
(Q, Q) masked products, and one (H, N, P) state passes from chunk to chunk
(a Python loop over the chunks, the reference's ``lax.scan``).  Padded
steps get dt = 0: an identity transition with no injection, so they change
nothing.  Projections stay separate (z / x / B / C / dt); the depthwise
causal convs act per channel.  Decode is O(1): one state update per token.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.layers import P, RMSNorm, normal, param, rmsnorm
from repro_torch.models.sharded import heads_view, merge_heads

_F32 = torch.float32


class SSMCache(NamedTuple):
    conv_x: torch.Tensor   # (B, K-1, Din)
    conv_b: torch.Tensor   # (B, K-1, N)
    conv_c: torch.Tensor   # (B, K-1, N)
    state: torch.Tensor    # (B, H, N, P), float32


class Mamba(nn.Module):
    def __init__(self, cfg, dtype, generator, device):
        super().__init__()
        d, din, nst = cfg.d_model, cfg.ssm_d_inner, cfg.ssm_state
        h, kw = cfg.ssm_heads, cfg.ssm_conv

        def lin(di, do):
            return param(normal((di, do), di ** -0.5, dtype, generator,
                                device))

        def conv(c):
            return param(normal((kw, c), 0.1, dtype, generator, device))

        self.wz, self.wx = lin(d, din), lin(d, din)
        self.wb, self.wc = lin(d, nst), lin(d, nst)
        self.wdt = lin(d, h)
        self.conv_x, self.conv_b, self.conv_c = conv(din), conv(nst), conv(nst)
        # a_log, dt_bias and d_skip stay float32 whatever the model's dtype
        self.a_log = param(torch.log(torch.linspace(1.0, 16.0, h,
                                                    device=device)))
        if torch.device(device).type == "meta":
            dt_bias = torch.empty(h, device=device)
        else:
            u = torch.rand(h, generator=generator, device=device)
            lo, hi = torch.log(torch.tensor(1e-3)), torch.log(torch.tensor(0.1))
            dt = torch.exp(lo + u * (hi - lo))
            dt_bias = torch.log(torch.expm1(dt))     # softplus^-1(dt)
        self.dt_bias = param(dt_bias)
        self.d_skip = param(torch.ones(h, device=device))
        self.wo = lin(din, d)
        self.norm = RMSNorm(din, dtype, device)

    def specs(self, rules):
        fsdp, tp = rules.fsdp, rules.tp
        return {"wz": P(fsdp, tp), "wx": P(fsdp, tp), "wb": P(fsdp, None),
                "wc": P(fsdp, None), "wdt": P(fsdp, tp),
                "conv_x": P(None, tp), "conv_b": P(None, None),
                "conv_c": P(None, None), "a_log": P(tp), "dt_bias": P(tp),
                "d_skip": P(tp), "wo": P(tp, fsdp)}


def _causal_conv(x, kernel):
    """x (B, T, C); kernel (K, C): depthwise causal conv."""
    k = kernel.shape[0]
    xp = _zeros_along_t(x, k - 1, before=True)
    return sum(xp[:, i:i + x.shape[1], :] * kernel[i][None, None, :]
               for i in range(k))


def _conv_step(buf, x_t, kernel):
    """buf (B, K-1, C) previous inputs; x_t (B, C).  Returns (y_t, buf')."""
    window = torch.cat([buf, x_t[:, None, :]], dim=1)           # (B, K, C)
    return torch.einsum("bkc,kc->bc", window, kernel), window[:, 1:, :]


def _inputs(p, h, t_true, t):
    """x, B (float32) and dt of the padded input h (B, T, D): dt = 0 on
    the padded steps."""
    x = F.silu(_causal_conv(h @ p.wx, p.conv_x))
    bm = F.silu(_causal_conv(h @ p.wb, p.conv_b)).to(_F32)
    dt = F.softplus((h @ p.wdt).to(_F32) + p.dt_bias)
    if t != t_true:
        valid = (torch.arange(t, device=h.device) < t_true).to(_F32)
        dt = dt * valid[None, :, None]
    return x, bm, dt


def _zeros_along_t(x, n: int, before: bool):
    """x (B, T, C) with n zero steps before or after it: a concatenation,
    where ``F.pad`` would do, since torch 2.11's DTensor gives a padded
    DTensor a one-dim layout on a mesh of more dims."""
    z = x.new_zeros((x.shape[0], n, x.shape[2]))
    return torch.cat([z, x] if before else [x, z], dim=1)


def _pad(h, t):
    return _zeros_along_t(h, t - h.shape[1], before=False) \
        if t != h.shape[1] else h


def mamba_forward(p, cfg, xin):
    """Training / prefill pass.  xin (B, T, D) -> (B, T, D)."""
    b, t_true, _ = xin.shape
    # The reference's rule (``ssm.py:109-111``: min(Q_max, T) when it
    # divides T, else Q_max) is min(Q_max, T) for every T.
    q = min(cfg.ssm_chunk, t_true)
    t = (t_true + q - 1) // q * q
    xin = _pad(xin, t)
    h, nst, p_ = cfg.ssm_heads, cfg.ssm_state, cfg.ssm_head_dim
    nc = t // q

    z = xin @ p.wz
    x, bm, dt = _inputs(p, xin, t_true, t)
    cm = F.silu(_causal_conv(xin @ p.wc, p.conv_c)).to(_F32)

    a = -torch.exp(p.a_log)                                     # (H,) < 0
    la = dt * a                                                 # (B,T,H) <= 0
    xh = heads_view(x, h, p_).to(_F32)

    cum = torch.cumsum(la.reshape(b, nc, q, h), dim=2)          # (B,Nc,Q,H)
    xc = xh.reshape(b, nc, q, h, p_)
    bc_ = bm.reshape(b, nc, q, nst)
    cc = cm.reshape(b, nc, q, nst)
    dtc = dt.reshape(b, nc, q, h)

    # intra-chunk: M[h, i, j] = (C_i . B_j) e^{L_i - L_j} dt_j, j <= i.  The
    # exponent is positive above the diagonal and may overflow to inf
    # there: the mask selects after the exp, never multiplies it.
    cb = torch.einsum("bcin,bcjn->bcij", cc, bc_)               # (B,Nc,Q,Q)
    decay = torch.exp(cum[:, :, :, None, :] - cum[:, :, None, :, :])
    mask = torch.tril(torch.ones(q, q, dtype=torch.bool, device=xin.device))
    m = torch.where(mask[None, None, :, :, None], decay,
                    torch.zeros((), dtype=_F32, device=xin.device))
    m = m * cb[..., None] * dtc[:, :, None, :, :]               # (B,Nc,i,j,H)
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", m, xc)

    # chunk-local end states: S_c = sum_j e^{L_Q - L_j} dt_j B_j x_j^T
    w_end = torch.exp(cum[:, :, -1:, :] - cum) * dtc            # (B,Nc,Q,H)
    s_local = torch.einsum("bcqh,bcqn,bcqhp->bchnp", w_end, bc_, xc)

    # inter-chunk recurrence: y_inter[i] = e^{L_i} C_i . S_prev
    s_prev = torch.zeros(b, h, nst, p_, dtype=_F32, device=xin.device)
    y_inter = []
    for c in range(nc):
        y_inter.append(torch.einsum("bqn,bhnp->bqhp", cc[:, c], s_prev)
                       * torch.exp(cum[:, c])[..., None])
        s_prev = (torch.exp(cum[:, c, -1, :])[:, :, None, None] * s_prev
                  + s_local[:, c])
    y_inter = torch.stack(y_inter, dim=1)                       # (B,Nc,Q,H,P)

    y = (y_intra + y_inter).reshape(b, t, h, p_)
    y = y + p.d_skip[None, None, :, None] * xh
    y = merge_heads(y).to(xin.dtype)
    y = rmsnorm(p.norm, y * F.silu(z), cfg.norm_eps)
    return (y @ p.wo)[:, :t_true, :]


def mamba_decode(p, cfg, xin, cache: SSMCache):
    """One-token step.  xin (B, 1, D)."""
    b = xin.shape[0]
    h, p_ = cfg.ssm_heads, cfg.ssm_head_dim
    xt = xin[:, 0, :]

    z = xt @ p.wz
    xr, conv_x = _conv_step(cache.conv_x, xt @ p.wx, p.conv_x)
    br, conv_b = _conv_step(cache.conv_b, xt @ p.wb, p.conv_b)
    cr, conv_c = _conv_step(cache.conv_c, xt @ p.wc, p.conv_c)
    x = F.silu(xr)
    bm = F.silu(br).to(_F32)                                    # (B, N)
    cm = F.silu(cr).to(_F32)
    dt = F.softplus((xt @ p.wdt).to(_F32) + p.dt_bias)          # (B, H)

    decay = torch.exp(dt * -torch.exp(p.a_log))                 # (B, H)
    xh = heads_view(x, h, p_).to(_F32)
    upd = torch.einsum("bh,bn,bhp->bhnp", dt, bm, xh)
    state = decay[:, :, None, None] * cache.state + upd
    y = torch.einsum("bn,bhnp->bhp", cm, state)
    y = y + p.d_skip[None, :, None] * xh
    y = merge_heads(y).to(xin.dtype)
    y = rmsnorm(p.norm, y * F.silu(z), cfg.norm_eps)
    return (y @ p.wo)[:, None, :], SSMCache(conv_x, conv_b, conv_c, state)


def empty_ssm_cache(cfg, batch: int, dtype=torch.bfloat16,
                    device=None) -> SSMCache:
    kw = cfg.ssm_conv

    def zeros(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)

    return SSMCache(
        conv_x=zeros(batch, kw - 1, cfg.ssm_d_inner),
        conv_b=zeros(batch, kw - 1, cfg.ssm_state),
        conv_c=zeros(batch, kw - 1, cfg.ssm_state),
        state=zeros(batch, cfg.ssm_heads, cfg.ssm_state, cfg.ssm_head_dim,
                    dt=_F32))
