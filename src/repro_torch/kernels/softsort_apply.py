"""The SoftSort-apply kernels for Hopper (forward + backward), dense and
banded, each beside its plain PyTorch twin.

For every instance b of a leading batch axis, with sorted keys ``ws`` (the
rows) and keys ``w`` (the columns):

    P[b]_ij   = softmax_j( -|ws[b]_i - w[b]_j| / tau )
    y[b]      = P[b] @ x[b]                      (B, N, d)
    colsum[b] = sum_i P[b]_ij                    (B, N)

Four kernels, the counterparts of the dense Pallas kernels of
``repro.kernels.softsort_apply``:

* ``fwd_fused``     — one online-softmax sweep per row: running max ``m``,
                      denominator ``l`` and the un-normalized ``y``
                      accumulator rescaled by ``exp(m_prev - m_new)``;
                      ``y = acc / l`` at the end.  Emits y, m, l.
* ``colsum``        — ``colsum_j = sum_i exp(s_ij - m_i) / l_i``.
* ``bwd_dws_delta`` — row sweep: ``D_i = dy_i.y_i + sum_j P_ij dc_j``,
                      ``A_i = sum_j P dP sgn``, ``S_i = sum_j P sgn`` with
                      ``dP = dy x^T + dc``; emits D and
                      ``dws = -(A - D S) / tau``.
* ``bwd_dx``        — column sweep: ``dx = P^T dy``,
                      ``dw_cols_j = sum_i ds_ij sgn_ij / tau`` and the dtau
                      partial ``sum_i ds_ij (-s_ij) / tau``, with
                      ``ds = P (dP - D)``.

Four more, the banded tier (counterparts of the banded Pallas kernels):
both matrix axes are the sorted keys ``ws`` (rank space), the payload
``xs`` is in rank order, and only pairs with ``|rank_i - rank_j| <= K``
are scored; out-of-band entries of P are exactly 0.

* ``fwd_band``           — kernel 1 over the band: y (row-rank order),
                           m, l.
* ``colsum_band``        — kernel 2 over the band, rank order.
* ``bwd_band_dws_delta`` — kernel 3 over the band: D and the row part
                           ``dws_row`` of the key gradient.
* ``bwd_band_dcol``      — kernel 4 over the band: ``dxs``, the column
                           part ``dws_col`` of the key gradient and the
                           dtau partials, all in rank order.

Operands are unpadded: ``ws``/``w`` (B, N) float32, ``x`` (B, N, d) in the
compute dtype (float32 or bfloat16), ``tau`` a one-element float32
tensor shared by the batch, read by the kernels through its pointer.
Keys, scores, softmax stats and accumulators are float32; at bfloat16 the
score is rounded to bfloat16 and back, as is P where it meets the payload.

Each wrapper routes on the device of its operands: CPU tensors go to the
plain twin (``*_plain``), which computes the same blocked algorithm in
plain PyTorch; CUDA tensors launch the kernel from
``csrc/softsort_apply.cu`` and raise if the launch fails.  Each wrapper
counts its kernel launches in its ``launches`` attribute.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

NEG_INF = -1e30
PLAIN_BLOCK = 128      # column / row block of the plain twins
_F32 = torch.float32
_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}


def _score(ws, w, inv_tau, cd):
    """L1 scores from float32 keys, rounded to the compute dtype and back."""
    s = -torch.abs(ws - w) * inv_tau
    return s if cd == _F32 else s.to(cd).to(_F32)


def _as_cd(p, cd):
    """P as it meets the payload: rounded to the compute dtype."""
    return p if cd == _F32 else p.to(cd).to(_F32)


# --------------------------------------------------------------------------
# Plain twins: the same blocked algorithm in plain PyTorch.
# --------------------------------------------------------------------------

def _blocks(n: int):
    """Slices of PLAIN_BLOCK rows or columns covering 0..n-1."""
    return [slice(i, min(i + PLAIN_BLOCK, n)) for i in range(0, n, PLAIN_BLOCK)]


def fwd_fused_plain(ws, w, x, tau):
    """Twin of kernel 1: online softmax over column blocks.
    Returns y (B, N, d) in x's dtype, m and l (B, N) float32."""
    cd = x.dtype
    bsz, n, d = x.shape
    inv_tau = 1.0 / tau.reshape(())
    m = torch.full((bsz, n), NEG_INF, dtype=_F32, device=x.device)
    l = torch.zeros((bsz, n), dtype=_F32, device=x.device)
    acc = torch.zeros((bsz, n, d), dtype=_F32, device=x.device)
    for j in _blocks(n):
        s = _score(ws[:, :, None], w[:, None, j], inv_tau, cd)
        m_new = torch.maximum(m, s.amax(dim=-1))
        corr = torch.exp(m - m_new)
        p_un = torch.exp(s - m_new[..., None])
        l = l * corr + p_un.sum(dim=-1)
        acc = acc * corr[..., None] + _as_cd(p_un, cd) @ x[:, j].to(_F32)
        m = m_new
    y = (acc / torch.clamp_min(l, 1e-30)[..., None]).to(cd)
    return y, m, l


def colsum_plain(ws, w, tau, m, l, cd=_F32):
    """Twin of kernel 2: column sums of P over row blocks.  (B, N) f32."""
    inv_tau = 1.0 / tau.reshape(())
    c = torch.zeros_like(w, dtype=_F32)
    for i in _blocks(w.shape[-1]):
        s = _score(ws[:, i, None], w[:, None, :], inv_tau, cd)
        p = (torch.exp(s - m[:, i, None])
             / torch.clamp_min(l[:, i, None], 1e-30))
        c = c + p.sum(dim=1)
    return c


def bwd_dws_delta_plain(ws, w, x, tau, m, l, dy, y, dc):
    """Twin of kernel 3: the fused delta + dws row sweep over column
    blocks.  Returns D and dws, (B, N) float32."""
    cd = x.dtype
    inv_tau = 1.0 / tau.reshape(())
    dyf = dy.to(_F32)
    D = (dyf * y.to(_F32)).sum(dim=-1)
    A = torch.zeros_like(D)
    S = torch.zeros_like(D)
    lc = torch.clamp_min(l, 1e-30)[..., None]
    for j in _blocks(w.shape[-1]):
        wj = w[:, None, j]
        dcj = dc[:, j].to(_F32)
        s = _score(ws[:, :, None], wj, inv_tau, cd)
        p = torch.exp(s - m[..., None]) / lc
        dp = dyf @ x[:, j].to(_F32).transpose(1, 2) + dcj[:, None]
        sgn = torch.sign(ws[:, :, None] - wj)
        D = D + (_as_cd(p, cd) @ dcj[..., None])[..., 0]
        A = A + (p * dp * sgn).sum(dim=-1)
        S = S + (p * sgn).sum(dim=-1)
    dws = -(A - D * S) * inv_tau
    return D, dws


def bwd_dx_plain(ws, w, x, tau, m, l, dy, dc, D):
    """Twin of kernel 4: the column pass over row blocks.  Returns dx
    (B, N, d) in x's dtype, dw_cols and dtau_cols (B, N) float32."""
    cd = x.dtype
    inv_tau = 1.0 / tau.reshape(())
    xf = x.to(_F32).transpose(1, 2)
    dcf = dc.to(_F32)[:, None]
    acc = torch.zeros(x.shape, dtype=_F32, device=x.device)
    dwc = torch.zeros_like(w, dtype=_F32)
    dtc = torch.zeros_like(w, dtype=_F32)
    for i in _blocks(w.shape[-1]):
        wsi = ws[:, i, None]
        dyi = dy[:, i].to(_F32)
        s = _score(wsi, w[:, None, :], inv_tau, cd)
        p = (torch.exp(s - m[:, i, None])
             / torch.clamp_min(l[:, i, None], 1e-30))
        ds = p * (dyi @ xf + dcf - D[:, i, None])
        sgn = torch.sign(wsi - w[:, None, :])
        acc = acc + _as_cd(p, cd).transpose(1, 2) @ dyi
        dwc = dwc + (ds * sgn).sum(dim=1) * inv_tau
        dtc = dtc + (ds * (-s)).sum(dim=1) * inv_tau
    return acc.to(cd), dwc, dtc


# Banded twins.  Both matrix axes are the sorted keys ``ws`` (rank space)
# and the payload ``xs`` is in rank order; only pairs with
# |rank_row - rank_col| <= K exist.  A block of PLAIN_BLOCK rows (or
# columns) meets one window of the other axis, [max(0, r0 - K),
# min(N, r1 + K)), so no full row of N is ever formed.

def _band_windows(n: int, k: int):
    """(block, window) slice pairs: PLAIN_BLOCK indices [b0, b1) and the
    indices of the other axis within K ranks of them."""
    out = []
    for b0 in range(0, n, PLAIN_BLOCK):
        b1 = min(b0 + PLAIN_BLOCK, n)
        out.append((slice(b0, b1), slice(max(0, b0 - k), min(n, b1 + k))))
    return out


def _band_mask(rows: slice, cols: slice, k: int, device):
    """(rows, cols) validity |r - c| <= K of one band block."""
    r = torch.arange(rows.start, rows.stop, device=device)
    c = torch.arange(cols.start, cols.stop, device=device)
    return (r[:, None] - c[None, :]).abs() <= k


def _band_p(ws, m, l, rows, cols, mask, inv_tau, cd):
    """Scores and the normalized band block of P from the saved stats,
    masked to exactly 0 off the band."""
    s = _score(ws[:, rows, None], ws[:, None, cols], inv_tau, cd)
    p = (torch.exp(s - m[:, rows, None])
         / torch.clamp_min(l[:, rows, None], 1e-30))
    return s, p.masked_fill(~mask, 0.0)


def fwd_band_plain(ws, xs, tau, band):
    """Twin of kernel 5: row blocks, each a softmax over its band window.
    Returns y (B, N, d) in xs's dtype (row-rank order), m and l (B, N)
    float32."""
    cd = xs.dtype
    bsz, n, d = xs.shape
    inv_tau = 1.0 / tau.reshape(())
    y = torch.empty_like(xs)
    m = torch.empty((bsz, n), dtype=_F32, device=xs.device)
    l = torch.empty_like(m)
    for i, j in _band_windows(n, band):
        mask = _band_mask(i, j, band, xs.device)
        s = _score(ws[:, i, None], ws[:, None, j], inv_tau, cd)
        s = s.masked_fill(~mask, NEG_INF)
        mi = s.amax(dim=-1)
        p_un = torch.exp(s - mi[..., None]).masked_fill(~mask, 0.0)
        li = p_un.sum(dim=-1)
        acc = _as_cd(p_un, cd) @ xs[:, j].to(_F32)
        y[:, i] = (acc / torch.clamp_min(li, 1e-30)[..., None]).to(cd)
        m[:, i], l[:, i] = mi, li
    return y, m, l


def colsum_band_plain(ws, tau, m, l, band, cd=_F32):
    """Twin of kernel 6: column sums of the band, in rank order.  (B, N)
    float32."""
    inv_tau = 1.0 / tau.reshape(())
    c = torch.empty_like(ws, dtype=_F32)
    for j, i in _band_windows(ws.shape[-1], band):
        mask = _band_mask(i, j, band, ws.device)
        _, p = _band_p(ws, m, l, i, j, mask, inv_tau, cd)
        c[:, j] = p.sum(dim=1)
    return c


def bwd_band_dws_delta_plain(ws, xs, tau, m, l, dy, y, dc, band):
    """Twin of kernel 7: the fused delta + row sweep over the band.
    Returns D and the row part of the key gradient ``dws_row``, (B, N)
    float32, rank order.  ``dc`` is the colsum cotangent in rank order."""
    cd = xs.dtype
    inv_tau = 1.0 / tau.reshape(())
    dyf = dy.to(_F32)
    D0 = (dyf * y.to(_F32)).sum(dim=-1)
    D = torch.empty_like(D0)
    dws = torch.empty_like(D0)
    for i, j in _band_windows(ws.shape[-1], band):
        mask = _band_mask(i, j, band, ws.device)
        _, p = _band_p(ws, m, l, i, j, mask, inv_tau, cd)
        dcj = dc[:, j].to(_F32)
        dp = dyf[:, i] @ xs[:, j].to(_F32).transpose(1, 2) + dcj[:, None]
        sgn = torch.sign(ws[:, i, None] - ws[:, None, j])
        Di = D0[:, i] + (_as_cd(p, cd) @ dcj[..., None])[..., 0]
        A = (p * dp * sgn).sum(dim=-1)
        S = (p * sgn).sum(dim=-1)
        D[:, i] = Di
        dws[:, i] = -(A - Di * S) * inv_tau
    return D, dws


def bwd_band_dcol_plain(ws, xs, tau, m, l, dy, dc, D, band):
    """Twin of kernel 8: the column sweep over the band.  Returns dxs
    (B, N, d) in xs's dtype, the column part of the key gradient
    ``dws_col`` and the dtau partials (B, N) float32, all in rank order."""
    cd = xs.dtype
    inv_tau = 1.0 / tau.reshape(())
    dcf = dc.to(_F32)
    dxs = torch.empty_like(xs)
    dwc = torch.empty_like(ws, dtype=_F32)
    dtc = torch.empty_like(ws, dtype=_F32)
    for j, i in _band_windows(ws.shape[-1], band):
        mask = _band_mask(i, j, band, ws.device)
        s, p = _band_p(ws, m, l, i, j, mask, inv_tau, cd)
        dyi = dy[:, i].to(_F32)
        dp = dyi @ xs[:, j].to(_F32).transpose(1, 2) + dcf[:, None, j]
        ds = p * (dp - D[:, i, None])
        sgn = torch.sign(ws[:, i, None] - ws[:, None, j])
        dxs[:, j] = (_as_cd(p, cd).transpose(1, 2) @ dyi).to(cd)
        dwc[:, j] = (ds * sgn).sum(dim=1) * inv_tau
        dtc[:, j] = (ds * (-s)).sum(dim=1) * inv_tau
    return dxs, dwc, dtc


# --------------------------------------------------------------------------
# Wrappers: CPU -> plain twin, CUDA -> hand-written kernel.
# --------------------------------------------------------------------------

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "ss_fwd_fused": [_P] * 7 + [_I] * 3 + [_P],
    "ss_colsum": [_P] * 6 + [_I] * 2 + [_P],
    "ss_bwd_dws_delta": [_P] * 11 + [_I] * 3 + [_P],
    "ss_bwd_dx": [_P] * 12 + [_I] * 3 + [_P],
    "ss_fwd_band": [_P] * 6 + [_I] * 4 + [_P],
    "ss_colsum_band": [_P] * 5 + [_I] * 3 + [_P],
    "ss_bwd_band_dws_delta": [_P] * 10 + [_I] * 4 + [_P],
    "ss_bwd_band_dcol": [_P] * 11 + [_I] * 4 + [_P],
}


def _route(*tensors) -> str:
    """"cpu" or "cuda" — the one device type all operands share."""
    kinds = {t.device.type for t in tensors}
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError("operands on different devices: "
                         f"{sorted(map(str, devices))}")
    kind = kinds.pop()
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device type {kind!r}")
    return kind


def _check(ws, w, x, tau, *extra_rows):
    """Validate the common operands; return (B, N, d)."""
    if w.dim() != 2:
        raise ValueError(f"keys must be (B, N), got {tuple(w.shape)}")
    bsz, n = w.shape
    d = x.shape[-1] if x is not None else 0
    if ws.shape != (bsz, n):
        raise ValueError(f"ws shape {tuple(ws.shape)} != w shape {(bsz, n)}")
    if x is not None and (x.shape != (bsz, n, d) or x.dtype not in _DTYPES):
        raise ValueError(f"x must be (B, N, d) float32/bfloat16, got "
                         f"{tuple(x.shape)} {x.dtype}")
    for t in (ws, w, *extra_rows):
        if t.dtype != _F32 or t.shape != (bsz, n):
            raise ValueError(f"expected (B, N) float32, got "
                             f"{tuple(t.shape)} {t.dtype}")
    if tau.numel() != 1 or tau.dtype != _F32:
        raise ValueError("tau must be a one-element float32 tensor")
    if bsz > 65535:
        raise ValueError(f"batch {bsz} exceeds the grid limit 65535")
    for t in (ws, w, x, tau, *extra_rows):
        if t is not None and not t.is_contiguous():
            raise ValueError("kernel operands must be contiguous")
    return bsz, n, d


def _check_cotangents(x, dc, *payloads):
    """``dy`` (and the saved ``y``) like the payload ``x``; ``dc`` (B, N)
    in the payload's dtype; all contiguous."""
    for t in payloads:
        if t.shape != x.shape or t.dtype != x.dtype or not t.is_contiguous():
            raise ValueError("dy and y must match the payload in shape and "
                             "dtype")
    if (dc.shape != x.shape[:2] or dc.dtype != x.dtype
            or not dc.is_contiguous()):
        raise ValueError("dc must be (B, N) in the payload's dtype")


def _check_band(band, n) -> int:
    """The band half-width as an int >= 1, capped at N."""
    if isinstance(band, bool) or int(band) != band or band < 1:
        raise ValueError(f"band must be an int >= 1, got {band!r}")
    return min(int(band), max(n, 1))


@functools.lru_cache(maxsize=None)
def _c_function(name: str):
    """``name`` from the kernel library (built at first use), with its
    ctypes signature declared."""
    lib = build.load("softsort_apply")
    fn = getattr(lib, name)
    if name == "ss_error_string":
        fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_char_p
    else:
        fn.argtypes = _SIGNATURES[name.rsplit("_", 1)[0]]
        fn.restype = ctypes.c_int
    return fn


def _launch(wrapper, symbol: str, cd, *args) -> None:
    """Call ``symbol`` for compute dtype ``cd`` on the current stream of
    the operands' device; raise on a CUDA error, count the launch."""
    if cd not in _DTYPES:
        raise ValueError(f"compute dtype must be float32 or bfloat16, "
                         f"got {cd}")
    fn = _c_function(f"{symbol}_{_DTYPES[cd]}")
    dev = next(a.device for a in args if isinstance(a, torch.Tensor))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(*[a.data_ptr() if isinstance(a, torch.Tensor) else a
                  for a in args], stream)
    if rc != 0:
        msg = _c_function("ss_error_string")(rc).decode()
        raise RuntimeError(f"{wrapper.__name__}: CUDA launch failed "
                           f"({rc}: {msg})")
    wrapper.launches += 1


def fwd_fused(ws, w, x, tau):
    """Kernel 1.  (y (B, N, d) in x's dtype, m, l (B, N) float32)."""
    if _route(ws, w, x, tau) == "cpu":
        return fwd_fused_plain(ws, w, x, tau)
    bsz, n, d = _check(ws, w, x, tau)
    y = torch.empty_like(x)
    m = torch.empty_like(w)
    l = torch.empty_like(w)
    if bsz * n:
        _launch(fwd_fused, "ss_fwd_fused", x.dtype, ws, w, x, tau, y, m, l,
                bsz, n, d)
    return y, m, l


def colsum(ws, w, tau, m, l, cd=_F32):
    """Kernel 2.  Column sums of P, (B, N) float32; ``cd`` is the compute
    dtype the scores are rounded to."""
    if _route(ws, w, tau, m, l) == "cpu":
        return colsum_plain(ws, w, tau, m, l, cd)
    bsz, n, _ = _check(ws, w, None, tau, m, l)
    c = torch.empty_like(w)
    if bsz * n:
        _launch(colsum, "ss_colsum", cd, ws, w, tau, m, l, c, bsz, n)
    return c


def bwd_dws_delta(ws, w, x, tau, m, l, dy, y, dc):
    """Kernel 3.  (D, dws), (B, N) float32."""
    if _route(ws, w, x, tau, m, l, dy, y, dc) == "cpu":
        return bwd_dws_delta_plain(ws, w, x, tau, m, l, dy, y, dc)
    bsz, n, d = _check(ws, w, x, tau, m, l)
    _check_cotangents(x, dc, dy, y)
    D = torch.empty_like(w)
    dws = torch.empty_like(w)
    if bsz * n:
        _launch(bwd_dws_delta, "ss_bwd_dws_delta", x.dtype, ws, w, x, tau,
                m, l, dy, y, dc, D, dws, bsz, n, d)
    return D, dws


def bwd_dx(ws, w, x, tau, m, l, dy, dc, D):
    """Kernel 4.  (dx (B, N, d) in x's dtype, dw_cols, dtau_cols (B, N)
    float32)."""
    if _route(ws, w, x, tau, m, l, dy, dc, D) == "cpu":
        return bwd_dx_plain(ws, w, x, tau, m, l, dy, dc, D)
    bsz, n, d = _check(ws, w, x, tau, m, l, D)
    _check_cotangents(x, dc, dy)
    dx = torch.empty_like(x)
    dwc = torch.empty_like(w)
    dtc = torch.empty_like(w)
    if bsz * n:
        _launch(bwd_dx, "ss_bwd_dx", x.dtype, ws, w, x, tau, m, l, dy, dc, D,
                dx, dwc, dtc, bsz, n, d)
    return dx, dwc, dtc


def fwd_band(ws, xs, tau, band):
    """Kernel 5.  (y (B, N, d) in xs's dtype, m, l (B, N) float32)."""
    if _route(ws, xs, tau) == "cpu":
        return fwd_band_plain(ws, xs, tau, band)
    bsz, n, d = _check(ws, ws, xs, tau)
    k = _check_band(band, n)
    y = torch.empty_like(xs)
    m = torch.empty_like(ws)
    l = torch.empty_like(ws)
    if bsz * n:
        _launch(fwd_band, "ss_fwd_band", xs.dtype, ws, xs, tau, y, m, l,
                bsz, n, d, k)
    return y, m, l


def colsum_band(ws, tau, m, l, band, cd=_F32):
    """Kernel 6.  Column sums of the band, (B, N) float32, rank order."""
    if _route(ws, tau, m, l) == "cpu":
        return colsum_band_plain(ws, tau, m, l, band, cd)
    bsz, n, _ = _check(ws, ws, None, tau, m, l)
    k = _check_band(band, n)
    c = torch.empty_like(ws)
    if bsz * n:
        _launch(colsum_band, "ss_colsum_band", cd, ws, tau, m, l, c, bsz, n,
                k)
    return c


def bwd_band_dws_delta(ws, xs, tau, m, l, dy, y, dc, band):
    """Kernel 7.  (D, dws_row), (B, N) float32, rank order."""
    if _route(ws, xs, tau, m, l, dy, y, dc) == "cpu":
        return bwd_band_dws_delta_plain(ws, xs, tau, m, l, dy, y, dc, band)
    bsz, n, d = _check(ws, ws, xs, tau, m, l)
    k = _check_band(band, n)
    _check_cotangents(xs, dc, dy, y)
    D = torch.empty_like(ws)
    dws = torch.empty_like(ws)
    if bsz * n:
        _launch(bwd_band_dws_delta, "ss_bwd_band_dws_delta", xs.dtype, ws,
                xs, tau, m, l, dy, y, dc, D, dws, bsz, n, d, k)
    return D, dws


def bwd_band_dcol(ws, xs, tau, m, l, dy, dc, D, band):
    """Kernel 8.  (dxs (B, N, d) in xs's dtype, dws_col, dtau_cols (B, N)
    float32), all in rank order."""
    if _route(ws, xs, tau, m, l, dy, dc, D) == "cpu":
        return bwd_band_dcol_plain(ws, xs, tau, m, l, dy, dc, D, band)
    bsz, n, d = _check(ws, ws, xs, tau, m, l, D)
    k = _check_band(band, n)
    _check_cotangents(xs, dc, dy)
    dxs = torch.empty_like(xs)
    dwc = torch.empty_like(ws)
    dtc = torch.empty_like(ws)
    if bsz * n:
        _launch(bwd_band_dcol, "ss_bwd_band_dcol", xs.dtype, ws, xs, tau, m,
                l, dy, dc, D, dxs, dwc, dtc, bsz, n, d, k)
    return dxs, dwc, dtc


DENSE_KERNELS = (fwd_fused, colsum, bwd_dws_delta, bwd_dx)
BAND_KERNELS = (fwd_band, colsum_band, bwd_band_dws_delta, bwd_band_dcol)
KERNELS = DENSE_KERNELS + BAND_KERNELS
for _k in KERNELS:
    _k.launches = 0


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


def launch_counts() -> dict[str, int]:
    return {k.__name__: k.launches for k in KERNELS}
