"""The SoftSort-apply kernels for Hopper (forward + backward), dense and
banded, each beside its plain PyTorch twin.

For every instance b of a leading batch axis, with sorted keys ``ws`` (the
rows) and keys ``w`` (the columns):

    P[b]_ij   = softmax_j( -|ws[b]_i - w[b]_j| / tau )
    y[b]      = P[b] @ x[b]                      (B, N, d)
    colsum[b] = sum_i P[b]_ij                    (B, N)

Four kernels, the counterparts of the dense Pallas kernels of
``repro.kernels.softsort_apply``:

* ``fwd_fused``     — per row, the exact maximum ``m`` from a sweep of
                      scores only, then one sweep for the denominator
                      ``l`` and the un-normalized ``y`` (no rescale);
                      ``y = acc / l`` at the end.  Emits y, m, l.  (The
                      twin keeps the online softmax of the Pallas kernel:
                      the same m bitwise, l and y within rounding.)
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

Two more, the v1 split forward (counterparts of the Pallas
``_stats_kernel`` and ``_apply_kernel`` of the v1 baseline), float32 only:

* ``v1_stats``  — per row, a sweep of scores for the exact maximum ``m``,
                  then one for the denominator ``l`` (no rescale), no
                  payload.  (The twin keeps the running maximum of the
                  Pallas kernel: the same m bitwise, l within rounding.)
* ``v1_apply``  — ``y_i = sum_j exp(s_ij - m_i) x_j * (1 / l_i)`` with m
                  and l read back, no rescaling.  ``colsum`` is the third
                  pass.

Operands are unpadded: ``ws``/``w`` (B, N) float32, ``x`` (B, N, d) in the
compute dtype (float32 or bfloat16), ``tau`` a float32 tensor of B
elements (instance b's temperature ``tau[b]``) or of one element shared by
the batch.  The kernels read ``tau[b]`` through a device pointer; a
wrapper given one element expands it to B on the device, with no host
sync, so a CUDA graph can capture the call.
Keys, scores, softmax stats and accumulators are float32; at bfloat16 the
score is rounded to bfloat16 and back, as is P where it meets the payload.

Each wrapper routes on the device of its operands: CPU tensors go to the
plain twin (``*_plain``), which computes the same blocked algorithm in
plain PyTorch; CUDA tensors launch the kernel from
``csrc/softsort_apply.cu`` and raise if the launch fails.  Each wrapper
counts its kernel launches in its ``launches`` attribute.

On the card the four dense kernels run the kernel bodies of the banded
ones (``fwd_fused`` that of ``fwd_band``, ``colsum`` of ``colsum_band``,
``bwd_dws_delta`` of ``bwd_band_dws_delta``, ``bwd_dx`` of
``bwd_band_dcol``) with the band K = N and column keys ``w``: their
wrappers pass K = N, the payload tile (all but ``colsum``, which has no
payload; ``_payload_dt``: the caller's ``dt``, the autotune table's
winner, or ``band_payload_tile(d)``) and, for ``fwd_fused``, ``EXACT_MAX``
(the row maximum is not known beforehand, so a first sweep takes it).
``v1_apply`` runs ``fwd_fused``'s body with m and l given, and passes K = N
and the payload tile as ``fwd_fused`` does.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import clib

NEG_INF = -1e30
PLAIN_BLOCK = 128      # column / row block of the plain twins
# The fixed tiles of the v1 kernels, constexprs of csrc/softsort_apply.cu:
# kernel 9a's rows and threads per block, and the column step of kernel
# 9b (kernel 1's).  Kernels 1, 3, 4, 5, 7, 8 and 9b take their payload
# tile at run time (``_payload_dt``); kernels 2, 6 and 9a have none.
TILES = {"V1_TR": 32, "V1_NT": 256, "BTC": 64}
BAND_PAYLOAD_TILES = (16, 32, 64)
EXACT_MAX = 1          # fwd_fused's flag: take the row maximum in a sweep
_F32 = torch.float32
_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}
_DTYPE_NAMES = {torch.float32: "float32", torch.bfloat16: "bfloat16"}


def _inv_tau(tau):
    """1 / tau per instance, (B, 1, 1) (or (1, 1, 1) for a shared tau): it
    broadcasts over the rows and columns of a (B, rows, cols) block; its
    ``[..., 0]`` over the (B, N) per-row or per-column results."""
    return 1.0 / tau.reshape(-1, 1, 1)


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
    inv_tau = _inv_tau(tau)
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
    inv_tau = _inv_tau(tau)
    c = torch.zeros_like(w, dtype=_F32)
    for i in _blocks(w.shape[-1]):
        s = _score(ws[:, i, None], w[:, None, :], inv_tau, cd)
        p = (torch.exp(s - m[:, i, None])
             / torch.clamp_min(l[:, i, None], 1e-30))
        c = c + p.sum(dim=1)
    return c


def v1_stats_plain(ws, w, tau):
    """Twin of kernel 9a: running max and denominator over column
    blocks.  m and l (B, N) float32."""
    inv_tau = _inv_tau(tau)
    bsz, n = w.shape
    m = torch.full((bsz, n), NEG_INF, dtype=_F32, device=w.device)
    l = torch.zeros((bsz, n), dtype=_F32, device=w.device)
    for j in _blocks(n):
        s = _score(ws[:, :, None], w[:, None, j], inv_tau, _F32)
        m_new = torch.maximum(m, s.amax(dim=-1))
        l = l * torch.exp(m - m_new) + torch.exp(s - m_new[..., None]).sum(-1)
        m = m_new
    return m, l


def v1_apply_plain(ws, w, x, tau, m, l):
    """Twin of kernel 9b: ``y = P x`` over column blocks, P from the
    given m and l (``/ l`` per pair, as the Pallas kernel).  (B, N, d)
    float32."""
    inv_tau = _inv_tau(tau)
    mc = m[..., None]
    lc = torch.clamp_min(l, 1e-30)[..., None]
    y = torch.zeros(x.shape, dtype=_F32, device=x.device)
    for j in _blocks(w.shape[-1]):
        s = _score(ws[:, :, None], w[:, None, j], inv_tau, _F32)
        y = y + (torch.exp(s - mc) / lc) @ x[:, j]
    return y


def bwd_dws_delta_plain(ws, w, x, tau, m, l, dy, y, dc):
    """Twin of kernel 3: the fused delta + dws row sweep over column
    blocks.  Returns D and dws, (B, N) float32."""
    cd = x.dtype
    inv_tau = _inv_tau(tau)
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
    dws = -(A - D * S) * inv_tau[..., 0]
    return D, dws


def bwd_dx_plain(ws, w, x, tau, m, l, dy, dc, D):
    """Twin of kernel 4: the column pass over row blocks.  Returns dx
    (B, N, d) in x's dtype, dw_cols and dtau_cols (B, N) float32."""
    cd = x.dtype
    inv_tau = _inv_tau(tau)
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
        dwc = dwc + (ds * sgn).sum(dim=1) * inv_tau[..., 0]
        dtc = dtc + (ds * (-s)).sum(dim=1) * inv_tau[..., 0]
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
    inv_tau = _inv_tau(tau)
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
    inv_tau = _inv_tau(tau)
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
    inv_tau = _inv_tau(tau)
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
        dws[:, i] = -(A - Di * S) * inv_tau[..., 0]
    return D, dws


def bwd_band_dcol_plain(ws, xs, tau, m, l, dy, dc, D, band):
    """Twin of kernel 8: the column sweep over the band.  Returns dxs
    (B, N, d) in xs's dtype, the column part of the key gradient
    ``dws_col`` and the dtau partials (B, N) float32, all in rank order."""
    cd = xs.dtype
    inv_tau = _inv_tau(tau)
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
        dwc[:, j] = (ds * sgn).sum(dim=1) * inv_tau[..., 0]
        dtc[:, j] = (ds * (-s)).sum(dim=1) * inv_tau[..., 0]
    return dxs, dwc, dtc


# --------------------------------------------------------------------------
# Wrappers: CPU -> plain twin, CUDA -> hand-written kernel.
# --------------------------------------------------------------------------

def band_payload_tile(d: int) -> tuple[int, int]:
    """(DT, tiles) of kernels 1, 3, 4, 5, 7 and 8 at payload width d: the
    smallest of 16, 32 and 64 that holds d, and one tile; above 64, tiles
    of 64."""
    for dt in BAND_PAYLOAD_TILES:
        if d <= dt:
            return dt, 1
    return 64, -(-d // 64)


def _payload_dt(dt, tier: str, n: int, d: int, k: int, cd) -> int:
    """The payload tile of one launch of kernels 1, 3, 4, 5, 7, 8 or 9b:
    ``dt`` when the caller names one, else the autotune table's winner
    for (tier, N, d, K, dtype) on the card (``autotune.lookup_blocks``:
    9b reads the dense tier's row), which falls back to
    ``band_payload_tile(d)[0]`` on any miss.  A tile the launcher rejects
    (``dt_ok`` in the .cu) fails the launch."""
    if dt is not None:
        return int(dt)
    from repro_torch.kernels.autotune import lookup_blocks
    return lookup_blocks(tier, n, d, k, _DTYPE_NAMES[cd])


_P, _I = clib.P, clib.I
_SIGNATURES = {
    "ss_fwd_fused": [_P] * 7 + [_I] * 6,
    "ss_colsum": [_P] * 6 + [_I] * 3,
    "ss_bwd_dws_delta": [_P] * 11 + [_I] * 5,
    "ss_bwd_dx": [_P] * 12 + [_I] * 5,
    "ss_fwd_band": [_P] * 6 + [_I] * 5,
    "ss_colsum_band": [_P] * 5 + [_I] * 3,
    "ss_bwd_band_dws_delta": [_P] * 10 + [_I] * 5,
    "ss_bwd_band_dcol": [_P] * 11 + [_I] * 5,
    "ss_v1_stats": [_P] * 5 + [_I] * 2,
    "ss_v1_apply": [_P] * 7 + [_I] * 5,
}


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
    if tau.numel() not in (1, bsz) or tau.dtype != _F32:
        raise ValueError(f"tau must be a float32 tensor of 1 or B = {bsz} "
                         f"elements, got {tuple(tau.shape)} {tau.dtype}")
    if bsz > 65535:
        raise ValueError(f"batch {bsz} exceeds the grid limit 65535")
    for t in (ws, w, x, tau, *extra_rows):
        if t is not None and not t.is_contiguous():
            raise ValueError("kernel operands must be contiguous")
    return bsz, n, d


def _tau_rows(tau, bsz: int):
    """The kernels' (B,) temperatures: a B-element tau as it is, one
    element expanded on the device (a copy kernel, no host sync)."""
    if tau.numel() == bsz:
        return tau.reshape(bsz)
    return tau.reshape(1).expand(bsz).contiguous()


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


def _launch(wrapper, symbol: str, cd, *args) -> None:
    """Launch ``symbol`` for compute dtype ``cd`` (see ``clib.launch``)."""
    if cd not in _DTYPES:
        raise ValueError(f"compute dtype must be float32 or bfloat16, "
                         f"got {cd}")
    clib.launch(wrapper, "softsort_apply", f"{symbol}_{_DTYPES[cd]}",
                _SIGNATURES[symbol], *args)


def fwd_fused(ws, w, x, tau, dt=None):
    """Kernel 1.  (y (B, N, d) in x's dtype, m, l (B, N) float32).  ``dt``
    the payload tile (``_payload_dt``)."""
    if clib.route(ws, w, x, tau) == "cpu":
        return fwd_fused_plain(ws, w, x, tau)
    bsz, n, d = _check(ws, w, x, tau)
    tau = _tau_rows(tau, bsz)
    y = torch.empty_like(x)
    m = torch.empty_like(w)
    l = torch.empty_like(w)
    if bsz * n:
        _launch(fwd_fused, "ss_fwd_fused", x.dtype, ws, w, x, tau, y, m, l,
                bsz, n, d, n, _payload_dt(dt, "fused", n, d, 0, x.dtype),
                EXACT_MAX)
    return y, m, l


def colsum(ws, w, tau, m, l, cd=_F32):
    """Kernel 2.  Column sums of P, (B, N) float32; ``cd`` is the compute
    dtype the scores are rounded to."""
    if clib.route(ws, w, tau, m, l) == "cpu":
        return colsum_plain(ws, w, tau, m, l, cd)
    bsz, n, _ = _check(ws, w, None, tau, m, l)
    tau = _tau_rows(tau, bsz)
    c = torch.empty_like(w)
    if bsz * n:
        _launch(colsum, "ss_colsum", cd, ws, w, tau, m, l, c, bsz, n, n)
    return c


def bwd_dws_delta(ws, w, x, tau, m, l, dy, y, dc, dt=None):
    """Kernel 3.  (D, dws), (B, N) float32."""
    if clib.route(ws, w, x, tau, m, l, dy, y, dc) == "cpu":
        return bwd_dws_delta_plain(ws, w, x, tau, m, l, dy, y, dc)
    bsz, n, d = _check(ws, w, x, tau, m, l)
    tau = _tau_rows(tau, bsz)
    _check_cotangents(x, dc, dy, y)
    D = torch.empty_like(w)
    dws = torch.empty_like(w)
    if bsz * n:
        _launch(bwd_dws_delta, "ss_bwd_dws_delta", x.dtype, ws, w, x, tau,
                m, l, dy, y, dc, D, dws, bsz, n, d, n,
                _payload_dt(dt, "fused", n, d, 0, x.dtype))
    return D, dws


def bwd_dx(ws, w, x, tau, m, l, dy, dc, D, dt=None):
    """Kernel 4.  (dx (B, N, d) in x's dtype, dw_cols, dtau_cols (B, N)
    float32)."""
    if clib.route(ws, w, x, tau, m, l, dy, dc, D) == "cpu":
        return bwd_dx_plain(ws, w, x, tau, m, l, dy, dc, D)
    bsz, n, d = _check(ws, w, x, tau, m, l, D)
    tau = _tau_rows(tau, bsz)
    _check_cotangents(x, dc, dy)
    dx = torch.empty_like(x)
    dwc = torch.empty_like(w)
    dtc = torch.empty_like(w)
    if bsz * n:
        _launch(bwd_dx, "ss_bwd_dx", x.dtype, ws, w, x, tau, m, l, dy, dc, D,
                dx, dwc, dtc, bsz, n, d, n,
                _payload_dt(dt, "fused", n, d, 0, x.dtype))
    return dx, dwc, dtc


def fwd_band(ws, xs, tau, band, dt=None):
    """Kernel 5.  (y (B, N, d) in xs's dtype, m, l (B, N) float32)."""
    if clib.route(ws, xs, tau) == "cpu":
        return fwd_band_plain(ws, xs, tau, band)
    bsz, n, d = _check(ws, ws, xs, tau)
    tau = _tau_rows(tau, bsz)
    k = _check_band(band, n)
    y = torch.empty_like(xs)
    m = torch.empty_like(ws)
    l = torch.empty_like(ws)
    if bsz * n:
        _launch(fwd_band, "ss_fwd_band", xs.dtype, ws, xs, tau, y, m, l,
                bsz, n, d, k, _payload_dt(dt, "banded", n, d, k, xs.dtype))
    return y, m, l


def colsum_band(ws, tau, m, l, band, cd=_F32):
    """Kernel 6.  Column sums of the band, (B, N) float32, rank order."""
    if clib.route(ws, tau, m, l) == "cpu":
        return colsum_band_plain(ws, tau, m, l, band, cd)
    bsz, n, _ = _check(ws, ws, None, tau, m, l)
    tau = _tau_rows(tau, bsz)
    k = _check_band(band, n)
    c = torch.empty_like(ws)
    if bsz * n:
        _launch(colsum_band, "ss_colsum_band", cd, ws, tau, m, l, c, bsz, n,
                k)
    return c


def bwd_band_dws_delta(ws, xs, tau, m, l, dy, y, dc, band, dt=None):
    """Kernel 7.  (D, dws_row), (B, N) float32, rank order."""
    if clib.route(ws, xs, tau, m, l, dy, y, dc) == "cpu":
        return bwd_band_dws_delta_plain(ws, xs, tau, m, l, dy, y, dc, band)
    bsz, n, d = _check(ws, ws, xs, tau, m, l)
    tau = _tau_rows(tau, bsz)
    k = _check_band(band, n)
    _check_cotangents(xs, dc, dy, y)
    D = torch.empty_like(ws)
    dws = torch.empty_like(ws)
    if bsz * n:
        _launch(bwd_band_dws_delta, "ss_bwd_band_dws_delta", xs.dtype, ws,
                xs, tau, m, l, dy, y, dc, D, dws, bsz, n, d, k,
                _payload_dt(dt, "banded", n, d, k, xs.dtype))
    return D, dws


def bwd_band_dcol(ws, xs, tau, m, l, dy, dc, D, band, dt=None):
    """Kernel 8.  (dxs (B, N, d) in xs's dtype, dws_col, dtau_cols (B, N)
    float32), all in rank order."""
    if clib.route(ws, xs, tau, m, l, dy, dc, D) == "cpu":
        return bwd_band_dcol_plain(ws, xs, tau, m, l, dy, dc, D, band)
    bsz, n, d = _check(ws, ws, xs, tau, m, l, D)
    tau = _tau_rows(tau, bsz)
    k = _check_band(band, n)
    _check_cotangents(xs, dc, dy)
    dxs = torch.empty_like(xs)
    dwc = torch.empty_like(ws)
    dtc = torch.empty_like(ws)
    if bsz * n:
        _launch(bwd_band_dcol, "ss_bwd_band_dcol", xs.dtype, ws, xs, tau, m,
                l, dy, dc, D, dxs, dwc, dtc, bsz, n, d, k,
                _payload_dt(dt, "banded", n, d, k, xs.dtype))
    return dxs, dwc, dtc


def _check_f32(x):
    if x.dtype != _F32:
        raise ValueError(f"the v1 kernels take a float32 payload, got "
                         f"{x.dtype}")


def v1_stats(ws, w, tau):
    """Kernel 9a.  (m, l), (B, N) float32."""
    if clib.route(ws, w, tau) == "cpu":
        return v1_stats_plain(ws, w, tau)
    bsz, n, _ = _check(ws, w, None, tau)
    tau = _tau_rows(tau, bsz)
    m = torch.empty_like(w)
    l = torch.empty_like(w)
    if bsz * n:
        _launch(v1_stats, "ss_v1_stats", _F32, ws, w, tau, m, l, bsz, n)
    return m, l


def v1_apply(ws, w, x, tau, m, l, dt=None):
    """Kernel 9b: kernel 1's body with m and l given.  y (B, N, d)
    float32."""
    if clib.route(ws, w, x, tau, m, l) == "cpu":
        return v1_apply_plain(ws, w, x, tau, m, l)
    bsz, n, d = _check(ws, w, x, tau, m, l)
    tau = _tau_rows(tau, bsz)
    _check_f32(x)
    y = torch.empty_like(x)
    if bsz * n:
        _launch(v1_apply, "ss_v1_apply", _F32, ws, w, x, tau, m, l, y, bsz,
                n, d, n, _payload_dt(dt, "fused", n, d, 0, _F32))
    return y


DENSE_KERNELS = (fwd_fused, colsum, bwd_dws_delta, bwd_dx)
BAND_KERNELS = (fwd_band, colsum_band, bwd_band_dws_delta, bwd_band_dcol)
V1_KERNELS = (v1_stats, v1_apply)
KERNELS = DENSE_KERNELS + BAND_KERNELS + V1_KERNELS
for _k in KERNELS:
    _k.launches = 0


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


def launch_counts() -> dict[str, int]:
    return {k.__name__: k.launches for k in KERNELS}
