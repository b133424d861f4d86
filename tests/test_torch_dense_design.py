"""What the design of the dense kernels 1-4 rests on, checked on the
CPU against the plain twin and the JAX reference:

* the dense row maximum is the rounded score of the nearest column key,
  ``m_i = rnd(-min_j |ws_i - w_j| * (1 / tau))``, bitwise: rounding
  through the compute dtype is monotone, so the maximum of the rounded
  scores is the rounded score of the smallest distance.  Kernel 1 takes
  this maximum in a first sweep of scores only and then sums with no
  rescale; the twin and the JAX ``softsort_apply_fwd_pallas`` (interpret
  mode) keep the online softmax, whose running maximum must end at the
  same value.  Row keys sorted from the column keys (m = -0), drawn
  independently of them, and tied, in float32 and bfloat16;
* the arithmetic of kernels 6 and 7 with column keys ``w``, which the
  dense kernels 2 and 3 run: ``exp(s - m) * (1 / l)`` instead of
  ``/ l``, dP seeded with ``dc``, ``p sgn`` as ``copysign`` (0 for tied
  keys).  A plain-torch rendering of those per-pair formulas is held to
  the JAX ``_colsum_kernel`` and ``_bwd_dws_delta_kernel`` in interpret
  mode, within the tolerances of ``tests/test_torch_kernels.py``;
* the wrappers' plumbing: on the card the dense wrappers run the bodies
  of the banded kernels 5-8 with K = N, the payload tile of
  ``band_payload_tile(d)`` (``colsum`` has no payload) and, for
  ``fwd_fused``, the flag that asks for the exact maximum.  The library
  is replaced by a recorder, so the real ``clib.launch`` runs on CPU
  tensors and counts the launch.

The row-maximum comparisons are exact: the invariant is an identity, not
a rounding bound.
"""
import contextlib
import ctypes
import functools
import importlib
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels.softsort_apply import softsort_apply_fwd_pallas  # noqa: E402
from repro_torch.kernels import clib  # noqa: E402

K = importlib.import_module("repro_torch.kernels.softsort_apply")
# The module, not the package's function of the same name.
jsa = importlib.import_module("repro.kernels.softsort_apply")

KEYS = ["sorted", "independent", "tied"]
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
TAUS = [1e-3, 0.6, 2.0]
BSZ, N, D = 2, 300, 5
FWD_ATOL = 2e-5        # the tolerances of tests/test_torch_kernels.py
GRAD_RTOL = 1e-4
BF16_RTOL = 2e-2


def _keys(kind, seed):
    """(ws, w), float32 (B, N): row keys sorted from w, drawn apart from
    it, or both on a coarse grid so that row and column keys tie."""
    rng = np.random.default_rng(seed)
    w = (rng.normal(size=(BSZ, N)) * 3.0).astype(np.float32)
    if kind == "sorted":
        return np.sort(w, axis=-1, kind="stable"), w
    v = (rng.normal(size=(BSZ, N)) * 3.0).astype(np.float32)
    if kind == "tied":
        w, v = np.round(w * 2.0) / 2.0, np.round(v * 2.0) / 2.0
    return np.sort(v, axis=-1, kind="stable"), w


def _nearest_score(ws, w, tau, cd):
    """rnd(-min_j |ws_i - w_j| * (1 / tau)), as the twin rounds."""
    inv_tau = 1.0 / torch.tensor([tau]).reshape(())
    dmin = (torch.tensor(ws)[:, :, None] - torch.tensor(w)[:, None, :]
            ).abs().amin(dim=-1)
    return (-dmin * inv_tau).to(cd).to(torch.float32).numpy()


def _check_max(m, ws, w, tau, cd, kind):
    want = _nearest_score(ws, w, tau, cd)
    np.testing.assert_array_equal(m, want)
    if kind == "sorted":
        assert (m == 0).all() and np.signbit(m).all()
    elif kind == "independent":
        assert (m < 0).any()
    else:
        assert (m == 0).any() and (m < 0).any()


@pytest.mark.parametrize("tau", TAUS)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("kind", KEYS)
def test_dense_row_max_is_the_nearest_key_score_in_the_twin(kind, dtype, tau):
    """fwd_fused_plain's running maximum ends at the rounded score of the
    nearest column key: what kernel 1's first sweep writes."""
    cd = DTYPES[dtype][0]
    ws, w = _keys(kind, seed=KEYS.index(kind))
    x = torch.tensor(np.random.default_rng(5).normal(
        size=(BSZ, N, D)).astype(np.float32)).to(cd)
    _, m, _ = K.fwd_fused_plain(torch.tensor(ws), torch.tensor(w), x,
                                torch.tensor([tau]))
    _check_max(m.numpy(), ws, w, tau, cd, kind)


@pytest.mark.parametrize("tau", TAUS)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("kind", KEYS)
def test_dense_row_max_is_the_nearest_key_score_in_the_jax_kernel(kind, dtype,
                                                                  tau):
    """The dense Pallas forward (interpret mode, 128-column blocks, so the
    maximum runs across blocks) on the operands its wrapper builds, with
    the row keys of the case padded into the same call: its running
    maximum ends at the same value in every real row."""
    cd, jcd = DTYPES[dtype]
    ws, w = _keys(kind, seed=KEYS.index(kind))
    x = np.random.default_rng(5).normal(size=(BSZ, N, D)).astype(np.float32)
    br, bc, np_, dp = jops._block_geometry(N, D, 128, 128)
    _, _, w_p, x_p = jops._pad_operands(jnp.asarray(w), jnp.asarray(x), N,
                                        np_, dp, cd=jcd)
    ws_p = jnp.pad(jnp.asarray(ws), ((0, 0), (0, np_ - N))).reshape(
        BSZ, np_, 1)
    _, _, m, _ = softsort_apply_fwd_pallas(
        ws_p, w_p, x_p, jnp.full((1, 1), tau, jnp.float32), n=N, br=br,
        bc=bc, interpret=True)
    _check_max(np.asarray(m[:, :N, 0]), ws, w, tau, cd, kind)


@pytest.fixture
def recorded(monkeypatch):
    """Route CPU tensors to the CUDA path with the kernel library
    replaced by a recorder: each entry is (symbol, argtypes, args)."""
    calls = []

    def symbol(stem, name, argtypes, restype):
        def fn(*args):
            calls.append((name, argtypes, args))
            return 0
        return fn

    monkeypatch.setattr(clib, "route", lambda *tensors: "cuda")
    monkeypatch.setattr(clib, "_symbol", symbol)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: types.SimpleNamespace(cuda_stream=0))
    return calls


@pytest.mark.parametrize("d", [3, 20, 50, 130])
@pytest.mark.parametrize("cd", [torch.float32, torch.bfloat16])
def test_dense_wrappers_pass_k_n_the_payload_tile_and_the_flag(recorded, d,
                                                               cd):
    """fwd_fused and bwd_dx launch once each, through the real
    ``clib.launch``, with K = N, DT = band_payload_tile(d)[0] and (kernel
    1) the exact-maximum flag, and count one launch each.  A (B,) tau,
    one per instance, is passed as it is."""
    n = 37
    rng = np.random.default_rng(d)
    t = lambda *shape: torch.tensor(  # noqa: E731
        rng.normal(size=shape).astype(np.float32))
    ws, w, x, dy = t(BSZ, n), t(BSZ, n), t(BSZ, n, d).to(cd), t(BSZ, n, d)
    dy, dc = dy.to(cd), t(BSZ, n).to(cd)
    tau = torch.linspace(0.3, 0.9, BSZ)
    m, l, D = t(BSZ, n), t(BSZ, n), t(BSZ, n)
    dt = K.band_payload_tile(d)[0]
    suffix = {torch.float32: "f32", torch.bfloat16: "bf16"}[cd]
    K.reset_launch_counts()

    y, m_out, l_out = K.fwd_fused(ws, w, x, tau)
    dx, dwc, dtc = K.bwd_dx(ws, w, x, tau, m, l, dy, dc, D)

    assert K.launch_counts() == {**{k.__name__: 0 for k in K.KERNELS},
                                 "fwd_fused": 1, "bwd_dx": 1}
    (name1, types1, args1), (name4, types4, args4) = recorded
    assert name1 == f"ss_fwd_fused_{suffix}"
    assert name4 == f"ss_bwd_dx_{suffix}"
    ptr = lambda *ts: tuple(a.data_ptr() for a in ts)  # noqa: E731
    assert len(args1) == len(types1)
    assert args1[:7] == ptr(ws, w, x, tau, y, m_out, l_out)
    assert args1[7:] == (BSZ, n, d, n, dt, K.EXACT_MAX, 0)
    assert len(args4) == len(types4)
    assert args4[:12] == ptr(ws, w, x, tau, m, l, dy, dc, D, dx, dwc, dtc)
    assert args4[12:] == (BSZ, n, d, n, dt, 0)


def test_wrappers_expand_one_tau_to_the_batch(monkeypatch):
    """Given one tau, every kernel wrapper hands its kernel a contiguous
    (B,) copy of it (the kernels read tau[b]); given B, the tensor
    itself."""
    seen = []
    tau_arg = {"ss_fwd_fused": 3, "ss_colsum": 2, "ss_bwd_dws_delta": 3,
               "ss_bwd_dx": 3, "ss_fwd_band": 2, "ss_colsum_band": 1,
               "ss_bwd_band_dws_delta": 2, "ss_bwd_band_dcol": 2,
               "ss_v1_stats": 2, "ss_v1_apply": 3}

    def symbol(stem, name, argtypes, restype):
        def fn(*args):
            at = tau_arg[name.rsplit("_", 1)[0]]
            vals = (ctypes.c_float * BSZ).from_address(args[at])
            seen.append((name, args[at], list(vals)))
            return 0
        return fn

    monkeypatch.setattr(clib, "route", lambda *tensors: "cuda")
    monkeypatch.setattr(clib, "_symbol", symbol)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: types.SimpleNamespace(cuda_stream=0))
    n, d, k = 37, 5, 4
    rng = np.random.default_rng(0)
    t = lambda *shape: torch.tensor(  # noqa: E731
        rng.normal(size=shape).astype(np.float32))
    ws, w, x, dy, y, dc = (t(BSZ, n), t(BSZ, n), t(BSZ, n, d), t(BSZ, n, d),
                           t(BSZ, n, d), t(BSZ, n))
    m, l, D = t(BSZ, n), t(BSZ, n), t(BSZ, n)

    def launch_all(tau):
        K.fwd_fused(ws, w, x, tau)
        K.colsum(ws, w, tau, m, l)
        K.bwd_dws_delta(ws, w, x, tau, m, l, dy, y, dc)
        K.bwd_dx(ws, w, x, tau, m, l, dy, dc, D)
        K.fwd_band(ws, x, tau, k)
        K.colsum_band(ws, tau, m, l, k)
        K.bwd_band_dws_delta(ws, x, tau, m, l, dy, y, dc, k)
        K.bwd_band_dcol(ws, x, tau, m, l, dy, dc, D, k)
        K.v1_stats(ws, w, tau)
        K.v1_apply(ws, w, x, tau, m, l)

    one = torch.tensor([0.6])
    launch_all(one)
    assert len(seen) == len(K.KERNELS)
    for name, ptr, vals in seen:
        assert ptr != one.data_ptr(), name
        assert vals == [np.float32(0.6)] * BSZ, name
    seen.clear()
    per = torch.linspace(0.3, 0.9, BSZ)
    launch_all(per)
    for name, ptr, vals in seen:
        assert ptr == per.data_ptr(), name
    with pytest.raises(ValueError, match="tau"):
        K.fwd_fused(ws, w, x, torch.ones(BSZ + 1))


@pytest.mark.parametrize("band", [5, 1000])
def test_banded_wrappers_keep_their_symbols(recorded, band):
    """fwd_band and bwd_band_dcol, which share the kernel bodies, still
    pass their band (capped at N) and payload tile and no flag."""
    n, d = 37, 14
    rng = np.random.default_rng(band)
    t = lambda *shape: torch.tensor(  # noqa: E731
        rng.normal(size=shape).astype(np.float32))
    ws, xs, dy, dc, tau = t(BSZ, n), t(BSZ, n, d), t(BSZ, n, d), t(BSZ, n), \
        torch.tensor([0.6])
    m, l, D = t(BSZ, n), t(BSZ, n), t(BSZ, n)
    K.fwd_band(ws, xs, tau, band)
    K.bwd_band_dcol(ws, xs, tau, m, l, dy, dc, D, band)
    (name5, types5, args5), (name8, types8, args8) = recorded
    assert (name5, name8) == ("ss_fwd_band_f32", "ss_bwd_band_dcol_f32")
    assert len(args5) == len(types5) and len(args8) == len(types8)
    assert args5[6:] == (BSZ, n, d, min(band, n), 16, 0)
    assert args8[11:] == (BSZ, n, d, min(band, n), 16, 0)


def _bwd_dws_delta_pallas(ws_p, w_p, x_p, tau_a, m, l, dy_p, y_p, dc_p, *,
                          n, br, bc):
    """The JAX ``_bwd_dws_delta_kernel`` alone, in interpret mode, on the
    grid and blocks ``softsort_apply_bwd_pallas`` gives it: (D, dws),
    (B, Np, 1) float32."""
    bsz, np_, dp = x_p.shape
    f32 = jnp.float32
    row = pl.BlockSpec((None, br, 1), lambda b, i, j: (b, i, 0))
    col = pl.BlockSpec((None, 1, bc), lambda b, i, j: (b, 0, j))
    return pl.pallas_call(
        functools.partial(jsa._bwd_dws_delta_kernel, n=n, bc=bc,
                          nj=np_ // bc, cd=x_p.dtype),
        grid=(bsz, np_ // br, np_ // bc),
        in_specs=[row, col,
                  pl.BlockSpec((None, bc, dp), lambda b, i, j: (b, j, 0)),
                  pl.BlockSpec((1, 1), lambda b, i, j: (0, 0)), row, row,
                  pl.BlockSpec((None, br, dp), lambda b, i, j: (b, i, 0)),
                  pl.BlockSpec((None, br, dp), lambda b, i, j: (b, i, 0)),
                  col],
        out_specs=[row, row],
        out_shape=[jax.ShapeDtypeStruct((bsz, np_, 1), f32)] * 2,
        scratch_shapes=[pltpu.VMEM((br, 1), f32), pltpu.VMEM((br, 1), f32)],
        interpret=True,
    )(ws_p, w_p, x_p, tau_a, m, l, dy_p, y_p, dc_p)


def _jax_colsum_dws_delta(ws, w, x, dy, dc, tau, jcd):
    """The dense Pallas forward (for y, colsum, m, l) and the delta + dws
    row sweep on its residuals, interpret mode, 128-row and column blocks,
    sliced back to the unpadded outputs."""
    n, d = x.shape[1:]
    br, bc, np_, dp = jops._block_geometry(n, d, 128, 128)
    _, _, w_p, x_p = jops._pad_operands(jnp.asarray(w), jnp.asarray(x), n,
                                        np_, dp, cd=jcd)
    ws_p = jnp.pad(jnp.asarray(ws), ((0, 0), (0, np_ - n))).reshape(
        BSZ, np_, 1)
    tau_a = jnp.full((1, 1), tau, jnp.float32)
    y, c, m, l = softsort_apply_fwd_pallas(ws_p, w_p, x_p, tau_a, n=n, br=br,
                                           bc=bc, interpret=True)
    dy_p = jnp.pad(jnp.asarray(dy), ((0, 0), (0, np_ - n), (0, dp - d)))
    dc_p = jnp.pad(jnp.asarray(dc), ((0, 0), (0, np_ - n))).reshape(
        BSZ, 1, np_)
    D, dws = _bwd_dws_delta_pallas(ws_p, w_p, x_p, tau_a, m, l,
                                   dy_p.astype(jcd), y, dc_p.astype(jcd),
                                   n=n, br=br, bc=bc)
    f = jnp.float32
    return dict(y=np.asarray(y[:, :n, :d].astype(f)),
                c=np.asarray(c[:, 0, :n]),
                m=np.asarray(m[:, :n, 0]), l=np.asarray(l[:, :n, 0]),
                D=np.asarray(D[:, :n, 0]), dws=np.asarray(dws[:, :n, 0]))


def _render_scores(ws, w, tau, cd):
    """(1 / tau, s): the scores -|ws_i - w_j| * (1 / tau) rounded through
    the compute dtype, as kernels 6 and 7 take them."""
    inv_tau = 1.0 / tau.reshape(())
    s = (-(ws[:, :, None] - w[:, None, :]).abs() * inv_tau).to(cd).to(
        torch.float32)
    return inv_tau, s


def _render_colsum(ws, w, tau, m, l, cd):
    """Kernel 6's per-pair formula with column keys w (kernel 2):
    c_j = sum_i fma(exp(s_ij - m_i), 1 / l_i)."""
    _, s = _render_scores(ws, w, tau, cd)
    rl = 1.0 / torch.clamp_min(l, 1e-30)
    return (torch.exp(s - m[..., None]) * rl[..., None]).sum(dim=1)


def _render_dws_delta(ws, w, x, tau, m, l, dy, y, dc):
    """Kernel 7's per-pair formulas with column keys w (kernel 3):
    p = exp(s - m) * (1 / l), dP seeded with dc, ps = copysign(p, ws_i -
    w_j) and 0 for tied keys, D_i = dy_i . y_i + sum_j rnd(p) dc_j,
    dws_i = -(sum_j ps dP - D_i sum_j ps) / tau."""
    cd, f32 = x.dtype, torch.float32
    inv_tau, s = _render_scores(ws, w, tau, cd)
    rl = 1.0 / torch.clamp_min(l, 1e-30)
    p = torch.exp(s - m[..., None]) * rl[..., None]
    df = ws[:, :, None] - w[:, None, :]
    ps = torch.where(df != 0, torch.copysign(p, df), torch.zeros_like(p))
    dcf = dc.to(f32)
    dp = dcf[:, None, :] + dy.to(f32) @ x.to(f32).transpose(1, 2)
    D = ((dy.to(f32) * y.to(f32)).sum(dim=-1)
         + (p.to(cd).to(f32) @ dcf[..., None])[..., 0])
    dws = -((ps * dp).sum(dim=-1) - D * ps.sum(dim=-1)) * inv_tau
    return D, dws


def _close(got, want, rtol):
    want = np.asarray(want, np.float32)
    scale = float(np.max(np.abs(want))) + 1e-9
    np.testing.assert_allclose(np.asarray(got, np.float32), want,
                               atol=rtol * scale)


@pytest.mark.parametrize("d", [5, 50])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("kind", KEYS)
def test_kernel_6_and_7_arithmetic_with_column_keys_matches_the_jax_kernels(
        kind, dtype, d):
    """The rewrite's rounding (reciprocal of l, dP seeded with dc,
    copysign, tied keys 0) against the dense Pallas _colsum_kernel and
    _bwd_dws_delta_kernel, both fed the Pallas forward's own y, m and l:
    row keys sort(w) (one tied column per row), drawn apart from w, and
    tied on a coarse grid."""
    cd, jcd = DTYPES[dtype]
    ws, w = _keys(kind, seed=10 + KEYS.index(kind))
    rng = np.random.default_rng(d)
    x, dy = (rng.normal(size=(BSZ, N, d)).astype(np.float32)
             for _ in range(2))
    dc = rng.normal(size=(BSZ, N)).astype(np.float32)
    tau = np.float32(0.6)
    want = _jax_colsum_dws_delta(ws, w, x, dy, dc, tau, jcd)
    t = torch.tensor
    wst, wt, tt = t(ws), t(w), t([tau])
    m, l = t(want["m"]), t(want["l"])
    c = _render_colsum(wst, wt, tt, m, l, cd)
    D, dws = _render_dws_delta(wst, wt, t(x).to(cd), tt, m, l, t(dy).to(cd),
                               t(want["y"]).to(cd), t(dc).to(cd))
    if cd == torch.float32:
        np.testing.assert_allclose(c.numpy(), want["c"], atol=FWD_ATOL)
        rtol = GRAD_RTOL
    else:
        _close(c.numpy(), want["c"], BF16_RTOL)
        rtol = BF16_RTOL
    _close(D.numpy(), want["D"], rtol)
    _close(dws.numpy(), want["dws"], rtol)


@pytest.mark.parametrize("d", [3, 20, 50, 130])
@pytest.mark.parametrize("cd", [torch.float32, torch.bfloat16])
def test_dense_colsum_and_dws_pass_k_n_and_the_payload_tile(recorded, d, cd):
    """colsum and bwd_dws_delta launch once each, through the real
    ``clib.launch``, with the column keys w, K = N and (kernel 3)
    DT = band_payload_tile(d)[0], and count one launch each.  A (B,)
    tau is passed as it is."""
    n = 37
    rng = np.random.default_rng(100 + d)
    t = lambda *shape: torch.tensor(  # noqa: E731
        rng.normal(size=shape).astype(np.float32))
    ws, w, x, dy, y = t(BSZ, n), t(BSZ, n), t(BSZ, n, d), t(BSZ, n, d), \
        t(BSZ, n, d)
    x, dy, y, dc = x.to(cd), dy.to(cd), y.to(cd), t(BSZ, n).to(cd)
    tau = torch.linspace(0.3, 0.9, BSZ)
    m, l = t(BSZ, n), t(BSZ, n)
    dt = K.band_payload_tile(d)[0]
    suffix = {torch.float32: "f32", torch.bfloat16: "bf16"}[cd]
    K.reset_launch_counts()

    c = K.colsum(ws, w, tau, m, l, cd)
    D, dws = K.bwd_dws_delta(ws, w, x, tau, m, l, dy, y, dc)

    assert K.launch_counts() == {**{k.__name__: 0 for k in K.KERNELS},
                                 "colsum": 1, "bwd_dws_delta": 1}
    (name2, types2, args2), (name3, types3, args3) = recorded
    assert name2 == f"ss_colsum_{suffix}"
    assert name3 == f"ss_bwd_dws_delta_{suffix}"
    ptr = lambda *ts: tuple(a.data_ptr() for a in ts)  # noqa: E731
    assert len(args2) == len(types2)
    assert args2[:6] == ptr(ws, w, tau, m, l, c)
    assert args2[6:] == (BSZ, n, n, 0)
    assert len(args3) == len(types3)
    assert args3[:11] == ptr(ws, w, x, tau, m, l, dy, y, dc, D, dws)
    assert args3[11:] == (BSZ, n, d, n, dt, 0)


@pytest.mark.parametrize("band", [5, 1000])
def test_banded_colsum_and_dws_keep_their_symbols(recorded, band):
    """colsum_band and bwd_band_dws_delta, which share the kernel bodies
    with colsum and bwd_dws_delta, still pass their band (capped at N)
    and, kernel 7, the payload tile."""
    n, d = 37, 14
    rng = np.random.default_rng(band + 1)
    t = lambda *shape: torch.tensor(  # noqa: E731
        rng.normal(size=shape).astype(np.float32))
    ws, xs, dy, y, dc, tau = t(BSZ, n), t(BSZ, n, d), t(BSZ, n, d), \
        t(BSZ, n, d), t(BSZ, n), torch.tensor([0.6])
    m, l = t(BSZ, n), t(BSZ, n)
    K.colsum_band(ws, tau, m, l, band)
    K.bwd_band_dws_delta(ws, xs, tau, m, l, dy, y, dc, band)
    (name6, types6, args6), (name7, types7, args7) = recorded
    assert (name6, name7) == ("ss_colsum_band_f32",
                              "ss_bwd_band_dws_delta_f32")
    assert len(args6) == len(types6) and len(args7) == len(types7)
    assert args6[5:] == (BSZ, n, min(band, n), 0)
    assert args7[10:] == (BSZ, n, d, min(band, n), 16, 0)
