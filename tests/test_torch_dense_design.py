"""What the design of the dense kernels 1 and 4 rests on, checked on the
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
* the wrappers' plumbing: on the card ``fwd_fused`` and ``bwd_dx`` run
  the bodies of the banded kernels 5 and 8 with K = N, the payload tile
  of ``band_payload_tile(d)`` and, for ``fwd_fused``, the flag that asks
  for the exact maximum.  The library is replaced by a recorder, so the
  real ``clib.launch`` runs on CPU tensors and counts the launch.

Exact comparisons: the invariant is an identity, not a rounding bound.
"""
import contextlib
import importlib
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels.softsort_apply import softsort_apply_fwd_pallas  # noqa: E402
from repro_torch.kernels import clib  # noqa: E402

K = importlib.import_module("repro_torch.kernels.softsort_apply")

KEYS = ["sorted", "independent", "tied"]
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
TAUS = [1e-3, 0.6, 2.0]
BSZ, N, D = 2, 300, 5


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
    1) the exact-maximum flag, and count one launch each."""
    n = 37
    rng = np.random.default_rng(d)
    t = lambda *shape: torch.tensor(  # noqa: E731
        rng.normal(size=shape).astype(np.float32))
    ws, w, x, dy = t(BSZ, n), t(BSZ, n), t(BSZ, n, d).to(cd), t(BSZ, n, d)
    dy, dc, tau = dy.to(cd), t(BSZ, n).to(cd), torch.tensor([0.6])
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
