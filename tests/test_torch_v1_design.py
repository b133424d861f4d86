"""What the design of the v1 kernels 9a (``v1_stats``) and 9b
(``v1_apply``) rests on, checked on the CPU against the JAX reference:

* kernel 9a's arithmetic: per row a sweep of scores for the exact
  maximum, then ``l = sum_j exp(s_ij - m_i)`` with no rescale, summed in
  the kernel's order (column lane k takes columns k, k + SCOLS, ... in
  turn; the SCOLS partials are added in lane order).  A plain-torch
  rendering of it is held to the JAX ``_stats_kernel`` as
  ``softsort_apply_fwd_pallas_v1`` runs it (interpret mode, 128-column
  blocks, so the running maximum and its rescale run across blocks): m
  bitwise (the rounding is monotone, so the maximum of the scores is the
  running maximum), l at rtol 2e-5;
* kernel 9b's rounding, kernel 1's body with m and l given:
  ``exp(s - m)`` with no division per pair and each row of ``P x`` scaled
  by ``1 / max(l, 1e-30)`` at the end, against the JAX ``_apply_kernel``'s
  y (fed the same m and l) at atol 2e-5 x max-abs;
* with row keys sorted from the column keys (m = -0), drawn apart from
  them, and tied on a coarse grid;
* the wrappers' plumbing: ``v1_apply`` passes K = N and the payload tile
  of ``band_payload_tile(d)``, as ``fwd_fused`` does; ``v1_stats`` takes
  no payload tile.  The library is replaced by a recorder, so the real
  ``clib.launch`` runs on CPU tensors and counts the launch.

Tolerances are those of ``tests/test_torch_kernels.py``.
"""
import contextlib
import functools
import importlib
import types
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro_torch.kernels import clib  # noqa: E402

K = importlib.import_module("repro_torch.kernels.softsort_apply")
# The module, not the package's function of the same name.
jsa = importlib.import_module("repro.kernels.softsort_apply")

KEYS = ["sorted", "independent", "tied"]
BSZ, N = 2, 300
FWD_ATOL = 2e-5
# Kernel 9a's column lanes: threads per block over 4-row groups.
SCOLS = K.TILES["V1_NT"] // (K.TILES["V1_TR"] // 4)


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


@functools.lru_cache(maxsize=None)
def _jax_v1(kind, tau, d):
    """``softsort_apply_fwd_pallas_v1`` in interpret mode on the operands
    its wrapper builds, the row keys of the case padded in, 128-row and
    column blocks.  The outputs of its pallas_calls are recorded: m and l
    of ``_stats_kernel``, and y of ``_apply_kernel``, which read them
    back.  Returns numpy ws, w, x and the unpadded m, l, y."""
    ws, w = _keys(kind, seed=KEYS.index(kind))
    x = np.random.default_rng(d).normal(size=(BSZ, N, d)).astype(np.float32)
    br, bc, np_, dp = jops._block_geometry(N, d, 128, 128)
    _, _, w_p, x_p = jops._pad_operands(jnp.asarray(w), jnp.asarray(x), N,
                                        np_, dp)
    ws_p = jnp.pad(jnp.asarray(ws), ((0, 0), (0, np_ - N))).reshape(
        BSZ, np_, 1)
    outs = []
    real = pl.pallas_call

    def recording(*args, **kwargs):
        call = real(*args, **kwargs)

        def run(*operands):
            outs.append(call(*operands))
            return outs[-1]
        return run

    with mock.patch.object(jsa.pl, "pallas_call", recording):
        y, _ = jsa.softsort_apply_fwd_pallas_v1(
            ws_p, w_p, x_p, jnp.full((1, 1), tau, jnp.float32), n=N, br=br,
            bc=bc, interpret=True)
    (m, l), y_rec, _ = outs
    assert y_rec is y
    return (ws, w, x, np.asarray(m[:, :N, 0]), np.asarray(l[:, :N, 0]),
            np.asarray(y[:, :N, :d]))


def _scores(ws, w, tau):
    """-|ws_i - w_j| * (1 / tau), float32, as the kernels take them."""
    inv_tau = 1.0 / torch.tensor([tau]).reshape(())
    return -(ws[:, :, None] - w[:, None, :]).abs() * inv_tau


def _render_v1_stats(ws, w, tau):
    """Kernel 9a, a step of SCOLS columns at a time: m the maximum of the
    scores (sweep 1); l the sum of exp(s - m) with no rescale (sweep 2),
    lane k summing columns k, k + SCOLS, ... in turn, then the lanes added
    in order."""
    n = w.shape[-1]
    steps = [slice(j0, min(j0 + SCOLS, n)) for j0 in range(0, n, SCOLS)]
    m = torch.full(ws.shape, -1e30)
    for c in steps:
        m = torch.maximum(m, _scores(ws, w[:, c], tau).amax(dim=-1))
    lanes = torch.zeros(ws.shape + (SCOLS,))
    for c in steps:
        e = torch.exp(_scores(ws, w[:, c], tau) - m[..., None])
        lanes[..., :e.shape[-1]] += e
    l = lanes[..., 0]
    for k in range(1, SCOLS):
        l = l + lanes[..., k]
    return m, l


def _render_v1_apply(ws, w, x, tau, m, l):
    """Kernel 9b: P x with p = exp(s - m) (no division per pair), each
    row then scaled by 1 / max(l, 1e-30)."""
    p = torch.exp(_scores(ws, w, tau) - m[..., None])
    return (p @ x) * (1.0 / torch.clamp_min(l, 1e-30))[..., None]


@pytest.mark.parametrize("tau", [0.05, 0.6])
@pytest.mark.parametrize("kind", KEYS)
def test_v1_stats_arithmetic_matches_the_jax_stats_kernel(kind, tau):
    """The exact-maximum sweep and the no-rescale sum in the kernel's
    order against ``_stats_kernel``'s running maximum and rescaled sum:
    m bitwise, l at rtol 2e-5."""
    ws, w, _, m_j, l_j, _ = _jax_v1(kind, tau, 5)
    m, l = _render_v1_stats(torch.tensor(ws), torch.tensor(w), tau)
    np.testing.assert_array_equal(m.numpy(), m_j)
    np.testing.assert_allclose(l.numpy(), l_j, rtol=FWD_ATOL)
    if kind == "sorted":
        assert (m_j == 0).all() and np.signbit(m_j).all()
    else:
        assert (m_j < 0).any()


@pytest.mark.parametrize("d", [5, 50])
@pytest.mark.parametrize("kind", KEYS)
def test_v1_apply_rounding_matches_the_jax_apply_kernel(kind, d):
    """``exp(s - m)`` and a per-row ``1 / l`` at the end against
    ``_apply_kernel``'s ``exp(s - m) / l`` per pair, both fed the stats
    kernel's m and l: atol 2e-5 x max-abs of the JAX y."""
    tau = 0.6
    ws, w, x, m_j, l_j, y_j = _jax_v1(kind, tau, d)
    y = _render_v1_apply(torch.tensor(ws), torch.tensor(w), torch.tensor(x),
                         tau, torch.tensor(m_j), torch.tensor(l_j))
    scale = float(np.max(np.abs(y_j)))
    np.testing.assert_allclose(y.numpy(), y_j, atol=FWD_ATOL * scale)


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


@pytest.mark.parametrize("d", [3, 8, 50, 130])
def test_v1_wrappers_pass_k_n_and_the_payload_tile(recorded, d):
    """v1_stats launches with (B, N) and no payload tile; v1_apply with
    K = N and DT = band_payload_tile(d)[0], as fwd_fused; one launch
    counted each, through the real ``clib.launch``.  A (B,) tau is passed
    as it is."""
    n = 37
    rng = np.random.default_rng(d)
    t = lambda *shape: torch.tensor(  # noqa: E731
        rng.normal(size=shape).astype(np.float32))
    ws, w, x = t(BSZ, n), t(BSZ, n), t(BSZ, n, d)
    tau = torch.linspace(0.3, 0.9, BSZ)
    m, l = t(BSZ, n), t(BSZ, n)
    K.reset_launch_counts()

    m_out, l_out = K.v1_stats(ws, w, tau)
    y = K.v1_apply(ws, w, x, tau, m, l)

    assert K.launch_counts() == {**{k.__name__: 0 for k in K.KERNELS},
                                 "v1_stats": 1, "v1_apply": 1}
    (name_s, types_s, args_s), (name_a, types_a, args_a) = recorded
    assert (name_s, name_a) == ("ss_v1_stats_f32", "ss_v1_apply_f32")
    ptr = lambda *ts: tuple(a.data_ptr() for a in ts)  # noqa: E731
    assert len(args_s) == len(types_s)
    assert args_s[:5] == ptr(ws, w, tau, m_out, l_out)
    assert args_s[5:] == (BSZ, n, 0)
    assert len(args_a) == len(types_a)
    assert args_a[:7] == ptr(ws, w, x, tau, m, l, y)
    assert args_a[7:] == (BSZ, n, d, n, K.band_payload_tile(d)[0], 0)
