"""The banded tier of the port against the JAX reference, on the CPU:

* the windowed oracle ``repro_torch.core.softsort_apply_banded`` and
  ``band_tail_bound`` against ``repro.core.softsort``;
* the four banded plain twins (``repro_torch.kernels.softsort_apply``)
  against the banded Pallas functions ``softsort_apply_fwd_banded_pallas``
  and ``softsort_apply_bwd_banded_pallas`` in interpret mode, on the
  operands the JAX wrapper builds (``_band_geometry``/``_band_operands``),
  comparing the unpadded, un-transposed outputs;
* the banded autograd.Function (``repro_torch.kernels.ops``) against the
  JAX ``custom_vjp``;
* the dense-to-banded dispatch (``resolve_band``, ``_band_switch_round``)
  and the engines across the switch, against ``repro.core.shufflesoftsort``
  and, inside the port, batched against sequential.

Tolerances:

* forward ``y``, ``colsum``, ``m``: atol 2e-5 (``l`` rtol 2e-5) — float32
  sums over the band taken in different orders;
* gradients and backward outputs: atol 1e-4 x max-abs of the reference,
  the reference suite's gradient bound;
* bfloat16 twins: the 2e-2 envelope of ``tests/test_precision.py``;
* dispatch: exactly equal; engine orders exactly equal and losses within
  rtol 1e-5 on warm rounds and on every round with ``lambda_sigma=0``
  (cold rounds with the std term on: see ``tests/test_torch_engine.py``).
"""
import dataclasses
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import shufflesoftsort as jeng  # noqa: E402
from repro.core import softsort as jss  # noqa: E402
from repro.core.losses import mean_pairwise_distance as jmpd  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels.softsort_apply import (  # noqa: E402
    softsort_apply_bwd_banded_pallas,
    softsort_apply_fwd_banded_pallas,
)
from repro_torch.core import shufflesoftsort as teng  # noqa: E402
from repro_torch.core import softsort as tss  # noqa: E402
from repro_torch.core.prng import ReplayShuffleSource  # noqa: E402
from repro_torch.core.reference import config_from_reference  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402

K = importlib.import_module("repro_torch.kernels.softsort_apply")

FWD_ATOL = 2e-5
GRAD_RTOL = 1e-4
BF16_RTOL = 2e-2
LOSS_RTOL = 1e-5
COLD_LOSS_RTOL = 2e-2
N, HW, D = 64, (8, 8), 3


def _untied_keys(rng, shape, scale=3.0):
    """Keys with no bitwise-tied pair (see test_torch_softsort)."""
    while True:
        w = (rng.normal(size=shape) * scale).astype(np.float32)
        if all(len(np.unique(row)) == row.size
               for row in w.reshape(-1, shape[-1])):
            return w


def _close(got, want, rtol):
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32)
    scale = float(np.max(np.abs(want))) + 1e-9
    np.testing.assert_allclose(got, want, atol=rtol * scale)


def _grad_inputs(seed, lead, n, d):
    rng = np.random.default_rng(seed)
    w = _untied_keys(rng, lead + (n,))
    x = rng.normal(size=lead + (n, d)).astype(np.float32)
    a = rng.normal(size=lead + (n, d)).astype(np.float32)
    b = rng.normal(size=lead + (n,)).astype(np.float32)
    return w, x, a, b


def _jax_value_and_grads(fn, w, x, a, b, tau):
    def loss_fn(w, x, tau):
        y, c = fn(w, x, tau)
        return jnp.sum(y * a) + jnp.sum(jnp.square(c) * b), (y, c)

    (_, (y, c)), grads = jax.jit(jax.value_and_grad(
        loss_fn, argnums=(0, 1, 2), has_aux=True))(
        jnp.asarray(w), jnp.asarray(x), jnp.float32(tau))
    return (np.asarray(y), np.asarray(c), *[np.asarray(g) for g in grads])


def _torch_value_and_grads(fn, w, x, a, b, tau):
    wt = torch.tensor(w, requires_grad=True)
    xt = torch.tensor(x, requires_grad=True)
    tt = torch.tensor(tau, dtype=torch.float32, requires_grad=True)
    y, c = fn(wt, xt, tt)
    loss = (y * torch.tensor(a)).sum() + (c.square() * torch.tensor(b)).sum()
    grads = torch.autograd.grad(loss, (wt, xt, tt))
    return (y.detach().numpy(), c.detach().numpy(),
            *[g.numpy() for g in grads])


def _assert_values_and_grads(got, want):
    np.testing.assert_allclose(got[0], want[0], atol=FWD_ATOL, err_msg="y")
    np.testing.assert_allclose(got[1], want[1], atol=FWD_ATOL, err_msg="c")
    for g, r in zip(got[2:], want[2:]):
        _close(g, r, GRAD_RTOL)


# ------------------------------------------------- oracle and tail bound

@pytest.mark.parametrize("n,d,k", [(100, 3, 16), (300, 7, 40), (300, 2, 100)])
@pytest.mark.parametrize("batch", [None, 3])
@pytest.mark.parametrize("descending", [False, True])
def test_banded_oracle_matches_jax(n, d, k, batch, descending):
    """Values and dw, dx, dtau of the windowed oracle against jax.grad."""
    lead = () if batch is None else (batch,)
    w, x, a, b = _grad_inputs(n + d + k, lead, n, d)

    def jfn(w, x, tau):
        return jss.softsort_apply_banded(w, x, tau, k, descending=descending)

    def tfn(w, x, tau):
        return tss.softsort_apply_banded(w, x, tau, k, descending=descending)

    _assert_values_and_grads(_torch_value_and_grads(tfn, w, x, a, b, 0.6),
                             _jax_value_and_grads(jfn, w, x, a, b, 0.6))


def test_band_tail_bound_matches_jax():
    """Scalar and per-instance tau; exactly 0 once the band covers all."""
    rng = np.random.default_rng(3)
    w = np.stack([rng.permutation(200) for _ in range(3)]).astype(
        np.float32) + rng.random((3, 200), dtype=np.float32) * 0.5
    taus = np.array([1.0, 2.0, 3.0], np.float32)   # bounds stay normal
    for k in (1, 8, 40):
        np.testing.assert_allclose(
            tss.band_tail_bound(torch.tensor(w[0]), 2.0, k).numpy(),
            np.asarray(jss.band_tail_bound(jnp.asarray(w[0]), 2.0, k)),
            rtol=1e-6)
        np.testing.assert_allclose(
            tss.band_tail_bound(torch.tensor(w), torch.tensor(taus),
                                k).numpy(),
            np.asarray(jss.band_tail_bound(jnp.asarray(w), jnp.asarray(taus),
                                           k)), rtol=1e-6)
    for k in (199, 250):
        got = tss.band_tail_bound(torch.tensor(w), 0.4, k)
        assert got.shape == (3,) and torch.equal(got, torch.zeros(3))


# ------------------------------------- twins vs the banded Pallas kernels

def _band_case(bsz, n, d, seed):
    rng = np.random.default_rng(seed)
    w = _untied_keys(rng, (bsz, n))
    x = rng.normal(size=(bsz, n, d)).astype(np.float32)
    dy = rng.normal(size=(bsz, n, d)).astype(np.float32)
    dc = rng.normal(size=(bsz, n)).astype(np.float32)      # rank order
    perm = np.argsort(w, axis=-1, kind="stable")
    ws = np.take_along_axis(w, perm, axis=-1)
    xs = np.take_along_axis(x, perm[..., None], axis=1)
    return w, ws, x, xs, dy, dc, np.float32(0.6)


def _jax_band_pallas(w, x, dy, dc, tau, k, y_for_bwd, cd=jnp.float32):
    """Both banded Pallas functions in interpret mode on the wrapper's
    padded, transposed layout, returned unpadded in (B, N[, d]) form."""
    bsz, n, d = x.shape
    blk, np_, dsub = jops._band_geometry(n, d, 128)
    _, wr, wc, xt = jops._band_operands(jnp.asarray(w), jnp.asarray(x), n,
                                        np_, dsub, cd=cd)
    tau_a = jnp.full((1, 1), tau, jnp.float32)
    y_t, c, m, l = softsort_apply_fwd_banded_pallas(
        wr, wc, xt, tau_a, n=n, k=k, blk=blk, interpret=True)

    def to_t(a):
        return jnp.pad(jnp.asarray(a, jnp.float32),
                       ((0, 0), (0, np_ - n), (0, dsub - d))).transpose(
                           0, 2, 1).astype(cd)

    dc_p = jnp.pad(jnp.asarray(dc), ((0, 0), (0, np_ - n))).reshape(
        bsz, np_, 1).astype(cd)
    dws_row, dws_col, dxt, dtc = softsort_apply_bwd_banded_pallas(
        wr, wc, xt, tau_a, m, l, to_t(y_for_bwd), to_t(dy), dc_p, n=n, k=k,
        blk=blk, interpret=True)
    f = np.float32
    return dict(
        y=np.asarray(y_t[:, :d, :n].astype(jnp.float32)).transpose(0, 2, 1),
        c=np.asarray(c[:, :n, 0]), m=np.asarray(m[:, 0, :n]),
        l=np.asarray(l[:, 0, :n]), dws_row=np.asarray(dws_row[:, 0, :n], f),
        dws_col=np.asarray(dws_col[:, :n, 0], f),
        dxs=np.asarray(dxt[:, :d, :n].astype(jnp.float32)).transpose(0, 2, 1),
        dtc=np.asarray(dtc[:, :n, 0], f))


def _torch_band_twins(ws, xs, dy, dc, tau, k, cd=torch.float32):
    t = torch.tensor
    wst, xst, tt = t(ws), t(xs).to(cd), t(tau).reshape(1)
    y, m, l = K.fwd_band(wst, xst, tt, k)
    c = K.colsum_band(wst, tt, m, l, k, cd)
    dyt, dct = t(dy).to(cd), t(dc).to(cd)
    D, dws_row = K.bwd_band_dws_delta(wst, xst, tt, m, l, dyt, y, dct, k)
    dxs, dws_col, dtc = K.bwd_band_dcol(wst, xst, tt, m, l, dyt, dct, D, k)
    f = torch.float32
    return dict(y=y.to(f).numpy(), c=c.numpy(), m=m.numpy(), l=l.numpy(),
                dws_row=dws_row.numpy(), dws_col=dws_col.numpy(),
                dxs=dxs.to(f).numpy(), dtc=dtc.numpy())


@pytest.mark.parametrize("bsz,n,d,k", [(1, 300, 7, 40), (3, 129, 17, 16),
                                       (2, 300, 2, 100)])
def test_band_twins_match_jax_pallas_kernels(bsz, n, d, k):
    """Kernels 5-8: each twin against its banded Pallas kernel; the
    backward Pallas function takes the twin's own y as the saved residual."""
    w, ws, x, xs, dy, dc, tau = _band_case(bsz, n, d, seed=n + d + k)
    got = _torch_band_twins(ws, xs, dy, dc, tau, k)
    want = _jax_band_pallas(w, x, dy, dc, tau, k, got["y"])
    for key in ("y", "c", "m"):
        np.testing.assert_allclose(got[key], want[key], atol=FWD_ATOL,
                                   err_msg=key)
    np.testing.assert_allclose(got["l"], want["l"], rtol=FWD_ATOL)
    for key in ("dws_row", "dws_col", "dxs", "dtc"):
        _close(got[key], want[key], GRAD_RTOL)


def test_band_twins_bf16_match_jax_pallas_kernels():
    """bfloat16: scores and payload rounded to bf16, stats float32."""
    k = 40
    w, ws, x, xs, dy, dc, tau = _band_case(2, 300, 7, seed=17)
    got = _torch_band_twins(ws, xs, dy, dc, tau, k, cd=torch.bfloat16)
    want = _jax_band_pallas(w, x, dy, dc, tau, k, got["y"], cd=jnp.bfloat16)
    for key in ("y", "c", "dws_row", "dws_col", "dxs", "dtc"):
        _close(got[key], want[key], BF16_RTOL)


def test_band_twins_visit_only_the_band():
    """A twin's block never meets an index more than K (plus its own
    block) away: every window is [max(0, b0 - K), min(N, b1 + K))."""
    for n, k in ((300, 40), (17, 3), (1000, 1)):
        for blk, win in K._band_windows(n, k):
            assert win.start == max(0, blk.start - k)
            assert win.stop == min(n, blk.stop + k)


# ------------------------------------------------- the banded Function

@pytest.mark.parametrize("bsz,n,d,k", [(1, 100, 3, 16), (3, 300, 7, 40),
                                       (2, 300, 2, 100)])
def test_softsort_apply_banded_matches_jax_ops(bsz, n, d, k):
    """The CPU route of the banded Function against the JAX custom_vjp
    (``block=128``): values and the gradients of w, x and tau."""
    w, x, a, b = _grad_inputs(7 * n + k, (bsz,), n, d)

    def jfn(w, x, tau):
        return jops.softsort_apply_banded(w, x, tau, k, block=128)

    def tfn(w, x, tau):
        return tops.softsort_apply_banded(w, x, tau, k)

    _assert_values_and_grads(_torch_value_and_grads(tfn, w, x, a, b, 0.7),
                             _jax_value_and_grads(jfn, w, x, a, b, 0.7))


def test_softsort_apply_banded_unbatched_and_descending():
    """(N,) keys, and ``descending`` (a flip of y), against JAX."""
    w, x, a, b = _grad_inputs(5, (), 150, 4)

    def jfn(w, x, tau):
        return jops.softsort_apply_banded(w, x, tau, 20, block=128,
                                          descending=True)

    def tfn(w, x, tau):
        return tops.softsort_apply_banded(w, x, tau, 20, descending=True)

    _assert_values_and_grads(_torch_value_and_grads(tfn, w, x, a, b, 0.5),
                             _jax_value_and_grads(jfn, w, x, a, b, 0.5))


def test_full_band_is_bitwise_the_dense_apply():
    """``band >= N - 1`` covers every pair and runs the dense Function."""
    rng = np.random.default_rng(9)
    w = torch.tensor(_untied_keys(rng, (2, 50)))
    x = torch.tensor(rng.normal(size=(2, 50, 3)).astype(np.float32))
    want = tops.softsort_apply(w, x, 0.5)
    for band in (49, 50, 1000):
        got = tops.softsort_apply_banded(w, x, 0.5, band)
        for g, r in zip(got, want):
            assert torch.equal(g, r)


def test_banded_cpu_route_never_launches_kernels():
    K.reset_launch_counts()
    w = torch.randn(2, 60, requires_grad=True)
    y, c = tops.softsort_apply_banded(w, torch.randn(2, 60, 4), 0.5, 8)
    (y.sum() + c.square().sum()).backward()
    counts = K.launch_counts()
    assert set(counts) == {"fwd_fused", "colsum", "bwd_dws_delta", "bwd_dx",
                           "fwd_band", "colsum_band", "bwd_band_dws_delta",
                           "bwd_band_dcol"}
    assert not any(counts.values())


# --------------------------------------------------------------- dispatch

def test_resolve_band_and_switch_round_match_jax():
    grid = [{}, {"rounds": 16}, {"rounds": 37, "tau_start": 2.0,
                                 "tau_end": 0.05},
            {"rounds": 6, "band_eps": 1e-3}, {"rounds": 100, "tau_end": 0.5,
                                              "band_eps": 1e-9}]
    for kw in grid:
        for n in (64, 300, 4096, 65536):
            for band in (1, 8, 16, 24, 64, "auto", n):
                jc = jeng.ShuffleSoftSortConfig(band=band, **kw)
                tc = config_from_reference(dataclasses.asdict(jc))
                assert teng.resolve_band(tc, n) == jeng.resolve_band(jc, n)
                assert (teng._band_switch_round(tc, n)
                        == jeng._band_switch_round(jc, n)), (kw, n, band)


# ------------------------------------------- the engines across the switch

def _jcfg(**kw):
    return jeng.ShuffleSoftSortConfig(rounds=6, inner_steps=4, band=16, **kw)


def _warm_rounds(cfg) -> np.ndarray:
    """Rounds whose first inner temperature resolves exp(-1/tau) above
    float32 epsilon (``tests/test_torch_engine.py``)."""
    if cfg.lambda_sigma == 0:
        return np.ones(cfg.rounds, bool)
    tau0 = jeng._tau_schedule(cfg) * np.float32(cfg.inner_tau_ramp)
    return np.exp(-1.0 / tau0.astype(np.float64)) > np.finfo(np.float32).eps


def _assert_rounds_match(cfg, got, want):
    """got/want: per-round lists of (orders, losses); the run crosses the
    switch at round 2 and compares banded rounds exactly."""
    switch = jeng._band_switch_round(cfg, N)
    warm = _warm_rounds(cfg)
    assert switch == 2 and warm[switch:].any()
    assert len(got) == len(want) == cfg.rounds
    for r, ((og, lg), (ow, lw)) in enumerate(zip(got, want)):
        if warm[r]:
            np.testing.assert_array_equal(og, ow, err_msg=f"round {r}")
            np.testing.assert_allclose(lg, lw, rtol=LOSS_RTOL,
                                       err_msg=f"round {r}")
        else:
            for row in np.asarray(og).reshape(-1, N):
                assert np.array_equal(np.sort(row), np.arange(N)), r
            np.testing.assert_allclose(lg, lw, rtol=COLD_LOSS_RTOL,
                                       err_msg=f"round {r}")


def _x(seed, b=None):
    rng = np.random.default_rng(seed)
    shape = (N, D) if b is None else (b, N, D)
    return rng.normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("lambda_sigma", [2.0, 0.0], ids=["std", "no_std"])
def test_banded_sequential_slice_matches_jax(lambda_sigma):
    """Sequential, kernel tier on both sides, 6 rounds x 4 inner steps:
    dense rounds 0-1, banded rounds 2-5."""
    x, key = _x(1), jax.random.PRNGKey(5)
    cfg = _jcfg(use_kernel=True, lambda_sigma=lambda_sigma)
    want = []
    jeng.shuffle_soft_sort(jnp.asarray(x), HW, cfg, key=key,
                           callback=lambda r, o, l: want.append(
                               (np.asarray(o).copy(), np.float32(l))))
    shuffles, k = [], key
    for _ in range(cfg.rounds):
        k, sub = jax.random.split(k)
        shuffles.append(np.asarray(jax.random.permutation(sub, N)))
    got = []
    teng.shuffle_soft_sort(
        x, HW, config_from_reference(dataclasses.asdict(cfg)), device="cpu",
        source=ReplayShuffleSource(np.stack(shuffles)[:, None], "cpu"),
        norm=float(jmpd(jnp.asarray(x))),
        callback=lambda r, o, l: got.append((o, l)))
    _assert_rounds_match(cfg, got, want)


@pytest.mark.parametrize("use_kernel,lambda_sigma",
                         [(True, 2.0), (True, 0.0), (False, 0.0)],
                         ids=["kernel-std", "kernel-no_std", "oracle-no_std"])
def test_banded_batched_slice_matches_jax(use_kernel, lambda_sigma):
    """B=2 problems x S=2 restarts with explicit keys; ``use_kernel=False``
    runs the chunked and windowed oracles on both sides."""
    b, s = 2, 2
    xs = _x(7, b)
    cfg = _jcfg(use_kernel=use_kernel, lambda_sigma=lambda_sigma)
    keys = jax.random.split(jax.random.PRNGKey(21), b * s)
    want = []
    jeng.shuffle_soft_sort_batched(
        jnp.asarray(xs), HW, cfg, n_restarts=s, keys=keys,
        callback=lambda r, o, l: want.append((np.asarray(o).copy(),
                                              np.asarray(l).copy())))
    shuffles, k = [], keys
    for _ in range(cfg.rounds):
        pair = jax.vmap(jax.random.split)(k)
        k, subs = pair[:, 0], pair[:, 1]
        shuffles.append(np.stack([np.asarray(jax.random.permutation(sk, N))
                                  for sk in subs]))
    got = []
    teng.shuffle_soft_sort_batched(
        xs, HW, config_from_reference(dataclasses.asdict(cfg)),
        n_restarts=s, device="cpu",
        source=ReplayShuffleSource(np.stack(shuffles), "cpu"),
        norms=np.asarray(jax.vmap(jmpd)(jnp.asarray(xs))),
        callback=lambda r, o, l: got.append((o, l)))
    _assert_rounds_match(cfg, got, want)


@pytest.mark.parametrize("use_kernel", [True, False])
def test_port_banded_batched_equals_sequential(use_kernel):
    """Inside the port, across the switch: instance i of a batched run
    equals a sequential run with seed ``seeds[i]``, bitwise."""
    b, s = 2, 2
    xs = _x(8, b)
    cfg = teng.ShuffleSoftSortConfig(use_kernel=use_kernel, rounds=6,
                                     inner_steps=3, band=16)
    assert teng._band_switch_round(cfg, N) == 2
    seeds = [11, 12, 13, 14]
    res = teng.shuffle_soft_sort_batched(xs, HW, cfg, n_restarts=s,
                                         seeds=seeds, device="cpu")
    for i, seed in enumerate(seeds):
        order, _, losses = teng.shuffle_soft_sort(
            xs[i // s], HW, cfg, seed=seed, device="cpu")
        np.testing.assert_array_equal(res.all_orders[i // s, i % s], order)
        np.testing.assert_array_equal(
            res.all_losses[i // s, i % s], np.asarray(losses, np.float32))


def test_band_auto_anneals_banded_from_round_zero():
    """``band="auto"`` at N = 64 resolves to dense (K = 64 >= N - 1); at
    N = 256 to K = 64 with the switch at round 0, and the run anneals."""
    cfg = teng.ShuffleSoftSortConfig(use_kernel=True, rounds=4,
                                     inner_steps=2, band="auto")
    assert teng.resolve_band(cfg, 64) is None
    assert teng.resolve_band(cfg, 256) == 64
    assert teng._band_switch_round(cfg, 256) == 0
    xs = np.random.default_rng(2).random((1, 256, 3)).astype(np.float32)
    res = teng.shuffle_soft_sort_batched(xs, (16, 16), cfg, n_restarts=2,
                                         device="cpu")
    for row in res.all_orders.reshape(-1, 256):
        assert np.array_equal(np.sort(row), np.arange(256))
    assert np.isfinite(res.all_losses).all()
    assert (res.all_losses[..., -1] < res.all_losses[..., 0]).all()
