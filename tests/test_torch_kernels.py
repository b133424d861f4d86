"""The four dense SoftSort-apply kernels of the port
(``repro_torch.kernels.softsort_apply``) and their autograd wrapper
(``repro_torch.kernels.ops.softsort_apply``).

On the CPU each kernel wrapper runs its plain PyTorch twin; those twins
are held to the JAX Pallas drivers (``softsort_apply_fwd_pallas`` and
``softsort_apply_bwd_pallas``), run in interpret mode on the same padded
operands as the JAX wrapper builds, comparing only the unpadded outputs.
``tests/test_torch_cuda.py`` holds each CUDA kernel to its twin on the
card.

Tolerances:

* forward ``y``, ``colsum``, ``m``, ``l``: atol 2e-5 (``l`` relative to its
  size) — float32 sums over N columns taken in different orders;
* ``dws``/``dw``, ``dx``, ``dtau`` and their per-column partials: atol
  1e-4 x max-abs of the reference, the reference suite's gradient bound;
* bfloat16 twins: the 2e-2 envelope of ``tests/test_precision.py``
  (relative to the output's max-abs) — bf16 rounding of scores and
  payload happens at different points in the two frameworks.
"""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels.softsort_apply import (  # noqa: E402
    softsort_apply_bwd_pallas,
    softsort_apply_fwd_pallas,
)
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels.ref import softsort_apply_ref  # noqa: E402

K = importlib.import_module("repro_torch.kernels.softsort_apply")

FWD_ATOL = 2e-5
GRAD_RTOL = 1e-4
BF16_RTOL = 2e-2
SHAPES = [(b, n, d) for b in (1, 3) for n in (16, 100) for d in (1, 3, 50)]


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


def _operands(bsz, n, d, seed):
    rng = np.random.default_rng(seed)
    w = _untied_keys(rng, (bsz, n))
    x = rng.normal(size=(bsz, n, d)).astype(np.float32)
    dy = rng.normal(size=(bsz, n, d)).astype(np.float32)
    dc = rng.normal(size=(bsz, n)).astype(np.float32)
    perm = np.argsort(w, axis=-1, kind="stable")
    ws = np.take_along_axis(w, perm, axis=-1)
    return w, ws, x, dy, dc, np.float32(0.6)


def _jax_drivers(w, ws, x, dy, dc, tau, y_for_bwd, cd=jnp.float32):
    """Both JAX Pallas drivers in interpret mode on the wrapper's padded
    layout, sliced back to the unpadded outputs."""
    bsz, n, d = x.shape
    br, bc, np_, dp = jops._block_geometry(n, d, 256, 256)
    _, ws_p, w_p, x_p = jops._pad_operands(jnp.asarray(w), jnp.asarray(x), n,
                                           np_, dp, cd=cd)
    tau_a = jnp.full((1, 1), tau, jnp.float32)
    y, c, m, l = softsort_apply_fwd_pallas(ws_p, w_p, x_p, tau_a, n=n, br=br,
                                           bc=bc, interpret=True)
    pad3 = ((0, 0), (0, np_ - n), (0, dp - d))
    y_res = jnp.pad(jnp.asarray(y_for_bwd), pad3).astype(cd)
    dy_p = jnp.pad(jnp.asarray(dy), pad3).astype(cd)
    dc_p = jnp.pad(jnp.asarray(dc), ((0, 0), (0, np_ - n))).reshape(
        bsz, 1, np_).astype(cd)
    dws, dwc, dx, dtc = softsort_apply_bwd_pallas(
        ws_p, w_p, x_p, tau_a, m, l, y_res, dy_p, dc_p, n=n, br=br, bc=bc,
        interpret=True)
    f = np.float32
    return dict(
        y=np.asarray(y[:, :n, :d].astype(jnp.float32)), c=np.asarray(c[:, 0, :n]),
        m=np.asarray(m[:, :n, 0]), l=np.asarray(l[:, :n, 0]),
        dws=np.asarray(dws[:, :n, 0], f), dwc=np.asarray(dwc[:, 0, :n], f),
        dx=np.asarray(dx[:, :n, :d].astype(jnp.float32)),
        dtc=np.asarray(dtc[:, 0, :n], f))


def _torch_twins(w, ws, x, dy, dc, tau, cd=torch.float32):
    t = torch.tensor
    wt, wst, xt = t(w), t(ws), t(x).to(cd)
    tt = t(tau).reshape(1)
    y, m, l = K.fwd_fused(wst, wt, xt, tt)
    c = K.colsum(wst, wt, tt, m, l, cd)
    dyt, dct = t(dy).to(cd), t(dc).to(cd)
    D, dws = K.bwd_dws_delta(wst, wt, xt, tt, m, l, dyt, y, dct)
    dx, dwc, dtc = K.bwd_dx(wst, wt, xt, tt, m, l, dyt, dct, D)
    f = torch.float32
    return dict(y=y.to(f).numpy(), c=c.numpy(), m=m.numpy(), l=l.numpy(),
                dws=dws.numpy(), dwc=dwc.numpy(), dx=dx.to(f).numpy(),
                dtc=dtc.numpy())


@pytest.mark.parametrize("bsz,n,d", SHAPES)
def test_plain_twins_match_jax_pallas_kernels(bsz, n, d):
    """Kernels 1-4: each twin against its Pallas kernel.  The backward
    drivers take the twin's own y as the saved residual, so each pass is
    compared on identical inputs."""
    w, ws, x, dy, dc, tau = _operands(bsz, n, d, seed=bsz * 1000 + n + d)
    got = _torch_twins(w, ws, x, dy, dc, tau)
    want = _jax_drivers(w, ws, x, dy, dc, tau, got["y"])
    for key in ("y", "c", "m"):
        np.testing.assert_allclose(got[key], want[key], atol=FWD_ATOL,
                                   err_msg=key)
    np.testing.assert_allclose(got["l"], want["l"], rtol=FWD_ATOL)
    for key in ("dws", "dwc", "dx", "dtc"):
        _close(got[key], want[key], GRAD_RTOL)


@pytest.mark.parametrize("bsz,n,d", [(1, 16, 3), (3, 100, 50)])
def test_plain_twins_bf16_match_jax_pallas_kernels(bsz, n, d):
    """The bfloat16 instantiation: scores and payload rounded to bf16,
    stats and accumulators float32."""
    w, ws, x, dy, dc, tau = _operands(bsz, n, d, seed=7 + n + d)
    got = _torch_twins(w, ws, x, dy, dc, tau, cd=torch.bfloat16)
    want = _jax_drivers(w, ws, x, dy, dc, tau, got["y"], cd=jnp.bfloat16)
    for key in ("y", "c", "dws", "dwc", "dx", "dtc"):
        _close(got[key], want[key], BF16_RTOL)


def _torch_apply_grads(w, x, a, b, tau):
    """Values and (dw, dx, dtau) of sum(y a) + sum(colsum^2 b), port."""
    wt = torch.tensor(w, requires_grad=True)
    xt = torch.tensor(x, requires_grad=True)
    tt = torch.tensor(tau, requires_grad=True)
    y, c = tops.softsort_apply(wt, xt, tt)
    loss = (y * torch.tensor(a)).sum() + (c.square() * torch.tensor(b)).sum()
    grads = torch.autograd.grad(loss, (wt, xt, tt))
    return (y.detach().numpy(), c.detach().numpy(),
            *[g.numpy() for g in grads])


def _jax_apply_grads(w, x, a, b, tau):
    """The same through the reference's custom_vjp."""
    def loss_fn(w, x, tau):
        y, c = jops.softsort_apply(w, x, tau)
        return jnp.sum(y * a) + jnp.sum(jnp.square(c) * b), (y, c)

    (_, (y, c)), grads = jax.value_and_grad(
        loss_fn, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(w), jnp.asarray(x), jnp.float32(tau))
    return (np.asarray(y), np.asarray(c), *[np.asarray(g) for g in grads])


@pytest.mark.parametrize("bsz,n,d", [(1, 16, 1), (3, 100, 3), (3, 100, 50)])
def test_softsort_apply_matches_jax_ops(bsz, n, d):
    """The CPU route of the autograd.Function against the JAX custom_vjp:
    values and the gradients of w, x and tau."""
    rng = np.random.default_rng(bsz + n + d)
    w = _untied_keys(rng, (bsz, n))
    x = rng.normal(size=(bsz, n, d)).astype(np.float32)
    a = rng.normal(size=(bsz, n, d)).astype(np.float32)
    b = rng.normal(size=(bsz, n)).astype(np.float32)
    got = _torch_apply_grads(w, x, a, b, np.float32(0.7))
    want = _jax_apply_grads(w, x, a, b, np.float32(0.7))
    np.testing.assert_allclose(got[0], want[0], atol=FWD_ATOL)
    np.testing.assert_allclose(got[1], want[1], atol=FWD_ATOL)
    for g, r in zip(got[2:], want[2:]):
        _close(g, r, GRAD_RTOL)


def test_softsort_apply_unbatched_and_descending():
    """(N,) keys and ``descending`` (a flip of y) against the dense oracle."""
    rng = np.random.default_rng(11)
    w = torch.tensor(_untied_keys(rng, (40,)))
    x = torch.tensor(rng.normal(size=(40, 3)).astype(np.float32))
    y, c = tops.softsort_apply(w, x, 0.5)
    yr, cr = softsort_apply_ref(w, x, 0.5)
    np.testing.assert_allclose(y.numpy(), yr.numpy(), atol=FWD_ATOL)
    np.testing.assert_allclose(c.numpy(), cr.numpy(), atol=FWD_ATOL)
    yd, cd = tops.softsort_apply(w, x, 0.5, descending=True)
    np.testing.assert_allclose(yd.numpy(), torch.flip(yr, (0,)).numpy(),
                               atol=FWD_ATOL)
    np.testing.assert_allclose(cd.numpy(), cr.numpy(), atol=FWD_ATOL)


def test_cpu_route_never_launches_kernels():
    """CPU tensors go to the plain twins; the launch counters count only
    kernel launches."""
    K.reset_launch_counts()
    w = torch.randn(2, 30, requires_grad=True)
    y, c = tops.softsort_apply(w, torch.randn(2, 30, 4), 0.5)
    (y.sum() + c.sum()).backward()
    assert K.launch_counts() == {"fwd_fused": 0, "colsum": 0,
                                 "bwd_dws_delta": 0, "bwd_dx": 0,
                                 "fwd_band": 0, "colsum_band": 0,
                                 "bwd_band_dws_delta": 0, "bwd_band_dcol": 0}


def test_wrappers_reject_mixed_and_unknown_devices():
    w = torch.zeros(1, 4)
    with pytest.raises(ValueError):
        K.fwd_fused(w, w.to("meta"), torch.zeros(1, 4, 2), torch.ones(1))
