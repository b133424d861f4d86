"""The v1 split forward of the port (kernels 9a/9b, ``v1_stats`` and
``v1_apply`` in ``repro_torch.kernels.softsort_apply``) and its
autograd wrapper ``repro_torch.kernels.ops.softsort_apply_v1``, against
the reference's v1 path.

On the CPU each kernel wrapper runs its plain twin.  The twins, with
``colsum`` as the third pass, are held to the JAX function
``softsort_apply_fwd_pallas_v1`` run in interpret mode on the same padded
operands (its y and colsum), and their m and l to the stats of the fused
Pallas forward, which are the same quantities.  ``tests/test_torch_cuda.py``
holds the CUDA kernels to the twins on the card.

Tolerances, as ``tests/test_torch_kernels.py``: forward y, colsum, m
atol 2e-5 and l rtol 2e-5 (float32 sums over N taken in other orders);
gradients atol 1e-4 x max-abs of the reference.
"""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels.softsort_apply import (  # noqa: E402
    softsort_apply_fwd_pallas,
    softsort_apply_fwd_pallas_v1,
)
from repro_torch.kernels import ops as tops  # noqa: E402

K = importlib.import_module("repro_torch.kernels.softsort_apply")

FWD_ATOL = 2e-5
GRAD_RTOL = 1e-4


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


@pytest.mark.parametrize("bsz,n,d", [(1, 16, 1), (3, 100, 3), (2, 300, 50)])
def test_v1_twins_match_jax_pallas_v1(bsz, n, d):
    """v1_stats, v1_apply and colsum twins against the Pallas v1
    forward (y, colsum) and the fused forward's m, l, on unpadded rows."""
    rng = np.random.default_rng(bsz * 100 + n + d)
    w = _untied_keys(rng, (bsz, n))
    x = rng.normal(size=(bsz, n, d)).astype(np.float32)
    ws = np.sort(w, axis=-1, kind="stable")
    tau = np.float32(0.6)

    br, bc, np_, dp = jops._block_geometry(n, d, 256, 256)
    _, ws_p, w_p, x_p = jops._pad_operands(jnp.asarray(w), jnp.asarray(x), n,
                                           np_, dp)
    tau_a = jnp.full((1, 1), tau, jnp.float32)
    y_j, c_j = softsort_apply_fwd_pallas_v1(ws_p, w_p, x_p, tau_a, n=n, br=br,
                                            bc=bc, interpret=True)
    _, _, m_j, l_j = softsort_apply_fwd_pallas(ws_p, w_p, x_p, tau_a, n=n,
                                               br=br, bc=bc, interpret=True)

    wst, wt, xt = torch.tensor(ws), torch.tensor(w), torch.tensor(x)
    tt = torch.tensor(tau).reshape(1)
    m, l = K.v1_stats(wst, wt, tt)
    y = K.v1_apply(wst, wt, xt, tt, m, l)
    c = K.colsum(wst, wt, tt, m, l)
    np.testing.assert_allclose(m.numpy(), np.asarray(m_j[:, :n, 0]),
                               atol=FWD_ATOL)
    np.testing.assert_allclose(l.numpy(), np.asarray(l_j[:, :n, 0]),
                               rtol=FWD_ATOL)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_j[:, :n, :d]),
                               atol=FWD_ATOL)
    np.testing.assert_allclose(c.numpy(), np.asarray(c_j[:, 0, :n]),
                               atol=FWD_ATOL)


def _port_v1(w, x, a, b, tau, bwd_chunk):
    """Values and (dw, dx, dtau) of sum(y a) + sum(colsum^2 b), port."""
    wt = torch.tensor(w, requires_grad=True)
    xt = torch.tensor(x, requires_grad=True)
    tt = torch.tensor(tau, requires_grad=True)
    y, c = tops.softsort_apply_v1(wt, xt, tt, bwd_chunk=bwd_chunk)
    loss = (y * torch.tensor(a)).sum() + (c.square() * torch.tensor(b)).sum()
    grads = torch.autograd.grad(loss, (wt, xt, tt))
    return (y.detach().numpy(), c.detach().numpy(),
            *[g.numpy() for g in grads])


def _jax_v1(w, x, a, b, tau, bwd_chunk):
    """The same through the reference's v1 custom_vjp."""
    def loss_fn(w, x, tau):
        y, c = jops.softsort_apply_v1(w, x, tau, 256, 256, bwd_chunk)
        return jnp.sum(y * a) + jnp.sum(jnp.square(c) * b), (y, c)

    (_, (y, c)), grads = jax.value_and_grad(
        loss_fn, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(w), jnp.asarray(x), jnp.float32(tau))
    return (np.asarray(y), np.asarray(c), *[np.asarray(g) for g in grads])


@pytest.mark.parametrize("n,d,bsz", [(64, 3, 1), (300, 8, 2), (384, 8, 2)])
@pytest.mark.parametrize("bwd_chunk", [256, 100])
def test_softsort_apply_v1_matches_jax(n, d, bsz, bwd_chunk):
    """The v1 Function on the CPU against the reference's
    ``softsort_apply_v1``: y, colsum and the gradients of w, x and tau.
    B = 1 runs unbatched (N,) keys; N = 384 is a ragged multi-block case
    for both chunk sizes."""
    rng = np.random.default_rng(n + d + bsz + bwd_chunk)
    shape = (n,) if bsz == 1 else (bsz, n)
    w = _untied_keys(rng, shape)
    x = rng.normal(size=shape + (d,)).astype(np.float32)
    a = rng.normal(size=shape + (d,)).astype(np.float32)
    b = rng.normal(size=shape).astype(np.float32)
    got = _port_v1(w, x, a, b, np.float32(0.7), bwd_chunk)
    want = _jax_v1(w, x, a, b, np.float32(0.7), bwd_chunk)
    np.testing.assert_allclose(got[0], want[0], atol=FWD_ATOL)
    np.testing.assert_allclose(got[1], want[1], atol=FWD_ATOL)
    for g, r in zip(got[2:], want[2:]):
        _close(g, r, GRAD_RTOL)


def test_v1_gradients_match_fused():
    """The port's v1 and fused paths implement the same math (as the
    reference's test_fused_matches_v1_baseline_gradients holds them)."""
    rng = np.random.default_rng(77)
    w = torch.tensor((rng.normal(size=129) * 2).astype(np.float32))
    x = torch.tensor(rng.normal(size=(129, 5)).astype(np.float32))
    a = torch.tensor(rng.normal(size=(129, 5)).astype(np.float32))
    b = torch.tensor(rng.normal(size=129).astype(np.float32))
    grads = []
    for fn in (tops.softsort_apply, tops.softsort_apply_v1):
        args = [w.clone().requires_grad_(True), x.clone().requires_grad_(True),
                torch.tensor(0.8, requires_grad=True)]
        y, c = fn(*args)
        grads.append(torch.autograd.grad((y * a).sum() + (c * b).sum(),
                                         args))
    for g, r in zip(*grads):
        _close(g.numpy(), r.numpy(), GRAD_RTOL)


def test_v1_cpu_route_launches_nothing_and_rejects_bf16():
    """CPU tensors run the twins (no launch counted); the v1 kernels take
    a float32 payload only."""
    K.reset_launch_counts()
    w = torch.randn(2, 30, requires_grad=True)
    y, c = tops.softsort_apply_v1(w, torch.randn(2, 30, 4), 0.5)
    (y.sum() + c.sum()).backward()
    assert K.launch_counts()["v1_stats"] == K.launch_counts()["v1_apply"] == 0
    with pytest.raises(ValueError):
        K._check_f32(torch.zeros(1, 4, 2, dtype=torch.bfloat16))
