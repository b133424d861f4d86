"""The CUDA kernels of the port on the card, against their plain PyTorch
twins and the dense oracle.  Every test here is marked ``cuda`` and skips
without a CUDA device; the file imports neither JAX nor the reference
package, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Tolerances: float32 forward outputs atol 2e-5; gradients and backward
outputs atol 1e-4 x max-abs of the twin (the reference suite's gradient
bound); bfloat16 within the 2e-2 envelope of ``tests/test_precision.py``.
"""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels.ref import softsort_apply_ref  # noqa: E402

K = importlib.import_module("repro_torch.kernels.softsort_apply")

FWD_ATOL = 2e-5
GRAD_RTOL = 1e-4
BF16_RTOL = 2e-2


def _untied_keys(rng, shape, scale=3.0):
    """Keys with no bitwise-tied pair."""
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
    ws = np.sort(w, axis=-1, kind="stable")
    return w, ws, x, dy, dc, np.float32(0.6)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("bsz,n,d", [(8, 4096, 50), (3, 1000, 3), (1, 17, 1),
                                     (2, 300, 130)])
@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
def test_cuda_kernels_match_plain_twins(cuda, bsz, n, d, cd):
    """Each CUDA kernel against its plain twin on the same card tensors."""
    dt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[cd]
    rtol = GRAD_RTOL if cd == "float32" else BF16_RTOL
    w, ws, x, dy, dc, tau = _operands(bsz, n, d, seed=n + d)
    t = lambda a, dtype=torch.float32: torch.tensor(a, device=cuda).to(dtype)  # noqa: E731
    wt, wst, xt, tt = t(w), t(ws), t(x, dt), t(tau).reshape(1)
    dyt, dct = t(dy, dt), t(dc, dt)
    y, m, l = K.fwd_fused(wst, wt, xt, tt)
    y0, m0, l0 = K.fwd_fused_plain(wst, wt, xt, tt)
    _close(y.float().cpu(), y0.float().cpu(), rtol)
    _close(m.cpu(), m0.cpu(), FWD_ATOL)
    _close(l.cpu(), l0.cpu(), FWD_ATOL)
    _close(K.colsum(wst, wt, tt, m, l, dt).cpu(),
           K.colsum_plain(wst, wt, tt, m, l, dt).cpu(), rtol)
    D, dws = K.bwd_dws_delta(wst, wt, xt, tt, m, l, dyt, y, dct)
    D0, dws0 = K.bwd_dws_delta_plain(wst, wt, xt, tt, m, l, dyt, y, dct)
    _close(D.cpu(), D0.cpu(), rtol)
    _close(dws.cpu(), dws0.cpu(), rtol)
    out = K.bwd_dx(wst, wt, xt, tt, m, l, dyt, dct, D)
    ref = K.bwd_dx_plain(wst, wt, xt, tt, m, l, dyt, dct, D)
    for g, r in zip(out, ref):
        _close(g.float().cpu(), r.float().cpu(), rtol)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("cd", [torch.float32, torch.bfloat16])
def test_cuda_kernels_batch_invariant(cuda, cd):
    """An instance run alone gives bitwise its row of a batched run: no
    block reads another instance's data and no pass uses atomics."""
    w, ws, x, dy, dc, tau = _operands(4, 700, 70, seed=5)
    t = lambda a, dtype=torch.float32: torch.tensor(a, device=cuda).to(dtype)  # noqa: E731
    tt = t(tau).reshape(1)

    def run(sl):
        wt, wst, xt = t(w[sl]), t(ws[sl]), t(x[sl], cd)
        dyt, dct = t(dy[sl], cd), t(dc[sl], cd)
        y, m, l = K.fwd_fused(wst, wt, xt, tt)
        c = K.colsum(wst, wt, tt, m, l, cd)
        D, dws = K.bwd_dws_delta(wst, wt, xt, tt, m, l, dyt, y, dct)
        return (y, m, l, c, D, dws,
                *K.bwd_dx(wst, wt, xt, tt, m, l, dyt, dct, D))

    batched = run(slice(0, 4))
    alone = run(slice(2, 3))
    for b_out, a_out in zip(batched, alone):
        assert torch.equal(b_out[2], a_out[0])


@pytest.mark.cuda
def test_cuda_softsort_apply_matches_dense_oracle(cuda):
    """Values and gradients of the kernel route against the dense oracle.

    The keys are drawn as the anneal's are, a jittered permutation of
    0..N-1.  dtau is a sum of B N^2 terms that cancel, and the saved-y
    delta trick of the kernels (the reference's too) rounds it about ten
    times more coarsely than autograd through the dense softmax.  With
    keys as wide and irregular as 3 x normal draws at N = 1000, its error
    can pass 1e-4 of its value (ROADMAP.md Queue C2)."""
    rng = np.random.default_rng(3)
    keys = np.stack([rng.permutation(1000) for _ in range(3)]) + 0.8 * (
        rng.random((3, 1000)) - 0.5)
    w = torch.tensor(keys.astype(np.float32), device=cuda,
                     requires_grad=True)
    x = torch.tensor(rng.normal(size=(3, 1000, 3)).astype(np.float32),
                     device=cuda, requires_grad=True)
    a = torch.tensor(rng.normal(size=(3, 1000, 3)).astype(np.float32),
                     device=cuda)
    grads = []
    for fn in (tops.softsort_apply, softsort_apply_ref):
        tau = torch.tensor(0.4, device=cuda, requires_grad=True)
        y, c = fn(w, x, tau)
        loss = (y * a).sum() + c.square().sum()
        grads.append((y, c, *torch.autograd.grad(loss, (w, x, tau))))
    for g, r in zip(*grads):
        _close(g.detach().cpu(), r.detach().cpu(), GRAD_RTOL)


@pytest.mark.cuda
def test_cuda_launch_counts_and_no_fallback(cuda):
    """A CUDA call launches each kernel once per direction and counts it."""
    K.reset_launch_counts()
    w = torch.randn(2, 300, device=cuda, requires_grad=True)
    y, c = tops.softsort_apply(w, torch.randn(2, 300, 5, device=cuda), 0.5)
    (y.sum() + c.square().sum()).backward()
    torch.cuda.synchronize()
    assert K.launch_counts() == {"fwd_fused": 1, "colsum": 1,
                                 "bwd_dws_delta": 1, "bwd_dx": 1,
                                 "fwd_band": 0, "colsum_band": 0,
                                 "bwd_band_dws_delta": 0, "bwd_band_dcol": 0}


@pytest.mark.cuda
def test_cuda_engine_matches_cpu_engine(cuda):
    """The anneal through the CUDA kernels against the same anneal through
    the plain twins on the CPU, with the same replayed shuffles and
    normalization: equal orders and losses within rtol 1e-5 every round.
    The std term is off (``lambda_sigma=0``): with it on, cold rounds are
    not reproducible across implementations (ROADMAP.md Queue C1)."""
    from repro_torch.core import (ReplayShuffleSource, ShuffleSoftSortConfig,
                                  shuffle_soft_sort_batched)

    n, hw, bs, rounds = 256, (16, 16), 2, 6
    rng = np.random.default_rng(4)
    xs = rng.normal(size=(bs, n, 8)).astype(np.float32)
    shuffles = np.stack([[rng.permutation(n) for _ in range(bs)]
                         for _ in range(rounds)])
    cfg = ShuffleSoftSortConfig(use_kernel=True, rounds=rounds,
                                inner_steps=4, lambda_sigma=0.0)
    runs = {}
    for dev in ("cpu", cuda):
        rec = []
        shuffle_soft_sort_batched(
            xs, hw, cfg, device=dev, norms=np.ones(bs, np.float32),
            source=ReplayShuffleSource(shuffles, dev),
            callback=lambda r, o, l: rec.append((o, l)))
        runs[str(dev)] = rec
    for (o_cpu, l_cpu), (o_gpu, l_gpu) in zip(runs["cpu"], runs["cuda"]):
        np.testing.assert_array_equal(o_gpu, o_cpu)
        np.testing.assert_allclose(l_gpu, l_cpu, rtol=1e-5)


def _band_operands(bsz, n, d, seed, cuda, cd):
    """Sorted keys, payload in rank order, cotangents (dc in rank order)."""
    w, ws, x, dy, dc, tau = _operands(bsz, n, d, seed)
    t = lambda a, dtype=torch.float32: torch.tensor(a, device=cuda).to(dtype)  # noqa: E731
    return (t(ws), t(x, cd), t(tau).reshape(1), t(dy, cd), t(dc, cd))


def _band_pipeline(ws, xs, tau, dy, dc, k, plain=False):
    """Kernels 5-8 (or their twins) in order; all their outputs."""
    f = {name: getattr(K, name + ("_plain" if plain else ""))
         for name in ("fwd_band", "colsum_band", "bwd_band_dws_delta",
                      "bwd_band_dcol")}
    y, m, l = f["fwd_band"](ws, xs, tau, k)
    c = f["colsum_band"](ws, tau, m, l, k, xs.dtype)
    D, dws_row = f["bwd_band_dws_delta"](ws, xs, tau, m, l, dy, y, dc, k)
    return (y, m, l, c, D, dws_row,
            *f["bwd_band_dcol"](ws, xs, tau, m, l, dy, dc, D, k))


@pytest.mark.cuda
@pytest.mark.parametrize("bsz,n,d,k", [(8, 4096, 50, 256), (3, 1000, 3, 40),
                                       (1, 17, 1, 3), (2, 300, 130, 100)])
@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
def test_cuda_band_kernels_match_plain_twins(cuda, bsz, n, d, k, cd):
    """Each banded CUDA kernel against its plain twin on the same card
    tensors; the twins' backward takes the kernels' own y, m, l and D."""
    dt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[cd]
    rtol = GRAD_RTOL if cd == "float32" else BF16_RTOL
    ws, xs, tt, dyt, dct = _band_operands(bsz, n, d, n + d + k, cuda, dt)
    y, m, l = K.fwd_band(ws, xs, tt, k)
    y0, m0, l0 = K.fwd_band_plain(ws, xs, tt, k)
    _close(y.float().cpu(), y0.float().cpu(), rtol)
    _close(m.cpu(), m0.cpu(), FWD_ATOL)
    _close(l.cpu(), l0.cpu(), FWD_ATOL)
    _close(K.colsum_band(ws, tt, m, l, k, dt).cpu(),
           K.colsum_band_plain(ws, tt, m, l, k, dt).cpu(), rtol)
    D, dws = K.bwd_band_dws_delta(ws, xs, tt, m, l, dyt, y, dct, k)
    D0, dws0 = K.bwd_band_dws_delta_plain(ws, xs, tt, m, l, dyt, y, dct, k)
    _close(D.cpu(), D0.cpu(), rtol)
    _close(dws.cpu(), dws0.cpu(), rtol)
    out = K.bwd_band_dcol(ws, xs, tt, m, l, dyt, dct, D, k)
    ref = K.bwd_band_dcol_plain(ws, xs, tt, m, l, dyt, dct, D, k)
    for g, r in zip(out, ref):
        _close(g.float().cpu(), r.float().cpu(), rtol)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("cd", [torch.float32, torch.bfloat16])
def test_cuda_band_kernels_batch_invariant(cuda, cd):
    """Banded: an instance run alone gives bitwise its row of the batch."""
    ops_ = _band_operands(4, 700, 70, 5, cuda, cd)
    batched = _band_pipeline(*ops_, 33)
    alone = _band_pipeline(*[t[2:3].contiguous() if t.dim() > 1 else t
                             for t in ops_], 33)
    for b_out, a_out in zip(batched, alone):
        assert torch.equal(b_out[2], a_out[0])


@pytest.mark.cuda
def test_cuda_softsort_apply_banded_matches_oracle(cuda):
    """The banded Function on the card against the windowed oracle."""
    from repro_torch.core import softsort_apply_banded as oracle

    rng = np.random.default_rng(6)
    keys = np.stack([rng.permutation(1000) for _ in range(3)]) + 0.8 * (
        rng.random((3, 1000)) - 0.5)
    w = torch.tensor(keys.astype(np.float32), device=cuda,
                     requires_grad=True)
    x = torch.tensor(rng.normal(size=(3, 1000, 3)).astype(np.float32),
                     device=cuda, requires_grad=True)
    a = torch.tensor(rng.normal(size=(3, 1000, 3)).astype(np.float32),
                     device=cuda)
    grads = []
    for fn in (tops.softsort_apply_banded, oracle):
        tau = torch.tensor(0.4, device=cuda, requires_grad=True)
        y, c = fn(w, x, tau, 40)
        loss = (y * a).sum() + c.square().sum()
        grads.append((y, c, *torch.autograd.grad(loss, (w, x, tau))))
    for g, r in zip(*grads):
        _close(g.detach().cpu(), r.detach().cpu(), GRAD_RTOL)


@pytest.mark.cuda
def test_cuda_launch_counts_across_the_band_switch(cuda):
    """band=16 at N = 64, 6 rounds x 4 inner steps: rounds 0-1 dense,
    2-5 banded, each inner step one launch of each kernel of its tier."""
    from repro_torch.core import ShuffleSoftSortConfig, shuffle_soft_sort_batched

    cfg = ShuffleSoftSortConfig(use_kernel=True, rounds=6, inner_steps=4,
                                band=16)
    xs = np.random.default_rng(1).normal(size=(2, 64, 3)).astype(np.float32)
    K.reset_launch_counts()
    shuffle_soft_sort_batched(xs, (8, 8), cfg, n_restarts=2, device=cuda)
    torch.cuda.synchronize()
    counts = K.launch_counts()
    assert all(counts[k.__name__] == 8 for k in K.DENSE_KERNELS), counts
    assert all(counts[k.__name__] == 16 for k in K.BAND_KERNELS), counts
