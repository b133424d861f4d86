"""The CUDA kernels of the port on the card, against their plain PyTorch
twins and the oracles: the SoftSort apply (dense, banded, v1) and the
flash-attention forward.  Every test here is marked ``cuda`` and skips
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


def _dense_operands(bsz, n, d, seed, cuda, cd):
    """Row keys ws drawn independently of the column keys w (sorted, but
    not sort(w): the row maximum is not -0), payload, cotangents."""
    w, _, x, dy, dc, tau = _operands(bsz, n, d, seed)
    ws = np.sort(_untied_keys(np.random.default_rng(seed + 1), (bsz, n)),
                 axis=-1)
    t = lambda a, dtype=torch.float32: torch.tensor(a, device=cuda).to(dtype)  # noqa: E731
    return (t(ws), t(w), t(x, cd), t(tau).reshape(1), t(dy, cd), t(dc, cd))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 3, 14, 30, 50, 64, 65, 130])
@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
@pytest.mark.parametrize("tau", [0.05, 0.6])
def test_cuda_dense_fwd_and_dx_match_plain_twins(cuda, d, cd, tau):
    """Kernels 1 and 4 (the bodies of 5 and 8 with K = N) at every payload
    tile (16, 32, 64, 2 x 64, 3 x 64) and ragged widths; N = 1000 is no
    multiple of any row or column tile, and ws is independent of w, so
    kernel 1's first sweep finds maxima other than -0.  Its m is the
    twin's bitwise: the maximum of the same rounded scores."""
    dt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[cd]
    rtol = GRAD_RTOL if cd == "float32" else BF16_RTOL
    ws, w, x, tt, dy, dc = _dense_operands(2, 1000, d, 50 + d, cuda, dt)
    tt = tt * (tau / 0.6)
    y, m, l = K.fwd_fused(ws, w, x, tt)
    y0, m0, l0 = K.fwd_fused_plain(ws, w, x, tt)
    _close(y.float().cpu(), y0.float().cpu(),
           FWD_ATOL if cd == "float32" else rtol)
    assert torch.equal(m, m0)
    assert bool((m < 0).any())
    _close(l.cpu(), l0.cpu(), FWD_ATOL)
    D, _ = K.bwd_dws_delta_plain(ws, w, x, tt, m, l, dy, y, dc)
    out = K.bwd_dx(ws, w, x, tt, m, l, dy, dc, D)
    ref = K.bwd_dx_plain(ws, w, x, tt, m, l, dy, dc, D)
    for g, r in zip(out, ref):
        _close(g.float().cpu(), r.float().cpu(), rtol)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("d", [14, 50])
@pytest.mark.parametrize("cd", [torch.float32, torch.bfloat16])
def test_cuda_dense_fwd_and_dx_batch_invariant(cuda, d, cd):
    """Kernels 1 and 4 at the Self-Organizing-Gaussians width and the
    main run's: an instance run alone gives bitwise its row of the batch
    (kernel 4 on the batch's own m, l and D)."""
    ws, w, x, tt, dy, dc = _dense_operands(3, 2000, d, 13 + d, cuda, cd)
    y, m, l = K.fwd_fused(ws, w, x, tt)
    D, _ = K.bwd_dws_delta(ws, w, x, tt, m, l, dy, y, dc)

    def run(sl):
        ws_, w_, x_, m_, l_, dy_, dc_, D_ = (t[sl].contiguous() for t in (
            ws, w, x, m, l, dy, dc, D))
        return (*K.fwd_fused(ws_, w_, x_, tt),
                *K.bwd_dx(ws_, w_, x_, tt, m_, l_, dy_, dc_, D_))

    for b_out, a_out in zip(run(slice(0, 3)), run(slice(1, 2))):
        assert torch.equal(b_out[1], a_out[0])


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 3, 14, 30, 50, 64, 65, 130])
@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
@pytest.mark.parametrize("tau", [0.05, 0.6])
@pytest.mark.parametrize("keys", ["independent", "sorted"])
def test_cuda_dense_colsum_and_dws_match_plain_twins(cuda, d, cd, tau, keys):
    """Kernels 2 and 3 (the bodies of 6 and 7 with K = N and column keys
    w) at every payload tile of kernel 3 (16, 32, 64, 2 x 64, 3 x 64) and
    ragged widths; N = 1000 is no multiple of any row, column or step
    tile.  Row keys drawn apart from w, or sort(w) (one tied column per
    row, sgn 0).  Both take kernel 1's own y, m and l."""
    dt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[cd]
    rtol = GRAD_RTOL if cd == "float32" else BF16_RTOL
    ws, w, x, tt, dy, dc = _dense_operands(2, 1000, d, 70 + d, cuda, dt)
    if keys == "sorted":
        ws = torch.sort(w, dim=-1, stable=True).values
    tt = tt * (tau / 0.6)
    y, m, l = K.fwd_fused(ws, w, x, tt)
    _close(K.colsum(ws, w, tt, m, l, dt).cpu(),
           K.colsum_plain(ws, w, tt, m, l, dt).cpu(),
           FWD_ATOL if cd == "float32" else rtol)
    D, dws = K.bwd_dws_delta(ws, w, x, tt, m, l, dy, y, dc)
    D0, dws0 = K.bwd_dws_delta_plain(ws, w, x, tt, m, l, dy, y, dc)
    _close(D.cpu(), D0.cpu(), rtol)
    _close(dws.cpu(), dws0.cpu(), rtol)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("d", [14, 50])
@pytest.mark.parametrize("cd", [torch.float32, torch.bfloat16])
def test_cuda_dense_colsum_and_dws_batch_invariant(cuda, d, cd):
    """Kernels 2 and 3 at the Self-Organizing-Gaussians width and the
    main run's: an instance run alone, on the batch's own y, m and l,
    gives bitwise its row of the batch."""
    ws, w, x, tt, dy, dc = _dense_operands(3, 2000, d, 17 + d, cuda, cd)
    y, m, l = K.fwd_fused(ws, w, x, tt)

    def run(sl):
        ws_, w_, x_, m_, l_, dy_, y_, dc_ = (t[sl].contiguous() for t in (
            ws, w, x, m, l, dy, y, dc))
        return (K.colsum(ws_, w_, tt, m_, l_, cd),
                *K.bwd_dws_delta(ws_, w_, x_, tt, m_, l_, dy_, y_, dc_))

    for b_out, a_out in zip(run(slice(0, 3)), run(slice(1, 2))):
        assert torch.equal(b_out[1], a_out[0])


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
                                 "bwd_band_dws_delta": 0, "bwd_band_dcol": 0,
                                 "v1_stats": 0, "v1_apply": 0}


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
@pytest.mark.parametrize("d", [1, 14, 16, 17, 33, 64, 65, 130])
@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
@pytest.mark.parametrize("tau", [0.6, -0.6])
def test_cuda_band_fwd_and_dcol_match_plain_twins(cuda, d, cd, tau):
    """Kernels 5 and 8 at every payload tile (16, 32, 64, 2 x 64, 3 x 64)
    and ragged widths; N = 1000 is no multiple of any row or column tile
    and K = 150 none of a tile but larger than each, so interior and edge
    tiles both occur.  tau = -0.6 takes kernel 5's exact-maximum branch;
    for tau > 0 its m is -0.0 in every row."""
    dt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[cd]
    rtol = GRAD_RTOL if cd == "float32" else BF16_RTOL
    k = 150
    ws, xs, tt, dyt, dct = _band_operands(2, 1000, d, 40 + d, cuda, dt)
    tt = tt * np.sign(tau)
    y, m, l = K.fwd_band(ws, xs, tt, k)
    y0, m0, l0 = K.fwd_band_plain(ws, xs, tt, k)
    _close(y.float().cpu(), y0.float().cpu(),
           FWD_ATOL if cd == "float32" else rtol)
    _close(m.cpu(), m0.cpu(), FWD_ATOL)
    _close(l.cpu(), l0.cpu(), FWD_ATOL)
    if tau > 0:
        assert bool((m == 0).all()) and bool(torch.signbit(m).all())
    D, _ = K.bwd_band_dws_delta_plain(ws, xs, tt, m, l, dyt, y, dct, k)
    out = K.bwd_band_dcol(ws, xs, tt, m, l, dyt, dct, D, k)
    ref = K.bwd_band_dcol_plain(ws, xs, tt, m, l, dyt, dct, D, k)
    for g, r in zip(out, ref):
        _close(g.float().cpu(), r.float().cpu(), rtol)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("cd", [torch.float32, torch.bfloat16])
def test_cuda_band_fwd_and_dcol_batch_invariant_at_d14(cuda, cd):
    """Kernels 5 and 8 at the Self-Organizing-Gaussians width d = 14: an
    instance run alone gives bitwise its row of the batch."""
    ops_ = _band_operands(3, 2000, 14, 11, cuda, cd)
    batched = _band_pipeline(*ops_, 300)
    alone = _band_pipeline(*[t[1:2].contiguous() if t.dim() > 1 else t
                             for t in ops_], 300)
    for b_out, a_out in zip(batched, alone):
        assert torch.equal(b_out[1], a_out[0])


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 14, 16, 17, 33, 64, 65, 130])
@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
@pytest.mark.parametrize("tau", [0.6, -0.6])
@pytest.mark.parametrize("k", [3, 24, 150, 1500])
def test_cuda_band_colsum_and_dws_match_plain_twins(cuda, d, cd, tau, k):
    """Kernels 6 and 7 at every payload tile of kernel 7 (16, 32, 64,
    2 x 64, 3 x 64) and ragged widths; N = 1000 is no multiple of any row,
    column or step tile.  K = 3 and 24 are narrower than a tile, K = 150
    is wider (interior and edge tiles both occur), and K = 1500 >= N puts
    every pair in the band.  Both take kernel 5's own y, m and l; tau =
    -0.6 gives rows whose maximum is not -0."""
    dt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[cd]
    rtol = GRAD_RTOL if cd == "float32" else BF16_RTOL
    ws, xs, tt, dyt, dct = _band_operands(2, 1000, d, 40 + d + k, cuda, dt)
    tt = tt * np.sign(tau)
    y, m, l = K.fwd_band(ws, xs, tt, k)
    _close(K.colsum_band(ws, tt, m, l, k, dt).cpu(),
           K.colsum_band_plain(ws, tt, m, l, k, dt).cpu(),
           FWD_ATOL if cd == "float32" else rtol)
    D, dws = K.bwd_band_dws_delta(ws, xs, tt, m, l, dyt, y, dct, k)
    D0, dws0 = K.bwd_band_dws_delta_plain(ws, xs, tt, m, l, dyt, y, dct, k)
    _close(D.cpu(), D0.cpu(), rtol)
    _close(dws.cpu(), dws0.cpu(), rtol)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("cd", [torch.float32, torch.bfloat16])
def test_cuda_band_colsum_and_dws_batch_invariant_at_d14(cuda, cd):
    """Kernels 6 and 7 at the Self-Organizing-Gaussians width d = 14: an
    instance run alone, on the batch's own y, m and l, gives bitwise its
    row of the batch."""
    k = 300
    ws, xs, tt, dyt, dct = _band_operands(3, 2000, 14, 12, cuda, cd)
    y, m, l = K.fwd_band(ws, xs, tt, k)

    def run(sl):
        ws_, xs_, m_, l_, dy_, y_, dc_ = (t[sl].contiguous() for t in (
            ws, xs, m, l, dyt, y, dct))
        return (K.colsum_band(ws_, tt, m_, l_, k, cd),
                *K.bwd_band_dws_delta(ws_, xs_, tt, m_, l_, dy_, y_, dc_, k))

    for b_out, a_out in zip(run(slice(0, 3)), run(slice(1, 2))):
        assert torch.equal(b_out[1], a_out[0])


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


def _v1_operands(bsz, n, d, seed, cuda):
    w, ws, x, _, _, tau = _operands(bsz, n, d, seed)
    t = lambda a: torch.tensor(a, device=cuda)  # noqa: E731
    return t(ws), t(w), t(x), t(tau).reshape(1)


@pytest.mark.cuda
@pytest.mark.parametrize("bsz,n,d", [(8, 4096, 50), (3, 1000, 3), (1, 17, 1),
                                     (2, 300, 130)])
def test_cuda_v1_kernels_match_plain_twins(cuda, bsz, n, d):
    """v1_stats and v1_apply (float32 only) against their twins; the
    apply twin takes the kernel's own m and l.  m is the twin's bitwise:
    the maximum of the same scores."""
    ws, w, x, tt = _v1_operands(bsz, n, d, n + d, cuda)
    m, l = K.v1_stats(ws, w, tt)
    m0, l0 = K.v1_stats_plain(ws, w, tt)
    assert torch.equal(m, m0)
    np.testing.assert_allclose(l.cpu(), l0.cpu(), rtol=FWD_ATOL)
    y = K.v1_apply(ws, w, x, tt, m, l)
    np.testing.assert_allclose(y.cpu(), K.v1_apply_plain(ws, w, x, tt, m,
                                                         l).cpu(),
                               atol=FWD_ATOL)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 3, 8, 14, 30, 50, 64, 65, 130])
@pytest.mark.parametrize("independent", [False, True])
@pytest.mark.parametrize("tau", [0.05, 0.6])
def test_cuda_v1_kernels_at_every_payload_tile(cuda, d, independent, tau):
    """9b, kernel 1's body with m and l given, at every payload tile (16,
    32, 64, 2 x 64, 3 x 64) and ragged widths; N = 1000 is no multiple of
    a row tile.  Row keys sort(w) (m = -0) or drawn apart from w (9a finds
    maxima below 0): m the twin's bitwise, l and y within FWD_ATOL."""
    ws, w, x, tt, _, _ = _dense_operands(2, 1000, d, 90 + d, cuda,
                                         torch.float32)
    if not independent:
        ws = torch.sort(w, dim=-1, stable=True).values
    tt = torch.full_like(tt, tau)
    m, l = K.v1_stats(ws, w, tt)
    m0, l0 = K.v1_stats_plain(ws, w, tt)
    assert torch.equal(m, m0)
    assert bool((m < 0).any()) == independent
    np.testing.assert_allclose(l.cpu(), l0.cpu(), rtol=FWD_ATOL)
    y = K.v1_apply(ws, w, x, tt, m, l)
    y0 = K.v1_apply_plain(ws, w, x, tt, m, l)
    np.testing.assert_allclose(y.cpu(), y0.cpu(), atol=FWD_ATOL)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("d", [3, 8, 50, 70, 130])
@pytest.mark.parametrize("independent", [False, True])
def test_cuda_v1_kernels_batch_invariant(cuda, d, independent):
    """v1 at each payload tile, row keys sort(w) or drawn apart from w:
    an instance run alone gives bitwise its row of the batch."""
    ws, w, x, tt, _, _ = _dense_operands(4, 700, d, 5 + d, cuda,
                                         torch.float32)
    if not independent:
        ws = torch.sort(w, dim=-1, stable=True).values

    def run(sl):
        wss, wsl = ws[sl].contiguous(), w[sl].contiguous()
        m, l = K.v1_stats(wss, wsl, tt)
        return m, l, K.v1_apply(wss, wsl, x[sl].contiguous(), tt, m, l)

    for b_out, a_out in zip(run(slice(0, 4)), run(slice(2, 3))):
        assert torch.equal(b_out[2], a_out[0])


@pytest.mark.cuda
def test_cuda_softsort_apply_v1_matches_fused(cuda):
    """The v1 Function on the card: values and gradients against the
    fused Function (the same math), and one launch of each v1 kernel and
    of colsum per forward."""
    rng = np.random.default_rng(8)
    keys = np.stack([rng.permutation(1000) for _ in range(3)]) + 0.8 * (
        rng.random((3, 1000)) - 0.5)
    w = torch.tensor(keys.astype(np.float32), device=cuda,
                     requires_grad=True)
    x = torch.tensor(rng.normal(size=(3, 1000, 3)).astype(np.float32),
                     device=cuda, requires_grad=True)
    a = torch.tensor(rng.normal(size=(3, 1000, 3)).astype(np.float32),
                     device=cuda)
    grads = []
    for fn in (tops.softsort_apply_v1, tops.softsort_apply):
        K.reset_launch_counts()
        tau = torch.tensor(0.4, device=cuda, requires_grad=True)
        y, c = fn(w, x, tau)
        loss = (y * a).sum() + c.square().sum()
        grads.append((y, c, *torch.autograd.grad(loss, (w, x, tau))))
        if fn is tops.softsort_apply_v1:
            counts = K.launch_counts()
            assert (counts["v1_stats"], counts["v1_apply"],
                    counts["colsum"], counts["fwd_fused"]) == (1, 1, 1, 0)
    for g, r in zip(*grads):
        _close(g.detach().cpu(), r.detach().cpu(), GRAD_RTOL)


# (B, Tq, S, H, Hkv, Dh, causal, q_offset): tests/test_flash_attention.py's
# cases, a negative offset (rows with no key), ragged T and Dh (100, and 30,
# which takes the 4-byte copies), and the NeMo decode step.
FLASH_SHAPES = [(2, 64, 64, 4, 2, 32, True, 0),
                (1, 100, 100, 5, 5, 16, True, 0),
                (2, 1, 128, 8, 2, 64, True, 127),
                (2, 48, 80, 6, 3, 32, False, 0),
                (1, 256, 256, 2, 1, 128, True, 0),
                (1, 70, 90, 4, 1, 100, True, -5),
                (1, 50, 300, 6, 2, 30, True, 3),
                (1, 1, 4096, 32, 8, 128, True, 4095)]


def _flash_operands(b, tq, s, h, hkv, dh, seed, cuda):
    rng = np.random.default_rng(seed)
    f = lambda *shape: torch.tensor(  # noqa: E731
        rng.normal(size=shape).astype(np.float32), device=cuda)
    return f(b, tq, h, dh), f(b, s, hkv, dh), f(b, s, hkv, dh)


@pytest.mark.cuda
@pytest.mark.parametrize("splits", [1, 5, None])
@pytest.mark.parametrize("shape", FLASH_SHAPES)
def test_cuda_flash_kernels_match_plain_twins(cuda, shape, splits):
    """flash_forward (and flash_combine) on the model layout read in place,
    at one key split, at five and at decode_splits' count, against the
    twins on folded card tensors: m and l against the stats twin, o against
    the apply twin fed the kernel's own m and l and against the one-pass
    twin at the same split count; one launch of flash_forward, and one of
    flash_combine exactly when the keys split."""
    from repro_torch.kernels import flash_ops

    F = importlib.import_module("repro_torch.kernels.flash_attention")
    b, tq, s, h, hkv, dh, causal, off = shape
    ops_ = _flash_operands(b, tq, s, h, hkv, dh, tq + s, cuda)
    q, k, v = (flash_ops.fold_heads(t) for t in ops_)
    n = F.split_plan(s, splits if splits is not None else
                     F.decode_splits(b * hkv, h // hkv * tq, s))[0]
    for kern in F.KERNELS:
        kern.launches = 0
    o, m, l = F.flash_forward(*(flash_ops.heads_major(t) for t in ops_),
                              causal, off, splits)
    torch.cuda.synchronize()
    assert (F.flash_forward.launches, F.flash_combine.launches) == (
        1, int(n > 1))
    o, m, l = o.reshape(q.shape), m.reshape(q.shape[:2]), l.reshape(
        q.shape[:2])
    m0, l0 = F.flash_stats_plain(q, k, causal, off)
    np.testing.assert_allclose(m.cpu(), m0.cpu(), atol=FWD_ATOL)
    np.testing.assert_allclose(l.cpu(), l0.cpu(), rtol=FWD_ATOL)
    o0 = F.flash_apply_plain(q, k, v, m, l, causal, off)
    np.testing.assert_allclose(o.cpu(), o0.cpu(), atol=FWD_ATOL)
    o1, m1, l1 = F.flash_forward_plain(q, k, v, causal, off, n)
    np.testing.assert_allclose(o.cpu(), o1.cpu(), atol=FWD_ATOL)
    np.testing.assert_allclose(m.cpu(), m1.cpu(), atol=FWD_ATOL)
    np.testing.assert_allclose(l.cpu(), l1.cpu(), rtol=FWD_ATOL)


@pytest.mark.cuda
def test_cuda_flash_forward_strided_matches_contiguous(cuda):
    """The kernel on the model layout read in place and on the contiguous
    folded planes gives the same o, m and l, with and without splits."""
    from repro_torch.kernels import flash_ops

    F = importlib.import_module("repro_torch.kernels.flash_attention")
    ops_ = _flash_operands(2, 40, 130, 8, 2, 16, 6, cuda)
    for splits in (1, 3):
        got = F.flash_forward(*(flash_ops.heads_major(t) for t in ops_),
                              True, 90, splits)
        want = F.flash_forward(*(flash_ops.fold_heads(t) for t in ops_),
                               True, 90, splits)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.reshape(w.shape).cpu(), w.cpu(),
                                       atol=FWD_ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 64, 64, 4, 2, 32, True, 0),
                                   (1, 70, 90, 4, 1, 100, True, -5),
                                   (2, 48, 80, 6, 3, 32, False, 0),
                                   (1, 1, 300, 8, 2, 64, True, 299)])
def test_cuda_flash_attention_matches_oracle(cuda, shape):
    """The Function on the card: output and dq, dk, dv against the
    oracle's autograd, one launch of flash_forward per forward, and one
    of flash_combine when the keys split (the decode step)."""
    from repro_torch.kernels import (flash_attention, flash_attention_ref,
                                     launch_counts, reset_launch_counts)

    F = importlib.import_module("repro_torch.kernels.flash_attention")
    b, tq, s, h, hkv, dh, causal, off = shape
    q, k, v = _flash_operands(b, tq, s, h, hkv, dh, 3, cuda)
    dout = torch.randn(q.shape, device=cuda)
    results = []
    for fn in (lambda *a: flash_attention(*a, causal, off, 16),
               lambda *a: flash_attention_ref(*a, causal=causal,
                                              q_offset=off)):
        reset_launch_counts()
        args = [t.clone().requires_grad_(True) for t in (q, k, v)]
        o = fn(*args)
        results.append((o, *torch.autograd.grad(o, args, dout)))
        if len(results) == 1:
            counts = launch_counts()
            split = F.decode_splits(b * hkv, h // hkv * tq, s) > 1
            assert (counts["flash_forward"], counts["flash_combine"]) == (
                1, int(split))
    for g, r in zip(*results):
        _close(g.detach().cpu(), r.detach().cpu(), GRAD_RTOL)


# ------------------------------------------------ one temperature per instance

TAUS4 = (0.05, 0.2, 0.6, 1.0)


def _tau_pipeline(kind, ops, tau, cd, plain=False):
    """Every kernel of one tier (or its twins) on ``ops`` with ``tau``; all
    their outputs, in launch order."""
    f = lambda name: getattr(K, name + ("_plain" if plain else ""))  # noqa: E731
    if kind == "banded":
        ws, xs, dy, dc, k = ops
        return _band_pipeline(ws, xs, tau, dy, dc, k, plain=plain)
    ws, w, x, dy, dc = ops
    if kind == "v1":
        m, l = f("v1_stats")(ws, w, tau)
        return m, l, f("v1_apply")(ws, w, x, tau, m, l)
    y, m, l = f("fwd_fused")(ws, w, x, tau)
    c = f("colsum")(ws, w, tau, m, l, cd)
    D, dws = f("bwd_dws_delta")(ws, w, x, tau, m, l, dy, y, dc)
    return (y, m, l, c, D, dws, *f("bwd_dx")(ws, w, x, tau, m, l, dy, dc, D))


def _tau_operands(kind, cuda, cd):
    bsz, n, d = 4, 1000, 50
    ws, w, x, _, dy, dc = _dense_operands(bsz, n, d, 77, cuda, cd)
    if kind == "banded":
        return (torch.sort(w, dim=-1).values, x, dy, dc, 150)
    return ws, w, x, dy, dc


@pytest.mark.cuda
@pytest.mark.parametrize("kind,cd", [("dense", torch.float32),
                                     ("dense", torch.bfloat16),
                                     ("banded", torch.float32),
                                     ("banded", torch.bfloat16),
                                     ("v1", torch.float32)])
def test_cuda_kernels_per_instance_tau(cuda, kind, cd):
    """B = 4 instances at tau = (0.05, 0.2, 0.6, 1.0), each kernel reading
    its instance's tau[b]: every output against the twins at the same
    (B,) tau; row b bitwise the B = 1 launch at tau_b; and one shared tau
    bitwise its B-fold expansion."""
    rtol = GRAD_RTOL if cd == torch.float32 else BF16_RTOL
    ops = _tau_operands(kind, cuda, cd)
    taus = torch.tensor(TAUS4, device=cuda)
    outs = _tau_pipeline(kind, ops, taus, cd)
    twins = _tau_pipeline(kind, ops, taus, cd, plain=True)
    for got, want in zip(outs, twins):
        _close(got.float().cpu(), want.float().cpu(), rtol)
    for b in range(4):
        row = [t[b:b + 1].contiguous() if isinstance(t, torch.Tensor)
               else t for t in ops]
        alone = _tau_pipeline(kind, row, taus[b:b + 1], cd)
        for got, want in zip(alone, outs):
            assert torch.equal(got[0], want[b]), (kind, b)
    shared = _tau_pipeline(kind, ops, taus[2:3], cd)
    expanded = _tau_pipeline(kind, ops, taus[2:3].expand(4).contiguous(), cd)
    for a, e in zip(shared, expanded):
        assert torch.equal(a, e)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("band", [None, "auto"])
def test_cuda_adaptive_run_matches_cpu_engine(cuda, band):
    """The adaptive schedule on the card against the same run through the
    plain twins on the CPU, with forced firing (patience 1, plateau_rtol
    1), the std term off (warm, ROADMAP.md Queue C1), replayed shuffles
    and the same normalization: the same rung decisions, rounds executed
    and orders, losses within rtol 1e-5."""
    from repro_torch.core import (ReplayShuffleSource, ShuffleSoftSortConfig,
                                  make_adaptive_controller)
    from repro_torch.core.shufflesoftsort import _run_adaptive

    n, hw, bs, rounds = 256, (16, 16), 3, 8
    rng = np.random.default_rng(6)
    xs = rng.normal(size=(bs, n, 8)).astype(np.float32)
    shuffles = np.stack([[rng.permutation(n) for _ in range(bs)]
                         for _ in range(rounds)])
    cfg = ShuffleSoftSortConfig(
        use_kernel=True, rounds=rounds, inner_steps=4, lambda_sigma=0.0,
        band=band, band_eps=1e3, schedule="adaptive", patience=1,
        plateau_rtol=1.0, adapt_every=2)
    runs = {}
    for dev in ("cpu", cuda):
        ctrl = make_adaptive_controller(cfg, bs, n)
        orders, losses, _ = _run_adaptive(
            torch.tensor(xs, device=dev),
            torch.arange(n, device=dev).repeat(bs, 1),
            ReplayShuffleSource(shuffles, dev), torch.ones(bs, device=dev),
            hw=hw, cfg=cfg, controller=ctrl)
        runs[str(dev)] = (orders.cpu().numpy(), losses, ctrl)
    (o_cpu, l_cpu, c_cpu), (o_gpu, l_gpu, c_gpu) = runs["cpu"], runs["cuda"]
    assert c_gpu.decisions == c_cpu.decisions
    assert any(d.fired for d in c_cpu.decisions)
    assert (band is None) == (not any(d.switched for d in c_cpu.decisions))
    np.testing.assert_array_equal(c_gpu.executed, c_cpu.executed)
    np.testing.assert_array_equal(o_gpu, o_cpu)
    np.testing.assert_array_equal(np.isnan(l_gpu), np.isnan(l_cpu))
    np.testing.assert_allclose(l_gpu, l_cpu, rtol=1e-5)


@pytest.mark.cuda
def test_cuda_adaptive_parting_instances_match_cpu_engine(cuda):
    """The instances that part ways of ``tests/test_torch_adaptive.py``
    (``PART``, ``_parting_xs``), on the card against the CPU engine: on a
    rising temperature schedule the random problem's loss falls and the
    sorted field's rises, so only the field's instances fire at the second
    boundary; at band 4 one field instance goes banded at the first and
    the rest stay dense.  The third rung runs a dense dispatch at
    positions (4, 4, 6) beside a banded one.  The same decisions,
    positions, regimes, rounds executed and orders; losses within rtol
    1e-5.  (The field is smooth: on a near-constant ramp the losses are
    too ill-conditioned to compare at 1e-5.)"""
    from repro_torch.core import (ReplayShuffleSource, ShuffleSoftSortConfig,
                                  make_adaptive_controller)
    from repro_torch.core.shufflesoftsort import _run_adaptive

    n, hw, d, bs, rounds = 64, (8, 8), 3, 4, 8
    rng = np.random.default_rng(31)
    r, c = np.divmod(np.arange(n), hw[1])
    field = np.stack([r / hw[0], c / hw[1], np.sin(r / 2.0)], 1)
    xs = np.stack([rng.normal(size=(n, d)),
                   field + 1e-2 * rng.normal(size=(n, d))]).astype(np.float32)
    xs = np.repeat(xs, 2, axis=0)
    shuffles = np.stack([[rng.permutation(n) for _ in range(bs)]
                         for _ in range(rounds)])
    cfg = ShuffleSoftSortConfig(
        use_kernel=True, rounds=rounds, inner_steps=3, chunk=n,
        lambda_sigma=0.0, band=4, band_eps=0.05, schedule="adaptive",
        patience=1, plateau_rtol=0.02, adapt_every=2, tau_start=0.2,
        tau_end=1.0)
    runs, seen = {}, []
    for dev in ("cpu", cuda):
        ctrl = make_adaptive_controller(cfg, bs, n)
        observe = ctrl.observe

        def spy(idx, losses, ws=None, ctrl=ctrl, observe=observe):
            seen.append((str(dev), ctrl.pos[idx].copy(),
                         ctrl.banded[idx].copy()))
            return observe(idx, losses, ws)

        ctrl.observe = spy
        orders, losses, _ = _run_adaptive(
            torch.tensor(xs, device=dev),
            torch.arange(n, device=dev).repeat(bs, 1),
            ReplayShuffleSource(shuffles, dev), torch.ones(bs, device=dev),
            hw=hw, cfg=cfg, controller=ctrl)
        runs[str(dev)] = (orders.cpu().numpy(), losses, ctrl)
    (o_cpu, l_cpu, c_cpu), (o_gpu, l_gpu, c_gpu) = runs["cpu"], runs["cuda"]
    # The run parted: a rung whose dense group holds several positions,
    # and a rung with a dense and a banded group.
    assert any(len(set(pos[~banded])) > 1 and banded.any() and
               not banded.all() for dev, pos, banded in seen if dev == "cpu")
    assert (c_cpu.executed < rounds).any() and (c_cpu.executed == rounds).any()
    assert c_gpu.decisions == c_cpu.decisions
    for f in ("pos", "executed", "done", "banded", "plateau", "fired"):
        np.testing.assert_array_equal(getattr(c_gpu, f), getattr(c_cpu, f))
    np.testing.assert_array_equal(o_gpu, o_cpu)
    np.testing.assert_array_equal(np.isnan(l_gpu), np.isnan(l_cpu))
    np.testing.assert_allclose(l_gpu, l_cpu, rtol=1e-5)


def _tournament_problem(b, s, n, rounds, seed):
    rng = np.random.default_rng(seed)
    xs = rng.normal(size=(b, n, 8)).astype(np.float32)
    shuffles = np.stack([[rng.permutation(n) for _ in range(b * s)]
                         for _ in range(rounds)])
    return xs, shuffles


@pytest.mark.cuda
@pytest.mark.parametrize("schedule", ["fixed", "adaptive"])
def test_cuda_tournament_matches_cpu_engine(cuda, schedule):
    """``restart_tournament`` through the CUDA kernels against the same
    tournament through the plain twins on the CPU (replayed shuffles, the
    same normalization, the std term off: ROADMAP.md Queue C1): the same
    survivors, rounds run and orders, losses within rtol 1e-5, NaN where
    a restart was culled or stopped.  Each cull's margin between the last
    kept and the first culled loss exceeds that tolerance."""
    from repro_torch.core import (ReplayShuffleSource, ShuffleSoftSortConfig,
                                  restart_tournament)

    n, hw, b, s = 256, (16, 16), 2, 4
    extra = (dict(rounds=6) if schedule == "fixed" else
             dict(rounds=8, schedule="adaptive", patience=1,
                  plateau_rtol=1.0, adapt_every=2))
    cfg = ShuffleSoftSortConfig(use_kernel=True, inner_steps=4,
                                lambda_sigma=0.0, band="auto", **extra)
    xs, shuffles = _tournament_problem(b, s, n, cfg.rounds, seed=8)
    runs = {}
    for dev in ("cpu", cuda):
        runs[str(dev)] = restart_tournament(
            xs, hw, cfg, n_restarts=s, device=dev,
            norms=np.ones(b, np.float32), cull_fraction=0.5, n_rungs=3,
            source=ReplayShuffleSource(shuffles, dev))
    cpu, gpu = runs["cpu"], runs["cuda"]
    live = np.tile(np.arange(s), (b, 1))
    for end, sv in zip(_ends(cfg), cpu.survivors[:-1]):
        for p in range(b):
            heads = [cpu.all_losses[p, r, :end] for r in live[p]]
            ranked = np.sort([h[~np.isnan(h)][-1] for h in heads])
            keep = sv.shape[1]
            assert ranked[keep] - ranked[keep - 1] > 1e-5 * ranked[keep]
        live = sv
    for a, c in zip(gpu.survivors, cpu.survivors):
        np.testing.assert_array_equal(a, c)
    assert gpu.rounds_run == cpu.rounds_run < gpu.rounds_full
    np.testing.assert_array_equal(gpu.order, cpu.order)
    np.testing.assert_array_equal(gpu.best_restart, cpu.best_restart)
    np.testing.assert_array_equal(np.isnan(gpu.all_losses),
                                  np.isnan(cpu.all_losses))
    np.testing.assert_allclose(gpu.all_losses, cpu.all_losses, rtol=1e-5)


def _ends(cfg):
    """The executed rounds at each tournament edge of a 3-rung run."""
    from repro_torch.core.shufflesoftsort import _rung_boundaries

    if cfg.schedule == "fixed":
        return _rung_boundaries(cfg.rounds, 3)
    seg = cfg.adapt_every
    return [e * seg for e in _rung_boundaries(cfg.rounds // seg, 3)]


@pytest.mark.cuda
@pytest.mark.parametrize("band", [None, "auto"])
def test_cuda_tournament_survivors_bitwise_their_batched_rows(cuda, band):
    """On the card, with the std term on: every restart alive at the end
    of a tournament of 2 problems x 8 restarts (16, then 8, then 4 live
    instances) has the loss trace of its row of the no-cull batched run
    bitwise, and each winner its order.  The kernels are bitwise
    batch-invariant; the loss runs in blocks of 8 instances, so the
    PyTorch reductions around them are too."""
    from repro_torch.core import (ShuffleSoftSortConfig, restart_tournament,
                                  shuffle_soft_sort_batched)

    n, hw, b, s = 256, (16, 16), 2, 8
    cfg = ShuffleSoftSortConfig(use_kernel=True, rounds=6, inner_steps=4,
                                band=band)
    xs, _ = _tournament_problem(b, s, n, 1, seed=9)
    res = restart_tournament(xs, hw, cfg, n_restarts=s, seed=3, device=cuda,
                             cull_fraction=0.5, n_rungs=3)
    twin = shuffle_soft_sort_batched(xs, hw, cfg, n_restarts=s, seed=3,
                                     device=cuda)
    assert [sv.shape[1] for sv in res.survivors] == [4, 2, 2]
    for p in range(b):
        for r in res.survivors[-1][p]:
            np.testing.assert_array_equal(res.all_losses[p, r],
                                          twin.all_losses[p, r])
        w = res.best_restart[p]
        np.testing.assert_array_equal(res.order[p], twin.all_orders[p, w])


@pytest.mark.cuda
@pytest.mark.parametrize("band", [None, "auto"])
def test_cuda_segment_matches_cpu_engine_and_each_instance_alone(cuda, band):
    """``run_round_segment`` on the card over 4 instances at rounds 0 and
    2: the CPU engine's orders and losses (rtol 1e-5, std term off), and
    on the card each row bitwise the instance run alone."""
    from repro_torch.core import (ReplayShuffleSource, ShuffleSoftSortConfig,
                                  run_round_segment)

    n, hw, rounds = 256, (16, 16), 6
    cfg = ShuffleSoftSortConfig(use_kernel=True, rounds=rounds,
                                inner_steps=4, lambda_sigma=0.0, band=band)
    xs, shuffles = _tournament_problem(4, 1, n, rounds, seed=10)
    progress = np.array([0, 0, 2, 2])
    orders = np.stack([np.random.default_rng(i).permutation(n)
                       for i in range(4)])

    def segment(dev, rows):
        src = ReplayShuffleSource(shuffles[:, rows], dev)
        src.pos[:] = progress[rows]
        o, l = run_round_segment(xs[rows], orders[rows], np.ones(len(rows)),
                                 progress[rows], 2, source=src, hw=hw,
                                 cfg=cfg, device=dev)
        return o.cpu().numpy(), l.cpu().numpy()

    o_cpu, l_cpu = segment("cpu", np.arange(4))
    o_gpu, l_gpu = segment(cuda, np.arange(4))
    np.testing.assert_array_equal(o_gpu, o_cpu)
    np.testing.assert_allclose(l_gpu, l_cpu, rtol=1e-5)
    for i in range(4):
        o_i, l_i = segment(cuda, np.array([i]))
        np.testing.assert_array_equal(o_i[0], o_gpu[i])
        np.testing.assert_array_equal(l_i[:, 0], l_gpu[:, i])
