"""The CUDA kernels of the port on the card, against their plain PyTorch
twins and the oracles: the SoftSort apply (dense, banded, v1), the
flash-attention forward and the threefry bits; and the LM zoo's serving
and training on the card against the host.  Every test here is marked ``cuda`` and skips
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
    twin at the same split count; one launch of flash_forward, merging 2
    to 8 key splits in its cluster epilogue, and one of flash_combine
    exactly when the keys split into more."""
    from repro_torch.kernels import flash_ops

    F = importlib.import_module("repro_torch.kernels.flash_attention")
    b, tq, s, h, hkv, dh, causal, off = shape
    ops_ = _flash_operands(b, tq, s, h, hkv, dh, tq + s, cuda)
    q, k, v = (flash_ops.fold_heads(t) for t in ops_)
    n = F.split_plan(s, splits if splits is not None else
                     F.decode_splits(b * hkv, h // hkv * tq, s, dh,
                                     cuda))[0]
    for kern in F.KERNELS:
        kern.launches = 0
    F.flash_forward.cluster_launches = 0
    o, m, l = F.flash_forward(*(flash_ops.heads_major(t) for t in ops_),
                              causal, off, splits)
    torch.cuda.synchronize()
    assert (F.flash_forward.launches, F.flash_combine.launches,
            F.flash_forward.cluster_launches) == (
        1, int(n > F.MAX_CLUSTER), int(F.merges_in_cluster(n)))
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
    oracle's autograd, one launch of flash_forward per forward, merging
    in its cluster epilogue when the keys split (the decode step) into 2
    to 8 ranges, and one of flash_combine when into more."""
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
            n = F.split_plan(s, F.decode_splits(b * hkv, h // hkv * tq,
                                                s, dh, cuda))[0]
            assert (counts["flash_forward"], counts["flash_combine"],
                    counts["flash_forward_cluster"]) == (
                1, int(n > F.MAX_CLUSTER), int(F.merges_in_cluster(n)))
    for g, r in zip(*results):
        _close(g.detach().cpu(), r.detach().cpu(), GRAD_RTOL)


# (B, Tq, S, H, Hkv, Dh, causal, q_offset) of the cluster merge: 1000 keys
# are 16 tiles, so 2, 3, 4 and 8 splits are exact; decode (16-row tiles),
# a causal block with an offset and one with rows that see no key (64-row
# tiles), no mask.
CLUSTER_SHAPES = [(2, 1, 1000, 8, 2, 0, True, 999),
                  (1, 40, 1000, 4, 2, 0, True, 960),
                  (1, 70, 1000, 4, 1, 0, True, -5),
                  (2, 3, 1000, 6, 3, 0, False, 0)]


@pytest.mark.cuda
@pytest.mark.parametrize("dh", [30, 64, 128])
@pytest.mark.parametrize("splits", [2, 3, 4, 8])
@pytest.mark.parametrize("shape", CLUSTER_SHAPES)
def test_cuda_flash_cluster_merge_is_bitwise_the_two_launch_path(
        cuda, shape, splits, dh):
    """flash_forward merging its key splits in the cluster epilogue: o, m
    and l bitwise flash_forward_split + flash_combine on the same
    operands, in one launch counted on flash_forward and
    flash_forward_cluster, none of flash_combine; Dh 30 ends each row in
    a part of a four-column group."""
    from repro_torch.kernels import (flash_ops, launch_counts,
                                     reset_launch_counts)

    F = importlib.import_module("repro_torch.kernels.flash_attention")
    b, tq, s, h, hkv, _, causal, off = shape
    views = [flash_ops.heads_major(t) for t in _flash_operands(
        b, tq, s, h, hkv, dh, splits + dh, cuda)]
    assert F.split_plan(s, splits)[0] == splits
    assert F.row_tile(h // hkv * tq) == (16 if h // hkv * tq <= 16 else 64)
    reset_launch_counts()
    got = F.flash_forward(*views, causal, off, splits)
    torch.cuda.synchronize()
    counts = launch_counts()
    assert (counts["flash_forward"], counts["flash_forward_cluster"],
            counts["flash_combine"]) == (1, 1, 0)
    want = F.flash_combine(*F.flash_forward_split(*views, causal, off,
                                                  splits))
    for g, w in zip(got, want):
        assert torch.equal(g.reshape(w.shape), w)


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


# ------------------------------------------- checkpoints and guardrails

CHILD_DRAWS = r"""
import sys
import numpy as np
import torch
sys.path.insert(0, sys.argv[1])
from repro_torch.core.prng import TorchShuffleSource
src = TorchShuffleSource([1, 2, 3], 4096, "cuda")
src.load_state_dict(np.load(sys.argv[2]))
np.save(sys.argv[3], torch.stack([src.next_round() for _ in range(3)])
        .cpu().numpy())
"""


@pytest.mark.cuda
def test_cuda_generator_state_roundtrip(cuda, tmp_path):
    """A card generator's state (a Philox seed and offset, read on the
    host) set again gives the same draws bitwise, in this process and in
    a fresh one; it never loads into a CPU generator."""
    import os
    import subprocess
    import sys

    from repro_torch.core.prng import TorchShuffleSource

    src = TorchShuffleSource([1, 2, 3], 4096, cuda)
    src.next_round([0, 2])
    st = src.state_dict()
    assert st.dtype == np.uint8 and st.shape[0] == 3
    want = torch.stack([src.next_round() for _ in range(3)]).cpu().numpy()
    src.load_state_dict(st)
    got = torch.stack([src.next_round() for _ in range(3)]).cpu().numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        src.advanced(st, None, 3), src.state_dict())
    np.save(tmp_path / "state.npy", st)
    src_dir = os.path.join(os.path.dirname(__file__), "..", "src")
    subprocess.run([sys.executable, "-c", CHILD_DRAWS, src_dir,
                    str(tmp_path / "state.npy"), str(tmp_path / "draws.npy")],
                   check=True, timeout=300)
    np.testing.assert_array_equal(np.load(tmp_path / "draws.npy"), want)
    with pytest.raises(ValueError):
        TorchShuffleSource([1, 2, 3], 4096, "cpu").load_state_dict(st)


def _ckpt_problem(b=2, n=1024, d=20, seed=0):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(b, n, d)).astype(np.float32), (32, n // 32)


@pytest.mark.cuda
@pytest.mark.parametrize("band", [None, "auto"])
def test_cuda_kill_and_resume_bitwise_on_the_kernel_tier(cuda, tmp_path,
                                                          band):
    """Kill at every rung on the card's kernel tier: each supervised
    resume is bitwise the uninterrupted run; a card checkpoint does not
    resume on the CPU (a ``ValueError``, no fallback)."""
    from repro_torch.core import (ShuffleSoftSortConfig,
                                  shuffle_soft_sort_batched)
    from repro_torch.runtime.fault_tolerance import (AnnealSupervisor,
                                                     FaultInjector,
                                                     RetryPolicy)

    xs, hw = _ckpt_problem()
    cfg = ShuffleSoftSortConfig(rounds=8, inner_steps=4, use_kernel=True,
                                band=band)

    def run(**kw):
        return shuffle_soft_sort_batched(xs, hw, cfg, n_restarts=2, seed=3,
                                         device=cuda, checkpoint_every=2,
                                         **kw)

    ref = shuffle_soft_sort_batched(xs, hw, cfg, n_restarts=2, seed=3,
                                    device=cuda)
    for k in range(4):
        hook = FaultInjector(lambda start: None, fail_calls={k})
        sup = AnnealSupervisor(lambda a, b_, c, **kw: run(**kw),
                               checkpoint_dir=str(tmp_path / f"k{k}"),
                               retry=RetryPolicy(backoff_base_s=0.0))
        got = sup.run(None, None, None, rung_hook=hook)
        assert hook.faults == 1
        np.testing.assert_array_equal(got.all_orders, ref.all_orders)
        np.testing.assert_array_equal(got.all_losses, ref.all_losses)
    with pytest.raises(ValueError, match="source"):
        shuffle_soft_sort_batched(xs, hw, cfg, n_restarts=2, seed=3,
                                  device="cpu", checkpoint_every=2,
                                  checkpoint_dir=str(tmp_path / "k0"),
                                  resume=True)


@pytest.mark.cuda
@pytest.mark.parametrize("schedule", ["fixed", "adaptive"])
def test_cuda_guarded_run_is_bitwise_the_unguarded_run(cuda, schedule):
    """The invariants on the kernel tier, and the shadow at rate 1 on the
    dense plain tier, leave the results bitwise.  The shadow on the kernel
    tier is refused on the card (the next test); the banded plain tier is
    not bitwise reproducible on the card (its colsum and gather backward
    accumulate with atomics), so the shadow there may fire too (ROADMAP.md
    Queue C8)."""
    from repro_torch.core import (ShuffleSoftSortConfig,
                                  shuffle_soft_sort_batched)
    from repro_torch.runtime.guardrails import (GuardrailMonitor,
                                                GuardrailPolicy)

    xs, hw = _ckpt_problem(seed=1)
    extra = (dict(schedule="adaptive", adapt_every=2, patience=1,
                  plateau_rtol=0.02) if schedule == "adaptive" else {})
    for policy, use_kernel, band in (
            (GuardrailPolicy(mode="invariants"), True, "auto"),
            (GuardrailPolicy(mode="shadow", shadow_rate=1.0), False, None)):
        cfg = ShuffleSoftSortConfig(rounds=8, inner_steps=4, band=band,
                                    use_kernel=use_kernel, **extra)
        ref = shuffle_soft_sort_batched(xs, hw, cfg, n_restarts=2, seed=4,
                                        device=cuda)
        mon = GuardrailMonitor(policy)
        got = shuffle_soft_sort_batched(xs, hw, cfg, n_restarts=2, seed=4,
                                        device=cuda, checkpoint_every=2,
                                        guardrail=mon)
        assert mon.rungs_checked >= 1 and not mon.incidents
        if policy.mode == "shadow":
            assert mon.rungs_shadowed == mon.rungs_checked
        np.testing.assert_array_equal(got.all_orders, ref.all_orders)
        np.testing.assert_array_equal(got.all_losses, ref.all_losses)


@pytest.mark.cuda
@pytest.mark.parametrize("schedule", ["fixed", "adaptive"])
def test_cuda_shadow_is_clean_on_every_tier(cuda, schedule):
    """The rate-1 shadow (a bitwise same-tier replay, and on the kernel
    tier the kernel-vs-plain apply check) on the card: on the dense and
    the banded kernel tier and the banded plain tier, every engine's
    guarded run has no incident and is bitwise its unguarded run."""
    from repro_torch.core import (ShuffleSoftSortConfig, TorchShuffleSource,
                                  restart_tournament, run_round_segment,
                                  shuffle_soft_sort,
                                  shuffle_soft_sort_batched)
    from repro_torch.runtime.guardrails import (GuardrailMonitor,
                                                GuardrailPolicy)

    xs, hw = _ckpt_problem(n=256)
    n = xs.shape[1]
    extra = (dict(schedule="adaptive", adapt_every=2, patience=1)
             if schedule == "adaptive" else {})
    for tier in (dict(use_kernel=True), dict(use_kernel=True, band="auto"),
                 dict(band="auto")):
        cfg = ShuffleSoftSortConfig(rounds=4, inner_steps=2, **tier, **extra)
        fixed = ShuffleSoftSortConfig(rounds=4, inner_steps=2, **tier)
        runs = {
            "sequential": lambda g: shuffle_soft_sort(
                xs[0], hw, cfg, device=cuda, guardrail=g,
                checkpoint_every=1),
            "batched": lambda g: shuffle_soft_sort_batched(
                xs, hw, cfg, n_restarts=2, device=cuda, guardrail=g,
                checkpoint_every=1),
            "tournament": lambda g: restart_tournament(
                xs, hw, cfg, n_restarts=2, n_rungs=2, device=cuda,
                guardrail=g),
            "segment": lambda g: run_round_segment(
                xs, np.tile(np.arange(n), (2, 1)), np.ones(2, np.float32),
                np.zeros(2, np.int64), 2,
                source=TorchShuffleSource([1, 2], n, cuda), hw=hw, cfg=fixed,
                device=cuda, guardrail=g),
        }
        for name, run in runs.items():
            ref = run(None)
            mon = GuardrailMonitor(GuardrailPolicy(mode="shadow",
                                                   shadow_rate=1.0))
            got = run(mon)
            assert mon.rungs_shadowed >= 1 and not mon.incidents, (tier, name)
            for a, b in zip(_fields(ref), _fields(got)):
                np.testing.assert_array_equal(a, b, err_msg=f"{tier} {name}")


def _fields(res):
    """An engine result's arrays, whatever the engine."""
    if isinstance(res, tuple):
        return [np.asarray(torch.as_tensor(v).cpu()) if isinstance(
            v, torch.Tensor) else np.asarray(v) for v in res]
    return [np.asarray(v) for v in vars(res).values()
            if isinstance(v, np.ndarray)]


@pytest.mark.cuda
@pytest.mark.parametrize("k", [8, 64])
def test_cuda_plain_banded_apply_is_bitwise_repeatable(cuda, k):
    """Two calls of the plain banded apply (``core.softsort_apply_banded``,
    whose windows and column sums are fixed-order diagonal sums, with no
    atomics) give the same bits in y, colsum, dw and dx on the card."""
    from repro_torch.core.softsort import softsort_apply_banded

    gen = torch.Generator().manual_seed(k)
    w = (torch.randn(3, 1000, generator=gen) * 30).to(cuda)
    x = torch.randn(3, 1000, 50, generator=gen).to(cuda)
    gy = torch.randn(3, 1000, 50, generator=gen).to(cuda)
    gc = torch.randn(3, 1000, generator=gen).to(cuda)
    tau = torch.tensor([0.2, 0.5, 1.0], device=cuda)

    def once():
        wv, xv = w.clone().requires_grad_(True), x.clone().requires_grad_(True)
        y, c = softsort_apply_banded(wv, xv, tau, k)
        dw, dx = torch.autograd.grad((y * gy).sum() + (c * gc).sum(),
                                     (wv, xv))
        return [t.detach().cpu().numpy() for t in (y, c, dw, dx)]

    for a, b in zip(once(), once()):
        assert a.tobytes() == b.tobytes()


@pytest.mark.cuda
def test_cuda_served_request_is_bitwise_its_solo_chain(cuda):
    """Mixed traffic on the card's kernel tier: a dense bucket (N = 64)
    and a banded one (N = 256, ``band="auto"``), requests joining at
    different rungs so that one dispatch mixes schedule positions; each
    served request is bitwise its own chained ``run_round_segment`` run
    alone (same seed, same norm)."""
    from repro_torch.core import (ShuffleSoftSortConfig, TorchShuffleSource,
                                  mean_pairwise_distance, run_round_segment)
    from repro_torch.launch.serve import SortServer

    cfg = ShuffleSoftSortConfig(rounds=8, inner_steps=2, use_kernel=True,
                                band="auto")
    rng = np.random.default_rng(5)
    shapes = [((8, 8), 3), ((16, 16), 5)]
    server = SortServer((8, 8), d=3, cfg=cfg, max_batch=8, sched_rungs=4,
                        autostart=False, device=cuda)
    futs, probs = [], []
    for i in range(6):
        hw, d = shapes[i % 2]
        x = rng.random((hw[0] * hw[1], d), dtype=np.float32)
        futs.append(server.submit(x, key=100 + i, hw=hw))
        probs.append((hw, x, 100 + i))
        if i % 2:
            server._tick()
    for _ in range(16):
        server._tick()
    server.close()
    assert max(server.stats["batch_sizes"]) > 1
    for fut, (hw, x, seed) in zip(futs, probs):
        order, _, losses = fut.result(timeout=0)
        n = x.shape[0]
        x_t = torch.as_tensor(x, device=cuda)
        norm = float(mean_pairwise_distance(x_t))
        src = TorchShuffleSource([seed], n, cuda)
        o, parts = torch.arange(n, device=cuda)[None], []
        for p0 in range(0, 8, 2):
            o, ls = run_round_segment(x_t[None], o, [norm], [p0], 2,
                                      source=src, hw=hw, cfg=cfg,
                                      device=cuda)
            parts.append(ls[:, 0].cpu().numpy())
        np.testing.assert_array_equal(order, o[0].cpu().numpy())
        np.testing.assert_array_equal(losses, np.concatenate(parts))


# ------------------------------------------------- the mesh on the card

@pytest.mark.cuda
@pytest.mark.parametrize("band", [None, "auto"])
def test_cuda_sharded_engines_are_bitwise_unsharded(cuda, band):
    """Meshes of 1, 3 and 8 slots of this card on the kernel tier (std
    term on): the fixed engine at B x S = 12 (padded to 15 / 16), the
    adaptive engine with forced firing, a tournament and a segment are
    bitwise ``mesh=None``: the kernels are batch-invariant and every
    slot's loss runs in blocks of 8 instances."""
    from repro_torch.core import (ShuffleSoftSortConfig, TorchShuffleSource,
                                  restart_tournament, run_round_segment,
                                  shuffle_soft_sort_batched)
    from repro_torch.launch.mesh import make_sort_mesh

    n, hw = 256, (16, 16)
    xs, _ = _tournament_problem(3, 1, n, 1, seed=12)
    fire = dict(schedule="adaptive", patience=1, plateau_rtol=1.0,
                adapt_every=2)
    for kw in ({}, fire):
        cfg = ShuffleSoftSortConfig(use_kernel=True, rounds=6 if not kw
                                    else 8, inner_steps=4, band=band, **kw)
        want = shuffle_soft_sort_batched(xs, hw, cfg, n_restarts=4, seed=2,
                                         device=cuda)
        for k in (1, 3, 8):
            got = shuffle_soft_sort_batched(
                xs, hw, cfg, n_restarts=4, seed=2,
                mesh=make_sort_mesh(devices=[cuda] * k))
            np.testing.assert_array_equal(got.all_orders, want.all_orders)
            np.testing.assert_array_equal(got.all_losses, want.all_losses)
            np.testing.assert_array_equal(got.best_restart,
                                          want.best_restart)
    cfg = ShuffleSoftSortConfig(use_kernel=True, rounds=6, inner_steps=4,
                                band=band)
    tour = [restart_tournament(xs, hw, cfg, n_restarts=4, seed=2,
                               cull_fraction=0.5, n_rungs=3, device=cuda,
                               mesh=m)
            for m in (None, make_sort_mesh(devices=[cuda] * 3))]
    np.testing.assert_array_equal(tour[0].order, tour[1].order)
    np.testing.assert_array_equal(tour[0].all_losses, tour[1].all_losses)
    outs = []
    for m in (None, make_sort_mesh(devices=[cuda] * 3)):
        src = TorchShuffleSource([1, 2, 3, 4, 5], n, cuda)
        outs.append(run_round_segment(
            np.concatenate([xs, xs[:2]]), np.tile(np.arange(n), (5, 1)),
            np.ones(5, np.float32), [0, 0, 2, 2, 4], 2, source=src, hw=hw,
            cfg=cfg, device=cuda, mesh=m) + (src.state_dict(),))
    for a, b in zip(*outs):
        assert np.array_equal(np.asarray(torch.as_tensor(a).cpu()),
                              np.asarray(torch.as_tensor(b).cpu()))


@pytest.mark.cuda
def test_cuda_mesh_over_two_cards(cuda):
    """A mesh over two cards: each slot's streams and rows move to its
    card, every kernel launch there raises its shared-memory limit on
    that card first (once per device), and the results are bitwise the
    run on the first card alone."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    from repro_torch.core import ShuffleSoftSortConfig, shuffle_soft_sort_batched
    from repro_torch.launch.mesh import make_sort_mesh

    n, hw = 256, (16, 16)
    xs, _ = _tournament_problem(2, 1, n, 1, seed=13)
    for band in (None, "auto"):
        cfg = ShuffleSoftSortConfig(use_kernel=True, rounds=4, inner_steps=4,
                                    band=band)
        want = shuffle_soft_sort_batched(xs, hw, cfg, n_restarts=5, seed=1,
                                         device="cuda:0")
        got = shuffle_soft_sort_batched(xs, hw, cfg, n_restarts=5, seed=1,
                                        mesh=make_sort_mesh(2))
        np.testing.assert_array_equal(got.all_orders, want.all_orders)
        np.testing.assert_array_equal(got.all_losses, want.all_losses)


# ------------------------------------------------ threefry (A3b), Table III

@pytest.mark.cuda
@pytest.mark.parametrize("r,m", [(8, 4096), (1, 1024 * 1024), (3, 1001),
                                 (5, 1), (2, 6)])
def test_cuda_threefry_kernel_is_bitwise_its_twin(cuda, r, m):
    TK = importlib.import_module("repro_torch.kernels.threefry")
    keys = torch.tensor(np.random.default_rng(m).integers(
        0, 2 ** 32, (r, 2)), dtype=torch.int64, device=cuda)
    for mode in (TK.ORIGINAL, TK.XOR, TK.PAIRS):
        mm = m + (m % 2 if mode == TK.PAIRS else 0)
        TK.threefry_bits.launches = 0
        got = TK.threefry_bits(keys, mm, mode)
        assert TK.threefry_bits.launches == 1
        assert torch.equal(got.cpu(),
                           TK.threefry_bits_plain(keys.cpu(), mm, mode))


@pytest.mark.cuda
@pytest.mark.parametrize("r,n", [(8, 4096), (2, 1024), (3, 1001), (5, 4098),
                                 (1, 1)])
def test_cuda_threefry_round_is_bitwise_its_twin(cuda, r, n):
    """The fused shuffle round in both layouts, with and without the
    source's split: kept keys and every round's sort words bitwise the
    twin's, in one launch."""
    TK = importlib.import_module("repro_torch.kernels.threefry")
    keys = torch.tensor(np.random.default_rng(n).integers(
        0, 2 ** 32, (r, 2)), dtype=torch.int64, device=cuda)
    rounds = TK.permutation_rounds(n)
    for part in (True, False):
        for split_keys in (True, False):
            TK.threefry_round.launches = 0
            kept, got = TK.threefry_round(keys, n, rounds, part, split_keys)
            assert TK.threefry_round.launches == int(
                split_keys or bool(rounds and n))
            kp, want = TK.threefry_round_plain(keys.cpu(), n, rounds, part,
                                               split_keys)
            assert torch.equal(got.cpu(), want)
            assert (kept is None and kp is None) or torch.equal(kept.cpu(),
                                                                kp)


@pytest.mark.cuda
def test_cuda_fold_in_and_threefry_2x32_launch_the_kernel(cuda):
    """fold_in over a batch of keys on CUDA: one threefry_bits launch
    each; threefry_2x32 of one counter pair and of 4- and 4096-word
    counts: one threefry_given launch each; all bitwise the CPU twin, and
    no other kernel of the package."""
    from repro_torch.core import threefry as tf
    from repro_torch.kernels import launch_counts, reset_launch_counts
    keys = tf.split(tf.prng_key(11), 6, device=cuda)
    for data in (0, 1, 2 ** 31, 2 ** 32 - 1):
        reset_launch_counts()
        got = tf.fold_in(keys, data)
        assert {k: v for k, v in launch_counts().items() if v} == {
            "threefry_bits": 1}
        assert torch.equal(got.cpu(), tf.fold_in(keys.cpu(), data))
    key, count = np.array([0x13198A2E, 0x03707344], np.uint32), np.array(
        [0x243F6A88, 0x85A308D3], np.uint32)
    reset_launch_counts()
    got = tf.threefry_2x32(key, count, device=cuda)
    assert {k: v for k, v in launch_counts().items() if v} == {
        "threefry_given": 1}
    assert got.tolist() == [0xC4923A9C, 0x483DF7A0]
    for m in (4, 4096):
        count = np.arange(m, dtype=np.uint32) * np.uint32(2654435761)
        reset_launch_counts()
        got = tf.threefry_2x32(key, count, device=cuda)
        assert {k: v for k, v in launch_counts().items() if v} == {
            "threefry_given": 1}
        assert torch.equal(got.cpu(), tf.threefry_2x32(key, count,
                                                       device="cpu"))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1,), (2,), (3,), (4,), (7,), (4096,),
                                   (3, 5)])
def test_cuda_threefry_2x32_of_any_count_is_the_twin(cuda, shape):
    """Queue C15: a count of any shape, held on the card, in one
    ``threefry_given`` launch, bitwise the CPU twin."""
    from repro_torch.core import threefry as tf
    from repro_torch.kernels import launch_counts, reset_launch_counts
    rng = np.random.default_rng(len(shape) * 10007 + shape[0])
    key = rng.integers(0, 2 ** 32, 2, dtype=np.uint32)
    count = rng.integers(0, 2 ** 32, shape, dtype=np.uint32)
    on_card = torch.as_tensor(count.astype(np.int64), device=cuda)
    reset_launch_counts()
    got = tf.threefry_2x32(key, on_card, device=cuda)
    assert {k: v for k, v in launch_counts().items() if v} == {
        "threefry_given": 1}
    assert got.shape == shape and got.device.type == "cuda"
    assert torch.equal(got.cpu(), tf.threefry_2x32(key, count, device="cpu"))


@pytest.mark.cuda
@pytest.mark.parametrize("partitionable", [True, False])
def test_cuda_threefry_source_is_bitwise_the_cpu_source(cuda, partitionable):
    from repro_torch.core import threefry as tf
    from repro_torch.core.prng import ThreefryShuffleSource
    keys = tf.split(tf.prng_key(5), 8, partitionable=partitionable,
                    device="cpu")
    TK = importlib.import_module("repro_torch.kernels.threefry")
    a = ThreefryShuffleSource(keys, 4096, cuda, partitionable)
    b = ThreefryShuffleSource(keys, 4096, "cpu", partitionable)
    for rows in (None, [3, 1], None):
        for k in TK.KERNELS:
            k.launches = 0
        assert torch.equal(a.next_round(rows).cpu(), b.next_round(rows))
        assert (TK.threefry_bits.launches, TK.threefry_round.launches) == (
            0, 1)
    np.testing.assert_array_equal(a.state_dict(), b.state_dict())
    for name in ("uniform", "normal"):
        fn = getattr(tf, name)
        assert torch.equal(fn(tf.prng_key(1), (64, 13), device=cuda).cpu(),
                           fn(tf.prng_key(1), (64, 13), device="cpu"))


@pytest.mark.cuda
def test_cuda_soft_sort_baseline_runs_the_dense_kernels(cuda):
    import dataclasses

    from repro_torch.core import ShuffleSoftSortConfig, soft_sort_baseline
    from repro_torch.core.threefry import prng_key, uniform
    x = uniform(prng_key(42), (256, 3), device=cuda)
    cfg = ShuffleSoftSortConfig(rounds=4, inner_steps=4, lambda_sigma=0.0)
    K.reset_launch_counts()
    kern = soft_sort_baseline(x, (16, 16),
                              dataclasses.replace(cfg, use_kernel=True))
    assert all(K.launch_counts()[k] == 16 for k in
               ("fwd_fused", "colsum", "bwd_dws_delta", "bwd_dx"))
    plain = soft_sort_baseline(x, (16, 16), cfg)
    assert sorted(kern[0].tolist()) == list(range(256))
    np.testing.assert_allclose(kern[2], plain[2], rtol=1e-4)


# ----------------------------------------- payload-tile autotune (A14b)

_AUTOTUNE_CELLS = [(t, n, d, k, cd) for t, n, d, k in
                   [("fused", 1024, 8, 0), ("fused", 1024, 50, 0),
                    ("banded", 1024, 8, 128), ("banded", 1024, 50, 128),
                    ("banded", 2048, 8, 128), ("banded", 4096, 8, 256)]
                   for cd in ("float32", "bfloat16")]


@pytest.mark.cuda
@pytest.mark.parametrize("tier,n,d,k,cd", _AUTOTUNE_CELLS)
def test_cuda_every_payload_tile_matches_the_twins(cuda, tier, n, d, k, cd):
    """Each autotune cell (``autotune.FULL_CELLS``, both dtypes): every
    candidate tile's y, colsum, dw and dx within the twins' tolerance
    (``search_cell`` raises otherwise), and the committed table's rule:
    a ``cuda`` row only where every tile gives the same bits, so the table
    moves no result."""
    from repro_torch.kernels import autotune
    assert (tier, n, d, k) in autotune.FULL_CELLS
    row = autotune.search_cell(tier, n, d, k, cd, autotune.CANDIDATES[tier],
                               reps=1, device=cuda)
    assert row["tiles"] == sorted({autotune._effective(c, d)
                                   for c in autotune.CANDIDATES[tier]})
    committed = autotune._load_table(autotune.TABLE_PATH)
    key = autotune._cell_key(tier, n, d, k, cd, "cuda")
    if not row["bitwise"]:
        assert key not in committed, row["bitwise_by"]
        assert autotune.lookup_blocks(tier, n, d, k, cd) \
            == K.band_payload_tile(d)[0]


# ------------------------------ batched == sequential per seed (Queue C12)

@pytest.mark.cuda
@pytest.mark.parametrize("b", [8, 64])
def test_cuda_batched_equals_sequential_per_seed(cuda, b):
    """The batched bench's cell on the kernel tier (N = 1024, d = 3, 10
    rounds x 4 inner steps, the reference bench's problems and keys): each
    seed's order and losses bitwise the same on the batched and the
    sequential path.  Before every loss ran in blocks of 8 instances, the
    sequential run's one-row loss reduced in another split than the
    batched run's 8 rows, and most seeds moved (Queue C12)."""
    from repro_torch.bench import batched_bench
    from repro_torch.core import ShuffleSoftSortConfig
    cfg = ShuffleSoftSortConfig(rounds=10, inner_steps=4, chunk=256,
                                use_kernel=True)
    row = batched_bench.bench_cell(b, 1024, 3, cfg, cuda, warm=False)
    assert row["seeds_orders_differ"] == [] and row["seeds_losses_differ"] == []


# ----------------------------------------- the LM zoo on the flash kernels

def _lm_on_card_and_host(arch, requests, max_new, prompt_len, **overrides):
    """serve_lm on the card with a tiny-preset model, the same weights
    teacher-forced on the host (plain twins), and the card's counts."""
    import copy

    from repro_torch.configs import get_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.serve import lm_context, pad_caches, serve_lm
    from repro_torch.launch.train import PRESETS
    from repro_torch.models import (decode_step, init_model, prefill,
                                    reduced_config)
    cfg = reduced_config(get_config(arch), **{**PRESETS["tiny"], **overrides})
    model = init_model(cfg, "cuda", seed=0)
    torch.cuda.synchronize()
    reset_launch_counts()
    out = serve_lm(cfg, requests, max_new, prompt_len, device="cuda",
                   model=model)
    counts = launch_counts()
    host = copy.deepcopy(model).to("cpu")
    toks = torch.from_numpy(out["tokens"])
    with torch.inference_mode():
        lg, caches = prefill(host, torch.from_numpy(out["prompts"]).long(),
                             lm_context(cfg, requests, "cpu"))
        caches, ref = pad_caches(caches, max_new), [lg]
        for i in range(max_new - 1):
            lg, caches = decode_step(host, toks[:, i:i + 1], caches,
                                     out["max_len"] + i,
                                     lm_context(cfg, requests, "cpu"))
            ref.append(lg)
    return cfg, out, counts, ref


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "whisper-small",
                                  "granite-moe-3b-a800m"])
def test_cuda_lm_serve_runs_attention_on_flash(cuda, arch):
    """Every attention call of serve_lm launches flash_forward (audio: the
    encoder again at each decode step); the card's logits are the host's
    within atol 1e-4 (float32, TF32 off)."""
    cfg, out, counts, ref = _lm_on_card_and_host(arch, 4, 8, 24)
    per_pass = 2 + (2 + cfg.encoder_layers if cfg.is_encdec else 0)
    assert counts["flash_forward"] == 8 * per_pass
    assert counts["flash_combine"] == 0
    for got, want in zip(out["logits"], ref):
        np.testing.assert_allclose(got.cpu().numpy(), want.numpy(),
                                   atol=1e-4, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("prompt_len,t,splits,route", [
    (520, 196, 4, "flash_forward_cluster"), (600, 563, 9, "flash_combine")])
def test_cuda_lm_decode_over_a_long_cache_merges_its_key_splits(
        cuda, prompt_len, t, splits, route):
    """One request, a t-token prompt: its two kv planes split the keys
    (``decode_splits``) at the prefill and at each decode step, so every
    attention call merges them: 4 splits in the forward's cluster
    epilogue, 9 (more than 8) in a flash_combine launch."""
    from repro_torch.kernels.flash_attention import decode_splits, split_plan
    cfg, out, counts, ref = _lm_on_card_and_host("qwen1.5-0.5b", 1, 6,
                                                 prompt_len)
    rep = cfg.num_heads // cfg.num_kv_heads
    assert out["max_len"] == t
    for rows, keys in [(rep * t, t)] + [(rep, t + 6)] * 5:
        assert split_plan(keys, decode_splits(
            cfg.num_kv_heads, rows, keys, cfg.resolved_head_dim,
            cuda))[0] == splits
    merges = {"flash_forward_cluster": 0, "flash_combine": 0, route: 12}
    assert counts["flash_forward"] == 12
    assert {k: counts[k] for k in merges} == merges
    for got, want in zip(out["logits"], ref):
        np.testing.assert_allclose(got.cpu().numpy(), want.numpy(),
                                   atol=1e-4, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "granite-moe-3b-a800m",
                                  "whisper-small"])
def test_cuda_train_step_matches_the_host(cuda, arch):
    """One ``make_train_step`` at the tiny preset (float32, remat "full")
    on the card against the same weights and batch on the host: the
    flash forwards of the step, recomputed under remat, are launched on
    the card; loss and gradient norm within 1e-5 relative, and the new
    parameters within 2 x lr (Adam's first step is sign-like)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.data import synthetic_batch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.steps import make_train_step, model_params
    from repro_torch.launch.train import PRESETS
    from repro_torch.models import init_model, reduced_config
    from repro_torch.optim import adam_init
    from repro_torch.tree import tree_map
    cfg = dataclasses.replace(reduced_config(get_config(arch),
                                             **PRESETS["tiny"]), remat=True)
    params = model_params(init_model(cfg, "cuda", seed=0))
    state = {"params": params, "opt": adam_init(params)}
    batch = synthetic_batch(cfg, 2, 32, 0, device="cuda")
    host = tree_map(lambda t: t.cpu(), (state, batch))
    step = make_train_step(cfg, lr=1e-3)
    reset_launch_counts()
    new, m = step(state, batch)
    torch.cuda.synchronize()
    unit, repeats = cfg.block_program()
    kinds = unit * repeats
    attn = (sum(k.startswith("attn") or k == "cross_attn" for k in kinds)
            + kinds.count("cross_attn") + cfg.encoder_layers)
    assert launch_counts()["flash_forward"] == 2 * attn
    hnew, hm = step(*host)
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(m[k]), float(hm[k]), rtol=1e-5)
    for k, p in new["params"].items():
        np.testing.assert_allclose(p.cpu().numpy(),
                                   hnew["params"][k].numpy(), rtol=0,
                                   atol=2e-3)


@pytest.mark.cuda
def test_cuda_bf16_checkpoint_roundtrip(cuda, tmp_path):
    """bfloat16 leaves saved from the card come back on the card, bit for
    bit (the reference's ``|V2`` layout)."""
    from repro_torch.runtime.checkpoint import CheckpointManager
    g = torch.Generator(device="cuda").manual_seed(0)
    state = {"w": torch.randn(64, 33, device="cuda", generator=g).to(
        torch.bfloat16), "m": torch.randn(7, device="cuda", generator=g)}
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(3, state)
    mgr.wait()
    got, step = mgr.restore(state)
    assert step == 3
    for k, v in state.items():
        assert got[k].device.type == "cuda" and got[k].dtype == v.dtype
        assert torch.equal(got[k].reshape(-1).view(torch.uint8),
                           v.reshape(-1).view(torch.uint8))


@pytest.mark.cuda
def test_cuda_supervisor_resume_is_bitwise(cuda, tmp_path):
    """A train run at the tiny preset on the card with a failure injected
    after a checkpoint ends bitwise the uninterrupted run."""
    from repro_torch.data import synthetic_batch
    from repro_torch.launch.train import build
    from repro_torch.runtime.checkpoint import CheckpointManager
    from repro_torch.runtime.fault_tolerance import (TrainSupervisor,
                                                     WorkerFailure)
    from repro_torch.tree import leaves

    def run(d, fail_at):
        cfg, state, step = build("qwen1.5-0.5b", "tiny", 1e-3, False,
                                 "cuda")
        armed = {"on": fail_at is not None}

        def step_fn(state, batch):
            i = batch.pop("step")
            if armed["on"] and i == fail_at:
                armed["on"] = False
                raise WorkerFailure("injected")
            return step(state, batch)

        sup = TrainSupervisor(
            step_fn, lambda i: dict(synthetic_batch(cfg, 2, 32, i,
                                                    device="cuda"), step=i),
            CheckpointManager(str(d)), checkpoint_every=5)
        state, n = sup.run(state, 0, 12)
        return state, n, sup.restarts

    clean, n0, r0 = run(tmp_path / "a", None)
    failed, n1, r1 = run(tmp_path / "b", 8)
    assert (n0, r0, n1, r1) == (12, 0, 12, 1)
    for a, b in zip(leaves(clean), leaves(failed)):
        assert torch.equal(a, b)


@pytest.fixture
def card_mesh(cuda):
    """A (1, 1) ("data", "model") mesh over an nccl group of one rank."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_production_mesh
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1, device_id=torch.device("cuda", 0))
    try:
        yield make_production_mesh(shape=(1, 1))
    finally:
        dist.destroy_process_group()


def _bitwise(got, want):
    from repro_torch.tree import flatten
    gl, gs = flatten(got)
    wl, ws = flatten(want)
    assert gs == ws
    for g, w in zip(gl, wl):
        g = g.to_local() if hasattr(g, "to_local") else g
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "granite-moe-3b-a800m",
                                  "jamba-v0.1-52b"])
def test_cuda_one_rank_builders_are_bitwise_the_unsharded_steps(card_mesh,
                                                                arch):
    """``lower_cell``'s train, prefill and decode steps on a (1, 1) mesh
    of the card, at the tiny preset (float32), are bitwise
    ``make_train_step``, ``prefill`` and ``decode_step`` on the same
    inputs, their flash forwards launched on the card (none for the
    jamba preset, whose two layers are Mamba layers)."""
    from repro_torch.configs import get_config
    from repro_torch.data import synthetic_batch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import steps
    from repro_torch.launch.train import PRESETS
    from repro_torch.models import init_model, reduced_config
    from repro_torch.models import model as model_lib
    from repro_torch.models.config import ShapeCell
    from repro_torch.optim import adam_init
    cfg = reduced_config(get_config(arch), **PRESETS["tiny"])
    model = init_model(cfg, "cuda", seed=0)
    params = steps.model_params(model)
    b, t = 2, 32
    batch = synthetic_batch(cfg, b, t, 0, device="cuda")
    state = {"params": params, "opt": adam_init(params)}
    want = steps.make_train_step(cfg)(state, batch)
    reset_launch_counts()
    got = steps.lower_cell(cfg, ShapeCell("t", t, b, "train"),
                           card_mesh)(state, batch)
    torch.cuda.synchronize()
    kinds = cfg.block_program()[0] * cfg.block_program()[1]
    attn = (sum(k.startswith("attn") or k == "cross_attn" for k in kinds)
            + kinds.count("cross_attn") + cfg.encoder_layers)
    assert launch_counts()["flash_forward"] == attn * (2 if cfg.remat
                                                       else 1)
    _bitwise(got, want)

    with torch.no_grad():
        want = model_lib.prefill(model, batch["tokens"])
    got = steps.lower_cell(cfg, ShapeCell("p", t, b, "prefill"),
                           card_mesh)(params, batch["tokens"])
    _bitwise(got, want)

    caches = model_lib.make_caches(cfg, b, t + 8, torch.float32, "cuda")
    for c, w in zip(caches, want[1]):
        if hasattr(c, "k"):
            c.k[:, :t], c.v[:, :t] = w.k, w.v
    mine = [type(c)(*(x.clone() for x in c)) for c in caches]
    token = batch["tokens"][:, -1:]
    with torch.no_grad():
        want = model_lib.decode_step(model, token, mine, t)
    got = steps.lower_cell(cfg, ShapeCell("d", t + 8, b, "decode"),
                           card_mesh)(params, token, caches,
                                      torch.tensor(t, dtype=torch.int32))
    _bitwise(got, want)


@pytest.mark.cuda
def test_cuda_restore_with_shardings_places_on_the_card(card_mesh,
                                                        tmp_path):
    """``restore(shardings=)`` on the card's mesh: each leaf a DTensor on
    the card with the saved bits."""
    from repro_torch.launch.mesh import NamedSharding
    from repro_torch.models.layers import P
    from repro_torch.runtime.checkpoint import CheckpointManager
    state = {"w": torch.arange(12.0, device="cuda").reshape(3, 4),
             "b": torch.arange(4, device="cuda").to(torch.bfloat16)}
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(1, state)
    sh = {"w": NamedSharding(card_mesh, P("data", "model")),
          "b": NamedSharding(card_mesh, P())}
    got, _ = mgr.restore(state, shardings=sh)
    for k, v in state.items():
        assert got[k].to_local().device.type == "cuda"
        assert torch.equal(got[k].to_local(), v)


@pytest.mark.cuda
def test_cuda_tensors_on_a_host_mesh_raise(cuda):
    """A gloo group gives a "cpu" mesh: placing a CUDA tensor there raises
    rather than copying it to the host and running the step there."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import NamedSharding, make_production_mesh
    from repro_torch.launch.steps import place
    from repro_torch.models.layers import P
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = make_production_mesh(shape=(1, 1))
        assert mesh.device_type == "cpu"
        with pytest.raises(ValueError, match="CUDA tensor"):
            place(torch.ones(4, 2, device=cuda), NamedSharding(mesh,
                                                               P("data")))
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
def test_cuda_paper_round_is_bitwise_the_unsharded_round(card_mesh):
    """The paper cell's per-shard round (``repro_torch.launch.paper``) on
    the card over an nccl group of one rank, at N = 4096 on 64 x 64, chunk
    512, 2 inner steps, tau_r = 1.0: order and loss bitwise the unsharded
    ``_outer_round`` on the same shuffle, one ``threefry_round`` launch."""
    import functools

    from repro_torch.core import threefry as tf
    from repro_torch.core.shufflesoftsort import (ShuffleSoftSortConfig,
                                                  _adam_bias, _inner_ramp,
                                                  _outer_round)
    from repro_torch.core.softsort import softsort_apply_chunked
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.paper import paper_round
    n, d, hw = 4096, 59, (64, 64)
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(8)
    x = torch.as_tensor(rng.random((n, d), dtype=np.float32), device=dev)
    order = torch.as_tensor(rng.permutation(n).astype(np.int32), device=dev)
    key = torch.as_tensor(tf.prng_key(8).astype(np.int64), device=dev)
    tau = torch.tensor(1.0, device=dev)
    norm = torch.tensor(0.9, device=dev)
    cfg = ShuffleSoftSortConfig(inner_steps=2, chunk=512)
    reset_launch_counts()
    new, loss = paper_round(x, order, key, tau, norm, hw=hw, cfg=cfg,
                            group=card_mesh.get_group(0))
    assert {k: v for k, v in launch_counts().items() if v} == {
        "threefry_round": 1}
    shuf = tf.permutation(key, n)
    ramp = torch.as_tensor(_inner_ramp(cfg), device=dev)
    want, want_loss, _ = _outer_round(
        x[None], order.to(torch.int64)[None], shuf[None],
        (tau * ramp)[None], norm.reshape(1), *_adam_bias(cfg, dev), hw=hw,
        cfg=cfg, apply_fn=functools.partial(softsort_apply_chunked,
                                            chunk=512))
    assert new.dtype == torch.int32
    assert torch.equal(new.to(torch.int64), want[0])
    assert torch.equal(loss, want_loss[0])


@pytest.mark.cuda
@pytest.mark.parametrize("band", [None, 64])
def test_cuda_phase_spans_time_the_anneal_on_the_card(cuda, band):
    """``repro_torch.spans`` on the card, over a batched call of 4 x 2
    instances at N = 1024 on the kernel tier, dense and banded: the apply's
    backward opens its span on autograd's worker thread and is counted,
    each device interval comes from CUDA events and the self times tile the
    call, the gauge reads the step graph's bytes, and orders and losses are
    bitwise the unprofiled call's."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import spans
    from repro_torch.core import (ShuffleSoftSortConfig,
                                  shuffle_soft_sort_batched)
    rounds, steps = 2, 2
    cfg = ShuffleSoftSortConfig(rounds=rounds, inner_steps=steps,
                                use_kernel=True, band=band, band_eps=1.0)
    xs = np.random.default_rng(3).random((4, 1024, 8), dtype=np.float32)

    def call():
        return shuffle_soft_sort_batched(xs, (32, 32), cfg, n_restarts=2,
                                         seed=5, device=cuda)

    off = call()
    spans.reset()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        on = call()
    rep = spans.report()
    spans.reset()
    rows = rep["spans"]
    for name, count in (("call", 1), ("round", rounds),
                        ("shuffle", 2 * rounds), ("commit", rounds),
                        ("step", rounds * steps),
                        ("apply.fwd", rounds * steps),
                        ("apply.bwd", rounds * steps)):
        assert rows[name]["calls"] == count, name
    assert rows["apply.bwd"]["self_s"] > 0
    assert sum(r["self_s"] for r in rows.values()) == pytest.approx(
        rows["call"]["device_s"], rel=1e-4)
    assert rep["gauges"]["step_graph_bytes"] > 0
    for field in ("order", "all_orders", "best_restart"):
        np.testing.assert_array_equal(getattr(off, field), getattr(on, field))
    assert off.all_losses.tobytes() == on.all_losses.tobytes()
