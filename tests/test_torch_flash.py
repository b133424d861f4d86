"""The flash-attention forward of the port (``flash_forward`` and
``flash_combine`` in ``repro_torch.kernels.flash_attention``, replacing
the TPU's two passes 10a/10b) and its autograd wrapper
``repro_torch.kernels.flash_ops.flash_attention``, against the
reference's ``repro.kernels.flash_ops`` and its Pallas kernels.

On the CPU each kernel wrapper runs its plain twin.  The twins are held to
the JAX function ``flash_attention_fwd_pallas`` in interpret mode on the
same folded, padded operands (its o, on unpadded rows), and their m and l
to the row max and denominator of the masked scores computed in float64
with numpy (that function does not return them).  ``tests/test_torch_cuda.py``
holds the CUDA kernels to the twins on the card.

Tolerances: forward atol 2e-5, as ``tests/test_flash_attention.py``
(float32 sums over S in other orders; l relative); gradients atol 1e-4 x
max-abs of the reference; bfloat16 inputs atol 3e-2, as that file's
``test_dtypes``.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import flash_ops as jfo  # noqa: E402
from repro.kernels.flash_attention import (  # noqa: E402
    flash_attention_fwd_pallas,
)
from repro_torch.kernels import flash_ops as tfo  # noqa: E402
from repro_torch.kernels import (  # noqa: E402
    flash_attention,
    flash_attention_ref,
    launch_counts,
    reset_launch_counts,
)
from repro_torch.kernels.bounds import (  # noqa: E402
    attention_pairs,
    flash_bound_ms,
)
from repro_torch.kernels.flash_attention import (  # noqa: E402
    decode_splits,
    flash_apply_plain,
    flash_combine,
    flash_forward,
    flash_forward_plain,
    flash_stats_plain,
    split_plan,
)

ATOL = 2e-5
GRAD_RTOL = 1e-4

# tests/test_flash_attention.py's CASES: (B, Tq, S, H, Hkv, Dh, causal).
CASES = [
    (2, 64, 64, 4, 2, 32, True),       # GQA train-like
    (1, 100, 100, 5, 5, 16, True),     # MHA, unaligned lengths
    (2, 1, 128, 8, 2, 64, True),       # decode: one query vs cache
    (2, 48, 80, 6, 3, 32, False),      # cross-attention (no mask)
    (1, 256, 256, 2, 1, 128, True),    # MQA, lane-aligned
]


def _qkv(b, tq, s, h, hkv, dh, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, tq, h, dh)).astype(np.float32),
            rng.normal(size=(b, s, hkv, dh)).astype(np.float32),
            rng.normal(size=(b, s, hkv, dh)).astype(np.float32))


def _close(got, want, rtol):
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32)
    scale = float(np.max(np.abs(want))) + 1e-9
    np.testing.assert_allclose(got, want, atol=rtol * scale)


@pytest.mark.parametrize("b,tq,s,h,hkv,dh,causal", CASES)
def test_flash_attention_matches_jax(b, tq, s, h, hkv, dh, causal):
    """The Function against the reference's flash_attention (Pallas in
    interpret mode) and against both oracles."""
    q, k, v = _qkv(b, tq, s, h, hkv, dh, b * tq + h)
    off = s - tq if causal else 0
    out = flash_attention(torch.tensor(q), torch.tensor(k), torch.tensor(v),
                          causal, off)
    ref = flash_attention_ref(torch.tensor(q), torch.tensor(k),
                              torch.tensor(v), causal=causal, q_offset=off)
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    out_j = jfo.flash_attention(jq, jk, jv, causal, off)
    ref_j = jfo.flash_attention_ref(jq, jk, jv, causal=causal, q_offset=off)
    np.testing.assert_allclose(out.numpy(), np.asarray(out_j), atol=ATOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_j), atol=ATOL)
    np.testing.assert_allclose(ref.numpy(), np.asarray(ref_j), atol=ATOL)


def _numpy_stats(qf, kf, rep, causal, off):
    """Row max and denominator of the masked scores, float64."""
    tq, dh = qf.shape[1:]
    s = np.einsum("ptd,psd->pts", qf.astype(np.float64),
                  np.repeat(kf, rep, axis=0).astype(np.float64)) * dh ** -0.5
    if causal:
        ok = np.arange(s.shape[2])[None, :] <= np.arange(tq)[:, None] + off
        s = np.where(ok[None], s, -np.inf)
    m = s.max(axis=-1)
    return m, np.exp(s - m[..., None]).sum(axis=-1)


@functools.lru_cache(maxsize=None)
def _pallas_o(b, tq, s, h, hkv, dh, causal):
    """o of the reference's Pallas forward (interpret mode) at a CASES
    case with the ``tq + s`` seed, on unpadded rows and Dh, folded."""
    q, k, v = _qkv(b, tq, s, h, hkv, dh, tq + s)
    off = s - tq if causal else 0
    qf, kf, vf = (tfo.fold_heads(torch.tensor(t)).numpy() for t in (q, k, v))
    br = min(128, -(-tq // 8) * 8)
    bc = min(128, -(-s // 128) * 128)
    tqp, tkp, dhp = -(-tq // br) * br, -(-s // bc) * bc, -(-dh // 128) * 128

    def pad(t, t_pad):
        return jnp.pad(jnp.asarray(t),
                       ((0, 0), (0, t_pad - t.shape[1]), (0, dhp - dh)))

    o_j = flash_attention_fwd_pallas(
        pad(qf, tqp), pad(kf, tkp), pad(vf, tkp), rep=h // hkv,
        scale=dh ** -0.5, q_len=tq, kv_len=s, causal=causal, q_offset=off,
        br=br, bc=bc, interpret=True)
    return np.asarray(o_j[:, :tq, :dh])


@pytest.mark.parametrize("b,tq,s,h,hkv,dh,causal", CASES)
def test_flash_twins_match_jax_pallas_kernels(b, tq, s, h, hkv, dh, causal):
    """The twins of the TPU's stats and apply passes on folded operands
    against the Pallas forward's o (unpadded rows and Dh) and the stats'
    definition."""
    q, k, v = _qkv(b, tq, s, h, hkv, dh, tq + s)
    off = s - tq if causal else 0
    rep = h // hkv
    qf, kf, vf = (tfo.fold_heads(torch.tensor(t)) for t in (q, k, v))
    m, l = flash_stats_plain(qf, kf, causal, off)
    o = flash_apply_plain(qf, kf, vf, m, l, causal, off)
    np.testing.assert_allclose(o.numpy(), _pallas_o(b, tq, s, h, hkv, dh,
                                                    causal), atol=ATOL)
    m_n, l_n = _numpy_stats(qf.numpy(), kf.numpy(), rep, causal, off)
    np.testing.assert_allclose(m.numpy(), m_n, atol=ATOL)
    np.testing.assert_allclose(l.numpy(), l_n, rtol=ATOL)


def test_flash_gradients_match_jax():
    """dq, dk and dv of the chunked backward against jax.grad of the
    reference's flash_attention, at a GQA causal case."""
    q, k, v = _qkv(1, 40, 40, 4, 2, 16, 9)
    a = np.random.default_rng(10).normal(size=q.shape).astype(np.float32)
    args = [torch.tensor(t, requires_grad=True) for t in (q, k, v)]
    out = flash_attention(*args, True, 0, 16)
    got = torch.autograd.grad((out * torch.tensor(a)).sum(), args)
    want = jax.grad(lambda q, k, v: jnp.sum(
        jfo.flash_attention(q, k, v, True, 0, 128, 128, 16) * a),
        argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    for g, r in zip(got, want):
        _close(g.numpy(), np.asarray(r), GRAD_RTOL)


def test_flash_bf16_in_bf16_out():
    """A bfloat16 input is computed in float32 and returned in bfloat16."""
    q, k, v = (torch.tensor(t).to(torch.bfloat16)
               for t in _qkv(1, 64, 64, 4, 2, 32, 0))
    out = flash_attention(q, k, v)
    assert out.dtype == torch.bfloat16
    ref = flash_attention_ref(q.float(), k.float(), v.float(), causal=True)
    np.testing.assert_allclose(out.float().numpy(), ref.numpy(), atol=3e-2)


@pytest.mark.parametrize("b,g,rep", [(1, 1, 1), (2, 3, 2), (1, 2, 4)])
def test_rows_are_convex_combinations(b, g, rep):
    """With V == 1 everywhere every output row is exactly 1."""
    rng = np.random.default_rng(b + g + rep)
    q = torch.tensor(rng.normal(size=(b, 16, g * rep, 8)).astype(np.float32))
    k = torch.tensor(rng.normal(size=(b, 16, g, 8)).astype(np.float32))
    out = flash_attention(q, k, torch.ones(b, 16, g, 8))
    np.testing.assert_allclose(out.numpy(), 1.0, atol=1e-5)


def test_rows_with_no_key_follow_the_oracle():
    """A negative q_offset leaves the first rows with no key.  The oracle
    averages them over the S real keys, and so does the port; the
    reference's Pallas kernel averages over its padded key columns
    instead (ROADMAP Queue C), so it differs there and only there."""
    q, k, v = _qkv(1, 20, 50, 2, 1, 8, 4)
    off = -6
    out = flash_attention(torch.tensor(q), torch.tensor(k), torch.tensor(v),
                          True, off).numpy()
    ref = jfo.flash_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal=True, q_offset=off)
    np.testing.assert_allclose(out, np.asarray(ref), atol=ATOL)
    np.testing.assert_allclose(out[:, :6], np.broadcast_to(
        v.mean(axis=1, keepdims=True).repeat(2, axis=2), out[:, :6].shape),
        atol=ATOL)
    out_j = np.asarray(jfo.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                           jnp.asarray(v), True, off))
    np.testing.assert_allclose(out_j[:, 6:], out[:, 6:], atol=ATOL)
    assert np.abs(out_j[:, :6] - out[:, :6]).max() > 1e-2


def test_cpu_route_launches_nothing():
    """CPU tensors go to the twins; the counters count kernel launches
    only, and the Function's backward launches no kernel."""
    reset_launch_counts()
    q, k, v = (torch.tensor(t, requires_grad=True)
               for t in _qkv(1, 8, 8, 2, 1, 4, 1))
    flash_attention(q, k, v).sum().backward()
    assert launch_counts()["flash_forward"] == launch_counts()[
        "flash_combine"] == 0


def test_wrappers_reject_bad_operands():
    q, kv = torch.zeros(4, 8, 16), torch.zeros(2, 8, 16)
    bad = [
        (q, torch.zeros(3, 8, 16), torch.zeros(3, 8, 16)),  # 4 planes / 3
        (q.double(), kv.double(), kv.double()),
        (q, torch.zeros(2, 0, 16), torch.zeros(2, 0, 16)),  # no keys
        (q, kv, torch.zeros(2, 8, 8)),                      # v unlike k
        (q[None], torch.zeros(2, 2, 8, 16), torch.zeros(2, 2, 8, 16)),
    ]
    for args in bad:
        with pytest.raises(ValueError):
            flash_forward(*args)
    with pytest.raises(ValueError):                         # partials
        flash_combine(torch.zeros(2, 4, 16), torch.zeros(2, 4),
                      torch.zeros(3, 4))
    with pytest.raises(ValueError):
        flash_attention(torch.zeros(1, 8, 3, 16), torch.zeros(1, 8, 2, 16),
                        torch.zeros(1, 8, 2, 16))      # 3 heads over 2


@pytest.mark.parametrize("tq,tk,causal,off", [(4096, 4096, True, 0),
                                              (1, 4096, True, 4095),
                                              (48, 80, False, 0),
                                              (20, 50, True, -6)])
def test_attention_pairs_counts_the_scored_pairs(tq, tk, causal, off):
    """The pair count of the flash bounds is the number of scored pairs
    of the mask (a row with no key scores all of them)."""
    rows = np.arange(tq)[:, None] + off
    ok = np.ones((tq, tk), bool)
    if causal:
        ok = (np.arange(tk)[None, :] <= rows) | (rows < 0)
    assert attention_pairs(tq, tk, causal, off) == int(ok.sum())


def _folded(b, tq, s, h, hkv, dh, seed):
    return tuple(tfo.fold_heads(torch.tensor(t))
                 for t in _qkv(b, tq, s, h, hkv, dh, seed))


@pytest.mark.parametrize("splits", [1, 2, 7])
@pytest.mark.parametrize("b,tq,s,h,hkv,dh,causal", CASES)
def test_flash_forward_twin_matches_jax(b, tq, s, h, hkv, dh, causal,
                                        splits):
    """The one-pass twin at 1, 2 and 7 key splits against the reference's
    Pallas forward (interpret mode) and its oracle, and its m and l
    against the stats' definition."""
    qf, kf, vf = _folded(b, tq, s, h, hkv, dh, tq + s)
    off = s - tq if causal else 0
    o, m, l = flash_forward(qf, kf, vf, causal, off, splits)
    np.testing.assert_allclose(o.numpy(), _pallas_o(b, tq, s, h, hkv, dh,
                                                    causal), atol=ATOL)
    q, k, v = _qkv(b, tq, s, h, hkv, dh, tq + s)
    ref = jfo.flash_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal=causal,
                                  q_offset=off)
    np.testing.assert_allclose(
        o.reshape(b, h, tq, dh).transpose(1, 2).numpy(), np.asarray(ref),
        atol=ATOL)
    m_n, l_n = _numpy_stats(qf.numpy(), kf.numpy(), h // hkv, causal, off)
    np.testing.assert_allclose(m.numpy(), m_n, atol=ATOL)
    np.testing.assert_allclose(l.numpy(), l_n, rtol=ATOL)


@pytest.mark.parametrize("splits", [1, 3])
@pytest.mark.parametrize("b,tq,s,h,hkv,dh,off", [
    (1, 20, 150, 2, 1, 8, -6),       # rows with no key
    (2, 33, 200, 8, 2, 24, 167),     # GQA, rep = 4, ragged tiles
])
def test_flash_forward_twin_edge_cases(b, tq, s, h, hkv, dh, off, splits):
    """A negative q_offset (rows with no key: the mean of the value rows)
    and a rep = 4 GQA case, against the JAX oracle; the twin's m and l
    against the twins of the TPU passes."""
    q, k, v = _qkv(b, tq, s, h, hkv, dh, 5)
    qf, kf, vf = (tfo.fold_heads(torch.tensor(t)) for t in (q, k, v))
    o, m, l = flash_forward_plain(qf, kf, vf, True, off, splits)
    ref = jfo.flash_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal=True, q_offset=off)
    np.testing.assert_allclose(
        o.reshape(b, h, tq, dh).transpose(1, 2).numpy(), np.asarray(ref),
        atol=ATOL)
    m0, l0 = flash_stats_plain(qf, kf, True, off)
    np.testing.assert_allclose(m.numpy(), m0.numpy(), atol=ATOL)
    np.testing.assert_allclose(l.numpy(), l0.numpy(), rtol=ATOL)
    np.testing.assert_allclose(
        o.numpy(), flash_apply_plain(qf, kf, vf, m, l, True, off).numpy(),
        atol=ATOL)


def test_strided_model_layout_matches_contiguous():
    """The heads-major view of the model layout, read in place, gives the
    result of the contiguous folded planes; the Function passes its
    float32 inputs as such views, with no copy."""
    q, k, v = (torch.tensor(t) for t in _qkv(2, 40, 130, 8, 2, 16, 6))
    views = [tfo.heads_major(t) for t in (q, k, v)]
    assert not views[0].is_contiguous()
    assert all(w.data_ptr() == t.data_ptr() for w, t in zip(views, (q, k, v)))
    for splits in (1, 3):
        o, m, l = flash_forward(*views, True, 90, splits)
        o2, m2, l2 = flash_forward(*(tfo.fold_heads(t) for t in (q, k, v)),
                                   True, 90, splits)
        np.testing.assert_allclose(o.reshape(o2.shape).numpy(), o2.numpy(),
                                   atol=ATOL)
        np.testing.assert_allclose(m.reshape(m2.shape).numpy(), m2.numpy(),
                                   atol=ATOL)
        np.testing.assert_allclose(l.reshape(l2.shape).numpy(), l2.numpy(),
                                   rtol=ATOL)


def test_flash_combine_adds_nothing_for_an_empty_split():
    """A split with no scored key (m = -1e30, l = 0, o = 0) leaves the
    merge of the others exactly as it was."""
    rng = np.random.default_rng(7)
    o = torch.tensor(rng.normal(size=(2, 5, 8)).astype(np.float32))
    m = torch.tensor(rng.normal(size=(2, 5)).astype(np.float32))
    l = torch.tensor(rng.uniform(1, 3, size=(2, 5)).astype(np.float32))
    want = flash_combine(o, m, l)
    got = flash_combine(torch.cat([o, torch.zeros(1, 5, 8)]),
                        torch.cat([m, torch.full((1, 5), -1e30)]),
                        torch.cat([l, torch.zeros(1, 5)]))
    for g, w in zip(got, want):
        assert torch.equal(g, w)


# One Mistral-NeMo-12B attention layer (32 query heads, 8 kv heads,
# head_dim 128) at a 4096-token prefill and one decode step after it.
NEMO = {"prefill": (32, 8, 4096, 4096, 128, True, 0),
        "decode": (32, 8, 1, 4096, 128, True, 4095)}


@pytest.mark.parametrize("cell", sorted(NEMO))
def test_decode_splits_at_nemo_shapes(cell):
    """Prefill fills the card with 2048 row tiles and does not split;
    decode's 8 blocks of 4 packed rows split the 64 key tiles one each,
    512 blocks; every split holds at least one key tile."""
    h, hkv, tq, tk, _, _, _ = NEMO[cell]
    splits = decode_splits(hkv, h // hkv * tq, tk, NEMO[cell][4])
    assert splits == {"prefill": 1, "decode": 64}[cell]
    n, tps = split_plan(tk, splits)
    assert n == splits and (n - 1) * tps < -(-tk // 64) <= n * tps


def test_flash_bounds_at_nemo_shapes():
    """The bounds of the two kernels at the NeMo shapes: prefill bound by
    operations, (4 Dh + 6) flops per causal pair at 67 TFLOP/s; decode by
    the 33.6 MB of K, V, q, o, m and l at 3.35 TB/s; the combine of
    decode's 64 splits by its partials' bytes."""
    pairs = 32 * 4096 * 4097 // 2
    ms, by = flash_bound_ms("flash_forward", 32, 8, 4096, 4096, 128, True, 0)
    assert by == "operations"
    np.testing.assert_allclose(ms, pairs * 518 / 67e12 * 1e3, rtol=1e-12)
    ms, by = flash_bound_ms("flash_forward", 32, 8, 1, 4096, 128, True, 4095)
    nbytes = 2 * 8 * 4096 * 128 * 4 + 2 * 32 * 128 * 4 + 2 * 32 * 4
    assert by == "bytes"
    np.testing.assert_allclose(ms, nbytes / 3.35e12 * 1e3, rtol=1e-12)
    ms, by = flash_bound_ms("flash_combine", 32, 8, 1, 4096, 128, True, 4095,
                            splits=64)
    nbytes = 65 * (32 * 128 * 4 + 2 * 32 * 4)
    assert by == "bytes"
    np.testing.assert_allclose(ms, nbytes / 3.35e12 * 1e3, rtol=1e-12)


# ------------------------------------------------ the cluster merge's route

def _chip_smoke():
    """chip_smoke.py's module, for its launch expectations."""
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_routes", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def test_cluster_route_takes_two_to_eight_splits():
    """flash_forward merges 2 to 8 key ranges (a portable cluster) in its
    epilogue; one range needs no merge, more go to flash_combine."""
    from repro_torch.kernels.flash_attention import MAX_CLUSTER, \
        merges_in_cluster
    assert MAX_CLUSTER == 8
    assert [merges_in_cluster(s) for s in range(1, 11)] == [
        False] + [True] * 7 + [False] * 2


# cudaOccupancyMaxActiveClusters of the merging forward on an H100 SXM
# (chip_smoke.py's build line): clusters of S blocks resident at once for
# kernels of two blocks per SM (up to 108 KB of shared memory) and of one
# (a 128-wide head with two K/V stages or 64-row tiles).
H100_CLUSTERS = {2: {2: 132, 3: 79, 4: 62, 5: 47, 6: 39, 7: 32, 8: 30},
                 1: {2: 66, 3: 39, 4: 30, 5: 22, 6: 17, 7: 15, 8: 15}}


def _h100_clusters(device, rows_tile, dh, stages, splits):
    assert torch.device(device).type == "cuda"
    one_per_sm = dh > 64 and (rows_tile == 64 or stages == 2)
    return H100_CLUSTERS[1 if one_per_sm else 2][splits]


# (kv planes, packed query rows, keys, Dh) -> (splits on the CPU, on an
# H100): Qwen1.5-0.5B's decode at lm_serve_run's traffic (b) and
# lm_mesh_run's 32 K cache (4 on the CPU; 2 on the card, where 4 splits of
# two blocks per SM would take a second wave of clusters), the 10m
# recovery run's training (2), the card test's tiny prefill and decode
# (4), and the NeMo decode and a tiny 563-token prefill, whose 64 and 9
# splits stay on flash_combine.
LM_SPLITS = [((128, 1, 1088, 64), 4, 2), ((128, 1, 32768, 64), 4, 2),
             ((64, 128, 128, 32), 2, 2), ((2, 392, 196, 16), 4, 4),
             ((2, 2, 202, 16), 4, 4), ((8, 4, 4096, 128), 64, 64),
             ((2, 1126, 563, 16), 9, 9)]


@pytest.mark.parametrize("call,cpu,card", LM_SPLITS)
def test_decode_splits_keep_merged_splits_to_one_wave_of_clusters(
        call, cpu, card, monkeypatch):
    """On a CUDA device, where the keys split into at most 8 ranges (the
    cluster route), every cluster of the launch is resident at once, as
    the card's occupancy query (here an H100's answers) says; the counts
    of more ranges, and every count off the card, are the rule's of two
    blocks per SM."""
    import importlib
    F = importlib.import_module("repro_torch.kernels.flash_attention")
    monkeypatch.setattr(F, "resident_clusters", _h100_clusters)
    bhkv, rows, tk, dh = call
    assert split_plan(tk, decode_splits(bhkv, rows, tk, dh))[0] == cpu
    assert split_plan(tk, decode_splits(bhkv, rows, tk, dh, "cpu"))[0] == cpu
    n, tps = split_plan(tk, decode_splits(bhkv, rows, tk, dh, "cuda"))
    assert n == card
    if F.merges_in_cluster(n):
        tile = F.row_tile(rows)
        clusters = bhkv * -(-rows // tile)
        assert clusters <= _h100_clusters("cuda", tile, dh,
                                          1 if tps == 1 else 2, n)


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_lm_launch_expectations_merge_every_split_in_the_cluster(
        device, monkeypatch):
    """chip_smoke.py's launch expectations: Qwen1.5-0.5B serving at
    traffic (b) (8 requests, prompts padded to 1024, 64 new tokens) and
    the 10m recovery run's train steps merge every split in the cluster
    epilogue and launch no flash_combine; the NeMo layer's decode keeps
    its one."""
    import importlib

    from repro_torch.configs import get_config
    from repro_torch.launch.train import PRESETS
    from repro_torch.models import reduced_config
    F = importlib.import_module("repro_torch.kernels.flash_attention")
    monkeypatch.setattr(F, "resident_clusters", _h100_clusters)
    cs = _chip_smoke()
    qwen = get_config("qwen1.5-0.5b")
    assert cs.lm_want(F, qwen, 8, 1024, 64, device) == {
        "flash_forward": 24 * 64, "flash_combine": 0,
        "flash_forward_cluster": 24 * 63}
    tiny = reduced_config(qwen, **PRESETS["10m"])
    calls = 3 * tiny.num_layers * (2 if tiny.remat else 1)
    assert cs.lm_train_want(F, tiny, 8, 128, 3, device) == {
        "flash_forward": calls, "flash_combine": 0,
        "flash_forward_cluster": calls}
    b, tq, s, h, hkv, dh, _, _ = cs.NEMO_PREFILL
    assert cs.flash_routes(F, [(b * hkv, h // hkv * t, s) for t in (tq, 1)],
                           dh, device) == {"flash_forward": 2, "flash_combine": 1,
                                   "flash_forward_cluster": 0}


@pytest.fixture
def recorded(monkeypatch):
    """Route CPU tensors to the CUDA path with the kernel library
    replaced by a recorder: each entry is (symbol, args)."""
    import contextlib
    import types

    from repro_torch.kernels import clib
    calls = []

    def symbol(stem, name, argtypes, restype):
        def fn(*args):
            assert len(args) == len(argtypes)
            calls.append((name, args))
            return 0
        return fn

    monkeypatch.setattr(clib, "route", lambda *tensors: "cuda")
    monkeypatch.setattr(clib, "_symbol", symbol)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: types.SimpleNamespace(cuda_stream=0))
    return calls


@pytest.mark.parametrize("splits,merge", [(1, 0), (2, 1), (8, 1), (12, 0)])
def test_forward_merges_up_to_eight_splits_in_one_launch(recorded, splits,
                                                          merge):
    """``flash_forward`` on the CUDA route: with 2 to 8 key ranges one
    ``fa_fwd_f32`` launch with the merge flag set, writing the merged (1,
    R, Dh) o and (1, R) m and l, counted on ``flash_forward`` and
    ``flash_forward_cluster``; with more, the forward's partials and a
    ``fa_combine_f32`` launch; with one, neither."""
    tk = 64 * 24                      # 24 key tiles: each count is exact
    q, k, v = (torch.tensor(t) for t in _qkv(2, 1, tk, 8, 2, 32, 3))
    views = [tfo.heads_major(t) for t in (q, k, v)]
    reset_launch_counts()
    o, m, l = flash_forward(*views, True, tk - 1, splits)
    assert o.shape == (2, 8, 1, 32) and m.shape == l.shape == (2, 8, 1)
    names = [name for name, _ in recorded]
    assert names == ["fa_fwd_f32"] + (["fa_combine_f32"]
                                      if splits > 8 else [])
    args = recorded[0][1]   # ..., splits, tiles per split, rows tile,
    assert args[-6:-1] == (splits, 24 // splits, 16, 1, merge)  # vec16, merge
    counts = launch_counts()
    assert (counts["flash_forward"], counts["flash_combine"],
            counts["flash_forward_cluster"]) == (1, int(splits > 8), merge)
