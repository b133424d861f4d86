"""The flash-attention forward of the port (kernels 10a/10b,
``repro_torch.kernels.flash_attention``) and its autograd wrapper
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
from repro_torch.kernels.bounds import attention_pairs  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_apply,
    flash_stats,
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


@pytest.mark.parametrize("b,tq,s,h,hkv,dh,causal", CASES)
def test_flash_twins_match_jax_pallas_kernels(b, tq, s, h, hkv, dh, causal):
    """flash_stats / flash_apply twins on folded operands against the
    Pallas forward's o (unpadded rows and Dh) and the stats' definition."""
    q, k, v = _qkv(b, tq, s, h, hkv, dh, tq + s)
    off = s - tq if causal else 0
    rep = h // hkv
    qf, kf, vf = (tfo.fold_heads(torch.tensor(t)) for t in (q, k, v))
    m, l = flash_stats(qf, kf, causal, off)
    o = flash_apply(qf, kf, vf, m, l, causal, off)

    br = min(128, -(-tq // 8) * 8)
    bc = min(128, -(-s // 128) * 128)
    tqp, tkp, dhp = -(-tq // br) * br, -(-s // bc) * bc, -(-dh // 128) * 128

    def pad(t, t_pad):
        return jnp.pad(jnp.asarray(t.numpy()),
                       ((0, 0), (0, t_pad - t.shape[1]), (0, dhp - dh)))

    o_j = flash_attention_fwd_pallas(
        pad(qf, tqp), pad(kf, tkp), pad(vf, tkp), rep=rep, scale=dh ** -0.5,
        q_len=tq, kv_len=s, causal=causal, q_offset=off, br=br, bc=bc,
        interpret=True)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_j[:, :tq, :dh]),
                               atol=ATOL)
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
    assert launch_counts()["flash_stats"] == launch_counts()[
        "flash_apply"] == 0


def test_wrappers_reject_bad_operands():
    q = torch.zeros(4, 8, 16)
    with pytest.raises(ValueError):
        flash_stats(q, torch.zeros(3, 8, 16))          # 4 planes over 3
    with pytest.raises(ValueError):
        flash_stats(q.double(), torch.zeros(2, 8, 16).double())
    with pytest.raises(ValueError):
        flash_stats(q, torch.zeros(2, 0, 16))          # no keys
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
