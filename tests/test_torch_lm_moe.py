"""The port's Mixture-of-Experts (``repro_torch.models.moe``) against the
reference's (``repro.models.moe``) on the CPU: both dispatches, with and
without capacity drops, one group and several, outputs and aux losses.

Routes must agree exactly, so the inputs (numpy seed 0 for the weights'
key and 1 + case for x) are checked to hold no near-tie: every token's
k + 1 largest router probabilities are at least 1e-6 apart, far above
the float32 differences of the two router products (~1e-7).

Tolerance: float32 atol 2e-5 on y and the aux losses.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import moe as jmoe  # noqa: E402
from repro.models.config import ModelConfig as JConfig  # noqa: E402
from repro.models.layers import AxisRules  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.models.model import load_tree  # noqa: E402

ATOL = 2e-5
MIN_GAP = 1e-6


@pytest.fixture(autouse=True)
def _no_autograd():
    """Forward parity only: the parameters require gradients (they are
    trainable), so each test runs without recording a graph."""
    with torch.no_grad():
        yield
E, K, D = 4, 2, 16


def _cfgs(group, impl):
    kw = dict(name="m", family="moe", num_layers=1, d_model=D, num_heads=2,
              num_kv_heads=2, d_ff=32, vocab_size=64, num_experts=E,
              num_experts_per_tok=K, moe_d_ff=8, moe_group_size=group,
              moe_impl=impl, param_dtype="float32")
    return JConfig(**kw), ModelConfig(**kw)


@pytest.fixture(scope="module")
def weights():
    params, _ = jmoe.init_moe(jax.random.PRNGKey(0), _cfgs(8, "einsum")[0],
                              jnp.float32, AxisRules())
    tree = jax.tree.map(np.asarray, params)
    mod = load_tree(tmoe.MoE(_cfgs(8, "einsum")[1], torch.float32, None,
                             torch.device("meta")), tree, "cpu")
    return tree, mod


def _no_near_tie(tree, x):
    logits = x.reshape(-1, D).astype(np.float64) @ tree["router"]
    p = np.exp(logits - logits.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    top = -np.sort(-p, axis=-1)[:, :K + 1]
    return float(np.min(top[:, :-1] - top[:, 1:]))


# (B, T, group): 24 tokens in 3 groups of 8, and 14 tokens that 8 does
# not divide (one group of 14).
SHAPES = [(2, 12, 8), (2, 7, 8)]


@pytest.mark.parametrize("impl", ["einsum", "gather"])
@pytest.mark.parametrize("cf", [1.0, float(E)])
@pytest.mark.parametrize("case", range(len(SHAPES)))
def test_moe_matches_reference(weights, impl, cf, case):
    tree, mod = weights
    b, t, group = SHAPES[case]
    jcfg, tcfg = _cfgs(group, impl)
    x = np.random.default_rng(1 + case).normal(size=(b, t, D)).astype(
        np.float32)
    assert _no_near_tie(tree, x) > MIN_GAP
    jf = jmoe.moe_ffn_gather if impl == "gather" else jmoe.moe_ffn
    tf = tmoe.moe_ffn_gather if impl == "gather" else tmoe.moe_ffn
    y0, aux0 = jf(tree, jcfg, jnp.asarray(x), capacity_factor=cf)
    y1, aux1 = tf(mod, tcfg, torch.from_numpy(x), capacity_factor=cf)
    np.testing.assert_allclose(y1.numpy(), np.asarray(y0), atol=ATOL, rtol=0)
    for key in ("moe_balance", "router_z"):
        np.testing.assert_allclose(float(aux1[key]), float(aux0[key]),
                                   atol=ATOL, rtol=0)


@pytest.mark.parametrize("case", range(len(SHAPES)))
def test_capacity_one_drops_tokens_and_both_dispatches_agree(weights, case):
    """At cf 1.0 some (token, expert) pairs drop (the output moves from
    the no-drop one), and the einsum and gather dispatches drop the same
    pairs."""
    _, mod = weights
    b, t, group = SHAPES[case]
    x = torch.from_numpy(np.random.default_rng(1 + case).normal(
        size=(b, t, D)).astype(np.float32))
    cfg = _cfgs(group, "einsum")[1]
    full, _ = tmoe.moe_ffn(mod, cfg, x, capacity_factor=float(E))
    drop, _ = tmoe.moe_ffn(mod, cfg, x, capacity_factor=1.0)
    gdrop, _ = tmoe.moe_ffn_gather(mod, dataclasses.replace(
        cfg, moe_impl="gather"), x, capacity_factor=1.0)
    assert float((full - drop).abs().max()) > 1e-3
    torch.testing.assert_close(gdrop, drop, atol=ATOL, rtol=0)


def test_topk_matches_reference_and_takes_the_first_maximum():
    """Iterated argmax: torch's first-maximum tie rule is JAX's, so an
    exact tie routes alike."""
    probs = np.array([[0.3, 0.3, 0.2, 0.2], [0.1, 0.4, 0.4, 0.1],
                      [0.25, 0.25, 0.25, 0.25]], np.float32)
    g0, s0 = jmoe._topk_onehot(jnp.asarray(probs), 2)
    g1, s1 = tmoe._topk_onehot(torch.from_numpy(probs), 2)
    np.testing.assert_array_equal(s1.numpy(), np.asarray(s0))
    np.testing.assert_array_equal(g1.numpy(), np.asarray(g0))
    i0, h0 = jmoe._topk_idx_gates(jnp.asarray(probs), 3)
    i1, h1 = tmoe._topk_idx_gates(torch.from_numpy(probs), 3)
    np.testing.assert_array_equal(i1.numpy(), np.asarray(i0))
    np.testing.assert_array_equal(h1.numpy(), np.asarray(h0))
