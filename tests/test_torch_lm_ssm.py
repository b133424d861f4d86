"""The port's Mamba2 / SSD block (``repro_torch.models.ssm`` and the
prefill state of ``repro_torch.models.blocks``) against the reference's
on the CPU: the chunked forward at a T the chunk divides, one it does not
(dt = 0 padding) and one shorter than the chunk; the one-token decode; the
state after a prefill (``_final_state_scan``, ``_ssm_state_after``); and
a prefill followed by decode steps against the forward of the longer
sequence.

Tolerance: float32 atol 2e-5 (the state sums of up to 24 steps in other
orders).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import blocks as jblocks  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.models.config import ModelConfig as JConfig  # noqa: E402
from repro.models.layers import AxisRules  # noqa: E402
from repro_torch.models import blocks as tblocks  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.models.model import load_tree  # noqa: E402

ATOL = 2e-5


@pytest.fixture(autouse=True)
def _no_autograd():
    """Forward parity only: the parameters require gradients (they are
    trainable), so each test runs without recording a graph."""
    with torch.no_grad():
        yield
B, D = 2, 32
KW = dict(name="s", family="ssm", num_layers=1, d_model=D, num_heads=2,
          num_kv_heads=2, d_ff=0, vocab_size=64, ssm_state=8,
          ssm_head_dim=8, ssm_chunk=8, param_dtype="float32")
JCFG, TCFG = JConfig(**KW), ModelConfig(**KW)


@pytest.fixture(scope="module")
def weights():
    params, _ = jssm.init_mamba(jax.random.PRNGKey(0), JCFG, jnp.float32,
                                AxisRules())
    tree = jax.tree.map(np.asarray, params)
    mod = load_tree(tssm.Mamba(TCFG, torch.float32, None,
                               torch.device("meta")), tree, "cpu")
    return tree, mod


def _x(t, seed):
    return np.random.default_rng(seed).normal(size=(B, t, D)).astype(
        np.float32)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("t", [16, 13, 5])
def test_mamba_forward_matches_reference(weights, t):
    tree, mod = weights
    x = _x(t, t)
    _close(tssm.mamba_forward(mod, TCFG, torch.from_numpy(x)),
           jssm.mamba_forward(tree, JCFG, jnp.asarray(x)))


@pytest.mark.parametrize("t", [16, 13, 5])
def test_prefill_state_matches_reference(weights, t):
    """``_final_state_scan`` and the conv buffers of ``_ssm_state_after``."""
    tree, mod = weights
    h = _x(t, 100 + t)
    _close(tblocks._final_state_scan(mod, TCFG, torch.from_numpy(h)),
           jblocks._final_state_scan(tree, JCFG, jnp.asarray(h)))
    c0 = jblocks._ssm_state_after(tree, JCFG, jnp.asarray(h))
    c1 = tblocks._ssm_state_after(mod, TCFG, torch.from_numpy(h))
    for a, b in zip(c1, c0):
        _close(a, b)


def test_mamba_decode_matches_reference(weights):
    tree, mod = weights
    rng = np.random.default_rng(7)
    cache = tuple(rng.normal(size=a.shape).astype(np.float32)
                  for a in jssm.empty_ssm_cache(JCFG, B, jnp.float32))
    xt = _x(1, 8)
    y0, c0 = jssm.mamba_decode(tree, JCFG, jnp.asarray(xt),
                               jssm.SSMCache(*map(jnp.asarray, cache)))
    y1, c1 = tssm.mamba_decode(mod, TCFG, torch.from_numpy(xt),
                               tssm.SSMCache(*map(torch.from_numpy, cache)))
    _close(y1, y0)
    for a, b in zip(c1, c0):
        _close(a, b)


def test_prefill_then_decode_is_the_forward(weights):
    """The port alone: prefill 13 steps, decode 3, each output the
    forward's row at that position."""
    _, mod = weights
    x = torch.from_numpy(_x(16, 9))
    full = tssm.mamba_forward(mod, TCFG, x)
    cache = tblocks._ssm_state_after(mod, TCFG, x[:, :13])
    for t in range(13, 16):
        y, cache = tssm.mamba_decode(mod, TCFG, x[:, t:t + 1], cache)
        _close(y, full[:, t:t + 1])


def test_empty_ssm_cache_shapes():
    c = tssm.empty_ssm_cache(TCFG, 3)
    assert c.conv_x.shape == (3, 3, TCFG.ssm_d_inner)
    assert c.conv_b.shape == c.conv_c.shape == (3, 3, 8)
    assert c.state.shape == (3, TCFG.ssm_heads, 8, 8)
    assert c.conv_x.dtype == torch.bfloat16 and c.state.dtype == torch.float32
