"""The LM zoo's layers in the port (``repro_torch.models.layers`` and
``repro_torch.models.attention``) against the reference's
(``repro.models.layers``, ``repro.models.attention``) on the CPU, with the
reference's weights carried across as numpy arrays.

The port's attention runs on the flash kernels' plain twins here (CPU
tensors); the reference computes it as einsums.  Inputs come from numpy
seeds; biases, which the reference initialises to zero, are drawn at
random so that they count.

Tolerance: float32 atol 2e-5 (the flash tests' forward bound: sums over
keys and features in other orders); RMSNorm and the unembedding 1e-6;
RoPE 8e-6 (angles up to 4096 rad: the libraries' sin and cos differ by a
few ulp of the angle).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import attention as jattn  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro.models.config import ModelConfig as JConfig  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.models.model import load_tree  # noqa: E402

ATOL = 2e-5


@pytest.fixture(autouse=True)
def _no_autograd():
    """Forward parity only: the parameters require gradients (they are
    trainable), so each test runs without recording a graph."""
    with torch.no_grad():
        yield
B, T = 2, 11


def _tree(params, rng):
    """The reference's params as numpy, zero-initialised biases drawn."""
    tree = jax.tree.map(np.asarray, params)

    def draw(node):
        if isinstance(node, dict):
            return {k: (rng.normal(size=v.shape).astype(np.float32) * 0.3
                        if k == "b" else draw(v)) for k, v in node.items()}
        return node
    return draw(tree)


def _cfgs(hkv, bias):
    kw = dict(name="t", family="dense", num_layers=1, d_model=32,
              num_heads=4, num_kv_heads=hkv, d_ff=64, vocab_size=97,
              head_dim=8, qkv_bias=bias, rope_theta=500.0,
              param_dtype="float32")
    return JConfig(**kw), ModelConfig(**kw)


def _attention(hkv, bias, seed):
    jcfg, tcfg = _cfgs(hkv, bias)
    params, _ = jattn.init_attention(jax.random.PRNGKey(seed), jcfg,
                                     jnp.float32, jl.AxisRules())
    tree = _tree(params, np.random.default_rng(seed))
    mod = load_tree(tattn.Attention(tcfg, torch.float32, None,
                                    torch.device("meta")), tree, "cpu")
    return jcfg, tcfg, tree, mod


def _x(seed, t=T, d=32):
    return np.random.default_rng(seed).normal(size=(B, t, d)).astype(
        np.float32)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=0)


ATTN = [(4, False), (4, True), (2, False), (2, True)]   # MHA, GQA x bias


@pytest.mark.parametrize("hkv,bias", ATTN)
@pytest.mark.parametrize("causal", [True, False])
def test_attention_full_matches_reference(hkv, bias, causal):
    jcfg, tcfg, tree, mod = _attention(hkv, bias, seed=1)
    x = _x(2)
    want = jattn.attention_full(tree, jcfg, jnp.asarray(x), causal=causal)
    got = tattn.attention_full(mod, tcfg, torch.from_numpy(x), causal=causal)
    _close(got, want)


@pytest.mark.parametrize("hkv,bias", ATTN)
def test_attention_prefill_matches_reference(hkv, bias):
    jcfg, tcfg, tree, mod = _attention(hkv, bias, seed=3)
    x = _x(4)
    y0, c0 = jattn.attention_prefill(tree, jcfg, jnp.asarray(x))
    y1, c1 = tattn.attention_prefill(mod, tcfg, torch.from_numpy(x))
    _close(y1, y0)
    _close(c1.k, c0.k)
    _close(c1.v, c0.v)


@pytest.mark.parametrize("hkv,bias", ATTN)
@pytest.mark.parametrize("pos", [T, T + 2])
def test_attention_decode_matches_reference(hkv, bias, pos):
    """One step over a prefilled cache padded to T + 4, written at
    ``pos`` (T + 2 leaves two zero rows unscored before it); the port
    writes the cache in place."""
    jcfg, tcfg, tree, mod = _attention(hkv, bias, seed=5)
    x, xt = _x(6), _x(7, t=1)
    _, c0 = jattn.attention_prefill(tree, jcfg, jnp.asarray(x))
    pad = ((0, 0), (0, 4), (0, 0), (0, 0))
    c0 = jattn.KVCache(jnp.pad(c0.k, pad), jnp.pad(c0.v, pad))
    c1 = tattn.KVCache(*(torch.from_numpy(np.array(a)) for a in c0))
    y0, n0 = jattn.attention_decode(tree, jcfg, jnp.asarray(xt), c0,
                                    jnp.int32(pos))
    y1, n1 = tattn.attention_decode(mod, tcfg, torch.from_numpy(xt), c1, pos)
    _close(y1, y0)
    assert n1.k is c1.k and n1.v is c1.v
    _close(n1.k, n0.k)
    _close(n1.v, n0.v)


@pytest.mark.parametrize("hkv,bias", ATTN)
def test_cross_attention_and_context_kv_match_reference(hkv, bias):
    jcfg, tcfg, tree, mod = _attention(hkv, bias, seed=8)
    x, ctx = _x(9), _x(10, t=7)
    k0 = jattn.context_kv(tree, jcfg, jnp.asarray(ctx))
    k1 = tattn.context_kv(mod, tcfg, torch.from_numpy(ctx))
    _close(k1.k, k0.k)
    _close(k1.v, k0.v)
    _close(tattn.cross_attention(mod, tcfg, torch.from_numpy(x), k1),
           jattn.cross_attention(tree, jcfg, jnp.asarray(x), k0))


def test_empty_cache_shape_and_dtype():
    _, tcfg = _cfgs(2, False)
    c = tattn.empty_cache(tcfg, 3, 5)
    assert c.k.shape == c.v.shape == (3, 5, 2, 8)
    assert c.k.dtype == torch.bfloat16 and not c.k.any()


@pytest.mark.parametrize("shape", [(2, 5, 16), (3, 1, 64)])
def test_rmsnorm_matches_reference(shape):
    rng = np.random.default_rng(11)
    x = (rng.normal(size=shape) * 3).astype(np.float32)
    scale = rng.normal(size=shape[-1:]).astype(np.float32)
    mod = load_tree(tl.RMSNorm(shape[-1], torch.float32, "meta"),
                    {"scale": scale}, "cpu")
    _close(tl.rmsnorm(mod, torch.from_numpy(x), 1e-5),
           jl.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x), 1e-5),
           atol=1e-6)


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_apply_rope_matches_reference(theta):
    rng = np.random.default_rng(12)
    x = rng.normal(size=(2, 9, 3, 16)).astype(np.float32)
    pos = rng.integers(0, 4096, size=(2, 9)).astype(np.int32)
    want = jl.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    got = tl.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
    _close(got, want, atol=8e-6)


def test_mlp_matches_reference():
    params, _ = jl.init_mlp(jax.random.PRNGKey(13), 32, 48, jnp.float32,
                            jl.AxisRules())
    tree = jax.tree.map(np.asarray, params)
    mod = load_tree(tl.MLP(32, 48, torch.float32, None, "meta"), tree, "cpu")
    x = _x(14)
    _close(tl.mlp(mod, torch.from_numpy(x)), jl.mlp(tree, jnp.asarray(x)))


def test_embed_unembed_match_reference():
    params, _ = jl.init_embedding(jax.random.PRNGKey(15), 97, 32,
                                  jnp.float32, jl.AxisRules())
    tree = jax.tree.map(np.asarray, params)
    mod = load_tree(tl.Embedding(97, 32, torch.float32, None, "meta"), tree,
                    "cpu")
    tok = np.random.default_rng(16).integers(0, 97, size=(B, T))
    e0 = jl.embed(tree, jnp.asarray(tok, jnp.int32))
    e1 = tl.embed(mod, torch.from_numpy(tok))
    np.testing.assert_array_equal(e1.numpy(), np.asarray(e0))
    _close(tl.unembed(mod, e1), jl.unembed(tree, e0), atol=1e-6)


def test_linear_promotes_like_jax():
    """f32 x bf16 weight computes in f32 in both packages."""
    rng = np.random.default_rng(17)
    w = rng.normal(size=(8, 5)).astype(np.float32)
    x = rng.normal(size=(3, 8)).astype(np.float32)
    jw = jnp.asarray(w, jnp.bfloat16)
    mod = tl.Linear(8, 5, torch.bfloat16, None, "meta")
    mod = load_tree(mod, {"w": np.asarray(jw)}, "cpu")
    assert mod.w.dtype == torch.bfloat16
    got = tl.linear(mod, torch.from_numpy(x))
    want = jl.linear({"w": jw}, jnp.asarray(x))
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    _close(got, want, atol=1e-5)


def test_configs_read_the_same_in_both_packages():
    from repro.configs import get_config as jget
    from repro.configs import list_archs
    from repro_torch.configs import get_config, list_archs as tlist
    assert tlist() == list_archs()
    for arch in list_archs():
        a, b = dataclasses.asdict(jget(arch)), dataclasses.asdict(
            get_config(arch))
        assert a == b
        assert jget(arch).block_program() == get_config(arch).block_program()
        assert jget(arch).padded_vocab == get_config(arch).padded_vocab


def test_shape_cells_read_the_same_in_both_packages():
    from repro.models.config import SHAPE_CELLS as JCELLS
    from repro.models.config import cell_by_name as jcell
    from repro_torch.models.config import SHAPE_CELLS, cell_by_name
    assert [dataclasses.asdict(c) for c in SHAPE_CELLS] == [
        dataclasses.asdict(c) for c in JCELLS]
    for c in JCELLS:
        assert dataclasses.asdict(cell_by_name(c.name)) == dataclasses.asdict(
            jcell(c.name))
    with pytest.raises(KeyError):
        cell_by_name("train_1m")
