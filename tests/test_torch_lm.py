"""The LM model zoo of the port (``repro_torch.models``) against the
reference (``repro.models``) on the CPU, for all ten architectures at
``reduced_config`` (jamba-v0.1-52b at one unit, 8 layers: its two units
cost the reference ~20 s of eager JAX).

Both packages run the same weights: the reference's parameter pytree (its
shapes from ``jax.eval_shape`` of ``init_model``) filled from a numpy
seed, biases, norm scales and the cross-attention gate included (the
reference initialises them to 0 or 1, which would hide them), and handed
to the port by ``params_from_jax``.  ``forward`` over T + 1 tokens,
``prefill`` over T and one ``decode_step`` at position T over caches
padded to T + 3 are held to the reference's, and the port's prefill +
decode to its own forward.  Full-size parameter counts come from the
``meta`` device against ``jax.eval_shape`` of the reference's init.

Tolerance: logits atol 1e-4 (float32; |logits| <= ~5, sums of up to 8
layers in other orders), the MoE aux loss 1e-5.  In bfloat16: logits
within 5e-2 of the largest, the f32 head atol 1e-5, the cross-attention
gate bitwise (JAX's promotion rules).
"""
import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import models as jm  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.configs import list_archs  # noqa: E402
from repro.models.attention import KVCache as JKVCache  # noqa: E402
from repro_torch import models as tm  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models.attention import KVCache  # noqa: E402

ATOL = 1e-4
B, T, PAD = 2, 12, 3


def _overrides(arch):
    return dict(num_layers=8) if arch.startswith("jamba") else {}


def fill(shapes, seed):
    """Weights for the reference's parameter tree of ``shapes``
    (ShapeDtypeStructs), float32 from ``np.random.default_rng(seed)``:
    each matrix at scale d_in^-1/2, as the reference draws it."""
    rng = np.random.default_rng(seed)

    def draw(path, s):
        name = str(path[-1].key)
        shape = s.shape
        if name == "table":
            return (rng.normal(size=shape) * 0.02).astype(np.float32)
        if name == "a_log":
            return np.broadcast_to(np.log(np.linspace(
                1.0, 16.0, shape[-1])), shape).astype(np.float32)
        if name == "dt_bias":
            dt = np.exp(rng.uniform(np.log(1e-3), np.log(0.1), shape))
            return np.log(np.expm1(dt)).astype(np.float32)
        if name in ("scale", "d_skip"):
            return (1 + 0.2 * rng.normal(size=shape)).astype(np.float32)
        if name in ("b", "xgate"):
            return (0.5 * rng.normal(size=shape)).astype(np.float32)
        if name.startswith("conv"):
            return (0.1 * rng.normal(size=shape)).astype(np.float32)
        return (rng.normal(size=shape) * shape[-2] ** -0.5).astype(
            np.float32)
    return jax.tree_util.tree_map_with_path(draw, shapes)


def _pad_jax(caches):
    pad = ((0, 0), (0, 0), (0, PAD), (0, 0), (0, 0))    # (R, B, S, H, Dh)
    return tuple(JKVCache(jnp.pad(c.k, pad), jnp.pad(c.v, pad))
                 if isinstance(c, JKVCache) else c for c in caches)


def _pad_torch(caches):
    return [KVCache(*(torch.nn.functional.pad(t, (0, 0, 0, 0, 0, PAD))
                      for t in c)) if isinstance(c, KVCache) else c
            for c in caches]


@pytest.fixture(scope="module", params=list_archs())
def case(request):
    """The reference's outputs for one architecture, computed once."""
    arch = request.param
    cfg = jm.reduced_config(jget(arch), **_overrides(arch))
    shapes = jax.eval_shape(lambda k: jm.init_model(k, cfg)[0],
                            jax.random.PRNGKey(0))
    tree = fill(shapes, seed=0)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab_size, (B, T + 1)).astype(np.int32)
    ctx = None
    if cfg.family == "vlm":
        ctx = rng.normal(size=(B, cfg.vision_tokens, cfg.vision_d))
    if cfg.is_encdec:
        ctx = rng.normal(size=(B, cfg.audio_frames, cfg.d_model))
    ctx = None if ctx is None else ctx.astype(np.float32)
    jctx = None if ctx is None else jnp.asarray(ctx)
    params = jax.tree.map(jnp.asarray, tree)
    out = jm.forward(params, cfg, jnp.asarray(toks), jctx)
    lp, caches = jm.prefill(params, cfg, jnp.asarray(toks[:, :T]), jctx)
    ld, _ = jm.decode_step(params, cfg, jnp.asarray(toks[:, T:]),
                           _pad_jax(caches), jnp.int32(T), jctx)
    tcfg = tm.reduced_config(get_config(arch), **_overrides(arch))
    return dict(arch=arch, cfg=cfg, tcfg=tcfg, tree=tree, toks=toks,
                ctx=ctx, n_params=jm.param_count(params),
                logits=np.asarray(out.logits), aux=float(out.aux_loss),
                prefill=np.asarray(lp), decode=np.asarray(ld),
                model=tm.params_from_jax(tcfg, tree, device="cpu"))


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.numpy(), want, atol=atol, rtol=0)


def test_forward_matches_reference(case):
    with torch.inference_mode():
        out = tm.forward(case["model"], _t(case["toks"]).long(),
                         _t(case["ctx"]))
    assert out.logits.shape == case["logits"].shape
    assert out.logits.dtype == torch.float32
    _close(out.logits, case["logits"])
    np.testing.assert_allclose(float(out.aux_loss), case["aux"], atol=1e-5)


def test_prefill_matches_reference(case):
    with torch.inference_mode():
        lp, _ = tm.prefill(case["model"], _t(case["toks"][:, :T]).long(),
                           _t(case["ctx"]))
    _close(lp, case["prefill"])


def test_decode_step_matches_reference(case):
    model, toks, ctx = case["model"], _t(case["toks"]).long(), _t(case["ctx"])
    with torch.inference_mode():
        _, caches = tm.prefill(model, toks[:, :T], ctx)
        ld, new = tm.decode_step(model, toks[:, T:], _pad_torch(caches), T,
                                 ctx)
    assert len(new) == case["tcfg"].num_layers
    _close(ld, case["decode"])


def test_prefill_decode_is_the_forward(case):
    """The port alone: prefill(T) + decode(T) == forward(T + 1) at the
    last position (MoE layers at capacity E, with no drop)."""
    tcfg = case["tcfg"]
    model = case["model"]
    if tcfg.num_experts:
        model.cfg = dataclasses.replace(tcfg,
                                        capacity_factor=float(tcfg.num_experts))
    toks, ctx = _t(case["toks"]).long(), _t(case["ctx"])
    try:
        with torch.inference_mode():
            full = tm.forward(model, toks, ctx).logits
            lp, caches = tm.prefill(model, toks[:, :T], ctx)
            ld, _ = tm.decode_step(model, toks[:, T:], _pad_torch(caches), T,
                                   ctx)
    finally:
        model.cfg = tcfg
    _close(lp, full[:, T - 1:T].numpy())
    _close(ld, full[:, T:].numpy())


def test_param_count_matches_reference(case):
    assert tm.param_count(case["model"]) == case["n_params"]
    names = {n for n, _ in case["model"].named_parameters()}
    assert "embed.table" in names


@pytest.mark.parametrize("arch", list_archs())
def test_full_size_param_count_matches_eval_shape(arch):
    """At full size, on the meta device (no allocation), against
    ``jax.eval_shape`` of the reference's init; the port's parameter
    dtypes are the config's (SSM a_log, dt_bias, d_skip and the gate in
    float32)."""
    shapes = jax.eval_shape(lambda k: jm.init_model(k, jget(arch))[0],
                            jax.random.PRNGKey(0))
    want = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))
    model = tm.init_model(get_config(arch), device="meta")
    assert tm.param_count(model) == want
    dtypes = {p.dtype for p in model.parameters()}
    assert dtypes <= {torch.bfloat16, torch.float32}
    assert model.embed.table.dtype == torch.bfloat16
    if arch == "qwen1.5-0.5b":
        assert want == 619_832_320
        assert model.lm_head.w.shape == (1024, 152_064)


def test_loss_fn_matches_reference():
    arch = "granite-moe-3b-a800m"          # the aux losses count too
    cfg = jm.reduced_config(jget(arch))
    tree = fill(jax.eval_shape(lambda k: jm.init_model(k, cfg)[0],
                               jax.random.PRNGKey(0)), seed=3)
    rng = np.random.default_rng(4)
    batch = {k: rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)
             for k in ("tokens", "labels")}
    loss0, m0 = jm.loss_fn(jax.tree.map(jnp.asarray, tree), cfg,
                           {k: jnp.asarray(v) for k, v in batch.items()})
    model = tm.params_from_jax(tm.reduced_config(get_config(arch)), tree,
                               device="cpu")
    with torch.inference_mode():
        loss1, m1 = tm.loss_fn(model, {k: torch.from_numpy(v).long()
                                       for k, v in batch.items()})
    np.testing.assert_allclose(float(loss1), float(loss0), atol=1e-5)
    for key in ("nll", "aux", "ppl"):
        np.testing.assert_allclose(float(m1[key]), float(m0[key]),
                                   rtol=1e-5)


def test_params_from_jax_takes_the_reference_init():
    """The reference's own init (zero biases, unit scales), tree for tree:
    every parameter lands where the reference keeps it."""
    cfg = jm.reduced_config(jget("qwen1.5-0.5b"))
    params, _ = jm.init_model(jax.random.PRNGKey(5), cfg)
    tree = jax.tree.map(np.asarray, params)
    model = tm.params_from_jax(tm.reduced_config(get_config("qwen1.5-0.5b")),
                               tree, device="cpu")
    unit = len(cfg.block_program()[0])
    for r in range(cfg.num_layers // unit):
        np.testing.assert_array_equal(
            model.blocks[r * unit].attn.wq.w.detach().numpy(),
            tree["blocks"][0]["attn"]["wq"]["w"][r])
    np.testing.assert_array_equal(model.lm_head.w.detach().numpy(),
                                  tree["lm_head"]["w"])


def test_init_model_needs_a_device_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = tm.reduced_config(get_config("qwen1.5-0.5b"))
    with pytest.raises(RuntimeError, match="CUDA"):
        tm.init_model(cfg)
    a = tm.init_model(cfg, device="cpu", seed=3)
    b = tm.init_model(cfg, device="cpu", seed=3)
    for (na, pa), (nb, pb) in zip(a.named_parameters(), b.named_parameters()):
        assert na == nb and torch.equal(pa, pb)


def test_decode_from_empty_caches_greedy_loop():
    """Greedy decode 6 tokens from empty caches (the reference's
    ``test_decode_from_empty_cache_greedy_loop``): shapes, finite logits,
    the padded vocabulary never chosen."""
    cfg = tm.reduced_config(get_config("mamba2-370m"), vocab_size=250)
    model = tm.init_model(cfg, device="cpu")
    caches = tm.make_caches(cfg, B, 8, torch.float32, device="cpu")
    tok = torch.zeros(B, 1, dtype=torch.long)
    with torch.inference_mode():
        for pos in range(6):
            logits, caches = tm.decode_step(model, tok, caches, pos)
            assert logits.shape == (B, 1, cfg.padded_vocab)
            assert torch.isfinite(logits[..., :cfg.vocab_size]).all()
            assert (logits[..., cfg.vocab_size:] == -1e30).all()
            tok = logits.argmax(-1)
            assert (tok < cfg.vocab_size).all()


# ------------------------------------------------ bfloat16: JAX's promotion

BF16_ARCHS = ["qwen1.5-0.5b", "whisper-small", "llama-3.2-vision-90b",
              "mamba2-370m"]


def _bf16_case(arch, seed=0):
    cfg = jm.reduced_config(jget(arch), param_dtype="bfloat16")
    shapes = jax.eval_shape(lambda k: jm.init_model(k, cfg)[0],
                            jax.random.PRNGKey(0))
    params = jax.tree.map(lambda a, s: jnp.asarray(a).astype(s.dtype),
                          fill(shapes, seed), shapes)
    model = tm.params_from_jax(
        tm.reduced_config(get_config(arch), param_dtype="bfloat16"),
        jax.tree.map(np.asarray, params), device="cpu")
    return cfg, params, model


@pytest.mark.parametrize("arch", BF16_ARCHS)
def test_bf16_forward_within_the_bf16_envelope(arch):
    """At bfloat16 the reference forms bf16 scores and probabilities and
    the flash kernels compute in f32, so the two round apart: the logits
    agree within 5e-2 of the largest (the bf16 envelope through the
    layers; measured 1-2.3%).  MoE archs are left out: a bf16 router
    near-tie routes a token apart."""
    cfg, params, model = _bf16_case(arch)
    assert model.embed.table.dtype == torch.bfloat16
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab_size, (B, T + 1)).astype(np.int32)
    ctx = None
    if cfg.family == "vlm":
        ctx = rng.normal(size=(B, cfg.vision_tokens, cfg.vision_d))
    if cfg.is_encdec:
        ctx = rng.normal(size=(B, cfg.audio_frames, cfg.d_model))
    ctx = None if ctx is None else ctx.astype(np.float32)
    want = np.asarray(jm.forward(params, cfg, jnp.asarray(toks),
                                 None if ctx is None else jnp.asarray(ctx)
                                 ).logits)[..., :cfg.vocab_size]
    with torch.inference_mode():
        got = tm.forward(model, _t(toks).long(), _t(ctx)).logits
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy()[..., :cfg.vocab_size], want,
                               atol=5e-2 * np.abs(want).max(), rtol=0)


def test_bf16_head_computes_in_float32():
    """A bf16 ``lm_head`` under f32 activations computes in f32, as JAX
    promotes it (a bf16 product would be ~1e-2 off)."""
    from repro.models.model import _head as jhead
    from repro_torch.models.model import _head as thead
    cfg, params, model = _bf16_case("qwen1.5-0.5b", seed=2)
    x = np.random.default_rng(3).normal(size=(B, 3, cfg.d_model)).astype(
        np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    want = np.asarray(jhead(params, cfg, xb))
    with torch.inference_mode():
        got = thead(model, torch.from_numpy(np.array(xb.astype(
            jnp.float32))).to(torch.bfloat16))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_bf16_cross_attention_gate_multiplies_in_float32(monkeypatch):
    """The tanh gate is a 0-d f32 parameter: JAX forms gate * y in f32 and
    casts, torch would form it in bf16.  The port's ``_gated`` is
    bitwise the reference's expression on the same cross-attention
    output."""
    from repro_torch.models import blocks as tblocks
    rng = np.random.default_rng(4)
    x = jnp.asarray(rng.normal(size=(B, T, 8)), jnp.bfloat16)
    y = jnp.asarray(rng.normal(size=(B, T, 8)), jnp.bfloat16)
    gate = np.float32(0.7310586)
    want = np.asarray((x + (jnp.tanh(jnp.float32(gate)) * y).astype(
        x.dtype)).astype(jnp.float32))

    def bf16(a):
        return torch.from_numpy(np.asarray(a.astype(jnp.float32))).to(
            torch.bfloat16)

    monkeypatch.setattr(tblocks.attn, "cross_attention",
                        lambda *a: bf16(y))
    layer = types.SimpleNamespace(
        xattn=None, norm_c=types.SimpleNamespace(
            scale=torch.ones(8, dtype=torch.bfloat16)),
        xgate=torch.tensor(gate))
    cfg = types.SimpleNamespace(norm_eps=1e-5)
    got = tblocks._gated(layer, cfg, bf16(x), None).float().numpy()
    np.testing.assert_array_equal(got, want)
    naive = (bf16(x) + torch.tanh(torch.tensor(gate)) * bf16(y)).float()
    assert not np.array_equal(naive.numpy(), want)
