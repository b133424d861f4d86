"""LM training in the port (``repro_torch.launch.steps``) against the
reference (``repro.launch.steps``) on the CPU, at ``reduced_config`` in
float32.

Both packages run the same weights: the reference's parameter tree filled
from a numpy seed (``fill`` of ``tests/test_torch_lm.py``), handed to the
port by ``params_from_jax``, on the same numpy batches.

- Gradients of ``loss_fn``: ``jax.value_and_grad`` against the port's
  autograd (``value_and_grad``), every leaf within ``1e-5 * max|g_leaf| +
  1e-7``; the reference's stacked leaves are compared to the port's
  per-layer ones through ``params_from_jax``'s naming.  The MoE model's
  routes are checked for near-ties first, as ``tests/test_torch_lm_moe.py``
  does: a flipped route would be another function.
- Remat (``remat=True``, policies "full" and "dots") changes no gradient
  bit.
- Three steps of ``make_train_step`` from the same weights on the same
  batches: per-step ``loss``, ``nll``, ``aux`` and ``grad_norm`` within
  1e-4 relative; step 1's gradients as above; the parameters after three
  steps within ``2 * lr * 3`` (Adam's first steps are sign-like: an entry
  whose gradient sits within rounding of zero may move the other way,
  ROADMAP.md known property 1; ``global_norm`` sums stacked leaves in the
  reference and per-layer ones here, so the clip scale may differ in its
  last bit).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import models as jm  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.launch.steps import make_train_step as jstep  # noqa: E402
from repro.optim.adam import adam_init as jadam_init  # noqa: E402
from repro_torch import models as tm  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.steps import (make_train_step, model_params,  # noqa: E402
                                      value_and_grad)
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.optim import adam_init  # noqa: E402
from test_torch_lm import fill  # noqa: E402

B, T = 2, 12
GRAD_ARCHS = ["qwen1.5-0.5b", "granite-moe-3b-a800m", "mamba2-370m",
              "whisper-small", "llama-3.2-vision-90b"]


def _batch(cfg, seed, b=B, t=T):
    rng = np.random.default_rng(seed)
    out = {k: rng.integers(0, cfg.vocab_size, (b, t)).astype(np.int32)
           for k in ("tokens", "labels")}
    if cfg.family == "vlm":
        out["context"] = rng.normal(
            size=(b, cfg.vision_tokens, cfg.vision_d)).astype(np.float32)
    if cfg.is_encdec:
        out["context"] = rng.normal(
            size=(b, cfg.audio_frames, cfg.d_model)).astype(np.float32)
    return out


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def named(cfg, tree):
    """The reference's parameter (or gradient) tree as the port's names:
    stacked leaves split per layer, as ``params_from_jax`` loads them."""
    tree = jax.tree.map(np.asarray, tree)
    flat = {k: v for k, v in tree.items() if k not in ("blocks", "encoder")}
    out = dict(tmodel._flat(flat))
    out.update(tmodel._stacked(tree, "blocks", len(cfg.block_program()[0])))
    if cfg.is_encdec:
        out.update(tmodel._stacked(tree, "encoder", 1))
    return out


def assert_grads_close(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k, g in got.items():
        w = np.asarray(want[k], np.float32)
        atol = 1e-5 * float(np.max(np.abs(w))) + 1e-7
        np.testing.assert_allclose(g.detach().float().numpy(), w, rtol=0,
                                   atol=atol, err_msg=k)


def _setup(arch, seed=0, **overrides):
    cfg = jm.reduced_config(jget(arch), **overrides)
    tree = fill(jax.eval_shape(lambda k: jm.init_model(k, cfg)[0],
                               jax.random.PRNGKey(0)), seed=seed)
    tcfg = tm.reduced_config(get_config(arch), **overrides)
    model = tm.params_from_jax(tcfg, tree, device="cpu")
    return cfg, tcfg, tree, model


def _route_margin(tcfg, model, batch):
    """The smallest gap, over every MoE layer's tokens, between the
    top-k-th and the next router probability: a near-tie flips a route
    under another summation order."""
    from repro_torch.models import moe as tmoe
    margins = []

    def hook(p, tokens):
        logits, probs = orig(p, tokens)
        top = torch.topk(probs, tcfg.num_experts_per_tok + 1, dim=-1).values
        margins.append(float((top[..., -2] - top[..., -1]).min()))
        return logits, probs

    orig = tmoe._router
    tmoe._router = hook
    try:
        with torch.no_grad():
            tm.loss_fn(model, batch)
    finally:
        tmoe._router = orig
    return min(margins)


@pytest.mark.parametrize("arch", GRAD_ARCHS)
def test_loss_gradients_match_reference(arch):
    cfg, tcfg, tree, model = _setup(arch)
    batch = _batch(cfg, seed=1)
    params = jax.tree.map(jnp.asarray, tree)
    (loss0, m0), g0 = jax.value_and_grad(jm.loss_fn, has_aux=True)(
        params, cfg, {k: jnp.asarray(v) for k, v in batch.items()})
    if tcfg.num_experts:
        assert _route_margin(tcfg, model, _tb(batch)) > 1e-5
    (loss1, m1), g1 = value_and_grad(tcfg)(model_params(model), _tb(batch))
    np.testing.assert_allclose(float(loss1), float(loss0), rtol=1e-5)
    for key in ("nll", "aux"):
        np.testing.assert_allclose(float(m1[key]), float(m0[key]),
                                   rtol=1e-5, atol=1e-7)
    assert_grads_close(g1, named(cfg, g0))


@pytest.mark.parametrize("arch,policy", [
    ("qwen1.5-0.5b", "full"), ("qwen1.5-0.5b", "dots"),
    ("granite-moe-3b-a800m", "full"), ("mamba2-370m", "full"),
    ("whisper-small", "full"), ("llama-3.2-vision-90b", "dots")])
def test_remat_changes_no_gradient_bit(arch, policy):
    """Each unit under torch.utils.checkpoint (and, for "dots", selective
    checkpointing that keeps the matrix products) recomputes exactly the
    values it dropped."""
    _, tcfg, _, model = _setup(arch)
    batch = _tb(_batch(tcfg, seed=2))
    params = model_params(model)
    (l0, _), g0 = value_and_grad(tcfg)(params, batch)
    rcfg = dataclasses.replace(tcfg, remat=True, remat_policy=policy)
    (l1, _), g1 = value_and_grad(rcfg)(params, batch)
    assert torch.equal(l0, l1)
    for k in g0:
        assert torch.equal(g0[k], g1[k]), k


def test_remat_recomputes_attention_in_the_backward(monkeypatch):
    """Under remat the backward runs each unit's forward again: twice the
    flash forwards of a step without it."""
    from repro_torch.models import attention as tattn
    calls = []
    orig = tattn.flash_attention

    def counted(*a, **kw):
        calls.append(1)
        return orig(*a, **kw)

    monkeypatch.setattr(tattn, "flash_attention", counted)
    _, tcfg, _, model = _setup("qwen1.5-0.5b")
    batch = _tb(_batch(tcfg, seed=3))
    for remat, want in ((False, tcfg.num_layers), (True,
                                                   2 * tcfg.num_layers)):
        calls.clear()
        value_and_grad(dataclasses.replace(tcfg, remat=remat))(
            model_params(model), batch)
        assert len(calls) == want


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "granite-moe-3b-a800m"])
def test_three_train_steps_match_reference(arch):
    lr = 3e-4
    cfg, tcfg, tree, model = _setup(arch, seed=4)
    batches = [_batch(cfg, seed=10 + i) for i in range(3)]
    jstate = {"params": jax.tree.map(jnp.asarray, tree),
              "opt": jadam_init(jax.tree.map(jnp.asarray, tree))}
    params = model_params(model)
    tstate = {"params": params, "opt": adam_init(params)}
    js, ts = jax.jit(jstep(cfg, lr=lr)), make_train_step(tcfg, lr=lr)
    if tcfg.num_experts:
        for b in batches:
            assert _route_margin(tcfg, model, _tb(b)) > 1e-5
    (_, _), g0 = jax.value_and_grad(jm.loss_fn, has_aux=True)(
        jstate["params"], cfg, {k: jnp.asarray(v)
                                for k, v in batches[0].items()})
    (_, _), g1 = value_and_grad(tcfg)(params, _tb(batches[0]))
    assert_grads_close(g1, named(cfg, g0))
    for b in batches:
        jstate, jm_ = js(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        tstate, tm_ = ts(tstate, _tb(b))
        for key in ("loss", "nll", "aux", "grad_norm"):
            np.testing.assert_allclose(float(tm_[key]), float(jm_[key]),
                                       rtol=1e-4, atol=1e-7, err_msg=key)
    want = named(cfg, jstate["params"])
    assert int(tstate["opt"].step) == 3
    for k, p in tstate["params"].items():
        np.testing.assert_allclose(p.numpy(), want[k], rtol=0,
                                   atol=2 * lr * 3, err_msg=k)


def test_train_step_state_layout():
    """The state is {"params": by name, "opt": AdamState of the same
    names}; a step returns new tensors and leaves its input untouched."""
    _, tcfg, _, model = _setup("qwen1.5-0.5b")
    params = model_params(model)
    state = {"params": params, "opt": adam_init(params)}
    before = {k: v.clone() for k, v in params.items()}
    new, metrics = make_train_step(tcfg)(state, _tb(_batch(tcfg, 5)))
    assert sorted(new) == ["opt", "params"]
    assert sorted(new["params"]) == sorted(params)
    assert sorted(new["opt"].mu) == sorted(params)
    assert sorted(metrics) == ["aux", "grad_norm", "loss", "nll", "ppl"]
    assert all(not v.requires_grad for v in new["params"].values())
    for k, v in params.items():
        assert torch.equal(v, before[k])
        assert not torch.equal(new["params"][k], v) or k.endswith("xgate")


def test_dots_policy_keeps_the_matrix_products():
    """``remat_policy="dots"`` saves the outputs of the 2-D matrix
    products: its backward runs no ``mm`` that the step without remat
    does not run, where "full" runs the forward's again."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.mm = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.mm += func in (torch.ops.aten.mm.default,
                                torch.ops.aten.addmm.default)
            return func(*args, **(kwargs or {}))

    _, tcfg, _, model = _setup("qwen1.5-0.5b")
    batch = _tb(_batch(tcfg, seed=6))
    counts = {}
    for name, over in (("none", dict(remat=False)),
                       ("full", dict(remat=True, remat_policy="full")),
                       ("dots", dict(remat=True, remat_policy="dots"))):
        with Count() as c:
            value_and_grad(dataclasses.replace(tcfg, **over))(
                model_params(model), batch)
        counts[name] = c.mm
    assert counts["dots"] == counts["none"] < counts["full"]


def test_unreached_parameters_get_zero_gradients():
    """The vision model at two layers has no cross-attention layer, so the
    loss never reaches ``vision_proj``: its gradient is zeros, as
    ``jax.grad`` gives, and every other leaf the reference's."""
    cfg, tcfg, tree, model = _setup("llama-3.2-vision-90b", num_layers=2)
    assert "cross_attn" not in tcfg.block_program()[0]
    batch = _batch(cfg, seed=7)
    (_, _), g0 = jax.value_and_grad(jm.loss_fn, has_aux=True)(
        jax.tree.map(jnp.asarray, tree), cfg,
        {k: jnp.asarray(v) for k, v in batch.items()})
    (_, _), g1 = value_and_grad(tcfg)(model_params(model), _tb(batch))
    assert not g1["vision_proj.w"].any()
    assert_grads_close(g1, named(cfg, g0))
