"""The port's optimizers (``repro_torch.optim``) against the reference
(``repro.optim.adam``) on the CPU.

Given the same gradients, ``adam_update`` is within 1 ulp of the
reference's, in float32 and with bfloat16 parameters and bfloat16
moments: the port rounds the float32 moment and parameter updates once,
as the FMAs XLA emits on the CPU, but XLA computes a bfloat16 expression
in float32 before it rounds once, where PyTorch rounds each operation.  Clipping and the schedules
agree to float32 rounding.  Then the reference's own cases
(``tests/test_optim_data.py``): the quadratic, tuple containers,
bfloat16 moments, the clipping property and the schedules' shapes.
"""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("hypothesis")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from hypothesis import given, settings, strategies as st  # noqa: E402

# the packages export the function ``adam``: import the modules by name
jadam = importlib.import_module("repro.optim.adam")
tadam = importlib.import_module("repro_torch.optim.adam")
from repro_torch.tree import leaves  # noqa: E402

LR = 1e-3


def _tree(rng, dtype):
    """A tree of the reference's container kinds, as numpy float32."""
    def a(*shape):
        return rng.normal(size=shape).astype(np.float32)
    del dtype
    return {"w": a(33, 7), "nested": ({"v": a(5)}, [a(4, 3), a(1)])}


def _jax(tree, dtype):
    return jax.tree.map(lambda x: jnp.asarray(x, dtype), tree)


def _torch(tree, dtype):
    return jax.tree.map(lambda x: torch.from_numpy(x).to(dtype), tree)


def _bits(x):
    """Integer bit patterns of a float32 or bfloat16 leaf (either
    package)."""
    if isinstance(x, torch.Tensor):
        return (x.view(torch.int16) if x.dtype == torch.bfloat16
                else x.view(torch.int32)).numpy().astype(np.int64)
    x = np.asarray(x)
    return (x.view(np.int16) if x.dtype.itemsize == 2
            else x.view(np.int32)).astype(np.int64)


def _within_ulp(got, want, ulps=1):
    for g, w in zip(leaves(got), jax.tree.leaves(want)):
        diff = np.abs(_bits(g) - _bits(w))
        assert diff.max() <= ulps, f"{diff.max()} ulp"


@pytest.mark.parametrize("pdt,mdt", [("float32", "float32"),
                                     ("bfloat16", "float32"),
                                     ("bfloat16", "bfloat16")])
@pytest.mark.parametrize("wd", [0.0, 0.01])
def test_adam_update_within_one_ulp_of_reference(pdt, mdt, wd):
    rng = np.random.default_rng(0)
    p0 = _tree(rng, pdt)
    grads = [_tree(rng, pdt) for _ in range(3)]
    jp, tp = _jax(p0, pdt), _torch(p0, getattr(torch, pdt))
    js = jadam.adam_init(jp, getattr(jnp, mdt))
    ts = tadam.adam_init(tp, getattr(torch, mdt))
    jupd = jax.jit(lambda g, s, p: jadam.adam_update(
        g, s, p, lr=LR, b1=0.9, b2=0.95, weight_decay=wd))
    for g in grads:
        # each package steps from the same state: the reference's
        jp2, js2 = jupd(_jax(g, pdt), js, jp)
        tp2, ts2 = tadam.adam_update(
            _torch(g, getattr(torch, pdt)),
            tadam.AdamState(torch.tensor(int(js.step), dtype=torch.int32),
                            _from_jax(js.mu), _from_jax(js.nu)),
            _from_jax(jp), lr=LR, b1=0.9, b2=0.95, weight_decay=wd)
        _within_ulp(tp2, jp2)
        _within_ulp(ts2.mu, js2.mu)
        _within_ulp(ts2.nu, js2.nu)
        assert int(ts2.step) == int(js2.step)
        assert isinstance(tp2["nested"], tuple)
        assert isinstance(tp2["nested"][1], list)
        jp, js = jp2, js2


def _from_jax(tree):
    def leaf(x):
        x = np.asarray(x)
        if x.dtype.itemsize == 2:
            return torch.from_numpy(x.view(np.int16).copy()).view(
                torch.bfloat16)
        return torch.from_numpy(np.array(x))
    return jax.tree.map(leaf, tree)


def test_clip_and_global_norm_match_reference():
    rng = np.random.default_rng(1)
    g = _tree(rng, "float32")
    for max_norm in (0.5, 1e3):
        jc, jn = jadam.clip_by_global_norm(_jax(g, jnp.float32), max_norm)
        tc, tn = tadam.clip_by_global_norm(_torch(g, torch.float32),
                                           max_norm)
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
        for a, b in zip(leaves(tc), jax.tree.leaves(jc)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-7,
                                       atol=0)


@pytest.mark.parametrize("step", [0, 1, 5, 10, 50, 99, 100, 150])
def test_schedules_match_reference(step):
    jc, tc = jadam.cosine_schedule(1e-3, 100), tadam.cosine_schedule(1e-3,
                                                                     100)
    jw = jadam.linear_warmup_cosine(1e-3, 10, 100)
    tw = tadam.linear_warmup_cosine(1e-3, 10, 100)
    s = torch.tensor(step, dtype=torch.int32)
    np.testing.assert_allclose(float(tc(s)), float(jc(jnp.int32(step))),
                               rtol=1e-6)
    np.testing.assert_allclose(float(tw(s)), float(jw(jnp.int32(step))),
                               rtol=1e-6)


def test_sgd_matches_reference():
    rng = np.random.default_rng(2)
    p, g = _tree(rng, "float32"), _tree(rng, "float32")
    for momentum in (0.0, 0.9):
        jo, to = jadam.sgd(0.1, momentum), tadam.sgd(0.1, momentum)
        jp, js = _jax(p, jnp.float32), jo.init(_jax(p, jnp.float32))
        tp, ts = _torch(p, torch.float32), to.init(_torch(p, torch.float32))
        for _ in range(2):
            jp, js = jo.update(_jax(g, jnp.float32), js, jp)
            tp, ts = to.update(_torch(g, torch.float32), ts, tp)
        _within_ulp(tp, jp)


# ------------------------------------------ the reference's own cases

def test_adam_converges_quadratic():
    target = torch.tensor([1.0, -2.0, 0.5])
    params = {"w": torch.zeros(3), "nested": ({"v": torch.ones(2)},)}
    state = tadam.adam_init(params)
    for _ in range(400):
        grads = {"w": 2 * (params["w"] - target),
                 "nested": ({"v": 2 * params["nested"][0]["v"]},)}
        params, state = tadam.adam_update(grads, state, params, lr=0.05)
    np.testing.assert_allclose(params["w"].numpy(), target.numpy(),
                               atol=1e-2)
    np.testing.assert_allclose(params["nested"][0]["v"].numpy(),
                               np.zeros(2), atol=1e-2)


def test_adam_handles_tuple_containers():
    """Block stacks are tuples: the update keeps every container type."""
    params = ({"a": torch.ones(4)}, {"b": torch.ones(3)})
    state = tadam.adam_init(params)
    grads = ({"a": torch.ones(4)}, {"b": torch.ones(3)})
    new_params, new_state = tadam.adam_update(grads, state, params, lr=0.1)
    assert isinstance(new_params, tuple) and len(new_params) == 2
    assert float(new_params[0]["a"][0]) < 1.0
    assert int(new_state.step) == 1


def test_adam_bf16_moments():
    params = {"w": torch.ones(8, dtype=torch.bfloat16)}
    state = tadam.adam_init(params, moment_dtype=torch.bfloat16)
    assert state.mu["w"].dtype == torch.bfloat16
    grads = {"w": torch.full((8,), 0.5, dtype=torch.bfloat16)}
    new_params, _ = tadam.adam_update(grads, state, params, lr=0.01)
    assert new_params["w"].dtype == torch.bfloat16
    assert float(new_params["w"][0]) < 1.0


@given(st.floats(0.1, 10.0), st.integers(1, 5))
@settings(max_examples=20, deadline=None)
def test_clip_by_global_norm_property(scale, seed):
    g = {"a": torch.from_numpy(np.random.default_rng(seed).normal(
        size=16).astype(np.float32)) * scale}
    clipped, norm = tadam.clip_by_global_norm(g, 1.0)
    assert float(tadam.global_norm(clipped)) <= 1.0 + 1e-4
    if float(norm) <= 1.0:   # no-op below threshold
        np.testing.assert_allclose(clipped["a"].numpy(), g["a"].numpy(),
                                   rtol=1e-5)


def test_schedules_monotone_shapes():
    cos = tadam.cosine_schedule(1e-3, 100)
    i32 = (lambda v: torch.tensor(v, dtype=torch.int32))
    assert float(cos(i32(0))) == pytest.approx(1e-3)
    assert float(cos(i32(100))) == pytest.approx(1e-4, rel=0.1)
    wc = tadam.linear_warmup_cosine(1e-3, 10, 100)
    assert float(wc(i32(5))) < float(wc(i32(10)))
