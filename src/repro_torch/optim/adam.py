"""Adam, AdamW and SGD over trees of tensors, with global-norm clipping
and LR schedules.  The port's counterpart of ``repro.optim.adam``.

A tree is nested dicts, lists, tuples and named tuples of tensors
(``repro_torch.tree``); every function keeps the container types, tuples
of block stacks included.  The arithmetic is the reference's, operation
for operation: moments in ``moment_dtype``, ``mhat / (sqrt(vhat) +
eps)``, weight decay added to ``delta``, the step cast to the parameter's
dtype before it is subtracted (a bfloat16 parameter is updated in
bfloat16), clipping by ``g * scale`` in ``g``'s dtype.  In float32 the
moment updates and the parameter step are rounded once, as the fused
multiply-adds XLA emits for them on the CPU (``_fma``).  ``torch.optim.Adam`` is not used:
its eps placement, moment dtype and weight decay differ.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.tree import flatten, leaves, tree_map, unflatten

PyTree = Any
_F32 = torch.float32


class AdamState(NamedTuple):
    step: torch.Tensor  # scalar int32
    mu: PyTree          # first moment
    nu: PyTree          # second moment


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """A minimal (init, update) pair; update returns (new_params,
    new_state)."""

    init: Callable[[PyTree], Any]
    update: Callable[[PyTree, Any, PyTree], tuple[PyTree, Any]]


def _tree_zeros_like(params: PyTree, dtype=None) -> PyTree:
    return tree_map(lambda p: torch.zeros_like(p, dtype=dtype or p.dtype),
                    params)


def _device(params: PyTree):
    ls = leaves(params)
    return ls[0].device if ls else None


def adam_init(params: PyTree, moment_dtype=_F32) -> AdamState:
    return AdamState(
        step=torch.zeros((), dtype=torch.int32, device=_device(params)),
        mu=_tree_zeros_like(params, moment_dtype),
        nu=_tree_zeros_like(params, moment_dtype),
    )


def global_norm(tree: PyTree) -> torch.Tensor:
    """sqrt of the sum over the leaves (in order) of each leaf's float32
    sum of squares."""
    return torch.sqrt(sum(torch.sum(torch.square(x.to(_F32)))
                          for x in leaves(tree)))


def clip_by_global_norm(grads: PyTree, max_norm: float
                        ) -> tuple[PyTree, torch.Tensor]:
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / (norm + 1e-12), max=1.0)
    return tree_map(lambda g: g * scale.to(g.dtype), grads), norm


def _lr(lr, step: torch.Tensor) -> torch.Tensor:
    if callable(lr):
        return lr(step)
    return torch.as_tensor(lr, dtype=_F32, device=step.device)


def _weak(x: float, dtype: torch.dtype) -> float:
    """A Python constant as JAX casts it against an array of ``dtype``
    (weak typing: rounded to that dtype first)."""
    return float(torch.tensor(x, dtype=dtype))


def _scaled(lr_t: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """``lr_t * t`` in their promoted dtype, as JAX multiplies a float32
    scalar array by a lower-precision array (torch would keep ``t``'s)."""
    dt = torch.promote_types(lr_t.dtype, t.dtype)
    return lr_t.to(dt) * t.to(dt)


def _fma(a, b, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c``.  In float32 it is rounded once, as the fused
    multiply-add XLA emits for it on the CPU (formed in float64, where
    the product of two float32 values is exact): the moments' two terms
    often cancel, and two roundings would leave them tens of ulp apart."""
    if c.dtype != _F32:
        return a * b + c
    a = a.double() if isinstance(a, torch.Tensor) else a
    return (a * b.double() + c.double()).to(_F32)


def adam_update(
    grads: PyTree,
    state: AdamState,
    params: PyTree,
    *,
    lr: float | torch.Tensor | Callable[[torch.Tensor], torch.Tensor],
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    weight_decay: float = 0.0,
) -> tuple[PyTree, AdamState]:
    step = state.step + 1
    lr_t = _lr(lr, step)
    sf = step.to(_F32)
    c1 = 1.0 - torch.pow(b1, sf)
    c2 = 1.0 - torch.pow(b2, sf)

    def upd(p, g, m, v):
        dt = m.dtype
        gf = g.to(dt)
        m2 = _fma(_weak(b1, dt), m, _weak(1.0 - b1, dt) * gf)
        v2 = _fma(_weak(b2, dt), v, _weak(1.0 - b2, dt) * torch.square(gf))
        hi = torch.promote_types(dt, _F32)
        mhat = m2.to(hi) / c1
        vhat = v2.to(hi) / c2
        delta = mhat / (torch.sqrt(vhat) + eps)
        if weight_decay:
            delta = delta + _weak(weight_decay, dt) * p.to(dt)
        if p.dtype == delta.dtype:
            return _fma(-lr_t, delta, p), m2, v2
        return p - _scaled(lr_t, delta).to(p.dtype), m2, v2

    flat_p, structure = flatten(params)
    out = [upd(*a) for a in zip(flat_p, leaves(grads), leaves(state.mu),
                                leaves(state.nu))]
    new_params, new_mu, new_nu = (unflatten(structure, [o[i] for o in out])
                                  for i in range(3))
    return new_params, AdamState(step=step, mu=new_mu, nu=new_nu)


def adam(lr, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8
         ) -> Optimizer:
    return Optimizer(
        init=adam_init,
        update=lambda g, s, p: adam_update(g, s, p, lr=lr, b1=b1, b2=b2,
                                           eps=eps),
    )


def adamw(lr, weight_decay: float = 0.01, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8) -> Optimizer:
    return Optimizer(
        init=adam_init,
        update=lambda g, s, p: adam_update(
            g, s, p, lr=lr, b1=b1, b2=b2, eps=eps,
            weight_decay=weight_decay),
    )


def sgd(lr, momentum: float = 0.0) -> Optimizer:
    def init(params):
        return _tree_zeros_like(params) if momentum else None

    def update(grads, state, params):
        if momentum:
            new_state = tree_map(
                lambda m, g: _weak(momentum, m.dtype) * m + g, state, grads)
            vel = new_state
        else:
            new_state, vel = None, grads
        new_params = tree_map(
            lambda p, v: p - _scaled(torch.as_tensor(
                lr, dtype=_F32, device=v.device), v).to(p.dtype),
            params, vel)
        return new_params, new_state

    return Optimizer(init=init, update=update)


def cosine_schedule(base_lr: float, total_steps: int, final_frac: float = 0.1):
    def fn(step):
        t = torch.clamp(step.to(_F32) / total_steps, max=1.0)
        cos = 0.5 * (1.0 + torch.cos(math.pi * t))
        return base_lr * (final_frac + (1.0 - final_frac) * cos)
    return fn


def linear_warmup_cosine(base_lr: float, warmup: int, total_steps: int,
                         final_frac: float = 0.1):
    cos = cosine_schedule(base_lr, max(total_steps - warmup, 1), final_frac)

    def fn(step):
        s = step.to(_F32)
        warm = base_lr * s / max(warmup, 1)
        return torch.where(step <= warmup, warm, cos(step - warmup))
    return fn
