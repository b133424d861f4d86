"""The LM train step, the port's counterpart of
``repro.launch.steps.make_train_step``.

The train state is ``{"params": params, "opt": AdamState}``: ``params``
maps each parameter's name in the model (``model_params``:
``embed.table``, ``blocks.<layer>.attn.wq.w``, ...) to its tensor, and
the Adam moments are trees of the same names.  A step is a pure function
of ``(state, batch)`` that returns a new state, so that
``TrainSupervisor`` can replace the state by a checkpoint's: the model
runs through ``torch.func.functional_call`` on a skeleton on the ``meta``
device, with the state's tensors in place of its parameters, and the
gradients are taken inside that call (remat recomputes its units in the
backward, while those tensors are still in place).

The reference's sharded builders (``model_state_specs``,
``_param_specs``, ``build_train``, ``build_prefill``, ``build_decode``,
``build_cell``, ``lower_cell``, ``_sanitize_spec``) come with the LM
meshes (ROADMAP.md A16d).
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.models.config import ModelConfig
from repro_torch.models.model import LM, loss_fn
from repro_torch.optim.adam import adam_update, clip_by_global_norm


def model_params(model: nn.Module) -> dict:
    """The model's parameters by name, detached: the ``params`` of a
    train state."""
    return {k: p.detach() for k, p in model.named_parameters()}


class _Objective(nn.Module):
    """``loss_fn`` of ``model`` and the gradients of ``params``, the
    tensors ``functional_call`` puts in place of its parameters."""

    def __init__(self, model: LM):
        super().__init__()
        self.model = model

    def forward(self, params, batch):
        loss, metrics = loss_fn(self.model, batch)
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        # a parameter the loss does not reach (a vision projection with
        # no cross-attention layer) has a zero gradient, as under jax.grad
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(params, grads)]
        return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
                grads)


def value_and_grad(cfg: ModelConfig):
    """``fn(params, batch) -> ((loss, metrics), grads)``, ``loss_fn``'s
    value and its gradients by name, as ``jax.value_and_grad(loss_fn,
    has_aux=True)``.  The gradient of a parameter has its dtype."""
    objective = _Objective(LM(cfg, None, torch.device("meta")))

    def fn(params: dict, batch: dict):
        names = list(params)
        leaves = [params[k].detach().requires_grad_() for k in names]
        loss, metrics, grads = torch.func.functional_call(
            objective, {f"model.{k}": t for k, t in zip(names, leaves)},
            (leaves, batch), strict=True)
        return (loss, metrics), dict(zip(names, grads))

    return fn


def make_train_step(cfg: ModelConfig, lr: float = 3e-4,
                    grad_clip: float = 1.0):
    """``train_step(state, batch) -> (state, metrics)``: the loss and its
    gradients, clipped to a global norm of ``grad_clip``, then one Adam
    step (b1 0.9, b2 0.95).  ``metrics``: ``nll``, ``aux``, ``ppl``,
    ``loss`` and ``grad_norm`` (before clipping), as 0-d tensors."""
    vg = value_and_grad(cfg)

    def train_step(state, batch):
        (loss, metrics), grads = vg(state["params"], batch)
        grads, gnorm = clip_by_global_norm(grads, grad_clip)
        new_params, new_opt = adam_update(
            grads, state["opt"], state["params"], lr=lr, b1=0.9, b2=0.95)
        metrics = dict(metrics, loss=loss, grad_norm=gnorm)
        return {"params": new_params, "opt": new_opt}, metrics

    return train_step
