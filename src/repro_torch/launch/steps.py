"""The LM step functions, the port's counterpart of
``repro.launch.steps``: the train step, and the sharded builders of every
shape cell.

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

``build_cell`` returns ``(fn, args, in_shardings, out_shardings,
donate)`` for one (arch config, shape cell, mesh), as the reference's:

  train_*    -> train_step   : loss + grad + Adam update
  prefill_*  -> prefill_step : full forward returning last logits + caches
  decode_*   -> serve_step   : one new token against a seq_len KV cache

``args`` are ``meta`` tensors of the global shapes; a sharding is a
``NamedSharding`` (a ``P`` on the mesh) per leaf.  Sharding policy (the
reference's baseline):

  batch          -> ("pod", "data")          [dp]
  params/moments -> FSDP over "data", TP over "model"
  KV cache       -> batch over dp when divisible; sequence over "model"
                    (decode_32k) or all axes (long_500k, batch 1)
  SSM state      -> batch over dp, heads over "model"

``lower_cell`` applies the reference's ``opts`` and returns a ``Lowered``:
``lowered.cost()`` runs the step on ``meta`` DTensors (under the dry-run's
``fake`` process group: per-device FLOPs, bytes and collectives,
``repro_torch.launch.dryrun``), and ``lowered(*args)`` runs it on real
tensors placed on a real mesh.  Donation is not modelled: the outputs are
new tensors.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from repro_torch.data.synthetic import batch_specs, context_spec, token_spec
from repro_torch.launch.mesh import NamedSharding, axis_rules_for, dp_axes
from repro_torch.models import model as model_lib
from repro_torch.models.attention import KVCache
from repro_torch.models.config import ModelConfig, ShapeCell
from repro_torch.models.layers import (P, activation_sharding_ctx,
                                       axis_names, axis_size)
from repro_torch.models.model import LM, loss_fn
from repro_torch.models.sharded import is_dtensor
from repro_torch.models.ssm import SSMCache
from repro_torch.optim.adam import (AdamState, adam_update,
                                    clip_by_global_norm)
from repro_torch.tree import flatten, tree_map

_META = torch.device("meta")


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
        # a sharded parameter's gradient comes back in its layout: partial
        # sums reduce-scattered to the shards (FSDP)
        grads = [g.redistribute(p.device_mesh, p.placements)
                 if is_dtensor(p) else g for p, g in zip(params, grads)]
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


# ----------------------------------------------------------- small utils

def _axis_size(mesh, axes) -> int:
    return axis_size(mesh, axes)


def _maybe(mesh, dim_size: int, axes):
    """Use axes only if dim divides evenly; else replicate that dim."""
    return axes if dim_size % _axis_size(mesh, axes) == 0 else None


def _sharding_tree(mesh, spec_tree):
    return tree_map(lambda s: NamedSharding(mesh, s), spec_tree)


def _sanitize_spec(mesh, spec: P, shape) -> P:
    """Drop axes from a spec wherever the dim is not divisible by the
    axis product (e.g. an odd vocab or width on a 16-way axis)."""
    out = []
    for i, axes in enumerate(spec):
        if axes is None or i >= len(shape):
            out.append(None if i >= len(shape) else axes)
            continue
        out.append(axes if shape[i] % _axis_size(mesh, axes) == 0 else None)
    return P(*out)


def _sharding_tree_for(mesh, spec_tree, shape_tree):
    """NamedShardings with divisibility-sanitized specs."""
    return tree_map(lambda s, sh: NamedSharding(
        mesh, _sanitize_spec(mesh, s, sh.shape)), spec_tree, shape_tree)


# -------------------------------------------------------- state skeleton

def _skeleton(cfg: ModelConfig) -> LM:
    return LM(cfg, None, _META)


def _param_specs(cfg: ModelConfig, rules) -> dict:
    """{parameter name: P} without allocating parameters."""
    return model_lib.param_specs(_skeleton(cfg), rules)


def model_state_specs(cfg: ModelConfig, mesh):
    """(shape_tree, spec_tree) for {params, opt}: ``meta`` tensors and
    ``P``s, the moments in ``cfg.moment_dtype``."""
    rules = axis_rules_for(mesh)
    param_shapes = model_params(_skeleton(cfg))
    param_specs = _param_specs(cfg, rules)
    mdt = torch.bfloat16 if cfg.moment_dtype == "bfloat16" else torch.float32

    def moments():
        return {k: torch.empty(v.shape, dtype=mdt, device=_META)
                for k, v in param_shapes.items()}

    opt_shapes = AdamState(step=torch.empty((), dtype=torch.int32,
                                            device=_META),
                           mu=moments(), nu=moments())
    opt_specs = AdamState(step=P(), mu=param_specs, nu=param_specs)
    return ({"params": param_shapes, "opt": opt_shapes},
            {"params": param_specs, "opt": opt_specs})


class _Call(nn.Module):
    """``fn(model, *args)`` of a skeleton, for ``functional_call``."""

    def __init__(self, model: LM, fn):
        super().__init__()
        self.model = model
        self.fn = fn

    def forward(self, *args, **kwargs):
        return self.fn(self.model, *args, **kwargs)


def _functional(cfg: ModelConfig, fn):
    """``call(params, *args)``: ``fn(model, *args)`` with the tensors of
    ``params`` (by name) in place of the model's parameters."""
    mod = _Call(_skeleton(cfg), fn)

    def call(params, *args, **kwargs):
        return torch.func.functional_call(
            mod, {f"model.{k}": v for k, v in params.items()}, args, kwargs,
            strict=True)

    return call


# ------------------------------------------------------------ train cell

def build_train(cfg: ModelConfig, cell: ShapeCell, mesh):
    dp = dp_axes(mesh)
    state_shapes, state_specs = model_state_specs(cfg, mesh)
    bspecs = batch_specs(cfg, cell)
    bshard = {k: P(_maybe(mesh, v.shape[0], dp), *([None] * (v.dim() - 1)))
              for k, v in bspecs.items()}
    fn = make_train_step(cfg)
    state_sh = _sharding_tree_for(mesh, state_specs, state_shapes)
    in_shardings = (state_sh, _sharding_tree(mesh, bshard))
    out_shardings = (state_sh, None)
    return fn, (state_shapes, bspecs), in_shardings, out_shardings, (0,)


# --------------------------------------------------------- serve: prefill

def _kinds(cfg: ModelConfig):
    unit, repeats = cfg.block_program()
    return unit * repeats


def _cache_pspecs(cfg: ModelConfig, cell: ShapeCell, mesh):
    """Specs of ``make_caches``' list, one entry per layer."""
    dp = dp_axes(mesh)
    b, s = cell.global_batch, cell.seq_len
    b_ax = _maybe(mesh, b, dp)
    if b_ax is None and b == 1:
        seq_axes = (("data", "model") if "pod" not in axis_names(mesh)
                    else ("pod", "data", "model"))
    else:
        seq_axes = ("model",)
    s_ax = _maybe(mesh, s, seq_axes)
    tp = "model"
    specs = []
    for kind in _kinds(cfg):
        if kind.startswith("attn") or kind == "cross_attn":
            spec = KVCache(k=P(b_ax, s_ax, None, None),
                           v=P(b_ax, s_ax, None, None))
        else:
            spec = SSMCache(
                conv_x=P(b_ax, None, _maybe(mesh, cfg.ssm_d_inner, tp)),
                conv_b=P(b_ax, None, _maybe(mesh, cfg.ssm_state, tp)),
                conv_c=P(b_ax, None, _maybe(mesh, cfg.ssm_state, tp)),
                state=P(b_ax, _maybe(mesh, cfg.ssm_heads, tp), None, None))
        specs.append(spec)
    return specs


def _ctx_kv_pspecs(cfg: ModelConfig, cell: ShapeCell, mesh):
    """Specs of ``precompute_ctx_kvs``' list, or None without a
    cross-attention layer."""
    kinds = _kinds(cfg)
    if "cross_attn" not in kinds:
        return None
    b_ax = _maybe(mesh, cell.global_batch, dp_axes(mesh))
    return [KVCache(k=P(b_ax, None, None, None), v=P(b_ax, None, None, None))
            if kind == "cross_attn" else None for kind in kinds]


def build_prefill(cfg: ModelConfig, cell: ShapeCell, mesh):
    rules = axis_rules_for(mesh)
    param_specs = _param_specs(cfg, rules)
    param_shapes = model_params(_skeleton(cfg))
    b, s = cell.global_batch, cell.seq_len
    ctx = context_spec(cfg, b)
    b_ax = _maybe(mesh, b, dp_axes(mesh))
    call = _functional(cfg, model_lib.prefill)

    def prefill_step(params, tokens, context=None):
        with torch.no_grad():
            return call(params, tokens, context)

    args = [param_shapes, token_spec(b, s)] + ([ctx] if ctx is not None
                                               else [])
    in_sh = [_sharding_tree_for(mesh, param_specs, param_shapes),
             NamedSharding(mesh, P(b_ax, None))]
    if ctx is not None:
        in_sh.append(NamedSharding(mesh, P(b_ax, None, None)))
    out_sh = (NamedSharding(mesh, P(b_ax, None, "model")),
              _sharding_tree(mesh, _cache_pspecs(cfg, cell, mesh)))
    return prefill_step, tuple(args), tuple(in_sh), out_sh, ()


# ---------------------------------------------------------- serve: decode

def _position(pos, last: int) -> int:
    """The position a decode step writes: ``pos`` (an int or a 0-d
    tensor); on ``meta`` (no value), the cache's last, where every key is
    in use."""
    if isinstance(pos, torch.Tensor):
        if is_dtensor(pos):
            pos = pos.to_local()
        return last if pos.device.type == "meta" else int(pos)
    return int(pos)


def build_decode(cfg: ModelConfig, cell: ShapeCell, mesh):
    rules = axis_rules_for(mesh)
    param_specs = _param_specs(cfg, rules)
    param_shapes = model_params(_skeleton(cfg))
    b, s = cell.global_batch, cell.seq_len
    b_ax = _maybe(mesh, b, dp_axes(mesh))
    cache_shapes = model_lib.make_caches(cfg, b, s, torch.bfloat16,
                                         device=_META)
    cache_specs = _cache_pspecs(cfg, cell, mesh)
    ctx = context_spec(cfg, b)
    ctx_kv_shapes = None
    if ctx is not None:
        with torch.no_grad():
            ctx_kv_shapes = _functional(cfg, model_lib.precompute_ctx_kvs)(
                param_shapes, ctx)
    call = _functional(cfg, model_lib.decode_step)

    def serve_step(params, token, caches, pos, ctx_kvs=None):
        with torch.no_grad():
            return call(params, token, caches, _position(pos, s - 1),
                        ctx_kvs=ctx_kvs)

    args = [param_shapes, token_spec(b, 1), cache_shapes,
            torch.empty((), dtype=torch.int32, device=_META)]
    in_sh = [_sharding_tree_for(mesh, param_specs, param_shapes),
             NamedSharding(mesh, P(b_ax, None)),
             _sharding_tree(mesh, cache_specs), NamedSharding(mesh, P())]
    if ctx_kv_shapes is not None:
        args.append(ctx_kv_shapes)
        in_sh.append(_sharding_tree(mesh, _ctx_kv_pspecs(cfg, cell, mesh)))
    out_sh = (NamedSharding(mesh, P(b_ax, None, "model")),
              _sharding_tree(mesh, cache_specs))
    return serve_step, tuple(args), tuple(in_sh), out_sh, (2,)


# -------------------------------------------------------------- dispatch

def build_cell(cfg: ModelConfig, cell: ShapeCell, mesh):
    if cell.kind == "train":
        return build_train(cfg, cell, mesh)
    if cell.kind == "prefill":
        return build_prefill(cfg, cell, mesh)
    if cell.kind == "decode":
        return build_decode(cfg, cell, mesh)
    raise ValueError(cell.kind)


def _local_shape(shape, mesh, placements):
    shape = list(shape)
    for i, pl in enumerate(placements):
        if pl.is_shard():
            n = mesh.size(i)
            if shape[pl.dim] % n:
                raise ValueError(f"dim {pl.dim} of {tuple(shape)} does not "
                                 f"split {n} ways")
            shape[pl.dim] //= n
    return tuple(shape)


def place(t: torch.Tensor, sharding: NamedSharding):
    """``t`` as a DTensor laid out by ``sharding``: a ``meta`` tensor
    becomes this rank's empty shard; a real one on a mesh of one rank is
    its own shard (no copy); on more ranks it is distributed from rank 0
    (``distribute_tensor``).  A CPU tensor moves onto a "cuda" mesh; a
    CUDA tensor on a "cpu" mesh raises, since the step would then run on
    the host."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    mesh, pl = sharding.mesh, sharding.placements
    if t.device.type == "meta":
        local = torch.empty(_local_shape(t.shape, mesh, pl), dtype=t.dtype,
                            device=_META)
        return DTensor.from_local(local, mesh, pl, run_check=False,
                                  shape=t.shape, stride=t.stride())
    if t.device.type == "cuda" and mesh.device_type != "cuda":
        raise ValueError(f"a CUDA tensor placed on a {mesh.device_type!r} "
                         "mesh; build the mesh on an nccl group")
    if t.device.type != mesh.device_type:
        t = t.to(mesh.device_type)
    if mesh.size() == 1:
        return DTensor.from_local(t, mesh, pl, run_check=False)
    return distribute_tensor(t, mesh, pl)


def map_placed(fn, tree, shardings):
    """``fn(leaf, sharding)`` of each leaf of ``tree`` and the sharding at
    its place (a sharding tree may stop at a container: one sharding for
    all of it; None leaves the subtree as it is)."""
    if shardings is None:
        return tree
    if isinstance(shardings, NamedSharding):
        return tree_map(lambda t: fn(t, shardings), tree)
    if isinstance(tree, dict):
        return {k: map_placed(fn, v, shardings[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        vals = [map_placed(fn, v, sh) for v, sh in zip(tree, shardings)]
        return type(tree)(*vals) if hasattr(tree, "_fields") else type(
            tree)(vals)
    return tree


def place_tree(tree, shardings):
    """Each leaf of ``tree`` placed by its sharding (``place``)."""
    return map_placed(place, tree, shardings)


def _shard_bytes(t, sharding: NamedSharding) -> int:
    """Bytes of this rank's shard of ``t`` laid out by ``sharding``."""
    shape = _local_shape(t.shape, sharding.mesh, sharding.placements)
    n = 1
    for d in shape:
        n *= d
    return n * t.element_size()


def _redistribute_tree(tree, shardings):
    return map_placed(lambda t, sh: t.redistribute(sh.mesh, sh.placements)
                      if is_dtensor(t) else t, tree, shardings)


@dataclasses.dataclass
class Lowered:
    """One cell's step built for a mesh (``lower_cell``)."""
    cfg: ModelConfig
    cell: ShapeCell
    mesh: object
    fn: object
    args: tuple
    in_shardings: tuple
    out_shardings: object
    ctx: dict

    def place(self, args=None) -> tuple:
        """``args`` (default: the ``meta`` arguments) placed by
        ``in_shardings``."""
        args = self.args if args is None else args
        return tuple(place_tree(a, sh)
                     for a, sh in zip(args, self.in_shardings))

    def run(self, placed):
        """The step on placed arguments, under the launcher's activation
        sharding; outputs laid out by ``out_shardings``."""
        with activation_sharding_ctx(**self.ctx):
            out = self.fn(*placed)
        return _redistribute_tree(out, self.out_shardings)

    def __call__(self, *args):
        return self.run(self.place(args))

    def argument_bytes(self, args=None) -> int:
        """Bytes of this rank's shards of the arguments (default: the
        ``meta`` arguments of the cell)."""
        args = self.args if args is None else args
        return sum(sum(flatten(map_placed(_shard_bytes, a, sh))[0])
                   for a, sh in zip(args, self.in_shardings))

    def cost(self) -> dict:
        """Per-device FLOPs, bytes and collectives of one step on ``meta``
        (``repro_torch.launch.dryrun.step_costs``)."""
        from repro_torch.launch.dryrun import step_costs
        return step_costs(self)


def lower_cell(cfg: ModelConfig, cell: ShapeCell, mesh,
               opts: dict | None = None) -> Lowered:
    """One cell's step on ``mesh``, with the reference's hillclimb
    ``opts``: cfg overrides (``moe_group_size``, ``moe_impl``, ``remat``,
    ``param_dtype``, ``embed_shard``, ``attn_seq_shard``,
    ``remat_policy``, ``scan_unroll``, ``capacity_factor``); ``force_sp``
    (sequence-parallel prefill, also taken when the batch cannot fill
    dp); ``decode_dshard`` (2-D weight-stationary decode); ``moe_shard``
    (MoE dispatch intermediates pinned)."""
    opts = opts or {}
    overrides = {k: v for k, v in opts.items()
                 if k in ("moe_group_size", "moe_impl", "remat",
                          "param_dtype", "embed_shard", "attn_seq_shard",
                          "remat_policy", "scan_unroll", "capacity_factor")}
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    fn, args, in_sh, out_sh, _ = build_cell(cfg, cell, mesh)
    sp = None
    if cell.kind == "prefill" and (
            cell.global_batch < _axis_size(mesh, dp_axes(mesh))
            or opts.get("force_sp")):
        sp = "model"     # batch too small to fill dp (or forced)
    dshard = "data" if (opts.get("decode_dshard")
                        and cell.kind == "decode") else None
    ctx = dict(mesh=mesh, dp_axes=dp_axes(mesh), tp_axis="model",
               sp_axis=sp, dshard_axis=dshard,
               moe_shard=bool(opts.get("moe_shard")))
    return Lowered(cfg, cell, mesh, fn, args, in_sh, out_sh, ctx)
