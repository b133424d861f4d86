"""Building blocks of the LM zoo: linear, RMSNorm, embedding, RoPE, SwiGLU.

Counterpart of ``repro.models.layers``.  Parameters live in
``nn.Module``s whose attribute names are the reference's pytree keys
(``w``, ``b``, ``scale``, ``table``, ``wi`` / ``wg`` / ``wo``), with the
reference's layouts: a linear weight is (d_in, d_out).  The functions take
such a module and tensors, as the reference's take a parameter dict and
arrays.  Parameters require gradients, for training
(``repro_torch.launch.steps``); the serving paths run under
``torch.inference_mode()``, which records no graph.

Mixed dtypes follow JAX's promotion, which PyTorch's matmul does not do by
itself: ``linear`` of a float32 input and a bfloat16 weight computes in
float32 (the weight cast once per call).

Sharding, as the reference's (mesh rationale: ``repro_torch.launch.mesh``):

  * tensor-parallel dims (heads, ffn hidden, experts, vocab) -> "model"
  * one remaining large dim per weight -> the FSDP axis ("data")
  * small vectors (norm scales, biases) -> replicated

Each module's ``specs(rules)`` gives its own parameters' ``P`` (the
counterpart of ``jax.sharding.PartitionSpec``), by attribute path;
``repro_torch.models.model.param_specs`` gathers them by parameter name.
``placements`` turns a ``P`` into DTensor placements on a
``DeviceMesh``.  Under ``activation_sharding_ctx`` (the launcher's, see
``repro_torch.launch.steps``) ``constrain_act``, ``constrain_dims`` and
``constrain_moe`` redistribute DTensor activations to the reference's
layouts; outside it they return their input.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn

_F32 = torch.float32
_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def torch_dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


# ---------------------------------------------------------------- sharding

class P:
    """A partition spec: one entry per tensor dim, each None (not
    sharded), a mesh axis name, or a tuple of names (the dim split over
    their product, the first axis major), as ``jax.sharding.PartitionSpec``.
    A leaf of the port's trees (``repro_torch.tree``), not a container."""

    __slots__ = ("entries",)

    def __init__(self, *entries):
        # a one-axis tuple is that axis, as JAX normalises it
        self.entries = tuple(
            e[0] if isinstance(e, (tuple, list)) and len(e) == 1
            else tuple(e) if isinstance(e, list) else e for e in entries)

    def __iter__(self):
        return iter(self.entries)

    def __len__(self):
        return len(self.entries)

    def __getitem__(self, i):
        return self.entries[i]

    def __eq__(self, other):
        return isinstance(other, P) and self.entries == other.entries

    def __hash__(self):
        return hash(self.entries)

    def __repr__(self):
        return "P(" + ", ".join(map(repr, self.entries)) + ")"


@dataclasses.dataclass(frozen=True)
class AxisRules:
    fsdp: Any = "data"           # axis (or tuple of axes) for param FSDP
    tp: Any = "model"            # axis for tensor parallelism
    dp: Any = ("data",)          # axes over which the batch is sharded
    sp: Any = None               # sequence-parallel axis for long-context KV


def mesh_shape(mesh) -> dict:
    """{axis name: size} of a ``DeviceMesh`` (or of any object with a
    ``shape`` dict and ``axis_names``, as the reference's meshes)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return dict(mesh.shape)


def axis_names(mesh) -> tuple:
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names if names is not None else mesh.axis_names)


def _axes(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def axis_size(mesh, axes) -> int:
    """Product of the sizes of ``axes`` (None, a name or a tuple)."""
    shape = mesh_shape(mesh)
    n = 1
    for a in _axes(axes):
        n *= shape[a]
    return n


def placements(mesh, spec) -> tuple:
    """DTensor placements on ``mesh`` of a tensor laid out as ``spec``:
    ``Shard(d)`` on the mesh dim of each axis that dim ``d`` names,
    ``Replicate()`` on the others.  A tuple entry shards its dim over its
    axes with the first one major, as JAX lays it out, which is DTensor's
    order when the axes come in the mesh's order; another order raises.
    A mesh dim of size 1 splits nothing and gets ``Replicate()``, the same
    layout (torch 2.11's DTensor refuses some views and products of a dim
    "split" over one rank)."""
    from torch.distributed.tensor import Replicate, Shard
    names = axis_names(mesh)
    size = mesh_shape(mesh)
    out = [Replicate()] * len(names)
    seen = set()
    for dim, entry in enumerate(spec):
        idx = [names.index(a) for a in _axes(entry)]
        if idx != sorted(idx):
            raise ValueError(f"{spec}: the axes of dim {dim} must come in "
                             f"the mesh's order {names}")
        for i in idx:
            if i in seen:
                raise ValueError(f"{spec} names axis {names[i]} twice")
            seen.add(i)
            if size[names[i]] > 1:
                out[i] = Shard(dim)
    return tuple(out)


# Activation sharding constraints.  Propagation alone loses the batch
# sharding at the embedding gather (the table is (vocab->tp, d->fsdp)
# sharded), so the launcher installs (mesh, dp axes) here and the model
# calls ``constrain_act`` at layer boundaries.  Outside a launcher context
# (unit tests, one device) each constraint returns its input.
_ACT_CTX: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_act_sharding", default=None)


@contextlib.contextmanager
def activation_sharding_ctx(mesh, dp_axes, tp_axis="model", sp_axis=None,
                            dshard_axis=None, moe_shard=False):
    """dshard_axis: shard the hidden (last) dim of activations over this
    axis ('2-D weight-stationary' serving: activations reshard instead of
    all-gathering FSDP weight shards every layer).  moe_shard: constrain
    MoE dispatch intermediates (experts -> tp).  Tensors the model makes
    inside the context (positions, masks, zeros) count as replicated
    (``implicit_replication``)."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.models.sharded import ensure_rules
    ensure_rules()
    tok = _ACT_CTX.set({"mesh": mesh, "dp": dp_axes, "tp": tp_axis,
                        "sp": sp_axis, "dshard": dshard_axis,
                        "moe_shard": moe_shard})
    try:
        with implicit_replication():
            yield
    finally:
        _ACT_CTX.reset(tok)


class _Constrain(torch.autograd.Function):
    """``redistribute`` to ``pl``, with the gradient redistributed to
    ``pl`` too: the transpose of JAX's ``with_sharding_constraint`` is the
    same constraint on the cotangent.  Left to itself DTensor may carry a
    gradient on as ``Partial`` (summed later, or never, by an op that
    gathers the other operand instead), and which it does differs between
    torch versions."""

    @staticmethod
    def forward(ctx, t, mesh, pl):
        ctx.mesh, ctx.pl = mesh, pl
        return t.redistribute(mesh, pl)

    @staticmethod
    def backward(ctx, g):
        return g.redistribute(ctx.mesh, ctx.pl), None, None


def _constrain(t, mesh, spec):
    from torch.distributed.tensor import DTensor
    if not isinstance(t, DTensor):
        return t
    return _Constrain.apply(t, mesh, placements(mesh, spec))


def constrain_act(x, *, vocab_dim: bool = False, seq_dim: bool = False):
    """Pin (B, T, ...) activations to batch-over-dp (+ optional vocab->tp
    on the last dim, seq->sp on dim 1, hidden->dshard in weight-stationary
    serving mode)."""
    ctx = _ACT_CTX.get()
    if ctx is None or x.ndim < 2:
        return x
    mesh, dp = ctx["mesh"], ctx["dp"]
    size = mesh_shape(mesh)
    spec = [None] * x.ndim
    if x.shape[0] % axis_size(mesh, dp) == 0:
        spec[0] = dp
    if seq_dim and ctx["sp"] and x.shape[1] % size[ctx["sp"]] == 0:
        spec[1] = ctx["sp"]
    if vocab_dim and x.shape[-1] % size[ctx["tp"]] == 0:
        spec[-1] = ctx["tp"]
    elif (not vocab_dim and ctx.get("dshard")
          and x.shape[-1] % size[ctx["dshard"]] == 0):
        # weight-stationary: the hidden dim takes the dshard axis and the
        # batch dim releases it (activations move, weights stay put)
        spec[-1] = ctx["dshard"]
        if spec[0] is not None:
            kept = tuple(a for a in _axes(spec[0]) if a != ctx["dshard"])
            spec[0] = kept if kept and x.shape[0] % axis_size(
                mesh, kept) == 0 else None
    return _constrain(x, mesh, P(*spec))


def constrain_dims(t, dims: dict, *, gate: str | None = None):
    """Constrain tensor dims to mesh axes under a launcher context.
    ``dims`` maps dim index -> 'dp' | 'tp'; ``gate`` names a context flag
    that must be truthy (None = always on)."""
    ctx = _ACT_CTX.get()
    if ctx is None or (gate is not None and not ctx.get(gate)):
        return t
    mesh = ctx["mesh"]
    spec = [None] * t.ndim
    for i, role in dims.items():
        axes = ctx["dp"] if role == "dp" else ctx["tp"]
        if t.shape[i] % axis_size(mesh, axes) == 0:
            spec[i] = axes
    return _constrain(t, mesh, P(*spec))


def constrain_moe(t, dims: dict):
    """MoE dispatch intermediates (experts -> tp, groups -> dp); always on
    under a launcher context."""
    return constrain_dims(t, dims)


def normal(shape, scale, dtype, generator, device):
    """float32 normal * scale, cast to ``dtype``; uninitialised on the
    ``meta`` device (shapes only)."""
    if torch.device(device).type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
    w = torch.randn(shape, dtype=_F32, device=device, generator=generator)
    return (w * scale).to(dtype)


def param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t)


def promoted(*ts):
    """The tensors cast to their common dtype, as JAX promotes operands."""
    dt = ts[0].dtype
    for t in ts[1:]:
        dt = torch.promote_types(dt, t.dtype)
    return tuple(t.to(dt) for t in ts)


# ------------------------------------------------------------------ linear

class Linear(nn.Module):
    def __init__(self, d_in, d_out, dtype, generator, device, *,
                 bias=False):
        super().__init__()
        self.w = param(normal((d_in, d_out), d_in ** -0.5, dtype, generator,
                              device))
        if bias:
            self.b = param(torch.zeros(d_out, dtype=dtype, device=device))
        else:
            self.b = None


def linear_specs(bias, in_spec, out_spec) -> dict:
    """Specs of a ``Linear``'s parameters: w (d_in, d_out), b (d_out,)."""
    out = {"w": P(in_spec, out_spec)}
    if bias:
        out["b"] = P(out_spec)
    return out


def prefixed(name: str, specs: dict) -> dict:
    return {f"{name}.{k}": v for k, v in specs.items()}


def linear(p, x):
    x, w = promoted(x, p.w)
    y = x @ w
    return y if p.b is None else y + p.b


# ----------------------------------------------------------------- rmsnorm

class RMSNorm(nn.Module):
    def __init__(self, d, dtype, device):
        super().__init__()
        self.scale = param(torch.ones(d, dtype=dtype, device=device))

    def specs(self, rules):
        return {"scale": P(None)}


def rmsnorm(p, x, eps: float = 1e-5):
    xf = x.to(_F32)
    y = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
    return (y * p.scale.to(_F32)).to(x.dtype)


# --------------------------------------------------------------- embedding

class Embedding(nn.Module):
    def __init__(self, vocab, d, dtype, generator, device):
        super().__init__()
        self.table = param(normal((vocab, d), 0.02, dtype, generator, device))

    def specs(self, rules):
        return {"table": P(rules.tp, rules.fsdp)}


def embed(p, tokens):
    """tokens (B, T) -> (B, T, D): rows of the table."""
    from repro_torch.models.sharded import embed_sharded, is_dtensor
    if is_dtensor(p.table):
        return embed_sharded(p.table, tokens)
    return p.table[tokens]


def unembed(p, x):
    """(B, T, D) @ table^T -> logits (B, T, V), in float32."""
    return x.to(_F32) @ p.table.to(_F32).t()


# -------------------------------------------------------------------- rope

def rope_freqs(head_dim: int, theta: float, device=None):
    return theta ** (-torch.arange(0, head_dim, 2, dtype=_F32,
                                   device=device) / head_dim)


def apply_rope(x, positions, theta: float):
    """x (B, T, H, Dh); positions (B, T) or (1, T) integers."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    ang = positions[..., None].to(_F32) * freqs                # (B, T, Dh/2)
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = x.to(_F32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)
    return out.to(x.dtype)


# ------------------------------------------------------------------ swiglu

class MLP(nn.Module):
    def __init__(self, d_model, d_ff, dtype, generator, device):
        super().__init__()
        self.wi = Linear(d_model, d_ff, dtype, generator, device)
        self.wg = Linear(d_model, d_ff, dtype, generator, device)
        self.wo = Linear(d_ff, d_model, dtype, generator, device)

    def specs(self, rules):
        return {**prefixed("wi", linear_specs(False, rules.fsdp, rules.tp)),
                **prefixed("wg", linear_specs(False, rules.fsdp, rules.tp)),
                **prefixed("wo", linear_specs(False, rules.tp, rules.fsdp))}


def mlp(p, x):
    h = F.silu(linear(p.wg, x)) * linear(p.wi, x)
    return linear(p.wo, h)
