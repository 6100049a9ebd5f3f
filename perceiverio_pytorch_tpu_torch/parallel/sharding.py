"""Parameter and batch partition rules (Megatron-style TP, and FSDP).

Counterpart of ``perceiverio_pytorch_tpu/parallel/sharding.py``.  The rules
are the JAX package's, keyed on the module attribute that holds the
parameter:

  * q/k/v projections and the MLP's ``fc1``: column-parallel, the output
    features (heads) split over the model axis, their biases with them;
  * the attention's ``final`` projection and the MLP's ``fc2``:
    row-parallel, the input features split; the bias replicated (added
    once, after the partial sums are reduced);
  * everything else replicated;
  * with FSDP, every >=2-D parameter also gets its largest still-unsharded
    dimension that the data axis divides sharded over the data axis.

A spec here is a tuple with one entry per dimension of the tensor **in
PyTorch's layout** (None, "data" or "model"); an ``nn.Linear`` weight is
the flax kernel transposed and a conv weight ``[out, in, k...]`` is flax's
``[k..., in, out]``.  The rules are evaluated on the flax layout and
transposed, so that JAX's tie-break (``max`` over the candidate dims in
flax order: a square kernel shards its *in* dimension) carries over: that
is torch's dim 1 of a Linear weight, not dim 0.

GSPMD places the collectives that such annotations need; here
``shard_module`` places the shards and sets up the modules to run their
part (``core.attention``: the projections' collectives, a site's local
heads), and the train step (``training.trainer``) averages the gradients
over the data axis, gathers FSDP's shards around the forward and backward
(``gathered``) and takes its norms over all shards.  The layout it records
(``layout_of(model)``) is what the optimizer, the checkpoints and the data
path read.
"""

from __future__ import annotations

import contextlib
import dataclasses
import re
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from perceiverio_pytorch_tpu_torch.parallel import collectives as cc
from perceiverio_pytorch_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, axis, mesh_device

__all__ = ["NamedSharding", "ShardLayout", "batch_sharding", "fsdp_param_partition_spec",
           "gathered", "layout_of", "param_partition_spec", "replicated", "shard_module",
           "shard_variables", "variables_shardings"]

_COLUMN_PARALLEL = ("proj_q", "proj_k", "proj_v", "fc1")
_ROW_PARALLEL = ("final", "fc2")
# The port's nn.Embedding tables (2-D ".weight"s that are not Linear weights).
_EMBEDDINGS = ("embed", "_embedding")
_TRANSPOSED_CONV = re.compile(r"(^|\.)(transp_conv\d+|conv3d_transpose_\d+)\.weight$")

Spec = Tuple[Optional[str], ...]


def _kind(name: str, ndim: int) -> str:
    """The layout of a parameter, from its name: "linear", "conv",
    "conv_transpose" or "same" (flax's layout)."""
    parts = name.split(".")
    if parts[-1] != "weight" or ndim < 2:
        return "same"
    if ndim == 2:
        return "same" if len(parts) > 1 and parts[-2] in _EMBEDDINGS else "linear"
    return "conv_transpose" if _TRANSPOSED_CONV.search(name) else "conv"


def _flax_dims(kind: str, ndim: int) -> List[int]:
    """For each torch dim, the flax dim it is."""
    if kind == "linear":
        return [1, 0]
    if kind == "conv":  # torch [out, in, k...] <- flax [k..., in, out]
        return [ndim - 1, ndim - 2] + list(range(ndim - 2))
    if kind == "conv_transpose":  # torch [in, out, k...] <- flax [k..., in, out]
        return [ndim - 2, ndim - 1] + list(range(ndim - 2))
    return list(range(ndim))


def _to_flax(spec: Spec, dims: List[int]) -> List[Optional[str]]:
    out = [None] * len(dims)
    for t, f in enumerate(dims):
        out[f] = spec[t]
    return out


def _to_torch(flax_spec, dims: List[int]) -> Spec:
    return tuple(flax_spec[f] for f in dims)


def param_partition_spec(name: str, value: torch.Tensor, kind: Optional[str] = None) -> Spec:
    """The spec of one parameter, by its port name (torch layout).

    ``kind`` ("linear", "conv", "conv_transpose", "same") overrides the
    layout the name implies (``shard_module`` passes the module's)."""
    ndim = value.dim()
    kind = kind or _kind(name, ndim)
    parts = name.split(".")
    spec: List[Optional[str]] = [None] * ndim
    if len(parts) < 2:
        return tuple(spec)
    parent, leaf = parts[-2], parts[-1]
    if parent in _COLUMN_PARALLEL:
        if leaf == "weight" and kind == "linear":
            spec = _to_torch([None, MODEL_AXIS], _flax_dims(kind, 2))
        elif leaf == "bias" and ndim == 1:
            spec = [MODEL_AXIS]
    if parent in _ROW_PARALLEL and leaf == "weight" and kind == "linear":
        spec = _to_torch([MODEL_AXIS, None], _flax_dims(kind, 2))
    return tuple(spec)


def _fsdp_dim(shape, flax_dims, base: Spec, data_size: int) -> Optional[int]:
    """The torch dim FSDP shards: JAX's rule on the flax shape (the largest
    still-unsharded dim divisible by ``data_size``, first in flax order on a
    tie), or None."""
    flax_shape = [0] * len(shape)
    for t, f in enumerate(flax_dims):
        flax_shape[f] = shape[t]
    flax_base = _to_flax(base, flax_dims)
    candidates = [d for d in range(len(shape)) if flax_base[d] is None
                  and flax_shape[d] > 0 and flax_shape[d] % data_size == 0]
    if not candidates:
        return None
    best = max(candidates, key=lambda d: flax_shape[d])
    return flax_dims.index(best)


def fsdp_param_partition_spec(name: str, value: torch.Tensor, data_size: int,
                              base: Optional[Spec] = None, kind: Optional[str] = None) -> Spec:
    """``base`` (default: the TP rule) with FSDP's data-axis dim composed in
    (JAX ``fsdp_param_partition_spec``); 1-D parameters and a data axis of
    one keep ``base``."""
    kind = kind or _kind(name, value.dim())
    base = tuple(base) if base is not None else param_partition_spec(name, value, kind)
    if value.dim() < 2 or data_size <= 1:
        return base
    dim = _fsdp_dim(tuple(value.shape), _flax_dims(kind, value.dim()), base, data_size)
    if dim is None:
        return base
    return tuple(DATA_AXIS if d == dim else s for d, s in enumerate(base))


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (JAX's ``NamedSharding``): ``piece(x)`` is this
    rank's piece of the whole tensor ``x`` where ``x`` lies, ``shard(x)``
    that piece on the rank's device."""

    mesh: object
    spec: Spec = ()

    def piece(self, x) -> torch.Tensor:
        x = torch.from_numpy(np.ascontiguousarray(x)) if isinstance(x, np.ndarray) else x
        x = torch.as_tensor(x)
        for dim, name in enumerate(self.spec):
            if name is None:
                continue
            ax = axis(self.mesh, name)
            if x.shape[dim] % ax.size:
                raise ValueError(f"dimension {dim} of size {x.shape[dim]} does not split over"
                                 f" the {name} axis of {ax.size}")
            x = x.chunk(ax.size, dim=dim)[ax.index]
        return x

    def shard(self, x) -> torch.Tensor:
        return self.piece(x).to(mesh_device(self.mesh))


def batch_sharding(mesh) -> NamedSharding:
    """Shard the leading batch axis over the data axis."""
    return NamedSharding(mesh, (DATA_AXIS,))


def replicated(mesh) -> NamedSharding:
    return NamedSharding(mesh, ())


def _module_kind(module: nn.Module) -> str:
    if isinstance(module, (nn.ConvTranspose1d, nn.ConvTranspose2d, nn.ConvTranspose3d)):
        return "conv_transpose"
    if isinstance(module, (nn.Conv1d, nn.Conv2d, nn.Conv3d)):
        return "conv"
    if isinstance(module, nn.Linear):
        return "linear"
    return "same"


def _named_params(model: nn.Module):
    """(name, module, attribute, parameter, kind) of every parameter once."""
    seen = set()
    for mod_name, mod in model.named_modules():
        for attr, p in mod.named_parameters(recurse=False):
            if id(p) in seen:
                continue
            seen.add(id(p))
            name = f"{mod_name}.{attr}" if mod_name else attr
            kind = _module_kind(mod) if attr == "weight" else "same"
            yield name, mod, attr, p, kind


def variables_shardings(model: nn.Module, mesh, fsdp: bool = False) -> Dict[str, NamedSharding]:
    """``NamedSharding`` of every ``state_dict`` entry of ``model`` (its
    whole, unsharded form): the rules for parameters, replicated buffers."""
    layout = layout_of(model)
    if layout is not None:  # placed already: the specs it was placed by
        return {name: NamedSharding(mesh, layout.specs.get(name, ()))
                for name in model.state_dict()}
    data_size = axis(mesh, DATA_AXIS).size
    specs = {}
    for name, _, _, p, kind in _named_params(model):
        spec = param_partition_spec(name, p, kind)
        if fsdp:
            spec = fsdp_param_partition_spec(name, p, data_size, base=spec, kind=kind)
        specs[name] = spec
    return {name: NamedSharding(mesh, specs.get(name, ())) for name in model.state_dict()}


def shard_variables(state_dict, model: nn.Module, mesh, fsdp: bool = False):
    """This rank's pieces of a whole ``state_dict`` of ``model`` on the mesh
    device, by ``variables_shardings``."""
    shardings = variables_shardings(model, mesh, fsdp=fsdp)
    return {name: shardings[name].shard(value) for name, value in state_dict.items()}


@dataclasses.dataclass
class ShardLayout:
    """What ``shard_module`` did to a model: the mesh, each parameter's spec
    (by ``state_dict`` name, a tied parameter under each of its names), each
    parameter's first name (``names``, by ``id``), and the parameters FSDP
    gathers at use (``gathers``: (modules and attributes, parameter, dim))."""

    mesh: object
    specs: Dict[str, Spec]
    names: Dict[int, str]
    gathers: List[tuple]

    def spec(self, p: torch.Tensor) -> Spec:
        return self.specs[self.names[id(p)]]

    def axes(self, p: torch.Tensor) -> Tuple[str, ...]:
        return tuple(a for a in self.spec(p) if a is not None)

    def gather(self, p: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """The whole tensor of which ``t`` is this rank's piece, placed as
        parameter ``p`` (no gradient)."""
        return self.gather_spec(self.spec(p), t)

    def gather_spec(self, spec: Spec, t: torch.Tensor) -> torch.Tensor:
        """The whole tensor of which ``t`` is this rank's piece by ``spec``."""
        for dim, name in enumerate(spec):
            if name is not None:
                t = cc.all_gather_dim(t.detach(), dim, axis(self.mesh, name).group)
        return t

    def local(self, p: torch.Tensor, whole: torch.Tensor) -> torch.Tensor:
        """This rank's piece of ``whole``, placed as parameter ``p``."""
        return NamedSharding(self.mesh, self.spec(p)).shard(whole)

    def global_norm(self, params, tensors) -> torch.Tensor:
        """``optim.global_norm`` of tensors placed as ``params``, over every
        shard: each tensor's sum of squares all-reduced over the axes its
        piece is split on (one collective per distinct set of axes), then
        the same sum and square root."""
        squares = [t.detach().float().pow(2).sum() for t in tensors]
        if not squares:
            return torch.zeros(())
        squares = torch.stack(squares)
        by_axes: Dict[Tuple[str, ...], List[int]] = {}
        for i, p in enumerate(params):
            by_axes.setdefault(self.axes(p), []).append(i)
        for axes, idx in by_axes.items():
            if axes:
                part = squares[idx]
                for name in sorted(set(axes)):
                    cc.all_reduce_(part, axis(self.mesh, name).group)
                squares[idx] = part
        return squares.sum().sqrt()

    def all_finite(self, finite: bool, device) -> bool:
        """Whether every rank's ``finite`` is true (one read)."""
        flag = torch.tensor([1 if finite else 0], dtype=torch.int32, device=device)
        for name in (DATA_AXIS, MODEL_AXIS):
            cc.all_reduce_(flag, axis(self.mesh, name).group, torch.distributed.ReduceOp.MIN)
        return bool(flag.item())


def layout_of(model: nn.Module) -> Optional[ShardLayout]:
    """The ``ShardLayout`` of a model placed by ``shard_module`` (None)."""
    return getattr(model, "_parallel_layout", None)


def shard_module(model: nn.Module, mesh, fsdp: bool = False) -> nn.Module:
    """Place ``model`` on ``mesh`` by the rules, in place; returns it.

    Every parameter keeps its name and becomes this rank's piece on the
    rank's device (``NamedSharding.shard``).  The projections the rules
    split run their part: a column-parallel one takes its input through
    ``copy_to`` and gives its local output features, a row-parallel one
    sums its partial products over the model axis (``reduce_from``), and an
    ``Attention`` attends on its local heads where the model axis divides
    its heads, else on all heads gathered.  With ``fsdp`` each >=2-D
    parameter also holds its data-axis piece and is all-gathered around
    each forward and backward (``gathered``); on a data axis of one that
    gather still runs, over the one rank, on the dim a larger axis would
    shard.  Raises ValueError where a split dim does not divide, and for a
    projection the rules split outside an ``Attention`` or ``MLP`` (no
    block there runs its part).
    """
    from perceiverio_pytorch_tpu_torch.core.attention import MLP, Attention, Dense

    if layout_of(model) is not None:
        raise ValueError("the model is placed on a mesh already")
    loose = [f"{name}.{attr}".lstrip(".") for name, parent in model.named_modules()
             if not isinstance(parent, (Attention, MLP))
             for attr, mod in parent.named_children()
             if attr in _COLUMN_PARALLEL + _ROW_PARALLEL
             and next(mod.parameters(recurse=False), None) is not None]
    if loose:
        raise ValueError(f"the TP rules split {loose}, which sit outside an Attention or an"
                         " MLP: only those blocks run a split projection's part")
    device = mesh_device(mesh)
    model.to(device)
    data_size = axis(mesh, DATA_AXIS).size
    model_axis = axis(mesh, MODEL_AXIS)
    specs, names, gathers = {}, {}, []
    slots: Dict[int, list] = {}
    for mod_name, mod in model.named_modules():
        for attr, p in mod.named_parameters(recurse=False):
            slots.setdefault(id(p), []).append((mod, attr))
    with torch.no_grad():
        for name, mod, attr, p, kind in _named_params(model):
            spec = param_partition_spec(name, p, kind)
            fsdp_dim = None
            if fsdp and p.dim() >= 2:
                tp_spec = spec
                spec = fsdp_param_partition_spec(name, p, data_size, base=tp_spec, kind=kind)
                if DATA_AXIS in spec:
                    fsdp_dim = spec.index(DATA_AXIS)
                elif data_size == 1:
                    fsdp_dim = _fsdp_dim(tuple(p.shape), _flax_dims(kind, p.dim()), tp_spec, 1)
            specs[name], names[id(p)] = spec, name
            p.data = NamedSharding(mesh, spec).shard(p.data).contiguous().clone()
            if fsdp_dim is not None:
                gathers.append((slots[id(p)], p, fsdp_dim))
        # A parameter registered under two names (a tied table) has a spec
        # under each, as the state_dict has an entry under each.
        for name, p in model.named_parameters(remove_duplicate=False):
            specs[name] = specs[names[id(p)]]
    for parent in model.modules():
        if isinstance(parent, Attention):
            parent.tp = model_axis
        for attr, mod in parent.named_children():
            if isinstance(mod, Dense) and attr in _COLUMN_PARALLEL + _ROW_PARALLEL:
                mod.tp = ("col" if attr in _COLUMN_PARALLEL else "row", model_axis)
    model._parallel_layout = ShardLayout(mesh, specs, names, gathers)
    return model


@contextlib.contextmanager
def gathered(model: nn.Module):
    """Within the block, each parameter FSDP shards is its whole tensor,
    all-gathered over the data axis (with gradients enabled, through
    ``fsdp_gather``: its gradient is reduce-scattered back onto the shard
    when the backward reaches it); outside, the shards.  A no-op for a model
    without FSDP.  The backward of a forward run inside must run inside too
    (a checkpointed region is recomputed with the whole tensors)."""
    layout = layout_of(model)
    if layout is None or not layout.gathers:
        yield model
        return
    group = axis(layout.mesh, DATA_AXIS).group
    swapped = []
    try:
        for slots, p, dim in layout.gathers:
            if torch.is_grad_enabled() and p.requires_grad:
                whole = cc.fsdp_gather(p, dim, group)
            else:
                whole = cc.all_gather_dim(p.detach(), dim, group)
            for mod, attr in slots:
                mod._parameters[attr] = whole
                swapped.append((mod, attr, p))
        yield model
    finally:
        for mod, attr, p in swapped:
            mod._parameters[attr] = p
