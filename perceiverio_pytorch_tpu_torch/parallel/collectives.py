"""The collectives that GSPMD inserts for the JAX package, written out.

The JAX package annotates parameters and batches with shardings and lets
XLA place every collective.  Here each is explicit, and each that sits in a
forward is an autograd Function with the matching backward (Megatron's
``f``/``g`` pair and FSDP's gather):

  * ``copy_to``: identity forward, all-reduce of the gradient backward (the
    replicated input of a column-parallel projection);
  * ``reduce_from``: all-reduce forward, identity backward (the partial sums
    of a row-parallel projection);
  * ``gather_dim`` / ``scatter_dim``: all-gather along a dim forward and
    this rank's slice of the gradient backward, and the reverse (a site
    whose heads do not split over the model axis gathers its projections);
  * ``fsdp_gather``: all-gather of a weight shard forward, reduce-scatter
    (a sum) of its gradient backward;
  * ``all_reduce_sum``: all-reduce forward and backward (the batch
    statistics of train-mode BatchNorm over the global batch).

``summed_params(modules, group)`` and ``using(...)`` put each parameter of
some modules through ``copy_to`` for a block: a rank that applies them to
its own part of the work (its key shard, its decoder chunks) gets a partial
gradient, which the ``copy_to`` sums over the axis once, before any
optimizer sees it.

``global_batch(group)`` marks the code that runs on this rank's rows of a
batch sharded over the data axis: the losses and BatchNorm read
``data_group()`` to reduce their denominators and statistics over it.
Every function takes the group of one mesh axis (``mesh.axis(...).group``).
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.distributed as dist

__all__ = ["all_gather_dim", "all_reduce_", "all_reduce_sum", "copy_to", "data_group",
           "fsdp_gather", "gather_dim", "global_batch", "reduce_from", "reduce_scatter_dim",
           "scatter_dim", "summed_params", "using"]

# dist.all_gather_single / reduce_scatter_single where the installed torch
# has them (the *_tensor names are deprecated there), else the older names.
_ALL_GATHER = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor


def size(group) -> int:
    return dist.get_world_size(group)


def index(group) -> int:
    return dist.get_group_rank(group, dist.get_rank())


def all_reduce_(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """In-place all-reduce of ``t`` over ``group``; returns ``t``."""
    dist.all_reduce(t, op=op, group=group)
    return t


def all_gather_dim(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The ranks' ``t`` concatenated along ``dim``, in group-rank order."""
    n = size(group)
    flat = t.contiguous().reshape(-1)
    out = flat.new_empty(n * flat.numel())
    _ALL_GATHER(out, flat, group=group)
    out = out.view((n,) + tuple(t.shape))
    return torch.cat(out.unbind(0), dim=dim) if n > 1 else out[0]


def reduce_scatter_dim(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's piece along ``dim`` of the ranks' ``t`` summed."""
    n = size(group)
    pieces = torch.stack(t.chunk(n, dim=dim)) if n > 1 else t.unsqueeze(0)
    out = t.new_empty(pieces.shape[1:])
    _REDUCE_SCATTER(out.view(-1), pieces.contiguous().view(-1), group=group)
    return out


def local_piece(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's contiguous piece of ``t`` along ``dim``."""
    return t.chunk(size(group), dim=dim)[index(group)]


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.group), None


class _GatherDim(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return all_gather_dim(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return local_piece(g, ctx.dim, ctx.group).contiguous(), None, None


class _ScatterDim(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return local_piece(x, dim, group).contiguous()

    @staticmethod
    def backward(ctx, g):
        return all_gather_dim(g, ctx.dim, ctx.group), None, None


class _FsdpGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, shard, dim, group):
        ctx.dim, ctx.group = dim, group
        return all_gather_dim(shard, dim, group)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter_dim(g, ctx.dim, ctx.group), None, None


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    return _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    return _ReduceFrom.apply(x, group)


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    return _AllReduceSum.apply(x, group)


def gather_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    return _GatherDim.apply(x, dim % x.dim(), group)


def scatter_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    return _ScatterDim.apply(x, dim % x.dim(), group)


def fsdp_gather(shard: torch.Tensor, dim: int, group) -> torch.Tensor:
    return _FsdpGather.apply(shard, dim, group)


def summed_params(modules, group) -> list:
    """``(module, attribute, copy_to(parameter, group))`` for every parameter
    slot of ``modules`` and their children (a parameter held in two slots
    goes through one ``copy_to``): stand-ins whose gradient is all-reduced
    over ``group`` when the backward reaches them (``using``)."""
    summed, out = {}, []
    for root in modules:
        for mod in root.modules():
            for attr, p in mod._parameters.items():
                if p is None:
                    continue
                if id(p) not in summed:
                    summed[id(p)] = copy_to(p, group)
                out.append((mod, attr, summed[id(p)]))
    return out


@contextlib.contextmanager
def using(substitutes):
    """Within the block, each ``(module, attribute, tensor)`` of
    ``substitutes`` stands in for that module's parameter.  Entering the
    block inside a checkpointed function makes the recomputation use the
    same stand-ins."""
    saved = []
    try:
        for mod, attr, tensor in substitutes:
            saved.append((mod, attr, mod._parameters[attr]))
            mod._parameters[attr] = tensor
        yield
    finally:
        for mod, attr, p in reversed(saved):
            mod._parameters[attr] = p


# The data-axis group of the enclosing global_batch block.  Process-wide, not
# per thread: a checkpointed region is recomputed on the autograd engine's
# device thread.
_DATA_GROUP = None


@contextlib.contextmanager
def global_batch(group):
    """Within the block, the code runs on this rank's rows of a batch sharded
    over ``group`` (the data axis): ``data_group()`` returns it."""
    global _DATA_GROUP
    prev, _DATA_GROUP = _DATA_GROUP, group
    try:
        yield
    finally:
        _DATA_GROUP = prev


def data_group() -> Optional[object]:
    """The data-axis group of the enclosing ``global_batch`` block, if it
    has more than one rank; None otherwise (a batch held whole)."""
    group = _DATA_GROUP
    return group if group is not None and size(group) > 1 else None
