"""Data-parallel (and tensor-parallel) inference over a mesh.

Counterpart of ``perceiverio_pytorch_tpu/parallel/api.py``.
``make_data_parallel_apply`` returns ``(fn, place)``: ``place`` puts the
weights on this rank's device (replicated, or TP-sharded by the rules) and
takes this rank's rows of the batch; ``fn`` runs the forward on them and
returns the whole batch's output, all-gathered over the data axis, on every
rank.  ``FlowInference(mesh=...)`` and ``evaluate_classification --mesh``
serve through it.

``serve_on_mesh`` puts such an ``fn`` behind a ``BatchingServer``.  One
JAX process drives every device, so the JAX package's server needs no mesh
code; here each rank is a process, and every rank must run each batch.
Rank 0 serves: each padded batch is broadcast over the mesh's ranks, first
a small header (the number of arrays, each one's dtype and shape), then the
arrays, inside the server's one ``fn`` call at a time and on the mesh's
device (NCCL on the card), so that every rank sees the batches in one
order.  The other ranks follow: they receive each batch and call the same
``fn`` on it, until stopping the server sends a stop header.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.utils import _pytree as pytree

from perceiverio_pytorch_tpu_torch.parallel import collectives as cc
from perceiverio_pytorch_tpu_torch.parallel.mesh import DATA_AXIS, axis as mesh_axis, mesh_device
from perceiverio_pytorch_tpu_torch.parallel.sharding import (
    batch_sharding,
    replicated,
    shard_module,
    shard_variables,
)
from perceiverio_pytorch_tpu_torch.serving_server import BatchingServer

__all__ = ["make_data_parallel_apply", "pad_batch_to_multiple", "serve_on_mesh"]


def make_data_parallel_apply(model: nn.Module, mesh, tensor_parallel: bool = False):
    """``(fn, place)`` for ``model`` on ``mesh``.

    Args:
      model: the module; ``fn`` calls its ``forward``.  With
        ``tensor_parallel`` its projections are set up for the model axis
        (``shard_module``) and its own parameters become this rank's pieces.
      mesh: a (data, model) mesh (``make_mesh``).
      tensor_parallel: shard the attention and MLP projections over the
        model axis too.

    Returns:
      (fn, place): ``place(state_dict, *batch)`` returns ``(variables,
      *rows)``: the weights on this rank's device, replicated or as this
      rank's pieces, and this rank's rows of each whole batch array (the
      leading axis must divide by the data-axis size); ``fn(variables,
      *rows)`` returns the whole batch's output (each tensor of the output
      all-gathered along its leading axis over the data axis).
    """
    data = mesh_axis(mesh, DATA_AXIS)
    rows, whole = batch_sharding(mesh), replicated(mesh)
    model.to(mesh_device(mesh))
    if tensor_parallel:
        shard_module(model, mesh)

    def place(variables, *batch):
        if tensor_parallel:
            variables = shard_variables(variables, model, mesh)
        else:
            variables = {k: whole.shard(v) for k, v in variables.items()}
        return (variables,) + tuple(rows.shard(x) for x in batch)

    def fn(variables, *batch):
        out = torch.func.functional_call(model, variables, batch)
        return pytree.tree_map(lambda t: cc.all_gather_dim(t, 0, data.group), out)

    return fn, place


def pad_batch_to_multiple(array, multiple: int, axis: int = 0):
    """Pad the leading axis to a multiple (for even DP sharding).

    Returns (padded_array, original_size).
    """
    size = array.shape[axis]
    target = -(-size // multiple) * multiple
    if target == size:
        return array, size
    pad_width = [(0, 0)] * array.ndim
    pad_width[axis] = (0, target - size)
    return np.pad(np.asarray(array), pad_width), size


# The dtypes a served batch's arrays may have (their index goes in the
# header), the header's length and its first entry's values.
_DTYPES = (torch.float32, torch.bfloat16, torch.float16, torch.float64, torch.int64,
           torch.int32, torch.int16, torch.int8, torch.uint8, torch.bool)
_HEADER = 64
_BATCH, _STOP = 1, 0


def serve_on_mesh(fn, variables, mesh, **server_kwargs):
    """A ``BatchingServer`` on rank 0 of ``mesh`` over ``fn(variables,
    *rows)``; every rank of the mesh calls it (see the module docstring).

    Args:
      fn, variables: ``make_data_parallel_apply``'s ``fn`` and the weights
        its ``place`` returned.
      mesh: the (data, model) mesh ``fn`` was made for, over every rank of
        the process group; the buckets must divide by its data axis.
      **server_kwargs: for ``BatchingServer`` (``max_batch``,
        ``batch_sizes``, ``pipeline``, ...; ``device`` is the mesh's).

    Returns:
      On rank 0, the server: a request is one example (an array, or a tuple
      of arrays, one for each of ``fn``'s row arguments) and its future the
      example's output row; ``stop()`` also stops the other ranks.  On the
      other ranks, None once rank 0 has stopped its server (the call
      returns only then).
    """
    ranks = mesh.mesh.flatten().tolist()
    if ranks != list(range(dist.get_world_size())):
        raise ValueError(f"serve_on_mesh needs a mesh over every rank of the group in order;"
                         f" got ranks {ranks}")
    device = mesh_device(mesh)
    rows = batch_sharding(mesh)

    def run(leaves):
        return fn(variables, *(rows.piece(x) for x in leaves))

    def send_header(values):
        header = torch.zeros(_HEADER, dtype=torch.int64)
        header[:len(values)] = torch.tensor(values, dtype=torch.int64)
        dist.broadcast(header.to(device), src=0)

    if dist.get_rank() != 0:
        _follow(run, device)
        return None

    def call(batch):
        leaves = list(batch) if isinstance(batch, (tuple, list)) else [batch]
        leaves = [x.to(device) for x in leaves]
        header = [_BATCH, len(leaves)]
        for x in leaves:
            header += [_DTYPES.index(x.dtype), x.dim(), *x.shape]
        if len(header) > _HEADER:
            raise ValueError(f"a batch of {len(leaves)} arrays does not fit the header")
        send_header(header)
        for x in leaves:
            dist.broadcast(x.contiguous(), src=0)
        return run(leaves)

    return _MeshServer(lambda: send_header([_STOP]), call, device=device, **server_kwargs)


class _MeshServer(BatchingServer):
    """Rank 0's server: ``stop`` also sends the other ranks the stop header
    (once), after the last batch."""

    def __init__(self, stop_ranks, *args, **kwargs):
        self._stop_ranks = stop_ranks
        super().__init__(*args, **kwargs)

    def stop(self, drain: bool = True) -> None:
        try:
            super().stop(drain)
        finally:
            stop_ranks, self._stop_ranks = self._stop_ranks, None
            if stop_ranks is not None:
                stop_ranks()


def _follow(run, device) -> None:
    """A following rank's loop: receive each batch rank 0 serves and run it,
    until the stop header."""
    while True:
        header = torch.empty(_HEADER, dtype=torch.int64, device=device)
        dist.broadcast(header, src=0)
        values = header.tolist()
        if values[0] == _STOP:
            return
        leaves, pos = [], 2
        for _ in range(values[1]):
            dtype, ndim = _DTYPES[values[pos]], values[pos + 1]
            shape = values[pos + 2:pos + 2 + ndim]
            pos += 2 + ndim
            x = torch.empty(shape, dtype=dtype, device=device)
            dist.broadcast(x, src=0)
            leaves.append(x)
        with torch.inference_mode():
            run(leaves)
