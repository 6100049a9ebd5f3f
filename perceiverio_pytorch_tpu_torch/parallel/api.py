"""Data-parallel (and tensor-parallel) inference over a mesh.

Counterpart of ``perceiverio_pytorch_tpu/parallel/api.py``.
``make_data_parallel_apply`` returns ``(fn, place)``: ``place`` puts the
weights on this rank's device (replicated, or TP-sharded by the rules) and
takes this rank's rows of the batch; ``fn`` runs the forward on them and
returns the whole batch's output, all-gathered over the data axis, on every
rank.  ``FlowInference(mesh=...)`` and ``evaluate_classification --mesh``
serve through it.
"""

from __future__ import annotations

import numpy as np
import torch
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

__all__ = ["make_data_parallel_apply", "pad_batch_to_multiple"]


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
