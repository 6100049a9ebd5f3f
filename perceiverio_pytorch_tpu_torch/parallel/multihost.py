"""Multi-process support: joining the process group, per-rank batches.

Counterpart of ``perceiverio_pytorch_tpu/parallel/multihost.py``.  A JAX
process drives all the devices of its host; here each process drives one
device, so a "process" of the JAX package is a rank, and the rows of a
global batch a rank holds are those of its coordinate on the data axis: the
ranks of one model group hold the same rows.  Every helper is the
single-process path's identity when one process runs.

A launch is what ``torchrun`` (``python -m torch.distributed.run``)
describes in the environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
``MASTER_PORT``, ``LOCAL_RANK``), the counterpart of the JAX package's TPU
pod variables; explicit arguments serve other launchers and tests.
"""

from __future__ import annotations

import os
from typing import Any, Optional

import torch
import torch.distributed as dist

from perceiverio_pytorch_tpu_torch.parallel import collectives as cc
from perceiverio_pytorch_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    axis,
    backend_for,
    process_mesh,
)

__all__ = [
    "initialize_distributed",
    "is_multihost",
    "local_batch_size",
    "shard_host_batch",
    "sync_hosts",
]

_LAUNCH_VARIABLES = ("RANK", "WORLD_SIZE", "MASTER_ADDR")


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None, *, device="cuda",
                           **kwargs) -> bool:
    """Join this process to the process group; returns True if it did.

    Skipped, returning False, when a group exists already or when nothing
    indicates a multi-process launch (no arguments and no ``torchrun``
    environment), so that scripts can call it unconditionally and still run
    as one process.  ``coordinator_address`` is ``host:port`` of rank 0 (a
    ``tcp://`` or ``file://`` URL is taken as it is); without it the
    environment describes the group.  The backend follows ``device``: NCCL
    for "cuda" (this rank's card is ``cuda:<LOCAL_RANK>``), gloo for "cpu".
    ``kwargs`` go to ``init_process_group`` (e.g. ``timeout``).
    """
    if dist.is_initialized():
        return False
    explicit = coordinator_address is not None or num_processes is not None
    if not explicit and not any(os.environ.get(k) for k in _LAUNCH_VARIABLES):
        return False
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    if num_processes is not None:
        kwargs["world_size"] = int(num_processes)
    if process_id is not None:
        kwargs["rank"] = int(process_id)
    dist.init_process_group(backend_for(device), init_method=init_method, **kwargs)
    return True


def is_multihost() -> bool:
    """True when more than one process shares the group."""
    return dist.is_initialized() and dist.get_world_size() > 1


def _data_axis(mesh):
    """(size, this rank's coordinate) of the data axis: the mesh's (default:
    the last one this process made), or every rank on it without one."""
    mesh = mesh if mesh is not None else process_mesh()
    if mesh is not None:
        ax = axis(mesh, DATA_AXIS)
        return ax.size, ax.index
    if dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def data_rows(global_batch_size: int, mesh=None):
    """``[lo, hi)`` of this rank's contiguous piece of a global batch: the
    piece of its coordinate on the data axis (``local_batch_size`` rows)."""
    _, index = _data_axis(mesh)
    local = local_batch_size(global_batch_size, mesh)
    return index * local, index * local + local


def local_batch_size(global_batch_size: int, mesh=None) -> int:
    """Examples this rank feeds per global batch: the global batch over the
    data axis's size (ranks of one model group feed the same rows).  The
    global size must divide evenly."""
    size, _ = _data_axis(mesh)
    if global_batch_size % size != 0:
        raise ValueError(
            f"global batch {global_batch_size} is not divisible by the process count {size}")
    return global_batch_size // size


def shard_host_batch(batch: Any, mesh, *, spec=None) -> Any:
    """Assemble each rank's rows into the global batch, on the rank's device.

    ``batch`` is this rank's rows (``local_batch_size(global)`` of them, as
    ``data_rows`` picks them); the result is the global batch on every rank,
    all-gathered over the data axis (tuples and lists of arrays or tensors).
    The train step and ``fit`` take global batches and keep their own rows.
    ``spec`` other than the batch axis over the data axis (the default) is
    ``()``: the rank already holds the whole value.  With one process this
    is ``batch`` moved to the device.
    """
    from perceiverio_pytorch_tpu_torch.parallel.sharding import replicated

    group = axis(mesh, DATA_AXIS).group
    whole = spec is not None and tuple(spec) == ()

    def put(x):
        x = replicated(mesh).shard(x)
        return x if whole else cc.all_gather_dim(x, 0, group)

    if isinstance(batch, (tuple, list)):
        return type(batch)(put(x) for x in batch)
    return put(batch)


def sync_hosts(name: str = "sync_hosts") -> None:
    """Barrier across all processes (a no-op for one process).

    Use around host side effects that are not collective, e.g. after
    ``Trainer.fit`` so that no process reads a checkpoint another is still
    writing."""
    del name  # the JAX package names its barrier; torch.distributed does not
    if is_multihost():
        dist.barrier()
