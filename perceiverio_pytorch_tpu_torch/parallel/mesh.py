"""Device-mesh construction: one process per device on ``torch.distributed``.

Counterpart of ``perceiverio_pytorch_tpu/parallel/mesh.py``.  The axes are
the JAX package's:

  * ``data``  -- batch (data parallelism): gradients are averaged over it,
    and with FSDP the weights and their optimizer moments are sharded over
    it;
  * ``model`` -- tensor parallelism over attention heads and the MLP's
    hidden width.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with
``mesh_dim_names=("data", "model")``, laid out row-major as JAX's
``reshape(d, m)``: rank r sits at (r // m, r % m).  Each rank is one
process driving one device (``cuda:<LOCAL_RANK>``, or the CPU), where a JAX
process drives all the devices of its host.  ``parallel.pipeline``'s
``make_pipeline_mesh`` makes a ("data", "pipe") mesh with the same set-up
(``join_group``).

``make_mesh`` in a process without a process group joins the one a
``torchrun`` launch describes (``multihost.initialize_distributed``), and
with no launch makes a one-rank group on a ``HashStore`` (no port, no
launcher), so that ``--mesh 1 1`` runs from a plain ``python`` call.  The
backend follows the device: NCCL for ``cuda``, gloo for ``cpu``.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"

__all__ = ["DATA_AXIS", "MODEL_AXIS", "Axis", "adopt_process_mesh", "axis",
           "default_mesh_shape", "join_group", "make_mesh", "mesh_device", "process_mesh"]

# The mesh the last make_mesh call of this process made (the data path's
# default, as JAX's process index is the process's own).
_PROCESS_MESH = None


def backend_for(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def _local_cuda_device() -> torch.device:
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))


def make_mesh(shape: Optional[Tuple[int, int]] = None, *,
              devices: Optional[Sequence[int]] = None, device="cuda"):
    """Create a (data, model) mesh over the process group's ranks.

    Args:
      shape: (data, model) sizes.  Defaults to all ranks on the data axis.
      devices: the global ranks to lay out row-major (default: every rank
        of the group, in order).
      device: "cuda" (this rank's card, ``cuda:<LOCAL_RANK>``, over NCCL) or
        "cpu" (over gloo).

    Raises ValueError when d * m is not the number of ranks.
    """
    from torch.distributed.device_mesh import DeviceMesh

    global _PROCESS_MESH
    device, ranks = join_group(device, devices)
    if shape is None:
        shape = (len(ranks), 1)
    d, m = (int(s) for s in shape)
    if d * m != len(ranks):
        raise ValueError(f"mesh shape {tuple(shape)} != device count {len(ranks)}")
    mesh = DeviceMesh(device.type, torch.tensor(ranks).reshape(d, m),
                      mesh_dim_names=(DATA_AXIS, MODEL_AXIS))
    _PROCESS_MESH = mesh
    return mesh


def join_group(device, devices: Optional[Sequence[int]] = None):
    """Set up this rank for a mesh: its card (``cuda:<LOCAL_RANK>``) made
    current, the process group joined (``multihost.initialize_distributed``)
    or, with no launch, made as a one-rank group on a ``HashStore``.
    Returns the resolved device and the global ranks ``devices`` names
    (default: every rank of the group, in order)."""
    from perceiverio_pytorch_tpu_torch.parallel.multihost import initialize_distributed
    from perceiverio_pytorch_tpu_torch.utils.device import resolve_device

    device = resolve_device(device)
    if device.type == "cuda":
        torch.cuda.set_device(_local_cuda_device() if device.index is None else device)
    if not dist.is_initialized() and not initialize_distributed(device=device.type):
        dist.init_process_group(backend_for(device), store=dist.HashStore(), rank=0,
                                world_size=1)
    return device, list(devices if devices is not None else range(dist.get_world_size()))


def default_mesh_shape(n_devices: int) -> Tuple[int, int]:
    """Pick a (data, model) factorisation: model=2 when even and >=4 devices
    (exercises TP collectives), else pure DP."""
    if n_devices >= 4 and n_devices % 2 == 0:
        return (n_devices // 2, 2)
    return (n_devices, 1)


def process_mesh():
    """The mesh this process made last (None before any): the layout the
    data path slices batches by when it is given no mesh."""
    if _PROCESS_MESH is not None and not dist.is_initialized():
        return None  # its group was torn down
    return _PROCESS_MESH


def adopt_process_mesh(mesh) -> None:
    """Make ``mesh`` the data path's default unless this process made a
    (data, model) mesh already, whose data axis the Trainer splits rows by."""
    global _PROCESS_MESH
    if process_mesh() is None:
        _PROCESS_MESH = mesh


class Axis(NamedTuple):
    """One mesh axis as this rank sees it: its process group, its size and
    this rank's coordinate along it."""

    group: object
    size: int
    index: int


def axis(mesh, name: str) -> Axis:
    """``Axis`` of ``mesh`` named ``name`` ("data", "model" or "pipe")."""
    cache = mesh.__dict__.setdefault("_pio_axes", {})
    if name not in cache:
        cache[name] = Axis(mesh.get_group(name), mesh.size(mesh.mesh_dim_names.index(name)),
                           mesh.get_local_rank(name))
    return cache[name]


def mesh_device(mesh) -> torch.device:
    """The device this rank of ``mesh`` drives."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)
