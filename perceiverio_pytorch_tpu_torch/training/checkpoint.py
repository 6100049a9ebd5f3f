"""Weights save and restore.

Counterpart of the first part of
``perceiverio_pytorch_tpu/training/checkpoint.py`` (``save_variables`` and
``restore_variables``): Orbax's directory becomes a directory holding one
``torch.save`` of the ``state_dict``, read back with
``torch.load(weights_only=True)``, which unpickles tensors and containers
only.  Zero-size tensors (the decoder's [1, 0] padding embedding) round-trip
as they are, so no sidecar is needed.  The async writer, ``latest_checkpoint``,
``prune_checkpoints`` and the train state are not ported yet.
"""

from __future__ import annotations

import os
import shutil
from typing import Dict, Mapping

import torch

from perceiverio_pytorch_tpu_torch.utils.device import resolve_device

__all__ = ["restore_variables", "save_variables"]

_FILE = "state_dict.pt"


def save_variables(path: str, state_dict: Mapping[str, torch.Tensor],
                   overwrite: bool = False) -> None:
    """Save ``state_dict`` into the new directory ``path``.

    An existing ``path`` is refused (FileExistsError) unless ``overwrite``,
    which replaces it.  The file is written under a temporary name and
    renamed, so that a reader never sees half of it.
    """
    path = os.path.abspath(path)
    if os.path.exists(path):
        if not overwrite:
            raise FileExistsError(f"{path} exists; pass overwrite=True to replace it")
        shutil.rmtree(path)
    os.makedirs(path)
    tmp = os.path.join(path, _FILE + ".tmp")
    torch.save({name: t.detach() for name, t in state_dict.items()}, tmp)
    os.replace(tmp, os.path.join(path, _FILE))


def restore_variables(path: str, device="cuda") -> Dict[str, torch.Tensor]:
    """The ``state_dict`` saved at ``path``, its tensors on ``device``: the
    card unless the caller asks for the CPU."""
    return torch.load(os.path.join(os.path.abspath(path), _FILE),
                      map_location=resolve_device(device), weights_only=True)
