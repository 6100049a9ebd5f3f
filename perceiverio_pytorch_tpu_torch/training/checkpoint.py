"""Weights and train-state checkpoints.

Counterpart of ``perceiverio_pytorch_tpu/training/checkpoint.py``.  Orbax's
directory becomes a directory holding one ``torch.save`` file, read back
with ``torch.load(weights_only=True)``, which unpickles tensors and plain
containers only, and a marker file (``checkpoint.json``) written after it:
a save counts as finished only once its marker exists, as Orbax's
``_CHECKPOINT_METADATA`` marks its own.

- ``save_variables``/``restore_variables``: a ``state_dict`` (serving).
- ``save_train_state``/``restore_train_state``: the module's ``state_dict``
  (BatchNorm's running averages and ``num_batches_tracked`` included; the
  non-persistent Fourier tables are derived, not saved), the optimizer's
  ``state_dict``, ``step`` and, when the state keeps one, the EMA of the
  parameters.  The optimizer's ``state_dict`` carries its own counts
  (``training/optim.py``: the inner count the schedule reads, the
  accumulation window and its running mean, the non-finite counters), so a
  resume inside an accumulation window goes on exactly.
- ``AsyncCheckpointWriter``: the same saves written by a thread while the
  training goes on.
- ``latest_checkpoint``/``prune_checkpoints``: the Trainer's
  ``step_XXXXXXXX`` directories.
- ``restore_eval_variables``: weights for evaluation from either kind of
  directory (a train state's EMA weights where it has them) or from a
  reference-convention ``.pth``.

Every tensor is copied to host memory before ``torch.save`` sees it: a
``state_dict`` holds live references, and AdamW updates the parameters in
place, so a writer that kept the references would save a later step's
values.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, List, Mapping, Optional

import torch
from torch import nn

from perceiverio_pytorch_tpu_torch.training.trainer import TrainState
from perceiverio_pytorch_tpu_torch.utils.device import resolve_device

__all__ = [
    "AsyncCheckpointWriter",
    "latest_checkpoint",
    "prune_checkpoints",
    "restore_eval_variables",
    "restore_train_state",
    "restore_variables",
    "save_train_state",
    "save_variables",
]

_FILE = "state_dict.pt"  # save_variables
_STATE_FILE = "train_state.pt"  # save_train_state
_MARKER = "checkpoint.json"  # written last: the save is finished


def _host_copy(tree: Any) -> Any:
    """The tree with every tensor copied to host memory (a copy even when the
    tensor is already there).  Copies from a card go to pinned memory without
    blocking, one after another on the current stream, and are waited for
    once at the end."""
    devices = set()

    def copy(node):
        if isinstance(node, torch.Tensor):
            if node.is_cuda:
                devices.add(node.device)
                return node.detach().to("cpu", non_blocking=True)  # pinned
            return node.detach().to("cpu", copy=True)
        if isinstance(node, Mapping):
            return {k: copy(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(copy(v) for v in node)
        return node

    out = copy(tree)
    for device in devices:
        torch.cuda.synchronize(device)
    return out


def _train_state_tree(state: TrainState) -> Dict[str, Any]:
    tree = {"step": int(state.step), "model": state.model.state_dict(),
            "optimizer": state.optimizer.state_dict()}
    if state.ema_params is not None:
        tree["ema"] = dict(state.ema_params)
    return tree


def _prepare(path: str, overwrite: bool) -> str:
    path = os.path.abspath(path)
    if os.path.exists(path):
        if not overwrite:
            raise FileExistsError(f"{path} exists; pass overwrite=True to replace it")
        shutil.rmtree(path)
    os.makedirs(path)
    return path


def _write(path: str, name: str, tree: Any, kind: str) -> None:
    """``torch.save`` of a host tree under a temporary name, renamed, then
    the marker."""
    tmp = os.path.join(path, name + ".tmp")
    torch.save(tree, tmp)
    os.replace(tmp, os.path.join(path, name))
    marker = {"kind": kind, "file": name}
    if kind == "train_state":
        marker["step"] = tree["step"]
    with open(os.path.join(path, _MARKER + ".tmp"), "w") as f:
        json.dump(marker, f)
    os.replace(os.path.join(path, _MARKER + ".tmp"), os.path.join(path, _MARKER))


def save_variables(path: str, state_dict: Mapping[str, torch.Tensor],
                   overwrite: bool = False) -> None:
    """Save ``state_dict`` into the new directory ``path``.

    An existing ``path`` is refused (FileExistsError) unless ``overwrite``,
    which replaces it.  Zero-size tensors (the decoder's [1, 0] padding
    embedding) round-trip as they are.
    """
    path = _prepare(path, overwrite)
    _write(path, _FILE, _host_copy(dict(state_dict)), "variables")


def restore_variables(path: str, device="cuda") -> Dict[str, torch.Tensor]:
    """The ``state_dict`` saved at ``path``, its tensors on ``device``: the
    card unless the caller asks for the CPU."""
    return torch.load(os.path.join(os.path.abspath(path), _FILE),
                      map_location=resolve_device(device), weights_only=True)


def save_train_state(path: str, state: TrainState, overwrite: bool = False) -> None:
    """Save ``state`` (module, optimizer, step, EMA) into the new directory ``path``."""
    path = _prepare(path, overwrite)
    _write(path, _STATE_FILE, _host_copy(_train_state_tree(state)), "train_state")


def _load_train_state(path: str) -> Dict[str, Any]:
    return torch.load(os.path.join(os.path.abspath(path), _STATE_FILE), map_location="cpu",
                      weights_only=True)


def restore_train_state(path: str, state: TrainState) -> TrainState:
    """Restore the checkpoint at ``path`` into ``state``'s module,
    optimizer and EMA, in place and on their device, and set its step;
    returns ``state``.

    A checkpoint whose module entries (names or shapes), optimizer groups or
    EMA (present or not, names) do not match ``state`` is refused with
    ValueError before anything is changed, as the JAX package refuses a
    template that does not match.
    """
    tree = _load_train_state(path)
    have = state.model.state_dict()
    saved = tree["model"]
    missing, unexpected = sorted(set(have) - set(saved)), sorted(set(saved) - set(have))
    if missing or unexpected:
        raise ValueError(f"checkpoint at {path} does not match the model: missing "
                         f"{missing[:5]}, unexpected {unexpected[:5]}")
    shapes = [n for n in have if tuple(have[n].shape) != tuple(saved[n].shape)]
    if shapes:
        raise ValueError(f"checkpoint at {path} has other shapes at {shapes[:5]}")
    groups = [len(g["params"]) for g in state.optimizer.state_dict()["param_groups"]]
    saved_groups = [len(g["params"]) for g in tree["optimizer"]["param_groups"]]
    if groups != saved_groups:
        raise ValueError(f"checkpoint at {path} has optimizer groups of {saved_groups}"
                         f" parameters, the optimizer {groups}")
    saved_ema = tree.get("ema")
    if (None if saved_ema is None else set(saved_ema)) != (
            None if state.ema_params is None else set(state.ema_params)):
        raise ValueError(f"checkpoint at {path} has an EMA of other parameters than the"
                         " state's, or one where the state has none, or none where it has one")
    state.model.load_state_dict(saved, strict=True)
    state.optimizer.load_state_dict(tree["optimizer"])
    if saved_ema is not None:
        with torch.no_grad():
            for name, value in saved_ema.items():
                state.ema_params[name].copy_(value)
    state.step = int(tree["step"])
    return state


class AsyncCheckpointWriter:
    """Saves written to disk by a thread while training goes on.

    ``save`` copies every tensor to host memory before it returns (a copy
    from the card waits for the work that produces it), so a following
    in-place update cannot reach the file; the ``torch.save`` and the marker
    run in a thread.  At most one save is in flight: ``save`` first waits
    for the previous one.  ``wait`` raises the writer's error, if any.
    ``latest_checkpoint`` skips a save whose marker is not written yet, so a
    crash in the middle of a write resumes from the previous one.  Use as a
    context manager or call ``close()`` before the process exits.
    """

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def _start(self, path: str, name: str, tree: Any, kind: str, overwrite: bool) -> None:
        self.wait()
        path = _prepare(path, overwrite)
        host = _host_copy(tree)

        def run():
            try:
                _write(path, name, host, kind)
            except BaseException as exc:  # raised again by wait()
                self._error = exc

        self._thread = threading.Thread(target=run, name="checkpoint_writer")
        self._thread.start()

    def save(self, path: str, state_dict: Mapping[str, torch.Tensor],
             overwrite: bool = False) -> None:
        """``save_variables`` in the background."""
        self._start(path, _FILE, dict(state_dict), "variables", overwrite)

    def save_train_state(self, path: str, state: TrainState, overwrite: bool = False) -> None:
        """``save_train_state`` in the background."""
        self._start(path, _STATE_FILE, _train_state_tree(state), "train_state", overwrite)

    def wait(self) -> None:
        """Block until the save in flight (if any) is on disk, marker included."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            error, self._error = self._error, None
            raise error

    def close(self) -> None:
        self.wait()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _is_finished(path: str) -> bool:
    return os.path.isdir(path) and os.path.exists(os.path.join(path, _MARKER))


def _step_dirs(checkpoint_dir: str) -> List[tuple]:
    """(step, path) of every ``step_XXXXXXXX`` directory."""
    found = []
    for name in os.listdir(checkpoint_dir):
        if not name.startswith("step_"):
            continue
        try:
            step = int(name[len("step_"):])
        except ValueError:
            continue
        full = os.path.join(checkpoint_dir, name)
        if os.path.isdir(full):
            found.append((step, full))
    return sorted(found)


def latest_checkpoint(checkpoint_dir: str) -> Optional[str]:
    """Path of the highest-step finished ``step_XXXXXXXX`` checkpoint, or
    None; saves without their marker (a crash in the middle of a save) are
    skipped."""
    if not os.path.isdir(checkpoint_dir):
        return None
    finished = [p for _, p in _step_dirs(checkpoint_dir) if _is_finished(p)]
    return finished[-1] if finished else None


def prune_checkpoints(checkpoint_dir: str, keep: int) -> list:
    """Delete all but the newest ``keep`` finished step checkpoints, and the
    unfinished ones older than the newest finished one (they can neither be
    resumed from nor be reached again).  Returns the removed paths."""
    if keep <= 0:
        raise ValueError(f"keep must be positive; got {keep}")
    if not os.path.isdir(checkpoint_dir):
        return []
    dirs = _step_dirs(checkpoint_dir)
    finished = [(s, p) for s, p in dirs if _is_finished(p)]
    doomed = [p for _, p in finished[:-keep]] if len(finished) > keep else []
    if finished:
        newest = finished[-1][0]
        doomed += [p for s, p in dirs if s < newest and not _is_finished(p)]
    for path in doomed:
        shutil.rmtree(path)
    return doomed


def _fill_batch_counters(model: nn.Module, state_dict: Dict[str, torch.Tensor]) -> None:
    """BatchNorm's ``num_batches_tracked``, which a ``.pth`` written from JAX
    variables lacks (flax has no such counter), keeps the model's value."""
    for name, value in model.state_dict().items():
        if name.endswith("num_batches_tracked") and name not in state_dict:
            state_dict[name] = value


def _fill_uncalibrated(model: nn.Module, state_dict: Dict[str, torch.Tensor]) -> None:
    """A static int8 projection's ``amax``, which weights saved from a model
    without one lack, is 0: uncalibrated, as the JAX package's initial
    ``quant_stats`` (run ``ops.quant.calibrate`` before serving)."""
    for name, value in model.state_dict().items():
        if name.endswith(".amax") and name not in state_dict:
            state_dict[name] = torch.zeros_like(value, device="cpu")


def restore_eval_variables(model: nn.Module, checkpoint: Optional[str] = None,
                           torch_checkpoint: Optional[str] = None) -> nn.Module:
    """Load weights into ``model`` (in place, on its device) for evaluation;
    returns ``model``.

    ``checkpoint`` is a ``save_variables`` directory or a Trainer
    checkpoint (``save_train_state``: its module entries, with the EMA
    weights in place of the trained parameters where it has them, as the
    JAX package prefers ``ema_params``).
    ``torch_checkpoint`` is a reference-convention ``.pth``
    (``{"model_state_dict": ...}``, or a bare state_dict), which loads with
    ``strict=True`` because the port carries the reference's names.  With
    neither, ``model`` is returned unchanged.  Into an ``int8_static`` model
    the load fills the ``amax`` entries a source without them lacks with 0
    (uncalibrated); any other missing or unexpected entry still fails.
    """
    ema = None
    if checkpoint:
        path = os.path.abspath(checkpoint)
        if os.path.exists(os.path.join(path, _STATE_FILE)):
            tree = _load_train_state(path)
            state_dict, ema = tree["model"], tree.get("ema")
        else:
            state_dict = restore_variables(path, device="cpu")
    elif torch_checkpoint:
        state_dict = torch.load(torch_checkpoint, map_location="cpu", weights_only=True)
        if "model_state_dict" in state_dict:
            state_dict = state_dict["model_state_dict"]
        state_dict = dict(state_dict)
        _fill_batch_counters(model, state_dict)
    else:
        return model
    state_dict = dict(state_dict)
    _fill_uncalibrated(model, state_dict)
    model.load_state_dict(state_dict, strict=True)
    if ema is not None:
        # By parameter: a module registered under two names (the language
        # model's token table) has two state_dict entries but one parameter.
        params = dict(model.named_parameters())
        with torch.no_grad():
            for name, value in ema.items():
                params[name].copy_(value)
    return model
