"""Ahead-of-time export for deployment (``torch.export``).

Counterpart of ``perceiverio_pytorch_tpu/serving.py``.  The deployment
unit is an exported program: ``export_apply`` traces
``model(*args, **static_kwargs)`` with the weights as an argument and
serializes it (``torch.export.save``) to bytes; ``load_exported`` turns the
bytes back into ``fn(state_dict, *args)``, which runs the traced graph with
no model code::

    model = ClassificationPerceiver(policy=PERFORMANCE).eval()
    weights = cast_variables_for_inference(model)
    blob = export_apply(model, weights, example_img, batch_polymorphic=True)
    Path("model.pt2").write_bytes(blob)

    # -- in the serving process --
    serve = load_exported(Path("model.pt2").read_bytes())
    logits = serve(weights, batch_of_any_size)

Notes:
  * The weights stay an argument: the artifact holds none of the model's
    parameters or persistent buffers, so one artifact serves any
    ``state_dict`` of the same architecture.  Derived non-persistent
    buffers (the Fourier position tables) ride along as constants.
  * ``batch_polymorphic=True`` puts a symbolic dimension on the leading
    axis of every example argument, so one artifact serves any batch (up to
    the range the model's ops allow).  The examples then need a batch of at
    least 2 (a batch of 1 would pin the dimension).  K1's launch plan
    reads the concrete batch at run time.
  * The examples' device takes the place of the JAX package's
    ``platforms``: exported from CUDA tensors, the graph holds K1's
    ``torch.library`` op (``ops.flash_attention.OP_NAME``) at every flash
    site; from CPU tensors, the dense path or, under ``attn_impl="flash"``,
    the op's CPU implementation (the plain version).  Loading needs the op
    registered: importing this module imports it.
  * The graph follows the module's mode at export: export a model in eval
    mode (the convnet's BatchNorm reads its running averages there).
"""

from __future__ import annotations

import io
import itertools
import json
from typing import Any, Callable, Mapping

import torch
from torch import nn

# Registers K1's op, which torch.export.load resolves by name.
from perceiverio_pytorch_tpu_torch.ops import flash_attention as _flash_attention  # noqa: F401

__all__ = ["export_apply", "load_exported"]

# The artifact's record of the state_dict entries its graph takes.
_NAMES = "state_dict_names.json"


def _shared_names(model: nn.Module) -> set:
    """Names of the parameters and buffers that reach the same attribute of
    the same module as a name before them (a module registered under two
    names, as the language model's embedding is)."""
    seen, shared = set(), set()
    for name, _ in itertools.chain(model.named_parameters(remove_duplicate=False),
                                   model.named_buffers(remove_duplicate=False)):
        prefix, _, attr = name.rpartition(".")
        key = (id(model.get_submodule(prefix)), attr)
        if key in seen:
            shared.add(name)
        seen.add(key)
    return shared


class _Apply(nn.Module):
    """``model`` called on a ``state_dict`` passed in, as a module whose own
    parameters are none: the model is held outside the module tree, so that
    export lifts none of its parameters into the artifact."""

    def __init__(self, model: nn.Module, static_kwargs: Mapping[str, Any]):
        super().__init__()
        object.__setattr__(self, "_model", model)
        self._static_kwargs = dict(static_kwargs)

    def forward(self, state_dict, *args):
        return torch.func.functional_call(self._model, state_dict, args, self._static_kwargs,
                                          tie_weights=False)


def export_apply(
    model: nn.Module,
    state_dict: Mapping[str, torch.Tensor],
    *example_args: torch.Tensor,
    batch_polymorphic: bool = False,
    **static_kwargs: Any,
) -> bytes:
    """Serialize ``model(*args, **static_kwargs)`` run on ``state_dict`` to
    bytes.

    Args:
      model: the module whose forward is exported (in eval mode to serve).
      state_dict: the weights (``model.state_dict()``, or the output of
        ``utils.params.cast_variables_for_inference``); they become the
        artifact's first argument.
      *example_args: example inputs fixing shapes, dtypes and the device.
      batch_polymorphic: export with a symbolic leading dimension on every
        example arg, so that the artifact accepts any batch.
      **static_kwargs: keyword arguments baked into the graph.
    """
    if batch_polymorphic and any(a.shape[0] < 2 for a in example_args):
        raise ValueError("batch_polymorphic export needs example batches of 2 or more")
    # A module's attribute is set once, under its first name: functional_call
    # would set a shared module's twice and restore the wrong one.
    shared = _shared_names(model)
    weights = {name: t.detach() for name, t in state_dict.items() if name not in shared}
    apply = _Apply(model, static_kwargs)
    # One forward builds the lazy tables (the Fourier features) before the
    # trace, which would otherwise branch on whether they exist.
    with torch.no_grad():
        apply(weights, *example_args)
    dynamic_shapes = None
    if batch_polymorphic:
        # DYNAMIC, not a named Dim: export takes the range the model's ops
        # allow (on the card a batch up to 65,535) instead of refusing it.
        dynamic_shapes = ({name: None for name in weights},
                          tuple({0: torch.export.Dim.DYNAMIC} for _ in example_args))
    exported = torch.export.export(apply, (weights, *example_args),
                                   dynamic_shapes=dynamic_shapes)
    exported.example_inputs = None  # they would carry the weights
    buf = io.BytesIO()
    torch.export.save(exported, buf, extra_files={_NAMES: json.dumps(list(weights))})
    return buf.getvalue()


def load_exported(blob: bytes) -> Callable[..., Any]:
    """Deserialize an ``export_apply`` artifact into ``fn(state_dict,
    *args)``; it needs no model code, only this package's ops.  The graph
    takes the entries it was exported with, as a plain dict, out of any
    mapping (``module.state_dict()`` is an OrderedDict, and holds a tied
    parameter under each of its names)."""
    names = {_NAMES: ""}
    module = torch.export.load(io.BytesIO(blob), extra_files=names).module()
    names = json.loads(names[_NAMES])
    return lambda state_dict, *args: module({n: state_dict[n] for n in names}, *args)
