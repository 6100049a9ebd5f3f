"""Weights carried across from the JAX package to the port.

``state_dict_from_flax`` turns the JAX package's ``{"params",
"batch_stats"}`` variable tree (nested dicts of numpy arrays) into this
port's ``state_dict``.  It is a numpy-only copy of the path translation in
``perceiverio_pytorch_tpu/utils/torch_checkpoint.py`` (``_translate_path``
and ``export_state_dict``), so the port's modules carry the reference's
torch attribute names and the converted DeepMind checkpoints load with
``load_state_dict(strict=True)``:

  kernel (2-D)  -> weight = kernel.T                   (Linear [out, in])
  kernel (4-D)  -> weight = kernel.transpose(3,2,0,1)  (Conv [out, in, kh, kw])
  scale         -> weight                              (LayerNorm / BatchNorm)
  embedding     -> weight                              (Embedding)
  mean / var    -> running_mean / running_var          (batch_stats)

A BatchNorm's ``num_batches_tracked`` buffer, which flax has no counterpart
of, is written as 0 beside its running averages.  ``overrides`` place flax
parameters whose torch names the path translation does not give, and
``tied`` writes a torch name a second time (the language model's shared
token table: ``LANGUAGE_OVERRIDES``, ``LANGUAGE_TIED``).

Derived buffers (the flax "consts" collection, e.g. Fourier tables) have no
state_dict entry: the port keeps them as non-persistent buffers.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

# flax attribute segment -> torch attribute segment
_SIMPLE_SEGMENTS = {
    "encoder": "_encoder",
    "decoder": "_decoder",
    "multi_preprocessor": "_multi_preprocessor",
    "position_enc": "_position_encoding",
    "positional_encoding": "_positional_encoding",
    "projector": "_projector",
    "base_position_encoding": "_base_position_encoding",
    "conv_after_patch_layer": "_conv_after_patch_layer",
    "extra_pos_mlp": "_extra_pos_mlps",
    "embedding": "_embedding",
}

# flax container-field prefix -> torch ModuleDict attribute
_CONTAINER_PREFIXES = {
    "input_preprocessors": "_multi_preprocessor._preprocessors",
    "output_postprocessors": "_output_postprocessors",
    "output_queries": "_output_queries",
    "padding_embeddings": "padding_embeddings",
    "mask_tokens": "mask_tokens",
}

_INDEXED_RE = re.compile(r"^(convs|norms|linear)_(\d+)$")


def _translate_segment(seg: str) -> str:
    m = _INDEXED_RE.match(seg)
    if m:
        name, idx = m.groups()
        if name == "linear":
            return idx
        return f"{name}.{idx}"
    for prefix, torch_name in _CONTAINER_PREFIXES.items():
        if seg == prefix:
            return f"{torch_name}.__default"
        if seg.startswith(prefix + "_"):
            return f"{torch_name}.{seg[len(prefix) + 1:]}"
    return _SIMPLE_SEGMENTS.get(seg, seg)


def translate_path(path: Tuple[str, ...], collection: str) -> str:
    """flax ('perceiver', 'encoder', ..., 'kernel') -> torch dotted name."""
    *body, leaf = path
    segments = [_translate_segment(s) for s in body]
    if collection == "batch_stats":
        leaf_name = {"mean": "running_mean", "var": "running_var"}[leaf]
    else:
        leaf_name = {
            "kernel": "weight",
            "scale": "weight",
            "embedding": "weight",
        }.get(leaf, leaf)
    return ".".join(segments + [leaf_name])


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()):
    for key, value in tree.items():
        path = prefix + (str(key),)
        if isinstance(value, Mapping):
            yield from _flatten(value, path)
        else:
            yield path, value


def state_dict_from_flax(variables: Mapping, overrides: Optional[Mapping[str, str]] = None,
                         tied: Optional[Mapping[str, str]] = None
                         ) -> Dict[str, torch.Tensor]:
    """JAX variables (nested dicts of arrays) -> the port's fp32 state_dict.

    ``overrides`` maps a flax path ("a/b/kernel") to its torch name; ``tied``
    maps an extra torch name to the torch name whose value it repeats.
    """
    overrides = dict(overrides or {})
    out: Dict[str, torch.Tensor] = {}
    for collection in ("params", "batch_stats"):
        for path, value in _flatten(variables.get(collection, {})):
            value = np.array(value, dtype=np.float32)  # a writable copy
            if path[-1] == "kernel":
                if value.ndim == 2:
                    value = value.T
                elif value.ndim == 4:
                    value = value.transpose(3, 2, 0, 1)
                else:
                    raise ValueError(
                        f"unexpected kernel rank {value.ndim} at {path}"
                    )
            name = overrides.get("/".join(path)) or translate_path(path, collection)
            out[name] = torch.from_numpy(np.ascontiguousarray(value))
            if collection == "batch_stats" and path[-1] == "mean":
                out[name[: -len("running_mean")] + "num_batches_tracked"] = torch.tensor(0)
    for alias, source in (tied or {}).items():
        out[alias] = out[source].clone()
    return out


# The language model's token table lives at the task model's top level in
# flax (one module shared by the preprocessor and the tied decode); the
# reference's state_dict holds it under the preprocessor and again under the
# postprocessor.
LANGUAGE_OVERRIDES = {
    "embed/embedding": "perceiver._multi_preprocessor._preprocessors.__default.embed.weight",
}
LANGUAGE_TIED = {
    "perceiver._output_postprocessors.__default._embedding.weight": (
        "perceiver._multi_preprocessor._preprocessors.__default.embed.weight"
    ),
}
