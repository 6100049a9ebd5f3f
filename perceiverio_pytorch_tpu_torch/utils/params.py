"""Parameter utilities.

Counterpart of ``perceiverio_pytorch_tpu/utils/params.py``.  The JAX
package casts the ``params`` collection of a variables pytree and keeps
every other collection (``batch_stats``, ``quant_stats``) as it is; here the
parameters are a module's ``nn.Parameter``s, and BatchNorm's running
statistics and ``num_batches_tracked`` and a static int8 projection's
``amax`` are buffers.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Union

import torch
from torch import nn
from torch.utils import _pytree as pytree

# state_dict entries that are statistics, not parameters: BatchNorm's and a
# static int8 projection's calibrated max|x| (core.attention.Dense).
_STATISTICS = ("running_mean", "running_var", "num_batches_tracked", "amax")


def cast_floating(tree: Any, dtype: torch.dtype = torch.bfloat16) -> Any:
    """Cast the floating-point tensors of a pytree (dicts, lists, tuples)
    to ``dtype``; other leaves pass through.

    For inference, weights stored in bf16 halve the bytes read per request;
    ``Dense`` under a bf16 compute dtype consumes them without a cast, and
    the fp32 LayerNorms upcast their (small) scale and bias.
    """

    def cast(x):
        if isinstance(x, torch.Tensor) and x.is_floating_point():
            return x.detach().to(dtype)
        return x

    return pytree.tree_map(cast, tree)


def cast_variables_for_inference(
    variables: Union[nn.Module, Mapping[str, torch.Tensor]],
    dtype: torch.dtype = torch.bfloat16,
) -> Dict[str, torch.Tensor]:
    """A state_dict whose parameters are cast to ``dtype``, the statistics
    kept as they are (fp32: BatchNorm's, for a stable normalisation, and
    the int8 projections' ``amax``, which sets their activation scale).

    ``variables`` is a module (its parameters are cast; its buffers are
    not) or a state_dict (every floating entry but BatchNorm's
    ``running_mean`` and ``running_var`` and the ``amax`` entries is cast).  The module itself is
    left unchanged.  Entries that share one tensor (a tied embedding)
    share one cast tensor.
    """
    if isinstance(variables, nn.Module):
        params = {name for name, _ in variables.named_parameters(remove_duplicate=False)}
        state = variables.state_dict()
    else:
        state = dict(variables)
        params = {name for name in state if name.rsplit(".", 1)[-1] not in _STATISTICS}
    cast: Dict[tuple, torch.Tensor] = {}
    out = {}
    for name, t in state.items():
        if name not in params:
            out[name] = t.detach()
            continue
        key = (t.device, t.dtype, t.data_ptr(), tuple(t.shape), t.stride())
        if key not in cast:
            cast[key] = cast_floating(t, dtype)
        out[name] = cast[key]
    return out
