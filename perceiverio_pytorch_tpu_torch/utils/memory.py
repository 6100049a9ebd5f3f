"""Device memory sizing of a call, measured on the card.

Counterpart of ``perceiverio_pytorch_tpu/utils/memory.py``, with its names
and dict keys.  The JAX package asks the compiler for a program's buffer
assignment without running it; eager PyTorch compiles no program, so here
the function runs once on the card and the numbers are read from the
caching allocator around that call: they are measured, not compiled.  The
call's arguments, and the parameters and buffers of ``fn`` or of any
argument that is an ``nn.Module``, count as its arguments.
"""

from __future__ import annotations

import re
from typing import Any, Callable, Dict, Iterable

import torch
from torch import nn

__all__ = ["compiled_memory_stats", "hbm_headroom"]

_UNITS = {"B": 1, "KiB": 1024, "MiB": 1024**2, "GiB": 1024**3, "TiB": 1024**4}


def _tensors(tree) -> Iterable[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, nn.Module):
        yield from tree.parameters()
        yield from tree.buffers()
    elif isinstance(tree, dict):
        for value in tree.values():
            yield from _tensors(value)
    elif isinstance(tree, (list, tuple)):
        for value in tree:
            yield from _tensors(value)


def _bytes(tensors: Iterable[torch.Tensor]) -> int:
    """Bytes of the distinct storages the tensors live in."""
    seen = {}
    for t in tensors:
        storage = t.untyped_storage()
        seen[storage.data_ptr()] = storage.nbytes()
    return sum(seen.values())


def _device(fn, example_args, kwargs) -> torch.device:
    """The one CUDA device of the call's tensors; raises otherwise."""
    devices = {t.device for t in _tensors([fn, list(example_args), kwargs])}
    if not devices or any(d.type != "cuda" for d in devices) or len(devices) > 1:
        # "No measurement" must not read as "uses 0 bytes": hbm_headroom
        # would turn it into a confident fits=True.
        raise RuntimeError(
            "compiled_memory_stats measures a call on one CUDA device; the call's tensors"
            f" are on {sorted(str(d) for d in devices) or 'no device'}")
    return devices.pop()


def compiled_memory_stats(fn: Callable[..., Any], *example_args, **kwargs) -> Dict[str, int]:
    """Run ``fn(*example_args, **kwargs)`` once on the card and return its
    device memory budget, read from the caching allocator.

    Returns a dict with ``argument_bytes`` (the distinct storages of the
    arguments and of ``fn``'s parameters and buffers when it is a module),
    ``output_bytes`` (the storages of the tensors it returns), ``temp_bytes``
    (the rest of the call's high-water mark above what was allocated before
    it: activations and workspace), ``code_bytes`` (0: no program is
    compiled) and ``peak_bytes`` (the arguments plus the call's high-water
    mark: compare against the card's memory).  Raises ``RuntimeError`` when
    a tensor of the call is not on one CUDA device.
    """
    device = _device(fn, example_args, kwargs)
    argument_bytes = _bytes(_tensors([fn, list(example_args), kwargs]))
    torch.cuda.synchronize(device)
    before = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    out = fn(*example_args, **kwargs)
    torch.cuda.synchronize(device)
    high = max(torch.cuda.max_memory_allocated(device) - before, 0)
    output_bytes = _bytes(t for t in _tensors(out) if t.device.type == "cuda")
    return {
        "argument_bytes": int(argument_bytes),
        "output_bytes": int(output_bytes),
        "temp_bytes": int(max(high - output_bytes, 0)),
        "code_bytes": 0,
        "peak_bytes": int(argument_bytes + high),
    }


def hbm_headroom(fn: Callable[..., Any], *example_args, hbm_bytes=None,
                 **kwargs) -> Dict[str, Any]:
    """``compiled_memory_stats`` plus a fit verdict against the card's memory.

    ``hbm_bytes`` defaults to the device's ``total_memory``.  Returns the
    stats extended with ``hbm_bytes``, ``fits`` and ``headroom_bytes``
    (negative: over by that much).  A ``torch.cuda.OutOfMemoryError`` during
    the call is the verdict ``fits=False``, as the JAX package turns the
    compiler's out-of-memory error into one: its ``peak_bytes`` is the
    arguments plus the high-water mark before the failure plus the request
    that failed, and the allocator's cache is emptied so that the card stays
    usable.  The allocator also reserves memory it does not hand out, so
    treat a headroom under about 5% of the memory as "does not fit".
    """
    device = _device(fn, example_args, kwargs)
    if hbm_bytes is None:
        hbm_bytes = torch.cuda.get_device_properties(device).total_memory
    oom = False
    try:
        stats = compiled_memory_stats(fn, *example_args, **kwargs)
    except torch.cuda.OutOfMemoryError as exc:
        oom = True
        before_peak = torch.cuda.max_memory_allocated(device)
        match = re.search(r"Tried to allocate ([0-9.]+) (B|KiB|MiB|GiB|TiB)", str(exc))
        if match is None:
            raise
        requested = float(match.group(1)) * _UNITS[match.group(2)]
        argument_bytes = _bytes(_tensors([fn, list(example_args), kwargs]))
        del exc
        torch.cuda.empty_cache()
        high = max(before_peak - torch.cuda.memory_allocated(device), 0)
        stats = {"argument_bytes": int(argument_bytes), "output_bytes": 0, "temp_bytes": 0,
                 "code_bytes": 0, "peak_bytes": int(argument_bytes + high + requested)}
    stats["hbm_bytes"] = int(hbm_bytes)
    stats["headroom_bytes"] = int(hbm_bytes) - stats["peak_bytes"]
    stats["fits"] = not oom and stats["headroom_bytes"] > 0
    return stats
