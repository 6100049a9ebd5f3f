"""LoRA: low-rank adapters for parameter-efficient fine-tuning.

Counterpart of ``perceiverio_pytorch_tpu/training/lora.py``.  A rank-r
delta ``(alpha / r) * a @ b`` is trained on each attention and MLP
projection of a frozen model; nothing else trains, so the optimizer state
is adapter-sized.

The adapters are a module of their own (``LoRA``): one ``a`` [in, rank] and
one ``b`` [rank, out] per adapted weight, in the flax kernel's layout, at
``<weight name>.a`` and ``<weight name>.b``.  That module is what the
``TrainState`` holds, so the Trainer, AdamW, the EMA and the checkpoints
treat it as any model.  ``wrap_loss`` runs the frozen base model through
``torch.func.functional_call`` with each adapted weight replaced by
``W + scale * (a @ b)^T`` (torch's [out, in] layout), so gradients reach the
adapters only; the base model's parameters are set ``requires_grad=False``
and never reach the optimizer.  ``merge_lora`` gives the merged
``state_dict``, which loads into the base model with ``strict=True``.

Typical flow::

    model = LanguagePerceiver(policy=PERFORMANCE)       # frozen, pretrained
    adapters = init_lora(model.state_dict(), rank=8)
    trainer = Trainer(wrap_loss(loss_fn, model), build_optimizer(1e-4))
    state = trainer.fit(trainer.init_state(adapters), batches, num_steps=...)
    model.load_state_dict(merge_lora(model.state_dict(), state.model))

A JAX adapter tree carries over with ``utils.weights.lora_state_dict_from_flax``.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Mapping, Optional, Sequence, Tuple

import torch
from torch import nn

from perceiverio_pytorch_tpu_torch.utils.weights import _translate_segment

__all__ = ["DEFAULT_TARGETS", "LoRA", "default_match", "init_lora", "lora_paths",
           "merge_lora", "wrap_loss"]

# The modules whose 2-D weight gets an adapter by default, by their flax
# names (the attention projections and the MLP): the same names in the
# port's modules, as the weight translation maps them.
DEFAULT_TARGETS = ("proj_q", "proj_k", "proj_v", "final", "fc1", "fc2")


def _selects(names: Tuple[str, ...], tensor, targets: Sequence[str]) -> bool:
    allowed = {_translate_segment(t) for t in targets}
    return (len(names) >= 2 and names[-1] == "weight" and names[-2] in allowed
            and getattr(tensor, "ndim", 0) == 2)


def default_match(names: Tuple[str, ...], tensor) -> bool:
    """True for the 2-D ``weight`` of a module named in ``DEFAULT_TARGETS``
    (``names``: the parameter's dotted name, split)."""
    return _selects(names, tensor, DEFAULT_TARGETS)


class _Adapter(nn.Module):
    def __init__(self, a: torch.Tensor, b: torch.Tensor):
        super().__init__()
        self.a = nn.Parameter(a)
        self.b = nn.Parameter(b)


class LoRA(nn.Module):
    """The adapters: for each adapted weight ``name`` (``paths``, sorted),
    parameters ``name.a`` [in, rank] and ``name.b`` [rank, out], held in a
    module tree that mirrors the base model's names."""

    def __init__(self, adapters: Mapping[str, Tuple[torch.Tensor, torch.Tensor]]):
        super().__init__()
        self.paths = sorted(adapters)
        for path in self.paths:
            node = self
            *parents, leaf = path.split(".")
            for seg in parents:
                if seg not in node._modules:
                    node.add_module(seg, nn.Module())
                node = node._modules[seg]
            node.add_module(leaf, _Adapter(*adapters[path]))

    def adapter(self, path: str) -> Tuple[torch.Tensor, torch.Tensor]:
        """(a, b) of the weight ``path``."""
        module = self.get_submodule(path)
        return module.a, module.b


def init_lora(params: Mapping[str, torch.Tensor], rank: int, *,
              targets: Optional[Sequence[str]] = None,
              match: Optional[Callable[[Tuple[str, ...], torch.Tensor], bool]] = None,
              dtype: Optional[torch.dtype] = None,
              generator: Optional[torch.Generator] = None) -> LoRA:
    """The adapters of ``params`` (a ``state_dict`` or ``named_parameters``).

    Every selected weight [out, in] gets ``a`` [in, rank], lecun-normal from
    ``generator`` (seed 0 when none is given), and ``b`` [rank, out] of
    zeros, so that the merged model is the base model exactly at step 0.
    Each is on its weight's device, in ``dtype`` (default: the weight's).

    Args:
      targets: module names to adapt (default ``DEFAULT_TARGETS``).
      match: ``match(name.split("."), tensor) -> bool``; wins over
        ``targets``.
    """
    if rank < 1:
        raise ValueError(f"rank must be >= 1, got {rank}")
    if match is None:
        allowed = tuple(targets) if targets is not None else DEFAULT_TARGETS

        def match(names, tensor):
            return _selects(names, tensor, allowed)

    selected = [(n, w) for n, w in params.items() if match(tuple(n.split(".")), w)]
    if not selected:
        raise ValueError(
            "init_lora matched no kernels; check targets/match against the parameter"
            " names (expected 2-D 'weight' entries of modules named"
            f" {list(targets) if targets is not None else list(DEFAULT_TARGETS)})")
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    adapters = {}
    for name, weight in selected:
        d_out, d_in = weight.shape
        adtype = dtype if dtype is not None else weight.dtype
        a = torch.randn((d_in, rank), generator=generator) / math.sqrt(d_in)
        adapters[name] = (a.to(device=weight.device, dtype=adtype),
                          torch.zeros((rank, d_out), dtype=adtype, device=weight.device))
    return LoRA(adapters)


def lora_paths(lora: LoRA) -> list:
    """The names of the weights that carry an adapter, sorted."""
    return list(lora.paths)


def _deltas(params: Mapping[str, torch.Tensor], lora: LoRA,
            alpha: Optional[float]) -> Dict[str, torch.Tensor]:
    """``W + scale * (a @ b)^T`` for every adapted weight: the product in
    fp32, cast to the weight's dtype, then added (JAX ``merge_lora``)."""
    missing = [p for p in lora.paths if p not in params]
    if missing:
        raise ValueError(f"adapter paths absent from params: {missing}")
    out = {}
    for path in lora.paths:
        a, b = lora.adapter(path)
        rank = a.shape[1]
        scale = (alpha if alpha is not None else float(rank)) / float(rank)
        weight = params[path]
        delta = (a.float() @ b.float()) * scale
        out[path] = weight + delta.t().to(weight.dtype)
    return out


def merge_lora(params: Mapping[str, torch.Tensor], lora: LoRA, *,
               alpha: Optional[float] = None) -> Dict[str, torch.Tensor]:
    """``params`` (a ``state_dict``) with ``W += (alpha / rank) * (a @ b)^T``
    at every adapted weight; the rest as they are.  ``alpha`` defaults to
    the rank (unit scale), so a fresh adapter (``b == 0``) merges to the
    base weights bit for bit.  The result loads into the base model with
    ``strict=True``."""
    with torch.no_grad():
        merged = dict(params)
        merged.update(_deltas(params, lora, alpha))
    return merged


class _Merged:
    """The frozen base model called with the adapters merged into its
    weights; it follows the adapters' train/eval mode."""

    def __init__(self, base_model: nn.Module, lora: LoRA, alpha: Optional[float]):
        self._base, self._lora, self._alpha = base_model, lora, alpha

    def __call__(self, *args, **kwargs):
        self._base.train(self._lora.training)
        weights = _deltas(dict(self._base.named_parameters()), self._lora, self._alpha)
        return torch.func.functional_call(self._base, weights, args, kwargs)


def wrap_loss(loss_fn: Callable[..., torch.Tensor], base_model: nn.Module, *,
              alpha: Optional[float] = None) -> Callable[..., torch.Tensor]:
    """Lift ``loss_fn(model, *batch)`` to ``loss(lora, *batch)``: the base
    model, its parameters frozen (``requires_grad_(False)``), runs with the
    adapters merged into its weights, so gradients reach the adapters only.
    Pass it to the Trainer (as ``loss_fn`` and ``eval_fn``) with the
    ``LoRA`` module as the model."""
    base_model.requires_grad_(False)

    def lifted(lora, *batch):
        return loss_fn(_Merged(base_model, lora, alpha), *batch)

    return lifted
