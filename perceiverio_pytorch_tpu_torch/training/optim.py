"""Optimizer construction: learning-rate schedules, AdamW, global-norm clip.

Counterpart of ``perceiverio_pytorch_tpu/training/optim.py``, with optax's
semantics:

  * ``build_schedule`` returns ``step -> lr`` for the update counted from 0
    (so the first update of a warmup has lr 0, as in optax);
  * ``build_optimizer`` returns an ``Optimizer``: AdamW's settings, the
    schedule and the clip.  ``Optimizer.create(params)`` makes the
    ``torch.optim.AdamW``; ``Optimizer.update(opt, step)`` clips the
    gradients by their global norm (scaled by ``max_norm / norm`` only when
    the norm reaches ``max_norm``, as ``optax.clip_by_global_norm`` does, not
    ``clip_grad_norm_``'s ``+1e-6``), sets the step's learning rate and
    takes the step.

Only ``adamw`` is ported; ``adafactor``, ``lion``, ``sgd``, gradient
accumulation, skipping non-finite updates and trainable masks raise.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Iterable, List, Optional

import torch


def build_schedule(
    peak_lr: float,
    *,
    schedule: str = "constant",
    total_steps: Optional[int] = None,
    warmup_steps: int = 0,
    end_lr_ratio: float = 0.0,
) -> Callable[[int], float]:
    """``step -> lr``: "constant" | "cosine" | "linear" (decay to
    ``end_lr_ratio * peak_lr`` over ``total_steps - warmup_steps``), each
    after an optional linear warmup from 0 over ``warmup_steps``."""
    if schedule == "constant":
        def base(step):
            return peak_lr
    elif schedule in ("cosine", "linear"):
        if total_steps is None:
            raise ValueError(f"{schedule} schedule requires total_steps")
        decay_steps = max(total_steps - warmup_steps, 1)
        end_lr = peak_lr * end_lr_ratio
        if schedule == "cosine":  # optax.cosine_decay_schedule
            def base(step):
                frac = min(step, decay_steps) / decay_steps
                cosine = 0.5 * (1.0 + math.cos(math.pi * frac))
                return peak_lr * ((1.0 - end_lr_ratio) * cosine + end_lr_ratio)
        else:  # optax.linear_schedule
            def base(step):
                frac = 1.0 - min(step, decay_steps) / decay_steps
                return (peak_lr - end_lr) * frac + end_lr
    else:
        raise ValueError(
            f"schedule must be 'constant', 'cosine' or 'linear'; got {schedule!r}"
        )
    if warmup_steps <= 0:
        return base

    def joined(step):  # optax.join_schedules([warmup, base], [warmup_steps])
        if step < warmup_steps:
            return peak_lr * min(step, warmup_steps) / warmup_steps
        return base(step - warmup_steps)

    return joined


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in fp32 (optax.global_norm)."""
    squares = [t.detach().float().pow(2).sum() for t in tensors]
    if not squares:
        return torch.zeros(())
    return torch.stack(squares).sum().sqrt()


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """What ``build_optimizer`` returns: AdamW with a schedule and a clip."""

    schedule: Callable[[int], float]
    b1: float = 0.9
    b2: float = 0.999
    weight_decay: float = 0.0
    weight_decay_mask: Optional[str] = None
    clip_norm: Optional[float] = None

    def create(self, params: Iterable[torch.nn.Parameter]) -> torch.optim.AdamW:
        """``torch.optim.AdamW`` over the trainable ``params``.  With
        ``weight_decay_mask="non_1d"`` only tensors of two or more dims are
        decayed (biases and LayerNorm scales are not)."""
        params = [p for p in params if p.requires_grad]
        decay = [p for p in params
                 if self.weight_decay_mask is None or p.dim() >= 2]
        decay_ids = {id(p) for p in decay}
        rest = [p for p in params if id(p) not in decay_ids]
        groups = [{"params": decay, "weight_decay": self.weight_decay}]
        if rest:
            groups.append({"params": rest, "weight_decay": 0.0})
        return torch.optim.AdamW(groups, lr=self.schedule(0),
                                 betas=(self.b1, self.b2), eps=1e-8)  # optax's eps

    def update(self, opt: torch.optim.Optimizer, step: int) -> torch.Tensor:
        """Clip the gradients, set the learning rate of update ``step`` (from
        0) and step ``opt``; returns the global norm of the gradients as they
        were before the clip.  A parameter without a gradient counts as a
        zero gradient, as in optax."""
        params: List[torch.Tensor] = [p for g in opt.param_groups for p in g["params"]]
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in params]
        norm = global_norm(grads)
        if self.clip_norm is not None:
            # Decided on the device, so the step does not wait for the norm.
            keep = norm < self.clip_norm
            for g in grads:
                g.copy_(torch.where(keep, g, g / norm.to(g.dtype) * self.clip_norm))
        lr = self.schedule(step)
        for group in opt.param_groups:
            group["lr"] = lr
        opt.step()
        return norm


def build_optimizer(
    peak_lr: float,
    *,
    optimizer: str = "adamw",
    schedule: str = "constant",
    total_steps: Optional[int] = None,
    warmup_steps: int = 0,
    end_lr_ratio: float = 0.0,
    weight_decay: float = 0.0,
    weight_decay_mask: Optional[str] = None,
    b1: float = 0.9,
    b2: float = 0.999,
    clip_norm: Optional[float] = None,
    accum_steps: int = 1,
    skip_nonfinite_updates: int = 0,
    trainable_mask=None,
) -> Optimizer:
    """AdamW with a schedule and an optional global-norm clip.

    Args:
      weight_decay_mask: None decays every parameter; ``"non_1d"`` only
        those of two or more dims.
      optimizer, accum_steps, skip_nonfinite_updates, trainable_mask: only
        the defaults are ported; anything else raises NotImplementedError.
    """
    if optimizer != "adamw":
        if optimizer in ("adafactor", "lion", "sgd"):
            raise NotImplementedError(
                f"optimizer={optimizer!r} is not ported to PyTorch yet (see ROADMAP.md)")
        raise ValueError(
            "optimizer must be 'adamw', 'adafactor', 'lion' or 'sgd';"
            f" got {optimizer!r}"
        )
    for name, value, off in (("accum_steps", accum_steps, 1),
                             ("skip_nonfinite_updates", skip_nonfinite_updates, 0),
                             ("trainable_mask", trainable_mask, None)):
        if value != off:
            raise NotImplementedError(
                f"build_optimizer({name}={value!r}) is not ported to PyTorch yet"
                " (see ROADMAP.md)")
    if weight_decay_mask not in (None, "non_1d"):
        raise ValueError(
            f"weight_decay_mask must be None or 'non_1d'; got {weight_decay_mask!r}")
    return Optimizer(
        schedule=build_schedule(peak_lr, schedule=schedule, total_steps=total_steps,
                                warmup_steps=warmup_steps, end_lr_ratio=end_lr_ratio),
        b1=b1, b2=b2, weight_decay=weight_decay,
        weight_decay_mask=weight_decay_mask, clip_norm=clip_norm,
    )
