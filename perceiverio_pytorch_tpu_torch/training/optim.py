"""Optimizer construction: learning-rate schedules and optax's chain.

Counterpart of ``perceiverio_pytorch_tpu/training/optim.py``, with optax's
semantics:

  * ``build_schedule`` returns ``step -> lr`` for the update counted from 0
    (so the first update of a warmup has lr 0, as in optax);
  * ``build_optimizer`` returns an ``Optimizer``, the settings of the chain
    the JAX package builds, outermost last::

        clip -> core -> trainable mask -> accumulation -> skip if not finite

    ``clip`` is ``optax.clip_by_global_norm`` (scaled by ``max_norm / norm``
    only when the norm reaches ``max_norm``, not ``clip_grad_norm_``'s
    ``+1e-6``); ``core`` is optax's ``adamw``, ``adafactor``, ``lion`` or
    ``sgd``; the trainable mask is ``optax.multi_transform`` with
    ``set_to_zero`` (frozen parameters get no update and no state, and stay
    out of the clip's norm); accumulation is ``optax.MultiSteps`` (a running
    mean of the gradients; the inner chain runs on it once every
    ``accum_steps`` calls); the skip is ``optax.apply_if_finite``.
  * ``Optimizer.create(module)`` makes the ``OptaxChain``, a
    ``torch.optim.Optimizer`` whose ``step()`` takes the chain's update from
    the parameters' ``.grad``, as ``_foreach`` launches over the parameter
    list.  It owns its counts, as optax's state does: the inner count that
    the schedule reads, the accumulation window and the non-finite
    counters are in its ``state_dict``, so a train-state checkpoint carries
    them.

The decision to skip a non-finite update is taken on the host: one read of
a flag from the device per step, only when ``skip_nonfinite_updates`` is
set.

On a mesh (``training.trainer.create_sharded_train_state``) the chain's
``shards`` is the model's ``parallel.sharding.ShardLayout`` and its
parameters are this rank's pieces.  The updates of AdamW, Lion, SGD, the
accumulation and the weight decay are elementwise, so they run on the
pieces as they are; what reads a whole tensor reads it over all shards:
the global norms of the clip and of the metrics (each tensor's sum of
squares all-reduced over the axes it is split on), the non-finite flag
(all ranks agree), and Adafactor, which gathers a split parameter and its
gradient to compute its factored moments (kept whole, replicated, as the
JAX package's opt_state_shardings leaves them) and its block RMS exactly as
unsharded, then keeps its own piece of the update.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Iterable, List, Mapping, Optional, Union

import numpy as np
import torch
from torch import nn

OPTIMIZERS = ("adamw", "adafactor", "lion", "sgd")
_ADAM_EPS = 1e-8  # optax.adamw's eps
_ADAFACTOR_EPS = 1e-30  # optax.adafactor's
_ADAFACTOR_MIN_DIM = 128  # optax.adafactor's min_dim_size_to_factor
_ADAFACTOR_DECAY = 0.8
_ADAFACTOR_MIN_SCALE = 1e-3  # scale_by_param_block_rms


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


def non_1d_weight_decay_mask(module: nn.Module) -> Dict[str, bool]:
    """The decay mask that decays only parameters of two or more dims (weight
    matrices and conv kernels; not biases or LayerNorm scales), by parameter
    name.  ``build_optimizer(weight_decay_mask="non_1d")`` uses it."""
    return {name: p.dim() >= 2 for name, p in module.named_parameters()}


def _adafactor_dims(shape) -> Optional[tuple]:
    """optax's ``_factored_dims``: the two largest dims ``(d1, d0)`` (``d0``
    the largest, ties broken as numpy's argsort breaks them), or None when
    the second largest is below 128 or the tensor has fewer than two dims."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < _ADAFACTOR_MIN_DIM:
        return None
    return int(order[-2]), int(order[-1])


def _mask_of(mask, module: Optional[nn.Module], names: List[Optional[str]], what: str):
    """Per-parameter booleans from None (all True), a callable of the module
    or a mapping by parameter name."""
    if mask is None:
        return [True] * len(names)
    if callable(mask):
        if module is None:
            raise ValueError(f"a callable {what} is called with the module: pass the"
                             " module to create()")
        mask = mask(module)
    if not isinstance(mask, Mapping):
        raise ValueError(f"{what} must be a mapping of parameter name to bool, or a"
                         f" callable of the module returning one; got {type(mask).__name__}")
    if any(n is None for n in names):
        raise ValueError(f"a mapping {what} needs the parameters' names: pass the module"
                         " or its named_parameters() to create()")
    missing = [n for n in names if n not in mask]
    if missing:
        raise ValueError(f"{what} has no entry for {missing[:5]}")
    return [bool(mask[n]) for n in names]


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """What ``build_optimizer`` returns: the chain's settings, its schedule
    and ``create`` / ``update`` / ``logged_lr``."""

    schedule: Callable[[int], float]
    optimizer: str = "adamw"
    b1: float = 0.9
    b2: float = 0.999
    momentum: Optional[float] = 0.9
    weight_decay: float = 0.0
    weight_decay_mask: Union[str, Callable, Mapping, None] = None
    clip_norm: Optional[float] = None
    accum_steps: int = 1
    skip_nonfinite_updates: int = 0
    trainable_mask: Union[Callable, Mapping, None] = None

    def create(self, params: Union[nn.Module, Iterable]) -> "OptaxChain":
        """The ``OptaxChain`` over ``params``: a module, its
        ``named_parameters()`` or bare parameters (then without a callable or
        mapping mask).  Only parameters with ``requires_grad`` are taken; a
        parameter listed twice (a tied table) once."""
        module = params if isinstance(params, nn.Module) else None
        named = params.named_parameters() if module is not None else params
        names, tensors, seen = [], [], set()
        for item in named:
            name, p = item if isinstance(item, tuple) else (None, item)
            if p.requires_grad and id(p) not in seen:
                seen.add(id(p))
                names.append(name)
                tensors.append(p)
        wd_mask = self.weight_decay_mask
        if wd_mask == "non_1d":
            decay = [p.dim() >= 2 for p in tensors]
        else:
            decay = _mask_of(wd_mask, module, names, "weight_decay_mask")
        train = _mask_of(self.trainable_mask, module, names, "trainable_mask")
        return OptaxChain(self, tensors, decay, train)

    def update(self, opt: "OptaxChain") -> torch.Tensor:
        """One call of the chain on the parameters' gradients (``opt.step()``);
        returns the global norm of the gradients as they came in.  The
        learning rate is ``schedule`` of the chain's own count."""
        return opt.step()

    def logged_lr(self, opt: "OptaxChain") -> float:
        """The learning rate to log after a call: that of the last update
        applied, or, inside an accumulation window, the one the window's
        update takes (for ``accum_steps = k`` and no skip,
        ``schedule((step - 1) // k)``, JAX's ``lambda s: sched(s // k)``
        read at ``step - 1``)."""
        count = opt.chain["count"]
        return self.schedule(count if opt.chain["mini_step"] else max(count - 1, 0))


class OptaxChain(torch.optim.Optimizer):
    """The chain of ``build_optimizer`` as a ``torch.optim.Optimizer``.

    Parameter groups: ``trainable`` and, among those, ``decay`` (whether the
    weight decay applies); ``lr`` is the rate of the last update applied.
    Per-parameter state (trainable parameters only): AdamW ``mu``, ``nu``;
    Adafactor ``v_row``, ``v_col`` (factored) or ``v``; Lion ``mu``; SGD
    ``trace``; with accumulation ``acc``.  ``chain`` holds the counts:
    ``count`` (inner updates applied, which the schedule and the bias
    corrections read), ``mini_step`` (the accumulation window's position),
    ``notfinite_count``, ``last_finite`` and ``total_notfinite``.
    """

    def __init__(self, spec: Optimizer, params: List[torch.Tensor], decay: List[bool],
                 train: List[bool]):
        groups = []
        for trainable, decayed in ((True, True), (True, False), (False, False)):
            members = [p for p, t, d in zip(params, train, decay)
                       if t == trainable and (d == decayed or not trainable)]
            if members:
                groups.append({"params": members, "trainable": trainable,
                               "decay": decayed and trainable})
        if not groups:
            groups = [{"params": [], "trainable": True, "decay": True}]
        super().__init__(groups, {"lr": spec.schedule(0)})
        self.spec = spec
        self.shards = None  # a ShardLayout on a mesh (see the module docstring)
        self.chain = {"count": 0, "mini_step": 0, "notfinite_count": 0,
                      "last_finite": True, "total_notfinite": 0}

    def state_dict(self):
        sd = super().state_dict()
        sd["chain"] = dict(self.chain)
        return sd

    def load_state_dict(self, state_dict):
        if "chain" not in state_dict:
            raise ValueError("the optimizer state has no chain counts: it was not saved by"
                             " an OptaxChain (a torch.optim.AdamW's, say)")
        super().load_state_dict(state_dict)
        self.chain = dict(state_dict["chain"])

    def global_norm(self, params: List[torch.Tensor], tensors) -> torch.Tensor:
        """``global_norm`` of ``tensors`` (placed as ``params``), over every
        shard on a mesh."""
        if self.shards is None:
            return global_norm(tensors)
        return self.shards.global_norm(params, tensors)

    def _params(self, trainable: Optional[bool] = None) -> List[torch.Tensor]:
        return [p for g in self.param_groups
                if trainable is None or g["trainable"] == trainable for p in g["params"]]

    @torch.no_grad()
    def step(self, closure=None) -> torch.Tensor:
        """One call of the chain; returns the global norm of the incoming
        gradients (a parameter without one counts as a zero gradient)."""
        if closure is not None:
            raise ValueError("OptaxChain.step takes no closure")
        spec, chain = self.spec, self.chain
        every = self._params()
        for p in every:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        norm = self.global_norm(every, [p.grad for p in every])
        if spec.skip_nonfinite_updates > 0:  # optax.apply_if_finite, outermost
            finite = self.grads_finite()
            chain["notfinite_count"] = 0 if finite else chain["notfinite_count"] + 1
            chain["last_finite"] = finite
            chain["total_notfinite"] += 0 if finite else 1
            if not finite and chain["notfinite_count"] <= spec.skip_nonfinite_updates:
                return norm
        params = self._params(trainable=True)
        grads = [p.grad for p in params]
        if spec.accum_steps > 1:  # optax.MultiSteps: a running mean
            acc = [self._state(p, "acc", lambda p: torch.zeros_like(p)) for p in params]
            diff = torch._foreach_sub(grads, acc)
            torch._foreach_div_(diff, chain["mini_step"] + 1)
            torch._foreach_add_(acc, diff)
            chain["mini_step"] = (chain["mini_step"] + 1) % spec.accum_steps
            if chain["mini_step"]:
                return norm  # inside the window: no update
            grads = acc
        self._inner(params, grads)
        if spec.accum_steps > 1:
            torch._foreach_zero_(grads)
        return norm

    def grads_finite(self) -> bool:
        """Whether every gradient is finite: the largest |g| of each, read
        on the host (NaN propagates through the max; an empty gradient, which
        has no max, is skipped)."""
        grads = [p.grad for p in self._params() if p.grad is not None and p.grad.numel()]
        finite = not grads or bool(
            torch.isfinite(torch.stack(torch._foreach_norm(grads, math.inf))).all())
        if self.shards is not None:
            finite = self.shards.all_finite(finite, self._params()[0].device)
        return finite

    def _state(self, p, key, make):
        state = self.state[p]
        if key not in state:
            state[key] = make(p)
        return state[key]

    def _inner(self, params: List[torch.Tensor], grads: List[torch.Tensor]) -> None:
        """clip -> core on the trainable parameters, then the update applied."""
        spec, chain = self.spec, self.chain
        if not params:
            chain["count"] += 1
            return
        if spec.clip_norm is not None:
            # In place, decided on the device: the step does not wait for the norm.
            clip_norm = self.global_norm(params, grads)
            keep = clip_norm < spec.clip_norm
            for g in grads:
                g.copy_(torch.where(keep, g, g / clip_norm.to(g.dtype) * spec.clip_norm))
        lr = spec.schedule(chain["count"])
        decay = {id(p) for g in self.param_groups if g["decay"] for p in g["params"]}
        decayed = [i for i, p in enumerate(params) if id(p) in decay]
        getattr(self, f"_{spec.optimizer}")(params, grads, lr, decayed)
        chain["count"] += 1
        for group in self.param_groups:
            group["lr"] = lr

    def _decayed_update(self, params, updates, decayed, rate, lr):
        """``p -= lr * (u + rate * p)`` with the decay on the ``decayed``
        indices only (optax.add_decayed_weights, then the learning rate);
        ``updates`` are changed in place only where the decay applies."""
        if rate and decayed:
            torch._foreach_add_([updates[i] for i in decayed],
                                torch._foreach_mul([params[i] for i in decayed], rate))
        torch._foreach_add_(params, torch._foreach_mul(updates, -lr))

    def _adamw(self, params, grads, lr, decayed):
        spec = self.spec
        mu = [self._state(p, "mu", torch.zeros_like) for p in params]
        nu = [self._state(p, "nu", torch.zeros_like) for p in params]
        torch._foreach_mul_(mu, spec.b1)
        torch._foreach_add_(mu, torch._foreach_mul(grads, 1.0 - spec.b1))
        torch._foreach_mul_(nu, spec.b2)
        torch._foreach_add_(nu, torch._foreach_mul(torch._foreach_mul(grads, grads),
                                                   1.0 - spec.b2))
        t = self.chain["count"] + 1
        c1 = float(np.float32(1.0) - np.float32(spec.b1) ** np.float32(t))
        c2 = float(np.float32(1.0) - np.float32(spec.b2) ** np.float32(t))
        denom = torch._foreach_sqrt(torch._foreach_div(nu, c2))
        torch._foreach_add_(denom, _ADAM_EPS)
        updates = torch._foreach_div(torch._foreach_div(mu, c1), denom)
        self._decayed_update(params, updates, decayed, spec.weight_decay, lr)

    def _lion(self, params, grads, lr, decayed):
        spec = self.spec
        mu = [self._state(p, "mu", torch.zeros_like) for p in params]
        updates = torch._foreach_mul(grads, 1.0 - spec.b1)
        torch._foreach_add_(updates, torch._foreach_mul(mu, spec.b1))
        torch._foreach_sign_(updates)
        torch._foreach_mul_(mu, spec.b2)
        torch._foreach_add_(mu, torch._foreach_mul(grads, 1.0 - spec.b2))
        self._decayed_update(params, updates, decayed, spec.weight_decay, lr)

    def _sgd(self, params, grads, lr, decayed):
        del decayed  # optax.sgd has no weight decay
        updates = grads
        if self.spec.momentum is not None:  # optax.trace: t = g + momentum * t
            updates = [self._state(p, "trace", torch.zeros_like) for p in params]
            torch._foreach_mul_(updates, self.spec.momentum)
            torch._foreach_add_(updates, grads)
        self._decayed_update(params, updates, [], 0.0, lr)

    def _adafactor(self, params, grads, lr, decayed):
        """optax.adafactor: factored second moments, block-RMS clip at 1,
        the learning rate, the parameter-block scale, then the weight decay
        (not multiplied by the learning rate)."""
        t = np.float32(self.chain["count"] + 1)
        rate = float(np.float32(1.0) - t ** np.float32(-_ADAFACTOR_DECAY))
        updates = []
        for p, g in zip(params, grads):
            shards = self.shards if self.shards is not None and self.shards.axes(p) else None
            piece = p
            if shards is not None:  # the whole tensors, computed as unsharded
                p, g = shards.gather(piece, p), shards.gather(piece, g)
            sq = g * g + _ADAFACTOR_EPS
            dims = _adafactor_dims(tuple(p.shape))
            if dims is not None:
                d1, d0 = dims
                v_row = self._state(piece, "v_row", lambda _: p.new_zeros(
                    [s for i, s in enumerate(p.shape) if i != d0]))
                v_col = self._state(piece, "v_col", lambda _: p.new_zeros(
                    [s for i, s in enumerate(p.shape) if i != d1]))
                v_row.mul_(rate).add_(sq.mean(dim=d0) * (1.0 - rate))
                v_col.mul_(rate).add_(sq.mean(dim=d1) * (1.0 - rate))
                reduced_d1 = d1 - 1 if d1 > d0 else d1
                row_factor = (v_row / v_row.mean(dim=reduced_d1, keepdim=True)).rsqrt()
                u = g * row_factor.unsqueeze(d0) * v_col.rsqrt().unsqueeze(d1)
            else:
                v = v_piece = self._state(piece, "v", torch.zeros_like)
                if shards is not None:
                    v = shards.gather(piece, v_piece)
                v.mul_(rate).add_(sq * (1.0 - rate))
                if shards is not None:
                    v_piece.copy_(shards.local(piece, v))
                u = g * v.rsqrt()
            u = u / torch.clamp(u.square().mean().sqrt(), min=1.0)  # clip_by_block_rms(1)
            u = u * lr
            u = u * torch.clamp(p.square().mean().sqrt(), min=_ADAFACTOR_MIN_SCALE)
            updates.append(u if shards is None else shards.local(piece, u))
        if self.spec.weight_decay and decayed:
            torch._foreach_add_([updates[i] for i in decayed],
                                torch._foreach_mul([params[i] for i in decayed],
                                                   self.spec.weight_decay))
        torch._foreach_sub_(params, updates)


def build_optimizer(
    peak_lr: float,
    *,
    optimizer: str = "adamw",
    schedule: str = "constant",
    total_steps: Optional[int] = None,
    warmup_steps: int = 0,
    end_lr_ratio: float = 0.0,
    weight_decay: float = 0.0,
    weight_decay_mask: Union[str, Callable, Mapping, None] = None,
    b1: float = 0.9,
    b2: float = 0.999,
    momentum: Optional[float] = 0.9,
    clip_norm: Optional[float] = None,
    accum_steps: int = 1,
    skip_nonfinite_updates: int = 0,
    trainable_mask: Union[Callable, Mapping, None] = None,
) -> Optimizer:
    """The JAX package's optimizer chain (see the module docstring).

    Args:
      optimizer: "adamw" | "adafactor" (factored second moments; the weight
        decay, if any, is ``weight_decay * p`` added after the learning
        rate's scale) | "lion" (``b1``, ``b2``: the JAX package passes its
        own 0.999) | "sgd" (``momentum``; no weight decay).
      weight_decay_mask: None decays every parameter; ``"non_1d"`` only
        those of two or more dims; or a mapping of parameter name to bool,
        or a callable of the module returning one.  Ignored by "sgd".
      accum_steps: micro-batches per update (optax.MultiSteps).
      skip_nonfinite_updates: > 0 drops a non-finite gradient (parameters,
        moments, counts untouched) unless more than that many arrive in a
        row (optax.apply_if_finite).
      trainable_mask: a mapping of parameter name to bool, or a callable of
        the module returning one; False freezes the parameter (no update, no
        state, out of the clip's norm).
    """
    if optimizer not in OPTIMIZERS:
        raise ValueError(
            "optimizer must be 'adamw', 'adafactor', 'lion' or 'sgd';"
            f" got {optimizer!r}"
        )
    if isinstance(weight_decay_mask, str) and weight_decay_mask != "non_1d":
        raise ValueError(
            "weight_decay_mask must be None, 'non_1d', a callable or a mapping;"
            f" got {weight_decay_mask!r}")
    if int(accum_steps) < 1:
        raise ValueError(f"accum_steps must be at least 1; got {accum_steps}")
    return Optimizer(
        schedule=build_schedule(peak_lr, schedule=schedule, total_steps=total_steps,
                                warmup_steps=warmup_steps, end_lr_ratio=end_lr_ratio),
        optimizer=optimizer, b1=b1, b2=b2, momentum=momentum, weight_decay=weight_decay,
        weight_decay_mask=weight_decay_mask, clip_norm=clip_norm,
        accum_steps=int(accum_steps), skip_nonfinite_updates=int(skip_nonfinite_updates),
        trainable_mask=trainable_mask,
    )
