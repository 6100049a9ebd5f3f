"""The training step: zero-grad, forward, loss, backward, the optimizer, EMA.

Counterpart of ``make_train_step``, ``make_multi_step`` and the EMA of
``perceiverio_pytorch_tpu/training/trainer.py``.  JAX's state is a pure
pytree; here ``TrainState`` holds the module (whose parameters are updated
in place), its ``OptaxChain`` (``training/optim.py``, which keeps its own
counts), the count of steps taken and, when
built with ``ema_decay``, an exponential moving average of the trainable
parameters.  Buffers such as the Fourier position tables are not
parameters, so they get no optimizer state and no average, as the JAX
package keeps its "consts" out of the optimized tree.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, Optional, Sequence

import torch
from torch import nn

from perceiverio_pytorch_tpu_torch.training.optim import Optimizer, global_norm


@dataclasses.dataclass
class TrainState:
    step: int
    model: nn.Module
    optimizer: torch.optim.Optimizer
    # Exponential moving average of the trainable parameters, by parameter
    # name, in their dtype (None unless the state was built with ema_decay).
    ema_params: Optional[Dict[str, torch.Tensor]] = None


def _trainable(model: nn.Module) -> Dict[str, nn.Parameter]:
    """The parameters the optimizer updates (``requires_grad``), by name."""
    return {n: p for n, p in model.named_parameters() if p.requires_grad}


def create_train_state(model: nn.Module, tx: Optimizer,
                       ema_decay: Optional[float] = None) -> TrainState:
    """The state at step 0; with ``ema_decay`` the average starts as a copy
    of the trainable parameters."""
    ema = None
    if ema_decay is not None:
        ema = {n: p.detach().clone() for n, p in _trainable(model).items()}
    return TrainState(step=0, model=model, optimizer=tx.create(model), ema_params=ema)


@torch.no_grad()
def _ema_update(state: TrainState, decay: float) -> None:
    """``e = e * decay + p * (1 - decay)`` for every trainable parameter, in
    place: the JAX package's formula, as three ``_foreach`` launches (two
    products and a sum, each rounded in the parameters' dtype)."""
    if state.ema_params is None:
        raise ValueError(
            "the step was built with ema_decay but the state carries no ema_params;"
            " build it with create_train_state(..., ema_decay=...)")
    params = _trainable(state.model)
    ema = [state.ema_params[n] for n in params]
    torch._foreach_mul_(ema, decay)
    torch._foreach_add_(ema, torch._foreach_mul(list(params.values()), 1.0 - decay))


@contextlib.contextmanager
def ema_weights(state: TrainState):
    """Run the module with the EMA weights in place of its trainable
    parameters (their storage swapped, nothing copied); the live weights are
    back when the block ends."""
    params = _trainable(state.model)
    live = {n: p.data for n, p in params.items()}
    try:
        for n, p in params.items():
            p.data = state.ema_params[n]
        yield state.model
    finally:
        for n, p in params.items():
            p.data = live[n]


def make_train_step(loss_fn: Callable[..., torch.Tensor], tx: Optimizer,
                    with_metrics: bool = False, ema_decay: Optional[float] = None):
    """Build ``step(state, *batch) -> (state, loss)``.

    ``loss_fn(model, *batch)`` returns a scalar tensor.  The model runs in
    ``train()`` mode with gradients.  With ``with_metrics`` the step returns
    ``(state, {"loss", "grad_norm", "param_norm"})``: the global norm of the
    gradients before the clip, and that of the updated parameters.  With
    ``ema_decay`` the average is updated after the optimizer (``_ema_update``).
    """

    def step(state: TrainState, *batch):
        model, opt = state.model, state.optimizer
        model.train()
        opt.zero_grad(set_to_none=True)
        with torch.enable_grad():
            loss = loss_fn(model, *batch)
        loss.backward()
        grad_norm = tx.update(opt)
        if ema_decay is not None:
            _ema_update(state, ema_decay)
        state.step += 1
        loss = loss.detach()
        if with_metrics:
            params = [p for g in opt.param_groups for p in g["params"]]
            return state, {"loss": loss, "grad_norm": grad_norm,
                           "param_norm": global_norm(params)}
        return state, loss

    return step


def make_multi_step(loss_fn: Callable[..., torch.Tensor], tx: Optimizer,
                    ema_decay: Optional[float] = None):
    """Build ``step(state, batches) -> (state, losses)``: one update per
    batch tuple of ``batches``, in order, each the step of
    ``make_train_step`` (EMA included); ``losses`` holds one loss per step.

    The JAX package scans the steps inside one dispatch; here they are that
    many eager steps, so the result is the same as calling the single step
    on each batch, bit for bit."""
    one = make_train_step(loss_fn, tx, ema_decay=ema_decay)

    def step(state: TrainState, batches: Sequence):
        losses = []
        for batch in batches:
            state, loss = one(state, *batch)
            losses.append(loss)
        return state, torch.stack(losses)

    return step
