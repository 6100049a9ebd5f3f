"""The training step: zero-grad, forward, loss, backward, clip, update.

Counterpart of ``make_train_step`` in
``perceiverio_pytorch_tpu/training/trainer.py``.  JAX's state is a pure
pytree; here ``TrainState`` holds the module (whose parameters are updated
in place), its ``torch.optim.AdamW`` and the count of updates taken.  Buffers
such as the Fourier position tables are not parameters, so they get no
optimizer state, as the JAX package keeps its "consts" out of the
optimized tree.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch
from torch import nn

from perceiverio_pytorch_tpu_torch.training.optim import Optimizer, global_norm


@dataclasses.dataclass
class TrainState:
    step: int
    model: nn.Module
    optimizer: torch.optim.Optimizer


def create_train_state(model: nn.Module, tx: Optimizer) -> TrainState:
    return TrainState(step=0, model=model, optimizer=tx.create(model.parameters()))


def make_train_step(loss_fn: Callable[..., torch.Tensor], tx: Optimizer,
                    with_metrics: bool = False):
    """Build ``step(state, *batch) -> (state, loss)``.

    ``loss_fn(model, *batch)`` returns a scalar tensor.  The model runs in
    ``train()`` mode with gradients.  With ``with_metrics`` the step returns
    ``(state, {"loss", "grad_norm", "param_norm"})``: the global norm of the
    gradients before the clip, and that of the updated parameters.
    """

    def step(state: TrainState, *batch):
        model, opt = state.model, state.optimizer
        model.train()
        opt.zero_grad(set_to_none=True)
        with torch.enable_grad():
            loss = loss_fn(model, *batch)
        loss.backward()
        grad_norm = tx.update(opt, state.step)
        state.step += 1
        loss = loss.detach()
        if with_metrics:
            params = [p for g in opt.param_groups for p in g["params"]]
            return state, {"loss": loss, "grad_norm": grad_norm,
                           "param_norm": global_norm(params)}
        return state, loss

    return step
