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

On a mesh (``create_sharded_train_state``, ``make_sharded_train_step``;
JAX :193-345) the module is placed by ``parallel.sharding.shard_module``:
each parameter is this rank's piece, and the optimizer moments, made like
their parameters, are pieces too.  The step takes the global batch and
keeps this rank's rows, runs the forward and the backward with FSDP's
pieces gathered (``parallel.sharding.gathered``) and the losses and
BatchNorm reducing over the data axis (``global_batch``), then averages
the gradients over the data axis: an all-reduce of the gradients of the
parameters FSDP does not split (one per dtype, over a flat buffer), and a
division of those FSDP's gather reduce-scattered.  The optimizer takes its
norms over all shards (``training/optim.py``), and the EMA is updated on
the pieces.  The loss it returns is the ranks' average: the global one.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, Optional, Sequence

import torch
from torch import nn

from perceiverio_pytorch_tpu_torch.parallel import collectives as cc
from perceiverio_pytorch_tpu_torch.parallel.mesh import DATA_AXIS, axis
from perceiverio_pytorch_tpu_torch.parallel.sharding import (
    NamedSharding,
    batch_sharding,
    gathered,
    layout_of,
    shard_module,
    variables_shardings,
)
from perceiverio_pytorch_tpu_torch.training.optim import Optimizer


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
        return state, _step_body(state, batch, loss_fn, tx, ema_decay, with_metrics)

    return step


def _step_body(state: TrainState, batch, loss_fn, tx: Optimizer, ema_decay, with_metrics,
               data=None):
    """One update, shared by the step builders: the loss (or the metrics).
    ``data`` is the mesh's data axis on a mesh: the forward and backward
    run on this rank's rows with FSDP's pieces gathered, the gradients and
    the loss are averaged over the data axis."""
    model, opt = state.model, state.optimizer
    model.train()
    opt.zero_grad(set_to_none=True)
    with contextlib.ExitStack() as scope:
        if data is not None:
            scope.enter_context(cc.global_batch(data.group))
            scope.enter_context(gathered(model))
        with torch.enable_grad():
            loss = loss_fn(model, *batch)
        loss.backward()
    if data is not None:
        sync_gradients(state)
    grad_norm = tx.update(opt)
    if ema_decay is not None:
        _ema_update(state, ema_decay)
    state.step += 1
    loss = loss.detach()
    if data is not None:
        loss = cc.all_reduce_(loss.clone(), data.group).div_(data.size)
    if with_metrics:
        params = [p for g in opt.param_groups for p in g["params"]]
        return {"loss": loss, "grad_norm": grad_norm,
                "param_norm": opt.global_norm(params, params)}
    return loss


def param_shardings(model: nn.Module, mesh, fsdp: bool = False) -> Dict[str, NamedSharding]:
    """``NamedSharding`` of each parameter of ``model`` by the rules (TP, and
    FSDP with ``fsdp``), by parameter name."""
    params = dict(model.named_parameters())
    return {n: s for n, s in variables_shardings(model, mesh, fsdp=fsdp).items()
            if n in params}


# Optimizer state entries made like their parameter (AdamW, Lion, SGD,
# Adafactor's unfactored second moment, the accumulation); Adafactor's
# factored moments are whole on every rank.
_PARAM_LIKE = ("mu", "nu", "trace", "acc", "v")


def opt_state_shardings(state: "TrainState") -> Dict[str, Dict[str, NamedSharding]]:
    """``NamedSharding`` of each optimizer state entry of a sharded state,
    by parameter name and entry: the moments take their parameter's
    placement, Adafactor's factored moments and the chain's counts are
    replicated (JAX ``opt_state_shardings``)."""
    layout = layout_of(state.model)
    out = {}
    for p, entries in state.optimizer.state.items():
        spec = layout.spec(p)
        out[layout.names[id(p)]] = {
            k: NamedSharding(layout.mesh, spec if k in _PARAM_LIKE else ())
            for k in entries}
    return out


def create_sharded_train_state(model: nn.Module, tx: Optimizer, mesh,
                               ema_decay: Optional[float] = None,
                               fsdp: bool = False) -> TrainState:
    """Place ``model`` on ``mesh`` by the rules (``shard_module``; ``fsdp``
    composes FSDP's data-axis pieces onto the TP rules) and build the state
    on it: the optimizer's moments and the EMA are made from the pieces, so
    they are placed like their parameters."""
    shard_module(model, mesh, fsdp=fsdp)
    state = create_train_state(model, tx, ema_decay=ema_decay)
    state.optimizer.shards = layout_of(model)
    return state


def place_batch(batch: Sequence, mesh) -> tuple:
    """This rank's rows of each array of a global batch, on its device (the
    batch axis split over the data axis; JAX's ``device_put`` with
    ``batch_sharding``)."""
    rows = batch_sharding(mesh)
    return tuple(rows.shard(x) for x in batch)


@torch.no_grad()
def sync_gradients(state: TrainState) -> None:
    """Average the gradients of a sharded state's trainable parameters over
    the data axis (see the module docstring); a parameter the loss did not
    reach gets a zero gradient first, so that every rank reduces the same
    tensors."""
    layout = layout_of(state.model)
    data = axis(layout.mesh, DATA_AXIS)
    fsdp_pieces = {id(p) for _, p, _ in layout.gathers}
    params = [p for g in state.optimizer.param_groups for p in g["params"]]
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    whole = [p.grad for p in params if id(p) not in fsdp_pieces]
    for dtype in sorted({g.dtype for g in whole}, key=str):
        grads = [g for g in whole if g.dtype == dtype]
        flat = cc.all_reduce_(torch.cat([g.reshape(-1) for g in grads]), data.group)
        flat.div_(data.size)
        torch._foreach_copy_(grads, [f.view_as(g) for f, g in
                                      zip(flat.split([g.numel() for g in grads]), grads)])
    pieces = [p.grad for p in params if id(p) in fsdp_pieces]
    if pieces:
        torch._foreach_div_(pieces, data.size)


def make_sharded_train_step(loss_fn: Callable[..., torch.Tensor], tx: Optimizer, mesh,
                            state: TrainState, with_metrics: bool = False,
                            ema_decay: Optional[float] = None, placed_batches: bool = False):
    """Build the mesh's ``step(state, *batch) -> (state, loss)`` for a state
    made by ``create_sharded_train_state`` (see the module docstring).

    ``batch`` is the global batch (every rank the same), of which the step
    keeps this rank's rows, or with ``placed_batches`` those rows already on
    the device (``place_batch``; the Trainer places its batches ahead, in
    its prefetch thread).  ``with_metrics`` and ``ema_decay`` as in
    ``make_train_step``; the returned loss and norms are global.
    """
    layout = layout_of(state.model)
    if layout is None or layout.mesh is not mesh:
        raise ValueError("the state is not placed on this mesh: build it with"
                         " create_sharded_train_state(model, tx, mesh)")
    data = axis(mesh, DATA_AXIS)

    def step(state: TrainState, *batch):
        if not placed_batches:
            batch = place_batch(batch, mesh)
        return state, _step_body(state, batch, loss_fn, tx, ema_decay, with_metrics, data)

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
