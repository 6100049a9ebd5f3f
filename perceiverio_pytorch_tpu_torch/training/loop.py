"""Training loop with JSONL metrics.

Counterpart of ``Trainer`` and ``MetricsLogger`` in
``perceiverio_pytorch_tpu/training/loop.py``, on one device, with its
evaluation (``eval_fn``, ``eval_every``, ``Trainer.evaluate``).  The JAX
Trainer's mesh and FSDP, checkpoints, EMA, multi-step dispatch and device
prefetch are not ported: setting any of them raises ``NotImplementedError``.
"""

from __future__ import annotations

import json
import os
import time
from typing import Callable, Iterable, Optional

import torch

from perceiverio_pytorch_tpu_torch.training.optim import Optimizer
from perceiverio_pytorch_tpu_torch.training.trainer import (
    TrainState,
    create_train_state,
    make_train_step,
)


class MetricsLogger:
    """Append-only JSONL metrics writer (plus stdout echo)."""

    def __init__(self, path: Optional[str] = None, echo: bool = True):
        self.path = path
        self.echo = echo
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            self._file = open(path, "a")
        else:
            self._file = None

    def log(self, **metrics):
        line = json.dumps(metrics)
        if self._file:
            self._file.write(line + "\n")
            self._file.flush()
        if self.echo:
            print(line, flush=True)

    def close(self):
        if self._file:
            self._file.close()
            self._file = None


# Trainer arguments of the JAX package that are not ported, with the value
# that means "off".
_NOT_PORTED = {
    "mesh": None, "fsdp": False, "checkpoint_dir": None, "checkpoint_every": 0,
    "ema_decay": None, "steps_per_call": 1, "prefetch": 0,
}


class Trainer:
    """Drives the train step over a batch iterator.

    Args:
      loss_fn: ``loss_fn(model, *batch) -> scalar tensor``.
      tx: ``training.optim.build_optimizer(...)``.
      metrics_path: JSONL file the metrics are appended to (None: stdout).
      log_every: log step, loss, steps_per_sec and elapsed_sec every this
        many steps (0: never), and at the last step.
      log_grad_norm: also log ``grad_norm`` and ``param_norm``.
      eval_fn: optional ``eval_fn(model, *batch) -> scalar tensor``, or a
        ``{name: scalar tensor}`` dict of metrics; ``fit`` runs it over its
        ``eval_batches`` every ``eval_every`` updates (``evaluate``) and logs
        the means on a line of their own (a scalar as ``eval_loss``).  The
        JAX Trainer's ``with_model_state`` and ``num_batch_args`` have no
        counterpart: state such as BatchNorm's running averages lives in the
        module's buffers, which the train step updates in ``train()`` mode
        and ``evaluate`` reads in ``eval()`` mode.
      mesh, fsdp, checkpoint_dir, checkpoint_every, ema_decay,
        steps_per_call, prefetch: not ported; anything but the default
        raises NotImplementedError.
    """

    def __init__(self, loss_fn: Callable, tx: Optimizer, *,
                 metrics_path: Optional[str] = None, log_every: int = 10,
                 log_grad_norm: bool = False, eval_fn: Optional[Callable] = None,
                 eval_every: int = 0, **not_ported):
        for name, value in not_ported.items():
            if name not in _NOT_PORTED:
                raise TypeError(f"Trainer got an unexpected argument {name!r}")
            if value != _NOT_PORTED[name]:
                raise NotImplementedError(
                    f"Trainer({name}=...) is not ported to PyTorch yet (see ROADMAP.md)")
        self.loss_fn = loss_fn
        self.tx = tx
        self.logger = MetricsLogger(metrics_path)
        self.log_every = log_every
        self.log_grad_norm = log_grad_norm
        self.eval_fn = eval_fn
        self.eval_every = eval_every

    def init_state(self, model) -> TrainState:
        return create_train_state(model, self.tx)

    def evaluate(self, state: TrainState, eval_batches, use_ema: Optional[bool] = None):
        """The mean of ``eval_fn`` over ``eval_batches``: a float for a scalar
        ``eval_fn``, a dict of floats for a dict of metrics, 0.0 when there is
        no batch.  The model runs in eval mode without gradients and is put
        back in the mode it was in.  ``use_ema=True`` raises: EMA is not
        ported."""
        if use_ema:
            raise NotImplementedError(
                "evaluate(use_ema=True): EMA is not ported to PyTorch yet (see ROADMAP.md)")
        model = state.model
        was_training = model.training
        totals, n = {}, 0
        model.eval()
        try:
            with torch.no_grad():
                for batch in eval_batches:
                    if not isinstance(batch, (tuple, list)):
                        batch = (batch,)
                    val = self.eval_fn(model, *batch)
                    for k, v in (val if isinstance(val, dict) else {"eval_loss": val}).items():
                        totals[k] = totals.get(k, 0.0) + torch.as_tensor(v).detach().double()
                    n += 1
        finally:
            model.train(was_training)
        if not totals:
            return 0.0
        means = {k: float(v) / n for k, v in totals.items()}  # one fetch per metric
        if set(means) == {"eval_loss"}:
            return means["eval_loss"]
        return means

    def fit(self, state: TrainState, batches, num_steps: Optional[int] = None,
            eval_batches=None, resume: bool = False) -> TrainState:
        """Run the training loop until ``num_steps`` updates in all (counting
        those ``state`` has taken) or the end of ``batches``.

        ``batches`` is an iterable of batch tuples, or a callable
        ``batches(start_step) -> iterable`` called with ``state.step``; pair it
        with ``batch_iterator(..., start_batch=start_step)`` so that a second
        ``fit`` on the same state continues the data order.

        ``eval_batches``: an iterable of batch tuples (materialised once, so
        that a generator serves every evaluation); with ``eval_fn`` set,
        ``evaluate`` runs over it every ``eval_every`` updates.
        """
        if resume:
            raise NotImplementedError(
                "resuming from checkpoints is not ported to PyTorch yet (see ROADMAP.md)")
        if eval_batches is not None:
            eval_batches = list(eval_batches)
        if callable(batches):
            batches = batches(state.step)
        step_fn = make_train_step(self.loss_fn, self.tx,
                                  with_metrics=self.log_grad_norm)
        return self._fit_loop(state, batches, num_steps, step_fn, eval_batches)

    def _fit_loop(self, state, batches: Iterable, num_steps, step_fn, eval_batches):
        t0 = time.perf_counter()
        window_start, window_step = t0, state.step
        for batch in batches:
            if num_steps is not None and state.step >= num_steps:
                break
            if not isinstance(batch, (tuple, list)):
                batch = (batch,)
            state, loss = step_fn(state, *batch)
            step_num = state.step
            if (self.log_every and step_num % self.log_every == 0) or (
                num_steps is not None and step_num >= num_steps
            ):
                extra = {}
                if isinstance(loss, dict):  # log_grad_norm metrics
                    extra = {k: round(float(v), 6) for k, v in loss.items()
                             if k != "loss"}
                    loss = loss["loss"]
                loss_val = float(loss)  # waits for the step: ends the window
                now = time.perf_counter()
                self.logger.log(
                    step=step_num,
                    loss=loss_val,
                    steps_per_sec=round(
                        (step_num - window_step) / max(now - window_start, 1e-9), 3),
                    elapsed_sec=round(now - t0, 3),
                    **extra,
                )
                window_start, window_step = now, step_num
            if (self.eval_fn is not None and eval_batches is not None
                    and self.eval_every and step_num % self.eval_every == 0):
                ev = self.evaluate(state, eval_batches)
                if not isinstance(ev, dict):
                    ev = {"eval_loss": ev}
                self.logger.log(step=step_num, **{k: round(v, 6) for k, v in ev.items()})
        return state
