"""Training loop with JSONL metrics, checkpoints and device prefetch.

Counterpart of ``Trainer`` and ``MetricsLogger`` in
``perceiverio_pytorch_tpu/training/loop.py``: the train step over a batch
stream, its evaluation (``eval_fn``, ``eval_every``, ``Trainer.evaluate``),
periodic train-state checkpoints (synchronous or by a thread, pruned to the
newest N), ``fit(resume=True)``, device prefetch, the SIGTERM guard, an EMA
of the parameters (``ema_decay``), the logged learning rate
(``lr_schedule``), ``steps_per_call`` (k updates a call, here k eager
steps), and the mesh (``mesh``, ``fsdp``): one process per device, each
running this loop on the same global batches, its step keeping its own rows
(``training.trainer.make_sharded_train_step``).  On a mesh the ranks agree
on the SIGTERM flag every step, so that all stop at the same step and save
once; rank 0 writes the checkpoints, the metrics file and the log lines.
"""

from __future__ import annotations

import contextlib
import json
import os
import signal
import threading
import time
from typing import Callable, Iterable, Optional

import torch

from perceiverio_pytorch_tpu_torch.parallel import collectives as cc
from perceiverio_pytorch_tpu_torch.parallel.mesh import DATA_AXIS, axis, mesh_device
from perceiverio_pytorch_tpu_torch.parallel.sharding import batch_sharding, gathered
from perceiverio_pytorch_tpu_torch.training import checkpoint as ckpt
from perceiverio_pytorch_tpu_torch.training.data import prefetch_to_device
from perceiverio_pytorch_tpu_torch.training.optim import Optimizer
from perceiverio_pytorch_tpu_torch.training.trainer import (
    TrainState,
    create_sharded_train_state,
    create_train_state,
    ema_weights,
    make_multi_step,
    make_sharded_train_step,
    make_train_step,
    place_batch,
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


class _PreemptionGuard:
    """Turns SIGTERM into a stop flag while ``fit`` runs.

    A preemptible machine gets SIGTERM some time before it goes away: the
    step in flight finishes, a checkpoint is written and ``fit`` returns, so
    that ``fit(resume=True)`` goes on from there.  A handler can only be
    installed from the main thread; elsewhere the guard never stops.
    """

    def __init__(self):
        self._installed = False
        self._prev = None
        self.requested = False

    def _handler(self, signum, frame):
        self.requested = True

    def __enter__(self):
        if threading.current_thread() is threading.main_thread():
            self._prev = signal.signal(signal.SIGTERM, self._handler)
            self._installed = True
        return self

    def __exit__(self, *exc):
        if self._installed:
            # None: the previous handler was not installed from Python
            signal.signal(signal.SIGTERM,
                          signal.SIG_DFL if self._prev is None else self._prev)
        return False


def _groups(batches, size: int):
    """Consecutive batch tuples in lists of ``size`` (a short last one at its
    own length): ``make_multi_step``'s input, the JAX ``_stack_groups``
    without the stacking."""
    group = []
    for batch in batches:
        group.append(batch if isinstance(batch, (tuple, list)) else (batch,))
        if len(group) == size:
            yield group
            group = []
    if group:
        yield group


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
      checkpoint_dir: directory of the ``step_XXXXXXXX`` train-state
        checkpoints (``training.checkpoint``); also what ``fit(resume=True)``
        restores from.
      checkpoint_every: save every this many updates (0: never).
      checkpoint_keep: keep only the newest N finished checkpoints (pruned
        after each save, with unfinished ones older than the newest
        finished); 0 keeps all.
      checkpoint_final: also save when ``fit`` ends off the
        ``checkpoint_every`` grid (budget reached, stream exhausted).
      checkpoint_async: write the saves by a thread
        (``AsyncCheckpointWriter``): the copy to host memory is part of the
        step, the disk write overlaps the following steps; ``fit`` waits
        for the last one before it returns.
      prefetch: keep this many batches copied to the model's device ahead of
        the step (``training.data.prefetch_to_device``), so that decoding and
        the copy overlap the steps; 0 takes the batches as they come.
      ema_decay: keep an exponential moving average of the trainable
        parameters in ``state.ema_params``, updated after each optimizer
        step; ``evaluate`` uses it by default and the checkpoints carry it.
      lr_schedule: ``tx.schedule``, to log the learning rate of each logged
        step as ``lr`` (``tx.logged_lr``: the rate of the last update the
        optimizer applied, read from its own count, or inside an
        accumulation window the rate the window's update takes), outside the
        ``steps_per_sec`` window.  The JAX Trainer takes the schedule because
        optax hides it; here ``tx`` carries it, so any other callable raises
        ValueError: the logged rate is the applied one.
      steps_per_call: run this many updates per call of the step
        (``make_multi_step``: k eager steps, the same updates as k calls of
        the single step); consecutive batches are grouped k at a time.  Log,
        evaluation and checkpoint cadences fire when the step count crosses
        them, and a run overshoots ``num_steps`` by at most k - 1; the
        logged loss is the group's last.  Refused with ``log_grad_norm``.
        Ignored on a mesh (one update a call), as in the JAX Trainer.
      mesh: a (data, model) mesh (``parallel.make_mesh``): ``init_state``
        places the model on it by the TP rules and the step runs on it
        (``make_sharded_train_step``).  ``fit`` and ``evaluate`` take global
        batches, the same on every rank, and keep this rank's rows (placed
        in the prefetch thread with ``prefetch``); the logged losses and
        evaluation metrics are the global ones.
      fsdp: also shard every >=2-D parameter and its optimizer moments over
        the data axis (FSDP); needs ``mesh`` (ValueError without one).
    """

    def __init__(self, loss_fn: Callable, tx: Optimizer, mesh=None, fsdp: bool = False, *,
                 metrics_path: Optional[str] = None, log_every: int = 10,
                 log_grad_norm: bool = False, eval_fn: Optional[Callable] = None,
                 eval_every: int = 0, checkpoint_dir: Optional[str] = None,
                 checkpoint_every: int = 0, checkpoint_keep: int = 0,
                 checkpoint_final: bool = False, checkpoint_async: bool = False,
                 prefetch: int = 0, ema_decay: Optional[float] = None,
                 lr_schedule: Optional[Callable[[int], float]] = None,
                 steps_per_call: int = 1):
        self.mesh = mesh
        self.fsdp = bool(fsdp)
        if self.fsdp and mesh is None:
            raise ValueError(
                "Trainer(fsdp=True) needs a mesh -- without one there is no data axis to"
                " shard the weights over and training would silently run fully replicated")
        self.loss_fn = loss_fn
        self.tx = tx
        self._rank0 = mesh is None or torch.distributed.get_rank() == 0
        self.logger = MetricsLogger(metrics_path if self._rank0 else None, echo=self._rank0)
        self.log_every = log_every
        self.log_grad_norm = log_grad_norm
        self.eval_fn = eval_fn
        self.eval_every = eval_every
        self.checkpoint_dir = checkpoint_dir
        self.checkpoint_every = checkpoint_every
        self.checkpoint_keep = int(checkpoint_keep)
        self.checkpoint_final = checkpoint_final
        self.checkpoint_async = bool(checkpoint_async)
        self.prefetch = max(int(prefetch), 0)
        self.ema_decay = ema_decay
        if lr_schedule is not None and lr_schedule is not tx.schedule:
            raise ValueError("lr_schedule must be tx.schedule, the schedule the updates apply")
        self.lr_schedule = lr_schedule
        self.steps_per_call = max(int(steps_per_call), 1)
        if log_grad_norm and self.steps_per_call > 1:
            raise ValueError("log_grad_norm is not available with steps_per_call > 1"
                             " (the multi-step call returns per-step losses only)")
        self._async_writer: Optional[ckpt.AsyncCheckpointWriter] = None

    def init_state(self, model) -> TrainState:
        if self.mesh is not None:
            return create_sharded_train_state(model, self.tx, self.mesh,
                                              ema_decay=self.ema_decay, fsdp=self.fsdp)
        return create_train_state(model, self.tx, ema_decay=self.ema_decay)

    def _eval_batch(self, model, batch):
        """``eval_fn`` on one batch: on a mesh, on this rank's rows, the
        result averaged over the data axis (the global metric)."""
        if self.mesh is None:
            return self.eval_fn(model, *batch)
        data = axis(self.mesh, DATA_AXIS)
        with cc.global_batch(data.group), gathered(model):
            val = self.eval_fn(model, *place_batch(batch, self.mesh))

        def mean(v):
            v = torch.as_tensor(v, device=mesh_device(self.mesh)).detach().float().clone()
            return cc.all_reduce_(v, data.group).div_(data.size)

        return {k: mean(v) for k, v in val.items()} if isinstance(val, dict) else mean(val)

    def evaluate(self, state: TrainState, eval_batches, use_ema: Optional[bool] = None):
        """The mean of ``eval_fn`` over ``eval_batches``: a float for a scalar
        ``eval_fn``, a dict of floats for a dict of metrics, 0.0 when there is
        no batch.  The model runs in eval mode without gradients and is put
        back in the mode it was in.

        ``use_ema``: evaluate with ``state.ema_params`` in place of the live
        parameters.  None (the default) uses them whenever the state has
        them; True without them raises ValueError.
        """
        if use_ema is None:
            use_ema = state.ema_params is not None
        if use_ema and state.ema_params is None:
            raise ValueError("evaluate(use_ema=True) needs state.ema_params; build the"
                             " state with ema_decay")
        model = state.model
        was_training = model.training
        totals, n = {}, 0
        model.eval()
        try:
            with torch.no_grad(), (ema_weights(state) if use_ema
                                   else contextlib.nullcontext()):
                for batch in eval_batches:
                    if not isinstance(batch, (tuple, list)):
                        batch = (batch,)
                    val = self._eval_batch(model, batch)
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
        ``batches(start_step) -> iterable`` called with ``state.step`` after
        the restore (if any); pair it with ``batch_iterator(...,
        start_batch=start_step)`` or ``dataset_iterator`` so that a resumed
        run, or a second ``fit`` on the same state, continues the data order
        of an uninterrupted one.

        ``resume=True`` restores the newest finished checkpoint under
        ``checkpoint_dir`` (if any) into ``state`` and logs
        ``resumed_from``; ``num_steps`` is the total budget, so a finished
        run restarts as a no-op.  It needs ``checkpoint_dir``.

        ``eval_batches``: an iterable of batch tuples (materialised once, so
        that a generator serves every evaluation), or a callable
        ``eval_batches() -> iterable`` called anew before each evaluation
        (batches made lazily); with ``eval_fn`` set, ``evaluate`` runs over
        it every ``eval_every`` updates.

        SIGTERM while the loop runs (on the main thread) finishes the step in
        flight, saves it (with ``checkpoint_dir``), logs ``preempted=True``
        and returns.
        """
        if eval_batches is not None and not callable(eval_batches):
            eval_batches = list(eval_batches)
        if resume:
            if not self.checkpoint_dir:
                raise ValueError(
                    "fit(resume=True) needs Trainer(checkpoint_dir=...): without it"
                    " there is nothing to resume from and training would restart at"
                    " step 0")
            latest = ckpt.latest_checkpoint(self.checkpoint_dir)
            if latest is not None:
                state = ckpt.restore_train_state(latest, state)
                self.logger.log(step=state.step, resumed_from=os.path.basename(latest))
        if callable(batches):
            batches = batches(state.step)
        sharding = None if self.mesh is None else batch_sharding(self.mesh)
        if self.prefetch > 0:
            device = next(iter(state.model.parameters())).device
            batches = prefetched = prefetch_to_device(batches, self.prefetch, device=device,
                                                      sharding=sharding)
        elif sharding is not None:
            batches = (place_batch(b if isinstance(b, (tuple, list)) else (b,), self.mesh)
                       for b in batches)
        if self.mesh is not None:
            step_fn = make_sharded_train_step(self.loss_fn, self.tx, self.mesh, state,
                                              with_metrics=self.log_grad_norm,
                                              ema_decay=self.ema_decay, placed_batches=True)
        elif self.steps_per_call > 1:
            step_fn = make_multi_step(self.loss_fn, self.tx, ema_decay=self.ema_decay)
            batches = _groups(batches, self.steps_per_call)
        else:
            step_fn = make_train_step(self.loss_fn, self.tx,
                                      with_metrics=self.log_grad_norm,
                                      ema_decay=self.ema_decay)
        try:
            with _PreemptionGuard() as guard:
                state = self._fit_loop(state, batches, num_steps, step_fn, eval_batches,
                                       guard)
        finally:
            if self.prefetch > 0:
                prefetched.close()  # stops the prefetch thread
            if self._async_writer is not None:
                # The caller may exit or restore right after fit().
                writer, self._async_writer = self._async_writer, None
                writer.close()
        if self.mesh is not None:  # every rank returns after rank 0's writes
            torch.distributed.barrier()
        return state

    def _fit_loop(self, state, batches: Iterable, num_steps, step_fn, eval_batches, guard):
        def crossed(step_num, prev_step, every):
            return bool(every) and step_num // every > prev_step // every

        t0 = time.perf_counter()
        window_start, window_step = t0, state.step
        start_step = step_num = state.step
        last_saved = -1
        for batch in batches:
            if num_steps is not None and state.step >= num_steps:
                break
            prev_step = state.step
            if self.steps_per_call > 1 and self.mesh is None:
                state, loss = step_fn(state, batch)
                loss = loss[-1]
            else:
                if not isinstance(batch, (tuple, list)):
                    batch = (batch,)
                state, loss = step_fn(state, *batch)
            step_num = state.step
            if crossed(step_num, prev_step, self.log_every) or (
                num_steps is not None and step_num >= num_steps
            ):
                extra = {}
                if isinstance(loss, dict):  # log_grad_norm metrics
                    extra = {k: round(float(v), 6) for k, v in loss.items()
                             if k != "loss"}
                    loss = loss["loss"]
                loss_val = float(loss)  # waits for the step: ends the window
                now = time.perf_counter()
                if self.lr_schedule is not None:
                    extra["lr"] = round(float(self.tx.logged_lr(state.optimizer)), 8)
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
                    and crossed(step_num, prev_step, self.eval_every)):
                ev = self.evaluate(
                    state, eval_batches() if callable(eval_batches) else eval_batches)
                if not isinstance(ev, dict):
                    ev = {"eval_loss": ev}
                self.logger.log(step=step_num, **{k: round(v, 6) for k, v in ev.items()})
            if self.checkpoint_dir and crossed(step_num, prev_step, self.checkpoint_every):
                self._save_checkpoint(state, step_num)
                last_saved = step_num
            if self._stop_requested(guard):
                # The step in flight has finished: save it and stop, so that
                # fit(resume=True) goes on from exactly here.
                if self.checkpoint_dir and last_saved != step_num:
                    self._save_checkpoint(state, step_num)
                    last_saved = step_num
                self.logger.log(step=step_num, preempted=True)
                break
        if (self.checkpoint_final and self.checkpoint_dir and last_saved != step_num
                and step_num > start_step):
            self._save_checkpoint(state, step_num)
        return state

    def _stop_requested(self, guard) -> bool:
        """Has any rank been told to stop?  SIGTERM reaches the ranks at
        different times; a rank that broke out alone would leave the others
        waiting in the next step's collectives.  On a mesh the ranks agree
        on the flag every step (one ``MAX`` all-reduce of a scalar), so that
        all break at the same step and save once."""
        if self.mesh is None:
            return guard.requested
        flag = torch.tensor([int(guard.requested)], device=mesh_device(self.mesh))
        return bool(cc.all_reduce_(flag, None, torch.distributed.ReduceOp.MAX).item())

    def _save_checkpoint(self, state: TrainState, step_num: int) -> None:
        path = os.path.join(self.checkpoint_dir, f"step_{step_num:08d}")
        # overwrite=True: a resumed run may reach this step again
        if self.checkpoint_async:
            if self._async_writer is None:
                self._async_writer = ckpt.AsyncCheckpointWriter()
            self._async_writer.save_train_state(path, state, overwrite=True)
        else:
            ckpt.save_train_state(path, state, overwrite=True)
        # A save in flight has no marker yet and is newer than every finished
        # one, so pruning leaves it alone.
        if self.checkpoint_keep > 0 and self._rank0:  # host files: one process
            ckpt.prune_checkpoints(self.checkpoint_dir, self.checkpoint_keep)
