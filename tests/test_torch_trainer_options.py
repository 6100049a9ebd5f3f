"""The port's Trainer with the rest of the optimizer chain and
``steps_per_call``, against the JAX Trainer.

A small tanh MLP with the same parameter names and layouts on both sides
(``w0``, ``b0``, ``w1``, ``b1``) trains on batches made with numpy: for each
optimizer option the logged losses, the logged learning rate and the final
weights against the JAX Trainer's (rtol 2e-4, atol 2e-5); ``steps_per_call=3``
against the JAX Trainer's and against the port's ``steps_per_call=1``, bit
for bit (losses, weights, EMA, the steps the log, evaluation and checkpoint
lines fall at); a run resumed from a checkpoint inside an accumulation
window against the run that was never interrupted, bit for bit.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from perceiverio_pytorch_tpu.training import Trainer as JaxTrainer
from perceiverio_pytorch_tpu.training import build_optimizer as jax_build_optimizer
from perceiverio_pytorch_tpu.training import build_schedule as jax_build_schedule
from perceiverio_pytorch_tpu_torch.training import Trainer, build_optimizer

torch.set_num_threads(1)
TOL = dict(rtol=2e-4, atol=2e-5)
SHAPES = {"w0": (3, 8), "b0": (8,), "w1": (8, 1), "b1": (1,)}
SCHEDULE = dict(schedule="cosine", total_steps=6, warmup_steps=2)


def _init(seed=0):
    rng = np.random.default_rng(seed)
    return {k: (0.5 * rng.standard_normal(s)).astype(np.float32) for k, s in SHAPES.items()}


def _batches(n, seed=1, nan_at=()):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        x = rng.standard_normal((4, 3)).astype(np.float32)
        y = rng.standard_normal((4, 1)).astype(np.float32)
        if i in nan_at:
            x[0, 0] = np.nan
        out.append((x, y))
    return out


def _jax_loss(p, x, y):
    return jnp.mean((jnp.tanh(x @ p["w0"] + p["b0"]) @ p["w1"] + p["b1"] - y) ** 2)


class Tiny(torch.nn.Module):
    def __init__(self, init):
        super().__init__()
        for k, v in init.items():
            self.register_parameter(k, torch.nn.Parameter(torch.from_numpy(v.copy())))

    def forward(self, x):
        return torch.tanh(x @ self.w0 + self.b0) @ self.w1 + self.b1


def _loss(model, x, y):
    return ((model(x) - y) ** 2).mean()


def _torch(batches):
    return [tuple(torch.from_numpy(a) for a in b) for b in batches]


def _lines(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


CASES = {
    "adafactor": dict(optimizer="adafactor", weight_decay=0.01),
    "lion": dict(optimizer="lion", weight_decay=0.1),
    "sgd": dict(optimizer="sgd", momentum=0.9, clip_norm=0.5),
    "accum": dict(accum_steps=2, clip_norm=1.0),
    "skip": dict(skip_nonfinite_updates=2, clip_norm=1.0),
    "trainable": dict(trainable_mask={"w0": False, "b0": True, "w1": True, "b1": False},
                      clip_norm=0.3, weight_decay=0.05),
    "decay_mask": dict(weight_decay=0.2, weight_decay_mask={"w0": True, "b0": False,
                                                            "w1": True, "b1": False}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_trainer_options_match_jax_trainer(tmp_path, case):
    """Six steps of each option (a NaN batch at step 3 for the skip) through
    both Trainers: the loss and lr lines, and the final weights.  Under
    accumulation the JAX Trainer logs ``lambda s: sched(s // k)``, the rate
    the optimizer applies; the port reads it from the optimizer's count."""
    kw = dict(SCHEDULE, **CASES[case])
    lr = 3e-2 if case != "lion" else 3e-3
    k = kw.get("accum_steps", 1)
    batches = _batches(6, nan_at=(2,) if case == "skip" else ())
    sched = jax_build_schedule(lr, **SCHEDULE)
    jax_trainer = JaxTrainer(_jax_loss, jax_build_optimizer(lr, **kw), log_every=1,
                             lr_schedule=lambda s: sched(s // k),
                             metrics_path=str(tmp_path / "jax.jsonl"))
    jax_state = jax_trainer.fit(
        jax_trainer.init_state({n: jnp.asarray(v) for n, v in _init().items()}),
        iter(batches), num_steps=6)

    tx = build_optimizer(lr, **kw)
    trainer = Trainer(_loss, tx, log_every=1, lr_schedule=tx.schedule,
                      metrics_path=str(tmp_path / "port.jsonl"))
    model = Tiny(_init())
    state = trainer.fit(trainer.init_state(model), _torch(batches), num_steps=6)
    got, want = _lines(tmp_path / "port.jsonl"), _lines(tmp_path / "jax.jsonl")
    assert [g["step"] for g in got] == [w["step"] for w in want] == [1, 2, 3, 4, 5, 6]
    np.testing.assert_allclose([g["loss"] for g in got], [w["loss"] for w in want], **TOL)
    want_lr = [w["lr"] for w in want]
    if case == "skip":
        # The JAX Trainer logs sched(step - 1) whatever the optimizer did;
        # optax's own count, which the updates apply, stays put at the
        # skipped step 3, and the port logs that.
        want_lr = [float(sched(c)) for c in (0, 1, 1, 2, 3, 4)]
    np.testing.assert_allclose([g["lr"] for g in got], want_lr, rtol=1e-6, atol=1e-9)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jax_state.params[name]),
                                   err_msg=name, **TOL)
    if case == "skip":
        assert np.isnan(got[2]["loss"]) and state.optimizer.chain["total_notfinite"] == 1
        assert state.optimizer.chain["count"] == 5 and state.step == 6
    if case == "trainable":
        np.testing.assert_array_equal(model.w0.detach().numpy(), _init()["w0"])


def test_steps_per_call_matches_jax_and_single_steps(tmp_path):
    """``steps_per_call=3`` over 6 steps with an EMA, evaluations and
    checkpoints every 2 steps: the JAX Trainer's losses and weights, and the
    port's ``steps_per_call=1`` run's bit for bit; the cadences fire when the
    count crosses them (steps 3 and 6), as in JAX."""
    batches = _batches(9, seed=2)
    eval_batches = _batches(2, seed=3)
    kw = dict(SCHEDULE, clip_norm=1.0)
    common = dict(eval_every=2, ema_decay=0.9)
    jax_trainer = JaxTrainer(_jax_loss, jax_build_optimizer(1e-2, **kw), steps_per_call=3,
                             metrics_path=str(tmp_path / "jax.jsonl"), log_every=2,
                             eval_fn=_jax_loss, **common)
    jax_state = jax_trainer.fit(
        jax_trainer.init_state({n: jnp.asarray(v) for n, v in _init().items()}),
        iter(batches), num_steps=6, eval_batches=eval_batches)

    runs = {}
    for k in (3, 1):
        model = Tiny(_init())
        # every step's loss on the single steps' lines
        trainer = Trainer(_loss, build_optimizer(1e-2, **kw), steps_per_call=k,
                          metrics_path=str(tmp_path / f"port{k}.jsonl"),
                          checkpoint_dir=str(tmp_path / f"ck{k}"), checkpoint_every=2,
                          log_every=2 if k == 3 else 1, eval_fn=_loss, **common)
        state = trainer.fit(trainer.init_state(model), _torch(batches), num_steps=6,
                            eval_batches=_torch(eval_batches))
        runs[k] = (state, model, _lines(tmp_path / f"port{k}.jsonl"),
                   sorted(p.name for p in (tmp_path / f"ck{k}").iterdir()))
    (s3, m3, lines3, ck3), (s1, m1, lines1, ck1) = runs[3], runs[1]
    assert s3.step == s1.step == 6
    want = _lines(tmp_path / "jax.jsonl")
    logged = [line for line in lines3 if "loss" in line]
    assert [line["step"] for line in logged] == [3, 6]
    assert [line["step"] for line in want if "loss" in line] == [3, 6]
    assert [line["step"] for line in lines3 if "eval_loss" in line] == [3, 6]
    assert [line["step"] for line in want if "eval_loss" in line] == [3, 6]
    assert ck3 == ["step_00000003", "step_00000006"]
    assert ck1 == ["step_00000002", "step_00000004", "step_00000006"]
    np.testing.assert_allclose([line["loss"] for line in logged],
                               [line["loss"] for line in want if "loss" in line], **TOL)
    by_step = {line["step"]: line["loss"] for line in lines1 if "loss" in line}
    assert [line["loss"] for line in logged] == [by_step[3], by_step[6]]
    for name, p in m3.named_parameters():
        assert torch.equal(p, m1.get_parameter(name)), name
        assert torch.equal(s3.ema_params[name], s1.ema_params[name]), name
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jax_state.params[name]),
                                   err_msg=name, **TOL)
        np.testing.assert_allclose(s3.ema_params[name].numpy(),
                                   np.asarray(jax_state.ema_params[name]), err_msg=name, **TOL)


def test_steps_per_call_overshoots_by_less_than_a_group(tmp_path):
    """num_steps = 5 with groups of 3 runs 6 updates, as the JAX Trainer."""
    batches = _batches(9, seed=4)
    jax_trainer = JaxTrainer(_jax_loss, jax_build_optimizer(1e-2), steps_per_call=3,
                             log_every=1, metrics_path=str(tmp_path / "jax.jsonl"))
    jax_state = jax_trainer.fit(
        jax_trainer.init_state({n: jnp.asarray(v) for n, v in _init().items()}),
        iter(batches), num_steps=5)
    trainer = Trainer(_loss, build_optimizer(1e-2), steps_per_call=3, log_every=1,
                      metrics_path=str(tmp_path / "port.jsonl"))
    state = trainer.fit(trainer.init_state(Tiny(_init())), _torch(batches), num_steps=5)
    assert state.step == int(jax_state.step) == 6
    assert ([line["step"] for line in _lines(tmp_path / "port.jsonl")]
            == [line["step"] for line in _lines(tmp_path / "jax.jsonl")] == [3, 6])


def test_resume_inside_an_accumulation_window_is_exact(tmp_path):
    """Accumulation over 3 micro-steps with checkpoints every 2 steps: a run
    stopped at step 4 (one micro-step into its second window) and resumed
    into a model of other weights ends as the uninterrupted run, bit for
    bit: weights, running mean, moments, counts and the losses after the
    resume."""
    batches = _batches(8, seed=5)
    kw = dict(SCHEDULE, accum_steps=3, clip_norm=1.0, skip_nonfinite_updates=1)

    def run(name, num_steps, init, resume=False, steps=None):
        tx = build_optimizer(1e-2, **kw)
        trainer = Trainer(_loss, tx, log_every=1, metrics_path=str(tmp_path / f"{name}.jsonl"),
                          checkpoint_dir=str(tmp_path / name.rstrip("b")), checkpoint_every=2)
        model = Tiny(init)
        state = trainer.init_state(model)
        data = _torch(batches)
        for n in steps or [num_steps]:
            state = trainer.fit(state, lambda s: data[s:], num_steps=n, resume=resume)
        return state

    whole = run("whole", 7, _init())
    run("part", 4, _init())
    resumed = run("partb", 7, _init(seed=9), resume=True)
    assert resumed.step == whole.step == 7
    assert resumed.optimizer.chain == whole.optimizer.chain
    assert resumed.optimizer.chain["mini_step"] == 1 and resumed.optimizer.chain["count"] == 2
    for name, p in whole.model.named_parameters():
        assert torch.equal(resumed.model.get_parameter(name), p), name
    got, want = resumed.optimizer.state_dict()["state"], whole.optimizer.state_dict()["state"]
    assert sorted(got) == sorted(want)
    for i, entry in want.items():
        assert sorted(entry) == sorted(got[i]) == ["acc", "mu", "nu"]
        for key, value in entry.items():
            assert torch.equal(got[i][key], value), (i, key)
    after = [line for line in _lines(tmp_path / "partb.jsonl") if "loss" in line]
    whole_lines = {line["step"]: line["loss"] for line in _lines(tmp_path / "whole.jsonl")}
    assert [line["step"] for line in after] == [5, 6, 7]
    assert [line["loss"] for line in after] == [whole_lines[s] for s in (5, 6, 7)]
