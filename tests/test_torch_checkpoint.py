"""The port's checkpoints: train state, the async writer, the Trainer's
``step_XXXXXXXX`` directories, SIGTERM, device prefetch on the CPU, and
weights for evaluation from every kind of checkpoint against the JAX
package's outputs.
"""

import json
import os
import signal
import threading
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from perceiverio_pytorch_tpu import config as jax_config
from perceiverio_pytorch_tpu.models import classification as jax_cls
from perceiverio_pytorch_tpu.models import flow as jax_flow
from perceiverio_pytorch_tpu.utils.torch_checkpoint import save_torch_checkpoint
from perceiverio_pytorch_tpu_torch import config as port_config
from perceiverio_pytorch_tpu_torch.models import classification as port_cls
from perceiverio_pytorch_tpu_torch.models import flow as port_flow
from perceiverio_pytorch_tpu_torch.training import (
    AsyncCheckpointWriter,
    Trainer,
    batch_iterator,
    build_optimizer,
    latest_checkpoint,
    prefetch_to_device,
    prune_checkpoints,
    restore_eval_variables,
    restore_train_state,
    restore_variables,
    save_train_state,
    save_variables,
)
from perceiverio_pytorch_tpu_torch.utils.weights import state_dict_from_flax

torch.set_num_threads(1)
TOL = dict(rtol=2e-4, atol=2e-5)
FLOW = dict(img_size=(16, 24), num_latents=8, num_latent_channels=32,
            num_self_attends_per_block=1)
CLS = dict(num_classes=5, img_size=(32, 32), num_self_attends_per_block=1, num_blocks=1,
           num_latents=8, num_latent_channels=32)


def _mse(model, x, y):
    return ((model(x) - y) ** 2).mean()


def _linear_state(seed, tx=None):
    gen = torch.Generator().manual_seed(seed)
    model = torch.nn.Sequential(torch.nn.Linear(4, 8), torch.nn.BatchNorm1d(8),
                                torch.nn.Linear(8, 2))
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.randn(p.shape, generator=gen))
    trainer = Trainer(_mse, tx or build_optimizer(1e-2, schedule="cosine", total_steps=8,
                                                  warmup_steps=2), log_every=0)
    return trainer, trainer.init_state(model)


def _data(n=16, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, 4)).astype(np.float32),
            rng.normal(size=(n, 2)).astype(np.float32))


def _batches(data, batch=4):
    def make(start):
        for b in batch_iterator(data, batch, shuffle=True, epochs=None, start_batch=start):
            yield tuple(torch.from_numpy(a) for a in b)
    return make


def _snapshot(state):
    return ({k: v.clone() for k, v in state.model.state_dict().items()},
            {i: {k: v.clone() for k, v in s.items()}
             for i, s in state.optimizer.state_dict()["state"].items()})


def _assert_same(state, snapshot):
    model_sd, opt_state = snapshot
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, model_sd[k]), k
    got = state.optimizer.state_dict()["state"]
    assert sorted(got) == sorted(opt_state)
    for i, entry in got.items():
        for k, v in entry.items():
            assert torch.equal(v, opt_state[i][k]), (i, k)


def test_train_state_round_trip_is_exact(tmp_path):
    """Module (BatchNorm statistics and counter included), AdamW moments,
    step and learning rate restored bit for bit into a model of other
    weights, in place."""
    trainer, state = _linear_state(0)
    state = trainer.fit(state, _batches(_data()), num_steps=3)
    save_train_state(str(tmp_path / "c"), state)
    marker = json.loads((tmp_path / "c" / "checkpoint.json").read_text())
    assert marker == {"kind": "train_state", "file": "train_state.pt", "step": 3}
    snap = _snapshot(state)
    lr = state.optimizer.param_groups[0]["lr"]
    trainer2, other = _linear_state(1)
    params = [id(p) for p in other.model.parameters()]
    restored = restore_train_state(str(tmp_path / "c"), other)
    assert restored is other and restored.step == 3
    assert [id(p) for p in restored.model.parameters()] == params
    _assert_same(restored, snap)
    assert restored.optimizer.param_groups[0]["lr"] == lr == trainer.tx.schedule(2)
    assert int(restored.model[1].num_batches_tracked) == 3
    with pytest.raises(FileExistsError):
        save_train_state(str(tmp_path / "c"), state)
    save_train_state(str(tmp_path / "c"), state, overwrite=True)


def test_restore_refuses_a_mismatched_state(tmp_path):
    trainer, state = _linear_state(0)
    save_train_state(str(tmp_path / "c"), state)
    other_model = torch.nn.Sequential(torch.nn.Linear(4, 8), torch.nn.Linear(8, 2))
    other = trainer.init_state(other_model)
    before = _snapshot(other)
    with pytest.raises(ValueError, match="does not match the model"):
        restore_train_state(str(tmp_path / "c"), other)
    _assert_same(other, before)
    wide = torch.nn.Sequential(torch.nn.Linear(4, 9), torch.nn.BatchNorm1d(9),
                               torch.nn.Linear(9, 2))
    with pytest.raises(ValueError, match="other shapes"):
        restore_train_state(str(tmp_path / "c"), trainer.init_state(wide))
    _, decayed = _linear_state(0, build_optimizer(1e-2, weight_decay=0.1,
                                                  weight_decay_mask="non_1d"))
    with pytest.raises(ValueError, match="optimizer groups"):
        restore_train_state(str(tmp_path / "c"), decayed)


def test_async_save_holds_the_values_before_the_next_step(tmp_path):
    """The writer copies the state before ``save`` returns: a step taken
    while it writes (AdamW updates in place) does not reach the file."""
    trainer, state = _linear_state(0)
    stream = _batches(_data())(0)
    state = trainer.fit(state, stream, num_steps=2)
    snap = _snapshot(state)
    with AsyncCheckpointWriter() as writer:
        writer.save_train_state(str(tmp_path / "a"), state)
        state = trainer.fit(state, stream, num_steps=3)  # in place, during the write
        writer.wait()
        assert (tmp_path / "a" / "checkpoint.json").exists()
        writer.save(str(tmp_path / "w"), state.model.state_dict())
    assert state.step == 3
    _, other = _linear_state(5)
    _assert_same(restore_train_state(str(tmp_path / "a"), other), snap)
    got = restore_variables(str(tmp_path / "w"), device="cpu")
    for k, v in state.model.state_dict().items():
        assert torch.equal(got[k], v)


def test_async_writer_raises_its_error_at_wait(tmp_path, monkeypatch):
    from perceiverio_pytorch_tpu_torch.training import checkpoint as ckpt

    def fail(*args, **kwargs):
        raise OSError("disk full")

    monkeypatch.setattr(ckpt.torch, "save", fail)
    writer = AsyncCheckpointWriter()
    writer.save(str(tmp_path / "w"), {"x": torch.ones(2)})
    with pytest.raises(OSError, match="disk full"):
        writer.wait()
    writer.wait()  # the error is raised once
    assert latest_checkpoint(str(tmp_path)) is None


def _fake_step(root, step, finished=True):
    path = os.path.join(root, f"step_{step:08d}")
    os.makedirs(path)
    if finished:
        with open(os.path.join(path, "checkpoint.json"), "w") as f:
            json.dump({"kind": "train_state", "step": step}, f)
    return path


def test_latest_skips_unfinished_and_prune_keeps_the_newest(tmp_path):
    root = str(tmp_path)
    assert latest_checkpoint(str(tmp_path / "none")) is None
    assert prune_checkpoints(str(tmp_path / "none"), 2) == []
    for step in (2, 4, 6):
        _fake_step(root, step)
    unfinished_old = _fake_step(root, 5, finished=False)
    unfinished_new = _fake_step(root, 8, finished=False)
    os.makedirs(os.path.join(root, "step_junk"))
    assert latest_checkpoint(root) == os.path.join(root, "step_00000006")
    removed = prune_checkpoints(root, 2)
    assert sorted(removed) == sorted([os.path.join(root, "step_00000002"), unfinished_old])
    assert sorted(os.listdir(root)) == ["step_00000004", "step_00000006", "step_00000008",
                                        "step_junk"]
    assert os.path.isdir(unfinished_new)
    with pytest.raises(ValueError):
        prune_checkpoints(root, 0)


def test_trainer_checkpoints_keep_final_and_resume(tmp_path):
    """Saves every 2 steps pruned to 2, a final save off the grid, and a
    resume that equals the uninterrupted run bit for bit and logs its origin."""
    data = _data()
    ref_trainer, ref = _linear_state(0)
    ref = ref_trainer.fit(ref, _batches(data), num_steps=7)

    metrics = tmp_path / "m.jsonl"
    trainer, state = _linear_state(0)
    trainer.checkpoint_dir, trainer.checkpoint_every = str(tmp_path / "ck"), 2
    trainer.checkpoint_keep, trainer.checkpoint_final = 2, True
    state = trainer.fit(state, _batches(data), num_steps=5)
    assert sorted(os.listdir(tmp_path / "ck")) == ["step_00000004", "step_00000005"]
    _, other = _linear_state(3)
    trainer2 = Trainer(_mse, trainer.tx, log_every=1, metrics_path=str(metrics),
                       checkpoint_dir=str(tmp_path / "ck"), checkpoint_every=2)
    other = trainer2.fit(other, _batches(data), num_steps=7, resume=True)
    assert other.step == 7
    lines = [json.loads(x) for x in metrics.read_text().splitlines()]
    assert lines[0] == {"step": 5, "resumed_from": "step_00000005"}
    assert [x["step"] for x in lines[1:]] == [6, 7]
    _assert_same(other, _snapshot(ref))
    again = trainer2.fit(other, _batches(data), num_steps=7, resume=True)
    assert again.step == 7  # a finished run restarts as a no-op
    with pytest.raises(ValueError, match="checkpoint_dir"):
        Trainer(_mse, trainer.tx).fit(other, _batches(data), resume=True)


def test_sigterm_mid_fit_checkpoints_and_returns(tmp_path):
    """SIGTERM during step 2 (between saves): the step finishes, is saved,
    ``preempted`` is logged and fit returns; the previous handler is back."""
    assert threading.current_thread() is threading.main_thread()
    previous = signal.getsignal(signal.SIGTERM)
    calls = []

    def loss(model, x, y):
        calls.append(1)
        if len(calls) == 2:
            handler = signal.getsignal(signal.SIGTERM)
            assert getattr(handler, "__self__", None).__class__.__name__ == "_PreemptionGuard"
            signal.raise_signal(signal.SIGTERM)
        return _mse(model, x, y)

    metrics = tmp_path / "m.jsonl"
    _, state = _linear_state(0)
    trainer = Trainer(loss, build_optimizer(1e-2), log_every=0, metrics_path=str(metrics),
                      checkpoint_dir=str(tmp_path / "ck"), checkpoint_every=5)
    state = trainer.fit(state, _batches(_data()), num_steps=10)
    assert state.step == 2 and len(calls) == 2
    assert [json.loads(x) for x in metrics.read_text().splitlines()] == [
        {"step": 2, "preempted": True}]
    assert latest_checkpoint(str(tmp_path / "ck")).endswith("step_00000002")
    assert signal.getsignal(signal.SIGTERM) is previous


def test_prefetch_on_the_cpu(tmp_path):
    """Tensors from numpy batches in order; the source's error raised at the
    consumer; the thread stops when the consumer closes the iterator."""
    data = [(np.full((2, 3), i, np.float32), np.arange(i, i + 2)) for i in range(5)]
    got = list(prefetch_to_device(iter(data), 2, device="cpu"))
    assert len(got) == 5
    for (a, b), (x, y) in zip(got, data):
        assert isinstance(a, torch.Tensor) and torch.equal(a, torch.from_numpy(x))
        assert torch.equal(b, torch.from_numpy(y))

    def failing():
        yield data[0]
        raise RuntimeError("bad file")

    it = prefetch_to_device(failing(), 1, device="cpu")
    next(it)
    with pytest.raises(RuntimeError, match="bad file"):
        next(it)

    def endless():
        while True:
            yield data[0]

    before = threading.active_count()
    it = prefetch_to_device(endless(), 2, device="cpu")
    next(it)
    it.close()
    deadline = time.monotonic() + 10
    while threading.active_count() > before and time.monotonic() < deadline:
        time.sleep(0.05)
    assert threading.active_count() == before
    with pytest.raises(ValueError):
        next(prefetch_to_device(iter(data), 0, device="cpu"))


def test_trainer_prefetch_gives_the_same_run(tmp_path):
    data = _data()
    t1, s1 = _linear_state(0)
    s1 = t1.fit(s1, _batches(data), num_steps=4)
    t2, s2 = _linear_state(0)  # numpy batches, turned into tensors by the prefetch
    t2.prefetch = 2
    s2 = t2.fit(s2, lambda s: batch_iterator(data, 4, shuffle=True, epochs=None,
                                             start_batch=s), num_steps=4)
    _assert_same(s2, _snapshot(s1))


@pytest.fixture(scope="module")
def jax_flow_run():
    """JAX weights of the small flow model (a random decoder projection),
    two frame pairs and JAX's flow for them."""
    jm = jax_flow.FlowPerceiver(**FLOW, policy=jax_config.PARITY)
    zeros = jnp.zeros((1, 3) + FLOW["img_size"])
    variables = jax.tree_util.tree_map(
        np.asarray, jax.jit(jm.init)(jax.random.PRNGKey(4), zeros, zeros))
    final = variables["params"]["perceiver"]["decoder"]["final_layer"]
    final["kernel"] = np.random.default_rng(4).standard_normal(
        final["kernel"].shape).astype(np.float32) * 0.1
    rng = np.random.default_rng(5)
    img1, img2 = (rng.uniform(-1, 1, (2, 3) + FLOW["img_size"]).astype(np.float32)
                  for _ in range(2))
    return variables, img1, img2, np.asarray(jax.jit(jm.apply)(variables, img1, img2))


@pytest.mark.parametrize("source", ["variables", "trainer", "pth"])
def test_restore_eval_variables_gives_the_jax_outputs(tmp_path, jax_flow_run, source):
    """Flow: JAX weights reach a port model of other weights through a
    weights directory, a Trainer checkpoint or a ``.pth`` written by the JAX
    package's ``save_torch_checkpoint``; its flow equals JAX's."""
    variables, img1, img2, want = jax_flow_run
    trained = port_flow.FlowPerceiver(**FLOW, policy=port_config.PARITY, device="cpu")
    trained.load_state_dict(state_dict_from_flax(variables), strict=True)
    kw = {}
    if source == "variables":
        save_variables(str(tmp_path / "w"), trained.state_dict())
        kw["checkpoint"] = str(tmp_path / "w")
    elif source == "trainer":
        trainer = Trainer(_mse, build_optimizer(1e-3))
        save_train_state(str(tmp_path / "t"), trainer.init_state(trained))
        kw["checkpoint"] = str(tmp_path / "t")
    else:
        save_torch_checkpoint(str(tmp_path / "flow.pth"), variables)
        kw["torch_checkpoint"] = str(tmp_path / "flow.pth")
    model = port_flow.FlowPerceiver(**FLOW, policy=port_config.PARITY, device="cpu",
                                    generator=torch.Generator().manual_seed(9))
    assert restore_eval_variables(model, **kw) is model
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(img1), torch.from_numpy(img2)).numpy()
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(got, want, **TOL)
    assert restore_eval_variables(model) is model  # nothing to restore


def test_restore_eval_variables_from_a_jax_pth_with_batchnorm(tmp_path):
    """The convnet classifier's ``.pth`` from JAX has no
    ``num_batches_tracked``: the model keeps its counters, every other entry
    loads strictly, and the eval-mode logits equal JAX's."""
    jm = jax_cls.ClassificationPerceiver(prep_type=jax_cls.PrepType.FOURIER_POS_CONVNET,
                                         policy=jax_config.PARITY, **CLS)
    img = np.random.default_rng(6).uniform(-1, 1, (2, 3, 32, 32)).astype(np.float32)
    variables = jax.tree_util.tree_map(
        np.asarray, jax.jit(jm.init)(jax.random.PRNGKey(1), jnp.zeros((1, 3, 32, 32))))
    rng = np.random.default_rng(2)
    variables["batch_stats"] = jax.tree_util.tree_map(
        lambda x: x + rng.uniform(0.1, 0.5, x.shape).astype(np.float32),
        variables["batch_stats"])
    want = np.asarray(jax.jit(jm.apply)(variables, img))
    save_torch_checkpoint(str(tmp_path / "cls.pth"), variables)
    model = port_cls.ClassificationPerceiver(
        prep_type=port_cls.PrepType.FOURIER_POS_CONVNET, policy=port_config.PARITY,
        device="cpu", **CLS)
    restore_eval_variables(model, torch_checkpoint=str(tmp_path / "cls.pth"))
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(img)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    torch.save({"model_state_dict": {"bogus": torch.ones(1)}}, str(tmp_path / "bad.pth"))
    with pytest.raises(RuntimeError):
        restore_eval_variables(model, torch_checkpoint=str(tmp_path / "bad.pth"))


def test_ema_checkpoint_resume_and_eval_weights_match_jax(tmp_path):
    """A Trainer with ``ema_decay`` saves its EMA; a model of other weights
    resumed from step 2 ends at step 4 with the uninterrupted run's weights,
    moments and EMA bit for bit; ``restore_eval_variables`` on the step-4
    checkpoint gives the EMA weights, which equal those the JAX package's
    ``restore_eval_variables`` gives from the JAX Trainer's checkpoint."""
    import shutil

    from perceiverio_pytorch_tpu.training import Trainer as JaxTrainer
    from perceiverio_pytorch_tpu.training import batch_iterator as jax_batch_iterator
    from perceiverio_pytorch_tpu.training import build_optimizer as jax_build_optimizer
    from perceiverio_pytorch_tpu.training.checkpoint import (
        restore_eval_variables as jax_restore_eval_variables,
    )

    data = _data()
    rng = np.random.default_rng(3)
    w0 = rng.normal(size=(4, 2)).astype(np.float32)
    b0 = rng.normal(size=(2,)).astype(np.float32)
    kw = dict(schedule="cosine", total_steps=4, warmup_steps=1)

    def jax_loss(p, xb, yb):
        return jnp.mean((xb @ p["w"] + p["b"] - yb) ** 2)

    jax_trainer = JaxTrainer(jax_loss, jax_build_optimizer(5e-2, **kw), log_every=0,
                             ema_decay=0.7, checkpoint_dir=str(tmp_path / "jax"),
                             checkpoint_every=2)
    jax_trainer.fit(jax_trainer.init_state({"w": jnp.asarray(w0), "b": jnp.asarray(b0)}),
                    lambda s: jax_batch_iterator(data, 4, shuffle=True, epochs=None,
                                                 start_batch=s), num_steps=4)
    want = jax_restore_eval_variables(
        {"params": {"w": jnp.zeros((4, 2)), "b": jnp.zeros((2,))}},
        checkpoint=str(tmp_path / "jax" / "step_00000004"))["params"]

    def linear(seed):
        model = torch.nn.Linear(4, 2)
        with torch.no_grad():
            if seed is None:
                model.weight.copy_(torch.from_numpy(w0.T))
                model.bias.copy_(torch.from_numpy(b0))
            else:
                gen = torch.Generator().manual_seed(seed)
                for p in model.parameters():
                    p.copy_(torch.randn(p.shape, generator=gen))
        return model

    def trainer(root):
        return Trainer(_mse, build_optimizer(5e-2, **kw), log_every=0, ema_decay=0.7,
                       checkpoint_dir=str(root), checkpoint_every=2)

    run_a = trainer(tmp_path / "a")
    state_a = run_a.fit(run_a.init_state(linear(None)), _batches(data), num_steps=4)
    saved = torch.load(str(tmp_path / "a" / "step_00000004" / "train_state.pt"),
                       weights_only=True)
    assert set(saved["ema"]) == {"weight", "bias"}
    shutil.copytree(tmp_path / "a" / "step_00000002", tmp_path / "b" / "step_00000002")
    run_b = trainer(tmp_path / "b")
    state_b = run_b.fit(run_b.init_state(linear(5)), _batches(data), num_steps=4, resume=True)
    assert state_b.step == 4
    _assert_same(state_b, _snapshot(state_a))
    for name in ("weight", "bias"):
        assert torch.equal(state_b.ema_params[name], state_a.ema_params[name]), name
    model = restore_eval_variables(linear(7), checkpoint=str(tmp_path / "a" / "step_00000004"))
    assert torch.equal(model.weight, state_a.ema_params["weight"])
    assert torch.equal(model.bias, state_a.ema_params["bias"])
    assert not torch.equal(model.weight, state_a.model.weight)
    np.testing.assert_allclose(model.weight.detach().numpy(), np.asarray(want["w"]).T, **TOL)
    np.testing.assert_allclose(model.bias.detach().numpy(), np.asarray(want["b"]), **TOL)
    plain = Trainer(_mse, build_optimizer(5e-2, **kw)).init_state(linear(7))
    with pytest.raises(ValueError, match="EMA"):
        restore_train_state(str(tmp_path / "a" / "step_00000004"), plain)
    save_train_state(str(tmp_path / "plain"), plain)
    with pytest.raises(ValueError, match="EMA"):
        restore_train_state(str(tmp_path / "plain"), state_a)
