"""Exact resume of the port's Trainer, and its resumed run against the JAX
Trainer's.

A run interrupted at a checkpoint and resumed into a model of other weights
equals the uninterrupted run bit for bit (fp32, CPU): the tiny flow model
trained from a file tree with random crops (the crops and the batch order
follow the absolute step across epochs), and the convnet classifier from an
image folder (its BatchNorm running averages ride in the checkpoint).  The
port's ``fit(checkpoint_dir, resume=True)`` logs the JAX Trainer's losses,
resumed the same way, within ``test_trainer_steps_match_jax_trainer``'s
tolerance.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from perceiverio_pytorch_tpu import config as jax_config
from perceiverio_pytorch_tpu.models import flow as jax_flow
from perceiverio_pytorch_tpu.training import Trainer as JaxTrainer
from perceiverio_pytorch_tpu.training import batch_iterator as jax_batch_iterator
from perceiverio_pytorch_tpu.training import build_optimizer as jax_build_optimizer
from perceiverio_pytorch_tpu.training import flow_endpoint_error as jax_epe
from perceiverio_pytorch_tpu_torch import config as port_config
from perceiverio_pytorch_tpu_torch.examples import train_classification, train_flow
from perceiverio_pytorch_tpu_torch.models import flow as port_flow
from perceiverio_pytorch_tpu_torch.tools import make_synthetic_data
from perceiverio_pytorch_tpu_torch.training import Trainer, batch_iterator, build_optimizer
from perceiverio_pytorch_tpu_torch.utils.weights import state_dict_from_flax

torch.set_num_threads(1)
TOL = dict(rtol=2e-4, atol=2e-5)  # test_torch_training.test_trainer_steps_match_jax_trainer's
SMALL = dict(img_size=(16, 24), num_latents=8, num_latent_channels=32,
             num_self_attends_per_block=2)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("data"))
    make_synthetic_data.make_flow(root, hw=(40, 56), scenes={"train": (3, 5)})
    make_synthetic_data.make_gratings(root, "cls", n_classes=3, amplitude=40, noise=48,
                                      per_split={"train": 4}, splits=("train",), hw=(32, 32))
    return root


def _state_of(state):
    return ({k: v.clone() for k, v in state.model.state_dict().items()},
            state.optimizer.state_dict()["state"])


def _assert_bitwise(got, want):
    (got_model, got_opt), (want_model, want_opt) = got, want
    assert sorted(got_model) == sorted(want_model)
    for k, v in want_model.items():
        assert torch.equal(got_model[k], v), k
    assert sorted(got_opt) == sorted(want_opt)
    for i, entry in want_opt.items():
        for k, v in entry.items():
            assert torch.equal(got_opt[i][k], v), (i, k)


def _losses(path):
    with open(path) as f:
        return {x["step"]: x["loss"] for x in map(json.loads, f) if "loss" in x}


def _interrupted_and_resumed(tmp_path, setup, total, stop_at):
    """(uninterrupted run, resumed run, their logged losses): the first run
    with no checkpoint, the second stopped at ``stop_at`` (a checkpoint) and
    resumed from it into a model drawn from another seed, with the batches
    prefetched."""
    trainer, state, batches, eval_batches = setup(metrics_path=str(tmp_path / "a.jsonl"),
                                                  seed=0)
    state = trainer.fit(state, batches, num_steps=total, eval_batches=eval_batches)
    ck = str(tmp_path / "ck")
    trainer, first, batches, eval_batches = setup(metrics_path=str(tmp_path / "b.jsonl"),
                                                  seed=0, checkpoint_dir=ck,
                                                  checkpoint_every=stop_at)
    first = trainer.fit(first, batches, num_steps=stop_at, eval_batches=eval_batches)
    assert first.step == stop_at
    trainer, second, batches, eval_batches = setup(metrics_path=str(tmp_path / "b.jsonl"),
                                                   seed=1, checkpoint_dir=ck,
                                                   checkpoint_every=stop_at, prefetch=2)
    second = trainer.fit(second, batches, num_steps=total, eval_batches=eval_batches,
                         resume=True)
    assert second.step == total
    return state, second, _losses(tmp_path / "a.jsonl"), _losses(tmp_path / "b.jsonl")


def test_flow_from_files_resumes_bit_for_bit(tmp_path, tree):
    """Tiny flow model, 12 pairs (8 trained, 4 held out), batch 2, random
    crops: 9 steps (2 epochs and a step), interrupted at step 3."""
    def setup(**kw):
        return train_flow.setup(9, batch_size=2, device="cpu", log_every=1,
                                data_dir=f"{tree}/flow_synth/train", **kw)

    want, got, want_losses, got_losses = _interrupted_and_resumed(tmp_path, setup, 9, 3)
    _assert_bitwise(_state_of(got), _state_of(want))
    assert sorted(want_losses) == sorted(got_losses) == list(range(1, 10))
    assert got_losses == want_losses


def test_convnet_classifier_from_files_resumes_bit_for_bit(tmp_path, tree):
    """Tiny convnet classifier (train-mode BatchNorm), 12 images (8 trained,
    4 held out), batch 2: 6 steps, interrupted at step 2; the running
    averages and their counters equal."""
    def setup(**kw):
        return train_classification.setup(6, batch_size=2, device="cpu", log_every=1,
                                          data_dir=f"{tree}/cls/train", **kw)

    want, got, want_losses, got_losses = _interrupted_and_resumed(tmp_path, setup, 6, 2)
    got_state, want_state = _state_of(got), _state_of(want)
    _assert_bitwise(got_state, want_state)
    counters = [k for k in want_state[0] if k.endswith("num_batches_tracked")]
    assert counters and all(int(want_state[0][k]) == 6 for k in counters)
    assert got_losses == want_losses and len(got_losses) == 6


def test_resumed_fit_matches_the_resumed_jax_trainer(tmp_path):
    """Three steps of the small flow model on the dense path, warmup+cosine
    AdamW with the clip, checkpointed at step 2 and resumed into a model of
    other weights, in both packages: the logged losses and the parameters."""
    jm = jax_flow.FlowPerceiver(**SMALL, policy=jax_config.PARITY)
    zeros = jnp.zeros((1, 3) + SMALL["img_size"])

    def jax_variables(seed):
        variables = jax.jit(jm.init)(jax.random.PRNGKey(seed), zeros, zeros)
        params = jax.tree_util.tree_map(np.asarray, variables["params"])
        final = params["perceiver"]["decoder"]["final_layer"]
        final["kernel"] = np.random.default_rng(seed).standard_normal(
            final["kernel"].shape).astype(np.float32) * 0.1
        return {**variables, "params": params}

    rng = np.random.default_rng(4)
    shape = (6, 3) + SMALL["img_size"]
    data = (rng.uniform(-1, 1, shape).astype(np.float32),
            rng.uniform(-1, 1, shape).astype(np.float32),
            rng.uniform(-2, 2, (6, 2) + SMALL["img_size"]).astype(np.float32))
    kw = dict(schedule="cosine", total_steps=3, warmup_steps=1, clip_norm=1.0)

    def jax_loss(params, model_state, a, b, gt):
        return jax_epe(jm.apply({"params": params, **model_state}, a, b), gt), model_state

    def jax_run(variables, num_steps, resume):
        trainer = JaxTrainer(jax_loss, jax_build_optimizer(1e-3, **kw), with_model_state=True,
                             log_every=1, metrics_path=str(tmp_path / "jax.jsonl"),
                             checkpoint_dir=str(tmp_path / "jax_ck"), checkpoint_every=2)
        consts = {k: v for k, v in variables.items() if k != "params"}
        state = trainer.init_state(variables["params"], model_state=consts)
        return trainer.fit(state, lambda s: jax_batch_iterator(
            data, 2, shuffle=True, epochs=None, start_batch=s), num_steps=num_steps,
            resume=resume)

    variables = jax_variables(3)
    jax_run(variables, 2, False)
    jax_state = jax_run(jax_variables(8), 3, True)
    want_params = state_dict_from_flax({"params": jax_state.params})

    def batches(start):
        for batch in batch_iterator(data, 2, shuffle=True, epochs=None, start_batch=start):
            yield tuple(torch.from_numpy(a) for a in batch)

    def port_run(variables, num_steps, resume):
        model = port_flow.FlowPerceiver(**SMALL, policy=port_config.PARITY, device="cpu")
        model.load_state_dict(state_dict_from_flax(variables), strict=True)
        trainer = Trainer(train_flow.loss_fn, build_optimizer(1e-3, **kw), log_every=1,
                          metrics_path=str(tmp_path / "port.jsonl"),
                          checkpoint_dir=str(tmp_path / "port_ck"), checkpoint_every=2)
        return trainer.fit(trainer.init_state(model), batches, num_steps=num_steps,
                           resume=resume)

    port_run(variables, 2, False)
    port_state = port_run(jax_variables(8), 3, True)
    assert port_state.step == int(jax_state.step) == 3

    def logged(name):
        with open(tmp_path / name) as f:
            return [json.loads(line) for line in f]

    jax_lines, port_lines = logged("jax.jsonl"), logged("port.jsonl")
    assert [x for x in port_lines if "resumed_from" in x] == [
        {"step": 2, "resumed_from": "step_00000002"}]
    assert [x for x in jax_lines if "resumed_from" in x] == [
        {"step": 2, "resumed_from": "step_00000002"}]
    want_losses = [x["loss"] for x in jax_lines if "loss" in x]
    got_losses = [x["loss"] for x in port_lines if "loss" in x]
    assert len(got_losses) == len(want_losses) == 3
    np.testing.assert_allclose(got_losses, want_losses, **TOL)
    initial = state_dict_from_flax(variables)
    for name, param in port_state.model.named_parameters():
        if name.endswith("proj_k.bias"):
            # Its exact gradient is 0: both sides hold rounding noise that
            # AdamW scales up to steps of up to lr (test_torch_training).
            assert (param.detach() - initial[name]).abs().max() <= 2e-3
            continue
        np.testing.assert_allclose(param.detach().numpy(), want_params[name].numpy(),
                                   err_msg=name, **TOL)
