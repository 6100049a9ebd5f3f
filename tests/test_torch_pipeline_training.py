"""Training through ``Policy(pp_mesh=...)`` on gloo ranks, against JAX's
sequential train steps (``tests/test_pipeline.py`` :729, :857).

One spawned group of 4 (``test_torch_parallel.run_ranks``) trains the byte
MLM of ``test_torch_parallel_train.py`` (2 self-attends) for 3 steps of
the flow example's AdamW on its 3 global batches of 4, with the stack
pipelined over a (2 data, 2 pipe) mesh (JAX: (2, 4)), 2 microbatches:

  * with the plain step (``make_train_step``: every rank the whole batch,
    each microbatch's rows split over the pipeline's data axis);
  * with the sharded step on a (2, 2) TP mesh (each rank its data rows;
    the stage gathers its layers' model-axis pieces at the entry), and
    with FSDP composed in.

Each run's losses and its trained parameters equal JAX's single-device
steps at rtol 2e-4 / atol 2e-5 (``proj_k.bias``, whose exact gradient is
0, within 3 steps of the rate of its start), and the plain step leaves
every rank's replicas equal.  One group of 2 runs ``examples/train_flow.py
--pp-stages 2`` (the tiny configuration with 2 * 2 self-attends): its CLI
for 2 steps, and ``setup`` for 3 steps on JAX's weights of the same
configuration, whose losses and parameters equal JAX's sequential steps on
the same batches.
"""

import os

import numpy as np
import pytest
import torch

from test_torch_parallel import run_ranks
from test_torch_parallel_train import LR, TOL, oracle as train_oracle

torch.set_num_threads(1)
RUNS = (("plain", None), ("tp", False), ("fsdp_tp", True))
FLOW_STEPS = 3


def _mlm_ranks(rank, world, case):
    import dataclasses

    from test_torch_parallel_train import OPT, build_port_model, port_loss

    from perceiverio_pytorch_tpu_torch import PARITY
    from perceiverio_pytorch_tpu_torch.parallel import make_mesh, make_pipeline_mesh
    from perceiverio_pytorch_tpu_torch.training import (
        build_optimizer,
        create_train_state,
        make_train_step,
    )
    from perceiverio_pytorch_tpu_torch.training.checkpoint import _train_state_tree
    from perceiverio_pytorch_tpu_torch.training.trainer import (
        create_sharded_train_state,
        make_sharded_train_step,
    )

    pp_mesh = make_pipeline_mesh(2, data=2, device="cpu")
    tp_mesh = make_mesh((2, 2), device="cpu")
    policy = dataclasses.replace(PARITY, pp_mesh=pp_mesh, pp_microbatches=2)
    out = {}
    for name, fsdp in RUNS:
        model = build_port_model("mlm", case["state_dict"], policy=policy)
        tx = build_optimizer(LR, **OPT)
        if fsdp is None:
            state = create_train_state(model, tx)
            step = make_train_step(port_loss("mlm"), tx)
        else:
            state = create_sharded_train_state(model, tx, tp_mesh, fsdp=fsdp)
            step = make_sharded_train_step(port_loss("mlm"), tx, tp_mesh, state)
        losses = []
        for batch in case["batches"]:
            state, loss = step(state, *(torch.from_numpy(a) for a in batch))
            losses.append(loss.item())
        tree = _train_state_tree(state)["model"] if fsdp is not None else model.state_dict()
        out[name] = dict(losses=losses, params={k: v.numpy() for k, v in tree.items()}
                         if rank == 0 or fsdp is None else None)
    return out


def _flow_ranks(rank, world, state_dict, tmp):
    import json
    import runpy
    import sys
    import warnings

    from perceiverio_pytorch_tpu_torch.examples import train_flow

    cwd, argv = os.getcwd(), sys.argv
    os.chdir(tmp)  # the CLI writes ./flow_metrics.jsonl
    try:
        sys.argv = ["train_flow", "--pp-stages", "2", "--steps", "2", "--device", "cpu"]
        with warnings.catch_warnings():  # the module is imported already: runpy says so
            warnings.simplefilter("ignore", RuntimeWarning)
            runpy.run_module("perceiverio_pytorch_tpu_torch.examples.train_flow",
                             run_name="__main__")
    finally:
        os.chdir(cwd)
        sys.argv = argv
    metrics = os.path.join(tmp, f"setup_{rank}.jsonl")
    trainer, state, batches, _ = train_flow.setup(FLOW_STEPS, device="cpu", pp_stages=2,
                                                  metrics_path=metrics, log_every=1)
    state.model.load_state_dict({k: torch.from_numpy(v) for k, v in state_dict.items()},
                                strict=True)
    state = trainer.fit(state, batches, num_steps=FLOW_STEPS)
    out = dict(params={k: v.detach().numpy() for k, v in state.model.state_dict().items()},
               layers=len(state.model.perceiver._encoder.self_attends))
    if rank == 0:
        with open(os.path.join(tmp, "flow_metrics.jsonl")) as f:
            out["cli"] = [json.loads(line) for line in f]
        with open(metrics) as f:
            out["losses"] = [json.loads(line)["loss"] for line in f]
    else:  # one process writes the host files
        out["wrote"] = os.path.exists(metrics)
    return out


def _flow_oracle():
    """JAX's tiny flow model with 4 self-attends (its decoder projection
    drawn at random), its 3 sequential steps on the example's batches."""
    import jax
    import jax.numpy as jnp

    from perceiverio_pytorch_tpu import config as jax_config
    from perceiverio_pytorch_tpu.models import flow as jax_flow
    from perceiverio_pytorch_tpu.training import batch_iterator as jax_batch_iterator
    from perceiverio_pytorch_tpu.training import flow_endpoint_error as jax_epe
    from perceiverio_pytorch_tpu_torch.examples import train_flow
    from perceiverio_pytorch_tpu_torch.utils.weights import state_dict_from_flax
    from test_torch_parallel_train import _jax_run

    tiny = dict(train_flow.TINY, num_self_attends_per_block=4)
    jm = jax_flow.FlowPerceiver(**tiny, policy=jax_config.DEFAULT)
    zeros = jnp.zeros((1, 3) + tiny["img_size"])
    variables = jax.tree_util.tree_map(
        np.asarray, jax.jit(jm.init)(jax.random.PRNGKey(0), zeros, zeros))
    final = variables["params"]["perceiver"]["decoder"]["final_layer"]
    final["kernel"] = np.random.default_rng(3).standard_normal(
        final["kernel"].shape).astype(np.float32) * 0.1
    data = train_flow.synthetic_flow_pairs(16, tiny["img_size"])
    stream = jax_batch_iterator(data, 2, shuffle=True, epochs=None)
    batches = [tuple(np.asarray(a) for a in next(stream)) for _ in range(FLOW_STEPS)]

    def loss(params, model_state, a, b, gt):
        return jax_epe(jm.apply({"params": params, **model_state}, a, b), gt), model_state

    losses, final_vars = _jax_run(variables, batches, loss)
    return dict(state_dict={k: v.numpy() for k, v in state_dict_from_flax(variables).items()},
                losses=losses,
                final={k: v.numpy() for k, v in state_dict_from_flax(final_vars).items()})


@pytest.fixture(scope="module")
def mlm(tmp_path_factory):
    want = train_oracle("mlm")
    case = dict(state_dict=want["state_dict"], batches=want["batches"])
    return want, run_ranks(_mlm_ranks, 4, tmp_path_factory.mktemp("pp_mlm"), case)


def _check_params(got, want, initial, label):
    for name, value in want.items():
        if name.endswith("proj_k.bias"):
            assert np.abs(got[name] - initial[name]).max() <= 3 * LR, (label, name)
            continue
        np.testing.assert_allclose(got[name], value, err_msg=f"{label} {name}", **TOL)


def test_policy_pp_mesh_full_train_step(mlm):
    """The plain step on every rank: JAX's losses and parameters, and the
    replicas equal on every rank after the steps."""
    want, results = mlm
    first = results[0]["plain"]
    np.testing.assert_allclose(first["losses"], want["losses"], **TOL)
    assert first["losses"][2] < first["losses"][0]
    _check_params(first["params"], want["final"], want["state_dict"], "plain")
    for got in results[1:]:
        assert got["plain"]["losses"] == first["losses"]
        for name, value in first["params"].items():
            np.testing.assert_array_equal(got["plain"]["params"][name], value, err_msg=name)


@pytest.mark.parametrize("name", ["tp", "fsdp_tp"])
def test_policy_pp_mesh_composes_with_tp_sharded_train_step(mlm, name):
    """TP (and FSDP + TP) on a (2, 2) mesh with the stack pipelined over a
    (2 data, 2 pipe) one: JAX's losses, descending, and parameters."""
    want, results = mlm
    got = results[0][name]
    np.testing.assert_allclose(got["losses"], want["losses"], err_msg=name, **TOL)
    assert np.all(np.isfinite(got["losses"])) and got["losses"][2] < got["losses"][0]
    for other in results[1:]:
        assert other[name]["losses"] == got["losses"]
    _check_params(got["params"], want["final"], want["state_dict"], name)


@pytest.fixture(scope="module")
def flow(tmp_path_factory):
    want = _flow_oracle()
    tmp = str(tmp_path_factory.mktemp("pp_flow"))
    return want, run_ranks(_flow_ranks, 2, tmp_path_factory.mktemp("pp_flow_group"),
                           want["state_dict"], tmp)


def test_train_flow_pp_stages_cli(flow):
    """``train_flow --pp-stages 2 --steps 2 --device cpu`` on 2 ranks: rank
    0 logs the last step, finite, rank 1 writes nothing; the tiny stack has
    2 * 2 self-attends."""
    _, results = flow
    logged = results[0]["cli"]
    assert logged[-1]["step"] == 2 and np.isfinite(logged[-1]["loss"])
    assert [r["layers"] for r in results] == [4, 4]
    assert results[1]["wrote"] is False


def test_train_flow_pp_stages_matches_jax(flow):
    """3 steps of the example's Trainer through the pipeline from JAX's
    weights: JAX's loss trajectory and parameters, the same on both ranks."""
    want, results = flow
    np.testing.assert_allclose(results[0]["losses"], want["losses"], **TOL)
    _check_params(results[0]["params"], want["final"], want["state_dict"], "flow")
    for name, value in results[0]["params"].items():
        np.testing.assert_array_equal(results[1]["params"][name], value, err_msg=name)


@pytest.mark.parametrize("mesh_shape", [(2, 1), (4, 1), (1, 4)])
def test_train_flow_pp_stages_refuses_other_model_axis(mesh_shape):
    """``--mesh D M --pp-stages 2`` with M != 2: the trainer's data axis
    would not be the pipeline mesh's, so setup refuses before any group."""
    from perceiverio_pytorch_tpu_torch.examples import train_flow

    with pytest.raises(ValueError, match="model axis must have 2 ranks"):
        train_flow.setup(2, device="cpu", mesh_shape=mesh_shape, pp_stages=2)
