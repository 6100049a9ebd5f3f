"""Sharded train steps of the convnet classifier in train-mode BatchNorm
against JAX's single-device train step: the batch statistics are the global
batch's under a data axis (``processor_utils.BatchNorm2d``), so the losses,
the parameters and the running averages equal JAX's loss, parameters and
batch_stats.  The runs, the data and the checks are
``test_torch_parallel_train.py``'s."""

import pytest
import torch

from test_torch_parallel_train import check_sharded_runs, oracle

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def cls_oracle():
    return oracle("cls")


@pytest.mark.parametrize("world", [2, 4])
def test_convnet_sharded_steps_match_jax_single_device(cls_oracle, world, tmp_path):
    """DP, TP and FSDP (2 ranks), DP+TP and FSDP+TP (4 ranks); the running
    averages are among the state_dict entries compared."""
    results = check_sharded_runs(cls_oracle, world, tmp_path)
    full = results[0][("cls", (2, 2) if world == 4 else (2, 1), False)]["full"]
    assert sum(name.endswith("running_var") for name in full) == 1
