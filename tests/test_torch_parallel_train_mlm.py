"""Sharded train steps of the byte MLM against JAX's single-device train
step, with unequal mask counts on the data ranks: the masked cross-entropy
takes the global count as its denominator (``training/losses.py``).  The
runs, the data and the checks are ``test_torch_parallel_train.py``'s."""

import pytest
import torch

from test_torch_parallel_train import check_sharded_runs, oracle

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def mlm_oracle():
    return oracle("mlm")


@pytest.mark.parametrize("world", [2, 4])
def test_mlm_sharded_steps_match_jax_single_device(mlm_oracle, world, tmp_path):
    """DP, TP and FSDP (2 ranks), DP+TP and FSDP+TP (4 ranks); the tied token
    table is one parameter (FSDP splits it once, its gradient sums its two
    uses)."""
    check_sharded_runs(mlm_oracle, world, tmp_path)
