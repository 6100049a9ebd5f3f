"""``examples/evaluate_mlm.py --quant`` of the port against the JAX script's.

Both scripts on the same weights and text, dynamic and static (each
calibrated on its first batch, masked at the seed's draw): the same counts,
and accuracy and cross-entropy within the int8 noise.  Inputs are made with
numpy.
"""

import dataclasses
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from perceiverio_pytorch_tpu import Policy
from perceiverio_pytorch_tpu.models import LanguagePerceiver as JaxLanguage
from perceiverio_pytorch_tpu.training.checkpoint import save_variables as jax_save_variables
from perceiverio_pytorch_tpu.utils.torch_checkpoint import (
    LANGUAGE_OVERRIDES,
    LANGUAGE_TIED,
    save_torch_checkpoint,
)
from perceiverio_pytorch_tpu_torch.examples import evaluate_mlm

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Upstream activation codes flip at rounding ties between the two packages
# (tests/test_torch_quant_models.py), which moves a logit by about 1e-2 of
# the largest; the cross-entropy over 304 masked tokens moves less.
MLM_CE_RTOL = 1e-2
MLM_ACC_ATOL = 0.02


def _jax_script(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(ROOT, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def mlm_weights(tmp_path_factory):
    """The JAX script's small MLM from another seed than the script's: JAX
    weights directories for its dynamic and static models (the latter with
    a zeroed, uncalibrated quant_stats collection: the JAX script cannot
    restore a directory without one into its static model), and the same
    weights as a reference .pth, which the port's static model loads with
    amax 0."""
    tokens = jnp.zeros((1, 256), jnp.int32)
    mask = jnp.ones((1, 256), bool)
    root = tmp_path_factory.mktemp("mlm")
    for mode in ("dynamic", "static"):
        policy = dataclasses.replace(Policy(), quant=f"int8_{mode}")
        model = JaxLanguage(**evaluate_mlm.SMALL, policy=policy)
        variables = jax.jit(model.init)(jax.random.PRNGKey(7), tokens, mask)
        if mode == "static":
            variables = {**variables, "quant_stats": jax.tree_util.tree_map(
                jnp.zeros_like, variables["quant_stats"])}
        jax_save_variables(str(root / mode), variables)
    save_torch_checkpoint(str(root / "mlm.pth"), {"params": variables["params"]},
                          LANGUAGE_OVERRIDES, LANGUAGE_TIED)
    return str(root), str(root / "mlm.pth")


@pytest.mark.parametrize("mode", ["dynamic", "static"])
def test_evaluate_mlm_quant_matches_jax(mlm_weights, mode):
    """The JAX script and the port's on the same weights and text under
    --quant (static: both calibrated on their first batch, masked at the
    seed's draw): the same counts, the numbers within the int8 noise."""
    root, pth = mlm_weights
    want = _jax_script("evaluate_mlm").main(checkpoint=os.path.join(root, mode), batch_size=4,
                                            limit=8, seed=3, quant=mode)
    got = evaluate_mlm.main(torch_checkpoint=pth, batch_size=4, limit=8, seed=3, quant=mode,
                            device="cpu")
    assert (got["sequences"], got["masked_tokens"]) == (want["sequences"],
                                                        want["masked_tokens"])
    np.testing.assert_allclose(got["masked_ce"], want["masked_ce"], rtol=MLM_CE_RTOL)
    np.testing.assert_allclose(got["masked_accuracy"], want["masked_accuracy"],
                               atol=MLM_ACC_ATOL)
