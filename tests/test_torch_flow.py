"""The port's FlowPerceiver and FlowInference against the JAX package's.

At the golden configuration (16x24 tiles, 8 latents x 32 channels, 2
self-attends) with random weights, including a non-zero decoder projection
(it is zero-initialised by design, which would hide the whole decoder).
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from perceiverio_pytorch_tpu import config as jax_config
from perceiverio_pytorch_tpu.models import flow as jax_flow
from perceiverio_pytorch_tpu.utils.torch_checkpoint import export_state_dict
from perceiverio_pytorch_tpu_torch import config as port_config
from perceiverio_pytorch_tpu_torch.models import flow as port_flow
from perceiverio_pytorch_tpu_torch.utils.weights import state_dict_from_flax

torch.set_num_threads(1)
TOL = dict(rtol=2e-4, atol=2e-5)
GOLDEN = os.path.join(os.path.dirname(__file__), "goldens", "flow.npz")
SMALL = dict(img_size=(16, 24), num_latents=8, num_latent_channels=32,
             num_self_attends_per_block=2)


def _jax_variables(model, seed):
    zeros = jnp.zeros((1, 3) + SMALL["img_size"])
    variables = jax.jit(model.init)(jax.random.PRNGKey(seed), zeros, zeros)
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    final = params["perceiver"]["decoder"]["final_layer"]
    final["kernel"] = np.random.default_rng(seed).standard_normal(
        final["kernel"].shape).astype(np.float32) * 0.1
    return {**variables, "params": params}


def _frames(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-1, 1, shape).astype(np.float32),
            rng.uniform(-1, 1, shape).astype(np.float32))


def _port_model(variables, policy):
    model = port_flow.FlowPerceiver(**SMALL, policy=policy, device="cpu")
    model.load_state_dict(state_dict_from_flax(variables), strict=True)
    return model.eval()


@pytest.mark.parametrize("impl", ["dense", "flash"])
def test_flow_perceiver_matches_jax(impl):
    if impl == "dense":
        jax_pol, port_pol = jax_config.PARITY, port_config.PARITY
    else:
        jax_pol = jax_config.Policy(compute_dtype=jnp.float32, attn_impl="flash",
                                    interpret=True)
        port_pol = port_config.Policy(compute_dtype=torch.float32, attn_impl="flash")
    jm = jax_flow.FlowPerceiver(**SMALL, policy=jax_pol)
    variables = _jax_variables(jm, seed=0)
    img1, img2 = _frames((2, 3, 16, 24), seed=1)
    want = np.asarray(jax.jit(jm.apply)(variables, img1, img2))
    assert np.abs(want).max() > 0
    pm = _port_model(variables, port_pol)
    with torch.no_grad():
        got = pm(torch.from_numpy(img1), torch.from_numpy(img2))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_flow_perceiver_bf16_matches_jax():
    """The PERFORMANCE policy (bf16 GEMMs, fp32 LayerNorm and softmax, tanh
    GELU) casts at the same points as JAX's.  Tolerance 5% of max|flow|:
    each framework sums its bf16 products in its own order, and at this size
    JAX's bf16 flow is itself 2.2% of max|flow| away from its fp32 flow."""
    jm = jax_flow.FlowPerceiver(**SMALL, policy=jax_config.PERFORMANCE)
    variables = _jax_variables(jm, seed=0)
    img1, img2 = _frames((2, 3, 16, 24), seed=1)
    want = np.asarray(jax.jit(jm.apply)(variables, img1, img2)).astype(np.float32)
    pm = _port_model(variables, port_config.PERFORMANCE)
    with torch.no_grad():
        got = pm(torch.from_numpy(img1), torch.from_numpy(img2))
    assert got.dtype == torch.bfloat16
    err = np.abs(got.float().numpy() - want).max()
    assert err <= 0.05 * np.abs(want).max(), err


def test_flow_golden_replay():
    z = np.load(GOLDEN)
    meta = json.loads(bytes(z["meta"]).decode())
    kwargs = {k: tuple(v) if isinstance(v, list) else v
              for k, v in meta["kwargs"].items()}
    model = port_flow.FlowPerceiver(**kwargs, policy=port_config.PARITY, device="cpu")
    sd = {k[4:]: torch.from_numpy(z[k].astype(np.float32))
          for k in z.files if k.startswith("sd::")}
    model.load_state_dict(sd, strict=True)  # includes the (1, 0) padding table
    with torch.no_grad():
        out = model(torch.from_numpy(z["in::img1"]), torch.from_numpy(z["in::img2"]))
    np.testing.assert_allclose(out.numpy(), z["out::flow"], **TOL)


@pytest.mark.parametrize("wave_size", [0, 3])
def test_flow_inference_matches_jax(wave_size):
    jm = jax_flow.FlowPerceiver(**SMALL, policy=jax_config.PARITY)
    variables = _jax_variables(jm, seed=2)
    img1, img2 = _frames((1, 3, 20, 40), seed=3)
    want = np.asarray(jax_flow.FlowInference(jm, variables, min_overlap=8)(img1, img2))
    pm = _port_model(variables, port_config.PARITY)
    infer = port_flow.FlowInference(pm, min_overlap=8, wave_size=wave_size, device="cpu")
    got = infer(torch.from_numpy(img1), torch.from_numpy(img2))
    assert got.shape == (1, 2, 20, 40)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize(
    "shape,patch,overlap",
    [((436, 1024), (368, 496), 20), ((20, 40), (16, 24), 8), ((368, 496), (368, 496), 20),
     ((390, 500), (368, 496), 20)],
)
def test_grid_indices_match_jax(shape, patch, overlap):
    got = port_flow.compute_grid_indices(shape, patch, overlap)
    assert got == jax_flow.compute_grid_indices(shape, patch, overlap)
    if shape == (436, 1024):
        assert len(got) == 6  # a Sintel frame is 6 tiles


def test_state_dict_from_flax_matches_export_state_dict():
    jm = jax_flow.FlowPerceiver(**SMALL)
    variables = _jax_variables(jm, seed=4)
    want = export_state_dict(variables)
    got = state_dict_from_flax(variables)
    assert list(got) == list(want)
    for key, value in want.items():
        np.testing.assert_array_equal(got[key].numpy(), value, err_msg=key)
    port_keys = set(port_flow.FlowPerceiver(**SMALL, device="cpu").state_dict())
    assert port_keys == set(got)
