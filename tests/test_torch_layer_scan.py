"""Policy.layer_scan in the port against the JAX package's scan.

JAX scans the self-attend stack with stacked parameters under "on" (and
"auto" from ``layer_scan_min`` layers), exactly as its unrolled loop.
Eager PyTorch has no scan: every value runs the port's one loop, so "on"
and "auto" equal "off" bit for bit (forward and gradients) and JAX's
scanned MLM at fp32 tolerance; a value outside "off" | "auto" | "on"
raises JAX's ValueError.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from perceiverio_pytorch_tpu import Policy as JaxPolicy
from perceiverio_pytorch_tpu.models import LanguagePerceiver as JaxLanguage
from perceiverio_pytorch_tpu_torch import PARITY, LanguagePerceiver, Policy
from perceiverio_pytorch_tpu_torch.utils.weights import (
    LANGUAGE_OVERRIDES,
    LANGUAGE_TIED,
    state_dict_from_flax,
)

torch.set_num_threads(1)
TOL = dict(rtol=2e-4, atol=2e-5)
SMALL = dict(max_seq_len=32, embed_dim=16, num_self_attends_per_block=3, num_latents=8,
             num_latent_channels=32)
JAX_ON = JaxPolicy(compute_dtype=jnp.float32, attn_impl="xla", layer_scan="on")


@pytest.fixture(scope="module")
def mlm():
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, 262, (2, 32)).astype(np.int32)
    mask = np.ones((2, 32), bool)
    mask[1, 25:] = False
    model = JaxLanguage(**SMALL, policy=JAX_ON)
    variables = jax.jit(model.init)(jax.random.PRNGKey(0), tokens, mask)
    want = np.asarray(jax.jit(model.apply)(variables, tokens, mask))
    sd = state_dict_from_flax(variables, overrides=LANGUAGE_OVERRIDES, tied=LANGUAGE_TIED)
    return tokens, mask, sd, want


def _port(sd, layer_scan, **kw):
    model = LanguagePerceiver(**SMALL, device="cpu",
                              policy=dataclasses.replace(PARITY, layer_scan=layer_scan, **kw))
    model.load_state_dict(sd, strict=True)
    return model.eval()


@pytest.mark.parametrize("layer_scan,kw", [("on", {}), ("auto", dict(layer_scan_min=2)),
                                           ("auto", {})],
                         ids=["on", "auto_engaged", "auto_below_min"])
def test_layer_scan_matches_jax_scan_and_the_loop(mlm, layer_scan, kw):
    tokens, mask, sd, want = mlm
    args = torch.from_numpy(tokens).long(), torch.from_numpy(mask)
    with torch.no_grad():
        got = _port(sd, layer_scan, **kw)(*args).numpy()
        off = _port(sd, "off")(*args).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_array_equal(got, off)


def test_layer_scan_gradients_equal_the_loop(mlm):
    tokens, mask, sd, _ = mlm
    args = torch.from_numpy(tokens).long(), torch.from_numpy(mask)
    grads = {}
    for value in ("on", "off"):
        model = _port(sd, value)
        model(*args).square().mean().backward()
        grads[value] = {n: p.grad for n, p in model.named_parameters()}
    assert grads["on"].keys() == grads["off"].keys()
    for name, grad in grads["on"].items():
        torch.testing.assert_close(grad, grads["off"][name], rtol=0, atol=0)


def test_layer_scan_fields_and_defaults_match_jax():
    assert Policy().layer_scan == JaxPolicy().layer_scan == "off"
    assert Policy().layer_scan_min == JaxPolicy().layer_scan_min == 16


@pytest.mark.parametrize("value", ["bogus", "maybe", "ON", None])
def test_layer_scan_bad_value_raises_as_jax(mlm, value):
    """JAX raises when the stack is applied (``tests/test_layer_scan.py``),
    the port when the Policy is made; the message is JAX's."""
    tokens, mask, _, _ = mlm
    model = JaxLanguage(**SMALL, policy=dataclasses.replace(JAX_ON, layer_scan=value))
    params = jax.jit(JaxLanguage(**SMALL, policy=dataclasses.replace(
        JAX_ON, layer_scan="off")).init)(jax.random.PRNGKey(0), tokens, mask)
    with pytest.raises(ValueError, match="layer_scan") as want:
        jax.eval_shape(model.apply, params, tokens, mask)
    with pytest.raises(ValueError, match="layer_scan") as got:
        Policy(layer_scan=value)
    assert str(got.value) == str(want.value)
