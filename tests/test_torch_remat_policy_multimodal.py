"""``Policy.remat_policy`` at the multimodal model's two checkpointed
regions (the encoder's self-attend stack and each chunk's decode), against
the JAX model under the same policy.

The example's tiny configuration with ``remat=True`` under every name the
port takes: the weighted loss and each parameter's gradient against
``jax.grad`` (rtol 2e-4, atol 2e-5, the atol scaled by a gradient's peak as
in ``test_torch_multimodal_training.py``).  Under ``dots_saveable`` the
backward runs as many products as one without remat: neither region reruns
one, so the policy reaches both.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax

from perceiverio_pytorch_tpu import config as jax_config
from perceiverio_pytorch_tpu.models import multimodal as jax_mm
from perceiverio_pytorch_tpu.training import multimodal_autoencode_loss as jax_loss
from perceiverio_pytorch_tpu_torch import config as port_config
from perceiverio_pytorch_tpu_torch.examples import train_multimodal
from perceiverio_pytorch_tpu_torch.models import multimodal as port_mm
from perceiverio_pytorch_tpu_torch.utils.weights import state_dict_from_flax
from test_torch_remat_policy import OpCounts

torch.set_num_threads(1)
TOL = dict(rtol=2e-4, atol=2e-5)
SMALL = dict(train_multimodal.TINY)
N_CHUNKS = 4


def _clip(seed):
    rng = np.random.default_rng(seed)
    images = rng.random((1, 2, 3, 16, 16), dtype=np.float32)
    audio = rng.uniform(-1, 1, (1, 256, 1)).astype(np.float32)
    return images, audio, np.asarray([5], np.int32)


def _port(remat, name, variables=None, fold=False):
    pm = port_mm.MultiModalPerceiver(
        **SMALL, remat=remat, device="cpu", generator=torch.Generator().manual_seed(2),
        policy=dataclasses.replace(port_config.PARITY, remat_policy=name,
                                   fold_query_pad=fold))
    if variables is not None:
        pm.load_state_dict(state_dict_from_flax(variables), strict=True)
    return pm.train()


_JAX = {}  # jax.checkpoint_policies function -> (variables, loss, gradients)


def _jax_gradients(name, images, audio, labels):
    """The JAX model's loss and gradients under ``name``; an alias
    (``checkpoint_dots``) is the same function as its name, computed once."""
    key = getattr(jax.checkpoint_policies, name)
    if key not in _JAX:
        jm = jax_mm.MultiModalPerceiver(
            **SMALL, remat=True,
            policy=dataclasses.replace(jax_config.PARITY, remat_policy=name))
        variables = jax.jit(lambda k, i, a: jm.init(k, i, a, N_CHUNKS))(
            jax.random.PRNGKey(0), images, audio)
        targets = {"image": images, "audio": audio, "label": labels}

        def loss(params):
            out = jm.apply({**variables, "params": params}, images, audio, N_CHUNKS)
            return jax_loss(out, targets, weights=train_multimodal.WEIGHTS)

        want_loss, grads = jax.jit(jax.value_and_grad(loss))(variables["params"])
        _JAX[key] = variables, want_loss, state_dict_from_flax({"params": grads})
    return _JAX[key]


@pytest.mark.parametrize("name", sorted(port_config.REMAT_POLICIES))
def test_multimodal_gradients_under_remat_policy_match_jax(name):
    images, audio, labels = _clip(1)
    variables, want_loss, want = _jax_gradients(name, images, audio, labels)
    pm = _port(True, name, variables)
    got_loss = train_multimodal.loss_fn(
        pm, *(torch.from_numpy(x) for x in (images, audio, labels)), n_chunks=N_CHUNKS)
    got_loss.backward()
    np.testing.assert_allclose(got_loss.item(), float(want_loss), **TOL)
    for pname, p in pm.named_parameters():
        grad = (torch.zeros_like(p) if p.grad is None else p.grad).numpy()
        peak = max(1.0, float(np.abs(want[pname].numpy()).max()))
        np.testing.assert_allclose(grad, want[pname].numpy(), err_msg=pname,
                                   rtol=TOL["rtol"], atol=TOL["atol"] * peak)


@pytest.mark.parametrize("fold", [False, True])
def test_dots_saveable_reaches_both_regions(fold):
    """With and without the query-pad fold (PERFORMANCE's), whose row-vector
    products are kept too: the backward reruns no product, and the
    gradients equal those without remat bit for bit."""
    images, audio, labels = (torch.from_numpy(x) for x in _clip(2))
    counts, grads = {}, {}
    for remat, name in ((False, None), (True, "dots_saveable"), (True, None)):
        pm = _port(remat, name, fold=fold)
        loss = train_multimodal.loss_fn(pm, images, audio, labels, n_chunks=N_CHUNKS)
        with OpCounts() as c:
            loss.backward()
        counts[(remat, name)] = c.products()
        grads[(remat, name)] = {n: p.grad for n, p in pm.named_parameters()
                                if p.grad is not None}
    assert counts[(True, "dots_saveable")] == counts[(False, None)]
    assert counts[(True, None)] > counts[(False, None)]
    for n, g in grads[(False, None)].items():
        assert torch.equal(grads[(True, "dots_saveable")][n], g), n
