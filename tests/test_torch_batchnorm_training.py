"""Train-mode BatchNorm of the port's convnet classifier against flax.

``Conv2DDownsample`` and the whole convnet classifier in train mode against
the JAX package's ``train=True`` / ``deterministic=False`` apply with
``mutable=["batch_stats"]``: outputs, gradients and the updated running
averages (flax's biased batch variance, where torch's own update takes the
unbiased one); fp32 statistics for a bf16 input; one update of the running
averages per train step under remat; and ``Trainer.evaluate`` on the
running averages, in eval mode.  Inputs are made with numpy.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from perceiverio_pytorch_tpu import config as jax_config
from perceiverio_pytorch_tpu.io_processors import processor_utils as jax_pu
from perceiverio_pytorch_tpu_torch import config as port_config
from perceiverio_pytorch_tpu_torch.examples import train_classification
from perceiverio_pytorch_tpu_torch.io_processors import processor_utils as port_pu
from perceiverio_pytorch_tpu_torch.models import classification as port_cls
from perceiverio_pytorch_tpu_torch.training import build_optimizer
from perceiverio_pytorch_tpu_torch.utils.weights import state_dict_from_flax
from test_torch_classification_training import (
    CONVNET,
    SMALL,
    TOL,
    _assert_grads,
    _images,
    _jax_grads,
    _jax_variables,
    _labels,
    _perturbed,
    _port_model,
)

torch.set_num_threads(1)


def _check_running_averages(port_sd, old, new, names, counts):
    """The running averages of ``names`` after one train step against flax's
    (``new``, from ``old``), compared in the batch's part of the update,
    (new - 0.9 old) / 0.1: the batch mean and the biased batch variance.
    torch's own update, with the unbiased variance, would miss it by a
    factor of N / (N - 1) over the ``counts`` (N) values of a channel."""
    for name, n in zip(names, counts):
        for suffix in ("running_mean", "running_var"):
            key = f"{name}.{suffix}"
            got = (port_sd[key].numpy() - 0.9 * old[key].numpy()) / 0.1
            want = (new[key].numpy() - 0.9 * old[key].numpy()) / 0.1
            np.testing.assert_allclose(got, want, err_msg=key, **TOL)
            if suffix == "running_var":
                assert not np.allclose(got * n / (n - 1), want, **TOL)
        assert int(port_sd[f"{name}.num_batches_tracked"]) == 1


@pytest.mark.parametrize("num_layers", [1, 2])
def test_conv2d_downsample_train_mode_matches_flax(num_layers):
    """Train mode against flax's ``train=True`` with ``mutable=["batch_stats"]``
    at 33x47, batch 2: the output, the updated running mean and variance
    (flax's biased batch variance) and the input's and parameters' gradients
    of a weighted sum of the output."""
    x = _images(3, (2, 33, 47, 3)) * 30  # batch variances of order 1 after the 0.01 convs
    jm = jax_pu.Conv2DDownsample(num_layers=num_layers, num_channels=8)
    variables = _perturbed(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)), seed=4)
    weights = np.random.default_rng(5).standard_normal(
        (2, 9, 12, 8) if num_layers == 1 else (2, 3, 3, 8)).astype(np.float32)

    def loss(params, inputs):
        out, mutated = jm.apply({**variables, "params": params}, inputs, train=True,
                                mutable=["batch_stats"])
        return jnp.sum(out * weights), (out, mutated)

    (_, (want, mutated)), (grads, grad_x) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(variables["params"], jnp.asarray(x))
    pm = port_pu.Conv2DDownsample(num_layers=num_layers, in_channels=3, num_channels=8)
    pm.load_state_dict(state_dict_from_flax(variables), strict=True)
    pm.train()
    inputs = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()
    got = pm(inputs).permute(0, 2, 3, 1)
    (got * torch.from_numpy(weights)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    # The convs' outputs: 17x24, then 5x6 (after the first layer's pool).
    _check_running_averages(pm.state_dict(), state_dict_from_flax(variables),
                            state_dict_from_flax({"params": variables["params"], **mutated}),
                            [f"norms.{i}" for i in range(num_layers)], [2 * 17 * 24, 2 * 5 * 6])
    np.testing.assert_allclose(inputs.grad.permute(0, 2, 3, 1).numpy(), np.asarray(grad_x),
                               **TOL)
    _assert_grads(pm, state_dict_from_flax({"params": grads}))


def test_batchnorm_returns_fp32_and_keeps_fp32_statistics():
    """A bf16 input (the conv output under a bf16 policy) is normalised in
    fp32, in both modes, and the running averages stay fp32."""
    bn = port_pu.BatchNorm2d(4, eps=1e-5, momentum=0.1)
    x = torch.from_numpy(_images(6, (2, 4, 5, 7)))
    want = bn(x)
    bn.running_mean.zero_(), bn.running_var.fill_(1.0), bn.num_batches_tracked.zero_()
    got = bn(x.bfloat16())
    assert got.dtype == want.dtype == bn.running_var.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=2e-2, atol=2e-2)
    assert bn.eval()(x.bfloat16()).dtype == torch.float32


@pytest.mark.parametrize("option", [dict(momentum=None), dict(affine=False),
                                    dict(track_running_stats=False)])
def test_batchnorm_refuses_options_its_update_does_not_honour(option):
    """The train-mode update needs a float momentum, the affine parameters
    and the running buffers: any other configuration raises at build time."""
    with pytest.raises(ValueError, match="BatchNorm2d takes"):
        port_pu.BatchNorm2d(4, **option)


def test_convnet_classifier_train_mode_matches_jax():
    """The whole convnet classifier in train mode against JAX's
    ``deterministic=False`` apply with mutable batch_stats, at the size where
    torch's unbiased update would miss (batch 2 at 32x32: 512 values a
    channel, a factor 512/511): the loss, every gradient, and the new
    running averages against the mutated batch_stats."""
    prep = "FOURIER_POS_CONVNET"
    variables = _jax_variables(prep, 0)
    img, labels = _images(7) * 30, _labels(8)  # batch variances of order 1
    want_loss, want, mutated = _jax_grads(prep, jax_config.PARITY, variables, img, labels,
                                          train=True)
    model = _port_model(variables, prep, port_config.PARITY).train()
    loss = train_classification.loss_fn(model, torch.from_numpy(img), torch.from_numpy(labels))
    loss.backward()
    np.testing.assert_allclose(loss.item(), want_loss, **TOL)
    _assert_grads(model, want)
    _check_running_averages(model.state_dict(), state_dict_from_flax(variables),
                            state_dict_from_flax({"params": variables["params"], **mutated}),
                            [f"{CONVNET}.norms.0"], [2 * 16 * 16])


@pytest.mark.parametrize("remat", [False, True])
def test_one_train_step_updates_the_running_averages_once(remat):
    """The convnet sits in the preprocessor, outside the remat checkpoint
    (the self-attend stack): a train step with remat moves the running
    averages by momentum 0.1 exactly once, as the convnet alone does."""
    model = port_cls.ClassificationPerceiver(
        prep_type=port_cls.PrepType.FOURIER_POS_CONVNET, remat=remat, device="cpu",
        generator=torch.Generator().manual_seed(9), **SMALL)
    convnet = port_pu.Conv2DDownsample(num_layers=1, in_channels=3, num_channels=64)
    convnet.load_state_dict(model.get_submodule(CONVNET).state_dict())
    img, labels = torch.from_numpy(_images(10)), torch.from_numpy(_labels(11))
    trainer = train_classification.Trainer(train_classification.loss_fn, build_optimizer(1e-3),
                                           log_every=0)
    state = trainer.init_state(model)
    trainer.fit(state, [(img, labels)], num_steps=1)
    convnet.train()(img)
    bn = model.get_submodule(CONVNET).norms[0]
    assert int(bn.num_batches_tracked) == 1
    assert torch.equal(bn.running_mean, convnet.norms[0].running_mean)
    assert torch.equal(bn.running_var, convnet.norms[0].running_var)
    assert bn.running_var.sub(1.0).abs().max() > 1e-3


def test_evaluate_uses_the_running_averages():
    """``Trainer.evaluate`` with the example's eval_fn: the model in eval
    mode (BatchNorm on its running averages, which stay as they are), back
    in train mode afterwards; the means over two batches."""
    trainer, state, batches, eval_batches = train_classification.setup(
        4, batch_size=2, device="cpu", metrics_path=None, log_every=0)
    assert eval_batches is None
    model = state.model
    stream = batches()
    trainer.fit(state, stream, num_steps=2)
    held = [next(stream) for _ in range(2)]
    bn = model.get_submodule(CONVNET).norms[0]
    stats = (bn.running_mean.clone(), bn.running_var.clone())
    model.train()
    got = trainer.evaluate(state, held)
    assert model.training and set(got) == {"eval_loss", "eval_top1"}
    assert torch.equal(bn.running_mean, stats[0]) and torch.equal(bn.running_var, stats[1])
    model.eval()
    with torch.no_grad():
        want = [train_classification.eval_fn(model, *b) for b in held]
    model.train()
    np.testing.assert_allclose(got["eval_loss"], np.mean([w["eval_loss"].item() for w in want]),
                               rtol=1e-6)
    np.testing.assert_allclose(got["eval_top1"], np.mean([w["eval_top1"].item() for w in want]),
                               rtol=1e-6)
