"""The port's multimodal training path against the JAX package's.

``multimodal_autoencode_loss`` with unlabelled examples and partial
weights; the tiny multimodal model's loss and every parameter's gradient
against ``jax.grad`` of the JAX model on the same weights (carried by
``state_dict_from_flax``): on the dense path, through the flash path (the
plain versions of K1, K2 and K3 on the CPU, the Pallas kernels in
interpreter mode in JAX), with the query-pad fold, with remat on and off,
and at 700 classes, where the input is padded to 704 channels and the
encoder's backward runs at head width 704; the example's synthetic clips
and its tiny configuration.  Inputs are made with numpy.
"""

import dataclasses
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from perceiverio_pytorch_tpu import config as jax_config
from perceiverio_pytorch_tpu.models import multimodal as jax_mm
from perceiverio_pytorch_tpu.training import multimodal_autoencode_loss as jax_loss
from perceiverio_pytorch_tpu_torch import config as port_config
from perceiverio_pytorch_tpu_torch.examples import train_multimodal
from perceiverio_pytorch_tpu_torch.models import multimodal as port_mm
from perceiverio_pytorch_tpu_torch.ops import flash_attention as fa
from perceiverio_pytorch_tpu_torch.training import multimodal_autoencode_loss
from perceiverio_pytorch_tpu_torch.utils.weights import state_dict_from_flax

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=2e-4, atol=2e-5)
# The example's tiny configuration (the JAX example's :78-85).
SMALL = dict(train_multimodal.TINY)
N_CHUNKS = 4
WEIGHTS = {"image": 1.0, "audio": 1.0, "label": 0.01}


@pytest.mark.parametrize("weights", [None, {"label": 2.0}, {"image": 0.5, "audio": 3.0}])
@pytest.mark.parametrize("labels", [[3, -1, 0, 7], [-1, -1, -1, -1]])
def test_multimodal_autoencode_loss_matches_jax(weights, labels):
    """MSE of image and audio plus the label cross-entropy over the labelled
    examples only (-1: unlabelled; none labelled gives a zero label term),
    with partial weights defaulting to 1."""
    rng = np.random.default_rng(0)
    outputs = {"image": rng.standard_normal((4, 2, 3, 5, 5), dtype=np.float32),
               "audio": rng.standard_normal((4, 32, 1), dtype=np.float32),
               "label": rng.standard_normal((4, 11), dtype=np.float32) * 3}
    targets = {"image": rng.random((4, 2, 3, 5, 5), dtype=np.float32),
               "audio": rng.uniform(-1, 1, (4, 32, 1)).astype(np.float32),
               "label": np.asarray(labels, np.int32)}
    want = float(jax_loss({k: jnp.asarray(v) for k, v in outputs.items()},
                          {k: jnp.asarray(v) for k, v in targets.items()}, weights))
    got = multimodal_autoencode_loss({k: torch.from_numpy(v) for k, v in outputs.items()},
                                     {k: torch.from_numpy(v) for k, v in targets.items()},
                                     weights)
    np.testing.assert_allclose(got.item(), want, rtol=1e-6)
    only_label = multimodal_autoencode_loss(
        {"label": torch.from_numpy(outputs["label"])},
        {"label": torch.from_numpy(targets["label"])})
    if min(labels) < 0 and max(labels) < 0:
        assert only_label.item() == 0.0
    else:
        assert only_label.item() > 0.0


def _clip(seed, num_classes):
    rng = np.random.default_rng(seed)
    images = rng.random((1, 2, 3, 16, 16), dtype=np.float32)
    audio = rng.uniform(-1, 1, (1, 256, 1)).astype(np.float32)
    labels = np.asarray([num_classes - 2], np.int32)
    return images, audio, labels


def _jax_variables(jm, images, audio, seed):
    """The JAX init's params, every 1-D one moved by seeded noise, so that
    LayerNorm scales and biases and every Dense bias show."""
    variables = jax.jit(lambda k, i, a: jm.init(k, i, a, N_CHUNKS))(
        jax.random.PRNGKey(0), images, audio)
    rng = np.random.default_rng(seed)

    def perturb(x):
        x = np.asarray(x)
        return x if x.ndim != 1 else x + 0.1 * rng.standard_normal(x.shape).astype(np.float32)

    return {**variables, "params": jax.tree_util.tree_map(perturb, variables["params"])}


def _policies(case):
    flash = dict(compute_dtype=jnp.float32, attn_impl="flash", interpret=True)
    port_flash = dict(compute_dtype=torch.float32, attn_impl="flash")
    fold = dict(fold_query_pad=True)
    return {
        "dense": (jax_config.PARITY, port_config.PARITY),
        "flash": (jax_config.Policy(**flash), port_config.Policy(**port_flash)),
        "fold": (dataclasses.replace(jax_config.PARITY, **fold),
                 dataclasses.replace(port_config.PARITY, **fold)),
        "flash_fold": (jax_config.Policy(**flash, **fold),
                       port_config.Policy(**port_flash, **fold)),
    }[case]


@pytest.mark.parametrize(
    "case,remat,num_classes",
    [("dense", False, 11), ("flash", False, 11), ("flash_fold", True, 11),
     ("flash", True, 700)],
)
def test_multimodal_gradients_match_jax(case, remat, num_classes):
    """The example's weighted loss and every parameter's gradient against
    jax.grad of the JAX model on the same weights.  At 700 classes the
    input is padded to 704 channels: the encoder's cross-attend runs the
    backward at head width 704 (the plain K2/K3 against the Pallas dKV/dQ
    sweeps in interpreter mode)."""
    jax_pol, port_pol = _policies(case)
    cfg = dict(SMALL, num_classes=num_classes)
    jm = jax_mm.MultiModalPerceiver(policy=jax_pol, remat=remat, **cfg)
    images, audio, labels = _clip(1, num_classes)
    variables = _jax_variables(jm, images, audio, seed=2)
    targets = {"image": images, "audio": audio, "label": labels}

    def loss(params):
        out = jm.apply({**variables, "params": params}, images, audio, N_CHUNKS)
        return jax_loss(out, targets, weights=WEIGHTS)

    want_loss, grads = jax.jit(jax.value_and_grad(loss))(variables["params"])
    want = state_dict_from_flax({"params": grads})

    pm = port_mm.MultiModalPerceiver(**cfg, policy=port_pol, remat=remat, device="cpu")
    pm.load_state_dict(state_dict_from_flax(variables), strict=True)
    pm.train()
    before = (fa.LAUNCHES, fa.LAUNCHES_BWD_DKV, fa.LAUNCHES_BWD_DQ)
    got_loss = train_multimodal.loss_fn(
        pm, *(torch.from_numpy(x) for x in (images, audio, labels)), n_chunks=N_CHUNKS)
    got_loss.backward()
    assert (fa.LAUNCHES, fa.LAUNCHES_BWD_DKV, fa.LAUNCHES_BWD_DQ) == before
    np.testing.assert_allclose(got_loss.item(), float(want_loss), **TOL)
    names = dict(pm.named_parameters())
    assert set(names) == set(want)
    for name, param in names.items():
        grad = (torch.zeros_like(param) if param.grad is None else param.grad).numpy()
        # atol scales with a gradient's max above 1: the latent array's
        # (max |g| about 1.9) sums every path through the model, and the two
        # frameworks' fp32 sums differ there by up to 2.5e-5 of that max, on
        # the dense path as on the flash one.
        peak = max(1.0, float(np.abs(want[name].numpy()).max()))
        np.testing.assert_allclose(grad, want[name].numpy(), err_msg=name,
                                   rtol=TOL["rtol"], atol=TOL["atol"] * peak)
    # The gradient reaches the encoder's 704-wide (at 700 classes) key
    # projection, the query pad and the decoder's query projection (through
    # the fold's LayerNorm where it is on).
    for name in ("perceiver._encoder.cross_attend.attention.proj_k.weight",
                 "perceiver.padding_embeddings.image.pos_embs",
                 "perceiver._decoder.decoding_cross_attn.attention.proj_q.weight",
                 "perceiver._decoder.decoding_cross_attn.layer_norm_q.weight"):
        assert names[name].grad.abs().max() > 0, name
    if num_classes == 700:
        assert names["perceiver._encoder.cross_attend.attention.proj_k.weight"].shape[1] == 704


def test_remat_leaves_the_gradients_unchanged():
    """The port's remat (the self-attend stack and each chunk's decode
    recomputed in the backward) changes no loss or gradient, with the fold
    on, through the flash path."""
    images, audio, labels = (torch.from_numpy(x) for x in _clip(3, 11))
    grads = {}
    for remat in (False, True):
        model = port_mm.MultiModalPerceiver(
            **SMALL, remat=remat, device="cpu", generator=torch.Generator().manual_seed(4),
            policy=port_config.Policy(compute_dtype=torch.float32, attn_impl="flash",
                                      fold_query_pad=True))
        loss = train_multimodal.loss_fn(model, images, audio, labels, n_chunks=N_CHUNKS)
        loss.backward()
        grads[remat] = (loss.item(), {n: p.grad.clone() for n, p in model.named_parameters()
                                      if p.grad is not None})
    assert grads[True][0] == grads[False][0]
    assert set(grads[True][1]) == set(grads[False][1])
    for name, want in grads[False][1].items():
        torch.testing.assert_close(grads[True][1][name], want, rtol=1e-6, atol=1e-7,
                                   msg=name)


def test_synthetic_clips_match_jax_example():
    spec = importlib.util.spec_from_file_location(
        "jax_train_multimodal", os.path.join(ROOT, "examples", "train_multimodal.py"))
    jax_example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_example)
    for args in ((4, 2, (16, 16), 256, 11), (3, 4, (10, 13), 100, 700)):
        want = jax_example.synthetic_clips(*args)
        got = train_multimodal.synthetic_clips(*args)
        for x, y in zip(got, want):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)


def test_train_multimodal_example_tiny_on_cpu(tmp_path):
    """The tiny configuration trains on the CPU: the loss over all four
    synthetic clips falls, and no kernel is launched."""
    path = tmp_path / "multimodal_metrics.jsonl"
    trainer, state, batches = train_multimodal.setup(
        12, device="cpu", metrics_path=str(path), log_every=1)
    clips = train_multimodal.synthetic_clips(4, 2, (16, 16), 256, 11)
    video, audio, labels = (torch.from_numpy(x) for x in clips)

    def loss_all():
        with torch.no_grad():
            return train_multimodal.loss_fn(state.model, video, audio, labels).item()

    before_loss = loss_all()
    launches = (fa.LAUNCHES, fa.LAUNCHES_BWD_DKV, fa.LAUNCHES_BWD_DQ)
    state = trainer.fit(state, batches, num_steps=12)
    assert state.step == 12
    assert loss_all() < before_loss
    with open(path) as f:
        logged = [json.loads(line) for line in f]
    assert [x["step"] for x in logged] == list(range(1, 13))
    assert all(np.isfinite(x["loss"]) for x in logged)
    assert (fa.LAUNCHES, fa.LAUNCHES_BWD_DKV, fa.LAUNCHES_BWD_DQ) == launches


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a GPU")


def test_train_multimodal_example_defaults_to_cuda(no_cuda, tmp_path):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_multimodal.main(steps=1, metrics_path=str(tmp_path / "m.jsonl"))
