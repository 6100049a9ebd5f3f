"""The port's ImageNet classification training path against the JAX
package's.

``classification_cross_entropy`` with and without label smoothing; every
parameter's gradient of each tiny ``PrepType`` under it against ``jax.grad``
of the JAX model on the same weights, with eval-mode BatchNorm (JAX
``deterministic=True``), and for the pixel variant through the plain
K1/K2/K3 at head width 261 (Pallas in interpreter mode in JAX); the replay
of ``tests/goldens/classification_convnet_grads.npz``; the launch plans of
the full-width encoders' forward and backward at the training batch of 8;
and the example's synthetic images and tiny configuration.  Train-mode
BatchNorm is in ``tests/test_torch_batchnorm_training.py``.  Inputs are made
with numpy.
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
from perceiverio_pytorch_tpu.models import classification as jax_cls
from perceiverio_pytorch_tpu.training import classification_cross_entropy as jax_ce
from perceiverio_pytorch_tpu_torch import config as port_config
from perceiverio_pytorch_tpu_torch.examples import train_classification
from perceiverio_pytorch_tpu_torch.models import classification as port_cls
from perceiverio_pytorch_tpu_torch.ops import flash_attention as fa
from perceiverio_pytorch_tpu_torch.training import classification_cross_entropy
from perceiverio_pytorch_tpu_torch.utils.weights import state_dict_from_flax

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=2e-4, atol=2e-5)
# The golden configuration (tests/make_goldens.py `classification`).
SMALL = dict(num_classes=7, img_size=(32, 32), num_self_attends_per_block=2, num_blocks=2,
             num_latents=8, num_latent_channels=32)
PREPS = ["FOURIER_POS_CONVNET", "LEARNED_POS_1X1CONV", "FOURIER_POS_PIXEL"]
CONVNET = "perceiver._multi_preprocessor._preprocessors.__default.convnet"


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_classification_cross_entropy_matches_jax(smoothing):
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((5, 7), dtype=np.float32) * 3
    labels = rng.integers(0, 7, 5).astype(np.int32)
    want = float(jax_ce(jnp.asarray(logits), jnp.asarray(labels), smoothing))
    got = classification_cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                                       smoothing)
    np.testing.assert_allclose(got.item(), want, rtol=1e-6)
    low = classification_cross_entropy(torch.from_numpy(logits).bfloat16(),
                                       torch.from_numpy(labels), smoothing)
    assert low.dtype == torch.float32  # taken in fp32


def _perturbed(variables, seed, scale=0.1):
    """The JAX init's variables with seeded noise: the 1-D parameters move
    off 1 and 0, the BatchNorm means off 0 and the variances into
    [0.5, 1.5]."""
    rng = np.random.default_rng(seed)

    def perturb(x):
        x = np.asarray(x)
        return x if x.ndim != 1 else x + scale * rng.standard_normal(x.shape).astype(np.float32)

    out = {**variables, "params": jax.tree_util.tree_map(perturb, variables["params"])}
    if "batch_stats" in variables:
        def stats(path, x):
            x = np.asarray(x)
            if path[-1].key == "var":
                return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
            return rng.standard_normal(x.shape).astype(np.float32) * 0.3
        out["batch_stats"] = jax.tree_util.tree_map_with_path(stats, variables["batch_stats"])
    return out


def _images(seed, shape=(2, 3, 32, 32)):
    return np.random.default_rng(seed).standard_normal(shape, dtype=np.float32)


def _labels(seed, n=2):
    return np.random.default_rng(seed).integers(0, SMALL["num_classes"], n).astype(np.int32)


def _policies(impl):
    if impl == "dense":
        return jax_config.PARITY, port_config.PARITY
    return (jax_config.Policy(compute_dtype=jnp.float32, attn_impl="flash", interpret=True),
            dataclasses.replace(port_config.PARITY, attn_impl="flash"))


def _jax_model(prep, policy):
    return jax_cls.ClassificationPerceiver(prep_type=jax_cls.PrepType[prep], policy=policy,
                                           **SMALL)


def _jax_variables(prep, seed):
    jm = _jax_model(prep, jax_config.PARITY)
    variables = jax.jit(jm.init)(jax.random.PRNGKey(seed), jnp.zeros((1, 3, 32, 32)))
    return _perturbed(jax.tree_util.tree_map(np.asarray, variables), seed=10 + seed)


def _port_model(variables, prep, policy, **kw):
    model = port_cls.ClassificationPerceiver(prep_type=port_cls.PrepType[prep], policy=policy,
                                             device="cpu", **SMALL, **kw)
    model.load_state_dict(state_dict_from_flax(variables), strict=True)
    return model


def _assert_grads(model, want):
    """Every parameter's gradient against the state_dict of gradients
    ``want``; atol scales with a gradient's max above 1."""
    names = dict(model.named_parameters())
    assert set(names) <= set(want)
    for name, param in names.items():
        grad = (torch.zeros_like(param) if param.grad is None else param.grad).numpy()
        ref = np.asarray(want[name])
        peak = max(1.0, float(np.abs(ref).max(initial=0.0)))
        np.testing.assert_allclose(grad, ref, err_msg=name, rtol=TOL["rtol"],
                                   atol=TOL["atol"] * peak)


def _jax_grads(prep, policy, variables, img, labels, train):
    """Loss, gradients (as a state_dict) and, in train mode, the mutated
    batch_stats of the JAX model."""
    jm = _jax_model(prep, policy)

    def loss(params):
        v = {**variables, "params": params}
        if train:
            logits, mutated = jm.apply(v, img, deterministic=False, mutable=["batch_stats"])
            return jax_ce(logits, labels), mutated
        return jax_ce(jm.apply(v, img), labels), {}

    (value, mutated), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        variables["params"])
    return float(value), state_dict_from_flax({"params": grads}), mutated


@pytest.mark.parametrize("prep,impl", [(p, "dense") for p in PREPS]
                         + [("FOURIER_POS_PIXEL", "flash")])
def test_classification_gradients_match_jax(prep, impl):
    """The cross-entropy and every parameter's gradient of each PrepType,
    eval-mode BatchNorm (JAX's deterministic default), single-query decode;
    the pixel variant also with every site through the plain K1, K2 and K3
    (the Pallas kernels in interpreter mode): its encoder attends 8 latents
    to 1,024 tokens of the odd width 261 (3 + 258), forward and backward."""
    variables = _jax_variables(prep, PREPS.index(prep))
    img, labels = _images(1), _labels(2)
    jax_pol, port_pol = _policies(impl)
    want_loss, want, _ = _jax_grads(prep, jax_pol, variables, img, labels, train=False)
    model = _port_model(variables, prep, port_pol).eval()
    if prep == "FOURIER_POS_PIXEL":
        assert model.perceiver._multi_preprocessor.n_output_channels() == 261
    before = (fa.LAUNCHES, fa.LAUNCHES_BWD_DKV, fa.LAUNCHES_BWD_DQ)
    loss = train_classification.loss_fn(model, torch.from_numpy(img), torch.from_numpy(labels))
    loss.backward()
    assert (fa.LAUNCHES, fa.LAUNCHES_BWD_DKV, fa.LAUNCHES_BWD_DQ) == before  # plain on the CPU
    np.testing.assert_allclose(loss.item(), want_loss, **TOL)
    _assert_grads(model, want)
    names = dict(model.named_parameters())
    encoder_k = names["perceiver._encoder.cross_attend.attention.proj_k.weight"]
    assert encoder_k.grad.abs().max() > 0


def test_classification_gradient_golden_replay():
    """tests/goldens/classification_convnet_grads.npz (eval-mode BatchNorm,
    MSE of the logits against a random target): the weights load strictly,
    the loss and every gradient replay."""
    z = np.load(os.path.join(ROOT, "tests", "goldens", "classification_convnet_grads.npz"))
    kwargs = {k: tuple(v) if isinstance(v, list) else v
              for k, v in json.loads(bytes(z["meta"]).decode())["kwargs"].items()}
    sd = {k[4:]: torch.from_numpy(z[k].astype(np.float32) if z[k].dtype == np.float16 else z[k])
          for k in z.files if k.startswith("sd::")}
    want = {k[6:]: z[k] for k in z.files if k.startswith("grad::")}
    model = port_cls.ClassificationPerceiver(
        **kwargs, prep_type=port_cls.PrepType.FOURIER_POS_CONVNET, device="cpu")
    model.load_state_dict(sd, strict=True)
    model.eval()
    logits = model(torch.from_numpy(z["in::img"]))
    loss = ((logits - torch.from_numpy(z["in::target"])) ** 2).mean()
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(z["out::loss"]), rtol=1e-5)
    _assert_grads(model, want)
    assert model.get_parameter(f"{CONVNET}.convs.0.weight").grad.abs().max() > 0


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("width", [261, 512])
def test_launch_plans_at_the_classification_training_batch(width, dtype):
    """The pixel (d = 261) and 1x1-conv (d = 512) encoders at the training
    batch of 8 (512 latents x 50,176 keys, one head): the bf16 K1 takes the
    long-KV route, 2 key splits (128 blocks) and a merge, after a copy of q,
    k and v into 16-byte aligned rows at 261; the fp32 K1 splits the keys
    in 4 (256 blocks) and merges; the bf16 K2 takes the long-KV route, 132
    persistent blocks over 12,544 blocks of 32 keys in one split, after a
    copy of q, dO, k and v into 16-byte aligned rows at 261 (522-byte
    rows); the bf16 K3 the long-KV route too, 2 key splits (128 blocks of
    64 query rows) and a sum, reading K2's copies; the fp32 K2 12,544
    blocks of 32 keys, the fp32 K3 64 blocks, neither split.  So a step
    makes K1 1 + merge 1 (+ 3 copies in bf16 at 261), K2 1 (+ 4 copies in
    bf16 at 261), K3 1 (+ sum 1 in bf16)."""
    q = torch.empty(8, 512, 1, width, device="meta", dtype=dtype)
    k = torch.empty(8, 50176, 1, width, device="meta", dtype=dtype)
    bf16 = dtype == torch.bfloat16
    fwd = fa.launch_plan(q, k, k)
    assert fwd["route"] == ("sm90_longkv" if bf16 else "cuda_cores")
    assert (fwd["splits"], fwd["col_chunks"], fwd["blocks"], fwd["cuda_launches"]) == (
        (2, 1, 128, 2 + 3 * (width == 261)) if bf16 else (4, 1, 256, 2))
    bwd = fa.backward_plan(q, k, k)
    assert bwd["route"] == ("sm90_longkv" if bf16 else "cuda_cores")
    dkv, dq = bwd["dkv"], bwd["dq"]
    assert (dkv["splits"], dkv["col_chunks"], dkv["blocks"], dkv["cuda_launches"]) == (
        (1, 1, 132, 5 if width == 261 else 1) if bf16 else (1, 1, 12544, 1))
    if bf16:
        assert dkv["items"] == 12544
    assert (dq["splits"], dq["col_chunks"], dq["blocks"], dq["cuda_launches"]) == (
        (2, 1, 128, 2) if bf16 else (1, 1, 64, 1))
    if bf16:
        assert (dkv["tiles_per_split"], dq["tiles_per_split"]) == (8, 392)


def _jax_example():
    spec = importlib.util.spec_from_file_location(
        "jax_train_classification", os.path.join(ROOT, "examples", "train_classification.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_synthetic_quadrants_match_jax_example():
    jax_example = _jax_example()
    for args, kw in (((64, (32, 32), 4), {}), ((64, (224, 224), 1000), {}),
                     ((5, (10, 13), 3), dict(seed=2))):
        want = jax_example.synthetic_quadrants(*args, **kw)
        got = train_classification.synthetic_quadrants(*args, **kw)
        for x, y in zip(got, want):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)


def test_train_classification_example_tiny_on_cpu(tmp_path):
    """Three steps of the tiny configuration (the convnet): finite losses,
    the running averages moved, and no kernel launch."""
    path = tmp_path / "classification_metrics.jsonl"
    launches = (fa.LAUNCHES, fa.LAUNCHES_BWD_DKV, fa.LAUNCHES_BWD_DQ)
    state = train_classification.main(steps=3, device="cpu", metrics_path=str(path))
    assert state.step == 3
    with open(path) as f:
        logged = [json.loads(line) for line in f]
    assert logged[-1]["step"] == 3 and np.isfinite(logged[-1]["loss"])
    bn = state.model.get_submodule(CONVNET).norms[0]
    assert int(bn.num_batches_tracked) == 3
    assert bn.running_mean.abs().max() > 0 and (bn.running_var - 1).abs().max() > 0
    assert (fa.LAUNCHES, fa.LAUNCHES_BWD_DKV, fa.LAUNCHES_BWD_DQ) == launches


@pytest.mark.parametrize("prep", ["LEARNED_POS_1X1CONV", "FOURIER_POS_PIXEL"])
def test_train_classification_setup_takes_the_prep_type(prep):
    """``setup(prep_type=...)`` trains the other variants through the same
    Trainer, loss and optimizer."""
    trainer, state, batches, _ = train_classification.setup(
        2, batch_size=2, prep_type=port_cls.PrepType[prep], device="cpu", metrics_path=None,
        log_every=0)
    assert state.model.prep_type == port_cls.PrepType[prep]
    state = trainer.fit(state, batches, num_steps=2)
    assert state.step == 2


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a GPU")


def test_train_classification_example_defaults_to_cuda(no_cuda, tmp_path):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_classification.main(steps=1, metrics_path=str(tmp_path / "m.jsonl"))
