"""The port's classification slice against the JAX package's.

Module by module (the TF-SAME shape arithmetic, ``Conv2DDownsample`` with
non-trivial BatchNorm statistics in eval mode at an odd, non-square size,
the conv and 1x1-conv image preprocessors, the extra position MLP in the
image and audio preprocessors), then the whole ``ClassificationPerceiver``
in each ``PrepType`` at the golden configuration (32x32 images, 7 classes,
8 latents x 32, 2 blocks of 2 self-attends): against the JAX model with
random weights carried by ``state_dict_from_flax``, and against the three
``tests/goldens/classification_*.npz`` loaded strictly.  Inputs are made
with numpy.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from perceiverio_pytorch_tpu import config as jax_config
from perceiverio_pytorch_tpu.core.position_encoding import PosEncodingType as JaxPE
from perceiverio_pytorch_tpu.io_processors import preprocessors as jax_pre
from perceiverio_pytorch_tpu.io_processors import processor_utils as jax_pu
from perceiverio_pytorch_tpu.models import classification as jax_cls
from perceiverio_pytorch_tpu.ops import attention as jax_ops
from perceiverio_pytorch_tpu.utils import conv_shapes as jax_shapes
from perceiverio_pytorch_tpu.utils.torch_checkpoint import export_state_dict
from perceiverio_pytorch_tpu_torch import config as port_config
from perceiverio_pytorch_tpu_torch.core.position_encoding import PosEncodingType as PortPE
from perceiverio_pytorch_tpu_torch.io_processors import preprocessors as port_pre
from perceiverio_pytorch_tpu_torch.io_processors import processor_utils as port_pu
from perceiverio_pytorch_tpu_torch.models import classification as port_cls
from perceiverio_pytorch_tpu_torch.ops import attention as port_ops
from perceiverio_pytorch_tpu_torch.ops import flash_attention as fa
from perceiverio_pytorch_tpu_torch.utils import conv_shapes as port_shapes
from perceiverio_pytorch_tpu_torch.utils.weights import state_dict_from_flax

torch.set_num_threads(1)
TOL = dict(rtol=2e-4, atol=2e-5)
GOLDENS = os.path.join(os.path.dirname(__file__), "goldens")
# The golden configuration (tests/make_goldens.py `classification`).
SMALL = dict(num_classes=7, img_size=(32, 32), num_self_attends_per_block=2, num_blocks=2,
             num_latents=8, num_latent_channels=32)
PREPS = ["FOURIER_POS_CONVNET", "LEARNED_POS_1X1CONV", "FOURIER_POS_PIXEL"]


def _perturbed(variables, seed, scale=0.1):
    """The JAX init's variables with seeded noise: the 1-D parameters
    (LayerNorm and BatchNorm scales and biases, Dense biases) move off 1 and
    0, the BatchNorm means off 0 and the variances into [0.5, 1.5]."""
    rng = np.random.default_rng(seed)

    def perturb(x):
        x = np.asarray(x)
        if x.ndim != 1:
            return x
        return x + scale * rng.standard_normal(x.shape).astype(np.float32)

    out = dict(variables)
    out["params"] = jax.tree_util.tree_map(perturb, variables["params"])
    if "batch_stats" in variables:
        def stats(path, x):
            x = np.asarray(x)
            if path[-1].key == "var":
                return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
            return rng.standard_normal(x.shape).astype(np.float32) * 0.3
        out["batch_stats"] = jax.tree_util.tree_map_with_path(stats, variables["batch_stats"])
    return out


def _port(module, variables):
    module.load_state_dict(state_dict_from_flax(variables), strict=True)
    return module.eval()


def _images(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape, dtype=np.float32)


# ---- shape arithmetic ------------------------------------------------------


@pytest.mark.parametrize("size,kernel,stride", [((33, 47), 7, 2), ((32, 32), 7, 2),
                                                ((17, 24), 3, 2), ((5, 9, 11), (3, 4), (2, 3)),
                                                ((8,), 5, 1)])
def test_same_padding_and_output_shape_match_jax(size, kernel, stride):
    dims = min(len(size), 2)
    want = jax_shapes.same_padding(size, kernel, stride, dims=dims)
    assert port_shapes.same_padding(size, kernel, stride, dims=dims) == want
    for padding, dilation in ((0, 1), (1, 2)):
        assert (port_shapes.conv_output_shape(size, kernel, stride, padding, dilation, dims=dims)
                == jax_shapes.conv_output_shape(size, kernel, stride, padding, dilation,
                                                dims=dims))
    if size == (32, 32):  # an odd total: the extra pixel goes right and bottom
        assert want == [2, 3, 2, 3]  # (w_l, w_r, h_l, h_r)


# ---- Conv2DDownsample ------------------------------------------------------


@pytest.mark.parametrize("num_layers", [1, 2])
def test_conv2d_downsample_matches_jax(num_layers):
    """Eval mode against JAX's ``deterministic`` default (running averages),
    at 33x47: the sizes along the stack (33x47, 17x24, 9x12, 5x6) are odd
    and even, so the pool's pad and the second conv's are asymmetric in
    width and symmetric in height."""
    x = _images(1, (2, 33, 47, 3))
    jm = jax_pu.Conv2DDownsample(num_layers=num_layers, num_channels=8)
    variables = _perturbed(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)), seed=2)
    want = np.asarray(jm.apply(variables, jnp.asarray(x)))
    pm = _port(port_pu.Conv2DDownsample(num_layers=num_layers, in_channels=3, num_channels=8),
               variables)
    with torch.no_grad():
        got = pm(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape == ((2, 9, 12, 8) if num_layers == 1 else (2, 3, 3, 8))
    np.testing.assert_allclose(got, want, **TOL)
    bn = pm.norms[0]
    assert (bn.eps, bn.momentum, int(bn.num_batches_tracked)) == (1e-5, 0.1, 0)


# ---- preprocessors ---------------------------------------------------------


def _image_case(kind):
    """(kwargs without the encoding type, JAX type, port type, input shape)."""
    if kind == "conv":
        return (dict(img_size=(16, 20), num_frames=2, prep_type="conv", num_channels=8,
                     fourier_position_encoding_kwargs=dict(num_bands=3, max_resolution=(2, 4, 5))),
                JaxPE.FOURIER, PortPE.FOURIER, (2, 2, 3, 16, 20))
    if kind == "conv1x1":
        return (dict(img_size=(9, 13), prep_type="conv1x1", spatial_downsample=2, num_channels=12,
                     trainable_position_encoding_kwargs=dict(num_channels=6, init_scale=0.02),
                     project_pos_dim=10, n_extra_pos_mlp=2),
                JaxPE.TRAINABLE, PortPE.TRAINABLE, (2, 3, 9, 13))
    return (dict(img_size=(9, 13), prep_type="pixels", spatial_downsample=1,
                 fourier_position_encoding_kwargs=dict(num_bands=4), n_extra_pos_mlp=1,
                 concat_or_add_pos="concat"),
            JaxPE.FOURIER, PortPE.FOURIER, (2, 3, 9, 13))


@pytest.mark.parametrize("kind", ["conv", "conv1x1", "pixels_extra_mlp"])
def test_image_preprocessor_conv_types_match_jax(kind):
    """The conv stack on video frames (time folded into the batch), a
    strided 1x1 conv with a projected trainable encoding through a 2-layer
    extra position MLP, and pixels with a 1-layer MLP."""
    kw, jax_pe, port_pe, shape = _image_case(kind)
    x = _images(3, shape)
    jm = jax_pre.ImagePreprocessor(position_encoding_type=jax_pe, **kw)
    variables = _perturbed(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)), seed=4)
    want, want_nopos = jm.apply(variables, jnp.asarray(x))
    pm = _port(port_pre.ImagePreprocessor(position_encoding_type=port_pe, **kw), variables)
    with torch.no_grad():
        got, got_nopos = pm(torch.from_numpy(x))
    assert pm.n_output_channels() == jm.n_output_channels() == got.shape[-1]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(got_nopos.numpy(), np.asarray(want_nopos), **TOL)


def test_audio_preprocessor_extra_pos_mlp_matches_jax():
    kw = dict(samples_per_batch=96, samples_per_patch=8, n_extra_pos_mlp=3,
              fourier_position_encoding_kwargs=dict(num_bands=5, max_resolution=(96,)))
    x = np.random.default_rng(5).uniform(-1, 1, (2, 96, 1)).astype(np.float32)
    jm = jax_pre.AudioPreprocessor(**kw)
    variables = _perturbed(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)), seed=6)
    want = jm.apply(variables, jnp.asarray(x))
    pm = _port(port_pre.AudioPreprocessor(**kw), variables)
    assert sorted(pm.state_dict()) == sorted(
        f"_extra_pos_mlps.{i}.{p}" for i in range(3) for p in ("weight", "bias"))
    with torch.no_grad():
        got = pm(torch.from_numpy(x))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


# ---- the whole model -------------------------------------------------------


@pytest.fixture(scope="module")
def cls_variables():
    """JAX random weights at the golden configuration for each PrepType,
    perturbed (BatchNorm statistics included)."""
    out = {}
    img = jnp.zeros((1, 3) + SMALL["img_size"])
    for i, prep in enumerate(PREPS):
        jm = jax_cls.ClassificationPerceiver(prep_type=jax_cls.PrepType[prep],
                                             policy=jax_config.PARITY, **SMALL)
        variables = jax.jit(jm.init)(jax.random.PRNGKey(i), img)
        out[prep] = _perturbed(jax.tree_util.tree_map(np.asarray, variables), seed=10 + i)
    return out


def _jax_flash_policy():
    return jax_config.Policy(compute_dtype=jnp.float32, attn_impl="flash", interpret=True)


def _port_model(variables, prep, policy, **kw):
    return _port(port_cls.ClassificationPerceiver(
        prep_type=port_cls.PrepType[prep], policy=policy, device="cpu", **SMALL, **kw),
        variables)


def _jax_logits(variables, prep, policy, img, **kw):
    jm = jax_cls.ClassificationPerceiver(prep_type=jax_cls.PrepType[prep], policy=policy,
                                         **SMALL, **kw)
    return np.asarray(jax.jit(jm.apply)(variables, jnp.asarray(img)))


@pytest.mark.parametrize("prep", PREPS)
def test_classification_matches_jax(cls_variables, prep):
    """Each PrepType on the dense path, single-query decode, 2 images."""
    img = _images(7, (2, 3, 32, 32))
    want = _jax_logits(cls_variables[prep], prep, jax_config.PARITY, img)
    model = _port_model(cls_variables[prep], prep, port_config.PARITY)
    with torch.no_grad():
        got = model(torch.from_numpy(img)).numpy()
    assert got.shape == want.shape == (2, 7) and np.abs(want).max() > 0
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("prep", PREPS)
def test_single_query_decode_is_row_zero(cls_variables, prep):
    """Decoding only query row 0 gives row 0 of the full 7-row decode, in
    the port and against JAX's full decode."""
    img = _images(8, (2, 3, 32, 32))
    variables = cls_variables[prep]
    single = _port_model(variables, prep, port_config.PARITY)
    full = _port_model(variables, prep, port_config.PARITY, single_query_decode=False)
    with torch.no_grad():
        got_single, got_full = single(torch.from_numpy(img)), full(torch.from_numpy(img))
    np.testing.assert_allclose(got_single.numpy(), got_full.numpy(), **TOL)
    want_full = _jax_logits(variables, prep, jax_config.PARITY, img, single_query_decode=False)
    np.testing.assert_allclose(got_full.numpy(), want_full, **TOL)


def test_pixel_classifier_through_the_flash_kernel_matches_jax(cls_variables):
    """The pixel variant with every site forced through K1's plain version
    (JAX through Pallas in interpreter mode): the encoder attends 8 latents
    to 1,024 tokens of the odd width 261 (3 + 258)."""
    prep = "FOURIER_POS_PIXEL"
    img = _images(9, (2, 3, 32, 32))
    want = _jax_logits(cls_variables[prep], prep, _jax_flash_policy(), img)
    model = _port_model(cls_variables[prep], prep,
                        dataclasses.replace(port_config.PARITY, attn_impl="flash"))
    assert model.perceiver._multi_preprocessor.n_output_channels() == 261
    before = fa.LAUNCHES
    with torch.no_grad():
        got = model(torch.from_numpy(img)).numpy()
    assert fa.LAUNCHES == before  # CPU tensors take the plain K1
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("prep", PREPS)
def test_classification_bf16_matches_jax(cls_variables, prep):
    """PERFORMANCE (bf16 GEMMs; the convs, BatchNorm and the pixel and
    position features stay fp32 until the encoder casts), against JAX's
    PERFORMANCE: 5% of the logits' max |x|, as for flow and multimodal."""
    img = _images(11, (2, 3, 32, 32))
    want = _jax_logits(cls_variables[prep], prep, jax_config.PERFORMANCE, img).astype(np.float32)
    model = _port_model(cls_variables[prep], prep, port_config.PERFORMANCE)
    with torch.no_grad():
        got = model(torch.from_numpy(img)).float().numpy()
    assert np.abs(got - want).max() <= 0.05 * np.abs(want).max()


@pytest.mark.parametrize("prep", PREPS)
def test_classification_golden_replay(prep):
    """tests/goldens/classification_*.npz: the reference's weights (with
    BatchNorm's num_batches_tracked) load strictly and its logits replay, on
    the dense path and through the plain K1."""
    z = np.load(os.path.join(GOLDENS, f"classification_{prep.lower()}.npz"))
    meta = json.loads(bytes(z["meta"]).decode())
    assert meta["prep"] == prep
    kwargs = {k: tuple(v) if isinstance(v, list) else v for k, v in meta["kwargs"].items()}
    sd = {k[4:]: torch.from_numpy(z[k].astype(np.float32) if z[k].dtype == np.float16 else z[k])
          for k in z.files if k.startswith("sd::")}
    for policy in (port_config.PARITY,
                   dataclasses.replace(port_config.PARITY, attn_impl="flash")):
        model = port_cls.ClassificationPerceiver(
            **kwargs, prep_type=port_cls.PrepType[prep], policy=policy, device="cpu")
        model.load_state_dict(sd, strict=True)
        with torch.no_grad():
            got = model.eval()(torch.from_numpy(z["in::img"]))
        np.testing.assert_allclose(got.numpy(), z["out::logits"], **TOL)


def test_classification_state_dict_from_flax_matches_export_state_dict(cls_variables):
    """The port's names are the JAX exporter's (the reference's), plus the
    num_batches_tracked buffer the exporter leaves out; the golden's key set
    is the port model's."""
    for prep, variables in cls_variables.items():
        want = export_state_dict(variables)
        got = state_dict_from_flax(variables)
        extra = sorted(set(got) - set(want))
        assert extra == ([] if prep != "FOURIER_POS_CONVNET" else [
            "perceiver._multi_preprocessor._preprocessors.__default.convnet.norms.0"
            ".num_batches_tracked"])
        for key, value in want.items():
            np.testing.assert_array_equal(got[key].numpy(), value, err_msg=key)
        port = port_cls.ClassificationPerceiver(prep_type=port_cls.PrepType[prep], **SMALL,
                                                device="cpu").state_dict()
        golden = np.load(os.path.join(GOLDENS, f"classification_{prep.lower()}.npz"))
        assert set(port) == set(got) == {k[4:] for k in golden.files if k.startswith("sd::")}


@pytest.mark.parametrize("prep,kv_len,kv_width", [("FOURIER_POS_CONVNET", 3136, 322),
                                                  ("LEARNED_POS_1X1CONV", 50176, 512),
                                                  ("FOURIER_POS_PIXEL", 50176, 261)])
@pytest.mark.parametrize("on_device", [True, False])
def test_attention_path_at_classification_sites(prep, kv_len, kv_width, on_device):
    """The published model's sites under "auto", as the JAX dispatch decides
    on a TPU: the pixel and 1x1-conv encoders (512 latents x 50,176 tokens)
    take the flash kernel on the card, the convnet encoder (3,136 tokens),
    the self-attends (512 latents) and the one-query decoder the dense
    path; the encoder's kv width is the widths' sum the issue names."""
    sites = {"encoder": (512, kv_len), "self": (512, 512), "decoder": (1, 512)}
    for site, (q_len, k_len) in sites.items():
        want = jax_ops.attention_path("auto", q_len=q_len, kv_len=k_len,
                                      backend="tpu" if on_device else "cpu")
        got = port_ops.attention_path("auto", q_len=q_len, kv_len=k_len, on_cuda=on_device)
        assert got == {"xla": "dense"}.get(want, want)
        flash = on_device and site == "encoder" and kv_len > 8192
        assert got == ("flash" if flash else "dense"), site
    pm = port_cls._preprocessor(port_cls.PrepType[prep], (224, 224), 3, None)
    assert pm.n_output_channels() == kv_width


@pytest.mark.parametrize("batch,splits", [(16, 1), (2, 8), (1, 16)])
@pytest.mark.parametrize("width", [261, 512])
def test_launch_plan_at_the_classification_encoders(batch, splits, width):
    """bf16 K1 at (B, 512, 50176, 1, d) takes the long-KV route: at the
    served batch of 16 the grid has 8 query blocks x 16 = 128 blocks and one
    split (no merge); at batch 2 and 1 it splits the keys into 128 blocks
    and merges once.  At d = 261 (522-byte rows) q, k and v are first copied
    into 16-byte aligned rows, one launch each; at 512 TMA reads them as
    they are."""
    q = torch.empty(batch, 512, 1, width, device="meta", dtype=torch.bfloat16)
    k = torch.empty(batch, 50176, 1, width, device="meta", dtype=torch.bfloat16)
    plan = fa.launch_plan(q, k, k)
    copies = ("q", "k", "v") if width == 261 else ()
    assert (plan["route"], plan["loader"], plan["copies"]) == (
        "sm90_longkv", "copy" if copies else "tma", copies)
    assert (plan["splits"], plan["col_chunks"], plan["cuda_launches"]) == (
        splits, 1, 1 + (splits > 1) + len(copies))
    assert plan["blocks"] == 8 * batch * splits == 128


def test_classification_refusals():
    """An unknown prep type raises, and a CUDA device where there is none."""
    with pytest.raises(ValueError, match="Unknown prep_type"):
        port_cls.ClassificationPerceiver(prep_type="pixels", **SMALL, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            port_cls.ClassificationPerceiver(**SMALL)
