"""The port's ImagePostprocessor, reverse_space_to_depth and transposed-conv
upsamplers against the JAX package's.

Inputs from ``np.random.default_rng``; the flax variables are carried across
with ``state_dict_from_flax`` (whose transposed-conv rule flips and permutes
the kernels) and loaded strictly.  fp32; reshapes are compared exactly.
"""

import jax
import numpy as np
import pytest
import torch

from perceiverio_pytorch_tpu.io_processors import postprocessors as jax_post
from perceiverio_pytorch_tpu.io_processors import processor_utils as jax_utils
from perceiverio_pytorch_tpu_torch.io_processors import postprocessors as port_post
from perceiverio_pytorch_tpu_torch.io_processors import processor_utils as port_utils
from perceiverio_pytorch_tpu_torch.utils.weights import state_dict_from_flax

torch.set_num_threads(1)
TOL = dict(rtol=2e-4, atol=2e-5)


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _carry(jax_module, port_module, x):
    variables = jax_module.init(jax.random.PRNGKey(1), x)
    port_module.load_state_dict(state_dict_from_flax(variables), strict=True)
    want = np.asarray(jax_module.apply(variables, x))
    with torch.no_grad():
        got = port_module(torch.from_numpy(x)).numpy()
    return got, want


@pytest.mark.parametrize("shape,t,s", [((2, 3, 5, 16), 1, 2), ((2, 3, 4, 5, 16), 2, 2),
                                       ((1, 2, 3, 3, 48), 1, 4), ((1, 2, 2, 2, 27), 3, 1)])
def test_reverse_space_to_depth_matches_jax_and_inverts(shape, t, s):
    x = _x(shape)
    got = port_utils.reverse_space_to_depth(torch.from_numpy(x), t, s)
    want = np.asarray(jax_utils.reverse_space_to_depth(x, t, s))
    np.testing.assert_array_equal(got.numpy(), want)
    back = port_utils.space_to_depth(got, t, s)
    np.testing.assert_array_equal(back.numpy(), x)


def test_reverse_space_to_depth_refuses_other_ranks():
    with pytest.raises(ValueError, match="rank 4"):
        port_utils.reverse_space_to_depth(torch.zeros(2, 3, 4))


@pytest.mark.parametrize("shape", [(2, 4, 5, 6), (1, 1, 1, 3)])
def test_conv2d_upsample_matches_flax(shape):
    got, want = _carry(jax_utils.Conv2DUpsample(n_outputs=3),
                       port_utils.Conv2DUpsample(shape[-1], 3), _x(shape, 2))
    assert got.shape == want.shape == (shape[0], 4 * shape[1], 4 * shape[2], 3)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("n_time,n_space", [(1, 2), (2, 1), (2, 2), (0, 1), (1, 0)],
                         ids=["stride1_time", "stride1_space", "both", "space_only",
                              "time_only"])
def test_conv3d_upsample_matches_flax(n_time, n_space):
    """Layers past n_time_upsamples run a stride-1 time axis, layers past
    n_space_upsamples stride-1 space axes: lax pads those (2, 1), which
    the port's cut of torch's n + 1 elements reproduces."""
    x = _x((1, 2, 3, 4, 5), 3)
    got, want = _carry(
        jax_utils.Conv3DUpsample(n_outputs=2, n_time_upsamples=n_time,
                                 n_space_upsamples=n_space),
        port_utils.Conv3DUpsample(5, 2, n_time_upsamples=n_time, n_space_upsamples=n_space),
        x)
    assert got.shape == want.shape == (1, 2 * 2**n_time, 3 * 2**n_space, 4 * 2**n_space, 2)
    np.testing.assert_allclose(got, want, **TOL)


def test_conv3d_upsample_channel_schedule_and_names():
    model = port_utils.Conv3DUpsample(7, 3, n_time_upsamples=1, n_space_upsamples=3)
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert shapes == {
        "conv3d_transpose_0.weight": (7, 12, 4, 4, 4), "conv3d_transpose_0.bias": (12,),
        "conv3d_transpose_1.weight": (12, 6, 4, 4, 4), "conv3d_transpose_1.bias": (6,),
        "conv3d_transpose_2.weight": (6, 3, 4, 4, 4), "conv3d_transpose_2.bias": (3,),
    }
    assert [m.strides for m in model.children()] == [(2, 2, 2), (1, 2, 2), (1, 2, 2)]


CASES = {
    "pixels": (dict(postproc_type="pixels"), (2, 4, 5, 3)),
    "pixels_reshape": (dict(postproc_type="pixels", input_reshape_size=(4, 5)), (2, 20, 3)),
    "patches_2d": (dict(postproc_type="patches", spatial_upsample=2), (2, 3, 4, 12)),
    "patches_3d": (dict(postproc_type="patches", spatial_upsample=4, temporal_upsample=2),
                   (1, 2, 3, 3, 96)),
    "patches_reshape": (dict(postproc_type="patches", spatial_upsample=2,
                             input_reshape_size=(2, 3, 4)), (1, 24, 8)),
    "conv_2d": (dict(postproc_type="conv", n_outputs=3, spatial_upsample=4), (2, 4, 5, 6)),
    "conv_fold_bt": (dict(postproc_type="conv", n_outputs=3, spatial_upsample=4),
                     (2, 3, 4, 4, 6)),
    "conv_3d": (dict(postproc_type="conv", n_outputs=3, spatial_upsample=4,
                     temporal_upsample=2), (1, 2, 3, 3, 6)),
    "conv_3d_stride1_space": (dict(postproc_type="conv", n_outputs=2, spatial_upsample=2,
                                   temporal_upsample=4), (1, 2, 3, 3, 6)),
    "conv_reshape": (dict(postproc_type="conv", n_outputs=3, spatial_upsample=4,
                          input_reshape_size=(3, 4)), (2, 12, 6)),
    "conv1x1_stride1": (dict(postproc_type="conv1x1", n_outputs=4), (2, 5, 6, 7)),
    "conv1x1_stride2": (dict(postproc_type="conv1x1", n_outputs=4, spatial_upsample=2),
                        (2, 5, 6, 7)),
    "conv1x1_video": (dict(postproc_type="conv1x1", n_outputs=4, spatial_upsample=2),
                      (2, 3, 5, 5, 7)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_image_postprocessor_matches_jax(case):
    kw, shape = CASES[case]
    x = _x(shape, 4)
    got, want = _carry(jax_post.ImagePostprocessor(img_size=(8, 8), **kw),
                       port_post.ImagePostprocessor(img_size=(8, 8), input_channels=shape[-1],
                                                    **kw), x)
    assert got.shape == want.shape
    if kw["postproc_type"] in ("pixels", "patches"):
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, **TOL)


def test_image_postprocessor_module_names_follow_flax():
    conv3d = port_post.ImagePostprocessor((8, 8), 6, "conv", 4, 2, n_outputs=3)
    conv2d = port_post.ImagePostprocessor((8, 8), 6, "conv", 4, n_outputs=3)
    conv1x1 = port_post.ImagePostprocessor((8, 8), 6, "conv1x1", 2, n_outputs=3)
    assert sorted(conv3d.state_dict()) == [f"convnet.conv3d_transpose_{i}.{p}"
                                           for i in range(2) for p in ("bias", "weight")]
    assert sorted(conv2d.state_dict()) == [f"convnet.transp_conv{i}.{p}"
                                           for i in (1, 2) for p in ("bias", "weight")]
    assert sorted(conv1x1.state_dict()) == ["conv1x1.bias", "conv1x1.weight"]
    assert tuple(conv1x1.state_dict()["conv1x1.weight"].shape) == (3, 6, 1, 1)


@pytest.mark.parametrize("kw,error,message", [
    (dict(postproc_type="bogus"), ValueError, "Invalid postproc_type!"),
    (dict(postproc_type="pixels", spatial_upsample=2), ValueError, "should not currently"),
    (dict(postproc_type="pixels", temporal_upsample=2), ValueError, "should not currently"),
    (dict(postproc_type="conv"), ValueError, "Expected value for n_outputs"),
    (dict(postproc_type="conv1x1"), ValueError, "Expected value for n_outputs"),
    (dict(postproc_type="conv1x1", n_outputs=3, temporal_upsample=2), AssertionError,
     "conv1x1 does not upsample in time."),
])
def test_image_postprocessor_validation_matches_jax(kw, error, message):
    """Each JAX refusal (at init there; at construction here).  JAX's
    temporal check for conv1x1 is an assert; the port raises ValueError
    with its message (an assert vanishes under -O)."""
    x = _x((1, 4, 4, 3))
    with pytest.raises(error, match=message):
        jax_post.ImagePostprocessor(img_size=(8, 8), **kw).init(jax.random.PRNGKey(0), x)
    with pytest.raises(ValueError, match=message):
        port_post.ImagePostprocessor(img_size=(8, 8), input_channels=3, **kw)


def test_raft_fails_at_the_call_in_both_packages():
    """JAX builds no upsampler for "raft" and fails on the missing convnet;
    the port constructs it too and refuses the call by name."""
    x = _x((1, 4, 4, 3))
    with pytest.raises(AttributeError, match="convnet"):
        jax_post.ImagePostprocessor(img_size=(8, 8), postproc_type="raft").init(
            jax.random.PRNGKey(0), x)
    model = port_post.ImagePostprocessor(img_size=(8, 8), postproc_type="raft")
    assert not list(model.parameters())
    with pytest.raises(NotImplementedError, match="raft"):
        model(torch.from_numpy(x))


def test_transposed_conv_weights_are_flipped_and_permuted():
    """state_dict_from_flax: a transposed-conv kernel [k..., in, out] becomes
    torch's [in, out, k...] flipped in every spatial axis; a plain conv
    kernel keeps the conv rule [out, in, kh, kw]."""
    k4 = _x((4, 4, 5, 6), 5)
    k5 = _x((4, 4, 4, 5, 6), 6)
    conv = _x((1, 1, 5, 6), 7)
    sd = state_dict_from_flax({"params": {
        "convnet": {"transp_conv1": {"kernel": k4}, "conv3d_transpose_0": {"kernel": k5}},
        "conv1x1": {"kernel": conv}}})
    np.testing.assert_array_equal(sd["convnet.transp_conv1.weight"].numpy(),
                                  k4.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1])
    np.testing.assert_array_equal(sd["convnet.conv3d_transpose_0.weight"].numpy(),
                                  k5.transpose(3, 4, 0, 1, 2)[:, :, ::-1, ::-1, ::-1])
    np.testing.assert_array_equal(sd["conv1x1.weight"].numpy(), conv.transpose(3, 2, 0, 1))
