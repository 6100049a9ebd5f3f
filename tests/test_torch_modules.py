"""The port's position encodings, patch utilities and image preprocessor
against the JAX package's, on the same numpy inputs and weights."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from perceiverio_pytorch_tpu.core import position_encoding as jax_pe
from perceiverio_pytorch_tpu.core import queries as jax_queries
from perceiverio_pytorch_tpu.io_processors import preprocessors as jax_pre
from perceiverio_pytorch_tpu.io_processors import processor_utils as jax_pu
from perceiverio_pytorch_tpu_torch.core import position_encoding as port_pe
from perceiverio_pytorch_tpu_torch.core import queries as port_queries
from perceiverio_pytorch_tpu_torch.io_processors import preprocessors as port_pre
from perceiverio_pytorch_tpu_torch.io_processors import processor_utils as port_pu
from perceiverio_pytorch_tpu_torch.utils import initializers
from perceiverio_pytorch_tpu_torch.utils.weights import state_dict_from_flax

torch.set_num_threads(1)
TOL = dict(rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("dims", [(16, 24), (368, 496), (7,), (3, 5, 6)])
def test_linear_positions_match_jax(dims):
    # XLA's CPU lowering of jnp.linspace rounds differently from the
    # formula it is traced from: positions may differ by 1 ulp of 1.0.
    want = np.asarray(jax_pe.build_linear_positions(dims))
    got = port_pe.build_linear_positions(dims).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1.2e-7)


# The full-size flow table gets its own atol: in fp32 the sine argument
# pi * f * x reaches ~779, whose ulp is 6.1e-5, so JAX's table and the
# port's each lie up to ~2.3e-4 from the float64 table and differ from each
# other by up to ~1.8e-4 (1-ulp differences in positions and bands).
@pytest.mark.parametrize(
    "dims,bands,concat_pos,sine_only,atol",
    [((368, 496), 64, True, False, 3e-4),  # the flow table, at full size
     ((16, 24), 5, False, True, 2e-5), ((9,), 3, True, False, 2e-5)],
)
def test_fourier_features_match_jax(dims, bands, concat_pos, sine_only, atol):
    kw = dict(num_bands=bands, concat_pos=concat_pos, sine_only=sine_only)
    jm = jax_pe.FourierPositionEncoding(index_dims=dims, **kw)
    want = np.asarray(jm.apply(jm.init(jax.random.PRNGKey(0), 2), 2))
    pm = port_pe.FourierPositionEncoding(index_dims=dims, **kw)
    got = pm(2).numpy()
    assert pm.n_output_channels() == jm.n_output_channels() == got.shape[-1]
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=atol)
    assert "fourier_table" not in pm.state_dict()


def test_fourier_explicit_positions_match_jax():
    pos = np.random.default_rng(0).uniform(-1, 1, (2, 30, 2)).astype(np.float32)
    want = jax_pe.generate_fourier_features(jnp.asarray(pos[0]), 6, (20, 30))
    got = port_pe.generate_fourier_features(torch.from_numpy(pos[0]), 6, (20, 30))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    pm = port_pe.FourierPositionEncoding(index_dims=(20, 30), num_bands=6)
    np.testing.assert_allclose(pm(2, pos=torch.from_numpy(pos))[1].numpy(),
                               np.asarray(want), **TOL)


def test_trainable_and_projected_encodings_load_jax_weights():
    jm = jax_pe.build_position_encoding(
        jax_pe.PosEncodingType.FOURIER, index_dims=(4, 5), project_pos_dim=7,
        fourier_position_encoding_kwargs=dict(num_bands=3))
    variables = jm.init(jax.random.PRNGKey(1), 3)
    pm = port_pe.build_position_encoding(
        port_pe.PosEncodingType.FOURIER, index_dims=(4, 5), project_pos_dim=7,
        fourier_position_encoding_kwargs=dict(num_bands=3))
    pm.load_state_dict(state_dict_from_flax(variables), strict=True)
    np.testing.assert_allclose(pm(3).detach().numpy(), np.asarray(jm.apply(variables, 3)),
                               **TOL)

    jt = jax_pe.TrainablePositionEncoding(index_dim=6, num_channels=4)
    variables = jt.init(jax.random.PRNGKey(2), 2)
    pt = port_pe.TrainablePositionEncoding(index_dim=6, num_channels=4)
    pt.load_state_dict(state_dict_from_flax(variables), strict=True)
    np.testing.assert_array_equal(pt(2).detach().numpy(), np.asarray(jt.apply(variables, 2)))


@pytest.mark.parametrize("kind", ["fourier", "trainable"])
@pytest.mark.parametrize("subsample", [False, True])
def test_queries_match_jax(kind, subsample):
    """Decoder queries, whole and subsampled (chunked decoding)."""
    inputs = np.zeros((2, 5, 3), np.float32)
    points = np.array([0, 7, 23, 11]) if subsample else None
    if kind == "fourier":
        jq = jax_queries.FourierQuery(output_index_dims=(4, 6), num_bands=3)
        pq = port_queries.FourierQuery(output_index_dims=(4, 6), num_bands=3)
    else:
        jq = jax_queries.TrainableQuery(output_index_dims=(4, 6), num_channels=5)
        pq = port_queries.TrainableQuery(output_index_dims=(4, 6), num_channels=5)
    variables = jq.init(jax.random.PRNGKey(0), jnp.asarray(inputs))
    want = jq.apply(variables, jnp.asarray(inputs),
                    subsampled_points=None if points is None else jnp.asarray(points))
    pq.load_state_dict(state_dict_from_flax(variables), strict=True)
    got = pq(torch.from_numpy(inputs),
             subsampled_points=None if points is None else torch.from_numpy(points))
    assert pq.n_query_channels() == jq.n_query_channels() == got.shape[-1]
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("shape,t,s", [((2, 6, 8, 3), 1, 2), ((1, 4, 6, 9, 2), 2, 3)])
def test_space_to_depth_matches_jax(shape, t, s):
    x = np.random.default_rng(3).standard_normal(shape, dtype=np.float32)
    want = jax_pu.space_to_depth(jnp.asarray(x), temporal_block_size=t, spatial_block_size=s)
    got = port_pu.space_to_depth(torch.from_numpy(x), temporal_block_size=t,
                                 spatial_block_size=s)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("size,stride,dilation", [((3, 3), 1, 1), ((2, 3), (2, 1), (1, 2))])
def test_extract_patches_matches_jax(size, stride, dilation):
    x = np.random.default_rng(4).standard_normal((2, 9, 11, 3), dtype=np.float32)
    want = jax_pu.extract_patches(jnp.asarray(x), size, stride, dilation)
    got = port_pu.extract_patches(torch.from_numpy(x), size, stride, dilation)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_patches_for_flow_matches_jax():
    x = np.random.default_rng(5).standard_normal((2, 2, 8, 10, 3), dtype=np.float32)
    want = jax_pu.patches_for_flow(jnp.asarray(x))
    got = port_pu.patches_for_flow(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("prep_type", ["patches", "pixels"])
def test_image_preprocessor_matches_jax(prep_type):
    if prep_type == "patches":  # the flow configuration at a small size
        kwargs = dict(
            img_size=(8, 12), input_channels=27, prep_type="patches",
            spatial_downsample=1, temporal_downsample=2, conv_after_patching=True,
            num_channels=16, fourier_position_encoding_kwargs=dict(
                num_bands=4, max_resolution=(8, 12), sine_only=False, concat_pos=True))
        shape = (2, 2, 27, 8, 12)
    else:
        kwargs = dict(
            img_size=(8, 12), input_channels=3, prep_type="pixels",
            spatial_downsample=2, concat_or_add_pos="concat",
            fourier_position_encoding_kwargs=dict(num_bands=3))
        shape = (2, 3, 8, 12)
    x = np.random.default_rng(6).standard_normal(shape, dtype=np.float32)
    jm = jax_pre.ImagePreprocessor(**kwargs)
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want, want_nopos = jm.apply(variables, jnp.asarray(x))
    pm = port_pre.ImagePreprocessor(**kwargs)
    pm.load_state_dict(state_dict_from_flax(variables), strict=True)
    with torch.no_grad():
        got, got_nopos = pm(torch.from_numpy(x))
    assert pm.n_output_channels() == jm.n_output_channels() == got.shape[-1]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(got_nopos.numpy(), np.asarray(want_nopos), **TOL)


@pytest.mark.parametrize("prep_type", ["conv", "conv1x1"])
def test_image_preprocessor_conv_types_not_ported(prep_type):
    """The conv types are ported now (tests/test_torch_classification.py
    holds them against JAX); what stays refused is what JAX refuses: a conv
    stack whose downsampling is not a power of 4 in space and 1 in time,
    and a 1x1 conv that would downsample in time."""
    kw = dict(img_size=(8, 8), prep_type=prep_type,
              fourier_position_encoding_kwargs=dict(num_bands=2))
    pm = port_pre.ImagePreprocessor(**kw)
    assert hasattr(pm, "convnet" if prep_type == "conv" else "convnet_1x1")
    assert pm.n_output_channels() == 64 + 2 * 2 * 2 + 2
    with pytest.raises(ValueError):
        port_pre.ImagePreprocessor(**kw, temporal_downsample=2)
    if prep_type == "conv":
        with pytest.raises(ValueError, match="powers of 4"):
            port_pre.ImagePreprocessor(**dict(kw, spatial_downsample=2))


def test_initializer_statistics():
    """fan-in truncated normal: std sqrt(scale/fan_in), cut at 2 std."""
    gen = torch.Generator().manual_seed(0)
    w = torch.empty(512, 256)
    initializers.variance_scaling_(w, 2.0, gen)
    std = (2.0 / 256) ** 0.5
    assert abs(w.std().item() / std - 1) < 0.02
    assert w.abs().max().item() <= 2 * std / initializers._TRUNC_STD + 1e-6
    t = initializers.trunc_normal_(torch.empty(100000), 0.02, gen)
    assert t.abs().max().item() <= 0.04 + 1e-7
    a = initializers.lecun_normal_(torch.empty(8, 8), torch.Generator().manual_seed(1))
    b = initializers.lecun_normal_(torch.empty(8, 8), torch.Generator().manual_seed(1))
    assert torch.equal(a, b)
