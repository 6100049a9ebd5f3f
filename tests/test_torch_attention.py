"""The port's attention path and transformer blocks against the JAX package.

Weights go from the JAX modules to the port through ``state_dict_from_flax``
and inputs are made with numpy, so both frameworks see the same numbers.
"""

import re
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from perceiverio_pytorch_tpu import config as jax_config
from perceiverio_pytorch_tpu.core import attention as jax_blocks
from perceiverio_pytorch_tpu.ops import attention as jax_ops
from perceiverio_pytorch_tpu.ops.attention_xla import attend_xla, make_cross_attention_mask
from perceiverio_pytorch_tpu_torch import config as port_config
from perceiverio_pytorch_tpu_torch.core import attention as port_blocks
from perceiverio_pytorch_tpu_torch.ops import attention as port_ops
from perceiverio_pytorch_tpu_torch.ops.attention_dense import attend_dense
from perceiverio_pytorch_tpu_torch.utils.weights import state_dict_from_flax

torch.set_num_threads(1)
TOL = dict(rtol=2e-4, atol=2e-5)

# (q_len, kv_len) of the sites the dispatch rule decides between.
SITES = {
    "mlm_encoder": (256, 2048),
    "imagenet_encoder": (512, 3136),
    "flow_encoder": (2048, 182528),
    "flow_self": (2048, 2048),
    "flow_decoder": (182528, 2048),
}


@pytest.mark.parametrize("site", sorted(SITES))
@pytest.mark.parametrize("impl", ["auto", "flash", "dense"])
@pytest.mark.parametrize("on_device", [True, False])
def test_attention_path_matches_jax(site, impl, on_device):
    q_len, kv_len = SITES[site]
    jax_impl = {"dense": "xla"}.get(impl, impl)
    want = jax_ops.attention_path(
        jax_impl, q_len=q_len, kv_len=kv_len,
        backend="tpu" if on_device else "cpu",
    )
    got = port_ops.attention_path(impl, q_len=q_len, kv_len=kv_len, on_cuda=on_device)
    assert got == {"xla": "dense"}.get(want, want)


@pytest.mark.parametrize("impl", ["auto", "flash", "dense"])
@pytest.mark.parametrize("lengths", [(2048, 182528), (2048, 2048), (182528, 2048), (256, 2048),
                                     (512, 512)])
@pytest.mark.parametrize("dropout_rate", [0.0, 0.1])
@pytest.mark.parametrize("masks", ["none", "mask", "bias"])
@pytest.mark.parametrize("on_device", [True, False])
def test_attention_path_grid_matches_jax(impl, lengths, dropout_rate, masks, on_device):
    """The port's rule against the JAX one over impl, lengths, dropout and
    masks: any dropout_rate > 0 takes the dense path, as in JAX."""
    q_len, kv_len = lengths
    kw = dict(q_len=q_len, kv_len=kv_len, dropout_rate=dropout_rate,
              attention_mask=object() if masks == "mask" else None,
              attention_bias=object() if masks == "bias" else None)
    want = jax_ops.attention_path({"dense": "xla"}.get(impl, impl),
                                  backend="tpu" if on_device else "cpu", **kw)
    got = port_ops.attention_path(impl, on_cuda=on_device, **kw)
    assert got == {"xla": "dense"}.get(want, want)
    if dropout_rate > 0:
        assert got == "dense"


def test_dropout_site_raises_on_the_dense_path():
    """A dropout site takes the dense path, which draws its mask from the
    caller's generator: without one it raises, as JAX does without
    ``dropout_rng``."""
    q = torch.zeros(1, 4, 1, 8)
    with pytest.raises(ValueError, match="generator"):
        port_ops.multihead_attention(q, q, q, impl="flash", dropout_rate=0.1)
    out = port_ops.multihead_attention(q, q, q, impl="flash", dropout_rate=0.1,
                                       dropout_generator=torch.Generator().manual_seed(0))
    assert out.shape == (1, 4, 8)
    out = port_ops.multihead_attention(q, q, q, impl="flash", dropout_rate=0.0)
    assert out.shape == (1, 4, 8)


def test_attention_path_masks_force_dense():
    kw = dict(q_len=2048, kv_len=182528, on_cuda=True)
    assert port_ops.attention_path("auto", **kw) == "flash"
    assert port_ops.attention_path("flash", attention_mask=object(), **kw) == "dense"
    assert port_ops.attention_path("flash", attention_bias=object(), **kw) == "dense"
    assert port_ops.attention_path("flash", return_matrix=True, **kw) == "dense"


def _qkv(b, tq, tk, h, d, dv, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, tq, h, d), dtype=np.float32),
            rng.standard_normal((b, tk, h, d), dtype=np.float32),
            rng.standard_normal((b, tk, h, dv), dtype=np.float32))


@pytest.mark.parametrize("with_mask", [False, True])
def test_dense_matches_jax(with_mask):
    q, k, v = _qkv(2, 12, 20, 3, 8, 5, seed=4)
    rng = np.random.default_rng(5)
    bias = rng.standard_normal((2, 3, 12, 20), dtype=np.float32)
    mask = None
    if with_mask:
        qm, km = rng.random((2, 12)) > 0.3, rng.random((2, 20)) > 0.3
        km[1] = False  # all-masked rows are wiped
        mask = np.array(make_cross_attention_mask(jnp.asarray(qm), jnp.asarray(km)))
    want_m, want = attend_xla(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), attention_bias=jnp.asarray(bias),
        attention_mask=None if mask is None else jnp.asarray(mask), return_matrix=True)
    got_m, got = attend_dense(
        *(torch.from_numpy(x) for x in (q, k, v)), attention_bias=torch.from_numpy(bias),
        attention_mask=None if mask is None else torch.from_numpy(mask),
        return_matrix=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(got_m.numpy(), np.asarray(want_m), **TOL)


def test_multihead_factored_masks_match_jax():
    q, k, v = _qkv(2, 10, 30, 2, 6, 6, seed=8)
    rng = np.random.default_rng(9)
    qm, km = rng.random((2, 10)) > 0.3, rng.random((2, 30)) > 0.3
    want = jax_ops.multihead_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), q_mask=jnp.asarray(qm),
        kv_mask=jnp.asarray(km), impl="xla", kv_logical_len=25)
    for impl in ("dense", "flash"):
        got = port_ops.multihead_attention(
            *(torch.from_numpy(x) for x in (q, k, v)), q_mask=torch.from_numpy(qm),
            kv_mask=torch.from_numpy(km), impl=impl, kv_logical_len=25)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _policies(impl):
    if impl == "dense":
        return jax_config.PARITY, port_config.PARITY
    return (jax_config.Policy(compute_dtype=jnp.float32, attn_impl="flash", interpret=True),
            port_config.Policy(compute_dtype=torch.float32, attn_impl="flash"))


def _port_module(cls, variables, **kwargs):
    module = cls(**kwargs)
    module.load_state_dict(state_dict_from_flax(variables), strict=True)
    return module.eval()


@pytest.mark.parametrize("impl", ["dense", "flash"])
def test_cross_attention_matches_jax(impl):
    jax_pol, port_pol = _policies(impl)
    rng = np.random.default_rng(11)
    xq = rng.standard_normal((2, 6, 16), dtype=np.float32)
    xkv = rng.standard_normal((2, 40, 23), dtype=np.float32)
    km = rng.random((2, 40)) > 0.2
    kwargs = dict(q_in_channels=16, kv_in_channels=23, num_heads=1, widening_factor=2)
    jm = jax_blocks.CrossAttention(**kwargs, policy=jax_pol)
    variables = jm.init(jax.random.PRNGKey(0), xq, xkv)
    want = jm.apply(variables, jnp.asarray(xq), jnp.asarray(xkv), kv_mask=jnp.asarray(km))
    pm = _port_module(port_blocks.CrossAttention, variables, policy=port_pol, **kwargs)
    with torch.no_grad():
        got = pm(torch.from_numpy(xq), torch.from_numpy(xkv), kv_mask=torch.from_numpy(km))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("impl", ["dense", "flash"])
def test_self_attention_matches_jax(impl):
    jax_pol, port_pol = _policies(impl)
    x = np.random.default_rng(12).standard_normal((2, 9, 32), dtype=np.float32)
    kwargs = dict(in_channels=32, num_heads=4, widening_factor=1)
    jm = jax_blocks.SelfAttention(**kwargs, policy=jax_pol)
    variables = jm.init(jax.random.PRNGKey(1), x)
    want = jm.apply(variables, jnp.asarray(x))
    pm = _port_module(port_blocks.SelfAttention, variables, policy=port_pol, **kwargs)
    with torch.no_grad():
        got = pm(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_attention_widths_and_gelu_tanh_match_jax():
    """Separate qk / v / output widths, no final bias, tanh GELU."""
    x = np.random.default_rng(13).standard_normal((1, 7, 12), dtype=np.float32)
    y = np.random.default_rng(14).standard_normal((1, 11, 10), dtype=np.float32)
    kwargs = dict(q_in_channels=12, k_in_channels=10, v_in_channels=10, num_heads=2,
                  qk_out_channels=8, v_out_channels=6, output_channels=5,
                  with_final_bias=False)
    jm = jax_blocks.Attention(**kwargs, policy=jax_config.PARITY)
    variables = jm.init(jax.random.PRNGKey(2), x, y, y)
    want = jm.apply(variables, jnp.asarray(x), jnp.asarray(y), jnp.asarray(y))
    pm = _port_module(port_blocks.Attention, variables, policy=port_config.PARITY, **kwargs)
    with torch.no_grad():
        got = pm(torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(y))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

    jax_pol = jax_config.Policy(compute_dtype=jnp.float32, gelu_approximate=True)
    port_pol = port_config.Policy(compute_dtype=torch.float32, gelu_approximate=True)
    jm = jax_blocks.MLP(in_channels=12, widening_factor=3, policy=jax_pol)
    variables = jm.init(jax.random.PRNGKey(3), x)
    pm = _port_module(port_blocks.MLP, variables, in_channels=12, widening_factor=3,
                      policy=port_pol)
    with torch.no_grad():
        got = pm(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(jm.apply(variables, x)), **TOL)


@pytest.mark.parametrize(
    "field,value",
    [("quant", "int8_dynamic"), ("sp_mesh", object()), ("pp_mesh", object()),
     ("layer_scan", "on"), ("remat_policy", "dots_saveable")],
)
def test_unported_policy_fields_raise(field, value):
    if field == "remat_policy":
        # Ported: the names with a torch meaning are taken; any other raises.
        assert port_config.Policy(**{field: value}).remat_policy == value
        with pytest.raises(ValueError, match=value):
            port_config.Policy(remat_policy="save_only_these_names")
        return
    if field == "layer_scan":
        # Ported: JAX's values are taken (each runs the same loop); any
        # other raises JAX's ValueError.
        assert port_config.Policy(**{field: value}).layer_scan == value
        with pytest.raises(ValueError, match="layer_scan must be 'auto', 'on' or 'off'"):
            port_config.Policy(layer_scan="maybe")
        return
    if field == "sp_mesh":
        # Ported: any mesh is taken with JAX's defaults for the other sp
        # fields; sp_impl takes attn_impl's names, and any other raises.
        pol = port_config.Policy(**{field: value})
        assert pol.sp_mesh is value
        assert (pol.sp_axis, pol.sp_min_kv, pol.sp_impl) == ("model", 32768, "auto")
        jax_pol = jax_config.Policy()
        assert (jax_pol.sp_axis, jax_pol.sp_min_kv) == (pol.sp_axis, pol.sp_min_kv)
        with pytest.raises(ValueError, match="sp_impl must be 'dense', 'flash' or 'auto'"):
            port_config.Policy(sp_mesh=value, sp_impl="xla")
        return
    if field == "quant":
        # Ported: the JAX modes are taken; any other raises JAX's ValueError.
        assert port_config.Policy(**{field: value}).quant == value
        with pytest.raises(ValueError) as want:
            jax_config.quant_enabled(jax_config.Policy(quant="int4"))
        with pytest.raises(ValueError) as got:
            port_config.Policy(quant="int4")
        assert str(got.value) == str(want.value)
        return
    # pp_mesh: ported.  A mesh is taken with JAX's defaults for the other pp
    # fields; an axis the mesh lacks or a repeat count below 1 raises JAX's
    # ValueError (JAX raises at apply, the port when the Policy is made).
    mesh = types.SimpleNamespace(mesh_dim_names=("data", "pipe"))
    pol = port_config.Policy(**{field: mesh})
    assert pol.pp_mesh is mesh
    jax_pol = jax_config.Policy()
    assert (pol.pp_axis, pol.pp_microbatches, pol.pp_circ_repeats) == (
        jax_pol.pp_axis, jax_pol.pp_microbatches, jax_pol.pp_circ_repeats) == ("pipe", 2, 1)
    with pytest.raises(ValueError, match=re.escape(
            "Policy.pp_axis 'model' is not an axis of pp_mesh ('data', 'pipe')")):
        port_config.Policy(pp_mesh=mesh, pp_axis="model")
    with pytest.raises(ValueError, match="Policy.pp_circ_repeats must be >= 1; got 0"):
        port_config.Policy(pp_mesh=mesh, pp_circ_repeats=0)


def test_fold_query_pad_is_ported():
    """The query-pad fold is a field the port honours; PERFORMANCE sets it,
    as the JAX preset does."""
    assert port_config.Policy(fold_query_pad=True).fold_query_pad
    assert port_config.PERFORMANCE.fold_query_pad == jax_config.PERFORMANCE.fold_query_pad
    assert not port_config.PARITY.fold_query_pad


def test_policy_rejects_jax_attn_name():
    with pytest.raises(ValueError):
        port_config.Policy(attn_impl="xla")
