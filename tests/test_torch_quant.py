"""The port's int8 products (``ops/quant.py``) and ``Policy.quant`` against
the JAX package's.

``int8_dynamic_matmul`` and ``int8_static_matmul`` at K, N in {32, 261, 322,
704} and M in {3, 16, 40}: the int8 codes each side hands its product
(captured at JAX's ``dot_general`` and the port's ``int8_gemm``) are equal,
the outputs agree, the zero-padded product that the card's
``torch._int_mm`` takes is bit for bit the unpadded one, values on the int8
grid come out exact; the straight-through gradients against ``jax.grad``;
``Policy`` and ``quant_enabled`` validation against the JAX messages; and
the blocks: ``quant_scope="latent"`` keeps a ``CrossAttention`` bit for bit
exact, and a quantized ``SelfAttention`` and ``CrossAttention`` with JAX's
weights against JAX's; LoRA's merged weights under int8.  Inputs are made
with numpy.
"""

import dataclasses
from unittest import mock

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from perceiverio_pytorch_tpu import config as jax_config
from perceiverio_pytorch_tpu.core import attention as jax_blocks
from perceiverio_pytorch_tpu.ops import quant as jax_quant
from perceiverio_pytorch_tpu_torch import config as port_config
from perceiverio_pytorch_tpu_torch.core import attention as port_blocks
from perceiverio_pytorch_tpu_torch.ops import quant
from perceiverio_pytorch_tpu_torch.utils.weights import state_dict_from_flax

torch.set_num_threads(1)
TOL = dict(rtol=2e-4, atol=2e-5)
WIDTHS = [32, 261, 322, 704]
ROWS = [3, 16, 40]
MODES = ["int8_dynamic", "int8_static"]


def _inputs(m, k, n, seed):
    """Activations [m, k] with an outlier row and weights [k, n] (JAX's
    layout) at a projection's scale."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k), dtype=np.float32)
    x[0] *= 4.0
    w = (rng.standard_normal((k, n), dtype=np.float32) / np.sqrt(k)).astype(np.float32)
    return x, w


def _jax_run(mode, x, w, amax):
    """JAX's result and the codes it hands dot_general."""
    seen = []
    dot_general = jax.lax.dot_general

    def record(a, b, *args, **kwargs):
        seen.append((np.asarray(a), np.asarray(b)))
        return dot_general(a, b, *args, **kwargs)

    with mock.patch.object(jax.lax, "dot_general", record):
        if mode == "int8_static":
            y = jax_quant.int8_static_matmul(jnp.asarray(x), jnp.asarray(w), amax)
        else:
            y = jax_quant.int8_dynamic_matmul(jnp.asarray(x), jnp.asarray(w))
    (xq, wq), = seen
    return np.asarray(y), xq, wq.T  # the weight codes in the port's [N, K]


def _port_run(mode, x, w, amax, gemm=None):
    """The port's result and the codes it hands its int8 product."""
    seen = []
    inner = gemm or quant.int8_gemm

    def record(a, b):
        seen.append((a.numpy().copy(), b.numpy().copy()))
        return inner(a, b)

    with mock.patch.object(quant, "int8_gemm", record):
        if mode == "int8_static":
            y = quant.int8_static_matmul(torch.from_numpy(x), torch.from_numpy(w.T.copy()),
                                         torch.tensor(amax))
        else:
            y = quant.int8_dynamic_matmul(torch.from_numpy(x), torch.from_numpy(w.T.copy()))
    (xq, wq), = seen
    return y.numpy(), xq, wq


def _x_scale(mode, x, amax):
    if mode == "int8_static":
        return np.full((x.shape[0], 1), np.float32(amax) / np.float32(127.0))
    return np.maximum(np.abs(x).max(-1, keepdims=True) / np.float32(127.0), 1e-12)


@pytest.mark.parametrize("m", ROWS)
@pytest.mark.parametrize("k", WIDTHS)
@pytest.mark.parametrize("mode", MODES)
def test_int8_matmul_matches_jax(mode, k, m):
    """The codes are JAX's and the outputs agree; N takes the next width, so
    every K and N of the list (and each pair's padding) comes up.  A code
    that flips at a rounding tie (x / scale within float32 rounding of a
    half) is reported and bounds the output by one quantization step."""
    n = WIDTHS[(WIDTHS.index(k) + 1) % len(WIDTHS)]
    x, w = _inputs(m, k, n, seed=k * 100 + m)
    # The static scale: 0.8 of the true max, so the outlier row clips.
    amax = float(np.abs(x).max()) * 0.8
    want, xq_jax, wq_jax = _jax_run(mode, x, w, amax)
    got, xq, wq = _port_run(mode, x, w, amax)
    assert xq.dtype == wq.dtype == np.int8 and xq.shape == (m, k) and wq.shape == (n, k)
    np.testing.assert_array_equal(wq, wq_jax)
    flips = xq != xq_jax
    if flips.any():
        scaled = x / _x_scale(mode, x, amax)
        ties = np.abs(np.abs(scaled - np.trunc(scaled)) - 0.5) < 1e-5
        assert (ties | ~flips).all() and (np.abs(xq.astype(int) - xq_jax) <= 1).all()
        print(f"{flips.sum()} activation codes flip at a rounding tie")
        w_scale = np.abs(w).max(0) / np.float32(127.0)
        step = _x_scale(mode, x, amax) * w_scale * np.abs(wq).max()
        assert (np.abs(got - want) <= flips.sum(-1, keepdims=True) * step * 1.01).all()
    else:
        np.testing.assert_allclose(got, want, **TOL)
    # The zero-padded product (the card's operand shapes) is bit for bit the
    # unpadded one, in the codes' product and through the whole function.
    ref = quant.int8_gemm_reference(torch.from_numpy(xq), torch.from_numpy(wq))
    padded = quant.int8_gemm_padded(torch.from_numpy(xq), torch.from_numpy(wq),
                                    quant.int8_gemm_reference)
    assert padded.dtype == torch.int32 and torch.equal(padded, ref)
    np.testing.assert_array_equal(
        ref.numpy(), xq.astype(np.int64) @ wq.astype(np.int64).T)
    got_padded, _, _ = _port_run(mode, x, w, amax, gemm=lambda a, b: quant.int8_gemm_padded(
        a, b, quant.int8_gemm_reference))
    np.testing.assert_array_equal(got_padded, got)


@pytest.mark.parametrize("shape", [(3, 261, 5), (16, 322, 8), (17, 704, 261), (40, 32, 16)])
def test_padded_operands_follow_the_card_rules(shape):
    """What ``torch._int_mm`` gets on the card: more than 16 rows, K and N
    multiples of 8, zeros in the padding; the result sliced back."""
    m, k, n = shape
    rng = np.random.default_rng(m + k + n)
    xq = torch.from_numpy(rng.integers(-127, 128, (m, k)).astype(np.int8))
    wq = torch.from_numpy(rng.integers(-127, 128, (n, k)).astype(np.int8))
    seen = []

    def gemm(a, b):
        seen.append((a, b))
        return quant.int8_gemm_reference(a, b)

    out = quant.int8_gemm_padded(xq, wq, gemm)
    (a, b), = seen
    assert a.shape[0] > 16 and a.shape[1] % 8 == 0 and b.shape[0] % 8 == 0
    assert a.shape[1] == b.shape[1] and a.is_contiguous()
    assert torch.equal(a[:m, :k], xq) and not a[m:].any() and not a[:, k:].any()
    assert torch.equal(b[:n, :k], wq) and not b[n:].any() and not b[:, k:].any()
    assert out.shape == (m, n) and torch.equal(out, quant.int8_gemm_reference(xq, wq))


@pytest.mark.parametrize("mode", MODES)
def test_int8_matmul_exact_on_grid_values(mode):
    """Inputs on the int8 grid (integers, max |.| = 127) quantize losslessly:
    the result equals the exact product, as in the JAX test; zero rows give
    zeros."""
    rng = np.random.RandomState(0)
    x = rng.randint(-127, 128, (2, 8, 32)).astype(np.float32)
    x[..., 0] = 127
    w = rng.randint(-127, 128, (16, 32)).astype(np.float32)
    w[:, 0] = 127
    args = (torch.from_numpy(x), torch.from_numpy(w))
    if mode == "int8_static":
        got = quant.int8_static_matmul(*args, torch.tensor(127.0))
    else:
        got = quant.int8_dynamic_matmul(*args)
    np.testing.assert_array_equal(got.numpy(), x @ w.T)
    zero = quant.int8_dynamic_matmul(torch.zeros(3, 32), args[1])
    assert not zero.any()


def test_static_matmul_uncalibrated_and_clipped():
    """amax 0 takes scale 1.0 and out-of-range values clip, as in JAX."""
    x, w = _inputs(6, 64, 32, seed=4)
    x[0, 0] = 50.0
    for amax in (0.0, 2.0):
        want = jax_quant.int8_static_matmul(jnp.asarray(x), jnp.asarray(w), amax)
        got = quant.int8_static_matmul(torch.from_numpy(x), torch.from_numpy(w.T.copy()),
                                       torch.tensor(amax))
        assert np.isfinite(got.numpy()).all()
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_out_dtype_and_input_dtype(dtype):
    """The result is ``out_dtype`` or the input's; a bf16 input and weight
    quantize from their own values (via fp32), as JAX's astype does."""
    x, w = _inputs(5, 48, 24, seed=9)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    wt = torch.from_numpy(w.T.copy()).to(getattr(torch, dtype))
    got = quant.int8_dynamic_matmul(xt, wt)
    assert got.dtype == xt.dtype
    jdt = getattr(jnp, dtype)
    want = jax_quant.int8_dynamic_matmul(jnp.asarray(x).astype(jdt),
                                         jnp.asarray(w).astype(jdt), out_dtype=jnp.float32)
    np.testing.assert_allclose(quant.int8_dynamic_matmul(xt, wt, out_dtype=torch.float32)
                               .numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("mode", MODES)
def test_straight_through_gradients_match_jax(mode):
    """The gradients through the int8 product are the exact product's
    (jax.grad through JAX's custom_vjp), for a 3-D input; amax gets none."""
    rng = np.random.RandomState(2)
    x = rng.randn(2, 4, 32).astype(np.float32)
    w = (rng.randn(32, 16) * 0.1).astype(np.float32)
    amax = float(np.abs(x).max())

    def jax_loss(x, w):
        if mode == "int8_static":
            return jnp.sum(jnp.sin(jax_quant.int8_static_matmul(x, w, amax)))
        return jnp.sum(jnp.sin(jax_quant.int8_dynamic_matmul(x, w)))

    gx_want, gw_want = jax.grad(jax_loss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w.T.copy()).requires_grad_()
    amax_t = torch.tensor(amax, requires_grad=True)
    if mode == "int8_static":
        y = quant.int8_static_matmul(xt, wt, amax_t)
    else:
        y = quant.int8_dynamic_matmul(xt, wt)
    torch.sin(y).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx_want), **TOL)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(gw_want).T, **TOL)
    assert wt.grad.abs().max() > 0 and amax_t.grad is None


def test_gradients_in_the_input_dtypes():
    """A bf16 activation and an fp32 weight (mixed-precision QAT) get
    gradients in their own dtypes."""
    x = torch.randn(3, 7, 16, generator=torch.Generator().manual_seed(0))
    xt = x.bfloat16().requires_grad_()
    wt = torch.randn(8, 16, generator=torch.Generator().manual_seed(1)).requires_grad_()
    quant.int8_dynamic_matmul(xt, wt, out_dtype=torch.bfloat16).float().sum().backward()
    assert xt.grad.dtype == torch.bfloat16 and wt.grad.dtype == torch.float32
    np.testing.assert_allclose(wt.grad.numpy(), (torch.ones(21, 8).t() @ x.bfloat16().float()
                                                 .reshape(21, 16)).numpy(), rtol=1e-5)


@pytest.mark.parametrize("field,value", [("quant", "int4"), ("quant", "int8"),
                                         ("quant_scope", "decoder"), ("quant_scope", "ALL")])
def test_policy_validation_matches_jax(field, value):
    """A bad value raises JAX's ValueError with JAX's message, when the
    port's Policy is made (JAX: when quant_enabled reads it)."""
    with pytest.raises(ValueError) as want:
        jax_config.quant_enabled(dataclasses.replace(jax_config.PARITY, **{field: value}))
    with pytest.raises(ValueError) as got:
        dataclasses.replace(port_config.PARITY, **{field: value})
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("q", [None, "int8_dynamic", "int8_static"])
@pytest.mark.parametrize("scope", ["all", "latent"])
def test_quant_enabled_and_mode_match_jax(q, scope):
    jax_pol = dataclasses.replace(jax_config.PARITY, quant=q, quant_scope=scope)
    port_pol = dataclasses.replace(port_config.PARITY, quant=q, quant_scope=scope)
    for site in ("latent", "cross"):
        assert port_config.quant_enabled(port_pol, site) == jax_config.quant_enabled(
            jax_pol, site)
        assert port_config.quant_mode(port_pol, site) == jax_config.quant_mode(jax_pol, site)


def test_int8_presets_match_jax():
    for name in ("PERFORMANCE_INT8", "PERFORMANCE_INT8_STATIC"):
        got, want = getattr(port_config, name), getattr(jax_config, name)
        assert (got.quant, got.quant_scope, got.compute_dtype, got.gelu_approximate) == (
            want.quant, want.quant_scope, torch.bfloat16, want.gelu_approximate)


def _policies(mode, scope="all"):
    return (dataclasses.replace(jax_config.PARITY, quant=mode, quant_scope=scope),
            dataclasses.replace(port_config.PARITY, quant=mode, quant_scope=scope))


def _cross_blocks(mode, scope, q, kv):
    jax_pol, port_pol = _policies(mode, scope)
    jm = jax_blocks.CrossAttention(q_in_channels=32, kv_in_channels=48, num_heads=4,
                                   policy=jax_pol)
    variables = jm.init(jax.random.PRNGKey(0), q, kv)
    pm = port_blocks.CrossAttention(q_in_channels=32, kv_in_channels=48, num_heads=4,
                                    policy=port_pol)
    pm.load_state_dict(state_dict_from_flax({"params": variables["params"]}), strict=False)
    return jm, variables, pm


@pytest.mark.parametrize("mode", MODES)
def test_latent_scope_cross_attention_is_exact(mode):
    """Under quant_scope="latent" a CrossAttention block is bit for bit the
    exact one and holds no amax; under "all" it quantizes (and matches
    JAX's quantized block, calibrated on the same input)."""
    rng = np.random.RandomState(3)
    q = rng.randn(2, 6, 32).astype(np.float32)
    kv = rng.randn(2, 10, 48).astype(np.float32)
    _, _, latent = _cross_blocks(mode, "latent", q, kv)
    exact = port_blocks.CrossAttention(q_in_channels=32, kv_in_channels=48, num_heads=4,
                                       policy=port_config.PARITY)
    exact.load_state_dict(latent.state_dict(), strict=True)
    args = (torch.from_numpy(q), torch.from_numpy(kv))
    with torch.no_grad():
        assert torch.equal(latent(*args), exact(*args))
    jm, variables, every = _cross_blocks(mode, "all", q, kv)
    every.load_state_dict(exact.state_dict(), strict=False)
    if mode == "int8_static":
        _, stats = jm.apply(variables, q, kv, mutable=["quant_stats"])
        variables = {**variables, **stats}
        quant.calibrate(every, [args])
    want = jm.apply(variables, q, kv)
    with torch.no_grad():
        got = every(*args)
        assert not torch.equal(got, exact(*args))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("mode", MODES)
def test_self_attention_block_matches_jax(mode):
    """A quantized SelfAttention block (4 projections and the MLP) with JAX's
    weights against JAX's; the static one calibrated on the same input on
    both sides, its six amax values equal to JAX's quant_stats."""
    rng = np.random.RandomState(5)
    x = rng.randn(2, 7, 32).astype(np.float32)
    jax_pol, port_pol = _policies(mode)
    jm = jax_blocks.SelfAttention(in_channels=32, num_heads=4, policy=jax_pol)
    variables = jm.init(jax.random.PRNGKey(1), x)
    pm = port_blocks.SelfAttention(in_channels=32, num_heads=4, policy=port_pol)
    sd = state_dict_from_flax(variables)
    pm.load_state_dict(sd, strict=True)
    if mode == "int8_static":
        # init recorded amax from x: the port's calibration must give the same
        for name in [n for n in sd if n.endswith("amax")]:
            pm.get_buffer(name).zero_()
        quant.calibrate(pm, [(torch.from_numpy(x),)])
        got_stats = {n: b.item() for n, b in pm.named_buffers() if n.endswith("amax")}
        assert len(got_stats) == 6
        for name, value in got_stats.items():
            np.testing.assert_allclose(value, sd[name].item(), rtol=1e-6)
    with torch.no_grad():
        got = pm(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(jm.apply(variables, x)), **TOL)


def test_lora_under_quant_quantizes_the_merged_weight():
    """``wrap_loss`` hands the int8 projections W + (a @ b)^T through
    ``functional_call``: the loss equals the merged model's bit for bit
    (not the frozen base's), and the straight-through gradients reach the
    adapters."""
    from perceiverio_pytorch_tpu_torch.models.language import LanguagePerceiver
    from perceiverio_pytorch_tpu_torch.training import lora

    policy = dataclasses.replace(port_config.PARITY, quant="int8_dynamic")
    kw = dict(vocab_size=262, max_seq_len=16, embed_dim=16, num_self_attends_per_block=1,
              num_blocks=1, num_latents=4, num_latent_channels=32, policy=policy,
              device="cpu")
    base = LanguagePerceiver(**kw, generator=torch.Generator().manual_seed(0))
    adapters = lora.init_lora(base.state_dict(), 2,
                              generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        for p in adapters.parameters():
            p.add_(torch.randn(p.shape, generator=torch.Generator().manual_seed(2)) * 0.1)
    tokens = torch.from_numpy(np.random.RandomState(0).randint(6, 262, (2, 16)))
    mask = torch.ones(2, 16, dtype=torch.bool)

    def loss_fn(model, tokens, mask):
        return model(tokens, mask).float().square().mean()

    loss = lora.wrap_loss(loss_fn, base)(adapters, tokens, mask)
    merged = LanguagePerceiver(**kw)
    merged.load_state_dict(lora.merge_lora(base.state_dict(), adapters), strict=True)
    with torch.no_grad():
        assert torch.equal(loss.detach(), loss_fn(merged, tokens, mask))
        assert not torch.equal(loss.detach(), loss_fn(base, tokens, mask))
    loss.backward()
    grads = [p.grad for p in adapters.parameters()]
    assert all(g is not None for g in grads) and max(g.abs().max() for g in grads) > 0
