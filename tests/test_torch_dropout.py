"""Dropout and stochastic input masking in the port against the JAX
package's formulas.

The draws cannot be JAX's bits, so the JAX side runs with
``jax.random.bernoulli`` recorded and the port replays those masks through
its one drawing function (``keep_mask``): the attention-probability,
post-attention and MLP dropout of ``SelfAttention`` and ``CrossAttention``
and the token masking of ``MultimodalPreprocessor`` then match JAX's
outputs on the same masks (rtol 2e-4, atol 2e-5).  The rate and scaling of
the port's own draws, eval mode against ``dropout_prob = 0``, seeds that
reproduce their masks, gradients under remat against those without, bit for
bit under one seed, and the dense path at a dropout site.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from perceiverio_pytorch_tpu.core import attention as jax_blocks
from perceiverio_pytorch_tpu.core import perceiver as jax_perceiver
from perceiverio_pytorch_tpu.ops.attention_xla import attend_xla
from perceiverio_pytorch_tpu_torch import config as port_config
from perceiverio_pytorch_tpu_torch.core import attention as port_blocks
from perceiverio_pytorch_tpu_torch.core import perceiver as port_perceiver
from perceiverio_pytorch_tpu_torch.ops import attention_dense
from perceiverio_pytorch_tpu_torch.ops import flash_attention as fa
from perceiverio_pytorch_tpu_torch.utils.weights import state_dict_from_flax

torch.set_num_threads(1)
TOL = dict(rtol=2e-4, atol=2e-5)


@pytest.fixture
def jax_masks(monkeypatch):
    """Every ``jax.random.bernoulli`` draw of the JAX side, in order."""
    masks = []
    real = jax.random.bernoulli

    def record(key, p=0.5, shape=None):
        mask = real(key, p, shape)
        masks.append((float(p), np.array(mask)))
        return mask

    monkeypatch.setattr(jax.random, "bernoulli", record)
    return masks


def _replay(monkeypatch, masks, module=attention_dense):
    """The port draws ``masks`` in order instead of its own."""
    queue = list(masks)

    def replay(shape, prob, generator, device):
        want_prob, mask = queue.pop(0)
        assert tuple(shape) == mask.shape and prob == pytest.approx(want_prob)
        return torch.from_numpy(mask).to(device)

    monkeypatch.setattr(module, "keep_mask", replay)
    return queue


def test_dense_attention_dropout_matches_attention_xla(jax_masks, monkeypatch):
    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal((2, n, 3, 8), dtype=np.float32) for n in (6, 9, 9))
    want = attend_xla(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), dropout_rate=0.25,
                      dropout_rng=jax.random.PRNGKey(1))
    assert len(jax_masks) == 1 and jax_masks[0][1].shape == (2, 3, 6, 9)
    left = _replay(monkeypatch, jax_masks)
    got = attention_dense.attend_dense(*(torch.from_numpy(x) for x in (q, k, v)),
                                       dropout_rate=0.25,
                                       dropout_generator=torch.Generator())
    assert not left
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _eager_apply(module, variables, *args, seed=3):
    return np.asarray(module.apply(variables, *args, deterministic=False,
                                   rngs={"dropout": jax.random.PRNGKey(seed)}))


@pytest.mark.parametrize("block", ["self", "cross"])
def test_block_dropout_matches_jax_on_its_masks(block, jax_masks, monkeypatch):
    """Attention probabilities (``dropout_attn_prob``), the attention's
    output and the MLP's (``dropout_prob``), in JAX's order, on JAX's masks."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 6, 16), dtype=np.float32)
    kv = rng.standard_normal((2, 11, 12), dtype=np.float32)
    probs = dict(dropout_prob=0.3, dropout_attn_prob=0.2)
    if block == "self":
        kw = dict(in_channels=16, num_heads=2, widening_factor=2)
        jm, cls, args = jax_blocks.SelfAttention(**kw, **probs), port_blocks.SelfAttention, (x,)
    else:
        kw = dict(q_in_channels=16, kv_in_channels=12, num_heads=2, widening_factor=2)
        jm, cls, args = (jax_blocks.CrossAttention(**kw, **probs),
                         port_blocks.CrossAttention, (x, kv))
    variables = jax.jit(jm.init)(jax.random.PRNGKey(0), *args)
    want = _eager_apply(jm, variables, *args)
    assert [p for p, _ in jax_masks] == [pytest.approx(0.8), pytest.approx(0.7),
                                         pytest.approx(0.7)]
    pm = cls(**kw, **probs, policy=port_config.PARITY)
    pm.load_state_dict(state_dict_from_flax(variables), strict=True)
    left = _replay(monkeypatch, jax_masks)
    with torch.no_grad():
        got = pm.train()(*(torch.from_numpy(a) for a in args), dropout_seed=5)
    assert not left
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # Eval mode is the deterministic block, as JAX's deterministic=True.
    with torch.no_grad():
        det = pm.eval()(*(torch.from_numpy(a) for a in args))
    np.testing.assert_allclose(det.numpy(), np.asarray(jm.apply(variables, *args)), **TOL)


def test_mlp_dropout_formula(jax_masks, monkeypatch):
    x = np.random.default_rng(2).standard_normal((3, 5, 8), dtype=np.float32)
    jm = jax_blocks.MLP(in_channels=8, widening_factor=2, dropout_prob=0.4)
    variables = jax.jit(jm.init)(jax.random.PRNGKey(0), x)
    want = _eager_apply(jm, variables, x)
    pm = port_blocks.MLP(in_channels=8, widening_factor=2, dropout_prob=0.4,
                         policy=port_config.PARITY)
    pm.load_state_dict(state_dict_from_flax(variables), strict=True)
    _replay(monkeypatch, jax_masks)
    with torch.no_grad():
        got = pm.train()(torch.from_numpy(x), dropout_seed=1).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    plain = np.asarray(jm.apply(variables, x))
    keep = jax_masks[0][1]
    np.testing.assert_allclose(got, np.where(keep, plain / 0.6, 0.0), **TOL)


def test_dropout_rate_scaling_and_seeds():
    """The kept share within 4 sigma of 1 - rate, kept entries scaled by
    1 / (1 - rate); a seed reproduces its mask, another seed does not;
    rate 0 is the identity and rate 1 gives zeros."""
    x = torch.ones(400, 500)
    rate = 0.1
    out = attention_dense.dropout(x, rate, attention_dense.site_generator(7, 0, "cpu"))
    kept = (out != 0).float().mean().item()
    sigma = (rate * (1 - rate) / x.numel()) ** 0.5
    assert abs(kept - (1 - rate)) < 4 * sigma
    assert torch.allclose(out[out != 0], torch.full((), 1 / (1 - rate)))
    again = attention_dense.dropout(x, rate, attention_dense.site_generator(7, 0, "cpu"))
    other = attention_dense.dropout(x, rate, attention_dense.site_generator(7, 1, "cpu"))
    assert torch.equal(out, again) and not torch.equal(out, other)
    assert attention_dense.dropout(x, 0.0, None) is x
    assert torch.equal(attention_dense.dropout(x, 1.0, torch.Generator()), torch.zeros_like(x))
    with pytest.raises(ValueError, match="generator"):
        attention_dense.dropout(x, rate, None)


ENCODER = dict(num_input_channels=12, num_self_attends_per_block=2, num_blocks=2,
               num_latents=8, num_latent_channels=32, num_self_attend_heads=4)


def _encoder(dropout, remat=False, remat_policy=None, impl="dense"):
    policy = port_config.Policy(compute_dtype=torch.float32, attn_impl=impl,
                                remat_policy=remat_policy)
    return port_perceiver.PerceiverEncoder(
        **ENCODER, remat=remat, policy=policy, dropout_prob=dropout,
        dropout_attn_prob=dropout, generator=torch.Generator().manual_seed(0))


def _encode(model, seed, inputs):
    generator = None if seed is None else torch.Generator().manual_seed(seed)
    return model(inputs, model.latents(inputs), generator=generator)


def test_encoder_eval_mode_equals_no_dropout():
    inputs = torch.from_numpy(np.random.default_rng(3).standard_normal((2, 20, 12),
                                                                       dtype=np.float32))
    with torch.no_grad():
        want = _encode(_encoder(0.0).eval(), None, inputs)
        got = _encode(_encoder(0.3).eval(), None, inputs)
        trained = _encode(_encoder(0.3).train(), 1, inputs)
    assert torch.equal(got, want)
    assert not torch.allclose(trained, want)
    with pytest.raises(ValueError, match="generator"):
        _encode(_encoder(0.3).train(), None, inputs)


@pytest.mark.parametrize("remat_policy", [None, "dots_saveable"])
def test_encoder_dropout_gradients_under_remat_equal_without(remat_policy):
    """Dropout in every site of a 2-block encoder with remat: the recompute
    draws the masks of the forward, so one seed gives the gradients of the
    run without remat, bit for bit; another seed gives other ones."""
    inputs = torch.from_numpy(np.random.default_rng(4).standard_normal((2, 20, 12),
                                                                       dtype=np.float32))
    grads = {}
    for remat, seed in ((False, 9), (True, 9), (True, 10)):
        model = _encoder(0.2, remat=remat, remat_policy=remat_policy).train()
        _encode(model, seed, inputs).square().mean().backward()
        grads[remat, seed] = {n: p.grad.clone() for n, p in model.named_parameters()}
    for name, want in grads[False, 9].items():
        assert torch.equal(grads[True, 9][name], want), name
    assert any(not torch.equal(grads[True, 10][n], g) for n, g in grads[False, 9].items())


def test_dropout_site_takes_the_dense_path():
    """Under attn_impl="flash" a site with attention dropout in train mode
    runs dense, as in JAX; in eval mode it goes back to the flash op."""
    inputs = torch.from_numpy(np.random.default_rng(5).standard_normal((1, 20, 12),
                                                                       dtype=np.float32))
    model = _encoder(0.2, impl="flash")
    calls = []
    real = fa.flash_attention

    def counted(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr("perceiverio_pytorch_tpu_torch.ops.attention.flash_attention", counted)
        with torch.no_grad():
            _encode(model.train(), 2, inputs)
            assert not calls
            _encode(model.eval(), None, inputs)
    assert len(calls) == 1 + ENCODER["num_blocks"] * ENCODER["num_self_attends_per_block"]


def test_mask_probs_match_jax_on_its_masks(jax_masks, monkeypatch):
    """A probability strictly between 0 and 1 mixes each drawn token with
    the mask token as JAX does; 0 and 1 keep their exact branches (none,
    all)."""
    rng = np.random.default_rng(6)
    channels = {"a": 5, "b": 7, "c": 6}
    probs = {"a": 0.4, "b": 1.0, "c": 0.0}
    inputs = {"a": rng.standard_normal((2, 30, 5), dtype=np.float32),
              "b": rng.standard_normal((2, 4, 7), dtype=np.float32),
              "c": rng.standard_normal((2, 3, 6), dtype=np.float32)}
    jm = jax_perceiver.MultimodalPreprocessor(mask_probs=probs, min_padding_size=2,
                                              input_channels=channels)
    j_in = {m: jnp.asarray(x) for m, x in inputs.items()}
    variables = jm.init({"params": jax.random.PRNGKey(0), "mask": jax.random.PRNGKey(1)}, j_in)
    del jax_masks[:]
    want, _, _ = jm.apply(variables, j_in, rngs={"mask": jax.random.PRNGKey(2)})
    assert len(jax_masks) == 1 and jax_masks[0][1].shape == (2, 30, 1)
    pm = port_perceiver.MultimodalPreprocessor(
        mask_probs=probs, min_padding_size=2, input_channels=channels)
    pm.load_state_dict(state_dict_from_flax(variables), strict=True)
    left = _replay(monkeypatch, jax_masks, port_perceiver)
    with torch.no_grad():
        got, _, _ = pm({m: torch.from_numpy(x) for m, x in inputs.items()})
    assert not left
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    token_b = pm.mask_tokens["b"].pos_embs.detach().numpy()[0]
    np.testing.assert_array_equal(got.numpy()[:, 30:34], np.broadcast_to(token_b, (2, 4, 9)))
    np.testing.assert_array_equal(got.numpy()[:, 34:, :6], inputs["c"])


def test_mask_probs_rate_and_seed():
    """The masked share within 4 sigma of the probability; the same seed
    gives the same mask, the constructor's generator when the forward has
    none."""
    pm = port_perceiver.MultimodalPreprocessor(
        mask_probs={"a": 0.15}, input_channels={"a": 3}, min_padding_size=0)
    x = {"a": torch.zeros(4, 5000, 3)}
    with torch.no_grad():
        out, _, _ = pm(x, generator=torch.Generator().manual_seed(3))
        again, _, _ = pm(x, generator=torch.Generator().manual_seed(3))
        own, _, _ = pm(x)
        own2, _, _ = pm(x)
    share = (out != 0).any(-1).float().mean().item()
    assert abs(share - 0.15) < 4 * (0.15 * 0.85 / 20000) ** 0.5
    assert torch.equal(out, again)
    assert not torch.equal(own, own2)  # the constructor's generator moves on
