"""The port's language slice against the JAX package's.

The byte tokenizer, the embedding pre- and postprocessors with their tied
table, then the whole ``LanguagePerceiver`` at the golden configuration
(32 bytes, 16-channel embedding, 8 latents x 64, 2 self-attends) with a
partial input mask, whole and at ``predict_positions``: against the JAX
model with random weights carried by ``state_dict_from_flax`` (the tied
table placed by ``LANGUAGE_OVERRIDES`` and ``LANGUAGE_TIED``), and against
``tests/goldens/language.npz`` loaded strictly.  Inputs are made with
numpy.
"""

import dataclasses
import json
import os

import flax.linen as flax_nn
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from perceiverio_pytorch_tpu import config as jax_config
from perceiverio_pytorch_tpu.io_processors import postprocessors as jax_post
from perceiverio_pytorch_tpu.io_processors import preprocessors as jax_pre
from perceiverio_pytorch_tpu.models import language as jax_lang
from perceiverio_pytorch_tpu.ops import attention as jax_ops
from perceiverio_pytorch_tpu.utils import bytes_tokenizer as jax_tok
from perceiverio_pytorch_tpu.utils.torch_checkpoint import (
    LANGUAGE_OVERRIDES as JAX_OVERRIDES,
    LANGUAGE_TIED as JAX_TIED,
    export_state_dict,
)
from perceiverio_pytorch_tpu_torch import BytesTokenizer
from perceiverio_pytorch_tpu_torch import config as port_config
from perceiverio_pytorch_tpu_torch.io_processors import postprocessors as port_post
from perceiverio_pytorch_tpu_torch.io_processors import preprocessors as port_pre
from perceiverio_pytorch_tpu_torch.models import language as port_lang
from perceiverio_pytorch_tpu_torch.ops import attention as port_ops
from perceiverio_pytorch_tpu_torch.ops import flash_attention as fa
from perceiverio_pytorch_tpu_torch.utils import bytes_tokenizer as port_tok
from perceiverio_pytorch_tpu_torch.utils.weights import (
    LANGUAGE_OVERRIDES,
    LANGUAGE_TIED,
    state_dict_from_flax,
)

torch.set_num_threads(1)
TOL = dict(rtol=2e-4, atol=2e-5)
GOLDEN = os.path.join(os.path.dirname(__file__), "goldens", "language.npz")
# The golden configuration (tests/make_goldens.py `language`).
SMALL = dict(vocab_size=262, max_seq_len=32, embed_dim=16, num_self_attends_per_block=2,
             num_blocks=1, num_latents=8, num_latent_channels=64)
POSITIONS = np.array([3, 17, 0, 25, 31, 9])


def _perturbed(variables, seed, scale=0.1):
    """The JAX init's params with seeded noise on the 1-D ones (LayerNorm
    scales and biases, Dense biases, the decode bias)."""
    rng = np.random.default_rng(seed)

    def perturb(x):
        x = np.asarray(x)
        if x.ndim != 1:
            return x
        return x + scale * rng.standard_normal(x.shape).astype(np.float32)

    return {**variables, "params": jax.tree_util.tree_map(perturb, variables["params"])}


def _tokens(seed, batch=2, length=32):
    """Tokenizer-encoded seeded text, right-padded, with a masked span: ids,
    mask (False at padding)."""
    rng = np.random.default_rng(seed)
    rows, masks = [], []
    for i in range(batch):
        text = "".join(chr(c) for c in rng.integers(32, 127, 20 - 3 * i)) + "é"
        ids = port_tok.encode(text)
        ids[4:8] = BytesTokenizer.mask_token
        rows.append(ids)
        masks.append(np.ones(len(ids), bool))
    width = max(len(r) for r in rows)
    ids = np.stack([np.pad(r, (0, width - len(r))) for r in rows])
    mask = np.stack([np.pad(m, (0, width - len(m))) for m in masks])
    return port_tok.pad_sequence(length, ids, mask)


# ---- the tokenizer ---------------------------------------------------------


def test_tokenizer_matches_jax():
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 262, 500)
    assert port_tok.decode(ids) == jax_tok.decode(ids)
    for text in ("Perceiver IO", "bytes: \x00\xff", "héllo wörld ✓ 🙂", b"\xc3\x28raw", ""):
        np.testing.assert_array_equal(port_tok.encode(text), jax_tok.encode(text))
        assert port_tok.encode(text).dtype == np.int32
        assert port_tok.decode(port_tok.encode(text)) == jax_tok.decode(jax_tok.encode(text))
    tok, jtok = BytesTokenizer(), jax_tok.BytesTokenizer()
    for name in ("pad_token", "bos_token", "eos_token", "mask_token", "cls_token", "sep_token",
                 "vocab_size"):
        assert getattr(tok, name) == getattr(jtok, name), name
    ids, mask = rng.integers(6, 262, (3, 10)), rng.random((3, 10)) > 0.2
    for got, want in zip(port_tok.pad_sequence(16, ids, mask),
                         jax_tok.pad_sequence(16, ids, mask)):
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="exceeds"):
        port_tok.pad_sequence(8, ids, mask)


# ---- the embedding pre- and postprocessors --------------------------------


def test_embedding_preprocessor_matches_jax():
    tokens = np.random.default_rng(1).integers(0, 262, (2, 12))
    jm = jax_pre.EmbeddingPreprocessor(vocab_size=262, max_seq_len=12, embedding_dims=10)
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(tokens))
    want = jm.apply(variables, jnp.asarray(tokens))
    pm = port_pre.EmbeddingPreprocessor(vocab_size=262, max_seq_len=12, embedding_dims=10)
    pm.load_state_dict(state_dict_from_flax(variables), strict=True)
    assert pm.n_output_channels() == jm.n_output_channels() == 10
    with torch.no_grad():
        got = pm(torch.from_numpy(tokens))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_embedding_postprocessor_matches_jax(dtype):
    """The tied decode: fp32 inputs, and bf16 ones promoted to fp32 against
    the fp32 table (flax ``Embed.attend``)."""
    x = np.random.default_rng(2).standard_normal((2, 5, 10), dtype=np.float32)
    jm = jax_post.EmbeddingPostprocessor(embedding=flax_nn.Embed(262, 10), vocab_size=262)
    variables = _perturbed(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)), seed=3)
    want = jm.apply(variables, jnp.asarray(x, dtype=dtype))
    pm = port_post.EmbeddingPostprocessor(torch.nn.Embedding(262, 10), vocab_size=262)
    pm.load_state_dict(state_dict_from_flax(variables), strict=True)
    with torch.no_grad():
        got = pm(torch.from_numpy(x).to(getattr(torch, dtype)))
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# ---- the whole model -------------------------------------------------------


@pytest.fixture(scope="module")
def lm_variables():
    jm = jax_lang.LanguagePerceiver(policy=jax_config.PARITY, **SMALL)
    tokens, mask = _tokens(0)
    variables = jax.jit(jm.init)(jax.random.PRNGKey(0), tokens, mask)
    return _perturbed(jax.tree_util.tree_map(np.asarray, variables), seed=4)


def _port_model(variables, policy):
    model = port_lang.LanguagePerceiver(**SMALL, policy=policy, device="cpu")
    model.load_state_dict(state_dict_from_flax(variables, overrides=LANGUAGE_OVERRIDES,
                                               tied=LANGUAGE_TIED), strict=True)
    return model.eval()


def _jax_logits(variables, policy, tokens, mask, positions=None):
    jm = jax_lang.LanguagePerceiver(policy=policy, **SMALL)
    fn = jax.jit(lambda v, t, m: jm.apply(v, t, m, predict_positions=positions))
    return np.asarray(fn(variables, tokens, mask))


def _policies(impl):
    if impl == "dense":
        return jax_config.PARITY, port_config.PARITY
    return (jax_config.Policy(compute_dtype=jnp.float32, attn_impl="flash", interpret=True),
            dataclasses.replace(port_config.PARITY, attn_impl="flash"))


@pytest.mark.parametrize("impl", ["dense", "flash"])
@pytest.mark.parametrize("predict", [False, True])
def test_language_matches_jax(lm_variables, impl, predict):
    """A partial input mask (right padding), the whole 32-row decode or 6
    positions, on the dense path and through K1's plain version (Pallas in
    interpreter mode in JAX)."""
    jax_pol, port_pol = _policies(impl)
    tokens, mask = _tokens(1)
    assert 0 < mask.sum() < mask.size
    positions = POSITIONS if predict else None
    want = _jax_logits(lm_variables, jax_pol, tokens, mask, positions)
    model = _port_model(lm_variables, port_pol)
    with torch.no_grad():
        got = model(torch.from_numpy(tokens), torch.from_numpy(mask),
                    predict_positions=None if positions is None else torch.from_numpy(positions))
    assert got.shape == want.shape == (2, len(POSITIONS) if predict else 32, 262)
    assert got.dtype == torch.float32 and np.abs(want).max() > 0
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_predict_positions_are_rows_of_the_full_decode(lm_variables):
    """The rows at predict_positions are those rows of the full decode,
    padded positions (whose attention rows are wiped) among them."""
    tokens, mask = _tokens(2)
    model = _port_model(lm_variables, port_config.PARITY)
    positions = torch.tensor([30, 2, 5, 31, 0])
    assert not mask[:, 30:].any()
    with torch.no_grad():
        full = model(torch.from_numpy(tokens), torch.from_numpy(mask))
        some = model(torch.from_numpy(tokens), torch.from_numpy(mask), predict_positions=positions)
    np.testing.assert_allclose(some.numpy(), full[:, positions].numpy(), rtol=0, atol=1e-6)


def test_shared_embedding_is_one_parameter(lm_variables):
    """One nn.Embedding under both of the reference's names: the state_dict
    holds both keys, the parameters hold the table once."""
    model = _port_model(lm_variables, port_config.PARITY)
    pre = model.perceiver._multi_preprocessor._preprocessors["__default"]
    post = model.perceiver._output_postprocessors["__default"]
    assert pre.embed is post._embedding
    names = [n for n, _ in model.named_parameters()]
    assert len(list(model.parameters())) == len(names) == len(set(model.state_dict())) - 1
    assert sum(n.endswith("embed.weight") or n.endswith("_embedding.weight") for n in names) == 1
    sd = model.state_dict()
    assert {k for k in sd if k.endswith(("embed.weight", "_embedding.weight"))} == {
        "perceiver._multi_preprocessor._preprocessors.__default.embed.weight",
        "perceiver._output_postprocessors.__default._embedding.weight"}


def test_language_state_dict_from_flax_matches_export_state_dict(lm_variables):
    """The numpy copy of the JAX exporter, with the language overrides and
    tie, gives the JAX exporter's names and values, which are the port
    model's and the golden's state_dict keys."""
    want = export_state_dict(lm_variables, JAX_OVERRIDES, JAX_TIED)
    got = state_dict_from_flax(lm_variables, overrides=LANGUAGE_OVERRIDES, tied=LANGUAGE_TIED)
    assert (LANGUAGE_OVERRIDES, LANGUAGE_TIED) == (JAX_OVERRIDES, JAX_TIED)
    assert set(got) == set(want)
    for key, value in want.items():
        np.testing.assert_array_equal(got[key].numpy(), value, err_msg=key)
    port = port_lang.LanguagePerceiver(**SMALL, device="cpu").state_dict()
    golden = np.load(GOLDEN)
    assert set(port) == set(got) == {k[4:] for k in golden.files if k.startswith("sd::")}


def test_language_golden_replay():
    """tests/goldens/language.npz: the reference's weights (the tied table
    stored twice) load strictly and its logits replay, on the dense path and
    through the plain K1."""
    z = np.load(GOLDEN)
    kwargs = json.loads(bytes(z["meta"]).decode())["kwargs"]
    sd = {k[4:]: torch.from_numpy(z[k].astype(np.float32))
          for k in z.files if k.startswith("sd::")}
    before = fa.LAUNCHES
    for policy in (port_config.PARITY, dataclasses.replace(port_config.PARITY, attn_impl="flash")):
        model = port_lang.LanguagePerceiver(**kwargs, policy=policy, device="cpu")
        model.load_state_dict(sd, strict=True)
        with torch.no_grad():
            got = model.eval()(torch.from_numpy(z["in::tokens"]), torch.from_numpy(z["in::mask"]))
        np.testing.assert_allclose(got.numpy(), z["out::logits"], **TOL)
    assert fa.LAUNCHES == before


def test_language_bf16_matches_jax(lm_variables):
    """PERFORMANCE: bf16 GEMMs in the encoder and decoder, the embedding
    lookup fp32 until the encoder casts, and the 262-way decode an fp32
    product of the bf16 decoder output with the fp32 table, on both sides.
    Tolerance 5% of the logits' max |x|, as for flow and multimodal: each
    framework sums its bf16 products in its own order."""
    tokens, mask = _tokens(3)
    want = _jax_logits(lm_variables, jax_config.PERFORMANCE, tokens, mask)
    model = _port_model(lm_variables, port_config.PERFORMANCE)
    with torch.no_grad():
        got = model(torch.from_numpy(tokens), torch.from_numpy(mask))
    assert want.dtype == np.float32 and got.dtype == torch.float32
    assert np.abs(got.numpy() - want).max() <= 0.05 * np.abs(want).max()


@pytest.mark.parametrize("site,q_len,kv_len", [("encoder", 256, 2048), ("self", 256, 256),
                                               ("decoder", 2048, 256)])
@pytest.mark.parametrize("on_device", [True, False])
def test_attention_path_at_language_sites(site, q_len, kv_len, on_device):
    """The published model's sites under "auto" take the dense path on the
    card too, as the JAX dispatch decides on a TPU: 2,048 bytes and 256
    latents are below every flash threshold."""
    want = jax_ops.attention_path("auto", q_len=q_len, kv_len=kv_len,
                                  backend="tpu" if on_device else "cpu")
    got = port_ops.attention_path("auto", q_len=q_len, kv_len=kv_len, on_cuda=on_device)
    assert got == {"xla": "dense"}.get(want, want) == "dense"


def test_language_refuses_a_missing_gpu():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a GPU")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_lang.LanguagePerceiver(**SMALL)
