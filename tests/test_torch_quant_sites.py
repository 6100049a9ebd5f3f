"""Which projections of the port's models quantize, and the multimodal
model's static int8, against the JAX package.

Model by model (the three classifier preprocessings, the byte MLM, flow,
multimodal), the port's ``amax`` buffers under int8_static against the JAX
model's ``quant_stats`` paths (the attention and MLP projections of every
attention block, no other Dense), and no ``amax`` under any other mode;
``quant_scope="latent"`` in a model; the language model's calibrated
``quant_stats`` carried by ``state_dict_from_flax`` under the language
overrides; the tiny multimodal model: ``amax`` folded over the decoder
chunks equal to JAX's, static outputs that do not depend on the chunk
count, and ``quant_error_report``'s keys (the output dict's).  Inputs are
made with numpy.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from perceiverio_pytorch_tpu import config as jax_config
from perceiverio_pytorch_tpu.models import classification as jax_cls
from perceiverio_pytorch_tpu.models import flow as jax_flow
from perceiverio_pytorch_tpu.models import language as jax_lang
from perceiverio_pytorch_tpu.models import multimodal as jax_mm
from perceiverio_pytorch_tpu.ops import quant as jax_quant
from perceiverio_pytorch_tpu_torch import config as port_config
from perceiverio_pytorch_tpu_torch.models import classification as port_cls
from perceiverio_pytorch_tpu_torch.models import flow as port_flow
from perceiverio_pytorch_tpu_torch.models import language as port_lang
from perceiverio_pytorch_tpu_torch.models import multimodal as port_mm
from perceiverio_pytorch_tpu_torch.ops import quant
from perceiverio_pytorch_tpu_torch.utils.weights import (
    LANGUAGE_OVERRIDES,
    LANGUAGE_TIED,
    state_dict_from_flax,
    translate_path,
)

torch.set_num_threads(1)
TOL = dict(rtol=2e-4, atol=2e-5)
# As in tests/test_torch_quant_models.py: amax is a max over the exact
# path's fp32 activations, which agree with JAX's to their last bits.
AMAX_RTOL = 2e-5
CLS = dict(num_classes=7, img_size=(32, 32), num_self_attends_per_block=2, num_blocks=2,
           num_latents=8, num_latent_channels=32)
MM = dict(img_size=(16, 16), num_frames=2, num_classes=11, audio_samples_per_frame=128,
          audio_samples_per_patch=16, num_self_attends_per_block=1, num_blocks=2,
          num_latents=8, num_latent_channels=512)


def _policies(mode):
    return (dataclasses.replace(jax_config.PARITY, quant=mode),
            dataclasses.replace(port_config.PARITY, quant=mode))


def _zero_stats(variables):
    return {**variables, "quant_stats": jax.tree_util.tree_map(
        jnp.zeros_like, variables["quant_stats"])}


def _clip(seed):
    rng = np.random.RandomState(seed)
    return (rng.rand(1, 2, 3, 16, 16).astype(np.float32),
            rng.uniform(-1, 1, (1, 256, 1)).astype(np.float32))


def test_multimodal_amax_folds_over_chunks_as_jax():
    """JAX unrolls its chunk scan to calibrate; the port's chunks share one
    decoder, whose amax is the max over every chunk: equal to JAX's.  The
    static outputs do not depend on the chunk count, and the
    ``quant_error_report`` keys are the output dict's, as JAX's."""
    jax_pol, port_pol = _policies("int8_static")
    jm = jax_mm.MultiModalPerceiver(policy=jax_pol, **MM)
    images, audio = _clip(8)
    variables = jax.jit(lambda k, i, a: jm.init(k, i, a, 2))(jax.random.PRNGKey(0), images,
                                                           audio)
    calibrated = jax_quant.calibrate(jm, _zero_stats(variables), [(images, audio)], n_chunks=2)
    model = port_mm.MultiModalPerceiver(policy=port_pol, device="cpu", **MM)
    model.load_state_dict(state_dict_from_flax(_zero_stats(variables)), strict=True)
    args = (torch.from_numpy(images), torch.from_numpy(audio))
    quant.calibrate(model, [args], n_chunks=2)
    want = state_dict_from_flax({"quant_stats": calibrated["quant_stats"]})
    got = {n: b.item() for n, b in model.named_buffers() if n.endswith("amax")}
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_allclose(got[name], want[name].item(), rtol=AMAX_RTOL)
    with torch.no_grad():
        out2 = model(*args, n_chunks=2)
        out4 = model(*args, n_chunks=4)
    for key in out2:
        np.testing.assert_allclose(out2[key].numpy(), out4[key].numpy(), **TOL)
    report = quant.quant_error_report(model, [args], n_chunks=2)
    want_report = jax_quant.quant_error_report(jm, calibrated, [(images, audio)], n_chunks=2)
    assert set(report) == set(want_report) == {"['audio']", "['image']", "['label']"}


def _jax_sites(jm, *args, n_chunks=None):
    extra = () if n_chunks is None else (n_chunks,)
    variables = jax.jit(lambda k, *a: jm.init(k, *a, *extra))(jax.random.PRNGKey(0), *args)
    return {translate_path(path, "quant_stats") for path, _ in _flat(variables["quant_stats"])}


def _flat(tree, prefix=()):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _flat(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def _port_sites(model):
    return {n for n, _ in model.named_buffers() if n.endswith(".amax")}


@pytest.mark.parametrize("family", ["pixel", "1x1conv", "convnet", "language", "flow",
                                    "multimodal"])
def test_quantized_projections_are_jax_s(family):
    """Which projections quantize: under int8_static each has an amax, in
    the JAX model's quant_stats and in the port's buffers; the same set
    (the attention and MLP projections of every attention block, no other
    Dense).  No model without static quant holds an amax."""
    jax_pol, port_pol = _policies("int8_static")
    if family in ("pixel", "1x1conv", "convnet"):
        prep = {"pixel": "FOURIER_POS_PIXEL", "1x1conv": "LEARNED_POS_1X1CONV",
                "convnet": "FOURIER_POS_CONVNET"}[family]
        kw = CLS
        want = _jax_sites(jax_cls.ClassificationPerceiver(
            policy=jax_pol, prep_type=jax_cls.PrepType[prep], **kw), np.zeros((1, 3, 32, 32),
                                                                              np.float32))
        make = lambda pol: port_cls.ClassificationPerceiver(  # noqa: E731
            policy=pol, prep_type=port_cls.PrepType[prep], device="cpu", **kw)
    elif family == "language":
        kw = dict(vocab_size=262, max_seq_len=32, embed_dim=16, num_self_attends_per_block=2,
                  num_blocks=2, num_latents=8, num_latent_channels=64)
        tokens = np.zeros((1, 32), np.int32)
        want = _jax_sites(jax_lang.LanguagePerceiver(policy=jax_pol, **kw), tokens,
                          np.ones((1, 32), bool))
        make = lambda pol: port_lang.LanguagePerceiver(policy=pol, device="cpu", **kw)  # noqa
    elif family == "flow":
        kw = dict(img_size=(16, 24), num_latents=8, num_latent_channels=32,
                  num_self_attends_per_block=2)
        frame = np.zeros((1, 3, 16, 24), np.float32)
        want = _jax_sites(jax_flow.FlowPerceiver(policy=jax_pol, **kw), frame, frame)
        make = lambda pol: port_flow.FlowPerceiver(policy=pol, device="cpu", **kw)  # noqa
    else:
        images, audio = _clip(0)
        want = _jax_sites(jax_mm.MultiModalPerceiver(policy=jax_pol, **MM), images, audio,
                          n_chunks=2)
        make = lambda pol: port_mm.MultiModalPerceiver(policy=pol, device="cpu", **MM)  # noqa
    assert want and _port_sites(make(port_pol)) == want
    for mode in (None, "int8_dynamic"):
        model = make(dataclasses.replace(port_config.PARITY, quant=mode))
        assert not _port_sites(model)
        assert sum(getattr(m, "quant", None) == "int8_dynamic"
                   for m in model.modules()) == (len(want) if mode else 0)


def test_latent_scope_leaves_cross_attention_exact_in_a_model():
    """quant_scope="latent" quantizes the self-attends' projections only."""
    policy = dataclasses.replace(port_config.PARITY, quant="int8_static", quant_scope="latent")
    model = port_cls.ClassificationPerceiver(prep_type=port_cls.PrepType.FOURIER_POS_PIXEL,
                                             policy=policy, device="cpu", **CLS)
    sites = _port_sites(model)
    assert sites and all(".self_attends." in n for n in sites)


def test_state_dict_from_flax_carries_language_amax():
    """quant_stats under the language model's overrides: the amax names are
    the port's buffers', and the load is strict."""
    jax_pol, port_pol = _policies("int8_static")
    kw = dict(vocab_size=262, max_seq_len=32, embed_dim=16, num_self_attends_per_block=2,
              num_blocks=1, num_latents=8, num_latent_channels=64)
    tokens = np.random.RandomState(0).randint(6, 262, (2, 32)).astype(np.int32)
    mask = np.ones((2, 32), bool)
    jm = jax_lang.LanguagePerceiver(policy=jax_pol, **kw)
    variables = jax.jit(jm.init)(jax.random.PRNGKey(0), tokens, mask)
    model = port_lang.LanguagePerceiver(policy=port_pol, device="cpu", **kw).eval()
    model.load_state_dict(state_dict_from_flax(variables, overrides=LANGUAGE_OVERRIDES,
                                               tied=LANGUAGE_TIED), strict=True)
    assert all(b.item() > 0 for n, b in model.named_buffers() if n.endswith("amax"))
    with torch.no_grad():
        got = model(torch.from_numpy(tokens).long(), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(jax.jit(jm.apply)(variables, tokens,
                                                                          mask)), **TOL)
