"""The port's multimodal slice against the JAX package's.

Module by module (the one-hot and audio preprocessors, the audio,
classification, projection and identity postprocessors, token masking with
probabilities 0 and 1, the query-pad fold, the decoder queries with
chunked subsampling), then the whole ``MultiModalPerceiver`` at the golden
configuration (16x16 frames, 2 of them, 11 classes, 8 latents x 512, 4
chunks): against the JAX model with random weights carried by
``state_dict_from_flax``, and against ``tests/goldens/multimodal.npz``
loaded strictly.  Inputs are made with numpy.
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
from perceiverio_pytorch_tpu.core import attention as jax_blocks
from perceiverio_pytorch_tpu.core import perceiver as jax_perceiver
from perceiverio_pytorch_tpu.core import queries as jax_queries
from perceiverio_pytorch_tpu.io_processors import postprocessors as jax_post
from perceiverio_pytorch_tpu.io_processors import preprocessors as jax_pre
from perceiverio_pytorch_tpu.models import flow as jax_flow
from perceiverio_pytorch_tpu.models import multimodal as jax_mm
from perceiverio_pytorch_tpu.ops import attention as jax_ops
from perceiverio_pytorch_tpu.utils.torch_checkpoint import export_state_dict
from perceiverio_pytorch_tpu_torch import config as port_config
from perceiverio_pytorch_tpu_torch.core import attention as port_blocks
from perceiverio_pytorch_tpu_torch.core import perceiver as port_perceiver
from perceiverio_pytorch_tpu_torch.core import queries as port_queries
from perceiverio_pytorch_tpu_torch.io_processors import postprocessors as port_post
from perceiverio_pytorch_tpu_torch.io_processors import preprocessors as port_pre
from perceiverio_pytorch_tpu_torch.models import flow as port_flow
from perceiverio_pytorch_tpu_torch.models import multimodal as port_mm
from perceiverio_pytorch_tpu_torch.ops import attention as port_ops
from perceiverio_pytorch_tpu_torch.ops import flash_attention as fa
from perceiverio_pytorch_tpu_torch.utils.weights import state_dict_from_flax

torch.set_num_threads(1)
TOL = dict(rtol=2e-4, atol=2e-5)
GOLDEN = os.path.join(os.path.dirname(__file__), "goldens", "multimodal.npz")
# The golden configuration (tests/make_goldens.py `multimodal`).
SMALL = dict(img_size=(16, 16), num_frames=2, num_classes=11, audio_samples_per_frame=128,
             audio_samples_per_patch=16, num_self_attends_per_block=1, num_blocks=1,
             num_latents=8, num_latent_channels=512)
N_CHUNKS = 4


def _jax_flash_policy(**kw):
    return jax_config.Policy(compute_dtype=jnp.float32, attn_impl="flash", interpret=True, **kw)


def _port_flash_policy(**kw):
    return port_config.Policy(compute_dtype=torch.float32, attn_impl="flash", **kw)


def _perturbed(variables, seed, scale=0.1):
    """The JAX init's params with seeded noise on the 1-D ones: LayerNorm
    scales and biases and every Dense bias move off 1 and 0, so that they
    show (in the fold above all)."""
    rng = np.random.default_rng(seed)

    def perturb(x):
        x = np.asarray(x)
        if x.ndim != 1:
            return x
        return x + scale * rng.standard_normal(x.shape).astype(np.float32)

    params = jax.tree_util.tree_map(perturb, variables.get("params", {}))
    return {**variables, "params": params}


def _port(module, variables):
    module.load_state_dict(state_dict_from_flax(variables), strict=True)
    return module.eval()


def _clip(seed, batch=1):
    rng = np.random.default_rng(seed)
    images = rng.random((batch, 2, 3, 16, 16), dtype=np.float32)
    audio = rng.uniform(-1, 1, (batch, 256, 1)).astype(np.float32)
    return images, audio


# ---- preprocessors ---------------------------------------------------------


def test_one_hot_preprocessor_matches_jax():
    x = np.random.default_rng(0).standard_normal((3, 11), dtype=np.float32)
    want = jax_pre.OneHotPreprocessor(input_channels=11).apply({}, jnp.asarray(x))
    pm = port_pre.OneHotPreprocessor(input_channels=11)
    got = pm(torch.from_numpy(x))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert pm.n_output_channels() == 11


# The published audio table gets its own atol, as the full flow table does in
# tests/test_torch_modules.py: the sine argument pi * f * x reaches 48,255
# (f up to 15,360), whose fp32 ulp is 3.9e-3, so JAX's table and the port's
# each lie up to ~1e-2 from the float64 table (9.4e-3 and 9.8e-3 measured)
# and differ from each other by up to ~1.6e-2 (1-ulp differences in
# positions and bands).  The waveform and position channels agree at TOL.
@pytest.mark.parametrize("samples,patch,bands,atol", [(256, 16, 8, 2e-5),
                                                      (30720, 16, 192, 2e-2)])
def test_audio_preprocessor_matches_jax(samples, patch, bands, atol):
    """Patches of the waveform with a Fourier encoding of the patch index;
    the second case is the published one (30,720 samples, 192 bands: 1,920
    tokens of 16 + 385 channels)."""
    kw = dict(samples_per_batch=samples, samples_per_patch=patch,
              fourier_position_encoding_kwargs=dict(
                  num_bands=bands, max_resolution=(samples,), sine_only=False,
                  concat_pos=True))
    x = np.random.default_rng(1).uniform(-1, 1, (2, samples, 1)).astype(np.float32)
    jm = jax_pre.AudioPreprocessor(**kw)
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want = jm.apply(variables, jnp.asarray(x))
    pm = port_pre.AudioPreprocessor(**kw)
    got = pm(torch.from_numpy(x))
    assert pm.n_output_channels() == jm.n_output_channels() == patch + 2 * bands + 1
    assert got[0].shape == (2, samples // patch, pm.n_output_channels())
    got_pos, want_pos = got[0].numpy(), np.asarray(want[0])
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), **TOL)
    np.testing.assert_allclose(got_pos[..., :patch + 1], want_pos[..., :patch + 1], **TOL)
    np.testing.assert_allclose(got_pos, want_pos, rtol=2e-4, atol=atol)
    if atol == TOL["atol"]:
        return
    # Both fp32 tables against the float64 one, each within half the atol.
    n = samples // patch
    pos = np.linspace(-1, 1, n)[:, None] * np.linspace(1, samples / 2, bands)[None]
    exact = np.concatenate([np.sin(np.pi * pos), np.cos(np.pi * pos)], axis=1)
    for table in (got_pos, want_pos):
        assert np.abs(table[0, :, patch + 1:] - exact).max() <= atol / 2


def test_audio_preprocessor_unported_options_raise():
    """Only "patches" is a prep type of the audio preprocessor, as in JAX;
    the extra position MLP is ported now (held against JAX in
    tests/test_torch_classification.py)."""
    kw = dict(samples_per_batch=256, fourier_position_encoding_kwargs=dict(num_bands=4))
    with pytest.raises(ValueError):
        port_pre.AudioPreprocessor(prep_type="conv", **kw)
    pm = port_pre.AudioPreprocessor(n_extra_pos_mlp=2, **kw)
    assert [name for name, _ in pm._extra_pos_mlps.named_children()] == ["0", "1"]


# ---- postprocessors --------------------------------------------------------


@pytest.mark.parametrize("kind", ["audio", "classification", "classification_raw",
                                  "projection", "identity"])
def test_postprocessors_match_jax(kind):
    jax_cls, port_cls, kw = {
        "audio": (jax_post.AudioPostprocessor, port_post.AudioPostprocessor,
                  dict(in_channels=24, samples_per_patch=16)),
        "classification": (jax_post.ClassificationPostprocessor,
                           port_post.ClassificationPostprocessor,
                           dict(num_input_channels=24, num_classes=11)),
        "classification_raw": (jax_post.ClassificationPostprocessor,
                               port_post.ClassificationPostprocessor,
                               dict(num_input_channels=24, num_classes=11, project=False)),
        "projection": (jax_post.ProjectionPostprocessor, port_post.ProjectionPostprocessor,
                       dict(num_inputs=24, num_outputs=3)),
        "identity": (jax_post.IdentityPostprocessor, port_post.IdentityPostprocessor, {}),
    }[kind]
    x = np.random.default_rng(2).standard_normal((2, 7, 24), dtype=np.float32)
    jm = jax_cls(**kw)
    variables = _perturbed(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)), seed=3)
    want = np.asarray(jm.apply(variables, jnp.asarray(x)))
    got = _port(port_cls(**kw), variables)(torch.from_numpy(x)).detach().numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)


# ---- token masking ---------------------------------------------------------


def test_mask_probs_zero_and_one_match_jax():
    """Probability 1 replaces every token of a modality by its mask token,
    0 leaves it; padding first, then masking, then the sorted concat."""
    channels = {"a": 5, "b": 9, "c": 3}
    probs = {"a": 0.0, "b": 1.0, "c": 1.0}
    rng = np.random.default_rng(4)
    inputs = {m: rng.standard_normal((2, n, c), dtype=np.float32)
              for (m, c), n in zip(channels.items(), (4, 6, 1))}
    jm = jax_perceiver.MultimodalPreprocessor(
        mask_probs=probs, min_padding_size=2, input_channels=channels)
    j_in = {m: jnp.asarray(x) for m, x in inputs.items()}
    variables = jm.init(jax.random.PRNGKey(0), j_in)
    want, want_sizes, _ = jm.apply(variables, j_in)
    pm = _port(port_perceiver.MultimodalPreprocessor(
        mask_probs=probs, min_padding_size=2, input_channels=channels), variables)
    got, sizes, _ = pm({m: torch.from_numpy(x) for m, x in inputs.items()})
    assert sizes == dict(want_sizes)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    token_b = pm.mask_tokens["b"].pos_embs.detach().numpy()[0]
    np.testing.assert_array_equal(got.detach().numpy()[:, 4:10], np.broadcast_to(token_b, (2, 6, 11)))


def test_mask_probs_between_zero_and_one_raise():
    """A probability strictly between 0 and 1 draws a mask per token (see
    tests/test_torch_dropout.py); one outside [0, 1] raises."""
    for bad in (1.5, -0.1):
        with pytest.raises(ValueError, match=r"\[0, 1\]"):
            port_perceiver.MultimodalPreprocessor(
                mask_probs={"a": bad}, input_channels={"a": 4})
    pm = port_perceiver.MultimodalPreprocessor(
        mask_probs={"a": 0.5}, input_channels={"a": 4}, min_padding_size=0)
    out, _, _ = pm({"a": torch.zeros(2, 64, 4)})
    masked = (out != 0).any(-1)
    assert 0 < masked.float().mean() < 1


# ---- the query-pad fold ----------------------------------------------------


def _folded_case(seed):
    """Two modalities' position features (widths 5 and 9, 6 and 3 tokens)
    and raw pad vectors (widths 7 and 3) of a 12-channel query."""
    rng = np.random.default_rng(seed)
    parts = [(rng.standard_normal((2, 6, 5), dtype=np.float32),
              rng.standard_normal(7, dtype=np.float32)),
             (rng.standard_normal((2, 3, 9), dtype=np.float32),
              rng.standard_normal(3, dtype=np.float32))]
    dense = np.concatenate(
        [np.concatenate([x, np.broadcast_to(p, x.shape[:2] + p.shape)], -1) for x, p in parts],
        axis=1)
    return parts, dense


@pytest.mark.parametrize("impl", ["dense", "flash"])
def test_folded_cross_attention_matches_jax(impl):
    """CrossAttention (no query residual) on a FoldedQuery against JAX's on
    the same FoldedQuery and against the port on the materialised concat;
    ``_project_q_folded`` against JAX's."""
    parts, dense = _folded_case(5)
    kv = np.random.default_rng(6).standard_normal((2, 10, 8), dtype=np.float32)
    kw = dict(q_in_channels=12, kv_in_channels=8, num_heads=1, use_query_residual=False)
    jax_pol, port_pol = ((jax_config.PARITY, port_config.PARITY) if impl == "dense"
                         else (_jax_flash_policy(), _port_flash_policy()))
    jm = jax_blocks.CrossAttention(**kw, policy=jax_pol)
    variables = _perturbed(jm.init(jax.random.PRNGKey(0), jnp.asarray(dense), jnp.asarray(kv)),
                           seed=7)
    j_fq = jax_blocks.FoldedQuery(parts=tuple((jnp.asarray(x), jnp.asarray(p))
                                              for x, p in parts))
    want = np.asarray(jm.apply(variables, j_fq, jnp.asarray(kv)))
    want_dense = np.asarray(jm.apply(variables, jnp.asarray(dense), jnp.asarray(kv)))
    np.testing.assert_allclose(want, want_dense, **TOL)
    pm = _port(port_blocks.CrossAttention(**kw, policy=port_pol), variables)
    fq = port_blocks.FoldedQuery(parts=tuple((torch.from_numpy(x), torch.from_numpy(p))
                                             for x, p in parts))
    assert (fq.num_tokens, fq.num_channels) == (9, 12)
    with torch.no_grad():
        got = pm(fq, torch.from_numpy(kv)).numpy()
        got_dense = pm(torch.from_numpy(dense), torch.from_numpy(kv)).numpy()
        ln = pm.layer_norm_q
        q = pm.attention._project_q_folded(fq._replace(ln_scale=ln.weight, ln_bias=ln.bias))
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got_dense, want, **TOL)

    def jax_q(module, fq):
        ln = variables["params"]["layer_norm_q"]
        return module.attention._project_q_folded(
            fq._replace(ln_scale=ln["scale"], ln_bias=ln["bias"]))

    want_q = jm.apply(variables, j_fq, method=jax_q)
    np.testing.assert_allclose(q.numpy(), np.asarray(want_q), **TOL)


def test_folded_query_with_query_residual_raises():
    parts, dense = _folded_case(8)
    pm = port_blocks.CrossAttention(q_in_channels=12, kv_in_channels=8, num_heads=1,
                                    use_query_residual=True)
    fq = port_blocks.FoldedQuery(parts=tuple((torch.from_numpy(x), torch.from_numpy(p))
                                             for x, p in parts))
    with pytest.raises(ValueError, match="use_query_residual"):
        pm(fq, torch.zeros(2, 4, 8))


# ---- queries with chunked subsampling --------------------------------------


@pytest.mark.parametrize("kind,chunk", [("image", 0), ("image", 37), ("audio", None),
                                        ("audio", 0), ("audio", 37), ("label", None),
                                        ("label", 0)])
def test_multimodal_queries_subsample_as_jax(kind, chunk):
    """The published queries, whole or one chunk of 128 as the model
    subsamples them: the image query over index dims (16, 224, 224) (6,272
    points a chunk), the audio query over (1920,) (15 a chunk), the label's
    1,024-channel trainable query (one row; JAX and the port index its
    table with the points as given).  The image query's whole 802,816-point
    table is never built: the model always subsamples it."""
    if kind == "image":
        kw = dict(output_index_dims=(16, 224, 224), num_bands=32,
                  max_resolution=(16, 56, 56), sine_only=False, concat_pos=True)
        jm, pm, size = jax_queries.FourierQuery(**kw), port_queries.FourierQuery(**kw), 6272
    elif kind == "audio":
        kw = dict(output_index_dims=(1920,), num_bands=192, max_resolution=(30720,),
                  sine_only=False, concat_pos=True)
        jm, pm, size = jax_queries.FourierQuery(**kw), port_queries.FourierQuery(**kw), 15
    else:
        kw = dict(output_index_dims=(1,), num_channels=1024, init_scale=0.02)
        jm, pm, size = jax_queries.TrainableQuery(**kw), port_queries.TrainableQuery(**kw), 1
    points = None if chunk is None else chunk * size + np.arange(size)
    x = jnp.zeros((2, 0))
    j_points = None if points is None else jnp.asarray(points)
    variables = jm.init(jax.random.PRNGKey(0), x, subsampled_points=j_points)
    want = np.asarray(jm.apply(variables, x, subsampled_points=j_points))
    if kind == "label":
        pm = _port(pm, variables)
    got = pm(torch.zeros(2, 0),
             subsampled_points=None if points is None else torch.from_numpy(points))
    assert got.shape[-1] == pm.n_query_channels() == jm.n_query_channels()
    # The audio query's 192 bands up to 15,360 take the published audio
    # table's atol (test_audio_preprocessor_matches_jax); its positions agree
    # at TOL.
    atol = 2e-2 if kind == "audio" else TOL["atol"]
    got = got.detach().numpy().reshape(want.shape)
    np.testing.assert_allclose(got[..., :1], want[..., :1], **TOL)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=atol)
    if kind == "image":
        assert pm._position_encoding.fourier_table is None


# ---- the whole model -------------------------------------------------------


@pytest.fixture(scope="module")
def mm_variables():
    """JAX random weights at the golden configuration, every parameter
    moved by seeded noise (LayerNorms and biases off 1 and 0)."""
    jm = jax_mm.MultiModalPerceiver(policy=jax_config.PARITY, **SMALL)
    images, audio = _clip(0)
    variables = jax.jit(lambda k, i, a: jm.init(k, i, a, N_CHUNKS))(
        jax.random.PRNGKey(0), images, audio)
    return _perturbed(jax.tree_util.tree_map(np.asarray, variables), seed=9)


def _policies(case):
    fold = dict(fold_query_pad=True)
    return {
        "dense": (jax_config.PARITY, port_config.PARITY),
        "flash": (_jax_flash_policy(), _port_flash_policy()),
        "fold": (dataclasses.replace(jax_config.PARITY, **fold),
                 dataclasses.replace(port_config.PARITY, **fold)),
        "flash_fold": (_jax_flash_policy(**fold), _port_flash_policy(**fold)),
    }[case]


def _port_model(variables, policy):
    return _port(port_mm.MultiModalPerceiver(**SMALL, policy=policy, device="cpu"), variables)


def _run(model, images, audio):
    with torch.no_grad():
        return model(torch.from_numpy(images), torch.from_numpy(audio), n_chunks=N_CHUNKS)


@pytest.mark.parametrize("case", ["dense", "flash", "fold", "flash_fold"])
def test_multimodal_matches_jax(mm_variables, case):
    """The whole model, encoded once and decoded in 4 chunks, against the
    JAX model on the same weights: the dense path, every site through the
    flash kernel's plain version (Pallas in interpreter mode in JAX), and
    both with the query-pad fold."""
    jax_pol, port_pol = _policies(case)
    jm = jax_mm.MultiModalPerceiver(policy=jax_pol, **SMALL)
    images, audio = _clip(1)
    want = jax.jit(lambda v, i, a: jm.apply(v, i, a, N_CHUNKS))(mm_variables, images, audio)
    got = _run(_port_model(mm_variables, port_pol), images, audio)
    assert set(got) == {"image", "audio", "label"}
    assert got["image"].shape == (1, 2, 3, 16, 16) and got["audio"].shape == (1, 256, 1)
    assert got["label"].shape == (1, 11)
    for key in got:
        want_key = np.asarray(want[key])
        assert np.abs(want_key).max() > 0, key
        np.testing.assert_allclose(got[key].numpy(), want_key, err_msg=key, **TOL)


def test_multimodal_golden_replay():
    """tests/goldens/multimodal.npz: the reference's weights load strictly
    and its outputs replay, on the dense path and through the plain K1."""
    z = np.load(GOLDEN)
    meta = json.loads(bytes(z["meta"]).decode())
    kwargs = {k: tuple(v) if isinstance(v, list) else v for k, v in meta["kwargs"].items()}
    sd = {k[4:]: torch.from_numpy(z[k].astype(np.float32))
          for k in z.files if k.startswith("sd::")}
    before = fa.LAUNCHES
    for policy in (port_config.PARITY, _port_flash_policy()):
        model = port_mm.MultiModalPerceiver(**kwargs, policy=policy, device="cpu")
        model.load_state_dict(sd, strict=True)
        with torch.no_grad():
            out = model(torch.from_numpy(z["in::images"]), torch.from_numpy(z["in::audio"]),
                        n_chunks=4)
        for key in ("image", "audio", "label"):
            np.testing.assert_allclose(out[key].numpy(), z[f"out::{key}"], err_msg=key, **TOL)
    assert fa.LAUNCHES == before  # CPU tensors take the plain K1: no launch


def test_fold_matches_materialised_query(mm_variables):
    """The port's fold against its own materialised concat on the same
    weights, as tests/test_fold_query_pad.py does in JAX; the folded query
    holds each modality's query and raw pad vector in sorted order."""
    images, audio = _clip(2)
    base = _port_model(mm_variables, port_config.PARITY)
    folded = _port_model(mm_variables, dataclasses.replace(port_config.PARITY,
                                                          fold_query_pad=True))
    want, got = _run(base, images, audio), _run(folded, images, audio)
    for key in want:
        np.testing.assert_allclose(got[key].numpy(), want[key].numpy(), err_msg=key, **TOL)
    with torch.no_grad():
        _, state = folded.perceiver.encode({
            "image": torch.from_numpy(images), "audio": torch.from_numpy(audio),
            "label": torch.zeros(1, 11)})
        query, sizes = folded.perceiver.decoder_query(
            *state, subsampled_points={"image": torch.arange(128), "audio": torch.arange(4)})
    assert isinstance(query, port_blocks.FoldedQuery)
    assert sizes == {"audio": 4, "image": 128, "label": 1}
    assert [(pos.shape[1:], pad.shape) for pos, pad in query.parts] == [
        ((4, 385), (641,)), ((128, 195), (831,)), ((1, 1024), (2,))]
    assert (query.num_tokens, query.num_channels) == (133, 1026)


def test_flow_unchanged_under_the_new_performance_policy():
    """PERFORMANCE now sets fold_query_pad; flow's query carries no pad
    channels, so its decoder query and its output are exactly those of the
    old PERFORMANCE."""
    small = dict(img_size=(16, 24), num_latents=8, num_latent_channels=32,
                 num_self_attends_per_block=2)
    assert port_config.PERFORMANCE.fold_query_pad
    old = dataclasses.replace(port_config.PERFORMANCE, fold_query_pad=False)
    gen = torch.Generator().manual_seed(3)
    models = [port_flow.FlowPerceiver(**small, policy=policy, device="cpu",
                                      generator=torch.Generator().manual_seed(5))
              for policy in (port_config.PERFORMANCE, old)]
    weight = torch.randn(models[0].perceiver._decoder.final_layer.weight.shape, generator=gen)
    for model in models:
        with torch.no_grad():
            model.perceiver._decoder.final_layer.weight.copy_(weight)
    rng = np.random.default_rng(6)
    img1, img2 = (torch.from_numpy(rng.uniform(-1, 1, (2, 3, 16, 24)).astype(np.float32))
                  for _ in range(2))
    with torch.no_grad():
        new_out, old_out = (model(img1, img2) for model in models)
        patches = torch.zeros(2, 2, 27, 16, 24)
        _, state = models[0].perceiver.encode(patches)
        query, _ = models[0].perceiver.decoder_query(*state)
    assert isinstance(query, torch.Tensor)
    assert new_out.abs().max() > 0 and torch.equal(new_out, old_out)


def test_multimodal_bf16_matches_jax(mm_variables):
    """The PERFORMANCE policy (bf16 GEMMs, fp32 LayerNorm and softmax, tanh
    GELU, the fold) casts at the same points as JAX's.  Tolerance 5% of each
    output's max |x|, as for flow: each framework sums its bf16 products in
    its own order."""
    jm = jax_mm.MultiModalPerceiver(policy=jax_config.PERFORMANCE, **SMALL)
    images, audio = _clip(4)
    want = jax.jit(lambda v, i, a: jm.apply(v, i, a, N_CHUNKS))(mm_variables, images, audio)
    got = _run(_port_model(mm_variables, port_config.PERFORMANCE), images, audio)
    for key in got:
        want_key = np.asarray(want[key]).astype(np.float32)
        err = np.abs(got[key].float().numpy() - want_key).max()
        assert err <= 0.05 * np.abs(want_key).max(), (key, err)


@pytest.mark.parametrize("site,q_len,kv_len,path",
                         [("encoder", 784, 52097, "flash"), ("self", 784, 784, "dense"),
                          ("decoder", 6288, 784, "dense")])
@pytest.mark.parametrize("on_device", [True, False])
def test_attention_path_at_multimodal_sites(site, q_len, kv_len, path, on_device):
    """The published model's sites under "auto": the encoder's 52,097 keys
    take the flash kernel on the card, the self-attends (784 latents) and
    the decoder chunks (6,288 queries x 784 latents) the dense path, as the
    JAX dispatch decides on a TPU."""
    want = jax_ops.attention_path("auto", q_len=q_len, kv_len=kv_len,
                                  backend="tpu" if on_device else "cpu")
    got = port_ops.attention_path("auto", q_len=q_len, kv_len=kv_len, on_cuda=on_device)
    assert got == {"xla": "dense"}.get(want, want)
    assert got == (path if on_device else "dense")


def test_multimodal_state_dict_from_flax_matches_export_state_dict(mm_variables):
    """The numpy copy of the JAX package's exporter gives its names and
    values, which are exactly the port model's state_dict keys (the
    per-modality padding embeddings and mask tokens, the preprocessors',
    postprocessors' and queries' parameters)."""
    want = export_state_dict(mm_variables)
    got = state_dict_from_flax(mm_variables)
    assert list(got) == list(want)
    for key, value in want.items():
        np.testing.assert_array_equal(got[key].numpy(), value, err_msg=key)
    port = port_mm.MultiModalPerceiver(**SMALL, device="cpu").state_dict()
    assert set(port) == set(got)
    for name in ("perceiver._multi_preprocessor.mask_tokens.label.pos_embs",
                 "perceiver._multi_preprocessor.padding_embeddings.audio.pos_embs",
                 "perceiver.padding_embeddings.image.pos_embs",
                 "perceiver._output_postprocessors.audio.linear.weight",
                 "perceiver._output_queries.label._position_encoding.pos_embs"):
        assert port[name].shape == got[name].shape, name


def test_multimodal_refusals():
    """n_chunks must divide both query counts (JAX's error); a remat policy
    the port does not know and a CUDA device where there is none raise
    (chunk_mesh's refusal of an n_chunks its data axis does not divide is
    held on a gloo group, tests/test_torch_chunk_mesh.py)."""
    model = port_mm.MultiModalPerceiver(**SMALL, device="cpu")
    images, audio = (torch.from_numpy(x) for x in _clip(5))
    with pytest.raises(ValueError, match="must divide both the image query"):
        model(images, audio, n_chunks=3)
    with pytest.raises(ValueError, match="dots_saveable"):
        port_config.Policy(remat_policy="save_and_offload_only_these_names")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            port_mm.MultiModalPerceiver(**SMALL)
