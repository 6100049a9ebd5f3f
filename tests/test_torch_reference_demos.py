"""The port's four reference demos against the JAX package's.

Each case runs the JAX demo (``examples/<name>.py``) and the port's
(``perceiverio_pytorch_tpu_torch/examples/<name>.py``) in one working
directory: ``sample_data/`` holds synthetic media written here (PNG frames,
a PNG image, an MJPG AVI through OpenCV and a stereo int16 WAV through
scipy) and ``pytorch_checkpoints/`` one reference-convention ``.pth``
written by the JAX package from seeded weights, which both demos load from
their default paths.  Every parameter the initialiser leaves at zero is
drawn at random (the flow decoder's projection is zero-initialised, so a
fresh flow model's field is exactly zero and would make the comparison
vacuous).  The models are shrunk on both sides by replacing each demo
module's model constructor; the media sizes, masks, chunk counts and file
formats are the demos' own (the multimodal demo's frame count, image size
and audio rate, and the MLM's sequence length, are module constants, cut
on both sides alike).  fp32 on the CPU.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from perceiverio_pytorch_tpu import models as jax_models
from perceiverio_pytorch_tpu.utils.torch_checkpoint import (
    LANGUAGE_OVERRIDES,
    LANGUAGE_TIED,
    save_torch_checkpoint,
)
from perceiverio_pytorch_tpu_torch import models as port_models
from perceiverio_pytorch_tpu_torch.examples import img_classify, language, multimodal, opt_flow

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=2e-4, atol=2e-5)
MISSING = "Please download the converted checkpoint"

FLOW_SMALL = dict(img_size=(24, 32), num_latents=8, num_latent_channels=32,
                  num_self_attends_per_block=1)
CLS_SMALL = dict(num_self_attends_per_block=1, num_blocks=1, num_latents=8,
                 num_latent_channels=32)
LM_SMALL = dict(max_seq_len=64, embed_dim=16, num_self_attends_per_block=1, num_latents=8,
                num_latent_channels=32)
MM_SMALL = dict(num_self_attends_per_block=1, num_latents=8)
MM_CONSTANTS = dict(NUM_FRAMES=2, IMG_SZ=16, AUDIO_SAMPLES_PER_FRAME=128)


def _jax_demo(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_demo_{name}", os.path.join(ROOT, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _shrink(monkeypatch, module, name, cls, small):
    """Replace ``module.name`` by ``cls`` with ``small`` over the demo's
    own keyword arguments."""
    monkeypatch.setattr(module, name, lambda *a, **kw: cls(*a, **{**kw, **small}))


@pytest.fixture
def demo_dir(tmp_path, monkeypatch):
    (tmp_path / "sample_data").mkdir()
    (tmp_path / "pytorch_checkpoints").mkdir()
    monkeypatch.chdir(tmp_path)
    return tmp_path


def _randomised(variables, seed):
    """The variables with every all-zero parameter drawn from N(0, 0.05^2)."""
    rng = np.random.default_rng(seed)

    def draw(x):
        x = np.asarray(x)
        if x.dtype.kind == "f" and not x.any():
            return jnp.asarray(rng.normal(0.0, 0.05, x.shape).astype(x.dtype))
        return x

    return {**variables, "params": jax.tree.map(draw, variables["params"])}


def _write_png(path, hwc):
    from PIL import Image

    Image.fromarray(hwc).save(path)


def _smooth_image(rng, h, w):
    y, x = np.mgrid[0:h, 0:w] / max(h, w)
    img = np.zeros((h, w, 3))
    for c in range(3):
        fy, fx, ph = rng.uniform(0, 6, 3)
        img[..., c] = np.sin(2 * np.pi * (fy * y + fx * x) + ph)
    return ((img + 1) * 127.5).astype(np.uint8)


def test_flow_demo_matches_jax(demo_dir, monkeypatch):
    rng = np.random.default_rng(0)
    frame = _smooth_image(rng, 40, 56)
    _write_png("sample_data/frame_0016.png", frame)
    _write_png("sample_data/frame_0017.png", np.roll(frame, (1, 2), axis=(0, 1)))
    jax_demo = _jax_demo("opt_flow")
    _shrink(monkeypatch, jax_demo, "FlowPerceiver", jax_models.FlowPerceiver, FLOW_SMALL)
    _shrink(monkeypatch, opt_flow, "FlowPerceiver", port_models.FlowPerceiver, FLOW_SMALL)
    model = jax_models.FlowPerceiver(**FLOW_SMALL)
    zeros = jnp.zeros((1, 3) + FLOW_SMALL["img_size"])
    variables = _randomised(jax.jit(model.init)(jax.random.PRNGKey(3), zeros, zeros), 4)
    save_torch_checkpoint(opt_flow.CKPT_FILE, variables)

    want = np.asarray(jax_demo.flow_example())
    want_png = open("flow_prediction.png", "rb").read()
    got = opt_flow.flow_example(device="cpu")
    assert got.shape == want.shape == (1, 2, 40, 56)
    assert np.abs(want).max() > 1e-3  # not the zero field
    np.testing.assert_allclose(got, want, **TOL)
    from PIL import Image

    got_img = np.asarray(Image.open("flow_prediction.png"), np.int16)
    with open(demo_dir / "jax.png", "wb") as f:
        f.write(want_png)
    want_img = np.asarray(Image.open(demo_dir / "jax.png"), np.int16)
    assert got_img.shape == want_img.shape == (40, 56, 3)
    assert np.abs(got_img - want_img).max() <= 1  # the color wheel's rounding


@pytest.mark.parametrize("prep", ["FOURIER_POS_CONVNET", "LEARNED_POS_1X1CONV",
                                  "FOURIER_POS_PIXEL"])
def test_img_classify_demo_matches_jax(demo_dir, monkeypatch, capsys, prep):
    _write_png("sample_data/dalmation.jpg", _smooth_image(np.random.default_rng(1), 48, 60))
    jax_demo = _jax_demo("img_classify")
    _shrink(monkeypatch, jax_demo, "ClassificationPerceiver",
            jax_models.ClassificationPerceiver, CLS_SMALL)
    _shrink(monkeypatch, img_classify, "ClassificationPerceiver",
            port_models.ClassificationPerceiver, CLS_SMALL)
    jax_prep = jax_models.PrepType[prep]
    model = jax_models.ClassificationPerceiver(num_classes=1000, prep_type=jax_prep,
                                               **CLS_SMALL)
    variables = jax.jit(model.init)(jax.random.PRNGKey(5), jnp.zeros((1, 3, 224, 224)))
    variables = _randomised(variables, 6)
    save_torch_checkpoint(img_classify.CKPT_FILES[port_models.PrepType[prep]], variables)

    want = jax_demo.img_classify_example(prep_type=jax_prep)
    want_out = capsys.readouterr().out
    got = img_classify.img_classify_example(port_models.PrepType[prep], device="cpu")
    got_out = capsys.readouterr().out
    assert got == want and len(got) == 5
    assert got_out == want_out and got_out.startswith("Top 5 labels:\n")


def test_language_demo_matches_jax(demo_dir, monkeypatch, capsys):
    jax_demo = _jax_demo("language")
    for mod in (jax_demo, language):
        monkeypatch.setattr(mod, "MAX_SEQ_LEN", LM_SMALL["max_seq_len"])
    _shrink(monkeypatch, jax_demo, "LanguagePerceiver", jax_models.LanguagePerceiver, LM_SMALL)
    _shrink(monkeypatch, language, "LanguagePerceiver", port_models.LanguagePerceiver,
            LM_SMALL)
    model = jax_models.LanguagePerceiver(**LM_SMALL)
    tokens = jnp.zeros((1, LM_SMALL["max_seq_len"]), jnp.int32)
    variables = jax.jit(model.init)(jax.random.PRNGKey(7), tokens, jnp.ones(tokens.shape, bool))
    variables = _randomised(variables, 8)
    save_torch_checkpoint(language.CKPT_FILE, variables, LANGUAGE_OVERRIDES, LANGUAGE_TIED)

    want = jax_demo.language_example()
    want_out = capsys.readouterr().out
    got = language.language_example(device="cpu")
    got_out = capsys.readouterr().out
    assert got == want and got_out == want_out
    assert "Greedy predictions:" in got_out and len(got_out.splitlines()) == 6


def _write_clip(rng, frames, size, samples):
    import cv2
    import scipy.io.wavfile

    writer = cv2.VideoWriter("sample_data/video.avi", cv2.VideoWriter_fourcc(*"MJPG"), 25,
                             (size + 8, size))
    for i in range(frames):
        writer.write(np.roll(_smooth_image(rng, size, size + 8), i, axis=1))
    writer.release()
    t = np.arange(samples)[:, None] / 48000.0
    audio = 0.5 * np.sin(2 * np.pi * np.array([440.0, 660.0]) * t)
    scipy.io.wavfile.write("sample_data/audio.wav", 48000, (audio * 2**15).astype(np.int16))


def test_multimodal_demo_matches_jax(demo_dir, monkeypatch, capsys):
    import scipy.io.wavfile

    from perceiverio_pytorch_tpu_torch.utils.image import load_video

    jax_demo = _jax_demo("multimodal")
    for mod in (jax_demo, multimodal):
        for name, value in MM_CONSTANTS.items():
            monkeypatch.setattr(mod, name, value)
    _shrink(monkeypatch, jax_demo, "MultiModalPerceiver", jax_models.MultiModalPerceiver,
            MM_SMALL)
    _shrink(monkeypatch, multimodal, "MultiModalPerceiver", port_models.MultiModalPerceiver,
            MM_SMALL)
    frames, size, per_frame = (MM_CONSTANTS[k] for k in MM_CONSTANTS)
    _write_clip(np.random.default_rng(2), frames + 1, size, frames * per_frame + 50)
    model = jax_models.MultiModalPerceiver(
        num_frames=frames, audio_samples_per_frame=per_frame, img_size=(size, size),
        num_classes=700, **MM_SMALL)
    variables = jax.jit(lambda k, i, a: model.init(k, i, a, 16))(
        jax.random.PRNGKey(9), jnp.zeros((1, frames, 3, size, size)),
        jnp.zeros((1, frames * per_frame, 1)))
    save_torch_checkpoint(multimodal.CKPT_FILE, _randomised(variables, 10))

    want = jax_demo.multimodal_example()
    want_out = capsys.readouterr().out
    want_wav = scipy.io.wavfile.read("audio_reconstruction.wav")[1]
    want_avi = load_video("video_reconstruction.avi", resize=(size, size))
    got = multimodal.multimodal_example(device="cpu")
    got_out = capsys.readouterr().out
    assert got_out == want_out and len(got_out.splitlines()) == 5
    assert tuple(got["image"].shape) == (1, frames, 3, size, size)
    for key in ("image", "audio", "label"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), **TOL)
    got_wav = scipy.io.wavfile.read("audio_reconstruction.wav")[1]
    assert got_wav.shape == want_wav.shape == (frames * per_frame,)
    assert np.abs(got_wav.astype(np.int32) - want_wav).max() <= 1
    got_avi = load_video("video_reconstruction.avi", resize=(size, size))
    assert got_avi.shape == want_avi.shape == (frames, size, size, 3)


@pytest.mark.parametrize("name,entry", [
    ("opt_flow", "flow_example"), ("img_classify", "img_classify_example"),
    ("language", "language_example"), ("multimodal", "multimodal_example")])
def test_demo_without_a_checkpoint_raises_as_jax(demo_dir, name, entry):
    """With no .pth and no --random-init each demo refuses with the JAX
    demo's message."""
    port_demo = {"opt_flow": opt_flow, "img_classify": img_classify, "language": language,
                 "multimodal": multimodal}[name]
    with pytest.raises(ValueError, match=MISSING) as want:
        getattr(_jax_demo(name), entry)()
    with pytest.raises(ValueError, match=MISSING) as got:
        getattr(port_demo, entry)(device="cpu")
    assert str(got.value) == str(want.value)


def test_random_init_is_seeded(demo_dir, monkeypatch):
    """--random-init draws the weights from the seed: one seed twice gives
    the same model and answer, another seed other weights (no .pth)."""
    built = []

    def build(*args, **kwargs):
        built.append(port_models.LanguagePerceiver(*args, **{**kwargs, **LM_SMALL}))
        return built[-1]

    monkeypatch.setattr(language, "LanguagePerceiver", build)
    monkeypatch.setattr(language, "MAX_SEQ_LEN", LM_SMALL["max_seq_len"])
    answers = [language.language_example(random_init=True, device="cpu", seed=seed)
               for seed in (4, 4, 5)]
    assert answers[0] == answers[1]
    weights = [m.state_dict() for m in built]
    assert all(torch.equal(weights[0][k], weights[1][k]) for k in weights[0])
    assert not all(torch.equal(weights[0][k], weights[2][k]) for k in weights[0])


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a GPU")


@pytest.mark.parametrize("call", [
    lambda: opt_flow.flow_example(random_init=True),
    lambda: img_classify.img_classify_example(random_init=True),
    lambda: language.language_example(random_init=True),
    lambda: multimodal.multimodal_example(random_init=True),
])
def test_demos_default_to_cuda(demo_dir, no_cuda, call):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        call()
