"""The port's evaluation scripts against the JAX package's.

``examples/evaluate_mlm.py`` (the masked rows alone and the full decode)
and ``examples/evaluate_multimodal.py --small`` run in both packages on the
same weights and the same text or clips; the printed numbers agree.  The
weights are the JAX package's, written by it as a reference ``.pth`` (and
for the JAX MLM script as its own weights directory: its ``.pth`` path
does not place the tied token table).  The JAX scripts round their
numbers (4 decimals, PSNRs 3), so those are compared at the fp32 tolerance
or one unit of the last printed digit, whichever is larger.
"""

import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from perceiverio_pytorch_tpu.models import LanguagePerceiver as JaxLanguage
from perceiverio_pytorch_tpu.models import MultiModalPerceiver as JaxMultiModal
from perceiverio_pytorch_tpu.training.checkpoint import save_variables as jax_save_variables
from perceiverio_pytorch_tpu.utils.torch_checkpoint import (
    LANGUAGE_OVERRIDES,
    LANGUAGE_TIED,
    save_torch_checkpoint,
)
from perceiverio_pytorch_tpu_torch.examples import evaluate_mlm, evaluate_multimodal

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_script(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(ROOT, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def mlm_weights(tmp_path_factory):
    """The JAX script's small MLM, initialised from another seed than the
    script's: a JAX weights directory and the same weights as a reference
    .pth."""
    model = JaxLanguage(**evaluate_mlm.SMALL)
    tokens = jnp.zeros((1, 256), jnp.int32)
    variables = jax.jit(model.init)(jax.random.PRNGKey(7), tokens, jnp.ones((1, 256), bool))
    root = tmp_path_factory.mktemp("mlm")
    jax_save_variables(str(root / "jax"), variables)
    save_torch_checkpoint(str(root / "mlm.pth"), variables, LANGUAGE_OVERRIDES, LANGUAGE_TIED)
    return str(root / "jax"), str(root / "mlm.pth")


@pytest.mark.parametrize("partial_decode", [True, False])
def test_evaluate_mlm_matches_jax(mlm_weights, partial_decode):
    jax_dir, pth = mlm_weights
    want = _jax_script("evaluate_mlm").main(checkpoint=jax_dir, batch_size=4, limit=8,
                                            partial_decode=partial_decode, seed=3)
    got = evaluate_mlm.main(torch_checkpoint=pth, batch_size=4, limit=8,
                            partial_decode=partial_decode, seed=3, device="cpu")
    assert set(got) == set(want)
    assert (got["sequences"], got["masked_tokens"]) == (want["sequences"],
                                                        want["masked_tokens"]) == (8, 304)
    np.testing.assert_allclose(got["masked_accuracy"], want["masked_accuracy"], rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(got["masked_ce"], want["masked_ce"], rtol=2e-4, atol=1e-4)
    assert np.isfinite(got["masked_ce"]) and 0.0 <= got["masked_accuracy"] <= 1.0


def test_evaluate_mlm_decodes_agree_and_refuse_int8(tmp_path):
    """The masked rows alone against the full decode on a text file (the
    JAX test's tolerances); ``--quant`` runs (dynamic, and static calibrated
    on the first batch), both decodes alike."""
    text = tmp_path / "corpus.txt"
    text.write_text("the encoder attends to the byte sequence in parallel. " * 60)
    fast = evaluate_mlm.main(text_file=str(text), batch_size=4, limit=8, device="cpu")
    slow = evaluate_mlm.main(text_file=str(text), batch_size=4, limit=8, device="cpu",
                             partial_decode=False)
    assert fast["sequences"] == slow["sequences"] == 8
    assert fast["masked_tokens"] == slow["masked_tokens"]
    np.testing.assert_allclose(fast["masked_accuracy"], slow["masked_accuracy"], atol=1e-6)
    np.testing.assert_allclose(fast["masked_ce"], slow["masked_ce"], atol=2e-3)
    for mode in ("dynamic", "static"):
        runs = [evaluate_mlm.main(text_file=str(text), batch_size=4, limit=8, device="cpu",
                                  quant=mode, partial_decode=partial)
                for partial in (True, False)]
        assert runs[0]["masked_tokens"] == runs[1]["masked_tokens"] == fast["masked_tokens"]
        assert np.isfinite(runs[0]["masked_ce"])
        np.testing.assert_allclose(runs[0]["masked_ce"], runs[1]["masked_ce"], atol=2e-3)
    with pytest.raises(ValueError, match="too short"):
        evaluate_mlm._chunks("short", 256, evaluate_mlm.BytesTokenizer())


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    """The JAX test's clips (a: video and audio, b: video only) with a
    labels file, plus a labelled directory clip, and the JAX script's small
    model as a reference .pth."""
    pytest.importorskip("cv2")
    import scipy.io.wavfile

    from perceiverio_pytorch_tpu_torch.utils.image import save_video

    root = tmp_path_factory.mktemp("clips")
    rng = np.random.RandomState(0)
    for stem, with_audio in [("a", True), ("b", False), ("7/c", True)]:
        os.makedirs(os.path.dirname(root / f"{stem}.avi"), exist_ok=True)
        save_video(str(root / f"{stem}.avi"), rng.rand(2, 16, 16, 3).astype(np.float32))
        if with_audio:
            wav = (rng.rand(200) * 2 - 1) * 0.5  # short: zero-padded to 256 samples
            scipy.io.wavfile.write(str(root / f"{stem}.wav"), 48000,
                                   (wav * 2**15).astype(np.int16))
    with open(root / "labels.json", "w") as f:
        json.dump({"a": 3, "b": 7}, f)
    model = JaxMultiModal(**evaluate_multimodal.SMALL)
    variables = jax.jit(lambda k, i, a: model.init(k, i, a, 4))(
        jax.random.PRNGKey(0), jnp.zeros((1, 2, 3, 16, 16), jnp.float32),
        jnp.zeros((1, 256, 1), jnp.float32))
    pth = str(root / "mm.pth")
    save_torch_checkpoint(pth, variables)
    return root, pth


def test_evaluate_multimodal_small_matches_jax(clips):
    root, pth = clips
    kw = dict(small=True, labels_file=str(root / "labels.json"), torch_checkpoint=pth)
    want = _jax_script("evaluate_multimodal").main(str(root), **kw)
    got = evaluate_multimodal.main(str(root), device="cpu", **kw)
    assert set(got) == set(want)
    assert (got["clips"], got["labeled_clips"]) == (want["clips"], want["labeled_clips"]) == (3, 3)
    for key in ("video_psnr", "audio_psnr"):
        np.testing.assert_allclose(got[key], want[key], rtol=2e-4, atol=1e-3, err_msg=key)
    assert (got["top1"], got["top5"]) == (want["top1"], want["top5"])
    limited = evaluate_multimodal.main(str(root), device="cpu", limit=1, **kw)
    assert limited["clips"] == 1 and "clips_per_sec" not in limited


def test_resolve_label_cases():
    """Label resolution as in the JAX test: labels-file values (an int, a
    name in any case, with '_' for spaces), parent-directory integers and
    names, and None when nothing resolves; each equal to the JAX script's."""
    jax_resolve = _jax_script("evaluate_multimodal")._resolve_label
    name_to_idx = {"playing piano": 42}
    cases = [(("clip", "x", {"clip": 7}), 7),
             (("clip", "x", {"clip": "Playing Piano"}), 42),
             (("clip", "x", {"clip": "Playing_Piano"}), 42),
             (("clip", "5", None), 5),
             (("clip", "playing_piano", None), 42),
             (("clip", "unknown_class", None), None),
             (("other", "9", {"clip": 1}), 9)]
    for args, want in cases:
        got = evaluate_multimodal._resolve_label(*args, name_to_idx)
        assert got == want == jax_resolve(*args, name_to_idx), args
