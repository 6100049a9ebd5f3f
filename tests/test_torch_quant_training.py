"""Quantization-aware training in the port's examples against the JAX
package's.

Three steps of ``train_mlm --quant dynamic`` and of ``train_classification
--quant dynamic`` at the tiny size: the JAX example's ``main`` from its
PRNGKey(0) init, and the port's ``setup`` with that init's weights loaded,
on the same batches through the same optimizer chain; the losses the two
Trainers log agree.  The static flag calibrates once on the first training
batch, the batch the JAX examples initialise with, and the amax stays put
through training.  Inputs are made with numpy.
"""

import dataclasses
import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from perceiverio_pytorch_tpu import DEFAULT
from perceiverio_pytorch_tpu.models import ClassificationPerceiver as JaxClassification
from perceiverio_pytorch_tpu.models import LanguagePerceiver as JaxLanguage
from perceiverio_pytorch_tpu.models import PrepType as JaxPrepType
from perceiverio_pytorch_tpu_torch.examples import train_classification, train_mlm
from perceiverio_pytorch_tpu_torch.ops import quant
from perceiverio_pytorch_tpu_torch.utils.weights import (
    LANGUAGE_OVERRIDES,
    LANGUAGE_TIED,
    state_dict_from_flax,
)

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The logged losses of the two Trainers, relative: the int8 forwards differ
# by activation codes that flip at rounding ties (tests/test_torch_quant_models.py,
# about 1e-2 of a logit), the updates by AdamW on those gradients.
LOSS_RTOL = 5e-3
# The JAX examples' tiny models under --quant dynamic.
DYNAMIC = dataclasses.replace(DEFAULT, quant="int8_dynamic")


def _jax_example(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(ROOT, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _logged(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def _losses(lines):
    return {(key, x["step"]): x[key] for x in lines for key in ("loss", "eval_loss") if key in x}


def _check_losses(got, want):
    assert set(got) == set(want) and got
    for key, value in want.items():
        assert np.isfinite(got[key])
        np.testing.assert_allclose(got[key], value, rtol=LOSS_RTOL, err_msg=str(key))


def test_train_mlm_quant_dynamic_matches_jax(tmp_path, monkeypatch):
    """The JAX example logs the evaluation loss after each of the 3 steps
    and the training loss at the last; the port's Trainer, from the same
    weights, logs the same numbers."""
    monkeypatch.chdir(tmp_path)
    jax_mod = _jax_example("train_mlm")
    jax_mod.main(steps=3, batch_size=8, quant="dynamic")
    want = _losses(_logged(tmp_path / "mlm_metrics.jsonl"))

    corrupted, _, _ = train_mlm.synthetic_corpus(1024, 256, 262)
    jm = JaxLanguage(max_seq_len=256, **train_mlm.TINY, policy=DYNAMIC)
    variables = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(corrupted[:8]),
                                 jnp.ones((8, 256), bool))
    path = tmp_path / "port.jsonl"
    trainer, state, batches, eval_batches = train_mlm.setup(
        3, device="cpu", metrics_path=str(path), quant="dynamic")
    state.model.load_state_dict(state_dict_from_flax(variables, overrides=LANGUAGE_OVERRIDES,
                                                     tied=LANGUAGE_TIED), strict=True)
    assert sum(getattr(m, "quant", None) == "int8_dynamic" for m in state.model.modules()) == 36
    trainer.fit(state, batches, num_steps=3, eval_batches=eval_batches)
    _check_losses(_losses(_logged(path)), want)


def test_train_classification_quant_dynamic_matches_jax(tmp_path, monkeypatch):
    """The JAX example logs the training loss at its last step; the port's
    Trainer (train-mode BatchNorm, as flax's mutable batch_stats), from the
    same weights and statistics, logs the same loss."""
    monkeypatch.chdir(tmp_path)
    jax_mod = _jax_example("train_classification")
    jax_mod.main(steps=3, batch_size=8, quant="dynamic")
    want = _losses(_logged(tmp_path / "classification_metrics.jsonl"))

    img, _ = train_classification.synthetic_quadrants(64, (32, 32), 4)
    jm = JaxClassification(num_classes=4, **train_classification.TINY, policy=DYNAMIC,
                           prep_type=JaxPrepType.FOURIER_POS_CONVNET)
    variables = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(img[:8]))
    path = tmp_path / "port.jsonl"
    trainer, state, batches, _ = train_classification.setup(
        3, device="cpu", metrics_path=str(path), quant="dynamic")
    state.model.load_state_dict(state_dict_from_flax(variables), strict=True)
    trainer.fit(state, batches, num_steps=3)
    _check_losses(_losses(_logged(path)), want)


@pytest.mark.parametrize("example", ["mlm", "classification"])
def test_static_flag_calibrates_on_the_first_batch(example, tmp_path):
    """--quant static: each projection's amax is the max |x| of its input on
    the first training batch (the JAX example's init batch), taken in eval
    mode; training leaves it where it was and moves the weights."""
    calls = []

    def spy(model, batches, **kwargs):
        batches = list(batches)
        calls.append((model.training, [a.clone() for a in batches[0]]))
        return quant.calibrate(model, batches, **kwargs)

    module = train_mlm if example == "mlm" else train_classification
    monkey = pytest.MonkeyPatch()
    monkey.setattr(module, "calibrate", spy)
    try:
        trainer, state, batches, _ = module.setup(3, device="cpu", quant="static",
                                                  metrics_path=str(tmp_path / "m.jsonl"))
    finally:
        monkey.undo()
    (training, first), = calls
    assert training is False and state.model.training is True
    if example == "mlm":
        corrupted, _, _ = train_mlm.synthetic_corpus(1024, 256, 262)
        np.testing.assert_array_equal(first[0].numpy(), corrupted[:8])
        assert first[1].all()
    else:
        img, _ = train_classification.synthetic_quadrants(64, (32, 32), 4)
        np.testing.assert_array_equal(first[0].numpy(), img[:8])
    amax = {n: b.clone() for n, b in state.model.named_buffers() if n.endswith(".amax")}
    assert amax and all(b.item() > 0 for b in amax.values())
    weights = {n: p.detach().clone() for n, p in state.model.named_parameters()}
    state = trainer.fit(state, batches, num_steps=3)
    for name, value in amax.items():
        assert torch.equal(state.model.get_buffer(name), value)
    assert any(not torch.equal(p, weights[n]) for n, p in state.model.named_parameters())
