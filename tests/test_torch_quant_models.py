"""The port's int8 models against the JAX package's.

A tiny pixel classifier (two blocks of two self-attends) with JAX's weights
(``state_dict_from_flax``), int8_dynamic and static: every one of its 36
projections, fed the input JAX's projection got, gives JAX's output; the
logits agree with JAX's within the int8 error itself (an activation code
that flips at a rounding tie upstream moves everything after it by a
quantization step, and 86 of the first cross-attend's 133,632 codes do: the
exact paths' fp32 results differ in their last bits); ``calibrate``'s
``amax`` per projection, max-folded over the two blocks, against JAX's
calibrated ``quant_stats``; the calibration pass's output equal to the
exact model's; ``quant_error_report`` against JAX's.  The weights'
utilities: ``amax``
kept fp32 by ``cast_variables_for_inference``, carried by
``state_dict_from_flax``, filled with 0 by ``restore_eval_variables`` where
a source lacks it.  Inputs are made with numpy.
"""

import dataclasses

import flax.linen as flax_nn
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from perceiverio_pytorch_tpu import config as jax_config
from perceiverio_pytorch_tpu.core.attention import _QuantDense
from perceiverio_pytorch_tpu.models import classification as jax_cls
from perceiverio_pytorch_tpu.ops import quant as jax_quant
from perceiverio_pytorch_tpu_torch import config as port_config
from perceiverio_pytorch_tpu_torch.models import classification as port_cls
from perceiverio_pytorch_tpu_torch.ops import quant
from perceiverio_pytorch_tpu_torch.training.checkpoint import (
    restore_eval_variables,
    save_variables,
)
from perceiverio_pytorch_tpu_torch.utils.params import cast_variables_for_inference
from perceiverio_pytorch_tpu_torch.utils.weights import state_dict_from_flax

torch.set_num_threads(1)
TOL = dict(rtol=2e-4, atol=2e-5)
# Logits of the two int8 models, relative to max |logit|: the JAX test's
# bound for int8 against exact (tests/test_quant.py), since the two differ
# by upstream codes that flip at rounding ties (measured: 1.6e-2 dynamic,
# 9.8e-3 static, against an int8 error of 2.2e-2 and 2.0e-2).
INT8_REL = 0.05
# amax is a max over the exact path's fp32 activations, which agree with
# JAX's to the last bits, more of them through each block (the exact models
# agree at TOL; measured here: 4.8e-6 at the deepest site).
AMAX_RTOL = 2e-5
CLS = dict(num_classes=7, img_size=(16, 16), num_self_attends_per_block=2, num_blocks=2,
           num_latents=8, num_latent_channels=32)


def _policies(mode):
    return (dataclasses.replace(jax_config.PARITY, quant=mode),
            dataclasses.replace(port_config.PARITY, quant=mode))


def _images(seed, batch=2):
    return (np.random.RandomState(seed).randn(batch, 3, 16, 16) * 0.5).astype(np.float32)


def _zero_stats(variables):
    return {**variables, "quant_stats": jax.tree_util.tree_map(
        jnp.zeros_like, variables["quant_stats"])}


@pytest.fixture(scope="module")
def cls_static():
    """The JAX static classifier, its variables with zeroed quant_stats,
    and JAX's calibration on two batches."""
    jax_pol, _ = _policies("int8_static")
    jm = jax_cls.ClassificationPerceiver(policy=jax_pol, prep_type=jax_cls.PrepType
                                         .FOURIER_POS_PIXEL, **CLS)
    variables = _zero_stats(jax.jit(jm.init)(jax.random.PRNGKey(0), _images(0)))
    batches = [(jnp.asarray(_images(1)),), (jnp.asarray(_images(2)),)]
    return jm, variables, jax_quant.calibrate(jm, variables, batches)


def _port_cls(mode, variables):
    _, port_pol = _policies(mode)
    model = port_cls.ClassificationPerceiver(
        prep_type=port_cls.PrepType.FOURIER_POS_PIXEL, policy=port_pol, device="cpu", **CLS)
    model.load_state_dict(state_dict_from_flax(variables), strict=True)
    return model.eval()


def _jax_site_io(jm, variables, *args):
    """JAX's output and, in call order, each int8 projection's input and
    output (through the block scans: ordered debug callbacks)."""
    seen = []

    def record(x, y):
        seen.append((np.array(x), np.array(y)))

    def interceptor(fn, call_args, kwargs, context):
        y = fn(*call_args, **kwargs)
        if (isinstance(context.module, _QuantDense) and context.method_name == "__call__"
                and context.module.quant):
            jax.debug.callback(record, call_args[0], y, ordered=True)
        return y

    # Eagerly: under jit XLA fuses the quantize chain, and a few codes come
    # out one step apart from the unfused arithmetic of the port and of
    # JAX's op-by-op run.
    with flax_nn.intercept_methods(interceptor):
        out = jm.apply(variables, *args)
    return np.asarray(out), seen


def _port_site_outputs(model, seen, *args):
    """Each int8 projection of the port's model fed JAX's input at that
    call: its output beside JAX's, in call order."""
    feed, pairs = iter(seen), []

    def pre(module, inputs):
        x, y = next(feed)
        pairs.append([y])
        return (torch.from_numpy(x),)

    def post(module, inputs, out):
        pairs[-1].append(out.numpy())

    hooks = []
    for module in model.modules():
        if getattr(module, "quant", None):
            hooks += [module.register_forward_pre_hook(pre), module.register_forward_hook(post)]
    try:
        with torch.no_grad():
            model(*args)
    finally:
        for hook in hooks:
            hook.remove()
    return pairs


def _check_int8_model(jm, variables, model, img):
    """The 36 projections fed JAX's inputs give JAX's outputs; the logits
    agree within INT8_REL; the int8 path engaged."""
    want, seen = _jax_site_io(jm, variables, img)
    pairs = _port_site_outputs(model, seen, torch.from_numpy(img))
    assert len(pairs) == len(seen) == 36
    for want_y, got_y in pairs:
        np.testing.assert_allclose(got_y, want_y, **TOL)
    with torch.no_grad():
        got = model(torch.from_numpy(img)).numpy()
    assert np.abs(got - want).max() <= INT8_REL * np.abs(want).max()
    plain = {k: v for k, v in variables.items() if k != "quant_stats"}
    exact = np.asarray(jax.jit(jm.clone(policy=jax_config.PARITY).apply)(plain, img))
    assert np.abs(got - exact).max() > 0


def test_dynamic_classifier_matches_jax(cls_static):
    jm_static, variables, _ = cls_static
    jax_pol, _ = _policies("int8_dynamic")
    plain = {k: v for k, v in variables.items() if k != "quant_stats"}
    _check_int8_model(jm_static.clone(policy=jax_pol), plain,
                      _port_cls("int8_dynamic", plain), _images(3))


def test_calibrated_amax_and_static_logits_match_jax(cls_static):
    """The port starts uncalibrated (amax 0, JAX's zeroed stats), calibrates
    on the same two batches, and then holds each projection's amax (folded
    over both blocks: 24 sites) at JAX's; the static logits agree, and the
    calibration pass itself runs the exact model."""
    jm, variables, calibrated = cls_static
    model = _port_cls("int8_static", variables)
    assert all(b.item() == 0.0 for n, b in model.named_buffers() if n.endswith("amax"))
    batches = [(torch.from_numpy(_images(1)),), (torch.from_numpy(_images(2)),)]
    assert quant.calibrate(model, batches) is model
    want = state_dict_from_flax({"quant_stats": calibrated["quant_stats"]})
    got = {n: b for n, b in model.named_buffers() if n.endswith("amax")}
    assert set(got) == set(want) and len(got) == 24
    for name in want:
        assert got[name].dtype == torch.float32 and got[name].item() > 0
        np.testing.assert_allclose(got[name].item(), want[name].item(), rtol=AMAX_RTOL)
    img = _images(4)
    # The static model on JAX's amax, projection by projection and whole.
    static = _port_cls("int8_static", calibrated)
    _check_int8_model(jm, calibrated, static, img)
    with torch.no_grad():
        with quant.quant_pass(model, "calibrate"):
            calib_out = model(torch.from_numpy(img))
        with quant.quant_pass(model, "exact"):
            exact_out = model(torch.from_numpy(img))
    assert torch.equal(calib_out, exact_out)
    exact = jm.clone(policy=jax_config.PARITY)
    plain = {k: v for k, v in calibrated.items() if k != "quant_stats"}
    np.testing.assert_allclose(exact_out.numpy(), np.asarray(jax.jit(exact.apply)(plain, img)),
                               **TOL)
    assert model.training is False and all(m.quant_pass is None for m in model.modules()
                                           if getattr(m, "quant", None))


def test_quant_error_report_matches_jax(cls_static):
    """The same keys as JAX's ("output" for a bare array), statistics
    computed from the model and its exact pass, and values of JAX's size:
    both measure the int8 error on the same batches, but upstream codes
    flip at rounding ties between the two (see INT8_REL), so they agree
    within half their size."""
    jm, _, calibrated = cls_static
    model = _port_cls("int8_static", calibrated)
    batches = [_images(5), _images(6)]
    want = jax_quant.quant_error_report(jm, calibrated, [(jnp.asarray(b),) for b in batches])
    got = quant.quant_error_report(model, [(torch.from_numpy(b),) for b in batches])
    assert set(got) == set(want) == {"output"}
    stats = got["output"]
    assert set(stats) == set(want["output"]) == {"max_rel", "max_abs", "mean_abs"}
    errs, peaks = [], []
    with torch.no_grad():
        for b in batches:
            q = model(torch.from_numpy(b))
            with quant.quant_pass(model, "exact"):
                e = model(torch.from_numpy(b))
            errs.append((q - e).abs())
            peaks.append(e.abs().max())
    assert stats["max_rel"] == max(float(x.max()) / float(p) for x, p in zip(errs, peaks))
    assert stats["max_abs"] == max(float(x.max()) for x in errs)
    np.testing.assert_allclose(stats["mean_abs"], float(torch.cat(errs).double().mean()),
                               rtol=1e-6)
    for stat, value in want["output"].items():
        np.testing.assert_allclose(stats[stat], value, rtol=0.5)
    assert 0 < stats["max_rel"] < INT8_REL


def test_cast_for_inference_keeps_amax_fp32(cls_static):
    """The module branch and the state_dict branch alike: the weights in
    bf16, amax (and nothing else of the model's buffers) in fp32."""
    _, _, calibrated = cls_static
    model = _port_cls("int8_static", calibrated)
    for cast in (cast_variables_for_inference(model),
                 cast_variables_for_inference(model.state_dict())):
        amax = {n: t for n, t in cast.items() if n.endswith(".amax")}
        assert len(amax) == 24 and all(t.dtype == torch.float32 for t in amax.values())
        for name, t in amax.items():
            assert torch.equal(t, model.get_buffer(name))
        assert cast["perceiver._decoder.final_layer.weight"].dtype == torch.bfloat16


def test_restore_eval_variables_fills_only_amax(cls_static, tmp_path):
    """A reference .pth or a weights directory of the unquantized model
    loads into the static model with amax 0 (uncalibrated); any other
    missing or unexpected entry still fails."""
    _, variables, _ = cls_static
    plain = {k: v for k, v in variables.items() if k != "quant_stats"}
    sd = state_dict_from_flax(plain)
    pth = tmp_path / "model.pth"
    torch.save({"model_state_dict": sd}, pth)
    save_variables(str(tmp_path / "weights"), sd)
    for source in (dict(torch_checkpoint=str(pth)), dict(checkpoint=str(tmp_path / "weights"))):
        model = _port_cls("int8_static", variables)
        for name, b in model.named_buffers():
            if name.endswith("amax"):
                b.fill_(3.0)
        restore_eval_variables(model, **source)
        amax = [b for n, b in model.named_buffers() if n.endswith("amax")]
        assert len(amax) == 24 and all(b.item() == 0.0 for b in amax)
        assert torch.equal(model.state_dict()["perceiver._decoder.final_layer.weight"],
                           sd["perceiver._decoder.final_layer.weight"])
    broken = dict(sd)
    broken.pop("perceiver._decoder.final_layer.bias")
    torch.save(broken, tmp_path / "broken.pth")
    with pytest.raises(RuntimeError, match="final_layer.bias"):
        restore_eval_variables(_port_cls("int8_static", variables),
                               torch_checkpoint=str(tmp_path / "broken.pth"))
    torch.save({**sd, "perceiver.extra.amax": torch.tensor(1.0)}, tmp_path / "extra.pth")
    with pytest.raises(RuntimeError, match="extra.amax"):
        restore_eval_variables(_port_cls("int8_static", variables),
                               torch_checkpoint=str(tmp_path / "extra.pth"))
