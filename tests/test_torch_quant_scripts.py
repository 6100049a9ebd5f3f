"""The int8 flags of the port's serving and evaluation scripts, on the CPU.

``examples/serve.py build(quant="static")`` at the tiny size: calibrated on
the JAX script's two seeded uniform batches, its weights directory carries
every ``amax`` in fp32 beside bf16 weights, and the one batch-polymorphic
artifact equals the eager int8 model at buckets 1 and 4, bit for bit, also
with the product on the operands zero-padded as the card's
``torch._int_mm`` takes them.  ``evaluate_classification --quant``: dynamic
and static, the latter calibrated on the first two batches with the fp32
weights kept.  Inputs are made with numpy.
"""

import os
from unittest import mock

import numpy as np
import pytest
import torch

from perceiverio_pytorch_tpu_torch import PERFORMANCE_INT8_STATIC, ClassificationPerceiver
from perceiverio_pytorch_tpu_torch.examples import evaluate_classification, serve
from perceiverio_pytorch_tpu_torch.ops import quant
from perceiverio_pytorch_tpu_torch.serving import export_apply, load_exported
from perceiverio_pytorch_tpu_torch.training.checkpoint import restore_variables

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def static_export(tmp_path_factory):
    out = tmp_path_factory.mktemp("serve")
    rec = serve.build(str(out), device="cpu", quant="static")
    return str(out), rec


def test_serve_build_static_calibrates_and_keeps_amax_fp32(static_export):
    """The weights directory: bf16 weights, every projection's amax in fp32,
    equal to a fresh model calibrated on the JAX script's two batches."""
    out, rec = static_export
    assert rec["quant"] == "static"
    weights = restore_variables(os.path.join(out, serve.WEIGHTS), device="cpu")
    amax = {n: t for n, t in weights.items() if n.endswith(".amax")}
    assert len(amax) == 24 and all(t.dtype == torch.float32 and t.item() > 0
                                   for t in amax.values())
    assert weights["perceiver._decoder.final_layer.weight"].dtype == torch.bfloat16
    model = ClassificationPerceiver(prep_type=serve.PrepType.FOURIER_POS_PIXEL, **serve.TINY,
                                    policy=PERFORMANCE_INT8_STATIC, device="cpu",
                                    generator=torch.Generator().manual_seed(0)).eval()
    rng = np.random.RandomState(0)
    quant.calibrate(model, [(torch.from_numpy(rng.uniform(-1, 1, (1, 3, 32, 32))).float(),)
                            for _ in range(2)])
    for name, t in amax.items():
        assert torch.equal(t, model.get_buffer(name))


def _eager_and_artifact(out):
    weights = restore_variables(os.path.join(out, serve.WEIGHTS), device="cpu")
    model = ClassificationPerceiver(prep_type=serve.PrepType.FOURIER_POS_PIXEL, **serve.TINY,
                                    policy=PERFORMANCE_INT8_STATIC, device="cpu").eval()
    return weights, model


@pytest.mark.parametrize("batch", [1, 4])
def test_static_artifact_equals_eager_int8(static_export, batch):
    """One artifact (exported at a batch of 2) answers buckets 1 and 4 with
    the eager int8 model's logits on the same weights, bit for bit."""
    out, _ = static_export
    weights, model = _eager_and_artifact(out)
    call = serve.load(out, device="cpu")
    img = torch.from_numpy(np.random.RandomState(batch).uniform(-1, 1, (batch, 3, 32, 32))
                           .astype(np.float32))
    with torch.no_grad():
        got = call(img)
        want = torch.func.functional_call(model, weights, (img,))
    assert got.shape == (batch, 10) and torch.equal(got, want)
    with torch.no_grad():
        with quant.quant_pass(model, "exact"):
            exact = torch.func.functional_call(model, weights, (img,))
    assert not torch.equal(got, exact)


def test_padded_product_exports_batch_polymorphic(static_export):
    """With the product on zero-padded operands (the card's rule: more than
    16 rows, K and N multiples of 8) the export keeps the batch symbolic:
    one artifact, buckets 1, 4 and 17, each bit for bit the unpadded eager
    model."""
    out, _ = static_export
    weights, model = _eager_and_artifact(out)

    def padded(xq, wq):
        return quant.int8_gemm_padded(xq, wq, quant.int8_gemm_reference)

    with mock.patch.object(quant, "int8_gemm", padded):
        fn = load_exported(export_apply(model, weights, torch.zeros(2, 3, 32, 32),
                                        batch_polymorphic=True))
        rng = np.random.RandomState(7)
        for batch in (1, 4, 17):
            img = torch.from_numpy(rng.uniform(-1, 1, (batch, 3, 32, 32)).astype(np.float32))
            with torch.no_grad():
                got = fn(weights, img)
                with mock.patch.object(quant, "int8_gemm", quant.int8_gemm_reference):
                    want = torch.func.functional_call(model, weights, (img,))
            assert torch.equal(got, want)


@pytest.mark.parametrize("mode", ["dynamic", "static"])
def test_evaluate_classification_quant(mode):
    """--quant runs the int8 model with fp32 weights (no bf16 cast, as in the
    JAX script); static calibrates once, on the first two batches' images,
    normalised as the scored ones are."""
    calls = []

    def spy(model, batches, **kwargs):
        batches = list(batches)
        calls.append((model, batches))
        return quant.calibrate(model, batches, **kwargs)

    with mock.patch.object(evaluate_classification, "calibrate", spy):
        result = evaluate_classification.main(quant=mode, device="cpu", limit=32,
                                              batch_size=8)
    assert result["images"] == 32 and 0.0 <= result["top1"] <= result["top5"] <= 1.0
    assert len(calls) == (mode == "static")
    if mode == "static":
        model, batches = calls[0]
        assert len(batches) == 2 and batches[0][0].shape == (8, 3, 32, 32)
        assert batches[0][0].dtype == torch.float32 and batches[0][0].min() < 0
        assert all(p.dtype == torch.float32 for p in model.parameters())
        assert all(b.item() > 0 for n, b in model.named_buffers() if n.endswith("amax"))
