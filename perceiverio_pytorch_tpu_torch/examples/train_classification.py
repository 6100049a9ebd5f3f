"""Training demo: image classification, on one GPU.

Counterpart of the JAX package's ``examples/train_classification.py``: a
synthetic task with a known answer, the class being the quadrant that holds
a bright patch, under the softmax cross-entropy.  The images, the labels
and the batch order come from the same numpy recipe and seeds as the JAX
example's.  The convnet's BatchNorm trains in train mode (batch statistics,
running averages updated as flax updates them) and evaluates in eval mode
(the running averages): ``Trainer.evaluate`` with the example's ``eval_fn``
(``eval_loss`` and ``eval_top1``).  As in the JAX example, the synthetic
set has no held-out split: ``setup`` returns ``eval_batches=None``.

The default configuration is tiny (32x32 images, the convnet, 32 latents x
128, one block of 2 self-attends, 4 classes; seconds on a CPU).
``--full-scale`` trains the published ImageNet model (224x224, 512 latents
x 1024, 8 blocks of 6 self-attends, 1,000 classes) with remat of the
self-attend stack under the bf16 ``PERFORMANCE`` policy at batch 8, lr 1e-4.
``setup(prep_type=...)`` picks the model's preprocessing (the convnet by
default, as in the JAX example, which has no such flag); at full scale the
pixel (``FOURIER_POS_PIXEL``) and 1x1-conv (``LEARNED_POS_1X1CONV``)
variants run the encoder's cross-attend through the flash kernels, forward
(K1) and backward (K2, K3), at head widths 261 and 512 over 50,176 tokens.

    python -m perceiverio_pytorch_tpu_torch.examples.train_classification --steps 30 [--full-scale]

Runs on the GPU unless the caller asks for the CPU (``--device cpu``, or
``main(device="cpu")``).  Not ported: ``--mesh``, ``--fsdp``,
``--checkpoint-dir``, ``--resume``, ``--quant`` and ``--data-dir``.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from perceiverio_pytorch_tpu_torch.config import DEFAULT, PERFORMANCE
from perceiverio_pytorch_tpu_torch.models.classification import (
    ClassificationPerceiver,
    PrepType,
)
from perceiverio_pytorch_tpu_torch.models.flow import resolve_device
from perceiverio_pytorch_tpu_torch.training import (
    Trainer,
    batch_iterator,
    build_optimizer,
    classification_cross_entropy,
)

TINY = dict(img_size=(32, 32), num_latents=32, num_latent_channels=128,
            num_self_attends_per_block=2, num_blocks=1)
TINY_CLASSES = 4
FULL_SCALE_HW = (224, 224)
FULL_SCALE_CLASSES = 1000


def synthetic_quadrants(n: int, hw, num_classes: int, seed: int = 0):
    """Images whose label is the quadrant containing a bright patch."""
    h, w = hw
    rng = np.random.RandomState(seed)
    img = rng.uniform(-1, 0, (n, 3, h, w)).astype(np.float32)
    labels = rng.randint(0, min(num_classes, 4), n)
    for i, lab in enumerate(labels):
        y0 = (lab // 2) * (h // 2)
        x0 = (lab % 2) * (w // 2)
        img[i, :, y0 : y0 + h // 4, x0 : x0 + w // 4] = 1.0
    return img, labels.astype(np.int32)


def loss_fn(model, img, labels):
    return classification_cross_entropy(model(img), labels)


def eval_fn(model, img, labels):
    """The inference pathway: BatchNorm on its running averages."""
    logits = model(img)
    return {"eval_loss": classification_cross_entropy(logits, labels),
            "eval_top1": (logits.argmax(-1) == labels).float().mean()}


def setup(steps=30, batch_size=8, full_scale=False, *, prep_type=PrepType.FOURIER_POS_CONVNET,
          device="cuda", metrics_path="./classification_metrics.jsonl", log_every=10):
    """The example's trainer, initial state, batch stream and evaluation
    batches: ``(trainer, state, batches, eval_batches)``, where
    ``batches(start_step)`` yields batches on ``device`` and
    ``eval_batches`` is None (the synthetic set holds none out).  Weights
    are drawn from seed 0."""
    device = resolve_device(device)
    generator = torch.Generator().manual_seed(0)
    if full_scale:
        hw, num_classes = FULL_SCALE_HW, FULL_SCALE_CLASSES
        model = ClassificationPerceiver(num_classes=num_classes, prep_type=prep_type,
                                        policy=PERFORMANCE, remat=True, device=device,
                                        generator=generator)
    else:
        hw, num_classes = TINY["img_size"], TINY_CLASSES
        model = ClassificationPerceiver(num_classes=num_classes, prep_type=prep_type, **TINY,
                                        policy=DEFAULT, device=device, generator=generator)
    img, labels = synthetic_quadrants(8 * batch_size, hw, num_classes)
    trainer = Trainer(
        loss_fn,
        build_optimizer(1e-4 if full_scale else 1e-3, schedule="cosine", total_steps=steps,
                        warmup_steps=max(steps // 10, 1), clip_norm=1.0),
        metrics_path=metrics_path,
        log_every=log_every,
        eval_fn=eval_fn,
        eval_every=max(steps // 2, 1),
    )

    def batches(start_step=0):
        for batch in batch_iterator((img, labels), batch_size, shuffle=True, epochs=None,
                                    start_batch=start_step):
            yield tuple(torch.from_numpy(a).to(device) for a in batch)

    return trainer, trainer.init_state(model), batches, None


def main(steps=30, batch_size=8, full_scale=False, *, prep_type=PrepType.FOURIER_POS_CONVNET,
         device="cuda", metrics_path="./classification_metrics.jsonl"):
    trainer, state, batches, eval_batches = setup(
        steps, batch_size, full_scale, prep_type=prep_type, device=device,
        metrics_path=metrics_path)
    state = trainer.fit(state, batches, num_steps=steps, eval_batches=eval_batches)
    print(f"finished at step {state.step}")
    return state


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", type=int, default=30)
    parser.add_argument("--batch-size", type=int, default=8)
    parser.add_argument("--full-scale", action="store_true",
                        help="published ImageNet conv-prep config, remat + bf16")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()
    main(args.steps, args.batch_size, full_scale=args.full_scale, device=args.device)
