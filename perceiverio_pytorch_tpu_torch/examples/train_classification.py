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

``--data-dir`` trains on a ``root/<class>/*.png`` tree instead
(``ImageFolderDataset``: as many classes as subdirectories, images decoded
by a thread pool, shipped uint8 and normalised on the device); the last
``2 * batch`` images are held out and scored by ``eval_fn``.
``--checkpoint-dir`` saves the train state every ``steps // 2`` updates and
``--resume`` goes on from the newest save there.

    python -m perceiverio_pytorch_tpu_torch.examples.train_classification --steps 30 \
        [--full-scale] [--data-dir DIR] [--checkpoint-dir DIR [--resume]]

``--quant dynamic|static`` is quantization-aware training: the forward runs
the int8 projections a deployment runs (``Policy.quant``), the backward the
exact products' gradients.  ``static`` calibrates every projection's
``amax`` first (in eval mode) on the first training batch, the batch the
JAX example initialises (and so calibrates) with, and keeps it through
training.

Runs on the GPU unless the caller asks for the CPU (``--device cpu``, or
``main(device="cpu")``).  Not ported: ``--mesh`` and ``--fsdp``.
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from perceiverio_pytorch_tpu_torch.config import DEFAULT, PERFORMANCE
from perceiverio_pytorch_tpu_torch.models.classification import (
    ClassificationPerceiver,
    PrepType,
)
from perceiverio_pytorch_tpu_torch.models.flow import resolve_device
from perceiverio_pytorch_tpu_torch.ops.quant import calibrate
from perceiverio_pytorch_tpu_torch.training import (
    ImageFolderDataset,
    Subset,
    Trainer,
    batch_iterator,
    build_optimizer,
    classification_cross_entropy,
    dataset_iterator,
    epoch_batches,
)
from perceiverio_pytorch_tpu_torch.utils.image import IMAGENET_MEAN_RGB, IMAGENET_STDDEV_RGB

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


def prep_images(img: torch.Tensor) -> torch.Tensor:
    """uint8 images (files) -> ImageNet-normalised floats, on their device;
    float images (the synthetic set) as they are."""
    if img.dtype != torch.uint8:
        return img
    mean = torch.tensor(IMAGENET_MEAN_RGB, device=img.device)[:, None, None]
    std = torch.tensor(IMAGENET_STDDEV_RGB, device=img.device)[:, None, None]
    return (img.float() - mean) / std


def loss_fn(model, img, labels):
    return classification_cross_entropy(model(prep_images(img)), labels)


def eval_fn(model, img, labels):
    """The inference pathway: BatchNorm on its running averages."""
    logits = model(prep_images(img))
    return {"eval_loss": classification_cross_entropy(logits, labels),
            "eval_top1": (logits.argmax(-1) == labels).float().mean()}


def setup(steps=30, batch_size=8, full_scale=False, *, prep_type=PrepType.FOURIER_POS_CONVNET,
          device="cuda", metrics_path="./classification_metrics.jsonl", log_every=10,
          data_dir=None, checkpoint_dir=None, checkpoint_every=None, checkpoint_async=False,
          prefetch=0, seed=0, quant=None):
    """The example's trainer, initial state, batch stream and evaluation
    batches: ``(trainer, state, batches, eval_batches)``.

    ``batches(start_step)`` yields batches on ``device``, or with
    ``prefetch`` > 0 host batches that the Trainer copies there ahead of the
    step.  ``eval_batches`` is a list of batches on ``device`` (the held-out
    images of ``data_dir``), or None for the synthetic set, which holds none
    out.  ``checkpoint_every`` defaults to ``steps // 2`` when
    ``checkpoint_dir`` is given.  Weights are drawn from ``seed``.
    ``quant`` ("dynamic" or "static") trains the int8 model (static:
    calibrated on the first training batch).
    """
    device = resolve_device(device)
    generator = torch.Generator().manual_seed(seed)
    hw = FULL_SCALE_HW if full_scale else TINY["img_size"]

    def on_device(batch):
        return tuple(torch.from_numpy(a).to(device) for a in batch)

    dataset = eval_batches = None
    if data_dir is not None:
        full = ImageFolderDataset(data_dir, image_size=hw)
        num_classes = len(full.class_names)
        n_eval = min(2 * batch_size, max(len(full) - batch_size, 0))
        dataset = Subset(full, range(len(full) - n_eval))
        print(f"{len(full)} images, {num_classes} classes from {data_dir}"
              f" ({len(dataset)} train / {n_eval} eval)")
        if n_eval:
            fields = tuple(np.stack(f) for f in zip(*[full[i] for i in
                                                      range(len(full) - n_eval, len(full))]))
            eval_batches = [on_device(b) for b in epoch_batches(
                fields, batch_size, shuffle=False, drop_remainder=False)]
    else:
        num_classes = FULL_SCALE_CLASSES if full_scale else TINY_CLASSES
        img, labels = synthetic_quadrants(8 * batch_size, hw, num_classes)
    policy = PERFORMANCE if full_scale else DEFAULT
    if quant:
        policy = dataclasses.replace(policy, quant=f"int8_{quant}")
    if full_scale:
        model = ClassificationPerceiver(num_classes=num_classes, prep_type=prep_type,
                                        policy=policy, remat=True, device=device,
                                        generator=generator)
    else:
        model = ClassificationPerceiver(num_classes=num_classes, prep_type=prep_type, **TINY,
                                        policy=policy, device=device, generator=generator)
    if quant == "static":
        first = (next(dataset_iterator(dataset, batch_size, num_workers=0))[0]
                 if dataset is not None else img[:batch_size])
        calibrate(model.eval(), [(prep_images(torch.from_numpy(first).to(device)),)])
        model.train()
    if checkpoint_every is None:
        checkpoint_every = 0 if checkpoint_dir is None else max(steps // 2, 1)
    trainer = Trainer(
        loss_fn,
        build_optimizer(1e-4 if full_scale else 1e-3, schedule="cosine", total_steps=steps,
                        warmup_steps=max(steps // 10, 1), clip_norm=1.0),
        metrics_path=metrics_path,
        log_every=log_every,
        eval_fn=eval_fn,
        eval_every=max(steps // 2, 1),
        checkpoint_dir=checkpoint_dir,
        checkpoint_every=checkpoint_every,
        checkpoint_async=checkpoint_async,
        prefetch=prefetch,
    )

    # epochs=None reshuffles every epoch; start_batch puts a resumed run at
    # the data position of an uninterrupted one
    def batches(start_step=0):
        if dataset is not None:
            source = dataset_iterator(dataset, batch_size, shuffle=True, epochs=None,
                                      start_batch=start_step, num_workers=4)
        else:
            source = batch_iterator((img, labels), batch_size, shuffle=True, epochs=None,
                                    start_batch=start_step)
        for batch in source:
            yield batch if prefetch else on_device(batch)

    return trainer, trainer.init_state(model), batches, eval_batches


def main(steps=30, batch_size=8, full_scale=False, *, prep_type=PrepType.FOURIER_POS_CONVNET,
         device="cuda", metrics_path="./classification_metrics.jsonl", data_dir=None,
         checkpoint_dir=None, resume=False, quant=None):
    trainer, state, batches, eval_batches = setup(
        steps, batch_size, full_scale, prep_type=prep_type, device=device,
        metrics_path=metrics_path, data_dir=data_dir, checkpoint_dir=checkpoint_dir,
        prefetch=2, quant=quant)
    state = trainer.fit(state, batches, num_steps=steps, eval_batches=eval_batches,
                        resume=resume)
    print(f"finished at step {state.step}")
    return state


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", type=int, default=30)
    parser.add_argument("--batch-size", type=int, default=8)
    parser.add_argument("--full-scale", action="store_true",
                        help="published ImageNet conv-prep config, remat + bf16")
    parser.add_argument("--prep-type", default="FOURIER_POS_CONVNET",
                        choices=[p.name for p in PrepType])
    parser.add_argument("--data-dir", default=None,
                        help="root/<class>/*.png image tree; default: synthetic quadrants")
    parser.add_argument("--checkpoint-dir", default=None)
    parser.add_argument("--resume", action="store_true",
                        help="continue from the newest checkpoint in --checkpoint-dir")
    parser.add_argument("--quant", nargs="?", const="dynamic", default=None,
                        choices=["dynamic", "static"],
                        help="quantization-aware training: int8 forward, exact backward")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()
    main(args.steps, args.batch_size, full_scale=args.full_scale,
         prep_type=PrepType[args.prep_type], device=args.device, data_dir=args.data_dir,
         checkpoint_dir=args.checkpoint_dir, resume=args.resume, quant=args.quant)
