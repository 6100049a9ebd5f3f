"""Offline evaluation: top-1 and top-5 accuracy over an image folder, on one GPU.

Counterpart of the JAX package's ``examples/evaluate_classification.py``:
point it at a ``root/<class>/*.png`` tree and a checkpoint, get accuracy
and throughput as one JSON line.  Images ship uint8 and are normalised on
the device; a thread pool decodes them (``dataset_iterator``).

    python -m perceiverio_pytorch_tpu_torch.examples.evaluate_classification \\
        --data-dir DIR [--checkpoint CKPT | --torch-checkpoint model.pth] \\
        [--full-scale] [--prep-type LEARNED_POS_1X1CONV]

Without ``--data-dir`` it scores a synthetic 3-class set (class = brightest
channel).  At ``--full-scale`` the published ImageNet model runs in bf16
with its weights cast to bf16 (``cast_variables_for_inference``), as in the
JAX script; ``--prep-type`` picks the preprocessing the checkpoint was
trained with (the JAX script always builds the convnet).  ``--quant
dynamic|static`` evaluates under int8 projections (``Policy.quant``); the
weights then stay fp32, as in the JAX script, and ``static`` calibrates
each projection on the first two batches first (``ops.quant.calibrate``).
Runs on the GPU unless the caller asks for the CPU (``--device cpu``).  Not
ported: ``--mesh`` (raises).
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import time

import numpy as np
import torch

from perceiverio_pytorch_tpu_torch.config import DEFAULT, PERFORMANCE
from perceiverio_pytorch_tpu_torch.examples.train_classification import TINY, prep_images
from perceiverio_pytorch_tpu_torch.models.classification import (
    ClassificationPerceiver,
    PrepType,
)
from perceiverio_pytorch_tpu_torch.training import ImageFolderDataset, dataset_iterator
from perceiverio_pytorch_tpu_torch.ops.quant import calibrate
from perceiverio_pytorch_tpu_torch.training.checkpoint import restore_eval_variables
from perceiverio_pytorch_tpu_torch.utils.compilation_cache import (
    add_cache_arg,
    enable_cache_if_requested,
)
from perceiverio_pytorch_tpu_torch.utils.device import resolve_device
from perceiverio_pytorch_tpu_torch.utils.params import cast_variables_for_inference


class _SyntheticSet:
    """The JAX script's demo set: class = the brightest RGB channel."""

    class_names = ["r", "g", "b"]

    def __init__(self, n, hw):
        rng = np.random.RandomState(0)
        self.imgs = (rng.rand(n, 3, *hw) * 60).astype(np.uint8)
        self.labels = rng.randint(0, 3, n)
        for i, label in enumerate(self.labels):
            self.imgs[i, label] = np.clip(self.imgs[i, label].astype(np.int32) + 160, 0, 255)

    def __len__(self):
        return len(self.imgs)

    def __getitem__(self, i):
        return self.imgs[i], np.asarray(self.labels[i], np.int32)


def main(data_dir=None, checkpoint=None, torch_checkpoint=None, batch_size=16,
         full_scale=False, mesh_devices=None, quant=None, limit=None, *,
         prep_type=PrepType.FOURIER_POS_CONVNET, device="cuda"):
    if mesh_devices:
        raise NotImplementedError("--mesh is not ported to PyTorch yet (see ROADMAP.md)")
    device = resolve_device(device)
    hw = (224, 224) if full_scale else TINY["img_size"]
    if data_dir is not None:
        dataset = ImageFolderDataset(data_dir, image_size=hw)
    else:
        dataset = _SyntheticSet(8 * batch_size, hw)
    num_classes = len(dataset.class_names)
    generator = torch.Generator().manual_seed(0)
    policy = PERFORMANCE if full_scale else DEFAULT
    if quant:
        policy = dataclasses.replace(policy, quant=f"int8_{quant}")
    if full_scale:
        model = ClassificationPerceiver(num_classes=num_classes, prep_type=prep_type,
                                        policy=policy, device=device, generator=generator)
    else:
        model = ClassificationPerceiver(num_classes=num_classes, prep_type=prep_type, **TINY,
                                        policy=policy, device=device, generator=generator)
    restore_eval_variables(model, checkpoint, torch_checkpoint).eval()
    if full_scale and not quant:
        model.load_state_dict(cast_variables_for_inference(model))  # bf16-rounded weights
    if quant == "static":
        # Restored weights carry no useful amax: calibrate on the first two
        # batches, as the JAX script does.
        batches = itertools.islice(dataset_iterator(dataset, batch_size, num_workers=4), 2)
        calibrate(model, [(prep_images(torch.from_numpy(img).to(device)),)
                          for img, _ in batches])
    k = min(5, num_classes)

    top1 = top5 = seen = 0
    t0, t0_seen = None, 0
    with torch.inference_mode():
        for img, label in dataset_iterator(dataset, batch_size, num_workers=4):
            logits = model(prep_images(torch.from_numpy(img).to(device)))
            pred5 = logits.topk(k, dim=-1).indices.cpu().numpy()  # [B, k] class indices
            if t0 is None:  # the first batch's warm-up is not timed
                t0, t0_seen = time.perf_counter(), len(label)
            top1 += int((pred5[:, 0] == label).sum())
            top5 += int((pred5 == label[:, None]).any(axis=1).sum())
            seen += len(label)
            if limit and seen >= limit:
                break
    elapsed = time.perf_counter() - t0 if t0 else 0.0
    result = {
        "images": seen,
        "top1": round(top1 / max(seen, 1), 4),
        "top5": round(top5 / max(seen, 1), 4),
        "images_per_sec": (round((seen - t0_seen) / elapsed, 1)
                           if elapsed > 0 and seen > t0_seen else None),
    }
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--data-dir", default=None,
                        help="root/<class>/*.png image tree (default: a synthetic 3-class"
                             " demo set)")
    parser.add_argument("--checkpoint", default=None,
                        help="weights directory or Trainer checkpoint")
    parser.add_argument("--torch-checkpoint", default=None,
                        help="reference-convention .pth state dict")
    parser.add_argument("--batch-size", type=int, default=16)
    parser.add_argument("--full-scale", action="store_true",
                        help="published ImageNet config, bf16")
    parser.add_argument("--prep-type", default="FOURIER_POS_CONVNET",
                        choices=[p.name for p in PrepType])
    parser.add_argument("--mesh", type=int, default=None, metavar="N",
                        help="not ported (raises)")
    parser.add_argument("--quant", nargs="?", const="dynamic", default=None,
                        choices=["dynamic", "static"],
                        help="int8 projections (static: calibrated on the first two batches)")
    parser.add_argument("--limit", type=int, default=None,
                        help="stop after this many images")
    parser.add_argument("--device", default="cuda")
    add_cache_arg(parser)
    args = parser.parse_args()
    enable_cache_if_requested(args)
    main(data_dir=args.data_dir, checkpoint=args.checkpoint,
         torch_checkpoint=args.torch_checkpoint, batch_size=args.batch_size,
         full_scale=args.full_scale, mesh_devices=args.mesh, quant=args.quant,
         limit=args.limit, prep_type=PrepType[args.prep_type], device=args.device)
