"""ImageNet classification demo: the published classifier on one image.

Counterpart of the JAX package's ``examples/img_classify.py`` (the
reference's ``example_img_classify.py``): ``ClassificationPerceiver`` at
full width (224x224, 1000 classes) for the ``PrepType`` given by ``--prep``,
in eval mode, on a centre-cropped, resized and ImageNet-normalised image;
prints the top 5 labels.

    python -m perceiverio_pytorch_tpu_torch.examples.img_classify \\
        [--prep FOURIER_POS_PIXEL] [--image IMG] [--checkpoint X.pth | --random-init]

``--checkpoint`` is a reference-convention ``.pth``, loaded strictly
(default: the JAX demo's path for the ``PrepType``); ``--random-init`` draws
seeded weights instead.  Runs on the GPU unless asked for the CPU
(``--device cpu``).
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional

import numpy as np
import torch

from perceiverio_pytorch_tpu_torch.models.classification import (
    ClassificationPerceiver,
    PrepType,
)
from perceiverio_pytorch_tpu_torch.training.checkpoint import restore_eval_variables
from perceiverio_pytorch_tpu_torch.utils.device import resolve_device
from perceiverio_pytorch_tpu_torch.utils.image import (
    center_crop_resize,
    load_image,
    normalize_imagenet,
)
from perceiverio_pytorch_tpu_torch.utils.labels import imagenet_labels

CKPT_FILES = {
    PrepType.FOURIER_POS_CONVNET: "./pytorch_checkpoints/imagenet_conv_preprocessing.pth",
    PrepType.LEARNED_POS_1X1CONV: "./pytorch_checkpoints/imagenet_learned_position_encoding.pth",
    PrepType.FOURIER_POS_PIXEL: "./pytorch_checkpoints/imagenet_fourier_position_encoding.pth",
}


def img_classify_example(
    prep_type: PrepType = PrepType.FOURIER_POS_CONVNET,
    image_path: str = "./sample_data/dalmation.jpg",
    random_init: bool = False,
    checkpoint: Optional[str] = None,
    *,
    device="cuda",
    seed: int = 0,
) -> List[str]:
    """The top 5 labels, best first; prints them with their probabilities."""
    device = resolve_device(device)
    checkpoint = checkpoint or CKPT_FILES[prep_type]
    if not random_init and not os.path.isfile(checkpoint):
        raise ValueError(
            "Please download the converted checkpoint and place it in"
            " ./pytorch_checkpoints (see README), or pass --random-init for"
            " an untrained demo run."
        )
    img_size = (224, 224)
    model = ClassificationPerceiver(num_classes=1000, img_size=img_size, prep_type=prep_type,
                                    device=device, generator=torch.Generator().manual_seed(seed))
    if not random_init:
        restore_eval_variables(model, torch_checkpoint=checkpoint)
    model.eval()

    img_norm = normalize_imagenet(center_crop_resize(load_image(image_path), img_size))
    with torch.inference_mode():
        logits = model(torch.from_numpy(img_norm).to(device))
    probs = torch.softmax(logits.float(), dim=-1).cpu().numpy()
    logits = logits.float().cpu().numpy()
    top5 = np.argsort(-logits[0])[:5]

    labels = imagenet_labels()
    print("Top 5 labels:")
    for idx in top5:
        print(f"{labels[idx]}: {float(probs[0, idx]) * 100:.1f}%")
    return [labels[i] for i in top5]


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--prep", default="FOURIER_POS_CONVNET",
                        choices=[p.name for p in PrepType])
    parser.add_argument("--image", default="./sample_data/dalmation.jpg")
    parser.add_argument("--random-init", action="store_true",
                        help="run with seeded untrained weights")
    parser.add_argument("--checkpoint", default=None,
                        help="reference-convention .pth (default: the PrepType's path)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()
    img_classify_example(PrepType[args.prep], args.image, random_init=args.random_init,
                         checkpoint=args.checkpoint, device=args.device, seed=args.seed)
