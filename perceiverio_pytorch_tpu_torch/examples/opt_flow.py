"""Optical flow demo: the published flow model over a frame pair, tiled.

Counterpart of the JAX package's ``examples/opt_flow.py`` (the reference's
``example_opt_flow.py``): ``FlowPerceiver(img_size=(368, 496))`` at full
width, test-mode ``FlowInference`` over the pair (tiles of 368x496 blended),
the flow rendered with the Middlebury color wheel into a PNG.

    python -m perceiverio_pytorch_tpu_torch.examples.opt_flow \\
        [--frame1 F1.png --frame2 F2.png] [--checkpoint flow.pth | --random-init]

``--checkpoint`` is a reference-convention ``.pth``, loaded strictly
(default: the JAX demo's path); ``--random-init`` draws seeded weights
instead.  Runs on the GPU unless asked for the CPU (``--device cpu``).
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from perceiverio_pytorch_tpu_torch.models.flow import FlowInference, FlowPerceiver
from perceiverio_pytorch_tpu_torch.training.checkpoint import restore_eval_variables
from perceiverio_pytorch_tpu_torch.utils.device import resolve_device
from perceiverio_pytorch_tpu_torch.utils.flow_viz import flow_to_image
from perceiverio_pytorch_tpu_torch.utils.image import load_image, write_png

CKPT_FILE = "./pytorch_checkpoints/optical_flow_checkpoint.pth"


def flow_example(
    frame1_path: str = "./sample_data/frame_0016.png",
    frame2_path: str = "./sample_data/frame_0017.png",
    output_path: str = "./flow_prediction.png",
    random_init: bool = False,
    checkpoint: str = CKPT_FILE,
    *,
    device="cuda",
    seed: int = 0,
) -> np.ndarray:
    """The flow of the pair, [1, 2, H, W] float32; writes its PNG."""
    device = resolve_device(device)
    if not random_init and not os.path.isfile(checkpoint):
        raise ValueError(
            "Please download the converted checkpoint and place it in"
            " ./pytorch_checkpoints (see README), or pass --random-init for"
            " an untrained demo run."
        )
    model = FlowPerceiver(img_size=(368, 496), device=device,
                          generator=torch.Generator().manual_seed(seed))
    if not random_init:
        restore_eval_variables(model, torch_checkpoint=checkpoint)

    # Normalise to [-1, 1].
    img1 = 2 * (load_image(frame1_path) / 255.0) - 1.0
    img2 = 2 * (load_image(frame2_path) / 255.0) - 1.0
    infer = FlowInference(model, device=device)
    flow = infer(torch.from_numpy(img1), torch.from_numpy(img2), test_mode=True)
    flow = flow.cpu().numpy()

    write_png(output_path, flow_to_image(np.transpose(flow[0], (1, 2, 0))))
    print(f"Flow visualisation written to {output_path}")
    return flow


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--frame1", default="./sample_data/frame_0016.png")
    parser.add_argument("--frame2", default="./sample_data/frame_0017.png")
    parser.add_argument("--output", default="./flow_prediction.png")
    parser.add_argument("--random-init", action="store_true",
                        help="run with seeded untrained weights")
    parser.add_argument("--checkpoint", default=CKPT_FILE, help="reference-convention .pth")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()
    flow_example(args.frame1, args.frame2, args.output, random_init=args.random_init,
                 checkpoint=args.checkpoint, device=args.device, seed=args.seed)
