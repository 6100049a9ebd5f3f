"""Flow evaluation: endpoint error and accuracies over frame pairs with
``.flo`` ground truth, on one GPU.

Counterpart of the JAX package's ``examples/evaluate_flow.py``.  Sintel-style
layout, any frame size (``FlowInference`` tiles and blends it):

    data_dir/
      frames/  frame_0001.png frame_0002.png ...   (consecutive)
      flow/    frame_0001.flo ...                  (ground truth of pair i, i+1)

    python -m perceiverio_pytorch_tpu_torch.examples.evaluate_flow --data-dir DIR \\
        [--checkpoint CKPT | --torch-checkpoint flow.pth] [--small] [--limit N]

``--checkpoint`` is a weights directory or a Trainer checkpoint,
``--torch-checkpoint`` a reference-convention ``.pth``; with neither the
weights are random (seed 0).  Prints one JSON line: AEPE, the 1/3/5-px
accuracies and Fl outliers over every scored pixel, and pairs/s after the
first pair.  Runs on the GPU unless the caller asks for the CPU
(``--device cpu``, or ``main(..., device="cpu")``).
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import time

import torch

from perceiverio_pytorch_tpu_torch.config import PERFORMANCE
from perceiverio_pytorch_tpu_torch.models.flow import FlowInference, FlowPerceiver
from perceiverio_pytorch_tpu_torch.training.checkpoint import restore_eval_variables
from perceiverio_pytorch_tpu_torch.utils.compilation_cache import (
    add_cache_arg,
    enable_cache_if_requested,
)
from perceiverio_pytorch_tpu_torch.utils.device import resolve_device
from perceiverio_pytorch_tpu_torch.utils.flow_io import flow_error_stats, read_flo
from perceiverio_pytorch_tpu_torch.utils.image import load_image

SMALL = dict(img_size=(64, 96), num_latents=32, num_latent_channels=64,
             num_self_attends_per_block=2)


def frame_pairs(data_dir):
    """(frame 1, frame 2, ground truth or None) of consecutive frames."""
    frames = sorted(glob.glob(os.path.join(data_dir, "frames", "*.png")))
    if len(frames) < 2:
        raise ValueError(f"need >= 2 frames under {data_dir}/frames")
    for a, b in zip(frames, frames[1:]):
        stem = os.path.splitext(os.path.basename(a))[0]
        gt = os.path.join(data_dir, "flow", stem + ".flo")
        yield a, b, (gt if os.path.exists(gt) else None)


def load_frame(path) -> torch.Tensor:
    """A frame file as [1, 3, H, W] float32 in [-1, 1]."""
    return torch.from_numpy(2.0 * (load_image(path) / 255.0) - 1.0)


def build_model(checkpoint=None, torch_checkpoint=None, small=False, *, device="cuda"):
    """The evaluated model: the published configuration in bf16 (the tiny
    one in fp32 with ``small``), weights from seed 0 or restored."""
    device = resolve_device(device)
    generator = torch.Generator().manual_seed(0)
    if small:
        model = FlowPerceiver(**SMALL, device=device, generator=generator)
    else:
        model = FlowPerceiver(policy=PERFORMANCE, device=device, generator=generator)
    return restore_eval_variables(model, checkpoint, torch_checkpoint).eval()


def main(data_dir, checkpoint=None, torch_checkpoint=None, small=False, limit=None,
         min_overlap=20, wave_size=0, *, device="cuda"):
    device = resolve_device(device)
    infer = FlowInference(build_model(checkpoint, torch_checkpoint, small, device=device),
                          min_overlap=min_overlap, wave_size=wave_size, device=device)
    totals, n_pairs, n_px = {}, 0, 0
    t0, timed_pairs = None, 0
    for f1, f2, gt_path in frame_pairs(data_dir):
        flow = infer(load_frame(f1), load_frame(f2))[0].cpu().numpy()  # [2, H, W]
        if t0 is None:
            t0 = time.perf_counter()  # after the first pair: its warm-up is not timed
        else:
            timed_pairs += 1
        if gt_path is not None:
            stats = flow_error_stats(flow, read_flo(gt_path))
            w = stats.pop("pixels")
            n_px += w
            for k, v in stats.items():
                totals[k] = totals.get(k, 0.0) + v * w
        n_pairs += 1
        if limit and n_pairs >= limit:
            break
    elapsed = time.perf_counter() - t0 if t0 else 0.0
    result = {"pairs": n_pairs}
    if n_px:
        result.update({k: round(v / n_px, 4) for k, v in totals.items()})
    else:
        result["note"] = "no .flo ground truth found; timing only"
    if timed_pairs and elapsed > 0:
        result["pairs_per_sec"] = round(timed_pairs / elapsed, 2)
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--data-dir", required=True,
                        help="directory with frames/*.png and flow/*.flo")
    parser.add_argument("--checkpoint", default=None,
                        help="weights directory or Trainer checkpoint")
    parser.add_argument("--torch-checkpoint", default=None,
                        help="reference-convention .pth (sintel.pth)")
    parser.add_argument("--small", action="store_true",
                        help="tiny random-weight config (pipeline demo)")
    parser.add_argument("--limit", type=int, default=None)
    parser.add_argument("--min-overlap", type=int, default=20)
    parser.add_argument("--wave-size", type=int, default=0,
                        help="tiles per forward (0: all of a request's tiles at once)")
    parser.add_argument("--device", default="cuda")
    add_cache_arg(parser)
    args = parser.parse_args()
    enable_cache_if_requested(args)
    main(args.data_dir, checkpoint=args.checkpoint, torch_checkpoint=args.torch_checkpoint,
         small=args.small, limit=args.limit, min_overlap=args.min_overlap,
         wave_size=args.wave_size, device=args.device)
