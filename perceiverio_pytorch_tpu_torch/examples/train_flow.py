"""Training demo: optical flow on synthetic frame pairs, on one GPU.

Counterpart of the JAX package's ``examples/train_flow.py``: frame 2 is
frame 1 rolled by a per-sample integer shift, so the ground truth is a
constant flow field that the endpoint-error loss can drive to zero.  The
frames, the shifts and the batch order come from the same numpy recipe and
seeds as the JAX example's.

The default configuration is tiny (seconds on a CPU).  ``--full-scale``
trains the published 368x496 configuration (2048 x 512 latents, 24
self-attends of 16 heads) at batch 1 with the self-attend stack
rematerialised and the bf16 ``PERFORMANCE`` policy: every attention site
then runs the hand-written flash kernels forward and backward.

    python -m perceiverio_pytorch_tpu_torch.examples.train_flow --steps 30 [--full-scale]

Runs on the GPU unless the caller asks for the CPU (``--device cpu``, or
``main(device="cpu")``).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from perceiverio_pytorch_tpu_torch.config import PERFORMANCE
from perceiverio_pytorch_tpu_torch.models.flow import FlowPerceiver, resolve_device
from perceiverio_pytorch_tpu_torch.training import (
    Trainer,
    batch_iterator,
    build_optimizer,
    flow_endpoint_error,
)

TINY = dict(img_size=(32, 48), num_latents=64, num_latent_channels=128,
            num_self_attends_per_block=2)


def synthetic_flow_pairs(n: int, hw, max_shift: int = 3, seed: int = 0):
    """Frame pairs related by a per-sample integer roll, and the exact flow."""
    h, w = hw
    rng = np.random.RandomState(seed)
    # smooth-ish frames: low-res noise upsampled, so the 3x3 patch context
    # around each pixel identifies the shift
    base = rng.uniform(-1, 1, (n, 3, max(h // 4, 1), max(w // 4, 1)))
    img1 = np.stack(
        [np.kron(b, np.ones((4, 4)))[:, :h, :w] for b in base]
    ).astype(np.float32)
    shifts = rng.randint(-max_shift, max_shift + 1, (n, 2))
    img2 = np.stack(
        [np.roll(im, (dy, dx), axis=(1, 2)) for im, (dy, dx) in zip(img1, shifts)]
    )
    # channel 0 = horizontal (x), channel 1 = vertical (y) displacement from
    # frame 1 to frame 2, as FlowPostprocessor emits it
    flow = np.zeros((n, 2, h, w), np.float32)
    flow[:, 0] = shifts[:, 1][:, None, None]
    flow[:, 1] = shifts[:, 0][:, None, None]
    return img1, img2, flow


def loss_fn(model, img1, img2, gt_flow):
    return flow_endpoint_error(model(img1, img2), gt_flow)


def setup(steps=30, batch_size=None, full_scale=False, *, device="cuda",
          metrics_path="./flow_metrics.jsonl", log_every=10):
    """The example's trainer, initial state and batch stream:
    ``(trainer, state, batches)``, where ``batches(start_step)`` yields
    batches on ``device``.  Weights are drawn from seed 0."""
    device = resolve_device(device)
    generator = torch.Generator().manual_seed(0)
    if full_scale:
        model = FlowPerceiver(policy=PERFORMANCE, remat=True, device=device,
                              generator=generator)
        if batch_size not in (None, 1):
            print(f"--full-scale forces batch_size=1 (requested {batch_size})")
        hw, batch_size = (368, 496), 1
    else:
        batch_size = 2 if batch_size is None else batch_size
        model = FlowPerceiver(**TINY, device=device, generator=generator)
        hw = TINY["img_size"]
    img1, img2, flow = synthetic_flow_pairs(8 * batch_size, hw)

    trainer = Trainer(
        loss_fn,
        build_optimizer(
            1e-4 if full_scale else 1e-3, schedule="cosine",
            total_steps=steps, warmup_steps=max(steps // 10, 1), clip_norm=1.0,
        ),
        metrics_path=metrics_path,
        log_every=log_every,
    )

    def batches(start_step=0):
        for batch in batch_iterator((img1, img2, flow), batch_size, shuffle=True,
                                    epochs=None, start_batch=start_step):
            yield tuple(torch.from_numpy(a).to(device) for a in batch)

    return trainer, trainer.init_state(model), batches


def main(steps=30, batch_size=None, full_scale=False, *, device="cuda",
         metrics_path="./flow_metrics.jsonl"):
    trainer, state, batches = setup(steps, batch_size, full_scale, device=device,
                                    metrics_path=metrics_path)
    state = trainer.fit(state, batches, num_steps=steps)
    print(f"finished at step {state.step}")
    return state


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", type=int, default=30)
    parser.add_argument("--batch-size", type=int, default=None,
                        help="default 2 (tiny); --full-scale forces 1")
    parser.add_argument("--full-scale", action="store_true",
                        help="published 368x496 config, remat + bf16")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()
    main(args.steps, args.batch_size, full_scale=args.full_scale, device=args.device)
