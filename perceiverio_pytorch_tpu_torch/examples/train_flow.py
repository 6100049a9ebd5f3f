"""Training demo: optical flow, on one GPU, from synthetic pairs or files.

Counterpart of the JAX package's ``examples/train_flow.py``.  By default
frame 2 is frame 1 rolled by a per-sample integer shift, so the ground truth
is a constant flow field that the endpoint-error loss can drive to zero;
the frames, the shifts and the batch order come from the same numpy recipe
and seeds as the JAX example's.  ``--data-dir`` trains on a Sintel-style
tree instead (``frames/*.png`` and ``flow/*.flo`` per scene, as the port's
``tools/make_synthetic_data.py`` writes one): random crops of the model's
frame size (centre crops with ``--no-augment``) decoded by a thread pool,
shipped uint8 and normalised on the device; the last ``2 * batch`` pairs,
centre-cropped, are held out and scored as ``eval_epe``.

The default configuration is tiny (seconds on a CPU).  ``--full-scale``
trains the published 368x496 configuration (2048 x 512 latents, 24
self-attends of 16 heads) at batch 1 with the self-attend stack
rematerialised and the bf16 ``PERFORMANCE`` policy: every attention site
then runs the hand-written flash kernels forward and backward.
``--checkpoint-dir`` saves the train state every ``steps // 2`` updates and
``--resume`` goes on from the newest save there.

    python -m perceiverio_pytorch_tpu_torch.examples.train_flow --steps 30 [--full-scale] \\
        [--data-dir DIR [--no-augment]] [--checkpoint-dir DIR [--resume]] \\
        [--mesh DATA MODEL [--fsdp]]

``--mesh D M`` trains on a (data, model) mesh of D x M processes, one per
device (``Trainer(mesh=...)``; ``python -m torch.distributed.run
--nproc-per-node N -m ...``, or a plain ``python`` call with ``--mesh 1 1``):
rank r drives ``cuda:<LOCAL_RANK>`` unless ``--device cpu``; every rank
makes the same global batches and trains on its rows.  ``--fsdp`` also
shards the weights and their optimizer moments over the data axis.

Runs on the GPU unless the caller asks for the CPU (``--device cpu``, or
``main(device="cpu")``).  Not ported: the pipeline flags.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from perceiverio_pytorch_tpu_torch.config import PERFORMANCE
from perceiverio_pytorch_tpu_torch.models.flow import FlowPerceiver, resolve_device
from perceiverio_pytorch_tpu_torch.parallel import make_mesh, mesh_device
from perceiverio_pytorch_tpu_torch.training import (
    FlowPairDataset,
    Subset,
    Trainer,
    batch_iterator,
    build_optimizer,
    dataset_iterator,
    epoch_batches,
    flow_endpoint_error,
)

TINY = dict(img_size=(32, 48), num_latents=64, num_latent_channels=128,
            num_self_attends_per_block=2)
FULL_SCALE_HW = (368, 496)


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


def prep_frames(img: torch.Tensor) -> torch.Tensor:
    """uint8 frames -> [-1, 1] floats (on their device); float frames as they are."""
    if img.dtype == torch.uint8:
        return 2.0 * (img.float() / 255.0) - 1.0
    return img


def loss_fn(model, img1, img2, gt_flow):
    return flow_endpoint_error(model(prep_frames(img1), prep_frames(img2)), gt_flow)


def eval_fn(model, img1, img2, gt_flow):
    return {"eval_epe": loss_fn(model, img1, img2, gt_flow)}


def flow_datasets(data_dir, hw, batch_size, augment=True):
    """The training subset of a Sintel-style tree and its held-out items:
    the last ``2 * batch_size`` pairs (fewer when the tree is small),
    centre-cropped."""
    full = FlowPairDataset(data_dir, crop_size=hw, augment=augment)
    n_eval = min(2 * batch_size, max(len(full) - batch_size, 0))
    train = Subset(full, range(len(full) - n_eval))
    center = FlowPairDataset(data_dir, crop_size=hw, augment=False)
    held_out = [center[i] for i in range(len(center) - n_eval, len(center))]
    return train, held_out


def setup(steps=30, batch_size=None, full_scale=False, *, device="cuda",
          metrics_path="./flow_metrics.jsonl", log_every=10, data_dir=None, augment=True,
          checkpoint_dir=None, checkpoint_every=None, checkpoint_async=False, prefetch=0, seed=0,
          mesh_shape=None, fsdp=False):
    """The example's trainer, initial state, batch stream and evaluation
    batches: ``(trainer, state, batches, eval_batches)``.

    ``batches(start_step)`` yields batches on ``device``, or with
    ``prefetch`` > 0 host batches that the Trainer copies there ahead of the
    step.  ``eval_batches`` is a list of batches on ``device`` (the held-out
    pairs of ``data_dir``), or None for the synthetic pairs, which hold none
    out.  ``checkpoint_every`` defaults to ``steps // 2`` when
    ``checkpoint_dir`` is given.  Weights are drawn from ``seed``.
    ``mesh_shape`` (data, model) trains on a mesh (``device`` becomes this
    rank's), ``fsdp`` with FSDP.
    """
    device = resolve_device(device)
    mesh = None
    if mesh_shape is not None:  # this rank's device of a (data, model) mesh
        mesh = make_mesh(tuple(mesh_shape), device=device)
        device = mesh_device(mesh)
    generator = torch.Generator().manual_seed(seed)
    if full_scale:
        model = FlowPerceiver(policy=PERFORMANCE, remat=True, device=device,
                              generator=generator)
        if batch_size not in (None, 1):
            print(f"--full-scale forces batch_size=1 (requested {batch_size})")
        hw, batch_size = FULL_SCALE_HW, 1
    else:
        batch_size = 2 if batch_size is None else batch_size
        model = FlowPerceiver(**TINY, device=device, generator=generator)
        hw = TINY["img_size"]

    def on_device(batch):
        return tuple(torch.from_numpy(a).to(device) for a in batch)

    dataset = eval_batches = None
    if data_dir is not None:
        dataset, held_out = flow_datasets(data_dir, hw, batch_size, augment)
        print(f"{len(dataset) + len(held_out)} frame pairs from {data_dir}"
              f" ({len(dataset)} train / {len(held_out)} eval)")
        if held_out:
            fields = tuple(np.stack(f) for f in zip(*held_out))
            eval_batches = [on_device(b) for b in epoch_batches(
                fields, batch_size, shuffle=False, drop_remainder=False)]
    else:
        img1, img2, flow = synthetic_flow_pairs(8 * batch_size, hw)

    if checkpoint_every is None:
        checkpoint_every = 0 if checkpoint_dir is None else max(steps // 2, 1)
    trainer = Trainer(
        loss_fn,
        build_optimizer(
            1e-4 if full_scale else 1e-3, schedule="cosine",
            total_steps=steps, warmup_steps=max(steps // 10, 1), clip_norm=1.0,
        ),
        metrics_path=metrics_path,
        log_every=log_every,
        eval_fn=None if eval_batches is None else eval_fn,
        eval_every=max(steps // 2, 1),
        checkpoint_dir=checkpoint_dir,
        checkpoint_every=checkpoint_every,
        checkpoint_async=checkpoint_async,
        prefetch=prefetch,
        mesh=mesh,
        fsdp=fsdp,
    )

    # epochs=None reshuffles every epoch; start_batch puts a resumed run at
    # the data position of an uninterrupted one
    def batches(start_step=0):
        if dataset is not None:
            source = dataset_iterator(dataset, batch_size, shuffle=True, epochs=None,
                                      start_batch=start_step, num_workers=4)
        else:
            source = batch_iterator((img1, img2, flow), batch_size, shuffle=True,
                                    epochs=None, start_batch=start_step)
        for batch in source:
            yield batch if prefetch else on_device(batch)

    return trainer, trainer.init_state(model), batches, eval_batches


def main(steps=30, batch_size=None, full_scale=False, *, device="cuda",
         metrics_path="./flow_metrics.jsonl", data_dir=None, augment=True,
         checkpoint_dir=None, resume=False, mesh_shape=None, fsdp=False):
    trainer, state, batches, eval_batches = setup(
        steps, batch_size, full_scale, device=device, metrics_path=metrics_path,
        data_dir=data_dir, augment=augment, checkpoint_dir=checkpoint_dir, prefetch=2,
        mesh_shape=mesh_shape, fsdp=fsdp)
    state = trainer.fit(state, batches, num_steps=steps, eval_batches=eval_batches,
                        resume=resume)
    print(f"finished at step {state.step}")
    return state


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", type=int, default=30)
    parser.add_argument("--batch-size", type=int, default=None,
                        help="default 2 (tiny); --full-scale forces 1")
    parser.add_argument("--full-scale", action="store_true",
                        help="published 368x496 config, remat + bf16")
    parser.add_argument("--data-dir", default=None,
                        help="Sintel-style scene tree (frames/ + flow/); default: synthetic"
                             " roll pairs")
    parser.add_argument("--no-augment", action="store_true",
                        help="centre-crop instead of random-crop --data-dir frames")
    parser.add_argument("--checkpoint-dir", default=None)
    parser.add_argument("--resume", action="store_true",
                        help="continue from the newest checkpoint in --checkpoint-dir")
    parser.add_argument("--mesh", type=int, nargs=2, default=None, metavar=("DATA", "MODEL"),
                        help="(data, model) mesh shape: one process per device")
    parser.add_argument("--fsdp", action="store_true",
                        help="shard the weights and optimizer moments over the data axis")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()
    main(args.steps, args.batch_size, full_scale=args.full_scale, device=args.device,
         data_dir=args.data_dir, augment=not args.no_augment,
         checkpoint_dir=args.checkpoint_dir, resume=args.resume, mesh_shape=args.mesh,
         fsdp=args.fsdp)
