"""Training demo: multimodal (video + audio + label) autoencoding, on one GPU.

Counterpart of the JAX package's ``examples/train_multimodal.py``: the
model reconstructs smooth synthetic video and sine audio and classifies a
planted label (the dominant colour), under the weighted autoencode loss
(image 1, audio 1, label 0.01).  The clips, the labels and the batch order
come from the same numpy recipe and seeds as the JAX example's.

The default configuration is tiny (seconds on a CPU).  ``--full-scale``
trains the published Kinetics configuration (16 frames of 224x224, 30,720
audio samples, 700 classes, 784 x 512 latents, 8 self-attends of 8 heads)
with remat (the encoder's self-attend stack and each of the 16 chunks'
decode rematerialised in the backward) under ``remat_policy=
"dots_saveable"``, as the JAX example sets it (the matrix products' outputs
kept, the rest recomputed), and the bf16 ``PERFORMANCE`` policy: the
encoder's cross-attend then runs the hand-written flash kernels forward
(K1) and backward (K2, K3) at head width 704.  ``--remat-policy`` takes
another ``jax.checkpoint_policies`` name the port knows
(``config.REMAT_POLICIES``; "nothing_saveable" is full remat); the tiny
configuration rematerialises in full unless given one.

``--data-dir`` trains on real clips instead (``VideoClipDataset``:
``.avi``/``.mp4`` with ``.wav`` sidecars, labels from the directory names or
``--labels-file``, -1 where neither resolves; video shipped uint8 and
scaled on the device).  ``--checkpoint-dir`` saves the train state every
``--checkpoint-every`` updates (``steps // 2`` by default) and ``--resume``
goes on from the newest save there.

    python -m perceiverio_pytorch_tpu_torch.examples.train_multimodal --steps 20 \
        [--full-scale] [--remat-policy NAME] [--data-dir DIR [--labels-file F]] \
        [--checkpoint-dir DIR [--resume]]

Runs on the GPU unless the caller asks for the CPU (``--device cpu``, or
``main(device="cpu")``).
"""

from __future__ import annotations

import argparse
import dataclasses
import functools

import numpy as np
import torch

from perceiverio_pytorch_tpu_torch.config import DEFAULT, PERFORMANCE
from perceiverio_pytorch_tpu_torch.models.flow import resolve_device
from perceiverio_pytorch_tpu_torch.models.multimodal import MultiModalPerceiver
from perceiverio_pytorch_tpu_torch.training import (
    Trainer,
    VideoClipDataset,
    batch_iterator,
    build_optimizer,
    dataset_iterator,
    multimodal_autoencode_loss,
)
from perceiverio_pytorch_tpu_torch.utils.labels import kinetics700_labels

TINY = dict(img_size=(16, 16), num_frames=2, num_classes=11, audio_samples_per_frame=128,
            audio_samples_per_patch=16, num_self_attends_per_block=1, num_blocks=1,
            num_latents=8, num_latent_channels=512)
WEIGHTS = {"image": 1.0, "audio": 1.0, "label": 0.01}
FULL_SCALE_CHUNKS = 16
FULL_SCALE_REMAT_POLICY = "dots_saveable"  # the JAX example's


def synthetic_clips(n: int, num_frames, hw, n_audio, num_classes, seed=0):
    """Smooth video + sine audio, label = dominant hue bucket."""
    h, w = hw
    rng = np.random.RandomState(seed)
    base = rng.rand(n, num_frames, 3, max(h // 4, 1), max(w // 4, 1))
    video = np.stack(
        [np.kron(clip, np.ones((1, 1, 4, 4)))[:, :, :h, :w] for clip in base]
    ).astype(np.float32)
    t = np.arange(n_audio) / n_audio
    freqs = rng.randint(2, 10, n)
    audio = np.sin(2 * np.pi * freqs[:, None] * t)[..., None].astype(np.float32)
    labels = (video.mean(axis=(1, 3, 4)).argmax(axis=1) * num_classes // 3).astype(np.int32)
    return video, audio, labels


def loss_fn(model, video, audio, labels, n_chunks: int = 4):
    """The weighted autoencode loss of one batch of clips, decoded in
    ``n_chunks`` chunks; uint8 video (files) is scaled to [0, 1] first."""
    if video.dtype == torch.uint8:
        video = video.float() / 255.0
    out = model(video, audio, n_chunks)
    return multimodal_autoencode_loss(
        out, {"image": video, "audio": audio, "label": labels}, weights=WEIGHTS)


def setup(steps=20, batch_size=1, n_chunks=None, full_scale=False, *, device="cuda",
          metrics_path="./multimodal_metrics.jsonl", log_every=5, lr=None, data_dir=None,
          labels_file=None, checkpoint_dir=None, checkpoint_every=None, prefetch=0, seed=0,
          remat_policy=None):
    """The example's trainer, initial state and batch stream:
    ``(trainer, state, batches)``, where ``batches(start_step)`` yields
    batches on ``device`` (with ``prefetch`` > 0, host batches that the
    Trainer copies there ahead of the step).  ``checkpoint_every`` defaults
    to ``steps // 2`` when ``checkpoint_dir`` is given.  Weights are drawn
    from ``seed``.  ``remat_policy`` defaults to "dots_saveable" at full
    scale and to full remat in the tiny configuration."""
    device = resolve_device(device)
    generator = torch.Generator().manual_seed(seed)
    if remat_policy is None and full_scale:
        remat_policy = FULL_SCALE_REMAT_POLICY
    if full_scale:
        policy = dataclasses.replace(PERFORMANCE, remat_policy=remat_policy)
        model = MultiModalPerceiver(policy=policy, remat=True, device=device,
                                    generator=generator)
        if n_chunks not in (None, FULL_SCALE_CHUNKS):
            print(f"--full-scale forces n_chunks={FULL_SCALE_CHUNKS} (requested {n_chunks})")
        num_frames, hw, num_classes, n_chunks = 16, (224, 224), 700, FULL_SCALE_CHUNKS
        n_audio = 16 * (48000 // 25)
    else:
        n_chunks = 4 if n_chunks is None else n_chunks
        model = MultiModalPerceiver(**TINY, policy=dataclasses.replace(
            DEFAULT, remat_policy=remat_policy), remat=True, device=device,
            generator=generator)
        num_frames, hw, num_classes = TINY["num_frames"], TINY["img_size"], TINY["num_classes"]
        n_audio = num_frames * TINY["audio_samples_per_frame"]
    dataset = None
    if data_dir is not None:
        dataset = VideoClipDataset(
            data_dir, num_frames=num_frames, image_size=hw,
            audio_samples_per_frame=n_audio // num_frames, labels_file=labels_file,
            class_names=kinetics700_labels() if num_classes == 700 else None)
        print(f"{len(dataset)} clips from {data_dir}")
    else:
        video, audio, labels = synthetic_clips(4 * batch_size, num_frames, hw, n_audio,
                                               num_classes)

    if checkpoint_every is None:
        checkpoint_every = 0 if checkpoint_dir is None else max(steps // 2, 1)
    trainer = Trainer(
        functools.partial(loss_fn, n_chunks=n_chunks),
        build_optimizer(
            lr or (1e-4 if full_scale else 1e-3), schedule="cosine",
            total_steps=steps, warmup_steps=max(steps // 10, 1), clip_norm=1.0,
        ),
        metrics_path=metrics_path,
        log_every=log_every,
        checkpoint_dir=checkpoint_dir,
        checkpoint_every=checkpoint_every,
        prefetch=prefetch,
    )

    # epochs=None reshuffles every epoch; start_batch puts a resumed run at
    # the data position of an uninterrupted one
    def batches(start_step=0):
        if dataset is not None:
            source = dataset_iterator(dataset, batch_size, shuffle=True, epochs=None,
                                      start_batch=start_step, num_workers=4)
        else:
            source = batch_iterator((video, audio, labels), batch_size, shuffle=True,
                                    epochs=None, start_batch=start_step)
        for batch in source:
            yield batch if prefetch else tuple(torch.from_numpy(a).to(device) for a in batch)

    return trainer, trainer.init_state(model), batches


def main(steps=20, batch_size=1, n_chunks=None, full_scale=False, *, device="cuda",
         metrics_path="./multimodal_metrics.jsonl", lr=None, data_dir=None, labels_file=None,
         checkpoint_dir=None, checkpoint_every=None, resume=False, remat_policy=None):
    trainer, state, batches = setup(steps, batch_size, n_chunks, full_scale, device=device,
                                    metrics_path=metrics_path, lr=lr, data_dir=data_dir,
                                    labels_file=labels_file, checkpoint_dir=checkpoint_dir,
                                    checkpoint_every=checkpoint_every, prefetch=2,
                                    remat_policy=remat_policy)
    state = trainer.fit(state, batches, num_steps=steps, resume=resume)
    print(f"finished at step {state.step}")
    return state


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", type=int, default=20)
    parser.add_argument("--batch-size", type=int, default=1)
    parser.add_argument("--n-chunks", type=int, default=None,
                        help="default 4 (tiny); --full-scale forces 16")
    parser.add_argument("--full-scale", action="store_true",
                        help="published Kinetics config, remat + bf16")
    parser.add_argument("--lr", type=float, default=None,
                        help="peak learning rate (default 1e-4 full-scale, 1e-3 tiny)")
    parser.add_argument("--data-dir", default=None,
                        help=".avi/.mp4 clips with .wav sidecars; default: synthetic clips")
    parser.add_argument("--labels-file", default=None,
                        help="JSON clip stem -> class index or name (with --data-dir)")
    parser.add_argument("--checkpoint-dir", default=None)
    parser.add_argument("--checkpoint-every", type=int, default=None,
                        help="steps between checkpoints (default steps // 2)")
    parser.add_argument("--resume", action="store_true",
                        help="continue from the newest checkpoint in --checkpoint-dir")
    parser.add_argument("--remat-policy", default=None,
                        help="what remat keeps for the backward (default: dots_saveable"
                             " full-scale, full remat tiny)")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()
    main(args.steps, args.batch_size, args.n_chunks, full_scale=args.full_scale,
         device=args.device, lr=args.lr, data_dir=args.data_dir,
         labels_file=args.labels_file, checkpoint_dir=args.checkpoint_dir,
         checkpoint_every=args.checkpoint_every, resume=args.resume,
         remat_policy=args.remat_policy)
