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
decode rematerialised in the backward) and the bf16 ``PERFORMANCE``
policy: the encoder's cross-attend then runs the hand-written flash
kernels forward (K1) and backward (K2, K3) at head width 704.

    python -m perceiverio_pytorch_tpu_torch.examples.train_multimodal --steps 20 [--full-scale]

Runs on the GPU unless the caller asks for the CPU (``--device cpu``, or
``main(device="cpu")``).  Not ported: real clips (``--data-dir``),
checkpoints and resuming, and the JAX example's selective remat policy
(the port rematerialises in full).
"""

from __future__ import annotations

import argparse
import functools

import numpy as np
import torch

from perceiverio_pytorch_tpu_torch.config import PERFORMANCE
from perceiverio_pytorch_tpu_torch.models.flow import resolve_device
from perceiverio_pytorch_tpu_torch.models.multimodal import MultiModalPerceiver
from perceiverio_pytorch_tpu_torch.training import (
    Trainer,
    batch_iterator,
    build_optimizer,
    multimodal_autoencode_loss,
)

TINY = dict(img_size=(16, 16), num_frames=2, num_classes=11, audio_samples_per_frame=128,
            audio_samples_per_patch=16, num_self_attends_per_block=1, num_blocks=1,
            num_latents=8, num_latent_channels=512)
WEIGHTS = {"image": 1.0, "audio": 1.0, "label": 0.01}
FULL_SCALE_CHUNKS = 16


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
    ``n_chunks`` chunks."""
    out = model(video, audio, n_chunks)
    return multimodal_autoencode_loss(
        out, {"image": video, "audio": audio, "label": labels}, weights=WEIGHTS)


def setup(steps=20, batch_size=1, n_chunks=None, full_scale=False, *, device="cuda",
          metrics_path="./multimodal_metrics.jsonl", log_every=5, lr=None):
    """The example's trainer, initial state and batch stream:
    ``(trainer, state, batches)``, where ``batches(start_step)`` yields
    batches on ``device``.  Weights are drawn from seed 0."""
    device = resolve_device(device)
    generator = torch.Generator().manual_seed(0)
    if full_scale:
        model = MultiModalPerceiver(policy=PERFORMANCE, remat=True, device=device,
                                    generator=generator)
        if n_chunks not in (None, FULL_SCALE_CHUNKS):
            print(f"--full-scale forces n_chunks={FULL_SCALE_CHUNKS} (requested {n_chunks})")
        num_frames, hw, num_classes, n_chunks = 16, (224, 224), 700, FULL_SCALE_CHUNKS
        n_audio = 16 * (48000 // 25)
    else:
        n_chunks = 4 if n_chunks is None else n_chunks
        model = MultiModalPerceiver(**TINY, remat=True, device=device, generator=generator)
        num_frames, hw, num_classes = TINY["num_frames"], TINY["img_size"], TINY["num_classes"]
        n_audio = num_frames * TINY["audio_samples_per_frame"]
    video, audio, labels = synthetic_clips(4 * batch_size, num_frames, hw, n_audio, num_classes)

    trainer = Trainer(
        functools.partial(loss_fn, n_chunks=n_chunks),
        build_optimizer(
            lr or (1e-4 if full_scale else 1e-3), schedule="cosine",
            total_steps=steps, warmup_steps=max(steps // 10, 1), clip_norm=1.0,
        ),
        metrics_path=metrics_path,
        log_every=log_every,
    )

    def batches(start_step=0):
        for batch in batch_iterator((video, audio, labels), batch_size, shuffle=True,
                                    epochs=None, start_batch=start_step):
            yield tuple(torch.from_numpy(a).to(device) for a in batch)

    return trainer, trainer.init_state(model), batches


def main(steps=20, batch_size=1, n_chunks=None, full_scale=False, *, device="cuda",
         metrics_path="./multimodal_metrics.jsonl", lr=None):
    trainer, state, batches = setup(steps, batch_size, n_chunks, full_scale, device=device,
                                    metrics_path=metrics_path, lr=lr)
    state = trainer.fit(state, batches, num_steps=steps)
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
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()
    main(args.steps, args.batch_size, args.n_chunks, full_scale=args.full_scale,
         device=args.device, lr=args.lr)
