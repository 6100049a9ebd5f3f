"""Multimodal Kinetics autoencoding demo: video, audio and a label.

Counterpart of the JAX package's ``examples/multimodal.py`` (the
reference's ``example_multimodal.py``): ``MultiModalPerceiver`` at full
width auto-encodes 16 frames of 224x224 and their 48 kHz audio (with a
fully masked label query), decoded in 16 chunks as the JAX demo has it
(the reference decodes in 128; the outputs do not depend on the count).
Writes ``audio_reconstruction.wav`` and ``video_reconstruction.avi`` into
the working directory and prints the top 5 Kinetics-700 classes.

    python -m perceiverio_pytorch_tpu_torch.examples.multimodal \\
        [--video V.avi --audio A.wav] [--checkpoint X.pth | --random-init]

The wav holds int16 or float32 samples, with a channel axis (the first
channel is taken).  ``--checkpoint`` is a reference-convention ``.pth``,
loaded strictly (default: the JAX demo's path); ``--random-init`` draws
seeded weights instead.  Runs on the GPU unless asked for the CPU
(``--device cpu``).
"""

from __future__ import annotations

import argparse
import os
from typing import Dict

import numpy as np
import torch

from perceiverio_pytorch_tpu_torch.models.multimodal import MultiModalPerceiver
from perceiverio_pytorch_tpu_torch.training.checkpoint import restore_eval_variables
from perceiverio_pytorch_tpu_torch.utils.device import resolve_device
from perceiverio_pytorch_tpu_torch.utils.image import load_video, save_video
from perceiverio_pytorch_tpu_torch.utils.labels import kinetics700_labels

CKPT_FILE = "./pytorch_checkpoints/video_autoencoding_checkpoint.pth"

FRAMES_PER_SECOND = 25
SAMPLING_RATE = 48000
NUM_FRAMES = 16
AUDIO_SAMPLES_PER_FRAME = SAMPLING_RATE // FRAMES_PER_SECOND
SAMPLES_PER_PATCH = 16
NUM_CLASSES = 700
IMG_SZ = 224
N_CHUNKS = 16


def multimodal_example(
    video_path: str = "./sample_data/video.avi",
    audio_path: str = "./sample_data/audio.wav",
    random_init: bool = False,
    checkpoint: str = CKPT_FILE,
    *,
    device="cuda",
    seed: int = 0,
) -> Dict[str, torch.Tensor]:
    """The reconstruction ({"image", "audio", "label"}, on the model's
    device); writes the wav and the avi and prints the top 5 classes."""
    import scipy.io.wavfile

    device = resolve_device(device)
    if not random_init and not os.path.isfile(checkpoint):
        raise ValueError(
            "Please download the converted checkpoint and place it in"
            " ./pytorch_checkpoints (see README), or pass --random-init for"
            " an untrained demo run."
        )

    sample_rate, audio = scipy.io.wavfile.read(audio_path)
    if audio.dtype == np.int16:
        audio = audio.astype(np.float32) / 2**15
    elif audio.dtype != np.float32:
        raise ValueError("Model expects sound samples in [-1, 1]")

    video = load_video(video_path, resize=(IMG_SZ, IMG_SZ))

    model = MultiModalPerceiver(
        num_frames=NUM_FRAMES,
        audio_samples_per_frame=AUDIO_SAMPLES_PER_FRAME,
        audio_samples_per_patch=SAMPLES_PER_PATCH,
        num_classes=NUM_CLASSES,
        img_size=(IMG_SZ, IMG_SZ),
        device=device,
        generator=torch.Generator().manual_seed(seed),
    )
    if not random_init:
        restore_eval_variables(model, torch_checkpoint=checkpoint)
    model.eval()

    video_input = torch.from_numpy(
        np.ascontiguousarray(np.moveaxis(video[None, :NUM_FRAMES], -1, -3), np.float32))
    audio_input = torch.from_numpy(
        np.ascontiguousarray(audio[None, : NUM_FRAMES * AUDIO_SAMPLES_PER_FRAME, 0:1],
                             np.float32))
    with torch.inference_mode():
        reconstruction = model(video_input.to(device), audio_input.to(device), N_CHUNKS)

    scipy.io.wavfile.write(
        "./audio_reconstruction.wav",
        SAMPLING_RATE,
        (reconstruction["audio"][0].float().cpu().numpy() * 2**15).astype(np.int16),
    )
    save_video(
        "./video_reconstruction.avi",
        np.clip(np.moveaxis(reconstruction["image"][0].float().cpu().numpy(), -3, -1), 0, 1),
    )

    probs = torch.softmax(reconstruction["label"].float(), dim=-1)[0].cpu().numpy()
    top5 = np.argsort(-probs)[:5]
    labels = kinetics700_labels()
    for idx in top5:
        print(f"{labels[idx]}: {float(probs[idx]) * 100:.1f}%")
    return reconstruction


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--video", default="./sample_data/video.avi")
    parser.add_argument("--audio", default="./sample_data/audio.wav")
    parser.add_argument("--random-init", action="store_true",
                        help="run with seeded untrained weights")
    parser.add_argument("--checkpoint", default=CKPT_FILE, help="reference-convention .pth")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()
    multimodal_example(args.video, args.audio, random_init=args.random_init,
                       checkpoint=args.checkpoint, device=args.device, seed=args.seed)
