"""Write the synthetic datasets of the training and evaluation recipes.

The port's copy of the JAX package's ``tools/make_synthetic_data.py``: the
same trees from the same ``zlib.crc32`` seeds (class-conditional oriented
gratings with Gaussian noise; template-grammar text; Sintel-style scenes
whose frames are integer rolls of each other; labelled clips of drifting
gratings with sine audio), written through the port's PNG, ``.flo`` and
video writers.  Sizes and counts are arguments, so that a small tree or a
Sintel-sized 436x1024 flow tree can be written; the defaults are the JAX
tool's.

    python -m perceiverio_pytorch_tpu_torch.tools.make_synthetic_data --root /tmp/data \\
        [--only flow --flow-size 436 1024]

Writes:
  <root>/imagenet_synth/{train,val}/class_XX/*.png   10 easy classes
  <root>/imagenet_med/{train,val}/class_XX/*.png     16 classes, mid SNR
  <root>/imagenet_med_valhard/val/class_XX/*.png     degraded-SNR val
  <root>/text/corpus_{train,val}.txt                 ~3 MB template text
  <root>/flow_synth/{train,val}/scene_XX/{frames,flow}/   Sintel-style
  <root>/kinetics_synth/{train,val}/<class idx>/*.avi+.wav  labelled clips

Then, for example:
  python -m perceiverio_pytorch_tpu_torch.examples.train_flow --full-scale \\
      --data-dir <root>/flow_synth/train --steps 3000 --checkpoint-dir /tmp/ckpt_flow
  python -m perceiverio_pytorch_tpu_torch.examples.evaluate_flow \\
      --data-dir <root>/flow_synth/val/scene_00 --checkpoint /tmp/ckpt_flow/step_00003000
"""

from __future__ import annotations

import argparse
import os
import zlib
from typing import Dict, Sequence, Tuple

import numpy as np

from perceiverio_pytorch_tpu_torch.utils.flow_io import write_flo
from perceiverio_pytorch_tpu_torch.utils.image import save_video, write_png

IMAGE_HW = (224, 224)
FLOW_HW = (368, 496)
FLOW_SCENES = {"train": (12, 13), "val": (2, 7)}  # split: (scenes, frames a scene)
CLIPS_PER_CLASS = {"train": 60, "val": 2}


def _seed(*parts) -> int:
    return zlib.crc32("/".join(str(p) for p in parts).encode()) & 0x7FFFFFFF


def _grating(theta, freq, amplitude, r, hw):
    yy, xx = np.mgrid[0:hw[0], 0:hw[1]].astype(np.float32)
    phase = r.uniform(0, 2 * np.pi)
    g = np.sin((np.cos(theta) * xx + np.sin(theta) * yy) * freq * 2 * np.pi + phase)
    return g * amplitude + 128


def make_easy(root: str, *, per_split: Dict[str, int] = None, hw=IMAGE_HW) -> None:
    """10 well-separated classes (orientation x frequency), high SNR."""
    h, w = hw
    for split, per in (per_split or {"train": 150, "val": 40}).items():
        for c in range(10):
            d = os.path.join(root, "imagenet_synth", split, f"class_{c:02d}")
            os.makedirs(d, exist_ok=True)
            theta, freq = np.pi * c / 10.0, 0.05 + 0.02 * (c % 5)
            for i in range(per):
                r = np.random.RandomState(_seed("easy", split, c, i))
                base = _grating(theta, freq, 60, r, hw)
                img = np.stack([
                    base + r.normal(0, 25, (h, w)),
                    base * (0.8 + 0.4 * r.rand()) + r.normal(0, 25, (h, w)),
                    base * (0.8 + 0.4 * r.rand()) + r.normal(0, 25, (h, w)),
                ], -1)
                write_png(os.path.join(d, f"{i:04d}.png"), np.clip(img, 0, 255).astype(np.uint8))
    print("imagenet_synth done")


def make_gratings(root: str, name: str, *, n_classes: int, amplitude: float, noise: float,
                  per_split: Dict[str, int], splits: Sequence[str], hw=IMAGE_HW) -> None:
    """Close orientations at a fixed frequency; the SNR sets the difficulty."""
    h, w = hw
    for split in splits:
        for c in range(n_classes):
            d = os.path.join(root, name, split, f"class_{c:02d}")
            os.makedirs(d, exist_ok=True)
            theta = np.pi * c / n_classes
            for i in range(per_split[split]):
                r = np.random.RandomState(_seed(name, split, c, i))
                base = _grating(theta, 0.06, amplitude, r, hw)
                img = np.stack([base + r.normal(0, noise, (h, w)) for _ in range(3)], -1)
                write_png(os.path.join(d, f"{i:04d}.png"), np.clip(img, 0, 255).astype(np.uint8))
    print(f"{name} done")


def make_text(root: str, *, total_chars: int = 3_000_000) -> None:
    subjects = ["the model", "a perceiver", "the encoder", "our decoder",
                "the latent array", "a transformer", "the attention head",
                "this framework", "the compiler", "a kernel"]
    verbs = ["computes", "attends to", "projects", "normalizes", "decodes",
             "encodes", "compresses", "reconstructs", "predicts", "samples"]
    objects = ["the input tokens", "a query vector", "the output logits",
               "masked positions", "fourier features", "latent channels",
               "the byte sequence", "spatial patches", "audio samples",
               "position encodings"]
    adverbs = ["quickly", "exactly", "in parallel", "on the device",
               "per layer", "with residuals", "at scale", "in bfloat16",
               "per head", "once per block"]
    r = np.random.RandomState(1)
    parts, total = [], 0
    while total < total_chars:
        s = (f"{r.choice(subjects)} {r.choice(verbs)} {r.choice(objects)}"
             f" {r.choice(adverbs)}. ")
        parts.append(s)
        total += len(s)
    text = "".join(parts)
    os.makedirs(os.path.join(root, "text"), exist_ok=True)
    with open(os.path.join(root, "text", "corpus_train.txt"), "w") as f:
        f.write(text[: int(len(text) * 0.9)])
    with open(os.path.join(root, "text", "corpus_val.txt"), "w") as f:
        f.write(text[int(len(text) * 0.9):])
    print("text done", len(text))


def make_flow(root: str, *, hw: Tuple[int, int] = FLOW_HW, max_shift: int = 3,
              scenes: Dict[str, Tuple[int, int]] = None) -> None:
    """Sintel-style scenes: frame i+1 is an integer roll of frame i.

    Frames are 4x-upsampled noise quantised to uint8 before rolling, so a
    pair is related by an exact integer translation and its ``.flo`` (a
    constant field, channel 0 horizontal) is exact but at the wrapped
    border.  ``scenes`` maps a split to (scenes, frames a scene).
    """
    h, w = hw
    for split, (n_scenes, n_frames) in (scenes or FLOW_SCENES).items():
        for s in range(n_scenes):
            d = os.path.join(root, "flow_synth", split, f"scene_{s:02d}")
            os.makedirs(os.path.join(d, "frames"), exist_ok=True)
            os.makedirs(os.path.join(d, "flow"), exist_ok=True)
            r = np.random.RandomState(_seed("flow", split, s))
            base = r.uniform(0, 255, (3, h // 4 + 1, w // 4 + 1))
            frame = np.kron(base, np.ones((1, 4, 4)))[:, :h, :w]
            frame = np.clip(frame, 0, 255).astype(np.uint8)  # [3, H, W]
            for i in range(n_frames):
                write_png(os.path.join(d, "frames", f"frame_{i + 1:04d}.png"),
                          np.transpose(frame, (1, 2, 0)))
                if i == n_frames - 1:
                    break
                dy, dx = r.randint(-max_shift, max_shift + 1, 2)
                flow = np.zeros((2, h, w), np.float32)
                flow[0], flow[1] = dx, dy
                write_flo(os.path.join(d, "flow", f"frame_{i + 1:04d}.flo"), flow)
                frame = np.roll(frame, (dy, dx), axis=(1, 2))
    print("flow_synth done")


def make_clips(root: str, *, n_classes: int = 9, num_frames: int = 16, hw=(224, 224),
               sample_rate: int = 48000, samples_per_frame: int = 1920,
               per_class: Dict[str, int] = None) -> None:
    """Labelled clips: a grating at orientation pi*c/n drifting over the
    frames, with a wav sidecar sine at a class-keyed low frequency, in
    directories named by the integer label."""
    import scipy.io.wavfile

    h, w = hw
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    n_audio = num_frames * samples_per_frame
    t_audio = np.arange(n_audio, dtype=np.float32) / sample_rate
    for split, per in (per_class or CLIPS_PER_CLASS).items():
        for c in range(n_classes):
            d = os.path.join(root, "kinetics_synth", split, str(c))
            os.makedirs(d, exist_ok=True)
            theta = np.pi * c / n_classes
            carrier = (np.cos(theta) * xx + np.sin(theta) * yy) * 0.07
            for i in range(per):
                r = np.random.RandomState(_seed("clips", split, c, i))
                speed = r.uniform(0.5, 1.5) * (1 if r.rand() < 0.5 else -1)
                phase0 = r.uniform(0, 2 * np.pi)
                frames = []
                for f in range(num_frames):
                    g = np.sin(carrier + phase0 + speed * f)
                    rgb = np.stack([
                        0.5 + 0.35 * g,
                        0.5 + 0.35 * g * r.uniform(0.8, 1.0),
                        0.5 + 0.35 * g * r.uniform(0.8, 1.0),
                    ], -1)
                    frames.append(np.clip(rgb, 0, 1))
                save_video(os.path.join(d, f"clip_{i:03d}.avi"), np.asarray(frames, np.float32))
                freq = 30.0 * (1.167 ** c) * r.uniform(0.98, 1.02)
                wav = 0.5 * np.sin(2 * np.pi * freq * t_audio)
                scipy.io.wavfile.write(os.path.join(d, f"clip_{i:03d}.wav"), sample_rate,
                                       (wav * 2**15).astype(np.int16))
    print("kinetics_synth done")


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--root", default="/tmp/data")
    p.add_argument("--only", default=None, choices=["imagenet", "text", "flow", "clips"],
                   help="write one tree instead of all of them")
    p.add_argument("--flow-size", type=int, nargs=2, default=FLOW_HW, metavar=("H", "W"),
                   help="frame size of the flow tree (Sintel: 436 1024)")
    args = p.parse_args(argv)
    if args.only in (None, "imagenet"):
        make_easy(args.root)
        make_gratings(args.root, "imagenet_med", n_classes=16, amplitude=40, noise=48,
                      per_split={"train": 100, "val": 25}, splits=("train", "val"))
        make_gratings(args.root, "imagenet_med_valhard", n_classes=16, amplitude=20,
                      noise=58, per_split={"val": 25}, splits=("val",))
    if args.only in (None, "text"):
        make_text(args.root)
    if args.only in (None, "flow"):
        make_flow(args.root, hw=tuple(args.flow_size))
    if args.only in (None, "clips"):
        make_clips(args.root)


if __name__ == "__main__":
    main()
