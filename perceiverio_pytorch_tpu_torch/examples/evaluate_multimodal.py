"""Multimodal (Kinetics autoencoding) evaluation: reconstruction and labels, on one GPU.

Counterpart of the JAX package's ``examples/evaluate_multimodal.py``: the
MultiModalPerceiver over a directory of clips, scoring video PSNR and audio
PSNR of the autoencoded modalities and, where a clip's label resolves,
top-1 and top-5 Kinetics accuracy.  As in the reference protocol, the first
``num_frames`` frames of each clip are autoencoded with the label query
fully masked.

Data layout (scanned recursively):

    data_dir/<class name or index>/<clip>.avi   # label from the directory name
    data_dir/<clip>.avi  +  <clip>.wav          # audio optional (silence if absent)

Labels resolve from ``--labels-file`` (JSON: clip stem -> class index or
name), else from the parent directory's name (an integer, or a Kinetics-700
class name with '_' for spaces).  A clip without a label still counts for
the reconstruction.  Frames are read with ``utils.image.load_video`` (a
short clip repeats its last frame); a ``.wav`` sidecar is read with
``scipy.io.wavfile`` (int16 scaled by 2^-15), cut or zero-padded to the
model's samples.

    python -m perceiverio_pytorch_tpu_torch.examples.evaluate_multimodal --data-dir DIR \\
        [--checkpoint CKPT | --torch-checkpoint video_autoencoding_checkpoint.pth] \\
        [--small] [--labels-file F] [--limit N] [--n-chunks K]

The published model runs in bf16 (``PERFORMANCE``, 16 decoder chunks);
``--small`` is the JAX script's tiny configuration (4 chunks).  Without a
checkpoint the weights are random (seed 0).  Prints one JSON line: clips,
video_psnr, audio_psnr, top1, top5, labeled_clips and clips_per_sec (the
first clip, the warm-up, left out).  Runs on the GPU unless the caller asks
for the CPU (``--device cpu``).
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import time

import numpy as np
import torch

from perceiverio_pytorch_tpu_torch.config import PERFORMANCE
from perceiverio_pytorch_tpu_torch.models.multimodal import MultiModalPerceiver
from perceiverio_pytorch_tpu_torch.training.checkpoint import restore_eval_variables
from perceiverio_pytorch_tpu_torch.utils.compilation_cache import (
    add_cache_arg,
    enable_cache_if_requested,
)
from perceiverio_pytorch_tpu_torch.utils.device import resolve_device
from perceiverio_pytorch_tpu_torch.utils.image import load_video
from perceiverio_pytorch_tpu_torch.utils.labels import kinetics700_labels

# The JAX script's tiny configuration (random weights, the real pipeline).
SMALL = dict(img_size=(16, 16), num_frames=2, num_classes=11, audio_samples_per_frame=128,
             audio_samples_per_patch=16, num_self_attends_per_block=1, num_latents=8,
             num_latent_channels=512)


def _resolve_label(stem, parent, labels_file_map, name_to_idx):
    if labels_file_map is not None and stem in labels_file_map:
        v = labels_file_map[stem]
        if isinstance(v, str):
            # normalised as the directory names below ("playing_piano")
            return name_to_idx.get(v.replace("_", " ").lower())
        return int(v)
    try:
        return int(parent)
    except ValueError:
        return name_to_idx.get(parent.replace("_", " ").lower())


def _clips(data_dir, labels_file_map, name_to_idx):
    """(video path, wav path or None, label or None) of every clip, sorted."""
    paths = sorted(glob.glob(os.path.join(data_dir, "**", "*.avi"), recursive=True)
                   + glob.glob(os.path.join(data_dir, "**", "*.mp4"), recursive=True))
    if not paths:
        raise ValueError(f"no .avi/.mp4 clips under {data_dir}")
    for path in paths:
        stem = os.path.splitext(os.path.basename(path))[0]
        wav = os.path.splitext(path)[0] + ".wav"
        label = _resolve_label(stem, os.path.basename(os.path.dirname(path)),
                               labels_file_map, name_to_idx)
        yield path, (wav if os.path.exists(wav) else None), label


def _psnr(mse, peak):
    return float(10.0 * np.log10(peak * peak / max(mse, 1e-12)))


def read_clip(path, wav_path, num_frames, hw, n_audio):
    """A clip's arrays: video [T, H, W, 3] float32 in [0, 1] (None when the
    file has no frame) and audio [n_audio, 1] float32 (zeros without a
    sidecar)."""
    h, w = hw
    video = load_video(path, max_frames=num_frames, resize=(w, h))
    if video.shape[0] == 0:
        return None, None
    if video.shape[0] < num_frames:  # pad a short clip by repeating its last frame
        video = np.concatenate(
            [video, np.repeat(video[-1:], num_frames - video.shape[0], axis=0)])
    if wav_path is None:
        return video, np.zeros((n_audio, 1), np.float32)
    import scipy.io.wavfile

    _, audio = scipy.io.wavfile.read(wav_path)
    if audio.dtype == np.int16:
        audio = audio.astype(np.float32) / 2**15
    audio = np.asarray(audio, np.float32).reshape(audio.shape[0], -1)[:n_audio, :1]
    if audio.shape[0] < n_audio:
        audio = np.pad(audio, ((0, n_audio - audio.shape[0]), (0, 0)))
    return video, audio


def build_model(checkpoint=None, torch_checkpoint=None, small=False, *, device="cuda"):
    """The evaluated model in eval mode: the published configuration in bf16
    (the tiny one in fp32 with ``small``), weights from seed 0 or the
    checkpoint."""
    generator = torch.Generator().manual_seed(0)
    if small:
        model = MultiModalPerceiver(**SMALL, device=device, generator=generator)
    else:
        model = MultiModalPerceiver(policy=PERFORMANCE, device=device, generator=generator)
    return restore_eval_variables(model, checkpoint, torch_checkpoint).eval()


def main(data_dir, checkpoint=None, torch_checkpoint=None, small=False, labels_file=None,
         limit=None, n_chunks=None, *, device="cuda"):
    device = resolve_device(device)
    model = build_model(checkpoint, torch_checkpoint, small, device=device)
    t = model.num_frames
    n_audio = t * model.audio_samples_per_frame
    n_chunks = n_chunks or (4 if small else 16)

    labels_file_map = None
    if labels_file:
        with open(labels_file) as f:
            labels_file_map = json.load(f)
    names = kinetics700_labels() if model.num_classes == 700 else []
    name_to_idx = {n.lower(): i for i, n in enumerate(names)}

    video_se = video_n = 0.0
    audio_se = audio_n = 0.0
    top1 = top5 = n_labeled = 0
    n_clips = 0
    t0, timed = None, 0
    with torch.inference_mode():
        for path, wav_path, label in _clips(data_dir, labels_file_map, name_to_idx):
            video, audio = read_clip(path, wav_path, t, model.img_size, n_audio)
            if video is None:
                continue
            video_chw = np.ascontiguousarray(np.moveaxis(video, -1, -3))  # [T, C, H, W]
            out = model(torch.from_numpy(video_chw[None]).to(device),
                        torch.from_numpy(audio[None]).to(device), n_chunks=n_chunks)
            rec_video = out["image"][0].float().cpu().numpy()
            rec_audio = out["audio"][0].float().cpu().numpy()
            logits = out["label"][0].float().cpu().numpy()
            if t0 is None:
                t0 = time.perf_counter()  # the first clip's warm-up is not timed
            else:
                timed += 1
            video_se += float(((np.clip(rec_video, 0, 1) - video_chw) ** 2).sum())
            video_n += rec_video.size
            if wav_path is not None:
                audio_se += float(((rec_audio - audio) ** 2).sum())
                audio_n += rec_audio.size
            if label is not None:
                order = np.argsort(-logits)
                top1 += int(order[0] == label)
                top5 += int(label in order[:5])
                n_labeled += 1
            n_clips += 1
            if limit and n_clips >= limit:
                break

    elapsed = time.perf_counter() - t0 if t0 else 0.0
    result = {"clips": n_clips}
    if video_n:
        result["video_psnr"] = round(_psnr(video_se / video_n, 1.0), 3)
    if audio_n:
        # a waveform in [-1, 1]: peak-to-peak 2
        result["audio_psnr"] = round(_psnr(audio_se / audio_n, 2.0), 3)
    if n_labeled:
        result["top1"] = round(top1 / n_labeled, 4)
        result["top5"] = round(top5 / n_labeled, 4)
        result["labeled_clips"] = n_labeled
    if timed and elapsed > 0:
        result["clips_per_sec"] = round(timed / elapsed, 2)
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--data-dir", required=True,
                        help="directory scanned recursively for clips")
    parser.add_argument("--checkpoint", default=None,
                        help="weights directory or Trainer checkpoint")
    parser.add_argument("--torch-checkpoint", default=None,
                        help="reference video_autoencoding_checkpoint.pth")
    parser.add_argument("--small", action="store_true",
                        help="tiny random-weight configuration (pipeline demo)")
    parser.add_argument("--labels-file", default=None,
                        help="JSON: clip stem -> class index or name")
    parser.add_argument("--limit", type=int, default=None)
    parser.add_argument("--n-chunks", type=int, default=None,
                        help="decoder chunks (16 at full width, 4 with --small)")
    parser.add_argument("--device", default="cuda")
    add_cache_arg(parser)
    args = parser.parse_args()
    enable_cache_if_requested(args)
    main(args.data_dir, checkpoint=args.checkpoint, torch_checkpoint=args.torch_checkpoint,
         small=args.small, labels_file=args.labels_file, limit=args.limit,
         n_chunks=args.n_chunks, device=args.device)
