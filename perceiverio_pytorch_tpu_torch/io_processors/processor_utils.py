"""Tensor-shuffling utilities for IO processors (channel-last tensors).

Counterpart of ``perceiverio_pytorch_tpu/io_processors/processor_utils.py``:
  * ``space_to_depth``: stack spatial/temporal blocks into channels, in
    (dt, dh, dw, c) order, for rank-4 images and rank-5 video;
  * ``extract_patches``: VALID patch extraction, the flattened patch in
    (ph, pw, c) channel order;
  * ``patches_for_flow``: pad 1 pixel and take 3x3 patches per frame.
"""

from __future__ import annotations

from typing import Sequence, Union

import torch
import torch.nn.functional as F


def space_to_depth(frames: torch.Tensor, temporal_block_size: int = 1,
                   spatial_block_size: int = 1) -> torch.Tensor:
    """[B, H, W, C] or [B, T, H, W, C] -> blocks folded into channels."""
    s = spatial_block_size
    if frames.dim() == 4:
        b, h, w, c = frames.shape
        x = frames.reshape(b, h // s, s, w // s, s, c)
        return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h // s, w // s, s * s * c)
    if frames.dim() == 5:
        t_ = temporal_block_size
        b, t, h, w, c = frames.shape
        x = frames.reshape(b, t // t_, t_, h // s, s, w // s, s, c)
        x = x.permute(0, 1, 3, 5, 2, 4, 6, 7)
        return x.reshape(b, t // t_, h // s, w // s, t_ * s * s * c)
    raise ValueError(
        "Frames should be of rank 4 (batch, height, width, channels)"
        " or rank 5 (batch, time, height, width, channels)"
    )


def _pair(v: Union[int, Sequence[int]]) -> tuple:
    if isinstance(v, int):
        return (v, v)
    return tuple(int(x) for x in v)


def extract_patches(images: torch.Tensor, size: Sequence[int],
                    stride: Union[int, Sequence[int]] = 1,
                    dilation: Union[int, Sequence[int]] = 1,
                    padding: str = "VALID") -> torch.Tensor:
    """[B, H, W, C] -> [B, out_h, out_w, ph * pw * C], (ph, pw, c) order."""
    if padding != "VALID":
        raise ValueError(f"Only valid padding is supported. Got {padding}")
    if images.dim() != 4:
        raise ValueError(
            f"Rank of images must be 4 (got tensor of shape {tuple(images.shape)})"
        )
    ph, pw = _pair(size)
    sh, sw = _pair(stride)
    dh, dw = _pair(dilation)
    _, h, w, _ = images.shape
    out_h = (h - dh * (ph - 1) - 1) // sh + 1
    out_w = (w - dw * (pw - 1) - 1) // sw + 1
    pieces = []
    for i in range(ph):
        for j in range(pw):
            top, left = i * dh, j * dw
            pieces.append(images[:, top:top + (out_h - 1) * sh + 1:sh,
                                 left:left + (out_w - 1) * sw + 1:sw, :])
    return torch.cat(pieces, dim=-1)


def patches_for_flow(inputs: torch.Tensor) -> torch.Tensor:
    """[N, T, H, W, C] frame stack -> [N, T, H, W, 9*C] 3x3 patch features."""
    n, t = inputs.shape[:2]
    flat = inputs.reshape((n * t,) + tuple(inputs.shape[2:]))
    padded = F.pad(flat, (0, 0, 1, 1, 1, 1))
    patches = extract_patches(padded, size=(3, 3), stride=1, dilation=1)
    return patches.reshape((n, t) + tuple(patches.shape[1:]))
