"""Tensor-shuffling utilities for IO processors (channel-last tensors).

Counterpart of ``perceiverio_pytorch_tpu/io_processors/processor_utils.py``:
  * ``space_to_depth``: stack spatial/temporal blocks into channels, in
    (dt, dh, dw, c) order, for rank-4 images and rank-5 video;
  * ``extract_patches``: VALID patch extraction, the flattened patch in
    (ph, pw, c) channel order;
  * ``patches_for_flow``: pad 1 pixel and take 3x3 patches per frame;
  * ``Conv2DDownsample``: per layer a TF-SAME padded 7x7 stride-2 conv
    (no bias), BatchNorm, ReLU and a zero-padded 3x3 stride-2 max-pool, on
    channel-first tensors (torch's conv layout);
  * ``BatchNorm2d``: ``nn.BatchNorm2d`` with flax's train-mode statistics.
"""

from __future__ import annotations

from typing import Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

from perceiverio_pytorch_tpu_torch.utils.conv_shapes import conv_output_shape, same_padding
from perceiverio_pytorch_tpu_torch.utils.initializers import default_generator, trunc_normal_


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
    out_h, out_w = conv_output_shape((h, w), (ph, pw), (sh, sw), 0, (dh, dw))
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


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` (same parameters, buffers and state_dict names) with
    the statistics of flax's ``nn.BatchNorm(dtype=float32)``.

    Train mode normalises with the batch's mean and biased variance, computed
    in fp32 as flax does (E[x^2] - E[x]^2, clipped at 0), and moves the
    running averages by ``momentum`` towards that mean and that biased
    variance, where torch's own update takes the unbiased variance (a factor
    N / (N - 1) over the N values a channel has in the batch).  Eval mode
    normalises with the running averages.  Both return fp32, whatever the
    input's dtype.  Only flax's configuration is taken: a float ``momentum``,
    ``affine`` and ``track_running_stats``; anything else raises ValueError.
    """

    def __init__(self, num_features: int, eps: float = 1e-5, momentum: float = 0.1,
                 affine: bool = True, track_running_stats: bool = True, **kwargs):
        if not (isinstance(momentum, float) and affine and track_running_stats):
            raise ValueError(
                "BatchNorm2d takes a float momentum with affine=True and "
                f"track_running_stats=True (got momentum={momentum!r}, affine={affine}, "
                f"track_running_stats={track_running_stats})")
        super().__init__(num_features, eps=eps, momentum=momentum, affine=affine,
                         track_running_stats=track_running_stats, **kwargs)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        if not self.training:
            # fp32 scale and bias, whatever the parameters' dtype (flax's
            # dtype=float32 promotes bf16 parameters).
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight.float(),
                                self.bias.float(), False, 0.0, self.eps)
        mean = x.mean(dim=(0, 2, 3))
        var = torch.clamp((x * x).mean(dim=(0, 2, 3)) - mean * mean, min=0.0)
        with torch.no_grad():
            self.running_mean.lerp_(mean, self.momentum)
            self.running_var.lerp_(var, self.momentum)
            self.num_batches_tracked.add_(1)
        scale = self.weight * torch.rsqrt(var + self.eps)
        return (x - mean[:, None, None]) * scale[:, None, None] + self.bias[:, None, None]


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` with flax ``nn.Conv``'s dtype promotion (no compute
    dtype): input, weight and bias are cast to their common dtype, so bf16
    weights (``utils.params.cast_variables_for_inference``) take an fp32
    image and compute in fp32, as in the JAX package."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = torch.promote_types(x.dtype, self.weight.dtype)
        bias = None if self.bias is None else self.bias.to(dtype)
        return self._conv_forward(x.to(dtype), self.weight.to(dtype), bias)


class Conv2DDownsample(nn.Module):
    """Downsample 4x per layer: TF-SAME pad, 7x7 stride-2 conv (no bias),
    BatchNorm, ReLU, TF-SAME pad with zeros, 3x3 stride-2 max-pool.

    Children ``convs.{i}`` and ``norms.{i}`` (the reference's state_dict
    names).  The padding is explicit, ``F.pad`` then a conv and a pool with
    ``padding=0``: SAME puts the odd pixel right and bottom, and the pool's
    pad is 0, not -inf (after the ReLU no 0 can win wrongly).  BatchNorm
    (``BatchNorm2d``: flax's statistics) follows ``module.training`` (the JAX
    package's ``train`` flag): in train mode it normalises with the batch's
    statistics and updates its running averages, in eval mode it uses them,
    as the JAX package does by default.
    """

    def __init__(self, num_layers: int = 1, in_channels: int = 3, num_channels: int = 64,
                 use_batchnorm: bool = True, *, generator=None):
        super().__init__()
        g = default_generator(generator)
        self.convs = nn.ModuleList()
        for layer in range(num_layers):
            conv = Conv2d(in_channels if layer == 0 else num_channels, num_channels,
                          kernel_size=7, stride=2, bias=False)
            trunc_normal_(conv.weight.data, 0.01, g)
            self.convs.append(conv)
        # Flax's momentum 0.9 (the kept share of the average) is torch's 0.1.
        self.norms = (nn.ModuleList(BatchNorm2d(num_channels, eps=1e-5, momentum=0.1)
                                    for _ in range(num_layers)) if use_batchnorm else None)

    def forward(self, inputs: torch.Tensor) -> torch.Tensor:
        """inputs: [B, C, H, W] channel-first."""
        out = inputs
        for layer, conv in enumerate(self.convs):
            out = conv(F.pad(out, same_padding(out.shape[-2:], 7, 2)))
            if self.norms is not None:
                out = self.norms[layer](out)
            out = F.relu(out)
            out = F.pad(out, same_padding(out.shape[-2:], 3, 2), value=0.0)
            out = F.max_pool2d(out, kernel_size=3, stride=2)
        return out
