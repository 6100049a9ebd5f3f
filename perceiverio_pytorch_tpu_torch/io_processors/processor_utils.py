"""Tensor-shuffling utilities for IO processors (channel-last tensors).

Counterpart of ``perceiverio_pytorch_tpu/io_processors/processor_utils.py``:
  * ``space_to_depth``: stack spatial/temporal blocks into channels, in
    (dt, dh, dw, c) order, for rank-4 images and rank-5 video, and
    ``reverse_space_to_depth``, its exact inverse;
  * ``extract_patches``: VALID patch extraction, the flattened patch in
    (ph, pw, c) channel order;
  * ``patches_for_flow``: pad 1 pixel and take 3x3 patches per frame;
  * ``Conv2DDownsample``: per layer a TF-SAME padded 7x7 stride-2 conv
    (no bias), BatchNorm, ReLU and a zero-padded 3x3 stride-2 max-pool, on
    channel-first tensors (torch's conv layout);
  * ``BatchNorm2d``: ``nn.BatchNorm2d`` with flax's train-mode statistics;
  * ``Conv2DUpsample`` / ``Conv3DUpsample``: the image postprocessor's
    transposed-convolution upsamplers, channel-last in and out (flax
    ``nn.ConvTranspose`` with SAME padding, ``ConvTranspose``).
"""

from __future__ import annotations

from typing import Sequence, Union

import math

import torch
import torch.nn.functional as F
from torch import nn

from perceiverio_pytorch_tpu_torch.parallel.collectives import all_reduce_sum, data_group
from perceiverio_pytorch_tpu_torch.utils.conv_shapes import conv_output_shape, same_padding
from perceiverio_pytorch_tpu_torch.utils.initializers import (
    default_generator,
    lecun_normal_,
    trunc_normal_,
)


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


def reverse_space_to_depth(frames: torch.Tensor, temporal_block_size: int = 1,
                           spatial_block_size: int = 1) -> torch.Tensor:
    """Inverse of ``space_to_depth``: channels (dt, dh, dw, c) unfolded into
    [B, H*dh, W*dw, C] or [B, T*dt, H*dh, W*dw, C]."""
    s = spatial_block_size
    if frames.dim() == 4:
        b, h, w, c = frames.shape
        x = frames.reshape(b, h, w, s, s, c // (s * s))
        return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h * s, w * s, c // (s * s))
    if frames.dim() == 5:
        t_ = temporal_block_size
        b, t, h, w, c = frames.shape
        x = frames.reshape(b, t, h, w, t_, s, s, c // (t_ * s * s))
        x = x.permute(0, 1, 4, 2, 5, 3, 6, 7)
        return x.reshape(b, t * t_, h * s, w * s, c // (t_ * s * s))
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

    Inside the train step of a mesh whose data axis has more than one rank
    (``parallel.collectives.global_batch``), the train-mode statistics are
    the global batch's: the fp32 sums and sums of squares are all-reduced
    over the data axis (with their gradients), as GSPMD reduces the sharded
    batch's mean.  Otherwise they are the rank's batch's, as above.
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
        group = data_group()
        if group is None:
            mean = x.mean(dim=(0, 2, 3))
            var = torch.clamp((x * x).mean(dim=(0, 2, 3)) - mean * mean, min=0.0)
        else:
            sums = all_reduce_sum(torch.stack([x.sum(dim=(0, 2, 3)),
                                               (x * x).sum(dim=(0, 2, 3))]), group)
            count = x.numel() // x.shape[1] * torch.distributed.get_world_size(group)
            mean = sums[0] / count
            var = torch.clamp(sums[1] / count - mean * mean, min=0.0)
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


class ConvTranspose(nn.Module):
    """flax ``nn.ConvTranspose(kernel_size=4, strides, padding="SAME")`` in 2
    or 3 spatial dims, channel-last in and out.

    The weight is torch's ``[in, out, k...]`` layout, which is the flax
    kernel ``[k..., in, out]`` permuted and flipped in every spatial axis
    (``utils.weights`` carries it so): lax's transposed convolution does not
    flip its kernel, torch's does.  Padding 1 gives SAME's ``n * stride``
    elements on a stride-2 axis exactly; on a stride-1 axis lax pads 2
    before and 1 after, torch 1 on each side, so torch's ``n + 1`` elements
    are cut to their first ``n``.  Input, weight and bias are cast to their
    common dtype, as flax promotes.
    """

    KERNEL = 4

    def __init__(self, in_channels: int, out_channels: int, strides: Sequence[int],
                 *, generator):
        super().__init__()
        self.strides = tuple(int(s) for s in strides)
        if set(self.strides) - {1, 2}:
            raise ValueError(f"ConvTranspose takes strides of 1 or 2 (got {self.strides})")
        k = (self.KERNEL,) * len(self.strides)
        self.weight = nn.Parameter(torch.empty((in_channels, out_channels) + k))
        self.bias = nn.Parameter(torch.zeros(out_channels))
        # flax's lecun_normal over the kernel [k..., in, out]: fan-in is the
        # input channels times the receptive field.
        lecun_normal_(self.weight.data, generator, fan_in=in_channels * math.prod(k))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dims = len(self.strides)
        dtype = torch.promote_types(x.dtype, self.weight.dtype)
        conv = F.conv_transpose2d if dims == 2 else F.conv_transpose3d
        out = conv(torch.movedim(x.to(dtype), -1, -dims - 1), self.weight.to(dtype),
                   self.bias.to(dtype), stride=self.strides, padding=1)
        for axis, (stride, n) in enumerate(zip(self.strides, x.shape[-dims - 1:-1])):
            if stride == 1:
                out = out.narrow(axis - dims, 0, n)
        return torch.movedim(out, -dims - 1, -1)


class Conv2DUpsample(nn.Module):
    """Upsample 4x: a stride-2 4x4 transposed conv to ``2 * n_outputs``
    channels, ReLU, a stride-2 4x4 transposed conv to ``n_outputs``
    (children ``transp_conv1``, ``transp_conv2``: the flax names).
    [B, H, W, C] -> [B, 4H, 4W, n_outputs]."""

    def __init__(self, in_channels: int, n_outputs: int, *, generator=None):
        super().__init__()
        g = default_generator(generator)
        self.transp_conv1 = ConvTranspose(in_channels, 2 * n_outputs, (2, 2), generator=g)
        self.transp_conv2 = ConvTranspose(2 * n_outputs, n_outputs, (2, 2), generator=g)

    def forward(self, inputs: torch.Tensor) -> torch.Tensor:
        return self.transp_conv2(F.relu(self.transp_conv1(inputs)))


class Conv3DUpsample(nn.Module):
    """``max(n_time_upsamples, n_space_upsamples)`` 4x4x4 transposed convs
    (children ``conv3d_transpose_{i}``, the flax names): layer i has strides
    (2 if i < n_time_upsamples else 1, then 2 if i < n_space_upsamples else
    1 on both spatial axes) and ``n_outputs * 2 ** (n - 1 - i)`` output
    channels, with a ReLU between layers.  [B, T, H, W, C] in and out."""

    def __init__(self, in_channels: int, n_outputs: int, n_time_upsamples: int = 2,
                 n_space_upsamples: int = 4, *, generator=None):
        super().__init__()
        g = default_generator(generator)
        self.n_upsamples = max(n_time_upsamples, n_space_upsamples)
        channels = in_channels
        for i in range(self.n_upsamples):
            t = 2 if i < n_time_upsamples else 1
            s = 2 if i < n_space_upsamples else 1
            out = n_outputs * 2 ** (self.n_upsamples - 1 - i)
            self.add_module(f"conv3d_transpose_{i}",
                            ConvTranspose(channels, out, (t, s, s), generator=g))
            channels = out

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n_upsamples):
            x = getattr(self, f"conv3d_transpose_{i}")(x)
            if i != self.n_upsamples - 1:
                x = F.relu(x)
        return x
