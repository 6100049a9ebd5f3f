"""Output postprocessors.

Counterpart of ``perceiverio_pytorch_tpu/io_processors/postprocessors.py``:
``EmbeddingPostprocessor`` (the language model's tied decode),
``FlowPostprocessor`` (flow), ``ClassificationPostprocessor``
(classification and the multimodal label) and the multimodal model's
``AudioPostprocessor`` and ``ProjectionPostprocessor``, with
``IdentityPostprocessor`` and ``ImagePostprocessor`` (its "conv" type
through ``Conv2DUpsample``/``Conv3DUpsample``; no shipped model decodes
through it).  Interface: ``forward(inputs, *, pos=None,
modality_sizes=None)``.
Their Dense layers and the tied product promote their input to fp32, as
the JAX package's plain ``nn.Dense`` and ``nn.Embed.attend`` do.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from perceiverio_pytorch_tpu_torch.core.attention import Dense
from perceiverio_pytorch_tpu_torch.io_processors.processor_utils import (
    Conv2d,
    Conv2DUpsample,
    Conv3DUpsample,
    reverse_space_to_depth,
)
from perceiverio_pytorch_tpu_torch.utils.initializers import default_generator, lecun_normal_


class EmbeddingPostprocessor(nn.Module):
    """Tied decode: ``inputs @ embedding.T + bias`` with the table of the
    ``EmbeddingPreprocessor`` (the same ``nn.Embedding`` module, so the
    model holds one parameter); the product runs in the promoted dtype of
    the inputs and the table (fp32 for bf16 inputs and an fp32 table)."""

    def __init__(self, embedding: nn.Embedding, vocab_size: int):
        super().__init__()
        self._embedding = embedding
        self.bias = nn.Parameter(torch.zeros(vocab_size))

    def forward(self, inputs, *, pos=None, modality_sizes=None):
        table = self._embedding.weight
        dtype = torch.promote_types(inputs.dtype, table.dtype)
        return F.linear(inputs.to(dtype), table.to(dtype)) + self.bias


class FlowPostprocessor(nn.Module):
    """Scale and reshape [B, N, 2] -> [B, 2, H, W]."""

    def __init__(self, img_size: Sequence[int], flow_scale_factor: float = 1.0):
        super().__init__()
        self.img_size = tuple(img_size)
        self.flow_scale_factor = flow_scale_factor

    def forward(self, inputs, *, pos=None, modality_sizes=None):
        batch_size = inputs.shape[0]
        flow = (inputs * self.flow_scale_factor).reshape(batch_size, *self.img_size, 2)
        return flow.permute(0, 3, 1, 2)


class AudioPostprocessor(nn.Module):
    """Linear to waveform patches, flattened: [B, N, C] -> [B, N * samples]."""

    def __init__(self, postproc_type: str = "patches", in_channels: int = 1024,
                 samples_per_patch: int = 96, *, generator=None):
        super().__init__()
        if postproc_type != "patches":
            raise ValueError("Invalid postproc_type!")
        self.linear = Dense(in_channels, samples_per_patch,
                            generator=default_generator(generator))

    def forward(self, inputs, *, pos=None, modality_sizes=None):
        return self.linear(inputs).reshape(inputs.shape[0], -1)


class IdentityPostprocessor(nn.Module):
    """Passes inputs through unchanged."""

    def forward(self, inputs, *, pos=None, modality_sizes=None):
        return inputs


class ClassificationPostprocessor(nn.Module):
    """Optional projection to class logits, then index 0: [B, N, C] -> [B, K]."""

    def __init__(self, num_input_channels: int, num_classes: int, project: bool = True,
                 *, generator=None):
        super().__init__()
        self.linear = (Dense(num_input_channels, num_classes,
                             generator=default_generator(generator)) if project else None)

    def forward(self, inputs, *, pos=None, modality_sizes=None):
        logits = inputs if self.linear is None else self.linear(inputs)
        return logits[:, 0, :]


class ProjectionPostprocessor(nn.Module):
    """Linear projection, e.g. 512 -> 3 RGB channels."""

    def __init__(self, num_inputs: int, num_outputs: int, *, generator=None):
        super().__init__()
        self.projection = Dense(num_inputs, num_outputs, generator=default_generator(generator))

    def forward(self, inputs, *, pos=None, modality_sizes=None):
        return self.projection(inputs)


class ImagePostprocessor(nn.Module):
    """Image postprocessing, channel-last: [B, N, C] (with
    ``input_reshape_size``) or an already spatial [B, (T,) H, W, C].

    ``postproc_type``:
      * "pixels": the input unchanged; refuses any upsampling;
      * "patches": ``reverse_space_to_depth`` by the temporal and spatial
        upsampling factors;
      * "conv": ``Conv2DUpsample`` (4x in space) when ``temporal_upsample``
        is 1, a 5-D input's frames folded into the batch; else
        ``Conv3DUpsample`` with log2 of both factors as its counts; child
        ``convnet``;
      * "conv1x1": a 1x1 conv with stride ``spatial_upsample`` (flax SAME:
        ``ceil(n / stride)`` positions), child ``conv1x1``; refuses
        temporal upsampling;
      * "raft": accepted, and its call raises ``NotImplementedError``: the
        JAX package builds no upsampler for it either (its call fails on the
        missing ``convnet``).

    ``input_channels`` is the channel count of the input, which the conv
    types' weights need (flax infers it at init).  "conv" and "conv1x1"
    need ``n_outputs``.
    """

    def __init__(self, img_size: Sequence[int], input_channels: int = 3,
                 postproc_type: str = "pixels", spatial_upsample: int = 1,
                 temporal_upsample: int = 1, n_outputs: int = -1,
                 input_reshape_size: Optional[Sequence[int]] = None, *, generator=None):
        super().__init__()
        if postproc_type not in ("conv", "patches", "pixels", "raft", "conv1x1"):
            raise ValueError("Invalid postproc_type!")
        self.img_size = tuple(img_size)
        self.postproc_type = postproc_type
        self.spatial_upsample = spatial_upsample
        self.temporal_upsample = temporal_upsample
        self.input_reshape_size = (None if input_reshape_size is None
                                   else tuple(input_reshape_size))
        g = default_generator(generator)
        if postproc_type == "pixels":
            if temporal_upsample != 1 or spatial_upsample != 1:
                raise ValueError("Pixels postprocessing should not currently upsample.")
        elif postproc_type == "conv1x1":
            if n_outputs == -1:
                raise ValueError("Expected value for n_outputs")
            if temporal_upsample != 1:
                raise ValueError("conv1x1 does not upsample in time.")
            self.conv1x1 = Conv2d(input_channels, n_outputs, kernel_size=1,
                                  stride=spatial_upsample)
            lecun_normal_(self.conv1x1.weight.data, g, fan_in=input_channels)
            nn.init.zeros_(self.conv1x1.bias)
        elif postproc_type == "conv":
            if n_outputs == -1:
                raise ValueError("Expected value for n_outputs")
            if temporal_upsample != 1:
                self.convnet = Conv3DUpsample(
                    input_channels, n_outputs,
                    n_time_upsamples=int(round(math.log2(temporal_upsample))),
                    n_space_upsamples=int(round(math.log2(spatial_upsample))),
                    generator=g)
            else:
                self.convnet = Conv2DUpsample(input_channels, n_outputs, generator=g)

    def forward(self, inputs, *, pos=None, modality_sizes=None):
        if self.input_reshape_size is not None:
            inputs = inputs.reshape((inputs.shape[0],) + self.input_reshape_size
                                    + (inputs.shape[-1],))
        if self.postproc_type == "raft":
            raise NotImplementedError(
                "ImagePostprocessor(postproc_type='raft') has no upsampler: the JAX"
                " package builds no convnet for it either (ROADMAP.md, queue 3)")
        if self.postproc_type == "conv":
            if inputs.dim() == 5 and self.temporal_upsample == 1:
                b, t = inputs.shape[:2]
                out = self.convnet(inputs.reshape((b * t,) + tuple(inputs.shape[2:])))
                return out.reshape((b, t) + tuple(out.shape[1:]))
            return self.convnet(inputs)
        if self.postproc_type == "conv1x1":
            lead = inputs.shape[:-3]
            flat = inputs.reshape((-1,) + tuple(inputs.shape[-3:]))
            out = torch.movedim(self.conv1x1(torch.movedim(flat, -1, 1)), 1, -1)
            return out.reshape(tuple(lead) + tuple(out.shape[1:]))
        if self.postproc_type == "patches":
            return reverse_space_to_depth(inputs, self.temporal_upsample,
                                          self.spatial_upsample)
        return inputs
