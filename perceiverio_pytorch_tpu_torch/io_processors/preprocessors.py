"""Input preprocessors.

Counterpart of ``perceiverio_pytorch_tpu/io_processors/preprocessors.py``:
``EmbeddingPreprocessor`` (token embedding, optionally shared with an
``EmbeddingPostprocessor``, plus a trainable position encoding);
``ImagePreprocessor`` with ``prep_type`` ``"conv"`` (``Conv2DDownsample``),
``"conv1x1"`` (a strided 1x1 conv), ``"patches"`` (optionally followed by a
Dense, ``conv_after_patching``) and ``"pixels"``; ``OneHotPreprocessor``
and ``AudioPreprocessor`` (``"patches"``).  ``n_extra_pos_mlp > 0`` runs
the position encoding through a residual stack of Dense layers
(``_ExtraPosMLP``, the JAX package's intended semantics of the reference's
broken path).

Interface: ``forward(inputs, *, pos=None) -> (inputs_with_pos,
inputs_without_pos)`` and ``n_output_channels()``.  Images arrive
channel-first ([B, C, H, W] or [B, T, C, H, W]), as in the reference; the
convs run channel-first and the tokens are made channel-last after them.
The conv type's BatchNorm follows ``module.training`` where the JAX
package passes ``train``: in eval mode it uses the running averages.
"""

from __future__ import annotations

import math
from typing import Any, Mapping, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from perceiverio_pytorch_tpu_torch.core import position_encoding
from perceiverio_pytorch_tpu_torch.core.attention import Dense
from perceiverio_pytorch_tpu_torch.core.position_encoding import PosEncodingType
from perceiverio_pytorch_tpu_torch.io_processors.processor_utils import (
    Conv2d,
    Conv2DDownsample,
    space_to_depth,
)
from perceiverio_pytorch_tpu_torch.utils.initializers import default_generator, trunc_normal_


def make_embedding(vocab_size: int, embedding_dims: int, *, generator=None) -> nn.Embedding:
    """A token table drawn as flax's ``nn.Embed`` draws it: a normal of std
    1/sqrt(embedding_dims)."""
    embed = nn.Embedding(vocab_size, embedding_dims)
    with torch.no_grad():
        embed.weight.normal_(0.0, embedding_dims ** -0.5,
                             generator=default_generator(generator))
    return embed


class EmbeddingPreprocessor(nn.Module):
    """Token embedding plus a trainable position encoding.

    ``embed`` may be passed in to share the table with an
    ``EmbeddingPostprocessor`` (the language model's tied weights); the
    lookup stays in the table's dtype (fp32) until the encoder casts.
    """

    def __init__(self, vocab_size: int, max_seq_len: int, embedding_dims: int,
                 embed: Optional[nn.Embedding] = None, *, generator=None):
        super().__init__()
        g = default_generator(generator)
        self.embedding_dims = embedding_dims
        self.input_pos_encoding = position_encoding.TrainablePositionEncoding(
            index_dim=max_seq_len, num_channels=embedding_dims, generator=g)
        self.embed = embed if embed is not None else make_embedding(
            vocab_size, embedding_dims, generator=g)

    def n_output_channels(self) -> int:
        return self.embedding_dims

    def forward(self, inputs, *, pos=None):
        """inputs: [B, max_seq_len] integer token ids."""
        embedded = self.embed(inputs)
        return embedded + self.input_pos_encoding(inputs.shape[0]), embedded


class _ExtraPosMLP(nn.ModuleList):
    """Residual Dense stack over a position encoding: pos + Dense_i(pos),
    with a ReLU between layers; children "0".."N-1" (none: the identity)."""

    def __init__(self, n_layers: int, channels: int, *, generator=None):
        g = default_generator(generator)
        super().__init__(Dense(channels, channels, generator=g) for _ in range(n_layers))

    def forward(self, pos_enc):
        for i, layer in enumerate(self):
            pos_enc = pos_enc + layer(pos_enc)
            if i < len(self) - 1:
                pos_enc = F.relu(pos_enc)
        return pos_enc


class ImagePreprocessor(nn.Module):
    """Image featurization by a conv stack, a 1x1 conv, patches or pixels."""

    def __init__(
        self,
        img_size: Sequence[int],
        num_frames: int = 1,
        input_channels: int = 3,
        prep_type: str = "conv",
        spatial_downsample: int = 4,
        temporal_downsample: int = 1,
        position_encoding_type: PosEncodingType = PosEncodingType.FOURIER,
        n_extra_pos_mlp: int = 0,
        num_channels: int = 64,
        conv_after_patching: bool = False,
        conv2d_use_batchnorm: bool = True,
        concat_or_add_pos: str = "concat",
        project_pos_dim: int = -1,
        trainable_position_encoding_kwargs: Optional[Mapping[str, Any]] = None,
        fourier_position_encoding_kwargs: Optional[Mapping[str, Any]] = None,
        *,
        generator=None,
    ):
        super().__init__()
        if prep_type not in ("conv", "patches", "pixels", "conv1x1"):
            raise ValueError("Invalid prep_type!")
        if concat_or_add_pos not in ("concat", "add"):
            raise ValueError(f"Invalid value {concat_or_add_pos} for concat_or_add_pos.")
        g = default_generator(generator)
        self.img_size = tuple(img_size)
        self.num_frames = num_frames
        self.input_channels = input_channels
        self.prep_type = prep_type
        self.spatial_downsample = spatial_downsample
        self.temporal_downsample = temporal_downsample
        self.num_channels = num_channels
        self.conv_after_patching = conv_after_patching
        self.concat_or_add_pos = concat_or_add_pos

        if prep_type == "conv":
            num_layers = math.log(spatial_downsample, 4)
            if num_layers != round(num_layers) or temporal_downsample != 1:
                raise ValueError(
                    "Only powers of 4 expected for spatial and 1 expected for"
                    " temporal downsampling with conv."
                )
            self.convnet = Conv2DDownsample(
                num_layers=int(num_layers), in_channels=input_channels,
                num_channels=num_channels, use_batchnorm=conv2d_use_batchnorm, generator=g,
            )
        elif prep_type == "conv1x1":
            if temporal_downsample != 1:
                raise ValueError("conv1x1 does not downsample in time.")
            self.convnet_1x1 = Conv2d(input_channels, num_channels, kernel_size=1,
                                      stride=spatial_downsample)
            trunc_normal_(self.convnet_1x1.weight.data, 0.01, g)
            with torch.no_grad():
                self.convnet_1x1.bias.zero_()

        self._positional_encoding = position_encoding.build_position_encoding(
            position_encoding_type=position_encoding_type,
            index_dims=self._index_dims(),
            project_pos_dim=project_pos_dim,
            trainable_position_encoding_kwargs=trainable_position_encoding_kwargs,
            fourier_position_encoding_kwargs=fourier_position_encoding_kwargs,
            generator=g,
        )
        self._extra_pos_mlps = _ExtraPosMLP(
            n_extra_pos_mlp, self._positional_encoding.n_output_channels(), generator=g)
        if conv_after_patching:
            self._conv_after_patch_layer = Dense(
                input_channels * spatial_downsample**2 * temporal_downsample,
                num_channels, generator=g,
            )

    def _index_dims(self):
        dims = [-(-d // self.spatial_downsample) for d in self.img_size]
        if self.num_frames > 1:
            dims = [-(-self.num_frames // self.temporal_downsample)] + dims
        return dims

    def n_output_channels(self) -> int:
        if self.prep_type == "pixels":
            out = self.input_channels
        elif self.prep_type != "patches" or self.conv_after_patching:
            out = self.num_channels
        else:
            out = (self.input_channels * self.spatial_downsample**2
                   * self.temporal_downsample)
        if self.concat_or_add_pos == "concat":
            out += self._positional_encoding.n_output_channels()
        return out

    def _build_network_inputs(self, inputs, pos):
        """Flatten index dims to one axis and attach the position encoding."""
        batch_size = inputs.shape[0]
        if inputs.dim() > 3:
            inputs = inputs.reshape(batch_size, math.prod(self._index_dims()), -1)
        pos_enc = self._positional_encoding(batch_size, pos=pos)
        pos_enc = self._extra_pos_mlps(pos_enc).to(inputs.dtype)
        if self.concat_or_add_pos == "concat":
            with_pos = torch.cat([inputs, pos_enc], dim=-1)
        else:
            with_pos = inputs + pos_enc
        return with_pos, inputs

    def forward(self, inputs, *, pos=None):
        """inputs: channel-first [B, C, H, W] or [B, T, C, H, W]."""
        if self.prep_type in ("conv", "conv1x1"):
            shape = inputs.shape
            if inputs.dim() == 5:  # fold time into the batch for the 2-D convs
                inputs = inputs.reshape((-1,) + tuple(shape[2:]))
            net = self.convnet if self.prep_type == "conv" else self.convnet_1x1
            inputs = torch.movedim(net(inputs), 1, -1)
            if len(shape) == 5:
                inputs = inputs.reshape(tuple(shape[:2]) + tuple(inputs.shape[1:]))
            return self._build_network_inputs(inputs, pos)
        inputs = torch.movedim(inputs, -3, -1)
        if self.prep_type == "patches":
            inputs = space_to_depth(
                inputs,
                temporal_block_size=self.temporal_downsample,
                spatial_block_size=self.spatial_downsample,
            )
            if inputs.dim() == 5 and inputs.shape[1] == 1:
                # Optical flow: both frames folded into channels.
                inputs = inputs.squeeze(1)
            if self.conv_after_patching:
                inputs = self._conv_after_patch_layer(inputs)
        else:  # pixels
            s, t = self.spatial_downsample, self.temporal_downsample
            if inputs.dim() == 4:
                inputs = inputs[:, ::s, ::s]
            elif inputs.dim() == 5:
                inputs = inputs[:, ::t, ::s, ::s]
            else:
                raise ValueError("Unsupported data format for pixels.")
        return self._build_network_inputs(inputs, pos)


class OneHotPreprocessor(nn.Module):
    """Adds a dummy index dim: [B, C] -> [B, 1, C]."""

    def __init__(self, input_channels: int):
        super().__init__()
        self.input_channels = input_channels

    def n_output_channels(self) -> int:
        return self.input_channels

    def forward(self, inputs, *, pos=None):
        inputs = inputs[:, None, :]
        return inputs, inputs


class AudioPreprocessor(nn.Module):
    """Waveform -> patch tokens of ``samples_per_patch`` samples, with the
    position encoding concatenated (or added)."""

    def __init__(
        self,
        samples_per_batch: int,
        prep_type: str = "patches",
        samples_per_patch: int = 96,
        position_encoding_type: PosEncodingType = PosEncodingType.FOURIER,
        n_extra_pos_mlp: int = 0,
        concat_or_add_pos: str = "concat",
        project_pos_dim: int = -1,
        trainable_position_encoding_kwargs: Optional[Mapping[str, Any]] = None,
        fourier_position_encoding_kwargs: Optional[Mapping[str, Any]] = None,
        *,
        generator=None,
    ):
        super().__init__()
        if prep_type != "patches":
            raise ValueError("Invalid prep_type!")
        if concat_or_add_pos not in ("concat", "add"):
            raise ValueError(f"Invalid value {concat_or_add_pos} for concat_or_add_pos.")
        g = default_generator(generator)
        self.samples_per_patch = samples_per_patch
        self.concat_or_add_pos = concat_or_add_pos
        self._positional_encoding = position_encoding.build_position_encoding(
            position_encoding_type=position_encoding_type,
            index_dims=[samples_per_batch // samples_per_patch],
            project_pos_dim=project_pos_dim,
            trainable_position_encoding_kwargs=trainable_position_encoding_kwargs,
            fourier_position_encoding_kwargs=fourier_position_encoding_kwargs,
            generator=g,
        )
        self._extra_pos_mlps = _ExtraPosMLP(
            n_extra_pos_mlp, self._positional_encoding.n_output_channels(), generator=g)

    def n_output_channels(self) -> int:
        out = self.samples_per_patch
        if self.concat_or_add_pos == "concat":
            out += self._positional_encoding.n_output_channels()
        return out

    def forward(self, inputs, *, pos=None):
        """inputs: [B, samples, ...] waveform."""
        inputs = inputs.reshape(inputs.shape[0], -1, self.samples_per_patch)
        pos_enc = self._positional_encoding(inputs.shape[0], pos=pos)
        pos_enc = self._extra_pos_mlps(pos_enc).to(inputs.dtype)
        if self.concat_or_add_pos == "concat":
            with_pos = torch.cat([inputs, pos_enc], dim=-1)
        else:
            with_pos = inputs + pos_enc
        return with_pos, inputs
