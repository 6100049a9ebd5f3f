"""Input preprocessors.

Counterpart of ``perceiverio_pytorch_tpu/io_processors/preprocessors.py``:
``ImagePreprocessor`` with ``prep_type="patches"`` (optionally followed by
a Dense, ``conv_after_patching``) and ``"pixels"``; ``OneHotPreprocessor``
and ``AudioPreprocessor`` (``"patches"``) for the multimodal model.  The
``"conv"`` and ``"conv1x1"`` types and the extra position MLP
(``n_extra_pos_mlp > 0``) come with the classification slice and raise
until then.

Interface: ``forward(inputs, *, pos=None) -> (inputs_with_pos,
inputs_without_pos)`` and ``n_output_channels()``.  Images arrive
channel-first ([B, C, H, W] or [B, T, C, H, W]), as in the reference, and
are made channel-last inside.
"""

from __future__ import annotations

import math
from typing import Any, Mapping, Optional, Sequence

import torch
from torch import nn

from perceiverio_pytorch_tpu_torch.core import position_encoding
from perceiverio_pytorch_tpu_torch.core.attention import Dense
from perceiverio_pytorch_tpu_torch.core.position_encoding import PosEncodingType
from perceiverio_pytorch_tpu_torch.io_processors.processor_utils import space_to_depth
from perceiverio_pytorch_tpu_torch.utils.initializers import default_generator


class ImagePreprocessor(nn.Module):
    """Image featurization by patches or pixels."""

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
        concat_or_add_pos: str = "concat",
        project_pos_dim: int = -1,
        trainable_position_encoding_kwargs: Optional[Mapping[str, Any]] = None,
        fourier_position_encoding_kwargs: Optional[Mapping[str, Any]] = None,
        *,
        generator=None,
    ):
        super().__init__()
        if prep_type in ("conv", "conv1x1"):
            raise NotImplementedError(
                f"prep_type={prep_type!r} is not ported yet (classification slice)"
            )
        if prep_type not in ("patches", "pixels"):
            raise ValueError("Invalid prep_type!")
        if concat_or_add_pos not in ("concat", "add"):
            raise ValueError(f"Invalid value {concat_or_add_pos} for concat_or_add_pos.")
        if n_extra_pos_mlp > 0:
            raise NotImplementedError(
                "n_extra_pos_mlp > 0 is not ported yet (classification slice)"
            )
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

        self._positional_encoding = position_encoding.build_position_encoding(
            position_encoding_type=position_encoding_type,
            index_dims=self._index_dims(),
            project_pos_dim=project_pos_dim,
            trainable_position_encoding_kwargs=trainable_position_encoding_kwargs,
            fourier_position_encoding_kwargs=fourier_position_encoding_kwargs,
            generator=g,
        )
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
        elif self.conv_after_patching:
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
        pos_enc = self._positional_encoding(batch_size, pos=pos).to(inputs.dtype)
        if self.concat_or_add_pos == "concat":
            with_pos = torch.cat([inputs, pos_enc], dim=-1)
        else:
            with_pos = inputs + pos_enc
        return with_pos, inputs

    def forward(self, inputs, *, pos=None):
        """inputs: channel-first [B, C, H, W] or [B, T, C, H, W]."""
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
        if n_extra_pos_mlp > 0:
            raise NotImplementedError(
                "n_extra_pos_mlp > 0 is not ported yet (classification slice)"
            )
        self.samples_per_patch = samples_per_patch
        self.concat_or_add_pos = concat_or_add_pos
        self._positional_encoding = position_encoding.build_position_encoding(
            position_encoding_type=position_encoding_type,
            index_dims=[samples_per_batch // samples_per_patch],
            project_pos_dim=project_pos_dim,
            trainable_position_encoding_kwargs=trainable_position_encoding_kwargs,
            fourier_position_encoding_kwargs=fourier_position_encoding_kwargs,
            generator=default_generator(generator),
        )

    def n_output_channels(self) -> int:
        out = self.samples_per_patch
        if self.concat_or_add_pos == "concat":
            out += self._positional_encoding.n_output_channels()
        return out

    def forward(self, inputs, *, pos=None):
        """inputs: [B, samples, ...] waveform."""
        inputs = inputs.reshape(inputs.shape[0], -1, self.samples_per_patch)
        pos_enc = self._positional_encoding(inputs.shape[0], pos=pos).to(inputs.dtype)
        if self.concat_or_add_pos == "concat":
            with_pos = torch.cat([inputs, pos_enc], dim=-1)
        else:
            with_pos = inputs + pos_enc
        return with_pos, inputs
