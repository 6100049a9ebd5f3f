"""Decoder output queries.

Counterpart of ``perceiverio_pytorch_tpu/core/queries.py``.  ``BasicQuery``
builds the decoder query from a position encoding, optionally concatenated
with the preprocessed input; ``TrainableQuery``, ``FourierQuery`` and
``FlowQuery`` are factories configuring it.  ``subsampled_points``
(chunked decoding) maps flat indices to [-1, 1] coordinates for a Fourier
query and selects table rows for a trainable one, as in the JAX package.
"""

from __future__ import annotations

import math
from typing import Any, Mapping, Optional, Sequence, Union

import torch
from torch import nn

from perceiverio_pytorch_tpu_torch.core import position_encoding
from perceiverio_pytorch_tpu_torch.core.position_encoding import PosEncodingType


def _as_tuple(dims) -> tuple:
    if dims is None:
        return ()
    if isinstance(dims, int):
        return (dims,)
    return tuple(int(d) for d in dims)


class BasicQuery(nn.Module):
    """Query built from a positional encoding."""

    def __init__(
        self,
        output_index_dims: Union[int, Sequence[int], None] = None,
        concat_preprocessed_input: bool = False,
        preprocessed_input_channels: Optional[int] = None,
        position_encoding_type: PosEncodingType = PosEncodingType.TRAINABLE,
        project_pos_dim: int = -1,
        trainable_position_encoding_kwargs: Optional[Mapping[str, Any]] = None,
        fourier_position_encoding_kwargs: Optional[Mapping[str, Any]] = None,
        *,
        generator=None,
    ):
        super().__init__()
        self.output_index_dims = _as_tuple(output_index_dims)
        self.concat_preprocessed_input = concat_preprocessed_input
        self.preprocessed_input_channels = preprocessed_input_channels
        self.position_encoding_type = position_encoding_type
        if position_encoding_type in (PosEncodingType.NONE, None):
            if not concat_preprocessed_input:
                raise ValueError(
                    "concat_preprocessed_input must be True if"
                    " position_encoding_type is None"
                )
            self._position_encoding = None
        else:
            self._position_encoding = position_encoding.build_position_encoding(
                position_encoding_type,
                index_dims=self.output_index_dims,
                project_pos_dim=project_pos_dim,
                trainable_position_encoding_kwargs=trainable_position_encoding_kwargs,
                fourier_position_encoding_kwargs=fourier_position_encoding_kwargs,
                generator=generator,
            )
        if concat_preprocessed_input and preprocessed_input_channels is None:
            raise ValueError(
                "preprocessed_input_channels must be set if"
                " concat_preprocessed_input is True"
            )

    def n_query_channels(self) -> int:
        channels = 0
        if self._position_encoding is not None:
            channels = self._position_encoding.n_output_channels()
        if self.concat_preprocessed_input:
            channels += self.preprocessed_input_channels
        return channels

    def forward(self, inputs, inputs_without_pos=None, subsampled_points=None):
        batch_size = inputs.shape[0]
        pos_emb = None
        if self._position_encoding is not None:
            if (subsampled_points is not None
                    and self.position_encoding_type == PosEncodingType.TRAINABLE):
                table = self._position_encoding(batch_size)
                table = table.reshape(batch_size, -1, table.shape[-1])
                flat = torch.as_tensor(subsampled_points, device=table.device)
                pos_emb = table[:, flat % table.shape[1], :]
            elif subsampled_points is not None:
                dims = self.output_index_dims
                indices = torch.as_tensor(subsampled_points) % math.prod(dims)
                coords = torch.stack(torch.unravel_index(indices, dims), dim=-1)
                # -1 + 2*c/dim (divisor dim, not dim-1), as the reference.
                pos = -1.0 + 2.0 * coords.float() / torch.tensor(dims, dtype=torch.float32)
                pos = pos[None].expand(batch_size, -1, -1).to(inputs.device)
                pos_emb = self._position_encoding(batch_size, pos=pos)
                pos_emb = pos_emb.reshape(batch_size, -1, pos_emb.shape[-1])
            else:
                pos_emb = self._position_encoding(batch_size)

        if self.concat_preprocessed_input:
            if inputs_without_pos is None:
                raise ValueError(
                    "Value is required for inputs_without_pos if"
                    " concat_preprocessed_input is True"
                )
            if pos_emb is None:
                # NONE encoding: the query is the preprocessed input itself
                # (position features included).
                pos_emb = inputs
            else:
                pos_emb = torch.cat([inputs_without_pos, pos_emb], dim=-1)
        return pos_emb


def TrainableQuery(output_index_dims=None, concat_preprocessed_input: bool = False,
                   preprocessed_input_channels: Optional[int] = None,
                   num_channels: int = 128, init_scale: float = 0.02,
                   *, generator=None) -> BasicQuery:
    """Query with a trainable positional encoding."""
    return BasicQuery(
        output_index_dims=output_index_dims,
        concat_preprocessed_input=concat_preprocessed_input,
        preprocessed_input_channels=preprocessed_input_channels,
        position_encoding_type=PosEncodingType.TRAINABLE,
        trainable_position_encoding_kwargs=dict(
            num_channels=num_channels, init_scale=init_scale),
        generator=generator,
    )


def FourierQuery(output_index_dims=None, concat_preprocessed_input: bool = False,
                 preprocessed_input_channels: Optional[int] = None,
                 num_bands: int = 64, concat_pos: bool = True,
                 max_resolution: Optional[Sequence[int]] = None,
                 sine_only: bool = False) -> BasicQuery:
    """Query with a Fourier positional encoding."""
    return BasicQuery(
        output_index_dims=output_index_dims,
        concat_preprocessed_input=concat_preprocessed_input,
        preprocessed_input_channels=preprocessed_input_channels,
        position_encoding_type=PosEncodingType.FOURIER,
        fourier_position_encoding_kwargs=dict(
            num_bands=num_bands, max_resolution=max_resolution,
            sine_only=sine_only, concat_pos=concat_pos),
    )


def FlowQuery(preprocessed_input_channels: int, output_img_size: Sequence[int],
              output_num_channels: int = 2) -> BasicQuery:
    """Encoding-free query: the preprocessed input itself."""
    return BasicQuery(
        output_index_dims=tuple(output_img_size) + (output_num_channels,),
        concat_preprocessed_input=True,
        preprocessed_input_channels=preprocessed_input_channels,
        position_encoding_type=PosEncodingType.NONE,
    )
