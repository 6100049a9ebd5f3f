"""Position encodings: Fourier features, trainable embeddings, projector.

Counterpart of ``perceiverio_pytorch_tpu/core/position_encoding.py``:
  * ``generate_fourier_features``: linear bands from 1 to res/2 per
    dimension, sin+cos (or sine only), raw positions first.  Channel order
    (concat_pos, not sine_only):
        [dim_1..dim_d,
         sin(pi f_1 dim_1)..sin(pi f_K dim_1), .., sin(pi f_K dim_d),
         cos(pi f_1 dim_1)..               .., cos(pi f_K dim_d)]
    computed in fp32, dimension-major and band-minor.
  * ``build_linear_positions``: N-D grid of linspace(-1, 1).
  * ``TrainablePositionEncoding``: learned [index_dim, C] table.
  * ``FourierPositionEncoding``: the table for the implicit linear
    positions is a non-persistent buffer (the JAX package's "consts"),
    built on the CPU at its first use and moved with the module; an
    encoding that is only ever given explicit positions (the multimodal
    image query, 802,816 x 195 in fp32: 626 MB) never builds it.
  * ``PositionEncodingProjector`` and ``build_position_encoding``.
"""

from __future__ import annotations

import enum
import math
from typing import Optional, Sequence

import torch
from torch import nn

from perceiverio_pytorch_tpu_torch.core.attention import Dense
from perceiverio_pytorch_tpu_torch.utils.initializers import (
    default_generator,
    lecun_normal_,
    trunc_normal_,
)


class PosEncodingType(enum.Enum):
    FOURIER = 1
    TRAINABLE = 2
    NONE = 3


def _linspace(start: float, stop: float, num: int) -> torch.Tensor:
    """fp32 linspace with the same rounding as ``jnp.linspace``:
    start * (1 - i/div) + stop * (i/div), then the exact end point."""
    if num == 1:
        return torch.tensor([start], dtype=torch.float32)
    div = num - 1
    step = torch.arange(div, dtype=torch.float32) / float(div)
    out = start * (1 - step) + stop * step
    return torch.cat([out, torch.tensor([stop], dtype=torch.float32)])


def generate_fourier_features(
    pos: torch.Tensor,
    num_bands: int,
    max_resolution: Sequence[int] = (224, 224),
    concat_pos: bool = True,
    sine_only: bool = False,
) -> torch.Tensor:
    """[n, d] positions -> [n, C] Fourier features,
    C = (1 if sine_only else 2) * K * d (+ d if concat_pos)."""
    freq_bands = torch.stack(
        [_linspace(1.0, res / 2.0, num_bands) for res in max_resolution]
    ).to(pos.device)  # [d, K]
    per_pos = (pos[:, :, None] * freq_bands[None, :, :]).reshape(pos.shape[0], -1)
    if sine_only:
        per_pos = torch.sin(math.pi * per_pos)
    else:
        per_pos = torch.cat(
            [torch.sin(math.pi * per_pos), torch.cos(math.pi * per_pos)], dim=-1
        )
    if concat_pos:
        per_pos = torch.cat([pos, per_pos], dim=-1)
    return per_pos


def build_linear_positions(index_dims: Sequence[int], output_range=(-1.0, 1.0)):
    """[*index_dims, N] grid of positions, each dim linspace over output_range."""
    ranges = [_linspace(output_range[0], output_range[1], n) for n in index_dims]
    grid = torch.meshgrid(*ranges, indexing="ij")
    return torch.stack(grid, dim=-1)


class TrainablePositionEncoding(nn.Module):
    """Learned [index_dim, num_channels] position table, broadcast to batch."""

    def __init__(self, index_dim: int, num_channels: int = 128,
                 init_scale: float = 0.02, *, generator=None):
        super().__init__()
        self.num_channels = num_channels
        self.pos_embs = nn.Parameter(torch.empty(index_dim, num_channels))
        trunc_normal_(self.pos_embs.data, init_scale, default_generator(generator))

    def forward(self, batch_size: int, pos=None) -> torch.Tensor:
        del pos  # part of the shared position-encoding interface
        return self.pos_embs[None].expand(batch_size, -1, -1)

    def n_output_channels(self) -> int:
        return self.num_channels


class FourierPositionEncoding(nn.Module):
    """Fourier encoding over ``index_dims``; positions are batch-constant."""

    def __init__(self, index_dims: Sequence[int], num_bands: int,
                 concat_pos: bool = True,
                 max_resolution: Optional[Sequence[int]] = None,
                 sine_only: bool = False):
        super().__init__()
        self.index_dims = tuple(index_dims)
        self.num_bands = num_bands
        self.concat_pos = concat_pos
        self.max_resolution = tuple(max_resolution or self.index_dims)
        self.sine_only = sine_only
        # Where the module lives (it has no parameters), and the table.
        self.register_buffer("_device", torch.empty(0), persistent=False)
        self.register_buffer("fourier_table", None, persistent=False)

    def _table(self) -> torch.Tensor:
        """The table of the implicit linear positions, built on the CPU at
        first use (the same arithmetic whatever the device) outside any
        inference mode, so that a later backward may save it."""
        if self.fourier_table is None:
            with torch.inference_mode(False), torch.no_grad():
                pos = build_linear_positions(self.index_dims).reshape(-1, len(self.index_dims))
                self.fourier_table = self._features(pos).to(self._device.device)
        return self.fourier_table

    def _features(self, pos: torch.Tensor) -> torch.Tensor:
        return generate_fourier_features(
            pos, num_bands=self.num_bands, max_resolution=self.max_resolution,
            concat_pos=self.concat_pos, sine_only=self.sine_only,
        )

    def forward(self, batch_size: int, pos=None) -> torch.Tensor:
        if pos is None:
            features = self._table()
        else:
            if pos.shape[-1] != len(self.index_dims):
                raise ValueError(
                    f"pos has {pos.shape[-1]} dims, expected {len(self.index_dims)}"
                )
            features = self._features(pos[0].float())
        return features[None].expand(batch_size, -1, -1)

    def n_output_channels(self) -> int:
        num = self.num_bands if self.sine_only else self.num_bands * 2
        num *= len(self.max_resolution)
        if self.concat_pos:
            num += len(self.max_resolution)
        return num


class PositionEncodingProjector(nn.Module):
    """Linear projection of a base position encoding to a target width."""

    def __init__(self, output_size: int, base_position_encoding: nn.Module,
                 *, generator=None):
        super().__init__()
        self.output_size = output_size
        self._base_position_encoding = base_position_encoding
        self._projector = Dense(
            base_position_encoding.n_output_channels(), output_size,
            init=lecun_normal_, generator=generator,
        )

    def forward(self, batch_size: int, pos=None) -> torch.Tensor:
        return self._projector(self._base_position_encoding(batch_size, pos))

    def n_output_channels(self) -> int:
        return self.output_size


def build_position_encoding(
    position_encoding_type: PosEncodingType,
    index_dims: Sequence[int],
    project_pos_dim: int = -1,
    trainable_position_encoding_kwargs=None,
    fourier_position_encoding_kwargs=None,
    *,
    generator=None,
):
    """Factory with the reference's knob surface."""
    generator = default_generator(generator)
    if position_encoding_type == PosEncodingType.TRAINABLE:
        if trainable_position_encoding_kwargs is None:
            raise ValueError("trainable_position_encoding_kwargs is required")
        enc = TrainablePositionEncoding(
            index_dim=math.prod(index_dims), generator=generator,
            **trainable_position_encoding_kwargs,
        )
    elif position_encoding_type == PosEncodingType.FOURIER:
        if fourier_position_encoding_kwargs is None:
            raise ValueError("fourier_position_encoding_kwargs is required")
        enc = FourierPositionEncoding(
            index_dims=tuple(index_dims), **fourier_position_encoding_kwargs
        )
    else:
        raise ValueError(f"Unknown position encoding: {position_encoding_type}.")
    if project_pos_dim > 0:
        enc = PositionEncodingProjector(project_pos_dim, enc, generator=generator)
    return enc
