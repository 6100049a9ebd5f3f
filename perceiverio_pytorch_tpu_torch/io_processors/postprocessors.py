"""Output postprocessors (flow slice: ``FlowPostprocessor``).

Counterpart of ``perceiverio_pytorch_tpu/io_processors/postprocessors.py``.
Interface: ``forward(inputs, *, pos=None, modality_sizes=None)``.
"""

from __future__ import annotations

from typing import Sequence

from torch import nn


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
