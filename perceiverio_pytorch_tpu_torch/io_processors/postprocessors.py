"""Output postprocessors.

Counterpart of ``perceiverio_pytorch_tpu/io_processors/postprocessors.py``:
``FlowPostprocessor`` (flow) and the multimodal model's
``AudioPostprocessor``, ``ClassificationPostprocessor`` and
``ProjectionPostprocessor``, with ``IdentityPostprocessor``.  The image
postprocessor's conv path (``Conv2D/3DUpsample``) comes with the
classification slice.  Interface: ``forward(inputs, *, pos=None,
modality_sizes=None)``.  Their Dense layers promote their input to fp32,
as the JAX package's plain ``nn.Dense`` does.
"""

from __future__ import annotations

from typing import Sequence

from torch import nn

from perceiverio_pytorch_tpu_torch.core.attention import Dense
from perceiverio_pytorch_tpu_torch.utils.initializers import default_generator


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
