"""Output postprocessors.

Counterpart of ``perceiverio_pytorch_tpu/io_processors/postprocessors.py``:
``EmbeddingPostprocessor`` (the language model's tied decode),
``FlowPostprocessor`` (flow), ``ClassificationPostprocessor``
(classification and the multimodal label) and the multimodal model's
``AudioPostprocessor`` and ``ProjectionPostprocessor``, with
``IdentityPostprocessor``.  ``ImagePostprocessor`` and its
``Conv2D/3DUpsample`` are not ported yet: no shipped model decodes through
them.  Interface: ``forward(inputs, *, pos=None, modality_sizes=None)``.
Their Dense layers and the tied product promote their input to fp32, as
the JAX package's plain ``nn.Dense`` and ``nn.Embed.attend`` do.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from perceiverio_pytorch_tpu_torch.core.attention import Dense
from perceiverio_pytorch_tpu_torch.utils.initializers import default_generator


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
