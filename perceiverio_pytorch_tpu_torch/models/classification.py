"""ImageNet classification Perceiver: the port's classification serving path.

Counterpart of ``perceiverio_pytorch_tpu/models/classification.py``: the
three preprocessing variants of the converted DeepMind checkpoints, 512
latents x 1024 channels, 8 weight-shared blocks of 6 self-attends (8
heads), a trainable 1,000-point query and a take-row-0 classification
postprocessor.  At 224x224 the encoder's cross-attend (one head, its qk
width that of the input) sees

  * ``FOURIER_POS_CONVNET``: a 7x7 conv, BatchNorm and max-pool stack
    (``Conv2DDownsample``) to 56x56 = 3,136 tokens of 64 + 258 Fourier
    channels: the dense path;
  * ``LEARNED_POS_1X1CONV``: a 1x1 conv to 256 channels and a learned
    position table projected to 256, 50,176 tokens of width 512: the flash
    kernel (K1) on a GPU;
  * ``FOURIER_POS_PIXEL``: the raw pixels and 258 Fourier channels, 50,176
    tokens of width 261: K1 on a GPU.

``single_query_decode`` (on by default, as in the JAX package) decodes only
query row 0, the one the postprocessor keeps: the same logits as the full
decode, the parameters unchanged.  The conv variant's BatchNorm follows
``module.training``: serve in eval mode (``model.eval()``), where it uses
the running averages as the JAX model does by default.

``device`` is "cuda" by default; with no GPU the model raises unless the
caller asks for ``device="cpu"``.  Weights are drawn from a
``torch.Generator`` (seed 0 when none is given).
"""

from __future__ import annotations

import enum
from typing import Sequence

import torch
from torch import nn

from perceiverio_pytorch_tpu_torch.config import DEFAULT, Policy
from perceiverio_pytorch_tpu_torch.core.perceiver import PerceiverIO
from perceiverio_pytorch_tpu_torch.core.position_encoding import PosEncodingType
from perceiverio_pytorch_tpu_torch.core.queries import TrainableQuery
from perceiverio_pytorch_tpu_torch.io_processors.postprocessors import (
    ClassificationPostprocessor,
)
from perceiverio_pytorch_tpu_torch.io_processors.preprocessors import ImagePreprocessor
from perceiverio_pytorch_tpu_torch.models.flow import resolve_device
from perceiverio_pytorch_tpu_torch.utils.initializers import default_generator


class PrepType(enum.Enum):
    FOURIER_POS_CONVNET = 1
    LEARNED_POS_1X1CONV = 2
    FOURIER_POS_PIXEL = 3


def _preprocessor(prep_type: PrepType, img_size, img_channels, generator):
    common = dict(img_size=tuple(img_size), input_channels=img_channels, generator=generator)
    if prep_type == PrepType.FOURIER_POS_CONVNET:
        return ImagePreprocessor(
            position_encoding_type=PosEncodingType.FOURIER,
            fourier_position_encoding_kwargs=dict(
                concat_pos=True, max_resolution=(56, 56), num_bands=64, sine_only=False),
            prep_type="conv", **common)
    if prep_type == PrepType.LEARNED_POS_1X1CONV:
        return ImagePreprocessor(
            position_encoding_type=PosEncodingType.TRAINABLE,
            trainable_position_encoding_kwargs=dict(init_scale=0.02, num_channels=256),
            prep_type="conv1x1", project_pos_dim=256, num_channels=256,
            spatial_downsample=1, concat_or_add_pos="concat", **common)
    if prep_type == PrepType.FOURIER_POS_PIXEL:
        return ImagePreprocessor(
            position_encoding_type=PosEncodingType.FOURIER,
            fourier_position_encoding_kwargs=dict(
                concat_pos=True, max_resolution=(224, 224), num_bands=64, sine_only=False),
            prep_type="pixels", spatial_downsample=1, **common)
    raise ValueError(f"Unknown prep_type type: {prep_type}")


class ClassificationPerceiver(nn.Module):
    """Perceiver for image classification."""

    def __init__(
        self,
        num_classes: int = 1000,
        img_size: Sequence[int] = (224, 224),
        img_channels: int = 3,
        prep_type: PrepType = PrepType.FOURIER_POS_CONVNET,
        num_self_attends_per_block: int = 6,
        num_blocks: int = 8,
        num_latents: int = 512,
        num_latent_channels: int = 1024,
        policy: Policy = DEFAULT,
        remat: bool = False,
        single_query_decode: bool = True,
        *,
        device="cuda",
        generator=None,
    ):
        super().__init__()
        device = resolve_device(device)
        g = default_generator(generator)
        self.prep_type = prep_type
        self.single_query_decode = single_query_decode
        preprocessor = _preprocessor(prep_type, img_size, img_channels, g)
        self.perceiver = PerceiverIO(
            num_blocks=num_blocks,
            num_self_attends_per_block=num_self_attends_per_block,
            num_latents=num_latents,
            num_latent_channels=num_latent_channels,
            input_preprocessors=preprocessor,
            perceiver_encoder_kwargs=dict(num_self_attend_heads=8, use_query_residual=True),
            output_queries=TrainableQuery(
                output_index_dims=num_classes, num_channels=1024, init_scale=0.02, generator=g),
            # The learned-position checkpoint was trained without a decoder
            # query residual.
            perceiver_decoder_kwargs=dict(
                use_query_residual=prep_type != PrepType.LEARNED_POS_1X1CONV),
            final_project_out_channels=num_classes,
            output_postprocessors=ClassificationPostprocessor(
                num_input_channels=num_classes, num_classes=num_classes, project=False),
            policy=policy,
            remat=remat,
            generator=g,
        )
        self.to(device)

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        """img: [B, C, H, W] channel-first; returns [B, num_classes] logits."""
        subsampled = None
        if self.single_query_decode:
            subsampled = {"__default": torch.arange(1, device=img.device)}
        return self.perceiver(img, subsampled_output_points=subsampled)
