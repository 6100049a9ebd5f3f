"""Multimodal (video + audio + label) autoencoding Perceiver: the port's
Kinetics serving and training path.

Counterpart of ``perceiverio_pytorch_tpu/models/multimodal.py``.  At the
published width (16 frames of 224x224x3 in 4x4 patches, 30,720 audio
samples in patches of 16, 700 classes, 784 latents x 512 channels, 8
self-attends of 8 heads) the input is 52,097 tokens padded to 704 channels,
and the output is 805k queries (16 x 224 x 224 image + 1,920 audio + 1
label), decoded in ``n_chunks`` chunks.

The input is encoded once, then the chunks are decoded one after another
in a Python loop over ``PerceiverIO.decode`` with the same subsampling
indices as the JAX package, and stitched back: image [B, T, C, H, W], audio
[B, samples, 1], label averaged over the chunks.  On a GPU the encoder's
cross-attend (one head of width 704 over 52,097 keys) takes the flash
kernels (K1, and K2 and K3 in the backward); the self-attends (784 tokens)
and the decoder chunks (6,288 queries against 784 latents, or 50,297 at the
training example's 16 chunks) take the dense path.

With ``remat`` (training at the published width), the encoder's
self-attend stack and each chunk's decode are rematerialised in the backward
(``torch.utils.checkpoint``), as the JAX model's ``nn.remat`` does; the
encoder's cross-attend stays outside every checkpoint, so its flash kernel
runs once a step.  ``Policy.remat_policy`` says what both regions keep for
the backward (``config.remat_call``): the full-scale training example sets
``"dots_saveable"``, as the JAX one does, which keeps the matrix products'
outputs and recomputes the rest.

Under ``Policy(quant="int8_static")`` every chunk's decode runs the same
shared decoder, so ``ops.quant.calibrate`` folds each projection's ``amax``
over the chunks (the JAX model unrolls its chunk scan for that pass) and
static inference reads it, whatever the chunk count.

Left out, raising: ``chunk_mesh`` (chunk-parallel decoding across cards).

``device`` is "cuda" by default; with no GPU the model raises unless the
caller asks for ``device="cpu"``.  Weights are drawn from a
``torch.Generator`` (seed 0 when none is given).
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from perceiverio_pytorch_tpu_torch.config import DEFAULT, Policy, remat_call
from perceiverio_pytorch_tpu_torch.core.perceiver import PerceiverIO
from perceiverio_pytorch_tpu_torch.core.position_encoding import PosEncodingType
from perceiverio_pytorch_tpu_torch.core.queries import FourierQuery, TrainableQuery
from perceiverio_pytorch_tpu_torch.io_processors.postprocessors import (
    AudioPostprocessor,
    ClassificationPostprocessor,
    ProjectionPostprocessor,
)
from perceiverio_pytorch_tpu_torch.io_processors.preprocessors import (
    AudioPreprocessor,
    ImagePreprocessor,
    OneHotPreprocessor,
)
from perceiverio_pytorch_tpu_torch.models.flow import resolve_device
from perceiverio_pytorch_tpu_torch.utils.initializers import default_generator


class MultiModalPerceiver(nn.Module):
    """Perceiver auto-encoding video, audio and a class label."""

    def __init__(
        self,
        img_size: Sequence[int] = (224, 224),
        img_channels: int = 3,
        num_frames: int = 16,
        num_classes: int = 700,
        audio_samples_per_frame: int = 48000 // 25,
        audio_samples_per_patch: int = 16,
        num_self_attends_per_block: int = 8,
        num_blocks: int = 1,
        num_latents: int = 28 * 28 * 1,
        num_latent_channels: int = 512,
        policy: Policy = DEFAULT,
        remat: bool = False,
        *,
        device="cuda",
        generator=None,
    ):
        super().__init__()
        device = resolve_device(device)
        g = default_generator(generator)
        h, w = img_size
        n_audio_samples = num_frames * audio_samples_per_frame
        self.img_size = (h, w)
        self.num_frames = num_frames
        self.num_classes = num_classes
        self.audio_samples_per_frame = audio_samples_per_frame
        self.audio_samples_per_patch = audio_samples_per_patch
        self.remat = remat
        input_preprocessors = {
            "audio": AudioPreprocessor(
                samples_per_batch=n_audio_samples,
                position_encoding_type=PosEncodingType.FOURIER,
                fourier_position_encoding_kwargs=dict(
                    num_bands=192, max_resolution=(n_audio_samples,),
                    sine_only=False, concat_pos=True,
                ),
                n_extra_pos_mlp=0,
                prep_type="patches",
                samples_per_patch=audio_samples_per_patch,
                generator=g,
            ),
            "image": ImagePreprocessor(
                img_size=(h, w),
                input_channels=img_channels,
                num_frames=num_frames,
                position_encoding_type=PosEncodingType.FOURIER,
                fourier_position_encoding_kwargs=dict(
                    num_bands=32, max_resolution=(num_frames, h // 4, w // 4),
                    sine_only=False, concat_pos=True,
                ),
                n_extra_pos_mlp=0,
                prep_type="patches",
                spatial_downsample=4,
                temporal_downsample=1,
                generator=g,
            ),
            "label": OneHotPreprocessor(input_channels=num_classes),
        }
        output_postprocessors = {
            "audio": AudioPostprocessor(
                in_channels=512, samples_per_patch=audio_samples_per_patch, generator=g),
            "image": ProjectionPostprocessor(num_inputs=512, num_outputs=3, generator=g),
            "label": ClassificationPostprocessor(
                num_input_channels=512, num_classes=num_classes, generator=g),
        }
        output_queries = {
            "image": FourierQuery(
                concat_preprocessed_input=False,
                output_index_dims=(num_frames, h, w),
                num_bands=32,
                max_resolution=(num_frames, h // 4, w // 4),
                sine_only=False,
                concat_pos=True,
            ),
            "audio": FourierQuery(
                concat_preprocessed_input=False,
                output_index_dims=(n_audio_samples // audio_samples_per_patch,),
                num_bands=192,
                max_resolution=(n_audio_samples,),
                sine_only=False,
                concat_pos=True,
            ),
            "label": TrainableQuery(
                output_index_dims=(1,),
                concat_preprocessed_input=False,
                num_channels=1024,
                init_scale=0.02,
                generator=g,
            ),
        }
        self.perceiver = PerceiverIO(
            num_self_attends_per_block=num_self_attends_per_block,
            num_blocks=num_blocks,
            num_latents=num_latents,
            num_latent_channels=num_latent_channels,
            input_preprocessors=input_preprocessors,
            output_postprocessors=output_postprocessors,
            output_queries=output_queries,
            input_padding_channels=4,
            output_query_padding_channels=2,
            input_mask_probs={"image": 0.0, "audio": 0.0, "label": 1.0},
            policy=policy,
            remat=remat,
            generator=g,
        )
        self.to(device)

    def forward(self, images: torch.Tensor, audio: torch.Tensor, n_chunks: int = 128,
                *, chunk_mesh=None):
        """Auto-encode one batch of clips.

        Args:
          images: [B, T, C, H, W] video in [0, 1].
          audio: [B, n_audio_samples, 1] waveform in [-1, 1].
          n_chunks: the output queries are decoded in this many equal chunks.
          chunk_mesh: chunk-parallel decoding across cards; not ported.

        Returns:
          dict with "image" [B, T, C, H, W], "audio" [B, n_samples, 1],
          "label" [B, num_classes].
        """
        if chunk_mesh is not None:
            raise NotImplementedError(
                "chunk_mesh (chunk-parallel decoding across cards) is not ported yet"
                " (ROADMAP.md)"
            )
        batch_size, t, c, h, w = images.shape
        n_audio_patches = audio.shape[1] // self.audio_samples_per_patch
        if (t * h * w) % n_chunks or n_audio_patches % n_chunks:
            raise ValueError(
                f"n_chunks ({n_chunks}) must divide both the image query"
                f" count ({t * h * w} = t*h*w) and the audio patch count"
                f" ({n_audio_patches}) -- otherwise the decoded chunks"
                " cannot be stitched back to the input shapes"
            )
        image_chunk = t * h * w // n_chunks
        audio_chunk = n_audio_patches // n_chunks
        inputs = {
            "image": images,
            "audio": audio,
            "label": images.new_zeros((batch_size, self.num_classes)),
        }
        latents, state = self.perceiver.encode(inputs)  # once, for every chunk
        outs = []
        for i in range(n_chunks):
            subsampling = {
                "image": i * image_chunk + torch.arange(image_chunk),
                "audio": i * audio_chunk + torch.arange(audio_chunk),
                "label": None,
            }
            if self.remat and torch.is_grad_enabled():
                # Recompute the chunk's decode in the backward: without it
                # every chunk's decoder activations stay alive together.
                outs.append(remat_call(self.perceiver.policy, self.perceiver.decode,
                                       latents, state,
                                       subsampled_output_points=subsampling))
            else:
                outs.append(self.perceiver.decode(latents, state,
                                                  subsampled_output_points=subsampling))
        image = torch.stack([o["image"] for o in outs], dim=1)  # [B, n_chunks, chunk, C]
        image = torch.movedim(image.reshape(batch_size, t, h, w, c), -1, -3)
        audio_out = torch.stack([o["audio"] for o in outs], dim=1).reshape(audio.shape)
        label = torch.stack([o["label"] for o in outs], dim=1).mean(dim=1)
        return {"image": image, "audio": audio_out, "label": label}
