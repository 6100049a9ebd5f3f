"""Byte-level masked-language-model Perceiver: the port's MLM serving path.

Counterpart of ``perceiverio_pytorch_tpu/models/language.py``: vocabulary
262, 2,048 bytes embedded in 768 channels, 256 latents x 1280 channels,
26 self-attends in one block, qk width 256 with 8 heads on the cross- and
self-attends, a decoder of value width 768 without a final projection and
a token table tied between the input embedding and the output decode.  At
this size every attention site (2,048 keys, 256 latents, 2,048 queries) is
below the flash thresholds, so on a GPU too all of them take the dense
path.

The table is one ``nn.Embedding``, registered under the preprocessor
(``embed``) and under the postprocessor (``_embedding``): the state_dict
carries it under both of the reference's names, the parameters hold it
once.  ``device`` is "cuda" by default; with no GPU the model raises unless
the caller asks for ``device="cpu"``.  Weights are drawn from a
``torch.Generator`` (seed 0 when none is given).
"""

from __future__ import annotations

import torch
from torch import nn

from perceiverio_pytorch_tpu_torch.config import DEFAULT, Policy
from perceiverio_pytorch_tpu_torch.core.perceiver import PerceiverIO
from perceiverio_pytorch_tpu_torch.core.queries import TrainableQuery
from perceiverio_pytorch_tpu_torch.io_processors.postprocessors import EmbeddingPostprocessor
from perceiverio_pytorch_tpu_torch.io_processors.preprocessors import (
    EmbeddingPreprocessor,
    make_embedding,
)
from perceiverio_pytorch_tpu_torch.models.flow import resolve_device
from perceiverio_pytorch_tpu_torch.utils.initializers import default_generator


class LanguagePerceiver(nn.Module):
    """Perceiver for masked language modelling."""

    def __init__(
        self,
        vocab_size: int = 262,
        max_seq_len: int = 2048,
        embed_dim: int = 768,
        num_self_attends_per_block: int = 26,
        num_blocks: int = 1,
        num_latents: int = 256,
        num_latent_channels: int = 1280,
        policy: Policy = DEFAULT,
        remat: bool = False,
        *,
        device="cuda",
        generator=None,
    ):
        super().__init__()
        device = resolve_device(device)
        g = default_generator(generator)
        embed = make_embedding(vocab_size, embed_dim, generator=g)
        self.perceiver = PerceiverIO(
            final_project=False,
            num_self_attends_per_block=num_self_attends_per_block,
            num_blocks=num_blocks,
            num_latents=num_latents,
            num_latent_channels=num_latent_channels,
            input_preprocessors=EmbeddingPreprocessor(
                vocab_size=vocab_size, max_seq_len=max_seq_len, embedding_dims=embed_dim,
                embed=embed, generator=g),
            output_postprocessors=EmbeddingPostprocessor(embed, vocab_size=vocab_size),
            output_queries=TrainableQuery(
                output_index_dims=max_seq_len, num_channels=embed_dim, generator=g),
            perceiver_encoder_kwargs=dict(
                num_self_attend_heads=8,
                num_cross_attend_heads=8,
                qk_channels=8 * 32,
                v_channels=num_latent_channels,
                use_query_residual=True,
            ),
            perceiver_decoder_kwargs=dict(
                qk_channels=8 * 32,
                v_channels=embed_dim,
                num_heads=8,
                use_query_residual=False,
            ),
            policy=policy,
            remat=remat,
            generator=g,
        )
        self.to(device)

    def forward(self, inputs: torch.Tensor, input_masks=None, *, predict_positions=None):
        """MLM logits.

        Args:
          inputs: [B, max_seq_len] integer token ids.
          input_masks: optional [B, max_seq_len] bool, False at padding: the
            encoder ignores those keys and the decoder wipes those rows.
          predict_positions: optional [P] integer sequence positions; the
            decoder then runs only those P query rows (the query mask
            gathered at them) and returns [B, P, vocab] instead of
            [B, max_seq_len, vocab], the same rows as the full decode.

        Returns:
          [B, max_seq_len or P, vocab_size] logits, fp32.
        """
        subsampled = None
        query_mask = input_masks
        if predict_positions is not None:
            positions = torch.as_tensor(predict_positions, device=inputs.device)
            subsampled = {"__default": positions}
            if input_masks is not None:
                query_mask = input_masks[:, positions]
        return self.perceiver(inputs, input_mask=input_masks, query_mask=query_mask,
                              subsampled_output_points=subsampled)
