"""Core Perceiver IO: encoder, decoder, multimodal preprocessing, orchestrator.

Counterpart of ``perceiverio_pytorch_tpu/core/perceiver.py``:
  * ``PerceiverEncoder``: trainable latent array, one cross-attend, then
    ``num_blocks`` weight-shared passes over ``num_self_attends_per_block``
    distinct self-attention layers, as a plain Python loop; with ``remat``
    each pass is rematerialised in the backward under
    ``Policy.remat_policy`` (``config.remat_call``: ``torch.utils.checkpoint``,
    the JAX package's ``nn.remat``); ``dropout_prob`` (and, beyond the JAX
    encoder, ``dropout_attn_prob``) in train mode, with one seed a block
    drawn from the caller's ``generator`` before the block's region; the
    blocks share their modules, so a static int8 projection's ``amax``
    calibrates as the max over every block's input (the JAX encoder
    unrolls its block scan for that pass);
  * ``PerceiverDecoder``: one query cross-attend over the latents and an
    optional final projection ("lecun_normal" or "zeros" init);
  * ``MultimodalPreprocessor``: per-modality preprocess, trainable channel
    padding, token masking with a trainable mask token per modality (a
    ``mask_probs`` of 0 or 1 is deterministic; one strictly between draws a
    Bernoulli per token from a ``torch.Generator``), concat in sorted
    modality order (checkpoint-critical);
  * ``PerceiverIO``: the orchestrator, with ``encode`` / ``decode`` /
    ``decoder_query``.  A bare module is wrapped under the ``"__default"``
    modality, as in the reference.  Under ``Policy.fold_query_pad`` the
    decoder query goes out as a ``FoldedQuery`` (per modality, its position
    features and its raw pad vector), never as the padded concat.  With
    ``input_token_sharding`` (a ``parallel.sharding.NamedSharding`` whose
    spec names the mesh axis of the token dim), each rank keeps its piece
    of the preprocessed tokens and of the input mask, padded with masked
    tokens where the axis does not divide them, and the encoder's
    cross-attend runs sequence parallel over that axis
    (``parallel.sequence_parallel_attention_local``); the decoder query is
    built from the whole tokens.  The spec's batch entry (None or "data")
    says how the caller placed the rows: a batch on a data axis is this
    rank's rows already, as the Trainer's.  The JAX package puts a GSPMD
    sharding constraint on the same array.

Pipelining: under ``Policy.pp_mesh`` each block of the self-attend stack
runs as a pipeline over the mesh's ``pp_axis``
(``parallel.pipeline.pipeline_layers``), unless the axis has one stage, the
projections are calibrating (``ops.quant.quant_pass``) or the latents are
on the ``meta`` device: those run the sequential stack.  With ``remat`` a
pipelined block rematerialises each (tick, stage) stage body on its own,
outside the hops, where the sequential one checkpoints the whole block.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Mapping, Optional, Union

import torch
from torch import nn

from perceiverio_pytorch_tpu_torch.config import DEFAULT, Policy, remat_call
from perceiverio_pytorch_tpu_torch.core import position_encoding
from perceiverio_pytorch_tpu_torch.core.attention import (
    CrossAttention,
    Dense,
    FoldedQuery,
    SelfAttention,
    zeros_,
)
from perceiverio_pytorch_tpu_torch.ops.attention_dense import keep_mask, mix_seed
from perceiverio_pytorch_tpu_torch.parallel import collectives as cc
from perceiverio_pytorch_tpu_torch.parallel.mesh import DATA_AXIS, axis as mesh_axis
from perceiverio_pytorch_tpu_torch.utils.initializers import (
    default_generator,
    lecun_normal_,
)

ModuleOrDict = Union[None, nn.Module, Mapping[str, nn.Module]]


def _concat_sorted(parts: Mapping[str, torch.Tensor], dim: int) -> torch.Tensor:
    """Concatenate in sorted key order; a single part is returned uncopied."""
    if len(parts) == 1:
        return next(iter(parts.values()))
    return torch.cat([parts[k] for k in sorted(parts)], dim=dim)


def restructure(modality_sizes: Mapping[str, int], inputs: torch.Tensor
                ) -> Dict[str, torch.Tensor]:
    """Partition a [B, N, C] tensor into per-modality tensors, laid out in
    sorted modality-name order."""
    outputs = {}
    index = 0
    for modality in sorted(modality_sizes):
        size = modality_sizes[modality]
        outputs[modality] = inputs[:, index:index + size]
        index += size
    return outputs


def draw_seeds(generator: torch.Generator, n: int):
    """``n`` dropout seeds drawn from ``generator`` (one read from its device
    when it is a card's)."""
    return torch.randint(0, 2**62, (n,), generator=generator,
                         device=generator.device).tolist()


class _SelfAttendStack(nn.ModuleList):
    """One block: ``num_self_attends`` distinct self-attention layers,
    children "0".."N-1" (the reference's state_dict names), applied in
    turn, or as a pipeline under ``Policy.pp_mesh``."""

    def __init__(self, num_self_attends: int, in_channels: int, num_heads: int,
                 qk_channels: Optional[int], v_channels: Optional[int],
                 widening_factor: int, policy: Policy, dropout_prob: float = 0.0,
                 dropout_attn_prob: float = 0.0, *, generator):
        super().__init__(
            SelfAttention(
                in_channels=in_channels, num_heads=num_heads,
                qk_channels=qk_channels, v_channels=v_channels,
                widening_factor=widening_factor, policy=policy,
                dropout_prob=dropout_prob, dropout_attn_prob=dropout_attn_prob,
                generator=generator,
            )
            for _ in range(num_self_attends)
        )
        self.policy = policy

    def forward(self, latents, dropout_seed: Optional[int] = None, remat: bool = False):
        """The block on ``latents``; ``remat``: rematerialised in the
        backward under ``Policy.remat_policy``."""
        if self._use_pipeline(latents):
            from perceiverio_pytorch_tpu_torch.parallel.pipeline import pipeline_layers

            return pipeline_layers(self, latents, self.policy, dropout_seed=dropout_seed,
                                   remat=remat)
        if remat:
            return remat_call(self.policy, self._sequential, latents, dropout_seed)
        return self._sequential(latents, dropout_seed)

    def _sequential(self, latents, dropout_seed: Optional[int] = None):
        for i, layer in enumerate(self):
            seed = None if dropout_seed is None else mix_seed(dropout_seed, i)
            latents = layer(latents, dropout_seed=seed)
        return latents

    def _use_pipeline(self, latents) -> bool:
        """Route through the pipeline (``Policy.pp_mesh``, its fields checked
        when the Policy was made)?  JAX's ``_use_pipeline``: a calibration
        pass (and a ``meta`` build) stays sequential, a pipe axis of one
        stage too (``pipeline_layers`` refuses a layer count that does not
        divide)."""
        pol = self.policy
        if pol.pp_mesh is None:
            return False
        if latents.device.type == "meta" or any(
                getattr(m, "quant_pass", None) == "calibrate" for m in self.modules()):
            return False
        return mesh_axis(pol.pp_mesh, pol.pp_axis).size > 1  # else the sequential path


class PerceiverEncoder(nn.Module):
    """Scalable fully attentional encoder."""

    def __init__(
        self,
        num_input_channels: int,
        num_self_attends_per_block: int = 6,
        num_blocks: int = 8,
        num_latents: int = 512,
        num_latent_channels: int = 1024,
        qk_channels: Optional[int] = None,
        v_channels: Optional[int] = None,
        num_cross_attend_heads: int = 1,
        num_self_attend_heads: int = 8,
        cross_attend_widening_factor: int = 1,
        self_attend_widening_factor: int = 1,
        latent_pos_enc_init_scale: float = 0.02,
        cross_attention_shape_for_attn: str = "kv",
        use_query_residual: bool = True,
        policy: Policy = DEFAULT,
        remat: bool = False,
        dropout_prob: float = 0.0,
        dropout_attn_prob: float = 0.0,
        *,
        generator=None,
    ):
        super().__init__()
        for heads, what in ((num_self_attend_heads, "num_self_attend_heads"),
                            (num_cross_attend_heads, "num_cross_attend_heads")):
            if num_latent_channels % heads != 0:
                raise ValueError(
                    f"num_z_channels ({num_latent_channels}) must be divisible"
                    f" by {what} ({heads})."
                )
        g = default_generator(generator)
        self.num_blocks = num_blocks
        # Rematerialise the self-attend stack in the backward: one more
        # forward of the stack in FLOPs, O(1) instead of O(depth) activations.
        self.remat = remat
        self.policy = policy
        self.has_dropout = dropout_prob > 0.0 or dropout_attn_prob > 0.0
        self.latent_pos_enc = position_encoding.TrainablePositionEncoding(
            index_dim=num_latents, num_channels=num_latent_channels,
            init_scale=latent_pos_enc_init_scale, generator=g,
        )
        self.cross_attend = CrossAttention(
            q_in_channels=num_latent_channels, kv_in_channels=num_input_channels,
            num_heads=num_cross_attend_heads,
            widening_factor=cross_attend_widening_factor,
            shape_for_attn=cross_attention_shape_for_attn,
            qk_channels=qk_channels, v_channels=v_channels,
            use_query_residual=use_query_residual, policy=policy,
            dropout_prob=dropout_prob, dropout_attn_prob=dropout_attn_prob, generator=g,
        )
        self.self_attends = _SelfAttendStack(
            num_self_attends_per_block, num_latent_channels,
            num_self_attend_heads, qk_channels, v_channels,
            self_attend_widening_factor, policy, dropout_prob, dropout_attn_prob,
            generator=g,
        )

    def latents(self, inputs) -> torch.Tensor:
        """Initial latent array for the cross-attend: [B, N_lat, C_lat]."""
        return self.latent_pos_enc(inputs.shape[0])

    def forward(self, inputs, latents, *, input_mask=None, kv_logical_len=None,
                generator: Optional[torch.Generator] = None, kv_shard=None):
        """``generator`` draws the dropout seeds (one for the cross-attend,
        one a block, before the block's checkpointed region); it is required
        in train mode when a dropout rate is above 0.  ``kv_shard``: the
        mesh axis that ``inputs`` and ``input_mask`` are this rank's tokens
        of (``PerceiverIO(input_token_sharding=...)``)."""
        seeds = [None] * (1 + self.num_blocks)
        if self.training and self.has_dropout:
            if generator is None:
                raise ValueError("PerceiverEncoder has dropout in train mode: pass a"
                                 " torch.Generator (generator=...)")
            seeds = draw_seeds(generator, 1 + self.num_blocks)
        latents = self.cross_attend(latents, inputs, kv_mask=input_mask,
                                    kv_logical_len=kv_logical_len, dropout_seed=seeds[0],
                                    kv_shard=kv_shard)
        for seed in seeds[1:]:  # weight-shared blocks
            latents = self.self_attends(latents, seed,
                                        remat=self.remat and torch.is_grad_enabled())
        return latents


class PerceiverDecoder(nn.Module):
    """Cross-attention decoder."""

    def __init__(
        self,
        query_channels: int,
        final_project_out_channels: int,
        num_latent_channels: int = 1024,
        qk_channels: Optional[int] = None,
        v_channels: Optional[int] = None,
        use_query_residual: bool = False,
        output_w_init: str = "lecun_normal",
        num_heads: int = 1,
        final_project: bool = True,
        policy: Policy = DEFAULT,
        *,
        generator=None,
    ):
        super().__init__()
        g = default_generator(generator)
        self.use_query_residual = use_query_residual
        self.decoding_cross_attn = CrossAttention(
            q_in_channels=query_channels, kv_in_channels=num_latent_channels,
            num_heads=num_heads, widening_factor=1, shape_for_attn="kv",
            qk_channels=qk_channels, v_channels=v_channels,
            use_query_residual=use_query_residual, policy=policy, generator=g,
        )
        self.final_project = final_project
        if final_project:
            inits = {"lecun_normal": lecun_normal_, "zeros": zeros_}
            if output_w_init not in inits:
                raise ValueError(f"{output_w_init} not supported as output_w_init")
            self.final_layer = Dense(
                query_channels, final_project_out_channels,
                init=inits[output_w_init], compute_dtype=policy.compute_dtype,
                generator=g,
            )

    def forward(self, query, latents, *, query_mask=None):
        output = self.decoding_cross_attn(query, latents, q_mask=query_mask)
        if self.final_project:
            output = self.final_layer(output)
        return output


class MultimodalPreprocessor(nn.Module):
    """Per-modality preprocess, padding to common channels and token
    masking."""

    def __init__(
        self,
        input_preprocessors: Optional[Mapping[str, nn.Module]] = None,
        mask_probs: Optional[Mapping[str, float]] = None,
        min_padding_size: int = 2,
        input_channels: Optional[Mapping[str, int]] = None,
        *,
        generator=None,
    ):
        super().__init__()
        if mask_probs is not None and not all(0.0 <= p <= 1.0 for p in mask_probs.values()):
            raise ValueError(f"mask_probs {dict(mask_probs)}: each must lie in [0, 1]")
        if (input_preprocessors is None) == (input_channels is None):
            raise ValueError(
                "exactly one of input_preprocessors and input_channels is required"
            )
        if input_preprocessors is not None:
            self._preprocessors = nn.ModuleDict(dict(input_preprocessors))
            channels = {m: p.n_output_channels() for m, p in input_preprocessors.items()}
        else:
            self._preprocessors = None
            channels = dict(input_channels)
        self._common_channels = max(channels.values()) + min_padding_size
        g = default_generator(generator)
        # Masking replaces each token of a modality by its mask token with
        # the modality's probability: all with 1, none with 0, else a
        # Bernoulli draw per token from the forward's generator or, without
        # one, from this constructor's.
        self.mask_probs = None if mask_probs is None else dict(mask_probs)
        self._mask_generator = (
            g if self.mask_probs and any(0.0 < p < 1.0 for p in self.mask_probs.values())
            else None)
        if mask_probs is not None:
            self.mask_tokens = nn.ModuleDict({
                m: position_encoding.TrainablePositionEncoding(
                    index_dim=1, num_channels=self._common_channels, init_scale=0.02,
                    generator=g)
                for m in channels
            })
        if max(channels.values()) != min(channels.values()) or min_padding_size != 0:
            self.padding_embeddings = nn.ModuleDict({
                m: position_encoding.TrainablePositionEncoding(
                    index_dim=1, num_channels=self._common_channels - c,
                    init_scale=0.02, generator=g)
                for m, c in channels.items()
            })
        else:
            self.padding_embeddings = None

    def n_output_channels(self) -> int:
        return self._common_channels

    def forward(self, inputs: Mapping[str, torch.Tensor], *, pos=None,
                generator: Optional[torch.Generator] = None):
        if self._preprocessors is None:
            outputs = dict(inputs)
            inputs_without_pos = dict(inputs)
        else:
            outputs, inputs_without_pos = {}, {}
            for modality, preprocessor in self._preprocessors.items():
                outputs[modality], inputs_without_pos[modality] = preprocessor(
                    inputs[modality], pos=pos)

        if self.padding_embeddings is not None:
            padded = {}
            for modality, output in outputs.items():
                pad = self.padding_embeddings[modality](output.shape[0])
                pad = pad.expand(output.shape[0], output.shape[1], -1).to(output.dtype)
                padded[modality] = torch.cat([output, pad], dim=2)
            outputs = padded
        modality_sizes = {m: o.shape[1] for m, o in outputs.items()}

        if self.mask_probs is not None:
            for modality, output in outputs.items():
                prob = self.mask_probs[modality]
                if prob <= 0.0:
                    continue
                token = self.mask_tokens[modality](output.shape[0])
                shape = (output.shape[0], output.shape[1], 1)
                if prob >= 1.0:
                    mask = output.new_ones(shape)
                else:
                    draws = generator if generator is not None else self._mask_generator
                    mask = keep_mask(shape, prob, draws, draws.device)
                    mask = mask.to(device=output.device, dtype=output.dtype)
                outputs[modality] = (1.0 - mask) * output + mask * token
        return _concat_sorted(outputs, 1), modality_sizes, inputs_without_pos


class PerceiverIO(nn.Module):
    """The Perceiver IO orchestrator."""

    def __init__(
        self,
        num_blocks: int = 8,
        num_self_attends_per_block: int = 6,
        num_latents: int = 512,
        num_latent_channels: int = 1024,
        final_project: bool = True,
        final_project_out_channels: Optional[int] = None,
        perceiver_encoder_kwargs: Optional[Mapping[str, Any]] = None,
        perceiver_decoder_kwargs: Optional[Mapping[str, Any]] = None,
        input_preprocessors: ModuleOrDict = None,
        output_postprocessors: ModuleOrDict = None,
        output_queries: ModuleOrDict = None,
        output_query_padding_channels: int = 0,
        input_padding_channels: int = 0,
        input_channels: Union[None, int, Mapping[str, int]] = None,
        input_mask_probs: Optional[Mapping[str, float]] = None,
        policy: Policy = DEFAULT,
        remat: bool = False,
        input_token_sharding=None,
        *,
        generator=None,
    ):
        super().__init__()
        g = default_generator(generator)
        self.policy = policy
        if input_token_sharding is not None:
            spec = tuple(input_token_sharding.spec)
            if (len(spec) < 2 or spec[1] is None or spec[0] not in (None, DATA_AXIS)
                    or any(s is not None for s in spec[2:])):
                raise ValueError(
                    f"input_token_sharding spec {spec}: the port splits the token dim of"
                    " [B, N, C] over one mesh axis, (None or 'data', axis)")
            if (perceiver_encoder_kwargs or {}).get("dropout_attn_prob", 0.0) > 0.0:
                raise ValueError(
                    "input_token_sharding: the encoder's attention dropout needs the whole"
                    " attention matrix, which no rank holds; set dropout_attn_prob to 0")
        self.input_token_sharding = input_token_sharding
        if isinstance(input_channels, int):
            input_channels = {"__default": input_channels}
        self._multi_preprocessor = MultimodalPreprocessor(
            input_preprocessors=self._as_dict(input_preprocessors),
            mask_probs=input_mask_probs,
            min_padding_size=input_padding_channels,
            input_channels=input_channels,
            generator=g,
        )
        postprocessors = self._as_dict(output_postprocessors)
        self._output_postprocessors = (
            nn.ModuleDict(postprocessors) if postprocessors else None)
        queries = self._as_dict(output_queries)
        if not queries:
            raise ValueError("output_queries are required")
        self._output_queries = nn.ModuleDict(queries)
        self._query_channels = (
            max(q.n_query_channels() for q in queries.values())
            + output_query_padding_channels
        )
        self.padding_embeddings = nn.ModuleDict({
            m: position_encoding.TrainablePositionEncoding(
                index_dim=1,
                num_channels=self._query_channels - q.n_query_channels(),
                init_scale=0.02, generator=g)
            for m, q in queries.items()
        })
        self._encoder = PerceiverEncoder(
            num_input_channels=self._multi_preprocessor.n_output_channels(),
            num_blocks=num_blocks,
            num_self_attends_per_block=num_self_attends_per_block,
            num_latents=num_latents,
            num_latent_channels=num_latent_channels,
            policy=policy,
            remat=remat,
            generator=g,
            **(perceiver_encoder_kwargs or {}),
        )
        self._decoder = PerceiverDecoder(
            query_channels=self._query_channels,
            final_project=final_project,
            final_project_out_channels=(
                final_project_out_channels or num_latent_channels),
            num_latent_channels=num_latent_channels,
            policy=policy,
            generator=g,
            **(perceiver_decoder_kwargs or {}),
        )

    @staticmethod
    def _as_dict(value: ModuleOrDict) -> Optional[Dict[str, nn.Module]]:
        if value is None:
            return None
        if isinstance(value, nn.Module):
            return {"__default": value}
        return dict(value)

    @property
    def query_channels(self) -> int:
        return self._query_channels

    def forward(self, inputs, *, subsampled_output_points=None, pos=None,
                input_mask=None, query_mask=None, generator=None):
        latents, state = self.encode(inputs, pos=pos, input_mask=input_mask,
                                     generator=generator)
        return self.decode(latents, state,
                           subsampled_output_points=subsampled_output_points,
                           query_mask=query_mask)

    def encode(self, inputs, *, pos=None, input_mask=None, generator=None):
        """Preprocess + encode once; returns (latents, preprocess state).
        ``generator`` draws the token masks and the encoder's dropout seeds,
        outside every checkpointed region."""
        if not isinstance(inputs, Mapping):
            inputs = {"__default": inputs}
        flat_inputs, modality_sizes, inputs_without_pos = self._multi_preprocessor(
            inputs, pos=pos, generator=generator)
        tokens, mask, kv_shard = flat_inputs, input_mask, None
        if self.input_token_sharding is not None:
            tokens, mask, kv_shard = self._token_piece(flat_inputs, input_mask)
        latents = self._encoder(tokens, self._encoder.latents(flat_inputs),
                                input_mask=mask, generator=generator, kv_shard=kv_shard)
        return latents, (flat_inputs, modality_sizes, inputs_without_pos)

    def _token_piece(self, tokens, input_mask):
        """This rank's piece of the [B, N, C] tokens and of the [B, N] mask
        along the axis of ``input_token_sharding``, N padded with masked
        tokens to a multiple of its size; and the axis."""
        from perceiverio_pytorch_tpu_torch.parallel.sequence_parallel import pad_tokens

        sharding = self.input_token_sharding
        ax = mesh_axis(sharding.mesh, sharding.spec[1])
        (tokens,), input_mask = pad_tokens((tokens,), input_mask, ax.size)
        tokens = cc.scatter_dim(tokens, 1, ax.group)  # the gradient gathered back whole
        if input_mask is not None:
            input_mask = cc.local_piece(input_mask, 1, ax.group).contiguous()
        return tokens, input_mask, ax

    def decode(self, latents, preprocess_state, *, subsampled_output_points=None,
               query_mask=None):
        """Decode (a subsample of) the output queries against given latents."""
        flat_inputs, modality_sizes, inputs_without_pos = preprocess_state
        query, query_sizes = self.decoder_query(
            flat_inputs, modality_sizes, inputs_without_pos,
            subsampled_points=subsampled_output_points,
        )
        outputs = self._decoder(query, latents, query_mask=query_mask)
        return self._postprocess(outputs, query_sizes)

    def _postprocess(self, outputs, query_sizes):
        if self._output_postprocessors is not None:
            if not isinstance(outputs, Mapping):
                outputs = restructure(query_sizes, outputs)
            outputs = {
                m: post(outputs[m], pos=None, modality_sizes=None)
                for m, post in self._output_postprocessors.items()
            }
        if isinstance(outputs, Mapping) and list(outputs) == ["__default"]:
            outputs = outputs["__default"]
        return outputs

    def decoder_query(self, flat_inputs, modality_sizes, inputs_without_pos=None,
                      subsampled_points=None):
        """The decoder query and its sizes: the concatenated, channel-padded
        query, or under ``Policy.fold_query_pad`` (where a query is padded
        and the decoder has no query residual) a ``FoldedQuery`` of each
        modality's query and raw pad vector, in sorted modality order."""
        fold = (
            self.policy.fold_query_pad
            and not self._decoder.use_query_residual
            and any(self._query_channels > q.n_query_channels()
                    for q in self._output_queries.values())
        )
        inputs = restructure(modality_sizes, flat_inputs)
        subsampled_points = subsampled_points or {}
        dummy_input = None
        if set(self._output_queries) != set(inputs):
            first = next(iter(inputs.values()))
            dummy_input = first.new_zeros((first.shape[0], 0))
        queries = {}
        for modality, output_query in self._output_queries.items():
            without_pos = (inputs_without_pos or {}).get(modality)
            query = output_query(
                inputs.get(modality, dummy_input),
                inputs_without_pos=without_pos,
                subsampled_points=subsampled_points.get(modality),
            )
            if self.policy.compute_dtype is not None:
                query = query.to(self.policy.compute_dtype)
            query = query.reshape(query.shape[0], math.prod(query.shape[1:-1]),
                                  query.shape[-1])
            width = self._query_channels - query.shape[2]
            if fold:
                # The raw [C - C_m] pad vector; the decoder folds it through
                # its query LayerNorm and projection.
                queries[modality] = (query, self.padding_embeddings[modality](1)[0, 0])
                continue
            if width:
                pad = self.padding_embeddings[modality](query.shape[0])
                pad = pad.expand(query.shape[0], query.shape[1], width).to(query.dtype)
                query = torch.cat([query, pad], dim=2)
            queries[modality] = query
        if fold:
            query_sizes = {m: q.shape[1] for m, (q, _) in queries.items()}
            return FoldedQuery(parts=tuple(queries[m] for m in sorted(queries))), query_sizes
        query_sizes = {m: q.shape[1] for m, q in queries.items()}
        return _concat_sorted(queries, 1), query_sizes
