"""Transformer primitives: Attention, MLP, SelfAttention, CrossAttention.

Counterpart of ``perceiverio_pytorch_tpu/core/attention.py``:
  * ``Attention``: separate q/k/v projections with independently sized
    qk / v / output widths; the attention itself goes through
    ``ops.attention.multihead_attention``, so long sites take the flash
    kernel;
  * ``MLP``: Dense -> GELU (exact erf, or tanh under
    ``Policy.gelu_approximate``) -> Dense;
  * ``SelfAttention``: pre-LN residual block;
  * ``CrossAttention``: separate q/kv LayerNorms, ``shape_for_attn``
    choosing the qk width, optional query residual;
  * ``FoldedQuery``: a decoder query in factored (position features,
    constant pad) form, whose pad channels ``Attention`` folds through the
    query LayerNorm and projection (``_project_q_folded``).

LayerNorms run in fp32 with eps 1e-5 and their output is cast to the
compute dtype.  Dropout is the JAX package's: ``dropout_attn_prob`` on the
attention probabilities (which sends the site to the dense path) and
``dropout_prob`` after the MLP and on the attention's output, in train mode
(``module.training``) only.  The masks come from ``dropout_seed``, an int
the caller draws (``PerceiverEncoder`` draws one a block from its
``generator``): each site makes its own ``torch.Generator`` from it
(``ops.attention_dense.site_generator``), so a checkpointed block draws the
same masks when the backward recomputes it.  Under ``Policy.quant`` the
attention and MLP projections are int8 products (``Dense(quant=...)``,
``ops.quant``); ``CrossAttention`` keeps them exact under
``quant_scope="latent"``, and the folded query projection
(``_project_q_folded``) is always exact, as in the JAX package.

Placed on a mesh (``parallel.sharding.shard_module``), a projection runs
its part of the tensor-parallel layout (``Dense.tp``): a column-parallel one
takes its replicated input through ``copy_to`` and gives its local output
features; a row-parallel one sums its partial products over the model axis
(``reduce_from``), the bias added once, by the rank at model coordinate 0,
so that on one rank the product is the unsharded one bit for bit; under
int8 it reduces its per-token and per-channel maxima over the model axis
too (``ops.quant``).  An ``Attention`` attends on its H/M local heads where
the model axis of M divides its H heads, else it gathers its projections'
output features and attends on all heads (the 1-head cross-attends), its
``final`` then taking its own slice of the replicated result.

Sequence parallelism: every ``Attention`` passes ``Policy.sp_*`` to the
dispatch, whose ``"sp"`` path splits a long site's keys over a mesh axis.
A ``CrossAttention`` given ``kv_shard`` (the mesh axis; the encoder under
``PerceiverIO(input_token_sharding=...)``) receives this rank's tokens
only: its key-side LayerNorm and K/V projections run under ``copy_to``
stand-ins (``parallel.collectives.summed_params``), so that their partial
gradients are summed over the axis, and a static int8 projection
calibrates the max over the axis.  A site that is TP-sharded and takes the
sequence-parallel path raises ValueError: both would use the model axis.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from perceiverio_pytorch_tpu_torch.config import DEFAULT, Policy, quant_enabled, quant_mode
from perceiverio_pytorch_tpu_torch.ops.attention import attention_path, multihead_attention
from perceiverio_pytorch_tpu_torch.ops.attention_dense import dropout, site_generator
from perceiverio_pytorch_tpu_torch.ops.quant import int8_dynamic_matmul, int8_static_matmul
from perceiverio_pytorch_tpu_torch.parallel.collectives import (
    all_reduce_,
    copy_to,
    gather_dim,
    reduce_from,
    scatter_dim,
    summed_params,
    using,
)
from perceiverio_pytorch_tpu_torch.utils.initializers import (
    default_generator,
    lecun_normal_,
    variance_scaling_,
)

__all__ = ["Dense", "LayerNorm", "FoldedQuery", "Attention", "MLP", "SelfAttention",
           "CrossAttention"]

_LN_EPS = 1e-5

# Sub-site indices of a block's dropout_seed.
_ATTN_PROBS, _POST_ATTN, _MLP_OUT = 0, 1, 2


def _site(module: nn.Module, rate: float, seed: Optional[int], index: int, device):
    """The generator of an active dropout site (train mode, rate above 0),
    else None."""
    if not (module.training and rate > 0.0):
        return None
    if seed is None:
        raise ValueError(
            f"{type(module).__name__} has dropout {rate} in train mode: pass dropout_seed"
            " (or a generator to PerceiverEncoder / PerceiverIO.encode)")
    return site_generator(seed, index, device)


def _dropout(module: nn.Module, x: torch.Tensor, rate: float, seed: Optional[int],
             index: int) -> torch.Tensor:
    generator = _site(module, rate, seed, index, x.device)
    return x if generator is None else dropout(x, rate, generator)


def zeros_(weight: torch.Tensor, generator: torch.Generator):
    del generator
    with torch.no_grad():
        return weight.zero_()


def _variance_scaling(scale: float) -> Callable:
    return lambda w, g: variance_scaling_(w, scale, g)


class Dense(nn.Linear):
    """``nn.Linear`` with the JAX package's init and dtype promotion.

    The weight is drawn by ``init(weight, generator)`` and the bias is 0.
    With ``compute_dtype`` set, input, weight and bias are cast to it (flax
    ``nn.Dense(dtype=...)``); otherwise they are promoted to a common dtype.

    ``quant`` (a ``Policy.quant`` mode, the JAX package's ``_QuantDense``)
    makes the product an int8 one (``ops.quant``), quantized from the stored
    weight, not from its compute-dtype cast; the result is in
    ``compute_dtype`` (else the input's dtype), the bias added in that dtype.
    An "int8_static" projection holds its calibrated ``max|x|`` in a 0-d
    fp32 buffer ``amax`` (0: uncalibrated), which no other projection has,
    so that every other model's state_dict keeps the reference's names.
    ``quant_pass`` (set by ``ops.quant.quant_pass``) is "calibrate" (a
    static projection records ``max|x|`` and runs the exact product),
    "exact" (the exact product) or None.

    ``tp`` (set by ``parallel.sharding.shard_module``) is None, or
    ``("col", axis)`` / ``("row", axis)`` with the model axis
    (``parallel.mesh.Axis``): see the module docstring.
    """

    tp = None

    def __init__(self, in_features: int, out_features: int, *, bias: bool = True,
                 init: Callable = lecun_normal_,
                 compute_dtype: Optional[torch.dtype] = None, generator=None,
                 quant: Optional[str] = None):
        super().__init__(in_features, out_features, bias=bias)
        if quant not in (None, "int8_dynamic", "int8_static"):
            raise ValueError(f"Dense quant must be None, 'int8_dynamic' or 'int8_static';"
                             f" got {quant!r}")
        self.compute_dtype = compute_dtype
        self.quant = quant
        self.quant_pass = None
        if quant == "int8_static":
            self.register_buffer("amax", torch.zeros((), dtype=torch.float32))
        init(self.weight.data, default_generator(generator))
        if self.bias is not None:
            with torch.no_grad():
                self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mode, ax = self.tp or (None, None)
        if mode == "col":
            x = copy_to(x, ax.group)
        quant = None if self.quant_pass == "exact" else self.quant
        if quant == "int8_static" and self.quant_pass == "calibrate":
            with torch.no_grad():
                local = x.detach().float().abs().amax()
                if mode == "row":
                    all_reduce_(local, ax.group, torch.distributed.ReduceOp.MAX)
                torch.maximum(self.amax, local, out=self.amax)
            quant = None
        if quant is not None:
            return self._int8(x, quant, ax.group if mode == "row" else None)
        dtype = self.compute_dtype or torch.promote_types(x.dtype, self.weight.dtype)
        bias = self.bias
        if mode == "row" and bias is not None:
            # Added once to the partial sums: the other ranks add a zero
            # that keeps the bias's gradient collective in their graph.
            bias = copy_to(bias, ax.group)
            bias = bias if ax.index == 0 else bias * 0.0
        bias = bias.to(dtype) if bias is not None else None
        y = F.linear(x.to(dtype), self.weight.to(dtype), bias)
        return reduce_from(y, ax.group) if mode == "row" else y

    def _int8(self, x: torch.Tensor, quant: str, group=None) -> torch.Tensor:
        out_dtype = self.compute_dtype or x.dtype
        if quant == "int8_static":
            y = int8_static_matmul(x, self.weight, self.amax, out_dtype=out_dtype,
                                   group=group)
        else:
            y = int8_dynamic_matmul(x, self.weight, out_dtype=out_dtype, group=group)
        return y if self.bias is None else y + self.bias.to(out_dtype)


class LayerNorm(nn.LayerNorm):
    """LayerNorm (eps 1e-5) computed and returned in fp32."""

    def __init__(self, num_channels: int):
        super().__init__(num_channels, eps=_LN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(
            x.float(), self.normalized_shape, self.weight.float(),
            self.bias.float(), self.eps,
        )


class FoldedQuery(NamedTuple):
    """A decoder query in factored form: per modality, ``(pos [B, T, C_m],
    pad [C - C_m])``, in the token order of the concatenated query (sorted
    modality names); each token's channels are ``[pos, pad]``, the pad the
    same for every token of a modality.  The padded [B, Tq, C] concat is
    never built: ``Attention`` folds the pad through the query LayerNorm
    (``ln_scale``, ``ln_bias``, filled in by ``CrossAttention``, which owns
    it) and the Q projection, and runs the one per-token GEMM on the narrow
    position features only."""

    parts: Tuple[Tuple[torch.Tensor, torch.Tensor], ...]
    ln_scale: Optional[torch.Tensor] = None
    ln_bias: Optional[torch.Tensor] = None

    @property
    def num_tokens(self) -> int:
        return sum(pos.shape[1] for pos, _ in self.parts)

    @property
    def num_channels(self) -> int:
        pos, pad = self.parts[0]
        return pos.shape[-1] + pad.shape[-1]


class Attention(nn.Module):
    """Multi-headed {cross, self}-attention.

    ``tp``: the model axis (``parallel.mesh.Axis``) when the module is
    placed on a mesh (``parallel.sharding.shard_module``), else None.
    """

    tp = None

    def __init__(
        self,
        q_in_channels: int,
        k_in_channels: Optional[int] = None,
        v_in_channels: Optional[int] = None,
        num_heads: int = 8,
        init_scale: float = 1.0,
        with_final_bias: bool = True,
        final_init_scale_multiplier: float = 1.0,
        qk_out_channels: Optional[int] = None,
        v_out_channels: Optional[int] = None,
        output_channels: Optional[int] = None,
        policy: Policy = DEFAULT,
        dropout_prob: float = 0.0,
        *,
        generator=None,
    ):
        super().__init__()
        self.dropout_prob = dropout_prob
        qk_out = qk_out_channels or q_in_channels
        v_out = v_out_channels or qk_out
        out = output_channels or v_out
        if qk_out % num_heads != 0:
            raise ValueError(
                f"qk_out_channels ({qk_out}) must be divisible by"
                f" num_heads ({num_heads})."
            )
        if v_out % num_heads != 0:
            raise ValueError(
                f"v_channels ({v_out}) must be divisible by num_heads ({num_heads})."
            )
        k_in = k_in_channels or q_in_channels
        v_in = v_in_channels or k_in
        self.num_heads = num_heads
        self.policy = policy
        self._qk_out, self._v_out = qk_out, v_out
        g = default_generator(generator)
        kw = dict(compute_dtype=policy.compute_dtype, generator=g, quant=quant_mode(policy))
        init = _variance_scaling(init_scale)
        self.proj_q = Dense(q_in_channels, qk_out, init=init, **kw)
        self.proj_k = Dense(k_in, qk_out, init=init, **kw)
        self.proj_v = Dense(v_in, v_out, init=init, **kw)
        self.final = Dense(
            v_out, out, bias=with_final_bias,
            init=_variance_scaling(final_init_scale_multiplier * init_scale), **kw,
        )

    def _project_q_folded(self, fq: FoldedQuery) -> torch.Tensor:
        """LayerNorm + proj_q of a ``FoldedQuery``, the pad folded in.

        For a token z = [x, p] (position features x, constant pad p) of C
        channels, LN(z) W + b = ((x g1) W1 + (p g2) W2 - mu (g W)) / sigma +
        beta W + b, with mu and sigma from x and the pad's sums: the mean
        over all C channels and the two-pass variance, its pad half sum((p -
        mu)^2) = sum(p^2) - 2 mu sum(p) + C2 mu^2 exactly.  Only (x g1) W1
        touches per-token data, in the compute dtype; everything else is
        fp32.
        """
        w32 = self.proj_q.weight.float().t()  # [C, qk_out]
        gamma, beta = fq.ln_scale.float(), fq.ln_bias.float()
        if self.proj_q.tp is not None:  # column-parallel: replicated inputs
            group = self.proj_q.tp[1].group
            gamma, beta = copy_to(gamma, group), copy_to(beta, group)
            fq = fq._replace(parts=tuple((copy_to(pos, group), copy_to(pad, group))
                                         for pos, pad in fq.parts))
        total_c = w32.shape[0]
        # Row-vector products as [1, C] @ [C, qk_out]: ``vector @ matrix``
        # squeezes its product in place, which a selective checkpoint that
        # keeps the product refuses (Policy.remat_policy).
        u = (gamma[None] @ w32)[0]  # [qk_out], token-independent
        const = (beta[None] @ w32)[0] + self.proj_q.bias.float()
        compute_dtype = self.policy.compute_dtype or fq.parts[0][0].dtype
        outs = []
        for pos, pad in fq.parts:
            cm = pos.shape[-1]
            x32, p32 = pos.float(), pad.float()
            sum_p, sumsq_p = p32.sum(), (p32 * p32).sum()
            mu = (x32.sum(-1) + sum_p) / total_c  # [B, T]
            dx = x32 - mu[..., None]
            pad_ss = sumsq_p - 2.0 * mu * sum_p + float(p32.shape[0]) * mu * mu
            inv_sigma = torch.rsqrt(((dx * dx).sum(-1) + pad_ss) / total_c + _LN_EPS)
            t1 = (x32 * gamma[:cm]).to(compute_dtype) @ w32[:cm].to(compute_dtype)
            cp = ((p32 * gamma[cm:])[None] @ w32[cm:])[0]  # [qk_out], constant
            q_m = (t1.float() + cp - mu[..., None] * u) * inv_sigma[..., None] + const
            outs.append(q_m.to(compute_dtype))
        return torch.cat(outs, dim=1) if len(outs) > 1 else outs[0]

    def forward(self, inputs_q, inputs_k, inputs_v, *, attention_mask=None,
                q_mask=None, kv_mask=None, kv_logical_len: Optional[int] = None,
                dropout_seed: Optional[int] = None, kv_shard=None):
        """``kv_shard``: the mesh axis (``parallel.mesh.Axis``) that
        ``inputs_k``/``inputs_v`` and ``kv_mask`` are this rank's tokens of
        (see the module docstring)."""
        pol = self.policy
        generator = _site(self, self.dropout_prob, dropout_seed, _ATTN_PROBS,
                          inputs_k.device)
        if self.tp is not None and (kv_shard is not None or attention_path(
                pol.attn_impl, q_len=0, kv_len=inputs_k.shape[1], on_cuda=False,
                attention_mask=attention_mask, dropout_rate=0.0 if generator is None else 1.0,
                sp_mesh=pol.sp_mesh, sp_min_kv=pol.sp_min_kv) == "sp"):
            raise ValueError(
                "this attention is tensor parallel over the model axis and would run"
                " sequence parallel (Policy.sp_mesh or input_token_sharding) over it too;"
                " the two cannot share the axis")
        if isinstance(inputs_q, FoldedQuery):
            q = self._project_q_folded(inputs_q)
        else:
            q = self.proj_q(inputs_q)
        if kv_shard is None:
            k = self.proj_k(inputs_k)
            v = self.proj_v(inputs_v)
        else:
            with using(summed_params((self.proj_k, self.proj_v), kv_shard.group)):
                k = self.proj_k(inputs_k)
                v = self.proj_v(inputs_v)
            for proj in (self.proj_k, self.proj_v):
                if proj.quant_pass == "calibrate" and proj.quant == "int8_static":
                    all_reduce_(proj.amax, kv_shard.group, torch.distributed.ReduceOp.MAX)
        heads, gathered = self.num_heads, False
        if self.tp is not None:
            if self.num_heads % self.tp.size == 0:
                heads = self.num_heads // self.tp.size  # this rank's heads
            else:  # the heads do not split: attend on all of them
                q, k, v = (gather_dim(t, -1, self.tp.group) for t in (q, k, v))
                gathered = True
        batch, q_time, _ = q.shape
        kv_time = k.shape[1]
        q = q.reshape(batch, q_time, heads, self._qk_out // self.num_heads)
        k = k.reshape(batch, kv_time, heads, self._qk_out // self.num_heads)
        v = v.reshape(batch, kv_time, heads, self._v_out // self.num_heads)
        result = multihead_attention(
            q, k, v,
            q_mask=q_mask,
            kv_mask=kv_mask,
            attention_mask=attention_mask,
            softmax_dtype=pol.softmax_dtype,
            impl=pol.attn_impl,
            flash_min_kv=pol.flash_min_kv,
            flash_min_self=pol.flash_min_self,
            flash_long_q_min_kv=pol.flash_long_q_min_kv,
            kv_logical_len=kv_logical_len,
            dropout_rate=0.0 if generator is None else self.dropout_prob,
            dropout_generator=generator,
            sp_mesh=pol.sp_mesh,
            sp_axis=pol.sp_axis,
            sp_min_kv=pol.sp_min_kv,
            sp_impl=pol.sp_impl,
            kv_shard=kv_shard,
        )
        if gathered:  # the row-parallel final takes its slice of the result
            result = scatter_dim(result, -1, self.tp.group)
        return self.final(result)


class MLP(nn.Module):
    """Dense -> GELU -> Dense -> Dropout."""

    def __init__(self, in_channels: int, out_channels: Optional[int] = None,
                 widening_factor: int = 4, init_scale: float = 1.0,
                 policy: Policy = DEFAULT, dropout_prob: float = 0.0, *, generator=None):
        super().__init__()
        g = default_generator(generator)
        self.dropout_prob = dropout_prob
        kw = dict(init=_variance_scaling(init_scale),
                  compute_dtype=policy.compute_dtype, generator=g, quant=quant_mode(policy))
        self.approximate = "tanh" if policy.gelu_approximate else "none"
        self.fc1 = Dense(in_channels, widening_factor * in_channels, **kw)
        self.fc2 = Dense(widening_factor * in_channels,
                         out_channels or in_channels, **kw)

    def forward(self, x, *, dropout_seed: Optional[int] = None):
        x = self.fc2(F.gelu(self.fc1(x), approximate=self.approximate))
        return _dropout(self, x, self.dropout_prob, dropout_seed, _MLP_OUT)


class SelfAttention(nn.Module):
    """Pre-LN self-attention block: x + Attn(LN1(x)); x + MLP(LN2(x))."""

    def __init__(self, in_channels: int, widening_factor: int = 4,
                 num_heads: int = 8, att_init_scale: float = 1.0,
                 dense_init_scale: float = 1.0,
                 qk_channels: Optional[int] = None,
                 v_channels: Optional[int] = None,
                 policy: Policy = DEFAULT, dropout_prob: float = 0.0,
                 dropout_attn_prob: float = 0.0, *, generator=None):
        super().__init__()
        g = default_generator(generator)
        qk_channels = qk_channels or in_channels
        v_channels = v_channels or qk_channels
        self.policy = policy
        self.dropout_prob = dropout_prob
        self.attention = Attention(
            q_in_channels=in_channels, k_in_channels=in_channels,
            v_in_channels=in_channels, num_heads=num_heads,
            init_scale=att_init_scale, qk_out_channels=qk_channels,
            v_out_channels=v_channels, policy=policy, dropout_prob=dropout_attn_prob,
            generator=g,
        )
        self.mlp = MLP(in_channels=v_channels, widening_factor=widening_factor,
                       init_scale=dense_init_scale, policy=policy,
                       dropout_prob=dropout_prob, generator=g)
        self.layer_norm1 = LayerNorm(in_channels)
        self.layer_norm2 = LayerNorm(v_channels)

    def forward(self, inputs, *, attention_mask=None, q_mask=None, kv_mask=None,
                dropout_seed: Optional[int] = None):
        compute_dtype = self.policy.compute_dtype or inputs.dtype
        qkv = self.layer_norm1(inputs).to(compute_dtype)
        attention = self.attention(qkv, qkv, qkv, attention_mask=attention_mask,
                                   q_mask=q_mask, kv_mask=kv_mask, dropout_seed=dropout_seed)
        x = inputs + _dropout(self, attention, self.dropout_prob, dropout_seed, _POST_ATTN)
        return x + self.mlp(self.layer_norm2(x).to(compute_dtype), dropout_seed=dropout_seed)


class CrossAttention(nn.Module):
    """Cross-attention block with optional query residual."""

    def __init__(self, q_in_channels: int, kv_in_channels: int,
                 widening_factor: int = 1, num_heads: int = 8,
                 attn_init_scale: float = 1.0, mlp_init_scale: float = 1.0,
                 shape_for_attn: str = "kv", use_query_residual: bool = True,
                 qk_channels: Optional[int] = None,
                 v_channels: Optional[int] = None,
                 policy: Policy = DEFAULT, dropout_prob: float = 0.0,
                 dropout_attn_prob: float = 0.0, *, generator=None):
        super().__init__()
        g = default_generator(generator)
        self.dropout_prob = dropout_prob
        if qk_channels is None:
            if shape_for_attn == "q":
                qk_channels = q_in_channels
            elif shape_for_attn == "kv":
                qk_channels = kv_in_channels
            else:
                raise ValueError(
                    f"Unknown value {shape_for_attn} for shape_for_attention."
                )
        v_channels = v_channels or qk_channels
        # A cross-attention block is a "cross" quant site: under
        # quant_scope="latent" its projections keep the exact product.
        if policy.quant is not None and not quant_enabled(policy, site="cross"):
            policy = dataclasses.replace(policy, quant=None)
        self.policy = policy
        self.use_query_residual = use_query_residual
        self.attention = Attention(
            q_in_channels=q_in_channels, k_in_channels=kv_in_channels,
            v_in_channels=kv_in_channels, num_heads=num_heads,
            init_scale=attn_init_scale, qk_out_channels=qk_channels,
            v_out_channels=v_channels, output_channels=q_in_channels,
            policy=policy, dropout_prob=dropout_attn_prob, generator=g,
        )
        self.mlp = MLP(in_channels=q_in_channels, widening_factor=widening_factor,
                       init_scale=mlp_init_scale, policy=policy,
                       dropout_prob=dropout_prob, generator=g)
        self.layer_norm_q = LayerNorm(q_in_channels)
        self.layer_norm_kv = LayerNorm(kv_in_channels)
        self.layer_norm2 = LayerNorm(q_in_channels)

    def forward(self, inputs_q, inputs_kv, *, attention_mask=None, q_mask=None,
                kv_mask=None, kv_logical_len: Optional[int] = None,
                dropout_seed: Optional[int] = None, kv_shard=None):
        """``kv_shard``: the mesh axis that ``inputs_kv`` and ``kv_mask``
        are this rank's tokens of (see the module docstring)."""
        folded = isinstance(inputs_q, FoldedQuery)
        compute_dtype = self.policy.compute_dtype or (
            inputs_q.parts[0][0].dtype if folded else inputs_q.dtype)
        if kv_shard is None:
            kv = self.layer_norm_kv(inputs_kv).to(compute_dtype)
        else:
            with using(summed_params((self.layer_norm_kv,), kv_shard.group)):
                kv = self.layer_norm_kv(inputs_kv).to(compute_dtype)
        if folded:
            if self.use_query_residual:
                raise ValueError(
                    "FoldedQuery requires use_query_residual=False (the padded query is"
                    " never materialised)."
                )
            # Attention folds the query LayerNorm through its Q projection.
            q = inputs_q._replace(ln_scale=self.layer_norm_q.weight,
                                  ln_bias=self.layer_norm_q.bias)
        else:
            q = self.layer_norm_q(inputs_q).to(compute_dtype)
        attention = self.attention(
            q, kv, kv, attention_mask=attention_mask, q_mask=q_mask,
            kv_mask=kv_mask, kv_logical_len=kv_logical_len, dropout_seed=dropout_seed,
            kv_shard=kv_shard,
        )
        attention = _dropout(self, attention, self.dropout_prob, dropout_seed, _POST_ATTN)
        # No residual when query and output semantics differ (e.g. queries
        # are positions, outputs are pixels).
        x = inputs_q + attention if self.use_query_residual else attention
        return x + self.mlp(self.layer_norm2(x).to(compute_dtype), dropout_seed=dropout_seed)
