"""Attention dispatch: the dense path or the flash kernel.

Counterpart of ``perceiverio_pytorch_tpu/ops/attention.py`` with the same
rule and thresholds.  Every attention site of a Perceiver goes through
``multihead_attention``:

  * ``dense`` -- ops.attention_dense.attend_dense, which materialises the
    [B,H,Tq,Tk] matrix;
  * ``flash`` -- ops.flash_attention.flash_attention: the CUDA kernel on a
    CUDA tensor, its plain chunked version on a CPU tensor;
  * ``auto``  -- flash on a CUDA tensor at long lengths, else dense.  Where
    the JAX rule asks "is this a TPU", this one asks "is q on a CUDA device";
  * ``sp``    -- ahead of both, under ``Policy.sp_mesh``: a site with at
    least ``sp_min_kv`` keys and no pre-built mask, bias, dropout or
    returned matrix splits its keys over the mesh axis
    (``parallel.sequence_parallel_attention``, route ``sp_impl``); a site
    whose keys are split already (``kv_shard``: the encoder under
    ``PerceiverIO(input_token_sharding=...)``) always takes it.

Masks travel in factored [B,Tq] x [B,Tk] form; a pre-built rank-3
``attention_mask`` (or a bias, a ``dropout_rate`` above 0, or
``return_matrix``) forces the dense path, as in the JAX package: a site with
attention dropout runs dense on the card too, its mask drawn from the
caller's ``dropout_generator``.
"""

from __future__ import annotations

from typing import Optional

import torch

from perceiverio_pytorch_tpu_torch.ops.attention_dense import (
    attend_dense,
    make_cross_attention_mask,
)
from perceiverio_pytorch_tpu_torch.ops.flash_attention import flash_attention


def attention_path(
    impl: str,
    *,
    q_len: int,
    kv_len: int,
    on_cuda: bool,
    flash_min_kv: int = 8192,
    flash_min_self: int = 2048,
    flash_long_q_min_kv: int = 1024,
    attention_mask=None,
    attention_bias=None,
    dropout_rate: float = 0.0,
    return_matrix: bool = False,
    sp_mesh=None,
    sp_min_kv: int = 32768,
) -> str:
    """Which implementation ``multihead_attention`` dispatches to:
    ``"sp"``, ``"flash"`` or ``"dense"``."""
    if (
        sp_mesh is not None
        and attention_mask is None
        and attention_bias is None
        and dropout_rate == 0.0
        and not return_matrix
        and kv_len >= sp_min_kv
    ):
        return "sp"
    if _flash_eligible(
        impl,
        q_len=q_len,
        kv_len=kv_len,
        on_cuda=on_cuda,
        flash_min_kv=flash_min_kv,
        flash_min_self=flash_min_self,
        flash_long_q_min_kv=flash_long_q_min_kv,
        attention_mask=attention_mask,
        attention_bias=attention_bias,
        dropout_rate=dropout_rate,
        return_matrix=return_matrix,
    ):
        return "flash"
    return "dense"


def _flash_eligible(
    impl: str,
    *,
    q_len: int,
    kv_len: int,
    on_cuda: bool,
    flash_min_kv: int,
    flash_min_self: int,
    flash_long_q_min_kv: int,
    attention_mask,
    attention_bias,
    dropout_rate: float,
    return_matrix: bool,
) -> bool:
    if impl == "dense":
        return False
    if attention_mask is not None or attention_bias is not None:
        return False
    if dropout_rate > 0.0 or return_matrix:
        return False
    if impl == "flash":
        return True
    # "auto" takes the kernel only where it runs: on a CUDA tensor.
    if not on_cuda:
        return False
    # The JAX package's thresholds: long self-attention, long KV (encoder
    # cross-attend), or long Q against a non-trivial KV (decoder).
    if q_len == kv_len and q_len >= flash_min_self:
        return True
    return kv_len >= flash_min_kv or (
        q_len >= flash_min_kv and kv_len >= flash_long_q_min_kv
    )


def multihead_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    q_mask: Optional[torch.Tensor] = None,
    kv_mask: Optional[torch.Tensor] = None,
    attention_mask: Optional[torch.Tensor] = None,
    attention_bias: Optional[torch.Tensor] = None,
    softmax_dtype: torch.dtype = torch.float32,
    impl: str = "auto",
    flash_min_kv: int = 8192,
    flash_min_self: int = 2048,
    flash_long_q_min_kv: int = 1024,
    dropout_rate: float = 0.0,
    dropout_generator: Optional[torch.Generator] = None,
    return_matrix: bool = False,
    softmax_scale: Optional[float] = None,
    kv_logical_len: Optional[int] = None,
    sp_mesh=None,
    sp_axis: str = "model",
    sp_min_kv: int = 32768,
    sp_impl: str = "auto",
    kv_shard=None,
):
    """Multi-head attention over [B, T, H, D] tensors.

    Args:
      q, k, v: [B,Tq,H,Dqk], [B,Tk,H,Dqk], [B,Tk,H,Dv].
      q_mask: optional [B,Tq] bool; invalid query rows are wiped to zero.
      kv_mask: optional [B,Tk] bool; invalid keys are excluded from softmax.
      attention_mask: optional pre-built [B,Tq,Tk] mask (forces dense).
      dropout_rate: post-softmax dropout; above 0 it forces the dense path
        and needs ``dropout_generator``, which draws the mask.
      kv_logical_len: keys at or beyond this index are masked.
      sp_mesh, sp_axis, sp_min_kv, sp_impl: ``Policy``'s sequence-parallel
        fields (the ``"sp"`` path).
      kv_shard: the mesh axis (``parallel.mesh.Axis``) that k, v and kv_mask
        are this rank's piece of; the site then runs
        ``sequence_parallel_attention_local`` over it.

    Returns:
      [B, Tq, H*Dv] (plus the attention matrix when return_matrix=True).
    """
    kv_len = k.shape[1]
    path = attention_path(
        impl,
        q_len=q.shape[1],
        kv_len=kv_len,
        on_cuda=q.is_cuda,
        flash_min_kv=flash_min_kv,
        flash_min_self=flash_min_self,
        flash_long_q_min_kv=flash_long_q_min_kv,
        attention_mask=attention_mask,
        attention_bias=attention_bias,
        dropout_rate=dropout_rate,
        return_matrix=return_matrix,
        sp_mesh=sp_mesh,
        sp_min_kv=sp_min_kv,
    )
    if kv_shard is not None:
        if (attention_mask is not None or attention_bias is not None or dropout_rate > 0.0
                or return_matrix or kv_logical_len is not None):
            raise ValueError(
                "keys split over a mesh axis (kv_shard) take the sequence-parallel path"
                " only: no attention_mask, bias, dropout, returned matrix or"
                " kv_logical_len")
        path = "sp"
    if path == "flash":
        return flash_attention(
            q, k, v, q_mask=q_mask, kv_mask=kv_mask,
            softmax_scale=softmax_scale, kv_logical_len=kv_logical_len,
        )

    if kv_logical_len is not None and kv_logical_len < kv_len:
        tail = torch.arange(kv_len, device=k.device) < kv_logical_len
        tail = tail[None, :].expand(k.shape[0], kv_len)
        kv_mask = tail if kv_mask is None else (kv_mask.bool() & tail)

    if path == "sp":
        from perceiverio_pytorch_tpu_torch.parallel import sequence_parallel as sp

        if kv_shard is not None:
            out = sp.sequence_parallel_attention_local(
                q, k, v, kv_shard.group, kv_mask=kv_mask, impl=sp_impl,
                softmax_scale=softmax_scale)
        else:
            out = sp.sequence_parallel_attention(
                q, k, v, sp_mesh, kv_mask=kv_mask, axis_name=sp_axis, impl=sp_impl,
                softmax_scale=softmax_scale)
        if q_mask is not None:
            out = out.masked_fill(~q_mask.bool()[:, :, None], 0.0)
        return out

    if q_mask is not None or kv_mask is not None:
        batch = q.shape[0]
        qm = q_mask if q_mask is not None else torch.ones(
            (batch, q.shape[1]), dtype=torch.bool, device=q.device)
        km = kv_mask if kv_mask is not None else torch.ones(
            (batch, kv_len), dtype=torch.bool, device=q.device)
        factored = make_cross_attention_mask(qm, km)
        attention_mask = (
            factored if attention_mask is None
            else (attention_mask.bool() & factored)
        )

    return attend_dense(
        q, k, v,
        attention_mask=attention_mask,
        attention_bias=attention_bias,
        softmax_dtype=softmax_dtype,
        return_matrix=return_matrix,
        softmax_scale=softmax_scale,
        dropout_rate=dropout_rate,
        dropout_generator=dropout_generator,
    )
