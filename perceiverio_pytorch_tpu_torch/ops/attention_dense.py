"""Multi-head attention as plain matmul + softmax (materialises [B,H,Tq,Tk]).

Counterpart of ``perceiverio_pytorch_tpu/ops/attention_xla.py``, with the
same numerical contract:
  * the scale ``1/sqrt(qk_head_dim)`` is applied AFTER the QK^T matmul;
  * masked logits are filled with -1e30 (-1e4 in fp16);
  * the softmax runs in ``softmax_dtype`` and is cast back to v's dtype;
  * query rows whose mask is all false are wiped to exactly 0.
"""

from __future__ import annotations

import math
from typing import Optional

import torch


def make_cross_attention_mask(
    query_mask: torch.Tensor, kv_mask: torch.Tensor
) -> torch.Tensor:
    """[B,Q] x [B,K] -> [B,Q,K] outer-product boolean mask."""
    return query_mask[:, :, None].bool() & kv_mask[:, None, :].bool()


def _mask_fill_value(dtype: torch.dtype) -> float:
    return 1e4 if dtype == torch.float16 else 1e30


def attend_dense(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    attention_mask: Optional[torch.Tensor] = None,
    attention_bias: Optional[torch.Tensor] = None,
    softmax_dtype: torch.dtype = torch.float32,
    return_matrix: bool = False,
    softmax_scale: Optional[float] = None,
):
    """Multi-head attention.

    Args:
      q: [B, Tq, H, Dqk]; k: [B, Tk, H, Dqk]; v: [B, Tk, H, Dv].
      attention_mask: optional [B, Tq, Tk] boolean validity mask.
      attention_bias: optional bias broadcastable to [B, H, Tq, Tk], added to
        the raw (pre-scale) logits.
      softmax_dtype: accumulation dtype of the softmax.
      softmax_scale: logit scale; defaults to 1/sqrt(Dqk).

    Returns:
      [B, Tq, H*Dv] (and the [B, H, Tq, Tk] matrix if return_matrix).
    """
    batch, q_len, num_heads, qk_head_dim = q.shape
    v_head_dim = v.shape[-1]

    attention = torch.einsum("bthd,bshd->bhts", q, k)
    if attention_bias is not None:
        attention = attention + attention_bias
    attention = attention * (
        softmax_scale if softmax_scale is not None
        else 1.0 / math.sqrt(qk_head_dim)
    )
    if attention_mask is not None:
        attention = attention.masked_fill(
            ~attention_mask.bool()[:, None, :, :],
            -_mask_fill_value(attention.dtype),
        )

    normalized = torch.softmax(attention.to(softmax_dtype), dim=-1).to(v.dtype)
    summed = torch.einsum("bhts,bshd->bthd", normalized, v)
    summed = summed.reshape(batch, q_len, num_heads * v_head_dim)

    if attention_mask is not None:
        wipe = ~attention_mask.bool().any(dim=2, keepdim=True)  # [B, Tq, 1]
        summed = summed.masked_fill(wipe, 0.0)

    if return_matrix:
        return normalized, summed
    return summed
