"""Multi-head attention as plain matmul + softmax (materialises [B,H,Tq,Tk]).

Counterpart of ``perceiverio_pytorch_tpu/ops/attention_xla.py``, with the
same numerical contract:
  * the scale ``1/sqrt(qk_head_dim)`` is applied AFTER the QK^T matmul;
  * masked logits are filled with -1e30 (-1e4 in fp16);
  * the softmax runs in ``softmax_dtype`` and is cast back to v's dtype;
  * post-softmax dropout keeps an entry with probability ``1 - rate`` and
    scales it by ``1 / (1 - rate)`` (``where(keep, p / (1 - rate), 0)``);
  * query rows whose mask is all false are wiped to exactly 0.

``dropout`` is the same rule on any tensor (flax ``nn.Dropout``).  Its
draws come from a ``torch.Generator``: ``site_generator`` makes one from a
seed and a site index, so that a dropout site inside a checkpointed region
draws the same mask when the backward recomputes it.  The bits cannot be
JAX's; ``keep_mask`` is the one place they are drawn.
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


def mix_seed(seed: int, index: int) -> int:
    """A seed for sub-site ``index`` of the site seeded with ``seed``."""
    return (seed * 1_000_003 + index) % 2**63


def site_generator(seed: int, index: int, device) -> torch.Generator:
    """The generator of dropout sub-site ``index`` of a site seeded with
    ``seed``, on ``device``: the same seed gives the same draws."""
    return torch.Generator(device=device).manual_seed(mix_seed(seed, index))


def keep_mask(shape, keep_prob: float, generator: torch.Generator,
              device) -> torch.Tensor:
    """Bernoulli(``keep_prob``) booleans: uniform draws below ``keep_prob``,
    ``jax.random.bernoulli``'s rule."""
    return torch.rand(shape, generator=generator, device=device) < keep_prob


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """``where(keep, x / (1 - rate), 0)`` with ``keep`` drawn from
    ``generator``; ``x`` itself when ``rate`` is 0."""
    if rate <= 0.0:
        return x
    if generator is None:
        raise ValueError("a generator is required when the dropout rate is above 0")
    if rate >= 1.0:  # flax's edge case: no 0 / 0 in the gradient
        return torch.zeros_like(x)
    keep_prob = 1.0 - rate
    keep = keep_mask(x.shape, keep_prob, generator, x.device)
    return torch.where(keep, x / keep_prob, torch.zeros((), dtype=x.dtype, device=x.device))


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
    dropout_rate: float = 0.0,
    dropout_generator: Optional[torch.Generator] = None,
):
    """Multi-head attention.

    Args:
      q: [B, Tq, H, Dqk]; k: [B, Tk, H, Dqk]; v: [B, Tk, H, Dv].
      attention_mask: optional [B, Tq, Tk] boolean validity mask.
      attention_bias: optional bias broadcastable to [B, H, Tq, Tk], added to
        the raw (pre-scale) logits.
      softmax_dtype: accumulation dtype of the softmax.
      softmax_scale: logit scale; defaults to 1/sqrt(Dqk).
      dropout_rate / dropout_generator: post-softmax dropout, drawn from
        the generator (required when the rate is above 0).

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
    normalized = dropout(normalized, dropout_rate, dropout_generator)
    summed = torch.einsum("bhts,bshd->bthd", normalized, v)
    summed = summed.reshape(batch, q_len, num_heads * v_head_dim)

    if attention_mask is not None:
        wipe = ~attention_mask.bool().any(dim=2, keepdim=True)  # [B, Tq, 1]
        summed = summed.masked_fill(wipe, 0.0)

    if return_matrix:
        return normalized, summed
    return summed
