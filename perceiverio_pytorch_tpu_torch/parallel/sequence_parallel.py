"""Sequence-parallel (KV-sharded) attention on ``torch.distributed``.

Counterpart of ``perceiverio_pytorch_tpu/parallel/sequence_parallel.py``.
The Perceiver's one long axis is its input: the encoder cross-attends a few
hundred latents against up to 182,528 tokens.  Here the key/value token
axis is split over one mesh axis; each rank holds Tk/n keys, and the global
softmax is rebuilt from reductions over the axis, so that the traffic is
O(Tq x Dv) a rank, whatever the token count.  The queries (the latents) are
replicated over the axis, and so is the result.

Two routes, the JAX package's:

  * ``"flash"`` (ring attention, JAX ``_ring_flash_merge`` and
    ``_make_ring_flash``): K1 with its lse on the local keys
    (``ops.flash_attention.flash_attention(return_lse=True)``), then
    ``lse_merge`` over the axis (one MAX and two SUMs).  Its backward runs
    K2 and K3 on the local keys with the merged output and the global lse,
    so that each shard's dK and dV are exact, and sums the partial dQ over
    the axis;
  * ``"dense"`` (JAX ``_local_attend``, "xla" there): fp32 local logits, a
    MAX of the row maxima (no gradient: the shift cancels), SUMs of the
    numerator and the denominator.

A rank's loss is replicated over the axis, so each collective's backward
goes the other way from its forward: the numerator's and denominator's SUMs
take ``reduce_from`` (identity backward), the replicated q enters through
``copy_to`` (its partial gradients summed), and whole k/v sliced by rank go
through ``scatter_dim`` (their gradients gathered).

``sequence_parallel_attention`` takes whole k/v, pads a token count the
axis does not divide with masked keys and slices this rank's keys;
``sequence_parallel_attention_local`` takes this rank's keys as they are
(``PerceiverIO(input_token_sharding=...)``).  The JAX function's
``block_q``, ``block_k``, ``interpret`` and ``backend`` have no meaning
here.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

from perceiverio_pytorch_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_backward,
)
from perceiverio_pytorch_tpu_torch.parallel import collectives as cc
from perceiverio_pytorch_tpu_torch.parallel.mesh import MODEL_AXIS, axis

__all__ = ["lse_merge", "pad_tokens", "sequence_parallel_attention",
           "sequence_parallel_attention_local", "sp_route"]

SP_IMPLS = ("dense", "flash", "auto")


def lse_merge(out: torch.Tensor, lse: torch.Tensor, reduce_max: Callable,
              reduce_sum: Callable):
    """The softmax over every key shard, from each shard's own.

    Args:
      out: a shard's locally normalised output, [..., Tq, H, Dv].
      lse: its log-sum-exp, [..., H, Tq], +inf on rows whose keys in the
        shard are all masked (K1's convention).
      reduce_max, reduce_sum: the MAX and the SUM over the shards of a
        tensor shaped as the argument (they may reduce in place): all-reduces
        over the mesh axis in the ring, reductions over a stacked leading dim
        in one process.

    Returns:
      (out, lse) over all shards in fp32: out = sum_i out_i w_i / sum_i w_i
      with w_i = exp(lse_i - max_j lse_j); a row whose keys are all masked
      comes out exactly 0, with lse +inf.
    """
    lse = lse.float()
    lse = torch.where(torch.isinf(lse), torch.full_like(lse, -math.inf), lse)
    m = reduce_max(lse.clone())
    m_safe = torch.where(m == -math.inf, torch.zeros_like(m), m)
    w = torch.exp(lse - m_safe)  # a shard with all keys masked: weight 0
    sum_w = reduce_sum(w.clone())
    numer = reduce_sum(out.float() * w.transpose(-1, -2)[..., None])
    sum_w_safe = torch.where(sum_w == 0, torch.ones_like(sum_w), sum_w)
    merged = numer / sum_w_safe.transpose(-1, -2)[..., None]
    lse_g = torch.where(sum_w == 0, torch.full_like(sum_w, math.inf),
                        m_safe + torch.log(sum_w_safe))
    return merged, lse_g


def pad_tokens(tensors, mask: Optional[torch.Tensor], multiple: int):
    """``tensors`` ([B, T, ...] each) padded with zeros along T to a multiple
    of ``multiple``, and the [B, T'] mask with the pad masked out (``mask``
    as it is when nothing is padded)."""
    b, t = tensors[0].shape[:2]
    pad = (-t) % multiple
    if not pad:
        return tensors, mask
    tensors = [F.pad(x, (0, 0) * (x.dim() - 2) + (0, pad)) for x in tensors]
    if mask is None:
        mask = (torch.arange(t + pad, device=tensors[0].device) < t).expand(b, t + pad)
    else:
        mask = F.pad(mask.bool(), (0, pad))
    return tensors, mask


def _all_reduce(group, op):
    return lambda t: cc.all_reduce_(t, group, op)


class _RingFlash(torch.autograd.Function):
    """Counterpart of ``_make_ring_flash``: K1 with its lse on this rank's
    keys and the merge over the axis forward; K2 and K3 on the keys with the
    merged output and the global lse backward, dQ summed over the axis."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask, group, softmax_scale):
        b, tq, h, _ = q.shape
        dv = v.shape[3]
        out, lse = flash_attention(q, k, v, kv_mask=kv_mask, softmax_scale=softmax_scale,
                                   return_lse=True)
        merged, lse_g = lse_merge(out.view(b, tq, h, dv), lse,
                                  _all_reduce(group, dist.ReduceOp.MAX),
                                  _all_reduce(group, dist.ReduceOp.SUM))
        out = merged.reshape(b, tq, h * dv).to(q.dtype)
        ctx.save_for_backward(q, k, v, kv_mask, out, lse_g)
        ctx.group, ctx.softmax_scale = group, softmax_scale
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable  # the kernels have no backward
    def backward(ctx, grad_out):
        q, k, v, kv_mask, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(
            q, k, v, out, lse, grad_out.contiguous(), kv_mask=kv_mask,
            softmax_scale=ctx.softmax_scale)
        return cc.all_reduce_(dq.contiguous(), ctx.group), dk, dv, None, None, None


def _local_attend(q, k, v, kv_mask, group, softmax_scale):
    """Counterpart of ``_local_attend``: this rank's keys, the statistics
    reduced over the axis.  q enters replicated (``copy_to``)."""
    q = cc.copy_to(q, group)
    b, tq, h, d = q.shape
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(d)
    s = torch.einsum("bthd,bshd->bhts", q, k).float() * scale
    if kv_mask is not None:
        s = s.masked_fill(~kv_mask.bool()[:, None, None, :], -math.inf)
    # The max shift cancels in numerator / denominator: no gradient.
    with torch.no_grad():
        m = cc.all_reduce_(s.amax(dim=-1, keepdim=True), group, dist.ReduceOp.MAX)
        m = torch.where(m == -math.inf, torch.zeros_like(m), m)
    p = torch.exp(s - m)  # masked logits contribute exactly 0
    numer = torch.einsum("bhts,bshd->bthd", p.to(v.dtype), v).float()
    numer = cc.reduce_from(numer, group)
    denom = cc.reduce_from(p.sum(dim=-1), group).transpose(1, 2)[..., None]  # [B, Tq, H, 1]
    out = numer / torch.where(denom == 0, torch.ones_like(denom), denom)  # wiped rows: 0
    return out.reshape(b, tq, h * v.shape[3])


def sp_route(impl: str, *, local_kv: int, on_cuda: bool, flash_min_shard: int = 8192) -> str:
    """The route ``impl`` takes: ``"flash"`` when asked, or under "auto" on
    a CUDA tensor whose local shard holds at least ``flash_min_shard`` keys;
    else ``"dense"``."""
    if impl not in SP_IMPLS:
        raise ValueError(f"impl must be 'dense', 'flash' or 'auto'; got {impl!r}")
    if impl == "flash" or (impl == "auto" and on_cuda and local_kv >= flash_min_shard):
        return "flash"
    return "dense"


def sequence_parallel_attention_local(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    group,
    *,
    kv_mask: Optional[torch.Tensor] = None,
    out_dtype: Optional[torch.dtype] = None,
    impl: str = "auto",
    flash_min_shard: int = 8192,
    softmax_scale: Optional[float] = None,
) -> torch.Tensor:
    """Attention of replicated queries over keys split across ``group``.

    Args:
      q: [B, Tq, H, Dqk], the same on every rank of ``group``.
      k, v: this rank's keys and values, [B, Tk/n, H, D*].
      group: the process group of the mesh axis the keys are split over.
      kv_mask: optional [B, Tk/n], this rank's piece of the key mask.
      impl, flash_min_shard: the route (``sp_route``).

    Returns:
      [B, Tq, H*Dv] in ``out_dtype`` (default q's), the same on every rank.
    """
    route = sp_route(impl, local_kv=k.shape[1], on_cuda=q.is_cuda,
                     flash_min_shard=flash_min_shard)
    if route == "flash":
        out = _RingFlash.apply(q, k, v, kv_mask, group, softmax_scale)
    else:
        out = _local_attend(q, k, v, kv_mask, group, softmax_scale)
    return out.to(out_dtype or q.dtype)


def sequence_parallel_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mesh,
    *,
    kv_mask: Optional[torch.Tensor] = None,
    axis_name: str = MODEL_AXIS,
    out_dtype: Optional[torch.dtype] = None,
    impl: str = "auto",
    flash_min_shard: int = 8192,
    softmax_scale: Optional[float] = None,
) -> torch.Tensor:
    """Cross-attention with the key/value token axis split over
    ``axis_name`` of ``mesh``.

    Args:
      q: [B, Tq, H, Dqk], replicated over the axis.
      k, v: [B, Tk, H, D*], whole and replicated over the axis; any Tk: a
        count the axis does not divide is padded with masked keys, which
        add exactly 0 to the softmax.
      kv_mask: optional [B, Tk] validity mask.
      impl: "dense", "flash" or "auto" (``sp_route``; the JAX package names
        the dense route "xla").

    Returns:
      [B, Tq, H*Dv], replicated.
    """
    if impl not in SP_IMPLS:
        raise ValueError(f"impl must be 'dense', 'flash' or 'auto'; got {impl!r}")
    ax = axis(mesh, axis_name)
    (k, v), kv_mask = pad_tokens((k, v), kv_mask, ax.size)
    k = cc.scatter_dim(k, 1, ax.group)
    v = cc.scatter_dim(v, 1, ax.group)
    if kv_mask is not None:
        kv_mask = cc.local_piece(kv_mask, 1, ax.group).contiguous()
    return sequence_parallel_attention_local(
        q, k, v, ax.group, kv_mask=kv_mask, out_dtype=out_dtype, impl=impl,
        flash_min_shard=flash_min_shard, softmax_scale=softmax_scale)
