"""Training objectives of the ported slices.

Counterpart of ``perceiverio_pytorch_tpu/training/losses.py``: the byte
MLM's ``masked_token_cross_entropy``, ImageNet's
``classification_cross_entropy``, flow's ``flow_endpoint_error`` and the
multimodal autoencoder's ``multimodal_autoencode_loss``.  Every
cross-entropy is taken in fp32, whatever the logits' dtype (the JAX package
takes it in the logits' dtype).

Inside the train step or evaluation of a mesh whose data axis has D > 1
ranks (``parallel.collectives.global_batch``), each rank holds its rows of
the global batch, and the step averages the ranks' losses.  A plain mean
over the rows is then the global one, but a masked mean is not: its
denominator differs per rank.  Each masked mean therefore returns D times
its local sum over the global count (all-reduced, with no gradient through
it), so that the ranks' average is the global masked mean, as GSPMD
computes it.  With no mesh, or D = 1, the code path and the bits are the
single-device ones.
"""

from __future__ import annotations

from typing import Mapping, Optional

import torch
import torch.nn.functional as F

from perceiverio_pytorch_tpu_torch.parallel import collectives as cc


def _masked_mean(total: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    """``total / max(count, 1)`` over the global batch (see the module
    docstring)."""
    group = cc.data_group()
    if group is None:
        return total / torch.clamp(count, min=1)
    count = cc.all_reduce_(count.detach().clone(), group)
    return total * cc.size(group) / torch.clamp(count, min=1)


def masked_token_cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                               loss_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Byte-MLM objective: the mean softmax cross-entropy of logits [B, T, V]
    against integer targets [B, T], over the positions where ``loss_mask``
    [B, T] is 1 (all of them without a mask), divided by their count, at
    least one."""
    ce = F.cross_entropy(logits.float().flatten(0, -2), targets.long().flatten(),
                         reduction="none").view(targets.shape)
    if loss_mask is None:
        return ce.mean()
    loss_mask = loss_mask.to(ce.dtype)
    return _masked_mean((ce * loss_mask).sum(), loss_mask.sum())


def classification_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                                 label_smoothing: float = 0.0) -> torch.Tensor:
    """ImageNet objective: the mean softmax cross-entropy of logits [B, C]
    against integer labels [B], the one-hot targets smoothed to
    ``(1 - label_smoothing) * onehot + label_smoothing / C``."""
    return F.cross_entropy(logits.float(), labels.long(), label_smoothing=label_smoothing)


def flow_endpoint_error(pred_flow: torch.Tensor, gt_flow: torch.Tensor,
                        valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean endpoint error over [B, 2, H, W] flow fields.

    ``valid``: optional [B, H, W] weights (1 = count); the mean is then taken
    over the valid pixels, at least one.
    """
    epe = torch.sqrt(torch.sum((pred_flow - gt_flow) ** 2, dim=1) + 1e-12)
    if valid is None:
        return epe.mean()
    valid = valid.to(epe.dtype)
    return _masked_mean((epe * valid).sum(), valid.sum())


def multimodal_autoencode_loss(outputs: Mapping[str, torch.Tensor],
                               targets: Mapping[str, torch.Tensor],
                               weights: Optional[Mapping[str, float]] = None) -> torch.Tensor:
    """Weighted sum of the per-modality losses of the multimodal autoencoder.

    The mean squared error of "image" and of "audio", and for "label" the
    softmax cross-entropy (in fp32) of the logits [B, num_classes] against
    integer targets [B], summed over the labelled examples (target >= 0; -1
    means unlabelled) and divided by their count, at least one.  ``weights``
    multiplies each term; a modality it does not name weighs 1.0.  Each term
    is taken only for a modality that ``outputs`` holds.
    """
    weights = dict(weights or {})
    total = 0.0
    for modality in ("image", "audio"):
        if modality in outputs:
            err = (outputs[modality] - targets[modality]) ** 2
            total = total + weights.get(modality, 1.0) * err.mean()
    if "label" in outputs:
        labels = targets["label"].long()
        valid = labels >= 0
        ce = F.cross_entropy(outputs["label"].float(), labels.clamp(min=0), reduction="none")
        label_loss = _masked_mean(torch.where(valid, ce, torch.zeros_like(ce)).sum(), valid.sum())
        total = total + weights.get("label", 1.0) * label_loss
    return total
