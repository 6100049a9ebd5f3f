"""Training objectives of the ported slices.

Counterpart of ``perceiverio_pytorch_tpu/training/losses.py``; the flow
slice needs only ``flow_endpoint_error``.  The language, classification
and multimodal losses come with their slices.
"""

from __future__ import annotations

from typing import Optional

import torch


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
    return (epe * valid).sum() / torch.clamp(valid.sum(), min=1.0)
