"""Middlebury ``.flo`` optical-flow files and the flow evaluation numbers.

A numpy-only copy of ``perceiverio_pytorch_tpu/utils/flow_io.py``.  The
``.flo`` layout: a float32 sanity tag 202021.25 ("PIEH"), int32 width, int32
height, then ``h*w*2`` float32 (u, v) interleaved row-major.
``flow_error_stats`` gives the mean endpoint error (AEPE), the 1/3/5-px
accuracies and the Fl outlier fraction of the Sintel and KITTI tables.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

_TAG = 202021.25

__all__ = ["read_flo", "write_flo", "flow_error_stats"]


def read_flo(path: str) -> np.ndarray:
    """Read a .flo file -> float32 [2, H, W] (u first, the reference layout)."""
    with open(path, "rb") as f:
        tag = np.frombuffer(f.read(4), np.float32)[0]
        if not np.isclose(tag, _TAG):
            raise ValueError(f"{path!r} is not a .flo file (tag {tag!r} != {_TAG})")
        w, h = np.frombuffer(f.read(8), np.int32)
        if w <= 0 or h <= 0 or w * h > 10**9:
            raise ValueError(f"{path!r}: implausible size {w}x{h}")
        data = np.frombuffer(f.read(int(w) * int(h) * 2 * 4), np.float32)
        if data.size != w * h * 2:
            raise ValueError(f"{path!r}: truncated ({data.size} floats)")
    return np.transpose(data.reshape(int(h), int(w), 2), (2, 0, 1)).copy()


def write_flo(path: str, flow: np.ndarray) -> None:
    """Write float32 [2, H, W] (or [H, W, 2]) as a .flo file."""
    flow = np.asarray(flow, np.float32)
    if flow.ndim != 3:
        raise ValueError(f"flow must be rank 3; got {flow.shape}")
    if flow.shape[0] == 2 and flow.shape[-1] != 2:
        flow = np.transpose(flow, (1, 2, 0))
    if flow.shape[-1] != 2:
        raise ValueError(f"flow must have a 2-channel axis; got {flow.shape}")
    h, w = flow.shape[:2]
    with open(path, "wb") as f:
        f.write(np.float32(_TAG).tobytes())
        f.write(np.asarray([w, h], np.int32).tobytes())
        f.write(np.ascontiguousarray(flow).tobytes())


def flow_error_stats(pred: np.ndarray, gt: np.ndarray,
                     valid: Optional[np.ndarray] = None) -> Dict[str, float]:
    """AEPE, the 1/3/5-px accuracy fractions, the KITTI Fl outlier fraction
    (EPE > 3 px and > 5% of the ground truth's magnitude) and the pixel count
    of [2, H, W] fields; ``valid`` is an optional [H, W] mask of the pixels
    scored."""
    pred = np.asarray(pred, np.float64)
    gt = np.asarray(gt, np.float64)
    if pred.shape != gt.shape:
        raise ValueError(f"shape mismatch: pred {pred.shape} vs gt {gt.shape}")
    epe = np.sqrt(((pred - gt) ** 2).sum(axis=0))
    mag = np.sqrt((gt ** 2).sum(axis=0))
    if valid is not None:
        valid = np.asarray(valid, bool)
        epe, mag = epe[valid], mag[valid]
    else:
        epe, mag = epe.ravel(), mag.ravel()
    n = max(epe.size, 1)
    fl = (epe > 3.0) & (epe > 0.05 * np.maximum(mag, 1e-9))
    return {
        "aepe": float(epe.mean()) if epe.size else 0.0,
        "acc_1px": float((epe <= 1.0).sum() / n),
        "acc_3px": float((epe <= 3.0).sum() / n),
        "acc_5px": float((epe <= 5.0).sum() / n),
        "fl_outlier": float(fl.sum() / n),
        "pixels": int(epe.size),
    }
