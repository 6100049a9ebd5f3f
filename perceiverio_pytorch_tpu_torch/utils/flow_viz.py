"""Optical-flow visualisation: the Middlebury (Baker et al.) colour wheel.

A numpy copy of ``perceiverio_pytorch_tpu/utils/flow_viz.py``: the standard
colour coding of Baker et al., "A Database and Evaluation Methodology for
Optical Flow" (ICCV 2007), vectorised.  matplotlib is imported only to show
the legend (``plot_flow_legend(show=True)``) and PIL only to build the image
of ``get_error_image``, so that importing this module needs neither.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

# Segment lengths of the standard colour wheel: RY, YG, GC, CB, BM, MR.
_SEGMENTS = (
    ("R", "Y", 15),
    ("Y", "G", 6),
    ("G", "C", 4),
    ("C", "B", 11),
    ("B", "M", 13),
    ("M", "R", 6),
)

_PRIMARY = {
    "R": np.array([255.0, 0.0, 0.0]),
    "Y": np.array([255.0, 255.0, 0.0]),
    "G": np.array([0.0, 255.0, 0.0]),
    "C": np.array([0.0, 255.0, 255.0]),
    "B": np.array([0.0, 0.0, 255.0]),
    "M": np.array([255.0, 0.0, 255.0]),
}


def make_colorwheel() -> np.ndarray:
    """[55, 3] RGB colour wheel (the sum of the standard segment lengths)."""
    rows = []
    for start, stop, count in _SEGMENTS:
        t = np.arange(count)[:, None] / count
        rows.append(_PRIMARY[start][None] * (1 - t) + _PRIMARY[stop][None] * t)
    return np.floor(np.concatenate(rows, axis=0))


def flow_uv_to_colors(u: np.ndarray, v: np.ndarray, convert_to_bgr: bool = False):
    """Map normalised (u, v) in the unit disk to wheel colours, [H, W, 3] uint8."""
    colorwheel = make_colorwheel()
    ncols = colorwheel.shape[0]

    rad = np.sqrt(np.square(u) + np.square(v))
    angle = np.arctan2(-v, -u) / np.pi
    fk = (angle + 1) / 2 * (ncols - 1)
    k0 = np.floor(fk).astype(np.int32)
    k1 = (k0 + 1) % ncols
    f = fk - k0

    image = np.zeros(u.shape + (3,), np.uint8)
    inside = rad <= 1
    for i in range(3):
        col0 = colorwheel[k0, i] / 255.0
        col1 = colorwheel[k1, i] / 255.0
        col = (1 - f) * col0 + f * col1
        col[inside] = 1 - rad[inside] * (1 - col[inside])
        col[~inside] = col[~inside] * 0.75  # out-of-range saturation falloff
        channel = 2 - i if convert_to_bgr else i
        image[..., channel] = np.floor(255 * col)
    return image


def flow_to_image(flow_uv: np.ndarray, clip_flow: Optional[float] = None,
                  convert_to_bgr: bool = False) -> np.ndarray:
    """Render a [H, W, 2] flow field as an RGB (or BGR) uint8 image."""
    flow_uv = np.asarray(flow_uv, np.float32)
    if flow_uv.ndim != 3 or flow_uv.shape[2] != 2:
        raise ValueError(f"flow must have shape [H, W, 2]; got {flow_uv.shape}")
    if clip_flow is not None:
        flow_uv = np.clip(flow_uv, 0, clip_flow)
    u, v = flow_uv[..., 0], flow_uv[..., 1]
    rad = np.sqrt(np.square(u) + np.square(v))
    rad_max = max(rad.max(), 1e-5)
    return flow_uv_to_colors(u / rad_max, v / rad_max, convert_to_bgr)


def plot_flow_legend(size: int = 500, show: bool = True) -> np.ndarray:
    """The colour-wheel legend over [-1, 1]^2 (the meshgrid of (u, v) through
    ``flow_uv_to_colors``), [size, size, 3] uint8; ``show`` also displays it
    with matplotlib, axes ticked at -1, 0 and 1."""
    u, v = np.meshgrid(np.linspace(-1, 1, size), np.linspace(-1, 1, size))
    wheel = flow_uv_to_colors(u, v)
    if show:
        import matplotlib.pyplot as plt

        plt.imshow(wheel)
        ticks = [0, (size - 1) / 2, size - 1]
        plt.xticks(ticks, [-1, 0, 1])
        plt.yticks(ticks, [-1, 0, 1])
        plt.show()
    return wheel


def flow_error_image(flow_pred: np.ndarray, flow_gt: np.ndarray,
                     log_scale: bool = True) -> np.ndarray:
    """Greyscale endpoint-error image, [H, W] float in [0, 1]."""
    err = np.linalg.norm(flow_pred - flow_gt, axis=-1)
    if log_scale:
        err = np.log1p(err)
    return err / max(err.max(), 1e-5)


def get_error_image(flow, gt_flow, valid=None):
    """Endpoint error of [H, W, 2] flows as a uint8 greyscale ``PIL.Image``,
    scaled linearly so that the largest error is 255, optionally multiplied
    by a validity mask first (``flow_error_image`` is the array variant,
    with log scaling)."""
    from PIL import Image

    error = np.sqrt(np.sum((np.asarray(flow) - np.asarray(gt_flow)) ** 2, axis=2))
    if valid is not None:
        error = error * valid
    error = error / max(float(np.max(error)), 1e-12) * 255
    return Image.fromarray(error.astype(np.uint8))
