"""Host-side image and video helpers of the examples and datasets.

Counterpart of ``perceiverio_pytorch_tpu/utils/image.py``: numpy, with PIL
(image files, bilinear resize) and OpenCV (video files) imported when a
function needs them, so that importing this module needs neither.  Where
the size of an image already equals the target, the resize is skipped: PIL's
``resize`` to the same size returns a copy of the pixels.  Left out:
``show_animation`` (matplotlib) and ``resolve_sample_path``.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

IMAGENET_MEAN_RGB = (0.485 * 255, 0.456 * 255, 0.406 * 255)
IMAGENET_STDDEV_RGB = (0.229 * 255, 0.224 * 255, 0.225 * 255)


def _pil_image(what: str):
    try:
        from PIL import Image
    except ImportError as exc:
        raise ImportError(f"{what} needs PIL (the pillow package), which is not installed"
                          ) from exc
    return Image


def _cv2(what: str):
    try:
        import cv2
    except ImportError as exc:
        raise ImportError(f"{what} needs OpenCV (cv2), which is not installed") from exc
    return cv2


def read_rgb(path: str) -> np.ndarray:
    """An image file as uint8 [H, W, 3] (any mode converted to RGB)."""
    image = _pil_image(f"reading {path}")
    return np.asarray(image.open(path).convert("RGB"), np.uint8)


def write_png(path: str, hwc: np.ndarray) -> None:
    """Write uint8 [H, W, 3] (or [H, W]) as a PNG file."""
    image = _pil_image(f"writing {path}")
    image.fromarray(np.asarray(hwc, np.uint8)).save(path)


def resize_bilinear(hwc: np.ndarray, size: Sequence[int]) -> np.ndarray:
    """uint8 [H, W, C] -> [size[0], size[1], C] by PIL's BILINEAR filter;
    the image itself when it already has that size."""
    if tuple(hwc.shape[:2]) == tuple(size):
        return hwc
    image = _pil_image(f"resizing a {hwc.shape[0]}x{hwc.shape[1]} image to {tuple(size)}")
    return np.asarray(
        image.fromarray(hwc).resize((size[1], size[0]), image.BILINEAR), np.uint8)


def load_image(path: str) -> np.ndarray:
    """Load an image as [1, C, H, W] float32 in [0, 255]."""
    image = _pil_image(f"reading {path}")
    img = np.asarray(image.open(path), np.uint8)
    return np.transpose(img, (2, 0, 1)).astype(np.float32)[None]


def center_crop_resize(img: np.ndarray, size: Sequence[int]) -> np.ndarray:
    """Crop [B, C, H, W] to a centred square, then bilinear-resize to size."""
    _, _, h, w = img.shape
    min_size = min(h, w)
    top = int(h / 2 - min_size / 2)
    left = int(w / 2 - min_size / 2)
    cropped = img[:, :, top: top + min_size, left: left + min_size]
    out = np.empty((img.shape[0], img.shape[1], size[0], size[1]), np.float32)
    for b in range(img.shape[0]):
        hwc = np.transpose(cropped[b], (1, 2, 0)).astype(np.uint8)
        out[b] = np.transpose(resize_bilinear(hwc, size).astype(np.float32), (2, 0, 1))
    return out


def normalize_imagenet(img: np.ndarray) -> np.ndarray:
    """Standard ImageNet mean/std normalisation on [B, C, H, W] in [0, 255]."""
    mean = np.asarray(IMAGENET_MEAN_RGB, np.float32)[None, :, None, None]
    std = np.asarray(IMAGENET_STDDEV_RGB, np.float32)[None, :, None, None]
    return (img - mean) / std


def crop_center_square(frame: np.ndarray) -> np.ndarray:
    """Crop a [H, W, C] frame to its centred square."""
    y, x = frame.shape[0:2]
    min_dim = min(y, x)
    start_x = (x // 2) - (min_dim // 2)
    start_y = (y // 2) - (min_dim // 2)
    return frame[start_y: start_y + min_dim, start_x: start_x + min_dim]


def load_video(path: str, max_frames: int = 0,
               resize: Tuple[int, int] = (224, 224)) -> np.ndarray:
    """Load a video as [T, H, W, 3] float32 in [0, 1] (needs cv2)."""
    cv2 = _cv2(f"reading {path}")
    cap = cv2.VideoCapture(path)
    frames = []
    try:
        while True:
            ret, frame = cap.read()
            if not ret:
                break
            frame = crop_center_square(frame)
            frame = cv2.resize(frame, resize)
            frame = frame[:, :, [2, 1, 0]]  # BGR -> RGB
            frames.append(frame)
            if len(frames) == max_frames:
                break
    finally:
        cap.release()
    return np.asarray(frames, np.float32) / 255.0


def save_video(path: str, data: np.ndarray, fps: int = 25) -> None:
    """Save [T, H, W, 3] float in [0, 1] as an MJPG avi (needs cv2)."""
    cv2 = _cv2(f"writing {path}")
    fourcc = cv2.VideoWriter_fourcc("M", "J", "P", "G")
    out = cv2.VideoWriter(path, fourcc, fps, (data.shape[2], data.shape[1]))
    for frame in data:
        out.write((frame[:, :, ::-1] * 255).astype(np.uint8))
    out.release()


def dump_pickle(obj, file_path: str) -> None:
    import pickle

    with open(file_path, "wb") as f:
        pickle.dump(obj, f)


def load_pickle(file_path: str):
    """Unpickle ``file_path``; only for files this program wrote (unpickling
    can run arbitrary code)."""
    import pickle

    with open(file_path, "rb") as f:
        return pickle.load(f)
