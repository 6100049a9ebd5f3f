"""File-backed datasets and a threaded decode loader.

Counterpart of ``perceiverio_pytorch_tpu/training/datasets.py``, item for
item: a map-style protocol (``__len__`` and ``__getitem__(i) -> tuple of
numpy fields``), one dataset per task (``ImageFolderDataset``: the
``root/<class>/<image>`` layout; ``TextFileDataset`` and ``MLMDataset``:
byte-token windows with masked-LM corruption; ``FlowPairDataset``:
Sintel-style frames and ``.flo`` scenes; ``VideoClipDataset``: clips with
wav sidecars), and ``dataset_iterator``, which shares ``batch_iterator``'s
epoch, shuffle and ``start_batch`` stream and decodes items in a thread
pool a bounded number of batches ahead.  Copying to the card is
``prefetch_to_device``'s work downstream:

    ds = ImageFolderDataset("/data/train", image_size=(224, 224))
    batches = dataset_iterator(ds, 64, shuffle=True, num_workers=8)
    trainer.fit(state, prefetch_to_device(batches, 2), ...)

Datasets that expose ``getitem_at_epoch(i, epoch)`` (``MLMDataset``,
``FlowPairDataset``) draw their random crops and masks from ``(seed, epoch,
index)``, the epoch counted from the absolute batch number, so a resumed
run sees the items of an uninterrupted one.  Images come back uint8 in
[C, H, W]: normalise them on the device.  PIL decodes images and OpenCV
videos, both imported when an item is read.
"""

from __future__ import annotations

import itertools
import os
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterator, Optional, Sequence, Tuple

import numpy as np

from perceiverio_pytorch_tpu_torch.training.data import _index_batches, process_slice
from perceiverio_pytorch_tpu_torch.utils.bytes_tokenizer import BytesTokenizer
from perceiverio_pytorch_tpu_torch.utils.flow_io import read_flo
from perceiverio_pytorch_tpu_torch.utils.image import load_video, read_rgb, resize_bilinear

__all__ = [
    "FlowPairDataset",
    "ImageFolderDataset",
    "MLMDataset",
    "Subset",
    "TextFileDataset",
    "VideoClipDataset",
    "dataset_iterator",
]


class Subset:
    """A map-style dataset seen at a fixed list of indices (train and eval
    splits: ``Subset(ds, range(n_train))``).

    ``getitem_at_epoch`` passes the epoch on to a dataset that takes one, so
    that a subset of a ``FlowPairDataset`` draws fresh crops each epoch.  The
    JAX package's ``Subset`` has no such method: through it every epoch gets
    epoch 0's crops (ROADMAP.md, queue 3).
    """

    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = list(indices)

    def __len__(self) -> int:
        return len(self.indices)

    def __getitem__(self, i: int):
        return self.dataset[self.indices[i]]

    def getitem_at_epoch(self, i: int, epoch: int):
        fetch_at = getattr(self.dataset, "getitem_at_epoch", None)
        if fetch_at is None:
            return self.dataset[self.indices[i]]
        return fetch_at(self.indices[i], epoch)


_IMAGE_EXTENSIONS = (".png", ".jpg", ".jpeg", ".bmp", ".gif")


class ImageFolderDataset:
    """``root/<class_name>/<image file>`` -> (uint8 [C, H, W], int32 label).

    Files and classes are enumerated in sorted order, so the index ->
    example mapping is the same in every process and run.

    Args:
      root: dataset root; every subdirectory is a class.
      image_size: (H, W) after the centre square crop and bilinear resize
        (None: native size, only safe if all images match).
      classes: explicit class-name order (default: sorted subdirectories).
      transform: optional ``fn(uint8 HWC image) -> np.ndarray`` replacing the
        default crop, resize and CHW transpose.
    """

    def __init__(self, root: str, *, image_size: Optional[Tuple[int, int]] = (224, 224),
                 classes: Optional[Sequence[str]] = None,
                 transform: Optional[Callable[[np.ndarray], np.ndarray]] = None):
        self.root = root
        if classes is None:
            classes = sorted(d for d in os.listdir(root)
                             if os.path.isdir(os.path.join(root, d)))
        self.class_names = list(classes)
        if not self.class_names:
            raise ValueError(f"no class subdirectories under {root!r}")
        self._items = []
        for label, cls in enumerate(self.class_names):
            cdir = os.path.join(root, cls)
            for fname in sorted(os.listdir(cdir)):
                if fname.lower().endswith(_IMAGE_EXTENSIONS):
                    self._items.append((os.path.join(cdir, fname), label))
        if not self._items:
            raise ValueError(f"no image files under {root!r}")
        self.image_size = image_size
        self.transform = transform

    def __len__(self) -> int:
        return len(self._items)

    def __getitem__(self, i: int) -> Tuple[np.ndarray, np.ndarray]:
        path, label = self._items[i]
        img = read_rgb(path)  # HWC
        if self.transform is not None:
            img = self.transform(img)
        else:
            if self.image_size is not None:
                h, w = img.shape[:2]
                m = min(h, w)
                top, left = (h - m) // 2, (w - m) // 2
                img = resize_bilinear(img[top: top + m, left: left + m], self.image_size)
            img = np.transpose(img, (2, 0, 1))  # HWC -> CHW, the reference's layout
        return np.asarray(img), np.asarray(label, np.int32)


class TextFileDataset:
    """Text file(s) -> fixed-length windows of byte tokens (the reference's
    byte vocabulary, ``BytesTokenizer``).  Windows never straddle files;
    files are taken in the given (or sorted glob) order.

    Args:
      paths: one path, a sequence of paths, or a glob pattern.
      seq_len: tokens per window.
      stride: window step (default ``seq_len``: disjoint windows).
    """

    def __init__(self, paths, seq_len: int, *, stride: Optional[int] = None, tokenizer=None):
        import glob as _glob

        if isinstance(paths, str):
            expanded = (sorted(_glob.glob(paths)) if any(c in paths for c in "*?[")
                        else [paths])
        else:
            expanded = list(paths)
        if not expanded:
            raise ValueError(f"no text files match {paths!r}")
        if seq_len <= 0:
            raise ValueError(f"seq_len must be positive; got {seq_len}")
        stride = seq_len if stride is None else stride
        if stride <= 0:
            raise ValueError(f"stride must be positive; got {stride}")
        self.tokenizer = BytesTokenizer() if tokenizer is None else tokenizer
        self.seq_len = seq_len
        chunks, starts = [], []
        offset = 0
        for path in expanded:
            with open(path, "rb") as f:
                # int16 holds the 262-id vocabulary in half the memory;
                # windows are widened to int32 when read
                ids = np.asarray(self.tokenizer.to_int(f.read()), np.int16)
            chunks.append(ids)
            starts.extend(range(offset, offset + len(ids) - seq_len + 1, stride))
            offset += len(ids)
        self._tokens = np.concatenate(chunks) if chunks else np.zeros((0,), np.int16)
        self._starts = np.asarray(starts, np.int64)
        if len(self._starts) == 0:
            raise ValueError(
                f"no window of {seq_len} tokens fits in {paths!r} ({offset} tokens total)")

    def __len__(self) -> int:
        return len(self._starts)

    def __getitem__(self, i: int) -> Tuple[np.ndarray]:
        s = self._starts[i]
        return (self._tokens[s: s + self.seq_len].astype(np.int32),)


class MLMDataset:
    """Masked-LM corruption over a token dataset: items
    ``(corrupted, targets, mlm_mask)``, the masked positions replaced by the
    mask token and scored at exactly those positions.

    The mask is a function of ``(seed, epoch, index)``: fresh positions every
    epoch (epoch 0 keeps the per-index masks), or the same every epoch with
    ``dynamic_masks=False``.

    Args:
      dataset: map-style dataset whose item field 0 is a [seq_len] token array.
      mask_rate: fraction of positions masked (at least one per sequence).
      mask_token: replacement id (3 = ``BytesTokenizer.mask_token``).
    """

    def __init__(self, dataset, *, mask_rate: float = 0.15, seed: int = 0,
                 mask_token: int = 3, dynamic_masks: bool = True):
        if not 0.0 < mask_rate <= 1.0:
            raise ValueError(f"mask_rate must be in (0, 1]; got {mask_rate}")
        self.dataset = dataset
        self.mask_rate = mask_rate
        self.seed = seed
        self.mask_token = mask_token
        self.dynamic_masks = dynamic_masks

    def __len__(self) -> int:
        return len(self.dataset)

    def __getitem__(self, i: int):
        return self.getitem_at_epoch(i, 0)

    def getitem_at_epoch(self, i: int, epoch: int):
        item = self.dataset[i]
        tokens = np.asarray(item[0] if isinstance(item, tuple) else item)
        key = ([self.seed, epoch, i] if self.dynamic_masks and epoch > 0
               else [self.seed, i])
        rng = np.random.default_rng(np.random.SeedSequence(key))
        mask = rng.random(tokens.shape[-1]) < self.mask_rate
        if not mask.any():
            mask[rng.integers(tokens.shape[-1])] = True
        corrupted = np.where(mask, self.mask_token, tokens).astype(np.int32)
        return corrupted, tokens.astype(np.int32), mask


class FlowPairDataset:
    """Sintel-style frame and flow tree(s) -> consecutive frame pairs.

    Layout of a scene (the one ``examples/evaluate_flow.py`` reads):

        scene/frames/frame_0001.png frame_0002.png ...
        scene/flow/frame_0001.flo   (ground truth of the pair 1 -> 2)

    ``root`` is one scene (``root/frames`` exists) or a tree searched for
    scene directories.  Items: ``(img1 uint8 [3, H, W], img2 uint8 [3, H,
    W], flow float32 [2, H, W])``, channel 0 of the flow horizontal.

    Args:
      crop_size: (H, W) crop taken at the same place from both frames and
        the flow (a crop keeps flow values, a resize would not); None:
        native size.
      augment: True draws the crop's origin from ``(seed, epoch, index)``
        (fresh crops each epoch, epoch 0 the per-index ones); False crops
        the centre.
      missing_flow: "error" (default) or "zeros" (timing runs).
    """

    def __init__(self, root: str, *, crop_size: Optional[Tuple[int, int]] = None,
                 augment: bool = False, seed: int = 0, missing_flow: str = "error"):
        if missing_flow not in ("error", "zeros"):
            raise ValueError(f"missing_flow must be 'error' or 'zeros'; got {missing_flow!r}")
        scenes = []
        if os.path.isdir(os.path.join(root, "frames")):
            scenes.append(root)
        else:
            for dirpath, dirnames, _ in os.walk(root):
                dirnames.sort()
                if "frames" in dirnames:
                    scenes.append(dirpath)
        self._pairs = []
        for scene in scenes:
            frames = sorted(f for f in os.listdir(os.path.join(scene, "frames"))
                            if f.lower().endswith((".png", ".jpg", ".jpeg")))
            for a, b in zip(frames, frames[1:]):
                flo = os.path.join(scene, "flow", os.path.splitext(a)[0] + ".flo")
                if not os.path.exists(flo):
                    if missing_flow == "error":
                        raise ValueError(f"missing ground truth {flo} (pass"
                                         " missing_flow='zeros' to train without it)")
                    flo = None
                self._pairs.append((os.path.join(scene, "frames", a),
                                    os.path.join(scene, "frames", b), flo))
        if not self._pairs:
            raise ValueError(f"no frame pairs under {root!r}")
        self.crop_size = crop_size
        self.augment = augment
        self.seed = seed

    def __len__(self) -> int:
        return len(self._pairs)

    def __getitem__(self, i: int):
        return self.getitem_at_epoch(i, 0)

    def getitem_at_epoch(self, i: int, epoch: int):
        f1, f2, flo = self._pairs[i]
        img1, img2 = read_rgb(f1), read_rgb(f2)
        flow = (read_flo(flo).astype(np.float32) if flo is not None
                else np.zeros((2,) + img1.shape[:2], np.float32))
        if img2.shape != img1.shape or flow.shape[1:] != img1.shape[:2]:
            raise ValueError(f"shape mismatch in pair {f1}: frames {img1.shape} vs"
                             f" {img2.shape}, flow {flow.shape}")
        if self.crop_size is not None:
            ch, cw = self.crop_size
            h, w = img1.shape[:2]
            if h < ch or w < cw:
                raise ValueError(f"frame {h}x{w} smaller than crop {ch}x{cw} ({f1})")
            if self.augment:
                key = [self.seed, epoch, i] if epoch > 0 else [self.seed, i]
                rng = np.random.default_rng(np.random.SeedSequence(key))
                top = int(rng.integers(h - ch + 1))
                left = int(rng.integers(w - cw + 1))
            else:
                top, left = (h - ch) // 2, (w - cw) // 2
            img1 = img1[top: top + ch, left: left + cw]
            img2 = img2[top: top + ch, left: left + cw]
            flow = flow[:, top: top + ch, left: left + cw]
        return (np.transpose(img1, (2, 0, 1)), np.transpose(img2, (2, 0, 1)),
                np.ascontiguousarray(flow, np.float32))


class VideoClipDataset:
    """Clip directory -> (video, audio, label) for multimodal training.

    ``.avi`` and ``.mp4`` clips found under ``root``; a wav file of the same
    stem gives the audio (silence otherwise).  Labels come from
    ``labels_file`` (JSON: clip stem -> class index or name), else from the
    parent directory's name (an integer, or a name in ``class_names``);
    -1 where neither resolves.  Items: ``(video uint8 [T, 3, H, W], audio
    float32 [n_audio, 1], label int32)``; short clips repeat their last
    frame, audio is cut or padded with zeros.
    """

    def __init__(self, root: str, *, num_frames: int = 16,
                 image_size: Tuple[int, int] = (224, 224),
                 audio_samples_per_frame: int = 1920, labels_file: Optional[str] = None,
                 class_names: Optional[Sequence[str]] = None):
        import glob as _glob
        import json

        self.num_frames = num_frames
        self.image_size = tuple(image_size)
        self.n_audio = num_frames * audio_samples_per_frame
        self._label_map = None
        if labels_file:
            with open(labels_file) as f:
                self._label_map = json.load(f)
        self._name_to_idx = {n.lower(): i for i, n in enumerate(class_names or [])}
        paths = sorted(_glob.glob(os.path.join(root, "**", "*.avi"), recursive=True)
                       + _glob.glob(os.path.join(root, "**", "*.mp4"), recursive=True))
        if not paths:
            raise ValueError(f"no .avi/.mp4 clips under {root!r}")
        self._items = []
        for path in paths:
            stem = os.path.splitext(os.path.basename(path))[0]
            wav = os.path.splitext(path)[0] + ".wav"
            self._items.append((path, wav if os.path.exists(wav) else None,
                                self._resolve_label(
                                    stem, os.path.basename(os.path.dirname(path)))))

    def _resolve_label(self, stem: str, parent: str) -> int:
        if self._label_map is not None and stem in self._label_map:
            v = self._label_map[stem]
            if isinstance(v, str):
                return self._name_to_idx.get(v.replace("_", " ").lower(), -1)
            return int(v)
        try:
            return int(parent)
        except ValueError:
            return self._name_to_idx.get(parent.replace("_", " ").lower(), -1)

    def __len__(self) -> int:
        return len(self._items)

    def __getitem__(self, i: int):
        path, wav_path, label = self._items[i]
        t = self.num_frames
        h, w = self.image_size
        video = load_video(path, max_frames=t, resize=(w, h))  # [T, H, W, 3]
        if video.shape[0] == 0:
            raise ValueError(f"no decodable frames in {path}")
        if video.shape[0] < t:
            video = np.concatenate([video, np.repeat(video[-1:], t - video.shape[0], axis=0)])
        video = np.transpose(np.round(video * 255.0).astype(np.uint8), (0, 3, 1, 2))
        if wav_path is not None:
            import scipy.io.wavfile

            _, audio = scipy.io.wavfile.read(wav_path)
            if audio.dtype == np.int16:
                audio = audio.astype(np.float32) / 2**15
            audio = np.asarray(audio, np.float32).reshape(audio.shape[0], -1)
            audio = audio[: self.n_audio, :1]
            if audio.shape[0] < self.n_audio:
                audio = np.pad(audio, ((0, self.n_audio - audio.shape[0]), (0, 0)))
        else:
            audio = np.zeros((self.n_audio, 1), np.float32)
        return video, audio, np.asarray(label, np.int32)


def dataset_iterator(dataset, batch_size: int, *, shuffle: bool = False, seed: int = 0,
                     epochs: Optional[int] = 1, drop_remainder: bool = True,
                     shard_by_process: bool = False, start_batch: int = 0,
                     num_workers: int = 4, lookahead: int = 2) -> Iterator[tuple]:
    """Yield batches of a map-style dataset, each field stacked by numpy
    into a C-contiguous array.

    The epoch, shuffle and ``start_batch`` stream is ``batch_iterator``'s;
    ``shard_by_process`` keeps this rank's contiguous piece of each global
    batch, that of its coordinate on the data axis (``process_slice``).  ``num_workers`` threads decode
    the items of up to ``lookahead`` batches ahead of the consumer, and the
    batches come in order whatever the threads' timing (``num_workers=0``
    decodes inline).  A dataset with ``getitem_at_epoch(i, epoch)`` gets the
    epoch of the batch, counted from the absolute batch number
    (``start_batch`` included).
    """
    n = len(dataset)
    if batch_size <= 0:
        raise ValueError(f"batch_size must be positive; got {batch_size}")
    if start_batch < 0:
        raise ValueError(f"start_batch must be >= 0; got {start_batch}")
    lo, hi = process_slice(batch_size, drop_remainder) if shard_by_process else (0, batch_size)
    indices = _index_batches(n, batch_size, shuffle=shuffle, seed=seed, epochs=epochs,
                             drop_remainder=drop_remainder, start_batch=start_batch)
    # Batches per epoch depend on (n, batch_size, drop_remainder) alone, so
    # the epoch of the k-th batch of the run is (start_batch + k) // bpe.
    fetch_at = getattr(dataset, "getitem_at_epoch", None)
    bpe = max((n // batch_size) if drop_remainder else -(-n // batch_size), 1)
    counter = itertools.count(start_batch)

    def _fetch(i: int, epoch: int):
        return fetch_at(i, epoch) if fetch_at is not None else dataset[i]

    def _collate(items):
        # C-contiguous whatever the items' strides (CHW views of HWC images
        # stack into a channels-last layout, which another conv algorithm
        # would take)
        return tuple(np.ascontiguousarray(np.stack(f)) for f in zip(*items))

    if num_workers <= 0:
        for take in indices:
            epoch = next(counter) // bpe
            yield _collate([_fetch(int(i), epoch) for i in take[lo: min(hi, len(take))]])
        return

    executor = ThreadPoolExecutor(max_workers=num_workers)
    try:
        pending = deque()

        def _submit_next() -> bool:
            take = next(indices, None)
            if take is None:
                return False
            epoch = next(counter) // bpe
            pending.append([executor.submit(_fetch, int(i), epoch)
                            for i in take[lo: min(hi, len(take))]])
            return True

        for _ in range(lookahead + 1):
            if not _submit_next():
                break
        while pending:
            futures = pending.popleft()
            batch = _collate([f.result() for f in futures])
            _submit_next()
            yield batch
    finally:
        executor.shutdown(wait=False, cancel_futures=True)
