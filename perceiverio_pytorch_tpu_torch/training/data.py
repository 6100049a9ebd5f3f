"""Host-side batching: the epoch / shuffle / resume index stream.

A numpy-only copy of ``_index_batches`` and ``batch_iterator`` from
``perceiverio_pytorch_tpu/training/data.py`` and of ``epoch_batches`` from
``perceiverio_pytorch_tpu/utils/data.py``, so that the port sees the same
data order as the JAX package for the same seed.  Multi-host sharding
(``shard_by_process``) and device prefetch are not ported.
"""

from __future__ import annotations

from typing import Iterator, Optional, Sequence

import numpy as np

__all__ = ["batch_iterator", "epoch_batches"]


def _index_batches(
    n: int,
    batch_size: int,
    *,
    shuffle: bool,
    seed: int,
    epochs: Optional[int],
    drop_remainder: bool,
    start_batch: int,
) -> Iterator[np.ndarray]:
    """Yield the index array of every batch: a fresh permutation each epoch
    (deterministic in ``seed``), the first ``start_batch`` batches skipped."""
    rng = np.random.default_rng(seed)
    if drop_remainder and n < batch_size:
        # would yield zero batches per epoch: with epochs=None, a hang
        raise ValueError(
            f"dataset has {n} examples but batch_size={batch_size} with"
            " drop_remainder=True yields no batches; shrink the batch or"
            " pass drop_remainder=False"
        )
    epoch = 0
    to_skip = start_batch
    while epochs is None or epoch < epochs:
        idx = rng.permutation(n) if shuffle else np.arange(n)
        stop = n - (n % batch_size) if drop_remainder else n
        for start in range(0, stop, batch_size):
            if to_skip > 0:
                to_skip -= 1
                continue
            yield idx[start : min(start + batch_size, stop)]
        epoch += 1


def batch_iterator(
    arrays: Sequence[np.ndarray],
    batch_size: int,
    *,
    shuffle: bool = False,
    seed: int = 0,
    epochs: Optional[int] = 1,
    drop_remainder: bool = True,
    start_batch: int = 0,
) -> Iterator[tuple]:
    """Yield tuples of aligned ``batch_size`` slices of host arrays.

    Args:
      arrays: equal-length arrays, e.g. ``(img1, img2, flow)``.
      shuffle: reshuffle every epoch (deterministic in ``seed``).
      epochs: number of passes; ``None`` repeats forever.
      drop_remainder: drop the short tail batch.
      start_batch: skip this many leading batches, with the same per-epoch
        shuffles, so that a resumed run sees the data order of an
        uninterrupted one.
    """
    arrays = tuple(np.asarray(a) for a in arrays)
    n = len(arrays[0])
    for a in arrays[1:]:
        if len(a) != n:
            raise ValueError(
                f"batch_iterator arrays must be equal length; got {len(a)} != {n}"
            )
    if batch_size <= 0:
        raise ValueError(f"batch_size must be positive; got {batch_size}")
    if start_batch < 0:
        raise ValueError(f"start_batch must be >= 0; got {start_batch}")
    for take in _index_batches(
        n, batch_size, shuffle=shuffle, seed=seed, epochs=epochs,
        drop_remainder=drop_remainder, start_batch=start_batch,
    ):
        yield tuple(a[take] for a in arrays)


def epoch_batches(
    arrays: Sequence[np.ndarray],
    batch_size: int,
    *,
    shuffle: bool = True,
    seed: int = 0,
    drop_remainder: bool = True,
) -> Iterator[tuple]:
    """One epoch of batch tuples from same-length in-memory arrays."""
    return batch_iterator(arrays, batch_size, shuffle=shuffle, seed=seed, epochs=1,
                          drop_remainder=drop_remainder)
