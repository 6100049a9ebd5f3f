"""Host-side batching and device prefetch.

A numpy copy of ``_index_batches`` and ``batch_iterator`` (with
``shard_by_process``) from ``perceiverio_pytorch_tpu/training/data.py`` and
of ``epoch_batches`` from ``perceiverio_pytorch_tpu/utils/data.py``, so that
the port sees the same data order as the JAX package for the same seed; and
``prefetch_to_device``, which keeps batches copied to the card ahead of the
step loop.

``shard_by_process`` keeps the rows of this rank's coordinate on the data
axis of the process's mesh (``parallel.make_mesh``), so that the ranks of
one model group see the same rows: a JAX process is a host whose devices
form whole mesh rows, a rank here is one device.  Without a mesh every rank
is its own data index (``torch.distributed``'s rank and world size, else 0
and 1).
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Iterable, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from perceiverio_pytorch_tpu_torch.utils.device import resolve_device

__all__ = ["batch_iterator", "epoch_batches", "prefetch_to_device", "process_slice"]


def process_slice(batch_size: int, drop_remainder: bool, mesh=None) -> Tuple[int, int]:
    """``[lo, hi)`` of this rank's contiguous piece of a global batch of
    ``batch_size``: the piece of its coordinate on the data axis of ``mesh``
    (default: the process's mesh; without one, ``rank`` of ``world_size``)."""
    from perceiverio_pytorch_tpu_torch.parallel.multihost import data_rows

    if not drop_remainder:
        raise ValueError(
            "shard_by_process requires drop_remainder=True: a ragged"
            " tail batch cannot be split evenly across processes"
        )
    return data_rows(batch_size, mesh)


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
    shard_by_process: bool = False,
    start_batch: int = 0,
) -> Iterator[tuple]:
    """Yield tuples of aligned ``batch_size`` slices of host arrays.

    Args:
      arrays: equal-length arrays, e.g. ``(img1, img2, flow)``.
      shuffle: reshuffle every epoch (deterministic in ``seed``).
      epochs: number of passes; ``None`` repeats forever.
      drop_remainder: drop the short tail batch.
      shard_by_process: ``batch_size`` is the global batch; each rank
        yields the contiguous piece of every global batch of its coordinate
        on the data axis (``process_slice``; every rank holds the same
        arrays and seed).  ``parallel.shard_host_batch`` assembles the
        pieces into the global batch the Trainer takes.
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
    lo, hi = process_slice(batch_size, drop_remainder) if shard_by_process else (0, batch_size)
    if start_batch < 0:
        raise ValueError(f"start_batch must be >= 0; got {start_batch}")
    for take in _index_batches(
        n, batch_size, shuffle=shuffle, seed=seed, epochs=epochs,
        drop_remainder=drop_remainder, start_batch=start_batch,
    ):
        yield tuple(a[take[lo: min(hi, len(take))]] for a in arrays)


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


class _Stop:
    pass


class _Raised:
    def __init__(self, exc: BaseException):
        self.exc = exc


def _host_tensor(x) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x)) if isinstance(x, np.ndarray) else x


def prefetch_to_device(batches: Iterable[Any], size: int = 2, device="cuda", *,
                       sharding=None) -> Iterator[tuple]:
    """Iterate ``batches`` (tuples of numpy arrays or CPU tensors) with up to
    ``size`` of them already on ``device``, as tuples of tensors.

    ``sharding``: ``parallel.batch_sharding(mesh)`` keeps this rank's rows of
    each global batch (cut before the copy; ``device`` is then the mesh's).

    A daemon thread draws from the source, so that file reads and decodes
    overlap the steps.  For a CUDA device it pins each array and copies it
    ``non_blocking`` on a side stream, recording an event; the consumer makes
    its current stream wait on that event and marks each tensor as used by
    that stream (``record_stream``), so that the caching allocator does not
    hand the tensor's memory to another stream's work while the step reads
    it.  For the CPU it only turns arrays into tensors.  The source's
    exception is raised at the consumer; the thread stops when the source
    ends or the consumer drops the iterator.
    """
    if size < 1:
        raise ValueError(f"prefetch size must be >= 1; got {size}")
    device = resolve_device(device)
    side = None
    if device.type == "cuda":
        if device.index is None:  # compare with the tensors' own device
            device = torch.device("cuda", torch.cuda.current_device())
        side = torch.cuda.Stream(device=device)

    def _put(batch):
        if not isinstance(batch, (tuple, list)):
            batch = (batch,)
        tensors = [_host_tensor(x) for x in batch]
        if sharding is not None:  # this rank's rows, cut before the copy
            tensors = [sharding.piece(t).contiguous() for t in tensors]
        if side is None:
            return tuple(t.to(device) for t in tensors), None
        with torch.cuda.stream(side):
            moved = tuple(t if t.device == device else
                          t.pin_memory().to(device, non_blocking=True) for t in tensors)
            event = torch.cuda.Event()
            event.record(side)
        return moved, event

    q: "queue.Queue" = queue.Queue(maxsize=size)
    done = threading.Event()

    def _put_until_done(item) -> bool:
        """Timed put that gives up once the consumer is gone (the queue may
        stay full after the generator is dropped)."""
        while not done.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _worker():
        try:
            for batch in batches:
                if not _put_until_done(_put(batch)):
                    return
            _put_until_done(_Stop())
        except BaseException as e:  # raised again on the consumer's thread
            _put_until_done(_Raised(e))

    thread = threading.Thread(target=_worker, daemon=True, name="prefetch_to_device")
    thread.start()
    try:
        while True:
            item = q.get()
            if isinstance(item, _Stop):
                return
            if isinstance(item, _Raised):
                raise item.exc
            moved, event = item
            if event is not None:
                stream = torch.cuda.current_stream(device)
                stream.wait_event(event)
                for t in moved:
                    t.record_stream(stream)
            yield moved
    finally:
        done.set()
