"""Micro-batching server: coalesce concurrent requests into device batches.

Counterpart of ``perceiverio_pytorch_tpu/serving_server.py``.  Requests
enqueue one example each; one worker thread drains the queue, pads the
group to the next bucket size, runs the function once on the device, and
resolves each request's future with its row.  On the card the buckets keep
the number of distinct shapes small (K1's launch plan and cuBLAS's choice
depend on the batch), and every call pays a fixed launch latency that a
batch shares.

Works with any callable taking and returning pytrees (dicts, lists,
tuples) whose tensor leaves have a leading batch axis, for example a
``serving.load_exported`` artifact closed over its weights::

    serve = load_exported(blob)
    server = BatchingServer(lambda x: serve(weights, x), max_batch=16,
                            max_wait_ms=2.0)
    fut = server.submit(example)        # one example, NO batch dim
    logits = fut.result()               # that example's output row
    server.stop()

Examples are numpy arrays or CPU tensors.  They are stacked on the host
into pinned memory and copied to ``device`` (the card unless the caller
asks for the CPU); ``fn`` runs under ``torch.inference_mode()`` (grad mode
is per thread, and a model whose parameters require grad would otherwise
record a graph on every batch); each output is copied back into host
memory, and the rows come back as CPU tensors.  Batching is transparent:
a row equals the function's row for the same padded batch, and a batch of
one within the kernels' batch-dependent rounding.
"""

from __future__ import annotations

import collections
import queue
import threading
import time
from concurrent.futures import Future
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch
from torch.utils import _pytree as pytree

from perceiverio_pytorch_tpu_torch.utils.device import resolve_device

__all__ = ["BatchingServer"]


def _as_tensor(leaf) -> torch.Tensor:
    """A tensor leaf as it is; anything else through numpy (no copy)."""
    if isinstance(leaf, torch.Tensor):
        return leaf
    return torch.as_tensor(np.asarray(leaf))


def _spec_of(example):
    """(treespec, [(shape, dtype), ...]) of an example pytree."""
    leaves, spec = pytree.tree_flatten(example)
    return spec, [(tuple(t.shape), t.dtype) for t in map(_as_tensor, leaves)]


def _check_spec(spec, example) -> None:
    treespec, leaf_specs = spec
    got_spec, got_leaves = _spec_of(example)
    if got_spec != treespec:
        raise ValueError(
            f"request structure {got_spec} does not match the served spec {treespec}"
        )
    for i, ((got_shape, got_dtype), (shape, dtype)) in enumerate(zip(got_leaves, leaf_specs)):
        if got_shape != shape or got_dtype != dtype:
            raise ValueError(
                f"request leaf {i} is {got_dtype}{list(got_shape)};"
                f" the served spec is {dtype}{list(shape)}"
            )


def _default_buckets(max_batch: int) -> Sequence[int]:
    out, b = [], 1
    while b < max_batch:
        out.append(b)
        b *= 2
    out.append(max_batch)
    return out


class _Fetch:
    """A batch's outputs on their way to host memory: each leaf's copy is
    queued on the device's stream as soon as ``fn`` returns (into pinned
    memory, without blocking), and one event marks their end.  ``rows``
    waits on that event only, never on work queued after it."""

    def __init__(self, out):
        leaves, self._spec = pytree.tree_flatten(out)
        self._host, self._event = [], None
        for leaf in map(_as_tensor, leaves):
            on_device = leaf.device.type == "cuda"
            host = torch.empty(leaf.shape, dtype=leaf.dtype, pin_memory=on_device)
            host.copy_(leaf, non_blocking=on_device)
            if on_device and self._event is None:
                self._event = torch.cuda.Event()
            self._host.append(host)
        if self._event is not None:
            self._event.record(torch.cuda.current_stream())

    def rows(self, n: int) -> list:
        if self._event is not None:
            self._event.synchronize()
        return [pytree.tree_unflatten([h[i] for h in self._host], self._spec)
                for i in range(n)]


class BatchingServer:
    """Coalesces ``submit`` calls into bucketed batches for ``fn``.

    Args:
      fn: ``fn(batch_pytree) -> batch_pytree`` with aligned leading batch
        axes (already closed over weights).  Called from the worker thread
        (and from ``warmup``'s), under ``torch.inference_mode()``.
      max_batch: largest batch per device call (also the largest bucket).
      max_wait_ms: after the first request of a group arrives, wait at most
        this long for more before dispatching.  0 dispatches immediately
        (batches still form under sustained load via queue backlog).
      batch_sizes: bucket sizes to pad to (sorted); defaults to powers of
        two up to ``max_batch``.
      pipeline: keep ONE batch in flight while collecting and dispatching
        the next: batch i's copy back to the host is queued behind its
        kernels as soon as ``fn`` returns, and its rows are handed out
        (after an event wait) only once batch i+1 has been dispatched, so
        batch i+1's host work overlaps batch i's device work.  ``fn`` must
        not synchronize.  Output equivalence is tested; only latency shape
        changes.
      example_spec: optional example pytree fixing the accepted request
        structure, shapes and dtypes.  With a spec, a malformed example is
        rejected at ``submit`` time with ValueError instead of failing the
        whole device batch it would share.  ``warmup(example,
        set_spec=True)`` can set it from an example.
      device: where batches are placed and ``fn`` runs: the card unless the
        caller passes "cpu".
    """

    def __init__(
        self,
        fn: Callable[..., Any],
        max_batch: int = 16,
        max_wait_ms: float = 2.0,
        batch_sizes: Optional[Sequence[int]] = None,
        pipeline: bool = False,
        example_spec: Any = None,
        *,
        device="cuda",
    ):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1; got {max_batch}")
        self._device = resolve_device(device)
        self._fn = fn
        self._max_batch = max_batch
        self._max_wait = max_wait_ms / 1e3
        self._pipeline = pipeline
        self._buckets = sorted(batch_sizes or _default_buckets(max_batch))
        if self._buckets[-1] < max_batch:
            raise ValueError(
                f"largest bucket {self._buckets[-1]} < max_batch {max_batch}"
            )
        self._spec = _spec_of(example_spec) if example_spec is not None else None
        self._queue: "queue.Queue" = queue.Queue()
        self._stopped = threading.Event()
        # observability (see stats()); guarded by _stats_lock -- counters
        # are touched by the worker thread and read by any caller
        self._stats_lock = threading.Lock()
        self._counters = {
            "requests_served": 0, "batches_dispatched": 0,
            "examples_dispatched": 0, "rows_padded": 0, "errors": 0,
            "requests_expired": 0,
        }
        self._bucket_counts = {b: 0 for b in self._buckets}
        self._latencies: "collections.deque" = collections.deque(maxlen=512)
        self._worker = threading.Thread(
            target=self._run, daemon=True, name="batching_server"
        )
        self._worker.start()

    # -- client side -------------------------------------------------------

    def submit(self, example: Any, timeout: Optional[float] = None) -> Future:
        """Enqueue one example (a pytree WITHOUT batch dim); returns a
        Future resolving to that example's output row (batch dim removed).

        ``timeout`` (seconds) sets a request deadline: if the worker has
        not DISPATCHED the example to the device by then, the future fails
        with TimeoutError and the example is shed -- it never occupies a
        device batch.  Once dispatch has started the request completes
        normally: device work is never cancelled mid-batch.
        """
        if self._stopped.is_set():
            raise RuntimeError("BatchingServer is stopped")
        if timeout is not None and timeout <= 0:
            raise ValueError(f"timeout must be positive; got {timeout}")
        if self._spec is not None:
            _check_spec(self._spec, example)
        fut: Future = Future()
        now = time.perf_counter()
        deadline = None if timeout is None else now + timeout
        self._queue.put((example, fut, now, deadline))
        return fut

    def __call__(self, example: Any) -> Any:
        """Blocking convenience wrapper around submit()."""
        return self.submit(example).result()

    def warmup(self, example: Any, set_spec: bool = False) -> None:
        """Run every bucket's batch of ``example`` once before taking
        traffic (the first call at a shape pays for cuBLAS's and the
        allocator's set-up), and wait for it.  Calls ``fn`` from this thread;
        does not touch the stats counters.

        ``set_spec=True`` additionally fixes the accepted request spec to
        this example's structure, shapes and dtypes (if no ``example_spec``
        was given).  Off by default: a server may accept several request
        dtypes.
        """
        if set_spec and self._spec is None:
            self._spec = _spec_of(example)
        for b in self._buckets:
            self._run_batch([example], b).rows(b)

    def stop(self, drain: bool = True) -> None:
        """Stop the worker.  ``drain=True`` serves queued requests first;
        otherwise they fail with RuntimeError."""
        self._stopped.set()
        self._queue.put(None)  # wake the worker
        self._worker.join()
        # anything still queued after the worker exits
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                break
            if item is None:
                continue
            if self._shed_if_expired(item):
                continue
            example, fut, t0, deadline = item
            if drain:
                try:
                    row = self._call_batch([example])[0]
                except Exception as e:
                    self._count_error()
                    fut.set_exception(e)
                else:
                    self._resolve([item], [row])
            else:
                fut.set_exception(RuntimeError("BatchingServer stopped"))

    def stats(self) -> dict:
        """Snapshot of serving counters (thread-safe, cheap).

        Keys: requests_served, batches_dispatched, examples_dispatched,
        rows_padded, errors, requests_expired (deadline shedding),
        queue_depth, per-bucket dispatch counts,
        mean_batch_occupancy (examples / padded rows actually computed),
        and request latency percentiles over the last 512 requests
        (submit -> result, i.e. including queueing and batching waits).
        """
        with self._stats_lock:
            c = dict(self._counters)
            buckets = {str(k): v for k, v in self._bucket_counts.items()}
            lat = sorted(self._latencies)
        out: dict = {**c, "queue_depth": self._queue.qsize(),
                     "bucket_dispatches": buckets}
        rows = c["examples_dispatched"] + c["rows_padded"]
        if rows:
            out["mean_batch_occupancy"] = round(
                c["examples_dispatched"] / rows, 4
            )
        if lat:
            out["request_latency_ms"] = {
                "p50": round(lat[len(lat) // 2] * 1e3, 3),
                "p99": round(lat[min(len(lat) - 1, int(len(lat) * 0.99))]
                             * 1e3, 3),
                "mean": round(sum(lat) / len(lat) * 1e3, 3),
                "window": len(lat),
            }
        return out

    def _count_error(self) -> None:
        with self._stats_lock:
            self._counters["errors"] += 1

    def _shed_if_expired(self, item) -> bool:
        """If the item's deadline has passed, fail its future with
        TimeoutError (shedding the device work) and return True."""
        _, fut, t0, deadline = item
        if deadline is None or time.perf_counter() <= deadline:
            return False
        with self._stats_lock:
            self._counters["requests_expired"] += 1
        fut.set_exception(
            TimeoutError(
                f"request expired in queue after"
                f" {time.perf_counter() - t0:.3f}s (server overloaded?)"
            )
        )
        return True

    def _resolve(self, group, rows) -> None:
        """Record latencies and hand each request its output row."""
        now = time.perf_counter()
        with self._stats_lock:
            self._counters["requests_served"] += len(group)
            for _, _, t0, _ in group:
                self._latencies.append(now - t0)
        for (_, fut, _, _), row in zip(group, rows):
            fut.set_result(row)

    # -- worker side -------------------------------------------------------

    def _bucket(self, n: int) -> int:
        for b in self._buckets:
            if b >= n:
                return b
        return self._buckets[-1]

    def _stack(self, examples, pad_to: int):
        """The examples stacked leaf by leaf (the last repeated up to
        ``pad_to`` rows) in host memory, pinned when bound for the card,
        and copied to the device without blocking."""
        flat = [pytree.tree_flatten(ex) for ex in examples]
        spec = flat[0][1]
        if any(s != spec for _, s in flat):
            raise ValueError("the examples of one batch differ in structure")
        pinned = self._device.type == "cuda"
        leaves = []
        for column in zip(*(leaves for leaves, _ in flat)):
            rows = [_as_tensor(x) for x in column]
            rows += [rows[-1]] * (pad_to - len(rows))
            dtype = rows[0].dtype
            for r in rows[1:]:
                dtype = torch.promote_types(dtype, r.dtype)
            host = torch.empty((pad_to, *rows[0].shape), dtype=dtype, pin_memory=pinned)
            torch.stack([r.to(dtype) for r in rows], out=host)
            leaves.append(host.to(self._device, non_blocking=pinned))
        return pytree.tree_unflatten(leaves, spec)

    def _dispatch(self, examples) -> _Fetch:
        """Count the batch, then run it padded to its bucket."""
        n = len(examples)
        pad_to = self._bucket(n)
        with self._stats_lock:
            self._counters["batches_dispatched"] += 1
            self._counters["examples_dispatched"] += n
            self._counters["rows_padded"] += pad_to - n
            self._bucket_counts[pad_to] += 1
        return self._run_batch(examples, pad_to)

    def _run_batch(self, examples, pad_to: int) -> _Fetch:
        """Stack, call fn, and queue the copy of its outputs to the host (no
        wait of its own)."""
        batch = self._stack(examples, pad_to)
        with torch.inference_mode():
            out = self._fn(batch)
        # Outside inference mode: the rows handed out are ordinary tensors.
        return _Fetch(out)

    def _call_batch(self, examples) -> list:
        return self._dispatch(examples).rows(len(examples))

    def _run(self) -> None:
        pending = None  # pipeline mode: (group, in-flight _Fetch)

        def settle(p) -> None:
            if p is None:
                return
            group, fetch = p
            try:
                rows = fetch.rows(len(group))
            except Exception as e:
                self._count_error()
                for _, fut, _, _ in group:
                    fut.set_exception(e)
                return
            self._resolve(group, rows)

        def handle(group) -> None:
            nonlocal pending
            if not group:
                return
            if not self._pipeline:
                self._serve_group(group)
                return
            try:
                fetch = self._dispatch([ex for ex, _, _, _ in group])
            except Exception as e:
                self._count_error()
                for _, fut, _, _ in group:
                    fut.set_exception(e)
                fetch = None
            # resolve the PREVIOUS batch while this one computes: its
            # stacking and dispatch above overlapped the prior device work
            settle(pending)
            pending = (group, fetch) if fetch is not None else None

        while True:
            if pending is not None:
                # results are owed: only keep them in flight while more
                # work is immediately available -- never block on an empty
                # queue holding clients' futures
                try:
                    item = self._queue.get_nowait()
                except queue.Empty:
                    settle(pending)
                    pending = None
                    item = self._queue.get()
            else:
                item = self._queue.get()
            if item is None:
                if self._stopped.is_set():
                    settle(pending)
                    return
                continue
            if self._shed_if_expired(item):
                continue
            group = [item]
            t_end = time.perf_counter() + max(self._max_wait, 0.0)
            while len(group) < self._max_batch:
                remaining = t_end - time.perf_counter()
                try:
                    nxt = (
                        self._queue.get_nowait()
                        if remaining <= 0
                        else self._queue.get(timeout=remaining)
                    )
                except queue.Empty:
                    break
                if nxt is None:
                    if self._stopped.is_set():
                        handle(group)
                        settle(pending)
                        return
                    continue
                if self._shed_if_expired(nxt):
                    continue
                group.append(nxt)
            handle(group)
            if self._stopped.is_set() and self._queue.empty():
                settle(pending)
                return

    def _serve_group(self, group) -> None:
        examples = [ex for ex, _, _, _ in group]
        try:
            rows = self._call_batch(examples)
        except Exception as e:
            self._count_error()
            for _, fut, _, _ in group:
                fut.set_exception(e)
            return
        self._resolve(group, rows)
