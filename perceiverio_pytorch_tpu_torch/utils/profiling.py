"""Tracing, profiling and debugging helpers.

Counterpart of ``perceiverio_pytorch_tpu/utils/profiling.py``, with its
names:
  * ``trace``: a context manager around ``torch.profiler`` (CPU and, with a
    card, CUDA activities) that saves a Chrome trace into ``log_dir``;
  * ``annotate``: ``torch.profiler.record_function``, a named range in the
    trace;
  * ``sync``: a completion barrier that returns a checksum;
  * ``ThroughputMeter``: steady-state items/s;
  * ``enable_nan_checks``: raise at the first operation that makes a NaN;
  * ``op_stats``: self time by operation from a saved trace.
"""

from __future__ import annotations

import contextlib
import glob
import gzip
import json
import os
import socket
import time
from collections import defaultdict
from typing import Dict, List

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

__all__ = ["ThroughputMeter", "annotate", "enable_nan_checks", "op_stats", "sync", "trace"]

annotate = torch.profiler.record_function

# The Chrome trace's event categories that are device work.
_DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the enclosed block and save it as a Chrome trace
    (``<host>.<pid>.<ns>.pt.trace.json``) in ``log_dir``: CPU activity, and
    CUDA activity when a card is present."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    os.makedirs(log_dir, exist_ok=True)
    name = f"{socket.gethostname()}.{os.getpid()}.{time.time_ns()}.pt.trace.json"
    prof.export_chrome_trace(os.path.join(log_dir, name))


def sync(tree) -> float:
    """Barrier on the tensors of a nested structure; returns the sum of the
    absolute values of each tensor's first element."""
    leaves = [x for x in tree_leaves(tree) if isinstance(x, torch.Tensor) and x.numel()]
    if not leaves:
        return 0.0
    for device in {x.device for x in leaves if x.device.type == "cuda"}:
        torch.cuda.synchronize(device)
    return float(sum(x.reshape(-1)[0].abs().double().item() for x in leaves))


class _NanCheckMode(TorchDispatchMode):
    """Raises ``FloatingPointError`` at the first operation whose floating
    point output holds a NaN."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if (isinstance(t, torch.Tensor) and (t.is_floating_point() or t.is_complex())
                    and bool(torch.isnan(t).any())):
                raise FloatingPointError(f"NaN in the output of {func}")
        return out


_nan_mode = None


def enable_nan_checks(enable: bool = True) -> None:
    """Raise ``FloatingPointError`` at the first operation of the calling
    thread whose floating point output holds a NaN, as ``jax_debug_nans``
    does: through a dispatch mode, so that the forward is checked too
    (``torch.autograd.set_detect_anomaly``, which this also sets, checks the
    backward, and raises ``RuntimeError`` there).  A debugging tool: every
    operation reads its output back to the host."""
    global _nan_mode
    torch.autograd.set_detect_anomaly(enable)
    if enable and _nan_mode is None:
        _nan_mode = _NanCheckMode()
        _nan_mode.__enter__()
    elif not enable and _nan_mode is not None:
        _nan_mode.__exit__(None, None, None)
        _nan_mode = None


def _read_traces(trace_dir: str) -> List[dict]:
    events = []
    for path in sorted(glob.glob(os.path.join(trace_dir, "**", "*.json*"), recursive=True)):
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rt") as f:
            data = json.load(f)
        events += data.get("traceEvents", []) if isinstance(data, dict) else data
    return [e for e in events if e.get("ph") == "X" and "dur" in e]


def _self_times(events: List[dict]) -> List[float]:
    """Each event's duration less its direct children's, on its thread."""
    self_us = [float(e["dur"]) for e in events]
    by_thread = defaultdict(list)
    for i, e in enumerate(events):
        by_thread[(e.get("pid"), e.get("tid"))].append(i)
    for members in by_thread.values():
        members.sort(key=lambda i: (events[i]["ts"], -events[i]["dur"]))
        stack = []
        for i in members:
            start = events[i]["ts"]
            while stack and events[stack[-1]]["ts"] + events[stack[-1]]["dur"] <= start:
                stack.pop()
            if stack:
                self_us[stack[-1]] -= float(events[i]["dur"])
            stack.append(i)
    return self_us


def op_stats(trace_dir: str, top: int = 0) -> List[Dict]:
    """Self time by operation from the Chrome traces saved in ``trace_dir``.

    The rows are the device's work: the kernel, copy and set events of a
    trace taken with a card.  A trace with no such event (taken on the CPU)
    gives the CPU operators instead, their time less their children's.
    Each row has the JAX package's keys: op, type (the event's category),
    occurrences, total_self_us, avg_self_us, flop_rate, bandwidth and
    bound_by; the last three are None, which the trace does not record.
    Sorted by total self time; ``top`` > 0 keeps that many rows.
    """
    events = _read_traces(trace_dir)
    picked = [e for e in events if e.get("cat") in _DEVICE_CATEGORIES]
    if picked:
        self_us = [float(e["dur"]) for e in picked]
    else:
        picked = [e for e in events if e.get("cat") == "cpu_op"]
        self_us = _self_times(picked)
    totals: Dict[tuple, List[float]] = defaultdict(list)
    for e, us in zip(picked, self_us):
        totals[(e["name"], e["cat"])].append(us)
    rows = [dict(op=name, type=cat, occurrences=len(times), total_self_us=sum(times),
                 avg_self_us=sum(times) / len(times), flop_rate=None, bandwidth=None,
                 bound_by=None)
            for (name, cat), times in totals.items()]
    rows.sort(key=lambda d: -d["total_self_us"])
    return rows[:top] if top else rows


class ThroughputMeter:
    """Steady-state throughput: warm up, then time ``iters`` chained calls.

    Each call's first output tensor is reduced on its device into an
    accumulator that the next call's reduction adds to, and one host read
    of the accumulator at the end is the barrier: the host clock stops when
    every call has finished on the device.
    """

    def __init__(self, warmup: int = 3):
        self.warmup = warmup

    def measure(self, fn, *args, iters: int = 10, items_per_call: int = 1) -> float:
        def run(n):
            acc = None
            for _ in range(n):
                leaf = next(x for x in tree_leaves(fn(*args)) if isinstance(x, torch.Tensor))
                term = leaf.detach().float().sum()
                acc = term if acc is None else acc + term
            return acc

        if self.warmup:
            float(run(self.warmup))
        t0 = time.perf_counter()
        float(run(iters))  # the single host read is the completion barrier
        dt = (time.perf_counter() - t0) / iters
        return items_per_call / dt
