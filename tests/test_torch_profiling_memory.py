"""The port's utils/profiling.py and utils/memory.py.

On the CPU: ``ThroughputMeter``, ``trace`` and ``op_stats`` (a CPU trace's
operators, and the device rows of a Chrome trace written here with kernel
events), ``sync`` against the JAX package's checksum, ``enable_nan_checks``
in the forward and the backward, and the memory functions refusing CPU
tensors (a measurement that cannot be made is never "0 bytes, fits").  The
card's cases are in ``tests/test_torch_cuda.py``.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from perceiverio_pytorch_tpu.utils import profiling as jax_profiling
from perceiverio_pytorch_tpu_torch.utils import memory, profiling

torch.set_num_threads(1)
KEYS = {"op", "type", "occurrences", "total_self_us", "avg_self_us", "flop_rate",
        "bandwidth", "bound_by"}


def _mlp():
    gen = torch.Generator().manual_seed(0)
    model = torch.nn.Sequential(torch.nn.Linear(16, 32), torch.nn.GELU(), torch.nn.Linear(32, 4))
    for p in model.parameters():
        with torch.no_grad():
            p.copy_(torch.randn(p.shape, generator=gen))
    return model


def test_throughput_meter_counts_every_call_and_returns_a_rate():
    model, calls = _mlp(), []

    def fn(x):
        calls.append(1)
        return {"y": model(x), "n": torch.ones(1)}

    rate = profiling.ThroughputMeter(warmup=2).measure(fn, torch.randn(8, 16), iters=5,
                                                       items_per_call=8)
    assert len(calls) == 7 and rate > 0 and np.isfinite(rate)


def test_trace_saves_a_chrome_trace_that_op_stats_reads(tmp_path):
    model, x = _mlp(), torch.randn(8, 16)
    with profiling.trace(str(tmp_path)):
        with profiling.annotate("forward"):
            for _ in range(3):
                model(x)
    files = os.listdir(tmp_path)
    assert len(files) == 1 and files[0].endswith(".pt.trace.json")
    rows = profiling.op_stats(str(tmp_path))
    assert rows and all(set(r) == KEYS for r in rows)
    by_op = {r["op"]: r for r in rows}
    assert by_op["aten::addmm"]["occurrences"] == 6 and by_op["aten::gelu"]["occurrences"] == 3
    assert all(r["type"] == "cpu_op" for r in rows)
    totals = [r["total_self_us"] for r in rows]
    assert totals == sorted(totals, reverse=True) and min(totals) >= 0
    assert profiling.op_stats(str(tmp_path), top=2) == rows[:2]
    assert profiling.annotate is torch.profiler.record_function


def test_op_stats_takes_the_device_rows_of_a_card_trace(tmp_path):
    """A trace with kernel events gives those (their durations are their
    self times) and not the CPU operators around them."""
    events = [
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 0, "dur": 50, "pid": 1, "tid": 1},
        {"ph": "X", "cat": "kernel", "name": "flash_fwd_sm90_kernel", "ts": 10, "dur": 30,
         "pid": 0, "tid": 7},
        {"ph": "X", "cat": "kernel", "name": "flash_fwd_sm90_kernel", "ts": 60, "dur": 10,
         "pid": 0, "tid": 7},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 80, "dur": 5,
         "pid": 0, "tid": 8},
        {"ph": "i", "cat": "kernel", "name": "marker", "ts": 90, "pid": 0, "tid": 7},
    ]
    (tmp_path / "x.pt.trace.json").write_text(json.dumps({"traceEvents": events}))
    rows = profiling.op_stats(str(tmp_path))
    assert [(r["op"], r["type"], r["occurrences"], r["total_self_us"]) for r in rows] == [
        ("flash_fwd_sm90_kernel", "kernel", 2, 40.0), ("Memcpy HtoD", "gpu_memcpy", 1, 5.0)]
    assert rows[0]["avg_self_us"] == 20.0
    assert rows[0]["flop_rate"] is rows[0]["bandwidth"] is rows[0]["bound_by"] is None


def test_op_stats_self_time_excludes_children(tmp_path):
    events = [
        {"ph": "X", "cat": "cpu_op", "name": "aten::linear", "ts": 0, "dur": 100, "pid": 1,
         "tid": 1},
        {"ph": "X", "cat": "cpu_op", "name": "aten::addmm", "ts": 10, "dur": 60, "pid": 1,
         "tid": 1},
        {"ph": "X", "cat": "cpu_op", "name": "aten::copy_", "ts": 20, "dur": 20, "pid": 1,
         "tid": 1},
        {"ph": "X", "cat": "cpu_op", "name": "aten::relu", "ts": 200, "dur": 5, "pid": 1,
         "tid": 1},
    ]
    (tmp_path / "t.pt.trace.json").write_text(json.dumps({"traceEvents": events}))
    got = {r["op"]: r["total_self_us"] for r in profiling.op_stats(str(tmp_path))}
    assert got == {"aten::linear": 40.0, "aten::addmm": 40.0, "aten::copy_": 20.0,
                   "aten::relu": 5.0}


def test_sync_returns_the_jax_checksum():
    rng = np.random.default_rng(0)
    tree = {"a": rng.standard_normal((3, 4)).astype(np.float32),
            "b": [rng.standard_normal(5).astype(np.float32), rng.standard_normal((2, 2, 2))]}
    want = jax_profiling.sync(jax.tree.map(jnp.asarray, tree))
    got = profiling.sync({"a": torch.from_numpy(tree["a"]),
                          "b": [torch.from_numpy(v) for v in tree["b"]]})
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert profiling.sync({"none": None}) == 0.0


def test_nan_checks_raise_in_the_forward_and_the_backward():
    x = torch.tensor([1.0, -1.0], requires_grad=True)
    profiling.enable_nan_checks(True)
    try:
        with pytest.raises(FloatingPointError, match="log"):
            torch.log(x)
        torch.exp(x)  # finite outputs pass
        zero = torch.zeros(1, requires_grad=True)
        loss = (torch.sqrt(zero) * 0.0).sum()  # finite forward, 0 * inf backward
        with pytest.raises((FloatingPointError, RuntimeError), match="nan|NaN"):
            loss.backward()
    finally:
        profiling.enable_nan_checks(False)
    assert torch.isnan(torch.log(x.detach())).any()  # off again
    assert not torch.is_anomaly_enabled()


def test_nan_checks_cover_a_model_forward_as_jax_debug_nans_does():
    model = _mlp()
    with torch.no_grad():
        model[0].bias[3] = float("nan")
    profiling.enable_nan_checks(True)
    try:
        with pytest.raises(FloatingPointError):
            model(torch.randn(2, 16))
    finally:
        profiling.enable_nan_checks(False)
    jax_profiling.enable_nan_checks(True)
    try:
        with pytest.raises(FloatingPointError):
            jax.jit(lambda v: jnp.log(v))(jnp.asarray([-1.0]))
    finally:
        jax_profiling.enable_nan_checks(False)


@pytest.mark.parametrize("fn", ["compiled_memory_stats", "hbm_headroom"])
@pytest.mark.parametrize("where", ["argument", "module"])
def test_memory_functions_refuse_cpu_tensors(fn, where):
    model, x = _mlp(), torch.randn(4, 16)
    call = getattr(memory, fn)
    with pytest.raises(RuntimeError, match="CUDA"):
        if where == "argument":
            call(lambda t: t * 2, x)
        else:
            call(model, x)

