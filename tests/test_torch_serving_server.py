"""The port's BatchingServer: transparent micro-batching, against the JAX one.

The counterparts of every case of ``tests/test_serving_server.py`` but the
device-mesh one (the port has no parallel layouts yet), on the CPU
(``device="cpu"``), with repeated cases merged as parameters (pipeline off
and on).  Batching must be invisible to the caller: each future resolves
to the row the function gives for that example (rows come back as CPU
tensors).  The same seeded requests through the JAX server and the port's
give the same rows (``rtol=2e-4, atol=2e-5``) and the same stats keys.  Also
what is the port's own: the function runs under ``torch.inference_mode()``
(no graph, no grad in the rows when the parameters require grad), and the
server refuses a missing GPU unless asked for the CPU.  Every future and
join has a timeout.
"""

import sys
import threading
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from perceiverio_pytorch_tpu.serving_server import BatchingServer as JaxBatchingServer
from perceiverio_pytorch_tpu_torch.serving_server import BatchingServer as PortServer

torch.set_num_threads(1)
TOL = dict(rtol=2e-4, atol=2e-5)


def BatchingServer(fn, **kw):  # noqa: N802 - the tests' spelling of the port's server
    return PortServer(fn, device="cpu", **kw)


def _call(server, example, timeout=10):
    """``server(example)``, the blocking ``__call__``, from a daemon thread
    that the test waits on at most ``timeout`` seconds."""
    out = []
    t = threading.Thread(target=lambda: out.append(server(example)), daemon=True)
    t.start()
    t.join(timeout)
    assert out, "server(example) did not return"
    return out[0]


@pytest.mark.parametrize("pipeline", [False, True])
def test_responses_match_direct_calls(pipeline):
    """Each future resolves to its own example's row; with pipeline=True
    (one batch in flight) the tail group resolves without any later
    submission (no starved futures), and rows are host tensors."""
    w = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    server = BatchingServer(lambda b: {"y": b["x"] @ w}, max_batch=4, max_wait_ms=5.0,
                            pipeline=pipeline)
    rng = np.random.default_rng(0)
    examples = [{"x": rng.standard_normal(3).astype(np.float32)} for _ in range(11)]
    try:
        futs = [server.submit(ex) for ex in examples]
        for ex, fut in zip(examples, futs):
            got = fut.result(timeout=30)
            assert isinstance(got["y"], torch.Tensor) and got["y"].device.type == "cpu"
            np.testing.assert_allclose(got["y"].numpy(), ex["x"] @ w.numpy(), rtol=1e-6)
    finally:
        server.stop()


def test_batches_form_and_shapes_are_bucketed():
    seen = []

    def fn(x):
        seen.append(x.shape[0])
        return x + 1

    server = BatchingServer(fn, max_batch=8, max_wait_ms=50.0)
    try:
        futs = [server.submit(np.zeros((2,), np.float32)) for _ in range(5)]
        for f in futs:
            f.result(timeout=10)
    finally:
        server.stop()
    # every device call used a bucket size (1, 2, 4, 8)
    assert seen and all(s in (1, 2, 4, 8) for s in seen)
    # the 50 ms window under a burst of 5 must have coalesced work
    assert len(seen) < 5


def test_concurrent_submitters():
    """More client threads than cores, the interpreter switching threads
    every microsecond: every client gets its own answer, and the counters
    (shared between the clients and the worker) lose no update."""
    server = BatchingServer(lambda x: x.sum(-1), max_batch=8, max_wait_ms=2.0)
    results, errors = {}, []

    def client(i):
        try:
            results[i] = float(server.submit(np.full((4,), float(i), np.float32))
                               .result(timeout=30))
        except Exception as e:  # pragma: no cover
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=client, args=(i,)) for i in range(32)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
        stats = server.stats()
    finally:
        sys.setswitchinterval(interval)
        server.stop()
    assert not errors
    assert results == {i: 4.0 * i for i in range(32)}
    assert stats["requests_served"] == stats["examples_dispatched"] == 32
    rows = sum(int(b) * n for b, n in stats["bucket_dispatches"].items())
    assert rows == 32 + stats["rows_padded"]


@pytest.mark.parametrize("pipeline", [False, True])
def test_error_propagates_to_futures_and_is_counted(pipeline):
    def fn(x):
        raise RuntimeError("device exploded")

    server = BatchingServer(fn, max_batch=2, max_wait_ms=1.0, pipeline=pipeline)
    try:
        fut = server.submit(np.zeros((1,), np.float32))
        with pytest.raises(RuntimeError, match="device exploded"):
            fut.result(timeout=10)
        deadline = time.perf_counter() + 5
        while server.stats()["errors"] == 0 and time.perf_counter() < deadline:
            time.sleep(0.01)
        stats = server.stats()
        assert stats["errors"] >= 1 and stats["requests_served"] == 0
    finally:
        server.stop(drain=False)


def test_stop_rejects_new_and_drains_queued():
    release = threading.Event()

    def slow_fn(x):
        release.wait(5)
        return x

    server = BatchingServer(slow_fn, max_batch=1, max_wait_ms=0.0)
    f1 = server.submit(np.ones((1,), np.float32))  # occupies the worker
    time.sleep(0.1)
    f2 = server.submit(np.full((1,), 2.0, np.float32))  # queued

    t = threading.Thread(target=lambda: server.stop(drain=True))
    release.set()
    t.start()
    t.join(timeout=10)
    assert not t.is_alive()
    np.testing.assert_array_equal(f1.result(timeout=5).numpy(), [1.0])
    np.testing.assert_array_equal(f2.result(timeout=5).numpy(), [2.0])
    with pytest.raises(RuntimeError, match="stopped"):
        server.submit(np.zeros((1,), np.float32))


def test_pytree_examples():
    server = BatchingServer(lambda d: {"sum": d["a"] + d["b"], "pair": (d["a"], d["b"] * 2)},
                            max_batch=4, max_wait_ms=1.0)
    try:
        out = _call(server, {"a": np.ones((2,), np.float32),
                             "b": torch.full((2,), 3.0)})  # numpy and tensor leaves
        np.testing.assert_allclose(out["sum"].numpy(), [4.0, 4.0])
        np.testing.assert_allclose(out["pair"][1].numpy(), [6.0, 6.0])
    finally:
        server.stop()


def test_pipeline_mode_error_propagation_and_stop_drain():
    def fn(batch):
        if batch["x"].shape[-1] != 3:
            raise ValueError("bad width")
        return {"y": batch["x"] * 2.0}

    server = BatchingServer(fn, max_batch=2, max_wait_ms=0.0, pipeline=True)
    try:
        ok = server.submit({"x": np.ones(3, np.float32)})
        np.testing.assert_allclose(ok.result(timeout=30)["y"].numpy(), 2.0)
        bad = server.submit({"x": np.ones(5, np.float32)})
        with pytest.raises(ValueError, match="bad width"):
            bad.result(timeout=30)
        # the server recovers: a good request after the failure still works
        ok2 = server.submit({"x": np.full(3, 2.0, np.float32)})
        np.testing.assert_allclose(ok2.result(timeout=30)["y"].numpy(), 4.0)
    finally:
        server.stop()


@pytest.mark.parametrize("pipeline", [False, True])
def test_stats_counters_and_latency(pipeline):
    server = BatchingServer(lambda x: x + 1.0, max_batch=4, max_wait_ms=5.0, pipeline=pipeline)
    try:
        futs = [server.submit(np.full((2,), float(i), np.float32)) for i in range(10)]
        for f in futs:
            f.result(timeout=10)
        stats = server.stats()
        assert stats["requests_served"] == 10
        assert stats["examples_dispatched"] == 10
        assert stats["batches_dispatched"] >= 3  # max_batch 4
        assert stats["errors"] == 0
        rows = sum(int(b) * n for b, n in stats["bucket_dispatches"].items())
        assert rows == stats["examples_dispatched"] + stats["rows_padded"]
        assert 0 < stats["mean_batch_occupancy"] <= 1.0
        lat = stats["request_latency_ms"]
        assert lat["window"] == 10 and lat["p50"] > 0 and lat["p99"] >= lat["p50"]
    finally:
        server.stop()
    assert server.stats()["requests_served"] == 10


def test_warmup_runs_every_bucket():
    seen = []

    def spy(x):
        seen.append(x.shape[0])
        return x * 2.0

    server = BatchingServer(spy, max_batch=8, max_wait_ms=1.0)
    try:
        server.warmup(np.zeros((3,), np.float32))
        assert seen == [1, 2, 4, 8]
        assert server.stats()["batches_dispatched"] == 0  # warmup is free
        out = _call(server, np.full((3,), 2.0, np.float32))
        np.testing.assert_allclose(out.numpy(), np.full((3,), 4.0))
    finally:
        server.stop()


def test_example_spec_rejects_malformed_requests():
    """A bad request fails at submit time, never inside the device batch it
    would share with good requests."""
    server = BatchingServer(lambda x: x * 2.0, max_batch=4, max_wait_ms=1.0,
                            example_spec=np.zeros((3,), np.float32))
    try:
        with pytest.raises(ValueError, match="spec"):
            server.submit(np.zeros((5,), np.float32))  # wrong shape
        with pytest.raises(ValueError, match="spec"):
            server.submit(np.zeros((3,), np.int32))  # wrong dtype
        with pytest.raises(ValueError, match="structure"):
            server.submit({"x": np.zeros((3,), np.float32)})
        out = _call(server, torch.full((3,), 2.0))  # conforming, as a tensor: fine
        np.testing.assert_allclose(out.numpy(), np.full((3,), 4.0))
        assert server.stats()["errors"] == 0
    finally:
        server.stop()


def test_warmup_spec_is_opt_in():
    server = BatchingServer(lambda x: x + 1.0, max_batch=2, max_wait_ms=1.0)
    try:
        server.warmup(np.zeros((2, 2), np.float32))
        np.testing.assert_allclose(_call(server, np.zeros((3, 3), np.float32)).numpy(),
                                   np.ones((3, 3)))
        server.warmup(np.zeros((2, 2), np.float32), set_spec=True)
        with pytest.raises(ValueError):
            server.submit(np.zeros((3, 3), np.float32))
        np.testing.assert_allclose(_call(server, np.zeros((2, 2), np.float32)).numpy(),
                                   np.ones((2, 2)))
    finally:
        server.stop()


def test_deadline_sheds_expired_requests():
    """A request whose deadline passes while queued fails with TimeoutError
    and is never dispatched."""
    release = threading.Event()
    calls = []

    def fn(x):
        calls.append(x.shape[0])
        release.wait(10)
        return x + 1

    server = BatchingServer(fn, max_batch=4, max_wait_ms=0.0)
    try:
        blocker = server.submit(np.zeros((2,), np.float32))
        time.sleep(0.05)  # let the worker enter fn and hold it there
        doomed = server.submit(np.zeros((2,), np.float32), timeout=0.01)
        time.sleep(0.05)  # the deadline passes while the worker is busy
        release.set()
        np.testing.assert_allclose(blocker.result(timeout=10).numpy(), 1.0)
        with pytest.raises(TimeoutError, match="expired"):
            doomed.result(timeout=10)
        fresh = server.submit(np.zeros((2,), np.float32))
        np.testing.assert_allclose(fresh.result(timeout=10).numpy(), 1.0)
        assert server.stats()["requests_expired"] == 1
        assert len(calls) == 2  # the doomed request never occupied a batch
    finally:
        release.set()
        server.stop()


def test_deadline_unexpired_and_validation():
    server = BatchingServer(lambda x: x * 2.0, max_batch=4, max_wait_ms=1.0)
    try:
        fut = server.submit(np.ones((3,), np.float32), timeout=30.0)
        np.testing.assert_allclose(fut.result(timeout=10).numpy(), 2.0)
        assert server.stats()["requests_expired"] == 0
        with pytest.raises(ValueError, match="timeout must be positive"):
            server.submit(np.ones((3,), np.float32), timeout=0)
    finally:
        server.stop()


def test_constructor_validation():
    with pytest.raises(ValueError, match="max_batch"):
        BatchingServer(lambda x: x, max_batch=0)
    with pytest.raises(ValueError, match="largest bucket"):
        BatchingServer(lambda x: x, max_batch=8, batch_sizes=(1, 2, 4))


@pytest.mark.parametrize("pipeline", [False, True])
def test_outputs_carry_no_grad_when_parameters_require_it(pipeline):
    """The worker thread runs fn under inference mode: a module whose
    parameters require grad records no graph, and its rows are ordinary
    tensors that require no grad (and take in-place updates)."""
    layer = torch.nn.Linear(3, 2)
    assert layer.weight.requires_grad
    server = BatchingServer(layer, max_batch=4, max_wait_ms=1.0, pipeline=pipeline)
    try:
        row = server.submit(np.ones(3, np.float32)).result(timeout=10)
        server.warmup(np.ones(3, np.float32))
    finally:
        server.stop()
    assert not row.requires_grad and row.grad_fn is None and not row.is_inference()
    with torch.no_grad():
        want = layer(torch.ones(3))
    torch.testing.assert_close(row, want)
    row.add_(1.0)


@pytest.mark.parametrize("pipeline", [False, True])
def test_rows_match_the_jax_server(pipeline):
    """The same seeded requests through the JAX BatchingServer and the
    port's, the same function (x W + b, then a sum) on both: the same rows
    and the same stats keys."""
    rng = np.random.default_rng(3)
    w = rng.standard_normal((4, 3)).astype(np.float32)
    b = rng.standard_normal(3).astype(np.float32)
    examples = [{"x": rng.standard_normal(4).astype(np.float32)} for _ in range(9)]
    jax_server = JaxBatchingServer(
        jax.jit(lambda d: {"y": d["x"] @ w + b, "s": jnp.sum(d["x"], -1)}),
        max_batch=4, max_wait_ms=2.0, pipeline=pipeline)
    wt, bt = torch.from_numpy(w), torch.from_numpy(b)
    port_server = BatchingServer(lambda d: {"y": d["x"] @ wt + bt, "s": d["x"].sum(-1)},
                                 max_batch=4, max_wait_ms=2.0, pipeline=pipeline)
    try:
        want = [f.result(timeout=30) for f in [jax_server.submit(e) for e in examples]]
        got = [f.result(timeout=30) for f in [port_server.submit(e) for e in examples]]
        jax_stats, port_stats = jax_server.stats(), port_server.stats()
    finally:
        jax_server.stop()
        port_server.stop()
    for g, wnt in zip(got, want):
        np.testing.assert_allclose(g["y"].numpy(), np.asarray(wnt["y"]), **TOL)
        np.testing.assert_allclose(g["s"].numpy(), np.asarray(wnt["s"]), **TOL)
    assert port_stats.keys() == jax_stats.keys()
    assert port_stats["requests_served"] == jax_stats["requests_served"] == 9


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a GPU")


def test_server_defaults_to_cuda(no_cuda):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PortServer(lambda x: x)
