"""The port's HTTP front end and codecs, against the JAX package's.

The counterparts of ``tests/test_serving_http.py`` (routing, batching over
HTTP, status codes 400/404/413/500/503/504, the npz protocol, multi-model
routes, ``/stats`` and ``/metrics``) on the port's ``HttpFrontend`` over
the port's ``BatchingServer`` (``device="cpu"``).  Then the two packages
held against each other: the port's ``encode_npz`` read by JAX's
``decode_npz`` and the other way round, byte for byte where both encode
the same tree, the same for the JSON codecs, and the same ``/metrics``
names and values for the same stats.  Last, the serving example's
closed-loop server and HTTP demos, every answer against its client's
input.  Outputs computed by torch and by JAX
from the same seeded inputs agree at ``rtol=2e-4, atol=2e-5``.  Every
socket wait and join has a timeout; servers bind port 0.
"""

import io
import json
import threading
import time
import urllib.error
import urllib.request
import zipfile

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from perceiverio_pytorch_tpu import serving_http as jax_http
from perceiverio_pytorch_tpu.serving_server import BatchingServer as JaxBatchingServer
from perceiverio_pytorch_tpu_torch import serving_http as port_http
from perceiverio_pytorch_tpu_torch.serving_http import (
    HttpFrontend,
    decode_inputs,
    decode_npz,
    encode_npz,
    encode_outputs,
)
from perceiverio_pytorch_tpu_torch.serving_server import BatchingServer as PortServer

torch.set_num_threads(1)
TOL = dict(rtol=2e-4, atol=2e-5)


def BatchingServer(fn, **kw):  # noqa: N802 - the tests' spelling of the port's server
    return PortServer(fn, device="cpu", **kw)


def _post(port, payload, path="/v1/infer"):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=30) as resp:
        return resp.status, json.loads(resp.read())


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=30) as resp:
        return resp.headers, resp.read()


def test_decode_encode_roundtrip_dtypes():
    tree = decode_inputs({"x": [[1.5, 2.0]], "y": [1, 2], "m": [True]})
    assert tree["x"].dtype == np.float32
    assert tree["y"].dtype == np.int32
    assert tree["m"].dtype == np.bool_
    out = encode_outputs({"z": torch.tensor([[1.0, 2.0]]),
                          "b": torch.ones(2, dtype=torch.bfloat16)})
    assert out == {"z": [[1.0, 2.0]], "b": [1.0, 1.0]}
    with pytest.raises(ValueError, match="unsupported input dtype"):
        decode_inputs({"s": ["a", "b"]})


def test_http_frontend_serves_and_batches():
    """Concurrent HTTP requests return per-example results equal to the
    direct computation (JAX's, on the same inputs), and coalesce into shared
    device batches."""
    w = np.arange(6, dtype=np.float32).reshape(3, 2)
    wt = torch.from_numpy(w)
    batch_sizes = []

    def fn(batch):
        batch_sizes.append(batch["x"].shape[0])
        return {"y": batch["x"] @ wt}

    server = BatchingServer(fn, max_batch=8, max_wait_ms=150.0)
    front = HttpFrontend(server, port=0).start()
    try:
        port = front.port
        assert json.loads(_get(port, "/healthz")[1]) == {"status": "ok"}
        rng = np.random.default_rng(0)
        examples = [rng.standard_normal((4, 3)).astype(np.float32) for _ in range(6)]
        want = [np.asarray(jnp.asarray(ex) @ w) for ex in examples]

        def run_burst():
            results = [None] * len(examples)
            barrier = threading.Barrier(len(examples))

            def call(i):
                barrier.wait(timeout=30)  # release all clients at once
                status, body = _post(port, {"inputs": {"x": examples[i].tolist()}})
                assert status == 200
                results[i] = np.asarray(body["outputs"]["y"], np.float32)

            threads = [threading.Thread(target=call, args=(i,)) for i in range(len(examples))]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            return results

        # coalescing is timing-dependent on a loaded machine: retry the
        # burst a few times before declaring the batching broken
        for _ in range(3):
            results = run_burst()
            for got, wnt in zip(results, want):
                np.testing.assert_allclose(got, wnt, **TOL)
            if max(batch_sizes) > 1:
                break
        assert max(batch_sizes) > 1
    finally:
        front.stop()
        server.stop()


def test_http_frontend_error_codes():
    server = BatchingServer(lambda b: {"y": b["x"] @ torch.eye(3)}, max_batch=4,
                            max_wait_ms=0.0)
    front = HttpFrontend(server, port=0).start()
    try:
        port = front.port
        for payload, path, code in (
                ({"inputs": {"x": [[1.0]]}}, "/v1/nope", 404),
                ({"not_inputs": 1}, "/v1/infer", 400),   # missing "inputs"
                ([1, 2, 3], "/v1/infer", 400),            # JSON that is not an object
                ({"inputs": {"x": [[1.0, 2.0]]}}, "/v1/infer", 500)):  # wants width 3
            with pytest.raises(urllib.error.HTTPError) as e:
                _post(port, payload, path=path)
            assert e.value.code == code
            if code == 400 and isinstance(payload, list):
                assert "bad request" in json.loads(e.value.read())["error"]
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(port, "/nope")
        assert e.value.code == 404
    finally:
        front.stop()
        server.stop()


def test_npz_codec_roundtrip():
    tree = {"image": np.arange(6, dtype=np.uint8).reshape(2, 3),
            "meta": {"scale": np.float32(2.0)}}
    back = decode_npz(encode_npz(tree))
    np.testing.assert_array_equal(back["image"], tree["image"])
    assert back["image"].dtype == np.uint8  # dtypes pass through exactly
    np.testing.assert_allclose(back["meta"]["scale"], 2.0)
    arr = np.random.default_rng(0).standard_normal(4).astype(np.float32)
    np.testing.assert_array_equal(decode_npz(encode_npz(arr)), arr)  # bare array
    np.testing.assert_array_equal(decode_npz(encode_npz(torch.from_numpy(arr))), arr)
    # keys that collide with np.savez's own kwargs round-trip fine
    tricky = {"file": np.ones(2, np.float32), "arr_0": np.zeros(3, np.int32)}
    back2 = decode_npz(encode_npz(tricky))
    assert set(back2) == {"file", "arr_0"}
    np.testing.assert_array_equal(back2["arr_0"], tricky["arr_0"])
    # bfloat16 outputs are cast to a client-readable float32
    bf = decode_npz(encode_npz({"y": torch.ones(2, dtype=torch.bfloat16) * 1.5}))
    assert bf["y"].dtype == np.float32
    np.testing.assert_allclose(bf["y"], 1.5)


def test_http_frontend_npz_binary_protocol():
    """octet-stream requests carry npz pytrees both ways; uint8 survives to
    the function; garbage is 400."""
    w = torch.arange(6, dtype=torch.float32).reshape(3, 2)
    seen = []

    def fn(b):
        seen.append(b["x"].dtype)
        return {"y": b["x"].float() @ w}

    server = BatchingServer(fn, max_batch=4, max_wait_ms=0.0)
    front = HttpFrontend(server, port=0).start()
    try:
        x = np.arange(12, dtype=np.uint8).reshape(4, 3)
        req = urllib.request.Request(
            f"http://127.0.0.1:{front.port}/v1/infer", data=encode_npz({"x": x}),
            headers={"Content-Type": "application/octet-stream"}, method="POST")
        with urllib.request.urlopen(req, timeout=30) as resp:
            assert resp.headers["Content-Type"] == "application/octet-stream"
            out = decode_npz(resp.read())
        np.testing.assert_allclose(out["y"], x.astype(np.float32) @ w.numpy())
        assert seen == [torch.uint8]
        bad = urllib.request.Request(
            f"http://127.0.0.1:{front.port}/v1/infer", data=b"not an npz",
            headers={"Content-Type": "application/octet-stream"}, method="POST")
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(bad, timeout=30)
        assert e.value.code == 400
    finally:
        front.stop()
        server.stop()


def test_http_frontend_double_start_rejected():
    server = BatchingServer(lambda b: b, max_batch=2, max_wait_ms=0.0)
    front = HttpFrontend(server, port=0).start()
    try:
        with pytest.raises(RuntimeError, match="already started"):
            front.start()
    finally:
        front.stop()
        server.stop()


def test_http_stats_route():
    server = BatchingServer(lambda x: x * 3.0, max_batch=4, max_wait_ms=1.0)
    front = HttpFrontend(server, port=0).start()
    try:
        st, out = _post(front.port, {"inputs": [1.0, 2.0]})
        assert st == 200 and out["outputs"] == [3.0, 6.0]
        stats = json.loads(_get(front.port, "/stats")[1])
        assert stats["requests_served"] == 1
        assert stats["batches_dispatched"] == 1
        assert "request_latency_ms" in stats
    finally:
        front.stop()
        server.stop()


def test_http_spec_rejection_is_400_and_body_cap_is_413():
    server = BatchingServer(lambda x: x * 2.0, max_batch=2, max_wait_ms=1.0,
                            example_spec=np.zeros((2,), np.float32))
    front = HttpFrontend(server, port=0, max_body_mb=0.001).start()
    try:
        with pytest.raises(urllib.error.HTTPError) as e:  # oversized body
            _post(front.port, {"inputs": [0.0] * 4096})
        assert e.value.code == 413
        with pytest.raises(urllib.error.HTTPError) as e:  # wrong shape
            _post(front.port, {"inputs": [1.0, 2.0, 3.0]})
        assert e.value.code == 400
        st, out = _post(front.port, {"inputs": [1.0, 2.0]})  # conforming
        assert st == 200 and out["outputs"] == [2.0, 4.0]
    finally:
        front.stop()
        server.stop()


def test_http_stopped_server_returns_503():
    server = BatchingServer(lambda x: x, max_batch=2, max_wait_ms=1.0)
    front = HttpFrontend(server, port=0).start()
    try:
        server.stop()  # lifecycles are separate; the front end stays up
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(front.port, {"inputs": [1.0]})
        assert e.value.code == 503
    finally:
        front.stop()


def test_http_multi_model_routing():
    """One front end, several models: per-model routes, default routing,
    per-model and aggregate stats, 404 with the model list on a miss."""
    add = BatchingServer(lambda x: x + 1.0, max_batch=2, max_wait_ms=1.0)
    mul = BatchingServer(lambda x: x * 10.0, max_batch=2, max_wait_ms=1.0)
    front = HttpFrontend({"add": add, "mul": mul}, port=0, default_model="add").start()
    try:
        port = front.port
        st, out = _post(port, {"inputs": [1.0, 2.0]}, path="/v1/models/mul/infer")
        assert st == 200 and out["outputs"] == [10.0, 20.0]
        st, out = _post(port, {"inputs": [1.0, 2.0]})  # default -> add
        assert st == 200 and out["outputs"] == [2.0, 3.0]
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(port, {"inputs": [1.0]}, path="/v1/models/nope/infer")
        assert e.value.code == 404
        assert json.loads(e.value.read())["models"] == ["add", "mul"]
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(port, "/v1/models/nope/stats")
        assert e.value.code == 404
        assert json.loads(_get(port, "/v1/models")[1]) == {"models": ["add", "mul"],
                                                           "default": "add"}
        stats = json.loads(_get(port, "/stats")[1])
        assert stats["add"]["requests_served"] == stats["mul"]["requests_served"] == 1
        assert json.loads(_get(port, "/v1/models/mul/stats")[1])["requests_served"] == 1
    finally:
        front.stop()
        add.stop()
        mul.stop()


def test_http_multi_model_no_default_404s_plain_infer():
    add = BatchingServer(lambda x: x + 1.0, max_batch=2, max_wait_ms=1.0)
    mul = BatchingServer(lambda x: x * 10.0, max_batch=2, max_wait_ms=1.0)
    front = HttpFrontend({"add": add, "mul": mul}, port=0).start()
    try:
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(front.port, {"inputs": [1.0]})
        assert e.value.code == 404
        assert "no default model" in json.loads(e.value.read())["error"]
    finally:
        front.stop()
        add.stop()
        mul.stop()
    # a single-entry mapping routes /v1/infer without naming a default
    solo = BatchingServer(lambda x: x - 1.0, max_batch=2, max_wait_ms=1.0)
    front = HttpFrontend({"solo": solo}, port=0).start()
    try:
        st, out = _post(front.port, {"inputs": [1.0, 2.0]})
        assert st == 200 and out["outputs"] == [0.0, 1.0]
    finally:
        front.stop()
        solo.stop()
    with pytest.raises(ValueError, match="default_model"):
        HttpFrontend({"a": solo}, default_model="b")
    with pytest.raises(ValueError, match="empty"):
        HttpFrontend({})


def test_http_request_deadline_returns_504():
    """timeout_ms in the body (or the X-Timeout-Ms header) sets a
    server-side deadline; a request shed in the queue comes back as 504."""
    release = threading.Event()
    server = BatchingServer(lambda x: (release.wait(10), x + 1)[1], max_batch=1,
                            max_wait_ms=0.0)
    front = HttpFrontend(server, port=0).start()
    try:
        port = front.port
        blocker = server.submit(np.zeros((1,), np.float32))  # occupy the worker
        time.sleep(0.05)
        results = {}

        def doomed_client(key, payload, headers):
            req = urllib.request.Request(f"http://127.0.0.1:{port}/v1/infer",
                                         data=payload, headers=headers, method="POST")
            try:
                urllib.request.urlopen(req, timeout=30)
                results[key] = (200, None)
            except urllib.error.HTTPError as e:
                results[key] = (e.code, json.loads(e.read()))

        threads = [
            threading.Thread(target=doomed_client, args=(
                "body", json.dumps({"inputs": [0.0], "timeout_ms": 20}).encode(), {})),
            threading.Thread(target=doomed_client, args=(
                "header", encode_npz(np.zeros((1,), np.float32)),
                {"Content-Type": "application/octet-stream", "X-Timeout-Ms": "20"})),
        ]
        for t in threads:
            t.start()
        time.sleep(0.2)  # the deadlines pass while the worker is held
        release.set()
        for t in threads:
            t.join(timeout=30)
        blocker.result(timeout=10)
        for key in ("body", "header"):
            code, body = results[key]
            assert code == 504 and "expired" in body["error"], key
        st, out = _post(port, {"inputs": [1.0], "timeout_ms": 30000})
        assert st == 200 and out["outputs"] == [2.0]
        with pytest.raises(urllib.error.HTTPError) as e:  # malformed timeout
            _post(port, {"inputs": [1.0], "timeout_ms": -5})
        assert e.value.code == 400
    finally:
        release.set()
        front.stop()
        server.stop()


def test_prometheus_metrics_endpoint():
    """GET /metrics: Prometheus text for every model's counters, labelled by
    model; single-server mode labels as model="default"."""
    a = BatchingServer(lambda x: x * 2, max_batch=2)
    b = BatchingServer(lambda x: x * 2, max_batch=2)
    front = HttpFrontend({"alpha": a, "beta": b}, default_model="alpha", port=0).start()
    try:
        st, _ = _post(front.port, {"inputs": [1.0, 2.0]}, "/v1/models/alpha/infer")
        assert st == 200
        headers, body = _get(front.port, "/metrics")
        assert headers["Content-Type"].startswith("text/plain")
        text = body.decode()
        assert "# TYPE perceiver_requests_served counter" in text
        assert 'perceiver_requests_served{model="alpha"} 1' in text
        assert 'perceiver_requests_served{model="beta"} 0' in text
        assert 'perceiver_queue_depth{model="alpha"}' in text
        assert text.count("# TYPE perceiver_requests_served ") == 1
        assert 'perceiver_request_latency_ms{model="alpha",quantile="p50"}' in text
    finally:
        front.stop()
        a.stop()
        b.stop()
    c = BatchingServer(lambda x: x * 2, max_batch=2)
    front2 = HttpFrontend(c, port=0).start()
    try:
        text = _get(front2.port, "/metrics")[1].decode()
        assert 'perceiver_requests_served{model="default"} 0' in text
    finally:
        front2.stop()
        c.stop()


def test_prometheus_metrics_escapes_label_values():
    s = BatchingServer(lambda x: x, max_batch=1)
    front = HttpFrontend({'evil"name\\x': s}, port=0).start()
    try:
        assert 'model="evil\\"name\\\\x"' in _get(front.port, "/metrics")[1].decode()
    finally:
        front.stop()
        s.stop()


# ---- the two packages against each other -------------------------------------

def _trees(rng):
    """The same tree as numpy (for JAX's encoder) and as tensors (for the
    port's): nested keys, a uint8 image, int32 ids, a bool mask, a bare
    scalar, and float16 (native to numpy)."""
    arrays = {"image": rng.integers(0, 256, (3, 4, 4)).astype(np.uint8),
              "tokens": {"ids": rng.integers(0, 262, 7).astype(np.int32),
                         "mask": rng.random(7) > 0.5},
              "scale": np.float32(rng.standard_normal()),
              "half": rng.standard_normal(3).astype(np.float16)}
    tensors = torch.utils._pytree.tree_map(lambda a: torch.from_numpy(np.asarray(a)), arrays)
    return arrays, tensors


def _members(blob):
    with zipfile.ZipFile(io.BytesIO(blob)) as z:
        return [(info.filename, z.read(info)) for info in z.infolist()]


@pytest.mark.parametrize("bare", [False, True])
def test_npz_is_byte_compatible_with_jax(bare):
    """The port's encode_npz and JAX's give the same archive members, name
    and bytes in order, for the same tree (numpy leaves, or the port's
    tensors; the zip headers' clock fields aside), and each package decodes
    the other's; bf16 goes out as fp32 on both sides."""
    arrays, tensors = _trees(np.random.default_rng(1))
    if bare:
        arrays, tensors = arrays["image"], tensors["image"]
    jax_bytes = jax_http.encode_npz(arrays)
    assert _members(port_http.encode_npz(arrays)) == _members(jax_bytes)
    assert _members(port_http.encode_npz(tensors)) == _members(jax_bytes)
    for decoded in (port_http.decode_npz(jax_bytes), jax_http.decode_npz(jax_bytes)):
        jax.tree_util.tree_map(np.testing.assert_array_equal, decoded, arrays)
        assert jax.tree_util.tree_structure(decoded) == jax.tree_util.tree_structure(arrays)
    bf16 = {"y": np.arange(4, dtype=np.float32) / 3}
    from_jax = jax_http.decode_npz(jax_http.encode_npz({"y": jnp.asarray(bf16["y"], jnp.bfloat16)}))
    from_port = port_http.decode_npz(port_http.encode_npz(
        {"y": torch.from_numpy(bf16["y"]).bfloat16()}))
    assert from_jax["y"].dtype == from_port["y"].dtype == np.float32
    np.testing.assert_array_equal(from_port["y"], from_jax["y"])


def test_json_codecs_match_jax():
    """decode_inputs gives the same leaves (values and dtypes) in both
    packages, and encode_outputs the same JSON for the same outputs."""
    obj = {"x": [[1.5, -2.0]], "y": [1, 2, 3], "m": [True, False], "n": {"s": 4.25}}
    port_tree, jax_tree = port_http.decode_inputs(obj), jax_http.decode_inputs(obj)
    for path in (("x",), ("y",), ("m",), ("n", "s")):
        p, j = port_tree, jax_tree
        for key in path:
            p, j = p[key], j[key]
        assert p.dtype == j.dtype and np.array_equal(p, j)
    arrays, tensors = _trees(np.random.default_rng(2))
    want = json.dumps(jax_http.encode_outputs(arrays), sort_keys=True)
    assert json.dumps(port_http.encode_outputs(tensors), sort_keys=True) == want
    assert json.dumps(port_http.encode_outputs(arrays), sort_keys=True) == want


def test_metrics_match_the_jax_front_end():
    """The same function and requests behind each package's server and
    front end: the same /metrics names and TYPE lines, and the same
    counter values (latency gauges aside), and the same outputs."""
    w = np.random.default_rng(4).standard_normal((3, 2)).astype(np.float32)
    wt = torch.from_numpy(w)
    jax_server = JaxBatchingServer(jax.jit(lambda x: x @ w), max_batch=2, max_wait_ms=0.0)
    port_server = BatchingServer(lambda x: x @ wt, max_batch=2, max_wait_ms=0.0)
    fronts = [jax_http.HttpFrontend({"m": jax_server}, port=0).start(),
              HttpFrontend({"m": port_server}, port=0).start()]
    inputs = np.random.default_rng(5).standard_normal((3, 3)).astype(np.float32)
    try:
        outs, texts = [], []
        for front in fronts:
            outs.append([np.asarray(_post(front.port, {"inputs": row.tolist()})[1]["outputs"])
                         for row in inputs])
            texts.append(_get(front.port, "/metrics")[1].decode())
    finally:
        for front in fronts:
            front.stop()
        jax_server.stop()
        port_server.stop()
    np.testing.assert_allclose(np.stack(outs[1]), np.stack(outs[0]), **TOL)

    def series(text):
        return {line.rsplit(" ", 1)[0]: line.rsplit(" ", 1)[1]
                for line in text.splitlines() if line and "latency" not in line}

    jax_series, port_series = series(texts[0]), series(texts[1])
    assert port_series == jax_series
    assert 'perceiver_requests_served{model="m"}' in port_series


@pytest.mark.parametrize("demo", ["server", "http"])
def test_example_demos_answer_every_closed_loop_request(demo):
    """``examples/serve.py``'s server_demo and http_demo drive their clients
    in closed loop for the window: each client's every answer is its own
    image's row, the counts agree with the server's stats, and the rates
    count every request over the window (JSON and npz apart over HTTP)."""
    from perceiverio_pytorch_tpu_torch.examples import serve

    hw, clients = 4, 6
    call = lambda x: x.reshape(x.shape[0], -1)[:, :10] * 2  # noqa: E731
    run = serve.server_demo if demo == "server" else serve.http_demo
    res = run(None, hw, clients=clients, max_batch=4, device="cpu", seconds=0.3, call=call)
    answers = res["rows"] if demo == "server" else res["outputs"]
    assert len(answers) == clients and all(len(a) >= 1 for a in answers)
    for i, rows in enumerate(answers):
        want = serve.image(i, hw).reshape(-1)[:10] * 2
        for row in rows:
            np.testing.assert_allclose(np.asarray(row), want, **TOL)
    n = sum(len(a) for a in answers)
    assert res["requests"] == n == res["stats"]["requests_served"]
    assert res["requests_per_s"] == pytest.approx(n / res["seconds"])
    assert res["seconds"] >= 0.3 and res["p50_ms"] <= res["p99_ms"]
    if demo == "http":
        assert res["json"]["requests"] + res["npz"]["requests"] == n
        assert f'perceiver_requests_served{{model="default"}} {n}' in res["metrics"]
