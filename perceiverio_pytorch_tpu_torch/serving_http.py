"""HTTP front end for the micro-batching server (stdlib and numpy only).

Counterpart of ``perceiverio_pytorch_tpu/serving_http.py``, with the same
protocol, status codes, npz layout and ``/metrics`` names, so that a client
of the JAX front end talks to this one unchanged.  ``BatchingServer``
provides the device-side batching; this module puts a network protocol in
front of it.  Threaded stdlib ``http.server`` is deliberate: each request
blocks its own handler thread on the BatchingServer future, so CONCURRENT
requests are exactly what coalesces into one device batch.

Protocol:

    POST /v1/infer   {"inputs": <pytree>}   ->  {"outputs": <pytree>}
    GET  /healthz                           ->  {"status": "ok"}
    GET  /stats                             ->  BatchingServer.stats() JSON
                                                (counters, bucket usage,
                                                batch occupancy, request
                                                latency percentiles)
    GET  /metrics                           ->  the same as Prometheus text

Multi-model routing: pass ``{"name": BatchingServer, ...}`` instead of a
single server and each model gets its own route (its own buckets, one
shared card):

    POST /v1/models/<name>/infer            ->  that model's outputs
    GET  /v1/models                         ->  {"models": [...], "default": ...}
    GET  /v1/models/<name>/stats            ->  that model's stats
    GET  /stats                             ->  {"<name>": stats, ...}

``/v1/infer`` keeps working when a ``default_model`` is named (or there is
only one model).

Request deadlines: a ``timeout_ms`` field next to ``inputs`` (JSON) or an
``X-Timeout-Ms`` header (either content type) sets a server-side deadline;
a request still queued past it is shed (never burns device time) and the
client gets **504**.  Other errors: 400 for a malformed body or a request
that does not match the server's example spec, 404 for an unknown route or
model, 413 for a body over ``max_body_mb``, 503 for a stopped server, 500
for a failure inside the model.

Pytree convention (JSON): objects are structure, arrays are array leaves
(one example, NO batch dim; the server adds and strips it).  Numeric
leaves land as float32/int32/bool.

Binary alternative: POST the same route with
``Content-Type: application/octet-stream`` and an ``.npz`` body; the
response mirrors the request format (an ``.npz`` of the outputs).  Native
numpy dtypes pass through exactly (ship uint8 pixels); bfloat16 outputs are
cast to float32 so that clients can read them.  Keys with ``/`` nest into
sub-dicts; a bare array travels under the reserved key ``__bare__``.

    server = BatchingServer(lambda x: serve(weights, x), max_batch=16)
    front = HttpFrontend(server, port=8000)
    front.start()           # serves until stop()
    ...
    front.stop()
"""

from __future__ import annotations

import io
import json
import threading
import zipfile
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Optional

import numpy as np
import torch
from torch.utils import _pytree as pytree

__all__ = [
    "HttpFrontend",
    "decode_inputs",
    "decode_npz",
    "encode_npz",
    "encode_outputs",
]


def _to_array(leaf) -> np.ndarray:
    a = np.asarray(leaf)
    if a.dtype.kind == "f":
        return a.astype(np.float32)
    if a.dtype.kind in "iu":
        return a.astype(np.int32)
    if a.dtype.kind == "b":
        return a
    raise ValueError(f"unsupported input dtype {a.dtype} (leaf {leaf!r:.80})")


def _to_numpy(leaf) -> np.ndarray:
    """An output leaf as a numpy array a client can read: a tensor is
    copied to the host, and a dtype numpy cannot describe (bfloat16) is
    cast to float32."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()
    arr = np.asarray(leaf)
    return arr if arr.dtype.kind in "biufc" else arr.astype(np.float32)


def decode_inputs(obj: Any) -> Any:
    """JSON value -> pytree: objects are structure, arrays/scalars are
    numpy leaves (float32 / int32 / bool)."""
    if isinstance(obj, dict):
        return {k: decode_inputs(v) for k, v in obj.items()}
    return _to_array(obj)


def encode_outputs(tree: Any) -> Any:
    """Pytree of arrays or tensors -> JSON-serialisable nested lists."""
    return pytree.tree_map(lambda leaf: _to_numpy(leaf).tolist(), tree)


_BARE = "__bare__"  # reserved key marking a tree that is one bare leaf


def decode_npz(body: bytes) -> Any:
    """``.npz`` request body -> pytree of numpy leaves.

    The archive stores a flat mapping; ``/`` in a key nests it back into
    sub-dicts.  A body encoded from a single bare array (no dict) uses the
    reserved ``__bare__`` key and decodes back to the bare leaf; real dict
    keys, including ``arr_0`` or ``file``, pass through untouched.
    """
    with np.load(io.BytesIO(body), allow_pickle=False) as z:
        items = {k: z[k] for k in z.files}
    if list(items) == [_BARE]:
        return items[_BARE]
    tree: dict = {}
    for key, leaf in items.items():
        node = tree
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = leaf
    return tree


def encode_npz(tree: Any) -> bytes:
    """Pytree of arrays or tensors -> ``.npz`` bytes (inverse of decode_npz).

    Written via zipfile directly (``np.savez(**flat)`` would collide with
    its own ``file``/``allow_pickle`` argument names for those dict keys).
    """
    flat = {}

    def _walk(node, prefix):
        if isinstance(node, dict):
            for k, v in node.items():
                _walk(v, f"{prefix}/{k}" if prefix else str(k))
        else:
            flat[prefix or _BARE] = _to_numpy(node)

    _walk(tree, "")
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_STORED) as z:
        for key, arr in flat.items():
            with z.open(key + ".npy", "w") as f:
                np.lib.format.write_array(f, arr, allow_pickle=False)
    return buf.getvalue()


class HttpFrontend:
    """Serve a BatchingServer over HTTP (stdlib ThreadingHTTPServer).

    Args:
      server: the BatchingServer (or any object with ``submit(example) ->
        Future``) handling the device side — or a ``{"name": server}``
        mapping to serve several models from one port (each under
        ``/v1/models/<name>/infer``).
      default_model: with a mapping, the model ``/v1/infer`` routes to.
        Defaults to the sole model when there is exactly one; with several
        and no default, ``/v1/infer`` returns 404 listing the models.
      host/port: bind address; ``port=0`` picks a free port (read it back
        from ``.port`` — the pattern tests use).
      decode/encode: override the JSON<->pytree codecs (e.g. to accept a
        base64 tensor format); signatures match ``decode_inputs`` /
        ``encode_outputs``.
    """

    def __init__(
        self,
        server: Any,
        host: str = "127.0.0.1",
        port: int = 0,
        decode: Optional[Callable[[Any], Any]] = None,
        encode: Optional[Callable[[Any], Any]] = None,
        max_body_mb: float = 64.0,
        default_model: Optional[str] = None,
    ):
        if isinstance(server, dict):
            if not server:
                raise ValueError("the model mapping is empty")
            self._models = dict(server)
            self._single = False
            if default_model is None and len(self._models) == 1:
                default_model = next(iter(self._models))
            if default_model is not None and default_model not in self._models:
                raise ValueError(
                    f"default_model {default_model!r} is not one of"
                    f" {sorted(self._models)}"
                )
            self._default = default_model
        else:
            self._models = {"__default": server}
            self._single = True
            self._default = "__default"
        self._decode = decode or decode_inputs
        self._encode = encode or encode_outputs
        self._max_body = int(max_body_mb * 1e6)
        frontend = self

        class _Handler(BaseHTTPRequestHandler):
            # quiet by default; errors still reach the client as JSON
            def log_message(self, fmt, *args):  # noqa: D401
                pass

            def _reply(self, code: int, payload: dict) -> None:
                self._reply_raw(
                    code, json.dumps(payload).encode(), "application/json"
                )

            def _reply_raw(self, code: int, body: bytes, ctype: str) -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/healthz":
                    self._reply(200, {"status": "ok"})
                elif self.path == "/metrics":
                    self._reply_raw(
                        200, frontend._prometheus_metrics().encode(),
                        "text/plain; version=0.0.4",
                    )
                elif self.path == "/stats":
                    self._reply(*frontend._stats_reply())
                elif self.path == "/v1/models":
                    payload = {"models": sorted(frontend._models)}
                    if not frontend._single:
                        payload["default"] = frontend._default
                    self._reply(200, payload)
                elif (self.path.startswith("/v1/models/")
                      and self.path.endswith("/stats")):
                    name = self.path[len("/v1/models/"):-len("/stats")]
                    srv = frontend._models.get(name)
                    if srv is None:
                        self._reply(404, {"error": f"no model {name!r}",
                                          "models": sorted(frontend._models)})
                    else:
                        self._reply(*frontend._one_stats_reply(srv))
                else:
                    self._reply(404, {"error": f"no route {self.path}"})

            def do_POST(self):
                server, err = frontend._model_for_path(self.path)
                if server is None:
                    self._reply(*err)
                    return
                ctype = self.headers.get("Content-Type", "")
                binary = ctype.startswith("application/octet-stream")
                try:
                    length = int(self.headers.get("Content-Length", 0))
                    if length > frontend._max_body:
                        self._reply(413, {
                            "error": f"body {length} B exceeds the"
                                     f" {frontend._max_body} B limit"
                        })
                        return
                    body = self.rfile.read(length)
                    timeout_ms = self.headers.get("X-Timeout-Ms")
                    if binary:
                        example = decode_npz(body)
                    else:
                        obj = json.loads(body)
                        example = frontend._decode(obj["inputs"])
                        if isinstance(obj, dict):
                            timeout_ms = obj.get("timeout_ms", timeout_ms)
                    if timeout_ms is not None:
                        timeout_ms = float(timeout_ms)
                        if timeout_ms <= 0:
                            raise ValueError(
                                f"timeout_ms must be positive; got {timeout_ms}"
                            )
                except (
                    KeyError,          # missing "inputs"
                    TypeError,         # valid JSON that isn't an object
                    ValueError,        # bad dtypes, truncated npy
                    json.JSONDecodeError,
                    zipfile.BadZipFile,
                    EOFError,
                ) as e:
                    self._reply(400, {"error": f"bad request: {e}"})
                    return
                try:
                    # submit is synchronous: an example_spec rejection
                    # raises HERE (the request's fault -> 400), before the
                    # example could poison a shared device batch
                    if timeout_ms is None:
                        fut = server.submit(example)
                    else:
                        fut = server.submit(example, timeout=timeout_ms / 1e3)
                except ValueError as e:
                    self._reply(400, {"error": str(e)})
                    return
                except RuntimeError as e:
                    # BatchingServer stopped (lifecycles are separate --
                    # the server may be shared): tell the client the
                    # backend is gone instead of dropping the connection
                    self._reply(503, {"error": str(e)})
                    return
                try:
                    # blocks THIS handler thread; concurrent requests pile
                    # into the BatchingServer queue and share a device batch
                    row = fut.result()
                    if binary:
                        self._reply_raw(
                            200, encode_npz(row), "application/octet-stream"
                        )
                    else:
                        self._reply(200, {"outputs": frontend._encode(row)})
                except TimeoutError as e:  # deadline shed by the server
                    self._reply(504, {"error": str(e)})
                except Exception as e:  # model/shape errors -> 500
                    self._reply(500, {"error": str(e)})

        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self._thread: Optional[threading.Thread] = None

    # -- routing -------------------------------------------------------------

    def _model_for_path(self, path: str):
        """POST path -> (server, None) or (None, (status, payload))."""
        if path == "/v1/infer":
            if self._default is None:
                return None, (404, {
                    "error": "no default model; POST"
                             " /v1/models/<name>/infer",
                    "models": sorted(self._models),
                })
            return self._models[self._default], None
        if path.startswith("/v1/models/") and path.endswith("/infer"):
            name = path[len("/v1/models/"):-len("/infer")]
            server = self._models.get(name)
            if server is None:
                return None, (404, {"error": f"no model {name!r}",
                                    "models": sorted(self._models)})
            return server, None
        return None, (404, {"error": f"no route {path}"})

    def _one_stats_reply(self, server):
        stats_fn = getattr(server, "stats", None)
        if stats_fn is None:
            return 404, {"error": "server exposes no stats"}
        return 200, stats_fn()

    def _prometheus_metrics(self) -> str:
        """Flatten every model's stats() into Prometheus exposition text.

        GET /metrics — the standard scrape target, so the BatchingServer's
        counters land in existing dashboards without a sidecar.  Counter
        semantics follow stats(): monotonic counts become counters, queue
        depth / occupancy / latency quantiles become gauges.  Models
        without a stats() method are skipped.
        """
        counters = {
            "requests_served", "batches_dispatched", "examples_dispatched",
            "rows_padded", "errors", "requests_expired",
        }
        lines = []

        def esc(v):
            # exposition-format label escaping: one malformed label value
            # would make the scraper reject the WHOLE /metrics response
            return (str(v).replace("\\", "\\\\").replace('"', '\\"')
                    .replace("\n", "\\n"))

        def emit(name, labels, value, mtype):
            full = f"perceiver_{name}"
            if not any(l.startswith(f"# TYPE {full} ") for l in lines):
                lines.append(f"# TYPE {full} {mtype}")
            label_str = ",".join(f'{k}="{esc(v)}"' for k, v in labels.items())
            lines.append(f"{full}{{{label_str}}} {value}")

        for model, server in sorted(self._models.items()):
            stats_fn = getattr(server, "stats", None)
            if stats_fn is None:
                continue
            label_model = "default" if self._single else model
            for key, value in stats_fn().items():
                if key == "bucket_dispatches":
                    for bucket, n in value.items():
                        emit("bucket_dispatches",
                             {"model": label_model, "bucket": bucket},
                             n, "counter")
                elif key == "request_latency_ms":
                    for q, v in value.items():
                        if q == "window":
                            continue
                        emit("request_latency_ms",
                             {"model": label_model, "quantile": q},
                             v, "gauge")
                elif isinstance(value, (int, float)):
                    emit(key, {"model": label_model}, value,
                         "counter" if key in counters else "gauge")
        return "\n".join(lines) + "\n"

    def _stats_reply(self):
        if self._single:
            return self._one_stats_reply(self._models["__default"])
        out = {}
        for name, server in self._models.items():
            code, payload = self._one_stats_reply(server)
            out[name] = payload if code == 200 else None
        return 200, out

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    def start(self) -> "HttpFrontend":
        """Serve on a daemon thread; returns self (so
        ``HttpFrontend(...).start()`` chains)."""
        if self._thread is not None:
            raise RuntimeError("HttpFrontend already started")
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True, name="http_frontend"
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        """Stop accepting connections (the BatchingServer is left running —
        stop it separately; it may be shared)."""
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join()
            self._thread = None
