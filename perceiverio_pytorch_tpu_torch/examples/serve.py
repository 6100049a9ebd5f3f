"""End-to-end deployment demo: export a model, then serve the artifact.

Counterpart of the JAX package's ``examples/serve.py``.  The deployment
unit is a ``torch.export`` artifact (``serving.export_apply``) plus a
weights directory (``training.checkpoint.save_variables``).  The script
plays both roles:

  1. ``build``: construct ``ClassificationPerceiver`` (seeded random
     weights, bf16 ``PERFORMANCE``, eval mode), cast its parameters to bf16
     (``cast_variables_for_inference``) and write a batch-polymorphic
     artifact and the weights to ``--out``;
  2. ``load`` reads both back from disk once (no model code needed to run
     the graph), and ``serve_demo`` answers timed requests at several
     batch sizes;
  3. ``--server``: 24 clients in closed loop for ``--seconds`` against a
     pipelined ``BatchingServer`` (``server_demo``);
  4. ``--http``: 12 clients in closed loop, half JSON and half npz, against
     ``HttpFrontend`` (``http_demo``), then ``/stats`` and ``/metrics``;
  5. ``--multi``: the classifier and a byte MLM behind one port, routed by
     name, and a 30 ms request deadline shed as HTTP 504 (``multi_demo``).

The default configuration is tiny (32x32 pixels, 10 classes; seconds on a
CPU).  ``--full-scale`` exports the published ImageNet convnet model
(224x224, 512 latents x 1024, 8 blocks of 6 self-attends), and
``multi_demo`` then serves the published byte MLM (2,048 bytes) beside it.
``build(..., prep_type=...)`` picks another preprocessing: at full scale
the 1x1-conv (``LEARNED_POS_1X1CONV``) and pixel (``FOURIER_POS_PIXEL``)
variants run K1 at their encoders; the convnet runs no kernel.

    python -m perceiverio_pytorch_tpu_torch.examples.serve [--full-scale] \\
        [--server] [--http] [--multi] [--requests 20] [--seconds 2] [--out DIR]

``--quant dynamic`` exports the model under ``PERFORMANCE_INT8`` (int8
projections, per-token scales); ``--quant static`` under
``PERFORMANCE_INT8_STATIC``, calibrated first on two seeded uniform batches
(``ops.quant.calibrate``), as the JAX script does: the calibrated ``amax``
of every projection rides in the weights directory, in fp32, and the
artifact stays batch-polymorphic.

Runs on the GPU unless the caller asks for the CPU (``--device cpu``).
The XLA compilation-cache flags have no counterpart.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import torch

from perceiverio_pytorch_tpu_torch.config import (
    PERFORMANCE,
    PERFORMANCE_INT8,
    PERFORMANCE_INT8_STATIC,
)
from perceiverio_pytorch_tpu_torch.models.classification import (
    ClassificationPerceiver,
    PrepType,
)
from perceiverio_pytorch_tpu_torch.models.language import LanguagePerceiver
from perceiverio_pytorch_tpu_torch.ops.quant import calibrate
from perceiverio_pytorch_tpu_torch.serving import export_apply, load_exported
from perceiverio_pytorch_tpu_torch.serving_http import HttpFrontend, decode_npz, encode_npz
from perceiverio_pytorch_tpu_torch.serving_server import BatchingServer
from perceiverio_pytorch_tpu_torch.training.checkpoint import restore_variables, save_variables
from perceiverio_pytorch_tpu_torch.utils.compilation_cache import (
    add_cache_arg,
    enable_cache_if_requested,
)
from perceiverio_pytorch_tpu_torch.utils.device import resolve_device
from perceiverio_pytorch_tpu_torch.utils.params import cast_variables_for_inference

TINY = dict(num_classes=10, img_size=(32, 32), num_self_attends_per_block=2, num_blocks=1,
            num_latents=16, num_latent_channels=64)
TINY_MLM = dict(vocab_size=262, max_seq_len=64, embed_dim=16, num_latents=8,
                num_latent_channels=32, num_self_attends_per_block=1, num_blocks=1)
FULL_MLM_LEN = 2048  # LanguagePerceiver's default, the published model's
ARTIFACT = "model.pt2"
WEIGHTS = "weights"


def image(i: int, hw: int) -> np.ndarray:
    """Client ``i``'s request: a seeded [3, hw, hw] image in [-1, 1]."""
    return np.random.RandomState(i).uniform(-1, 1, (3, hw, hw)).astype(np.float32)


def build(out_dir: str, full_scale: bool = False, *, prep_type=None, device="cuda",
          quant=None) -> dict:
    """Export the classifier and its bf16 weights to ``out_dir``; returns
    the artifact's and the weights' sizes in bytes and the export time.
    ``quant``: None, "dynamic" or "static" (int8, calibrated on two seeded
    batches of uniform [-1, 1] images)."""
    policy = {None: PERFORMANCE, "dynamic": PERFORMANCE_INT8,
              "static": PERFORMANCE_INT8_STATIC}[quant]
    device = resolve_device(device)
    generator = torch.Generator().manual_seed(0)
    if full_scale:
        prep_type = prep_type or PrepType.FOURIER_POS_CONVNET
        model = ClassificationPerceiver(num_classes=1000, img_size=(224, 224),
                                        prep_type=prep_type, policy=policy,
                                        device=device, generator=generator)
        hw = 224
    else:
        prep_type = prep_type or PrepType.FOURIER_POS_PIXEL
        model = ClassificationPerceiver(prep_type=prep_type, **TINY, policy=policy,
                                        device=device, generator=generator)
        hw = TINY["img_size"][0]
    model.eval()
    if quant == "static":
        # Calibration on representative inputs (random here, real data in
        # production) before the weights are cast, as the JAX script does.
        rng = np.random.RandomState(0)
        calibrate(model, [(torch.from_numpy(rng.uniform(-1, 1, (1, 3, hw, hw))).float()
                           .to(device),) for _ in range(2)])
    weights = cast_variables_for_inference(model)
    # A batch of 2: a batch-polymorphic export needs one above 1.
    example = torch.zeros((2, 3, hw, hw), device=device)
    t0 = time.perf_counter()
    blob = export_apply(model, weights, example, batch_polymorphic=True)
    export_s = time.perf_counter() - t0
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, ARTIFACT), "wb") as f:
        f.write(blob)
    save_variables(os.path.join(out_dir, WEIGHTS), weights, overwrite=True)
    rec = dict(prep_type=prep_type.name, quant=quant, artifact_bytes=len(blob),
               export_s=export_s,
               weights_bytes=sum(t.numel() * t.element_size() for t in weights.values()))
    print(f"exported {rec['artifact_bytes'] / 1e6:.1f} MB artifact + "
          f"{rec['weights_bytes'] / 1e6:.1f} MB weights to {out_dir} in {export_s:.1f} s")
    return rec


def load(out_dir: str, device="cuda"):
    """The artifact closed over its weights, both read from ``out_dir``:
    ``call(images) -> logits``, with no model code."""
    with open(os.path.join(out_dir, ARTIFACT), "rb") as f:
        fn = load_exported(f.read())
    weights = restore_variables(os.path.join(out_dir, WEIGHTS), device=device)
    return lambda x: fn(weights, x)


def _percentile_ms(times, q: float) -> float:
    return times[min(len(times) - 1, int(len(times) * q))] * 1e3


def serve_demo(out_dir: str, hw: int, batch_sizes=(1, 4, 16), requests: int = 20,
               device="cuda", call=None) -> dict:
    """Timed requests at each batch size against the reloaded artifact:
    p50 and p99 latency (host clock, the logits fetched) and images/s.
    ``call`` as in ``server_demo``."""
    device = resolve_device(device)
    call = call or load(out_dir, device)
    rng = np.random.RandomState(0)
    out = {}
    with torch.inference_mode():
        for b in batch_sizes:
            img = torch.from_numpy(rng.uniform(-1, 1, (b, 3, hw, hw)).astype(np.float32))
            img = img.to(device)
            call(img).cpu()  # the first call at this batch
            times = []
            for _ in range(requests):
                t0 = time.perf_counter()
                call(img).cpu()
                times.append(time.perf_counter() - t0)
            times.sort()
            rec = dict(p50_ms=_percentile_ms(times, 0.5), p99_ms=_percentile_ms(times, 0.99),
                       images_per_s=b / (sum(times) / len(times)))
            out[b] = rec
            print(f"batch {b:3d}: p50 {rec['p50_ms']:7.2f} ms  p99 {rec['p99_ms']:7.2f} ms  "
                  f"{rec['images_per_s']:8.1f} img/s")
    return out


def _closed_loop(clients: int, seconds: float, request) -> tuple:
    """``clients`` threads, each sending ``request(i)`` again as soon as its
    last answer came back, until ``seconds`` have passed (at least one
    request each).  Returns each client's answers and latencies and the
    wall time from the first request to the last answer."""
    answers = [[] for _ in range(clients)]
    latencies = [[] for _ in range(clients)]
    errors = []
    t_start = time.perf_counter()
    t_end = t_start + seconds

    def client(i):
        try:
            while True:
                t0 = time.perf_counter()
                answers[i].append(request(i))
                latencies[i].append(time.perf_counter() - t0)
                if t0 >= t_end:
                    break
        except Exception as e:  # noqa: BLE001 -- re-raised below
            errors.append(e)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=seconds + 600)
    wall = time.perf_counter() - t_start
    if errors:
        raise RuntimeError(f"{len(errors)} of {clients} clients failed") from errors[0]
    if any(t.is_alive() for t in threads):
        raise RuntimeError("a client is still waiting for its answer")
    return answers, latencies, wall


def _rates(latencies, wall: float) -> dict:
    """Requests, req/s over the window and p50/p99 over every request."""
    times = sorted(t for client in latencies for t in client)
    return dict(requests=len(times), requests_per_s=len(times) / wall,
                p50_ms=_percentile_ms(times, 0.5), p99_ms=_percentile_ms(times, 0.99))


def server_demo(out_dir: str, hw: int, clients: int = 24, max_batch: int = 8,
                device="cuda", pipeline: bool = True, seconds: float = 2.0,
                call=None) -> dict:
    """Concurrent clients against the micro-batching server, in closed loop
    for ``seconds``: requests coalesce into bucketed device batches
    transparently.  Client ``i`` sends ``image(i, hw)`` each time.  ``call``
    (``images -> logits``) replaces the artifact read from ``out_dir``.
    Returns each client's rows, req/s and p50/p99 over every request, and
    the server's stats."""
    call = call or load(out_dir, device)
    server = BatchingServer(call, max_batch=max_batch, max_wait_ms=3.0, pipeline=pipeline,
                            device=device)
    # every bucket once before timed traffic; these clients all send one
    # shape and dtype, so also pin the request spec
    server.warmup(np.zeros((3, hw, hw), np.float32), set_spec=True)
    images = [image(i, hw) for i in range(clients)]
    try:
        rows, latencies, wall = _closed_loop(
            clients, seconds, lambda i: server.submit(images[i]).result(timeout=300))
    finally:
        stats = server.stats()
        server.stop()
    rec = _rates(latencies, wall)
    print(f"server: {clients} closed-loop clients for {wall:.1f} s, max_batch {max_batch}, "
          f"pipeline {pipeline}: {rec['requests']} requests, p50 {rec['p50_ms']:.1f} ms  "
          f"p99 {rec['p99_ms']:.1f} ms  {rec['requests_per_s']:.1f} req/s")
    print(f"server stats: {stats['batches_dispatched']} batches, "
          f"occupancy {stats.get('mean_batch_occupancy', 0):.2f}, "
          f"buckets {stats['bucket_dispatches']}")
    return dict(rows=rows, seconds=wall, stats=stats, **rec)


def _get(port: int, path: str):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=60) as resp:
        return resp.read()


def _post(port: int, body: bytes, path: str = "/v1/infer", npz: bool = False) -> bytes:
    headers = {"Content-Type": "application/octet-stream"} if npz else {}
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=body,
                                 headers=headers, method="POST")
    with urllib.request.urlopen(req, timeout=300) as resp:
        return resp.read()


def _post_json(port: int, payload, path: str = "/v1/infer"):
    return json.loads(_post(port, json.dumps(payload).encode(), path))["outputs"]


def http_demo(out_dir: str, hw: int, clients: int = 12, max_batch: int = 8,
              device="cuda", seconds: float = 2.0, call=None) -> dict:
    """The same coalescing over HTTP: closed-loop clients for ``seconds``,
    the even ones sending JSON and the odd ones npz (each client's body
    encoded once, client ``i`` sending ``image(i, hw)``), against
    HttpFrontend + BatchingServer; then /stats and /metrics.  ``call`` as
    in ``server_demo``.  Returns each client's outputs, req/s and p50/p99
    per codec and in all, the stats and the metrics text."""
    call = call or load(out_dir, device)
    server = BatchingServer(lambda x: call(x["image"]), max_batch=max_batch, max_wait_ms=3.0,
                            pipeline=True, device=device)
    server.warmup({"image": np.zeros((3, hw, hw), np.float32)}, set_spec=True)
    front = HttpFrontend(server, port=0).start()
    bodies = [encode_npz({"image": image(i, hw)}) if i % 2 else
              json.dumps({"inputs": {"image": image(i, hw).tolist()}}).encode()
              for i in range(clients)]

    def request(i):
        if i % 2:  # the binary npz protocol
            return decode_npz(_post(front.port, bodies[i], npz=True))
        return np.asarray(json.loads(_post(front.port, bodies[i]))["outputs"], np.float32)

    try:
        outputs, latencies, wall = _closed_loop(clients, seconds, request)
        stats = json.loads(_get(front.port, "/stats"))
        metrics = _get(front.port, "/metrics").decode()
    finally:
        front.stop()
        server.stop()
    if "perceiver_requests_served" not in metrics:
        raise RuntimeError("/metrics lacks the counters")
    rec = dict(_rates(latencies, wall), json=_rates(latencies[0::2], wall),
               npz=_rates(latencies[1::2], wall))
    print(f"http: {clients} closed-loop clients over HTTP for {wall:.1f} s: "
          f"{rec['requests_per_s']:.1f} req/s (JSON {rec['json']['requests_per_s']:.1f}, "
          f"npz {rec['npz']['requests_per_s']:.1f}), p50 {rec['p50_ms']:.1f} ms  "
          f"p99 {rec['p99_ms']:.1f} ms")
    print(f"http GET /stats: {stats}")
    print("http GET /metrics (first lines):")
    print("\n".join(metrics.splitlines()[:4]))
    return dict(outputs=outputs, seconds=wall, stats=stats, metrics=metrics, **rec)


def multi_demo(out_dir: str, hw: int, device="cuda", full_scale: bool = False,
               call=None) -> dict:
    """Several models from one port: the exported classifier and a byte MLM
    (the published 2,048-byte model at full scale, a 64-byte one else), each
    behind its own BatchingServer (``max_batch=2``), routed by name; then a
    live request-deadline shed (504).  Returns the MLM's logits, the
    per-model requests served and the shed request's status.  ``call`` as
    in ``server_demo``."""
    device = resolve_device(device)
    cls_call = call or load(out_dir, device)
    generator = torch.Generator().manual_seed(1)
    mlm_kwargs = {} if full_scale else TINY_MLM
    mlm = LanguagePerceiver(**mlm_kwargs, policy=PERFORMANCE, device=device,
                            generator=generator).eval()
    seq_len = mlm_kwargs.get("max_seq_len", FULL_MLM_LEN)

    cls_server = BatchingServer(cls_call, max_batch=2, batch_sizes=(1, 2), device=device)
    mlm_server = BatchingServer(lambda b: mlm(b["tokens"], b["mask"]), max_batch=2,
                                batch_sizes=(1, 2), device=device)
    tokens = np.random.RandomState(2).randint(0, 262, (seq_len,)).astype(np.int32)
    mask = np.ones((seq_len,), bool)
    cls_server.warmup(np.zeros((3, hw, hw), np.float32))
    mlm_server.warmup({"tokens": tokens, "mask": mask})
    front = HttpFrontend({"imagenet": cls_server, "mlm": mlm_server},
                         default_model="imagenet", port=0).start()
    try:
        img = image(0, hw).tolist()
        row = _post_json(front.port, {"inputs": img}, "/v1/models/imagenet/infer")
        if np.asarray(row).ndim != 1:
            raise RuntimeError("the imagenet route did not return one row of logits")
        if np.asarray(_post_json(front.port, {"inputs": img})).ndim != 1:  # default route
            raise RuntimeError("the default route did not return one row of logits")
        logits = np.asarray(_post_json(
            front.port, {"inputs": {"tokens": tokens.tolist(), "mask": mask.tolist()}},
            "/v1/models/mlm/infer"), np.float32)
        if logits.shape != (seq_len, 262):
            raise RuntimeError(f"the mlm route returned {logits.shape}")
        print(f"multi: GET /v1/models -> {json.loads(_get(front.port, '/v1/models'))}")
        stats = json.loads(_get(front.port, "/stats"))
        served = {n: s["requests_served"] for n, s in stats.items()}
        print(f"multi: per-model requests_served = {served}")
    finally:
        front.stop()
        cls_server.stop()
        mlm_server.stop()

    # request deadline: hold a 1-deep server busy, let a 30 ms-deadline
    # request expire in the queue -> the server sheds it, the client sees 504
    release = threading.Event()
    slow = BatchingServer(lambda x: (release.wait(10), x + 1)[1], max_batch=1,
                          max_wait_ms=0.0, device=device)
    front2 = HttpFrontend(slow, port=0).start()
    blocker = slow.submit(np.zeros((1,), np.float32))
    time.sleep(0.1)
    status = {}

    def doomed():
        try:
            _post_json(front2.port, {"inputs": [0.0], "timeout_ms": 30})
            status["code"] = 200
        except urllib.error.HTTPError as e:
            status["code"] = e.code

    t = threading.Thread(target=doomed)
    try:
        t.start()
        time.sleep(0.3)
    finally:
        release.set()
        t.join(30)
        blocker.result(10)
        front2.stop()
    expired = slow.stats()["requests_expired"]
    slow.stop()
    if status.get("code") != 504 or expired != 1:
        raise RuntimeError(f"the deadline was not shed: {status}, requests_expired={expired}")
    print("multi: 30 ms-deadline request shed server-side -> HTTP 504"
          f" (requests_expired={expired})")
    return dict(mlm_logits=logits, requests_served=served, shed_status=status["code"],
                requests_expired=expired)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(), "perceiver_serve"))
    ap.add_argument("--full-scale", action="store_true",
                    help="shipped ImageNet conv-prep config")
    ap.add_argument("--requests", type=int, default=20)
    ap.add_argument("--seconds", type=float, default=2.0,
                    help="the closed-loop window of --server and --http")
    ap.add_argument("--server", action="store_true",
                    help="also demo the micro-batching BatchingServer")
    ap.add_argument("--http", action="store_true",
                    help="also demo the HTTP front end (JSON and npz)")
    ap.add_argument("--multi", action="store_true",
                    help="also demo multi-model routing + request deadlines")
    ap.add_argument("--quant", nargs="?", const="dynamic", default=None,
                    choices=["dynamic", "static"],
                    help="int8 export (static: calibrated on two seeded batches)")
    ap.add_argument("--device", default="cuda")
    add_cache_arg(ap)
    args = ap.parse_args(argv)
    enable_cache_if_requested(args)

    build(args.out, args.full_scale, device=args.device, quant=args.quant)
    hw = 224 if args.full_scale else TINY["img_size"][0]
    call = load(args.out, resolve_device(args.device))  # read back once, for every demo
    serve_demo(args.out, hw, batch_sizes=(1, 4, 16) if args.full_scale else (1, 4),
               requests=args.requests, device=args.device, call=call)
    if args.server:
        server_demo(args.out, hw, device=args.device, seconds=args.seconds, call=call)
    if args.http:
        http_demo(args.out, hw, device=args.device, seconds=args.seconds, call=call)
    if args.multi:
        multi_demo(args.out, hw, device=args.device, full_scale=args.full_scale, call=call)


if __name__ == "__main__":
    main()
