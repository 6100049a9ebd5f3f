"""Chip smoke test of the PyTorch/CUDA port (perceiverio_pytorch_tpu_torch).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases (each raises on failure; nothing is caught):
  1. device: requires CUDA, prints the card's name and power limit, turns
     TF32 off for the comparisons;
  2. build: compiles the flash attention kernels from csrc/ with nvcc, one
     process per source, all at once (K1 forward: the bf16 wgmma kernel and
     the fp32 CUDA-core kernel with the split-KV merge; K2 dK/dV and K3 dQ
     backward: the bf16 wgmma kernels with the sum of their split partials,
     and the fp32 CUDA-core kernels);
  3. kernel: holds K1 against its plain PyTorch version on the card
     at the three flow attention shapes (batch 1) in fp32 and bf16, at the
     serving forward's shapes (6 tiles, bf16), at the multimodal encoder
     (784 latents x 52,097 keys, one head of d = dv = 704: two value-column
     chunks) in fp32 and bf16, at small masked cases at widths 41 and 704
     (kv_mask, q_mask, ragged Tk, kv_logical_len, an all-masked row, lse),
     and at the classification encoders at the served batch of 16 (512
     latents x 50,176 keys, one head of d = dv = 261 for the pixel variant
     and 512 for the 1x1-conv one) in fp32 and bf16, unmasked and masked;
     records each call's route, key splits, column chunks, blocks and CUDA
     launches; times kernel, plain version,
     F.scaled_dot_product_attention (a yardstick only; null where it does
     not run) and the bound; then, at the bf16 flow encoder at batch 1 and
     at the bf16 multimodal encoder, holds the planned split count against a
     single split and two calls against each other bit for bit;
  4. backward kernels: holds K2 and K3 against the plain backward at the
     three flow sites (batch 1) in fp32 and bf16, at the multimodal encoder
     (d = dv = 704) in fp32 and bf16 and at masked cases at widths 41 and
     704 (exact zeros on wiped rows and tail keys); records each call's
     route, splits, column chunks, blocks and CUDA launches
     (``backward_plan``); times each kernel, the plain backward, SDPA's
     backward (forward+backward minus forward, a yardstick only; null where
     it does not run) and the bounds; then holds bf16 K2 at the flow decoder
     and K3 at the flow and multimodal encoders at their planned splits
     against a single split, and two calls of each (and of K2 at the
     multimodal encoder) against each other bit for bit;
  5. model: FlowPerceiver at full width (368x496 tiles, 2048x512 latents,
     24 self-attends), seeded random weights with a random decoder
     projection, fp32, once through the kernel (26 launches) and once with
     attention on the plain version; the two flows must agree;
  6. serve: three synthetic 436x1024 frame pairs through FlowInference under
     the PERFORMANCE policy (bf16), 6 tiles per request in one forward;
  7. gradients: the full-width model with remat, one endpoint-error loss
     on a synthetic roll pair and its backward through the kernels (per
     step: K1 26 + 24 recomputed, K2 26, K3 26), then with the flash forward
     and backward patched to their plain versions (which compute in fp32);
     every parameter's gradient must agree, in fp32 and in bf16
     (PERFORMANCE, through the wgmma kernels);
  8. train: the port's examples/train_flow.py at --full-scale (bf16
     PERFORMANCE, remat, batch 1, synthetic roll pairs) through its Trainer:
     one warm-up step, then timed steps with finite losses and parameters
     that move once the warmup's lr-0 step is past;
  9. multimodal model: MultiModalPerceiver at full width (16 frames of
     224x224, 30,720 audio samples, 700 classes, 784x512 latents, 8
     self-attends), seeded random weights, fp32, one synthetic clip decoded
     in 128 chunks, once through K1 (one launch and one merge: the encoder)
     and once with attention on the plain version; image, audio and label
     must agree;
 10. multimodal serve: three synthetic clips through the model under the
     PERFORMANCE policy (bf16, query-pad fold), after a warm-up clip: per-clip
     latency, clips/s, peak memory, K1 and merge launches per clip, and the
     last clip against the fp32 model;
 11. multimodal gradients: the full-width model with remat, 16 decoder
     chunks, one synthetic clip with a label and the training example's
     weighted loss, its backward through the kernels (per step: K1, its
     merge, K2 and K3 once each at the encoder, and in bf16 the sum of K3's
     key splits) and then with the flash forward and backward patched to
     their plain versions; every parameter's gradient must agree, in fp32
     and in bf16 (PERFORMANCE);
 12. multimodal train: the port's examples/train_multimodal.py at
     --full-scale (bf16 PERFORMANCE, remat, 16 chunks, batch 1, synthetic
     clips) through its Trainer: one warm-up step, then timed steps with
     finite losses, parameters that move once the warmup's lr-0 step is
     past, and the planned launches per step;
 13. classification model: ClassificationPerceiver at full width (224x224,
     512x1024 latents, 8 blocks of 6 self-attends, 1000 classes), one run
     for each PrepType, seeded random weights (random BatchNorm statistics),
     fp32 in eval mode, two synthetic images, once through K1 (the pixel
     and 1x1-conv encoders: one launch and, at batch 2, one merge; the
     convnet: none) and once with attention on the plain version; the
     logits must agree;
 14. classification serve: each PrepType under PERFORMANCE (bf16) at batch
     16, one warm-up request then three timed ones: images/s, request
     latency, peak memory, K1 launches per request, and the last request's
     logits and top-1 against the fp32 model's;
 15. language serve: LanguagePerceiver at full width (2,048 bytes, 768
     channels, 256x1280 latents, 26 self-attends) at batch 32 on seeded
     text, encoded with the byte tokenizer, with a masked span and right
     padding (input masks): fp32 and bf16 (PERFORMANCE), the logits at a
     set of positions by ``predict_positions`` against those rows of the
     full decode, then three timed bf16 requests after a warm-up: sequences/s,
     latency, peak memory; every site is dense, so no K1 launch;
 16. classification kernels, at the training batch of 8 (512 latents x
     50,176 keys, d = dv = 261 and 512), after the flow and multimodal
     phases so that their large blocks leave those phases' allocator state
     alone: K1 with its lse, as training calls it, in fp32 and bf16,
     unmasked and masked, against the plain version, its plan 4 key splits
     and a merge; K2 and K3 against the plain backward in fp32 and bf16, as
     in phase 4; bf16 K3 at the pixel encoder at its planned splits against
     one split, and two calls bit for bit;
 17. classification gradients: the full-width pixel and 1x1-conv
     classifiers with remat, two synthetic images with random labels and
     the cross-entropy, the backward through the kernels (per step: K1 and
     its merge, K2 and K3 once each at the encoder, d = 261 or 512, and in
     bf16 the sum of K3's key splits) and then with the flash forward and
     backward patched to their plain versions; every parameter's gradient
     must agree, in fp32 and in bf16 (PERFORMANCE);
 18. classification train: the port's examples/train_classification.py at
     --full-scale (bf16 PERFORMANCE, remat, batch 8, synthetic quadrant
     images) for the convnet (train-mode BatchNorm), then through the same
     setup for the pixel and 1x1-conv variants: one warm-up step, then
     ten timed steps with finite losses, parameters that move once the
     warmup's lr-0 step is past and the planned launches per step (none for
     the convnet; K1 and its merge, K2, K3 and its sum for the others); for
     the convnet, running averages that moved and that evaluation uses;
 19. language train: the port's examples/train_mlm.py at --full-scale
     (bf16 PERFORMANCE, batch 8, 2,048 bytes): one warm-up step, then 11
     timed steps with finite losses, parameters that move, evaluation lines
     at the mid and final steps (timed apart, and left out of the steps'
     times), and no kernel launch;
 20. server buckets: K1 at the classification encoders (d = 261 and 512,
     50,176 keys) at batches 1, 2 and 4, bf16 with its lse, against the
     plain version, each plan's splits (33, 16, 8) and merge asserted; K1's
     torch.library op through torch.ops against the direct launch, bit for
     bit;
 21. export: the full-width bf16 1x1-conv classifier (eval mode, weights
     cast by cast_variables_for_inference) through export_apply(...,
     batch_polymorphic=True) on the card: the graph holds K1's op once and
     the artifact no parameter (its bytes against the weights' printed);
     load_exported from the bytes at batches 1, 4 and 16 against the eager
     model (EXPORT_TOL), K1 once a call; p50/p99 latency and images/s of
     the artifact beside the eager model's.  The pixel variant goes through
     export and one batch;
 22. server: the serving example's server_demo over the reloaded artifact,
     24 clients in closed loop for 6 s against BatchingServer(max_batch=8,
     max_wait_ms=3), pipeline off, on, off, on: every row against
     batch-of-one calls (SERVE_TOL), K1 launches equal to the batches
     dispatched and the warm-up's, req/s over the window, p50/p99 over
     every request, occupancy, buckets; then 4 requests grouped into one
     batch, bit for bit against a direct call of that batch;
 23. HTTP: the serving example's http_demo over the artifact, 12 clients in
     closed loop for 6 s (half JSON, half npz, rates apart), every answer
     against batch-of-one calls, /stats and /metrics; then its multi_demo:
     the artifact as "imagenet" and the full-width LanguagePerceiver as
     "mlm" behind one port (max_batch 2), and a 30 ms deadline shed as
     HTTP 504;
 24. serving example: examples/serve.py --full-scale --server --http
     --requests 5 --seconds 2 (the convnet: no kernel launch) into a
     temporary directory;
 25. prints the kernels line and, last, {"ok": true, "device": {...}}.

It exits non-zero without a result when there is no GPU or when the port's
package is not beside it.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from unittest import mock

SEED = 0
ROOT = os.path.dirname(os.path.abspath(__file__))
# Peak rates of one H100 SXM (NVIDIA data sheet, dense): fp32 on the CUDA
# cores, bf16 on the tensor cores, HBM3 bandwidth.
PEAK_FLOPS = {"fp32": 67e12, "bf16": 989e12}
PEAK_BYTES = 3.35e12
# Tolerances of kernel vs plain version, relative to max|out|: fp32 against
# fp32; bf16 against the plain version run in fp32 on the same bf16 inputs
# (the kernel's output is rounded to bf16, a relative step of 2^-8).
TOL = {"fp32": 1e-4, "bf16": 2e-2}
# Full-width fp32 model, kernel vs plain attention, relative to max|flow|.
MODEL_TOL = 1e-3
# Full-width fp32 gradients, kernels vs plain attention, per parameter,
# relative to that parameter's max|grad| (the worst measured on an H100 was
# 4.9e-5, at the decoder's key projection).
GRAD_TOL = 2e-4
# The same in bf16 (PERFORMANCE): the kernels round P, dS and every output
# to bf16, the plain versions compute in fp32 and round only their outputs
# (the worst measured on an H100 was 4.7e-2, again at the decoder's key
# projection, whose exact gradient nearly cancels; about twice that).
BF16_GRAD_TOL = 1e-1
# Launches per bf16 training step of the flow model with remat: 26 attention
# sites, the 24 self-attends' forward recomputed in the backward; at batch 1
# the encoder's K1 splits its keys and merges them once, the decoder's K2
# splits its query rows and the encoder's K3 its keys, each summed once.  The
# fp32 kernels of K2 and K3 never split.
STEP_LAUNCHES = {"K1": 26 + 24, "K2": 26, "K3": 26, "merge": 1, "sum": 2}
FP32_STEP_LAUNCHES = dict(STEP_LAUNCHES, sum=0)
TRAIN_STEPS = 6  # timed, after one warm-up step

FLOW_SITES = {
    # name: (B, Tq, Tk, H, D, Dv) of the flow model's attention sites
    "encoder": (1, 2048, 182528, 1, 322, 322),
    "self": (1, 2048, 2048, 16, 32, 32),
    "decoder": (1, 182528, 2048, 1, 512, 512),
}
SITE_LAUNCHES = {"encoder": 1, "self": 24, "decoder": 1}
# Tiles of one 436x1024 request: the batch the serving forward gives K1.
SERVE_TILES = 6
# The multimodal model's one K1 site: its encoder cross-attend, (B, Tq, Tk,
# H, D, Dv) for one clip (784 latents; 50,176 image + 1,920 audio + 1 label
# tokens, padded to 700 + 4 channels).
MM_SITE = (1, 784, 52097, 1, 704, 704)
MM_CHUNKS = 128
# The full-width bf16 model against the fp32 one on the same clip, relative
# to each output's max |x|: bf16 GEMMs through 10 attention blocks.
MM_BF16_TOL = 1e-1
# Multimodal training (examples/train_multimodal.py --full-scale): 16
# decoder chunks, remat.  Per step the encoder's cross-attend is the one
# flash site, outside every checkpoint: K1 once with its merge, K2 and K3
# once; in bf16 K3 splits the keys and sums them once, K2 does not split.
MM_TRAIN_CHUNKS = 16
MM_STEP_LAUNCHES = {"K1": 1, "K2": 1, "K3": 1, "merge": 1, "sum": 1}
MM_FP32_STEP_LAUNCHES = dict(MM_STEP_LAUNCHES, sum=0)
MM_TRAIN_STEPS = 3  # timed, after one warm-up step
MM_LABEL = 123  # the synthetic clip's class in the gradient phase
# The classification model's K1 sites: the pixel and 1x1-conv encoders'
# cross-attends at the served batch (512 latents; 50,176 tokens of 3 + 258
# Fourier channels, or of 256 conv + 256 projected position channels).
CLS_SITES = {"cls_pixel": (16, 512, 50176, 1, 261, 261),
             "cls_1x1conv": (16, 512, 50176, 1, 512, 512)}
CLS_SITE_OF = {"FOURIER_POS_PIXEL": "cls_pixel", "LEARNED_POS_1X1CONV": "cls_1x1conv",
               "FOURIER_POS_CONVNET": None}
CLS_MODEL_BATCH = 2
CLS_SERVE_BATCH = 16  # the JAX bench's ImageNet batch
CLS_REQUESTS = 3  # timed, after one warm-up request
# The bf16 logits against the fp32 ones on the same images, relative to
# their max |x|: bf16 GEMMs through 49 attention blocks.
CLS_BF16_TOL = 1e-1
# K2/K3 at the classification encoders at the training batch
# (examples/train_classification.py --full-scale): (B, Tq, Tk, H, D, Dv).
CLS_TRAIN_SITES = {"cls_pixel": (8, 512, 50176, 1, 261, 261),
                   "cls_1x1conv": (8, 512, 50176, 1, 512, 512)}
# K1's plan there, on both routes: 4 key splits and their merge.
CLS_TRAIN_K1_PLAN = {"splits": 4, "cuda_launches": 2}
# Launches per training step of the pixel or 1x1-conv classifier (remat of
# the self-attend stack, batch 2 or 8): the encoder's cross-attend, outside
# every checkpoint, is the one flash site: K1 with its merge, K2 and K3 once;
# in bf16 K3 splits the keys and sums them once, K2 does not split.  The
# convnet's sites are all dense.
CLS_STEP_LAUNCHES = {"K1": 1, "K2": 1, "K3": 1, "merge": 1, "sum": 1}
CLS_FP32_STEP_LAUNCHES = dict(CLS_STEP_LAUNCHES, sum=0)
NO_LAUNCHES = {"K1": 0, "K2": 0, "K3": 0, "merge": 0, "sum": 0}
CLS_TRAIN_STEPS = 10  # timed, after one warm-up step
# Timed, after one warm-up step: 12 steps in all, so that train_mlm's
# eval_every (steps // 2) puts its evaluations at the mid and final steps.
LM_TRAIN_STEPS = 11
LM_BATCH = 32  # the JAX bench's MLM batch
LM_REQUESTS = 3
LM_SPAN = (200, 264)  # the masked bytes, predicted by predict_positions
# Rows at predict_positions against the full decode, relative to its max
# |logit|: the same attention rows, but cuBLAS may pick another GEMM
# algorithm for fewer rows (fp32), and bf16 rounds differently there.
LM_ROWS_TOL = {"fp32": 1e-5, "bf16": 2e-2}
LM_BF16_TOL = 1e-1  # bf16 logits against fp32, relative to max |logit|
# The serving stack (phases 20 to 24).  K1 at the classification encoders at
# the server's buckets below 8 (8 and 16 are held in phases 16 and 3): (B,
# Tq, Tk, H, D, Dv) for the pixel (d = 261) and 1x1-conv (d = 512) variants,
# and the key splits each bucket's plan must take (a merge after each).
BUCKET_SPLITS = {1: 33, 2: 16, 4: 8}
BUCKET_SITES = {f"{site}_bucket{b}": (b,) + CLS_SITES[site][1:]
                for site in CLS_SITES for b in BUCKET_SPLITS}
EXPORT_BATCHES = (1, 4, 16)
EXPORT_REQUESTS = 10  # timed per batch, after one warm-up call
# The reloaded artifact against the eager model on the same bf16 weights and
# images, relative to max |logit|: the same ATen ops and kernels, so equal
# but for a GEMM algorithm cuBLAS might pick otherwise (measured: bit for
# bit, see "bitwise" in the phase's line).
EXPORT_TOL = 2e-2
# A served row against a batch-of-one call of the artifact, relative to max
# |logit|: K1's plan (key splits) and cuBLAS's GEMM tiling change with the
# bucket, and bf16 rounds each of the 49 attention blocks' outputs, as
# every bf16 comparison of the port with the JAX package (5%).
SERVE_TOL = 5e-2
SERVER_CLIENTS = 24
SERVER_PIPELINES = (False, True, False, True)  # one closed-loop window each, alternated
HTTP_CLIENTS = 12
SERVE_WINDOW_S = 6.0  # each closed-loop window of the server and HTTP phases


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` launches (CUDA events)."""
    import torch

    fn()  # warm-up
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    line = smi_line()
    print(f"[device] {torch.cuda.get_device_name(0)} | nvidia-smi: {line} |"
          f" torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    return line


def phase_build():
    from perceiverio_pytorch_tpu_torch.ops import flash_attention as fa

    t0 = time.perf_counter()
    paths = fa.build()
    fa._load()
    print(f"[build] {paths} in {time.perf_counter() - t0:.1f} s", flush=True)


def _case_inputs(b, tq, tk, h, d, dv, dtype, masked, gen):
    import torch

    dev = "cuda"
    q = torch.randn(b, tq, h, d, generator=gen, device=dev).to(dtype)
    k = torch.randn(b, tk, h, d, generator=gen, device=dev).to(dtype)
    v = torch.randn(b, tk, h, dv, generator=gen, device=dev).to(dtype)
    kw = {}
    if masked:
        kv_mask = torch.rand(b, tk, generator=gen, device=dev) > 0.3
        kv_mask[-1] = False  # every row of the last batch entry is all-masked
        kw = dict(
            kv_mask=kv_mask,
            q_mask=torch.rand(b, tq, generator=gen, device=dev) > 0.2,
            kv_logical_len=tk - 50,
            return_lse=True,
        )
    return q, k, v, kw


def _flops_and_bytes(q, k, v, kw):
    """Operations and bytes this call's data needs: valid (query, key) pairs
    only; each input read once, the output (and lse) written once."""
    import torch

    b, tq, h, d = q.shape
    tk, dv = k.shape[1], v.shape[3]
    kv_len = kw.get("kv_logical_len") or tk
    keys = torch.arange(tk, device=q.device)[None].expand(b, tk) < kv_len
    if kw.get("kv_mask") is not None:
        keys = keys & kw["kv_mask"]
    rows = kw["q_mask"] if kw.get("q_mask") is not None else torch.ones(
        b, tq, dtype=torch.bool, device=q.device)
    pairs = int((rows.sum(1) * keys.sum(1)).sum())
    flops = 2.0 * h * (d + dv) * pairs
    size = q.element_size()
    nbytes = size * (q.numel() + k.numel() + v.numel() + b * tq * h * dv)
    for name in ("kv_mask", "q_mask"):
        if kw.get(name) is not None:
            nbytes += kw[name].numel()
    if kw.get("return_lse"):
        nbytes += 4 * b * h * tq
    return flops, nbytes


def _library_ms(q, k, v, kw, reps):
    """SDPA's time on the same tensors, or None where no SDPA backend takes
    them (the yardstick is optional; the kernel is not)."""
    try:
        return time_ms(_library_call(q, k, v, kw), reps)
    except RuntimeError as exc:
        print(f"[kernel] no SDPA at {tuple(q.shape)} x {tuple(k.shape)}: {exc}"[:300],
              flush=True)
        return None


def _library_call(q, k, v, kw):
    import torch
    import torch.nn.functional as F

    mask = None
    if kw.get("kv_mask") is not None:
        tk = k.shape[1]
        keys = torch.arange(tk, device=q.device)[None] < kw["kv_logical_len"]
        mask = (keys & kw["kv_mask"])[:, None, None, :]
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    return lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, scale=1.0 / math.sqrt(q.shape[-1]))


def check_case(name, shape, dtype_name, masked, reps, gen, lse=False, want_plan=None):
    """Kernel vs plain version at one shape (with ``lse``, the lse too, as a
    masked case always has it; with ``want_plan``, these keys of the launch
    plan must hold); returns a result record."""
    import torch

    from perceiverio_pytorch_tpu_torch.ops import flash_attention as fa

    dtype = {"fp32": torch.float32, "bf16": torch.bfloat16}[dtype_name]
    q, k, v, kw = _case_inputs(*shape, dtype, masked, gen)
    if lse:
        kw["return_lse"] = True
    plan = fa.launch_plan(q, k, v, kv_logical_len=kw.get("kv_logical_len"))
    if want_plan and any(plan[key] != val for key, val in want_plan.items()):
        raise AssertionError(f"{name}/{dtype_name}: plan {plan}, expected {want_plan}")
    with torch.inference_mode():
        before = fa.LAUNCHES + fa.LAUNCHES_MERGE
        got = fa.flash_attention(q, k, v, **kw)
        cuda_launches = fa.LAUNCHES + fa.LAUNCHES_MERGE - before
        if cuda_launches != plan["cuda_launches"]:
            raise AssertionError(f"{name}/{dtype_name}: {cuda_launches} CUDA launches, "
                                 f"planned {plan}")
        want = fa.flash_attention_reference(q.float(), k.float(), v.float(), **kw)
        torch.cuda.synchronize()
        lse_err = None
        if kw.get("return_lse"):
            (got, got_lse), (want, want_lse) = got, want
            finite = torch.isfinite(want_lse)
            if not torch.equal(finite, torch.isfinite(got_lse)):
                raise AssertionError(f"{name}/{dtype_name}: lse +inf rows differ")
            lse_err = (got_lse[finite] - want_lse[finite]).abs().max().item()
            if lse_err > 1e-4 * (1.0 + want_lse[finite].abs().max().item()):
                raise AssertionError(f"{name}/{dtype_name}: lse error {lse_err}")
        if masked:
            wiped = ~kw["q_mask"]
            wiped[-1] = True  # all keys masked
            if got.view(q.shape[0], q.shape[1], -1)[wiped].abs().max().item() != 0.0:
                raise AssertionError(f"{name}/{dtype_name}: wiped rows are not 0")
        got = got.float()
        if not torch.isfinite(got).all():
            raise AssertionError(f"{name}/{dtype_name}: non-finite kernel output")
        err = (got - want).abs().max().item()
        scale = want.abs().max().item()
        if not err <= TOL[dtype_name] * scale:
            raise AssertionError(
                f"{name}/{dtype_name}: max abs err {err} > {TOL[dtype_name]} * {scale}")

        kernel_ms = time_ms(lambda: fa.flash_attention(q, k, v, **kw), reps)
        plain_ms = time_ms(
            lambda: fa.flash_attention_reference(q, k, v, **kw), reps)
        library_ms = _library_ms(q, k, v, kw, reps)
    flops, nbytes = _flops_and_bytes(q, k, v, kw)
    flops_ms = flops / PEAK_FLOPS[dtype_name] * 1e3
    bytes_ms = nbytes / PEAK_BYTES * 1e3
    rec = dict(
        site=name, dtype=dtype_name, shape=list(shape), route=plan["route"],
        splits=plan["splits"], col_chunks=plan["col_chunks"], blocks=plan["blocks"],
        cuda_launches=cuda_launches,
        max_abs_err=err, max_abs_out=scale, lse_err=lse_err, ms=kernel_ms, plain_ms=plain_ms,
        library_ms=library_ms, bound_ms=max(flops_ms, bytes_ms),
        bound_by="operations" if flops_ms >= bytes_ms else "bytes",
        flops=flops, tflops=flops / kernel_ms / 1e9,
    )
    print(f"[kernel] {json.dumps(rec)}", flush=True)
    return rec


def phase_kernels(reps: int = 3):
    import torch

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    records = []
    for dtype_name in ("fp32", "bf16"):
        for name, shape in FLOW_SITES.items():
            records.append(check_case(name, shape, dtype_name, False, reps, gen))
        records.append(check_case(
            "masked", (2, 100, 777, 2, 41, 64), dtype_name, True, reps, gen))
        records.append(check_case("mm_encoder", MM_SITE, dtype_name, False, reps, gen))
        records.append(check_case(
            "mm_masked", (2, 100, 777, 1, 704, 704), dtype_name, True, reps, gen))
        for name, shape in CLS_SITES.items():
            records.append(check_case(name, shape, dtype_name, False, reps, gen))
            records.append(check_case(f"{name}_masked", shape, dtype_name, True, reps, gen))
    for name, shape in FLOW_SITES.items():  # the serving forward's shapes
        records.append(check_case(
            name, (SERVE_TILES,) + shape[1:], "bf16", False, reps, gen))
    check_splits(gen, "encoder", FLOW_SITES["encoder"])
    check_splits(gen, "mm_encoder", MM_SITE)
    return records


def check_splits(gen, site, shape):
    """At a bf16 site whose short grid splits the keys: the planned split
    count against one split (within the bf16 tolerance), and two calls bit
    for bit."""
    import torch

    from perceiverio_pytorch_tpu_torch.ops import flash_attention as fa

    q, k, v, _ = _case_inputs(*shape, torch.bfloat16, False, gen)
    with torch.inference_mode():
        planned, planned_lse = fa.flash_attention(q, k, v, return_lse=True)
        again, again_lse = fa.flash_attention(q, k, v, return_lse=True)
        one, one_lse = fa._flash_attention_cuda(
            q, k, v, q_mask=None, kv_mask=None, softmax_scale=None, kv_logical_len=None,
            return_lse=True, num_splits=1)
        torch.cuda.synchronize()
    splits = fa.launch_plan(q, k, v)["splits"]
    if splits < 2:
        raise AssertionError(f"the {site} should split its keys, plan {splits}")
    if not (torch.equal(planned, again) and torch.equal(planned_lse, again_lse)):
        raise AssertionError(f"{site}: two K1 calls on the same inputs differ")
    err = (planned.float() - one.float()).abs().max().item()
    scale = one.float().abs().max().item()
    lse_err = (planned_lse - one_lse).abs().max().item()
    if not (err <= TOL["bf16"] * scale and lse_err <= 1e-4 * (1 + one_lse.abs().max().item())):
        raise AssertionError(
            f"{site}: {splits} splits vs 1: out {err} (max {scale}), lse {lse_err}")
    rec = dict(site=site, dtype="bf16", splits=splits, max_abs_diff_vs_1_split=err,
               max_abs_out=scale, lse_diff_vs_1_split=lse_err, bitwise_repeat=True)
    print(f"[kernel] splits: {json.dumps(rec)}", flush=True)


def _bwd_flops_and_bytes(q, k, v, kw):
    """Per kernel, the operations and bytes this call's data needs: valid
    (query, key) pairs only, 4d + 4dv FLOP a pair and head for K2 (dK, dV)
    and 4d + 2dv for K3 (dQ); q, k, v, dO, lse, delta and kv_mask read once,
    each kernel's outputs written once."""
    b, tq, h, d = q.shape
    tk, dv = k.shape[1], v.shape[3]
    pairs = _flops_and_bytes(q, k, v, kw)[0] / (2.0 * h * (d + dv))
    size = q.element_size()
    inputs = size * (q.numel() + k.numel() + v.numel() + b * tq * h * dv)
    inputs += 2 * 4 * b * h * tq
    if kw.get("kv_mask") is not None:
        inputs += kw["kv_mask"].numel()
    return {
        "K2": ((4 * d + 4 * dv) * h * pairs, inputs + size * (k.numel() + v.numel())),
        "K3": ((4 * d + 2 * dv) * h * pairs, inputs + size * q.numel()),
    }


def _library_backward_ms(q, k, v, grad, kw, reps):
    """F.scaled_dot_product_attention forward+backward minus its forward, on
    the same tensors: a yardstick for K2+K3 (the port never calls it), or
    None where no SDPA backend takes them."""
    import torch

    qt, kt, vt = (x.detach().transpose(1, 2).requires_grad_() for x in (q, k, v))
    fwd = _library_call(qt.transpose(1, 2), kt.transpose(1, 2), vt.transpose(1, 2), kw)
    b, tq, h = q.shape[:3]
    g = grad.view(b, tq, h, -1).transpose(1, 2)

    def fwd_bwd():
        torch.autograd.grad(fwd(), (qt, kt, vt), g)

    try:
        with torch.enable_grad():
            total = time_ms(fwd_bwd, reps)
            forward = time_ms(fwd, reps)
    except RuntimeError as exc:
        print(f"[backward] no SDPA backward at {tuple(q.shape)} x {tuple(k.shape)}: {exc}"[:300],
              flush=True)
        return None
    return total - forward


def check_backward_case(name, shape, dtype_name, masked, reps, gen):
    """K2 and K3 vs the plain backward at one shape; returns one record per
    kernel."""
    import torch

    from perceiverio_pytorch_tpu_torch.ops import flash_attention as fa

    dtype = {"fp32": torch.float32, "bf16": torch.bfloat16}[dtype_name]
    q, k, v, kw = _case_inputs(*shape, dtype, masked, gen)
    kw.pop("return_lse", None)
    with torch.no_grad():
        out, lse = fa.flash_attention(q, k, v, return_lse=True, **kw)
        grad = torch.randn(out.shape, generator=gen, device="cuda").to(dtype)
        args = (q, k, v, out, lse, grad)
        kernels = fa.BackwardKernels(*args, q_mask=kw.get("q_mask"),
                                     kv_mask=kw.get("kv_mask"), softmax_scale=None,
                                     kv_logical_len=kw.get("kv_logical_len"))
        plan = kernels.plan
        want_route = "sm90_wgmma" if dtype_name == "bf16" else "cuda_cores"
        if plan["route"] != want_route:
            raise AssertionError(f"{name}/{dtype_name}: route {plan['route']}")
        cuda_launches = {}
        for kernel, run in (("K2", kernels.dkv), ("K3", kernels.dq)):
            before = fa.LAUNCHES_BWD_DKV + fa.LAUNCHES_BWD_DQ + fa.LAUNCHES_BWD_SUM
            run()
            cuda_launches[kernel] = (fa.LAUNCHES_BWD_DKV + fa.LAUNCHES_BWD_DQ
                                     + fa.LAUNCHES_BWD_SUM - before)
            planned = plan["dkv" if kernel == "K2" else "dq"]["cuda_launches"]
            if cuda_launches[kernel] != planned:
                raise AssertionError(f"{name}/{dtype_name}: {kernel} made "
                                     f"{cuda_launches[kernel]} CUDA launches, planned {plan}")
        got = {"dq": kernels.grad_q, "dk": kernels.grad_k, "dv": kernels.grad_v}
        want = dict(zip(("dq", "dk", "dv"), fa.flash_attention_backward_reference(
            *(x.float() for x in args), **kw)))
        torch.cuda.synchronize()
        errs = {}
        for key in got:
            g = got[key].float()
            if not torch.isfinite(g).all():
                raise AssertionError(f"{name}/{dtype_name}: non-finite {key}")
            err = (g - want[key]).abs().max().item()
            peak = want[key].abs().max().item()
            if not err <= TOL[dtype_name] * peak:
                raise AssertionError(
                    f"{name}/{dtype_name}: {key} max abs err {err} > {TOL[dtype_name]} * {peak}")
            errs[key] = (err, peak)
        if masked:
            tail = kw["kv_logical_len"]
            wiped_rows = ~kw["q_mask"]
            wiped_rows[-1] = True  # all keys masked
            exact = (got["dq"][wiped_rows].abs().max().item(),
                     got["dk"][:, tail:].abs().max().item(),
                     got["dv"][:, tail:].abs().max().item(),
                     got["dk"][-1].abs().max().item(), got["dv"][-1].abs().max().item())
            if any(x != 0.0 for x in exact):
                raise AssertionError(f"{name}/{dtype_name}: wiped gradients not 0: {exact}")

        ms = {"K2": time_ms(kernels.dkv, reps), "K3": time_ms(kernels.dq, reps)}
        plain_ms = time_ms(
            lambda: fa.flash_attention_backward_reference(*args, **kw), reps)
    library_ms = _library_backward_ms(q, k, v, grad, kw, reps)
    records = []
    for kernel, (flops, nbytes) in _bwd_flops_and_bytes(q, k, v, kw).items():
        flops_ms = flops / PEAK_FLOPS[dtype_name] * 1e3
        bytes_ms = nbytes / PEAK_BYTES * 1e3
        keys = ("dk", "dv") if kernel == "K2" else ("dq",)
        kplan = plan["dkv" if kernel == "K2" else "dq"]
        rec = dict(
            kernel=kernel, site=name, dtype=dtype_name, shape=list(shape),
            route=plan["route"], splits=kplan["splits"], col_chunks=kplan["col_chunks"],
            blocks=kplan["blocks"], cuda_launches=cuda_launches[kernel],
            max_abs_err=max(errs[key][0] for key in keys),
            max_abs_grad=max(errs[key][1] for key in keys),
            ms=ms[kernel], plain_ms=plain_ms, library_ms=library_ms,
            bound_ms=max(flops_ms, bytes_ms),
            bound_by="operations" if flops_ms >= bytes_ms else "bytes",
            flops=flops, tflops=flops / ms[kernel] / 1e9,
        )
        print(f"[backward] {json.dumps(rec)}", flush=True)
        records.append(rec)
    return records


def phase_backward(reps: int = 3):
    import torch

    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    records = []
    for dtype_name in ("fp32", "bf16"):
        for name, shape in FLOW_SITES.items():
            records += check_backward_case(name, shape, dtype_name, False, reps, gen)
        records += check_backward_case(
            "masked", (2, 100, 777, 2, 41, 64), dtype_name, True, reps, gen)
        records += check_backward_case("mm_encoder", MM_SITE, dtype_name, False, reps, gen)
        records += check_backward_case(
            "mm_masked", (2, 100, 777, 1, 704, 704), dtype_name, True, reps, gen)
    check_backward_splits(gen, (("K2", "decoder", FLOW_SITES["decoder"]),
                                ("K3", "encoder", FLOW_SITES["encoder"]),
                                ("K3", "mm_encoder", MM_SITE), ("K2", "mm_encoder", MM_SITE)))
    return records


def check_backward_splits(gen, cases):
    """At each (kernel, site, shape) of ``cases``, bf16: the planned split
    count against one split (within the bf16 tolerance), and two calls bit
    for bit; K2 at the multimodal encoder, which does not split, two calls
    bit for bit."""
    import torch

    from perceiverio_pytorch_tpu_torch.ops import flash_attention as fa

    for kernel, site, shape in cases:
        q, k, v, _ = _case_inputs(*shape, torch.bfloat16, False, gen)
        with torch.no_grad():
            out, lse = fa.flash_attention(q, k, v, return_lse=True)
            grad = torch.randn(out.shape, generator=gen, device="cuda").to(torch.bfloat16)
            results = []
            for splits in (None, None, 1):
                kernels = fa.BackwardKernels(q, k, v, out, lse, grad, q_mask=None,
                                             kv_mask=None, softmax_scale=None,
                                             kv_logical_len=None, num_splits=splits)
                if kernel == "K2":
                    kernels.dkv()
                    results.append((kernels.grad_k, kernels.grad_v))
                else:
                    kernels.dq()
                    results.append((kernels.grad_q,))
            torch.cuda.synchronize()
        planned = fa.backward_plan(q, k, v)["dkv" if kernel == "K2" else "dq"]["splits"]
        must_split = (kernel, site) != ("K2", "mm_encoder")
        if (planned > 1) != must_split:
            raise AssertionError(f"{kernel} at the {site}: unexpected plan of {planned} splits")
        if not all(torch.equal(x, y) for x, y in zip(results[0], results[1])):
            raise AssertionError(f"two {kernel} calls at the {site} on the same inputs differ")
        diffs = [((x.float() - y.float()).abs().max().item(), y.float().abs().max().item())
                 for x, y in zip(results[0], results[2])]
        for err, peak in diffs:
            if not err <= TOL["bf16"] * peak:
                raise AssertionError(f"{kernel}: {planned} splits vs 1: {err} (max {peak})")
        rec = dict(kernel=kernel, site=site, dtype="bf16", splits=planned,
                   max_abs_diff_vs_1_split=max(d[0] for d in diffs),
                   max_abs_grad=max(d[1] for d in diffs), bitwise_repeat=True)
        print(f"[backward] splits: {json.dumps(rec)}", flush=True)


def phase_cls_kernels(reps: int = 3):
    """K1, K2 and K3 at the classification encoders at the training batch of
    8, where training runs them (after the flow and multimodal phases, so
    that their large blocks do not change the allocator state those phases
    start from): K1 with its lse (as the autograd Function asks for it) in
    fp32 and bf16, unmasked and masked, its plan 4 key splits and a merge;
    K2 and K3 against the plain backward in fp32 and bf16; bf16 K3 at the
    pixel encoder at its planned splits against one split, and two calls bit
    for bit.  Returns the K1 and the K2/K3 records."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(SEED + 14)
    forward, backward = [], []
    for dtype_name in ("fp32", "bf16"):
        for name, shape in CLS_TRAIN_SITES.items():
            for masked in (False, True):
                forward.append(check_case(
                    f"{name}_train" + ("_masked" if masked else ""), shape, dtype_name,
                    masked, reps, gen, lse=True, want_plan=CLS_TRAIN_K1_PLAN))
            backward += check_backward_case(name, shape, dtype_name, False, reps, gen)
    check_backward_splits(gen, (("K3", "cls_pixel", CLS_TRAIN_SITES["cls_pixel"]),))
    return forward, backward


def _flow_model(policy, remat=False):
    import torch

    from perceiverio_pytorch_tpu_torch import FlowPerceiver
    from perceiverio_pytorch_tpu_torch.utils.initializers import lecun_normal_

    gen = torch.Generator().manual_seed(SEED)
    model = FlowPerceiver(img_size=(368, 496), policy=policy, remat=remat,
                          device="cuda", generator=gen)
    # The decoder projection is zero-initialised by design, which makes a
    # fresh model's flow exactly 0; draw it at random so the check sees
    # the whole path.
    weight = model.perceiver._decoder.final_layer.weight
    with torch.no_grad():
        weight.copy_(lecun_normal_(torch.empty(weight.shape), gen))
    return model.eval()


def _smooth_frame(gen, height, width):
    """A seeded smooth image in [-1, 1]: a sum of random 2-D sinusoids."""
    import torch

    y = torch.linspace(0, 1, height)[:, None]
    x = torch.linspace(0, 1, width)[None, :]
    img = torch.zeros(3, height, width)
    for c in range(3):
        for _ in range(4):
            fy, fx, ph = (torch.rand(3, generator=gen) * torch.tensor([6.0, 6.0, 6.28])).tolist()
            img[c] += torch.sin(2 * math.pi * (fy * y + fx * x) + ph)
    return (img / img.abs().max()).clamp(-1, 1)


def phase_model():
    import torch

    from perceiverio_pytorch_tpu_torch.config import PARITY
    from perceiverio_pytorch_tpu_torch.ops import attention as attention_ops
    from perceiverio_pytorch_tpu_torch.ops import flash_attention as fa

    model = _flow_model(dataclasses.replace(PARITY, attn_impl="auto"))
    gen = torch.Generator().manual_seed(SEED + 1)
    frame = _smooth_frame(gen, 368, 496)
    img1 = frame[None].cuda()
    img2 = torch.roll(frame, shifts=(2, 3), dims=(1, 2))[None].cuda()
    with torch.inference_mode():
        fa.LAUNCHES = 0
        t0 = time.perf_counter()
        flow_kernel = model(img1, img2)
        torch.cuda.synchronize()
        kernel_s = time.perf_counter() - t0
        launches = fa.LAUNCHES
        with mock.patch.object(attention_ops, "flash_attention",
                               fa.flash_attention_reference):
            t0 = time.perf_counter()
            flow_plain = model(img1, img2)
            torch.cuda.synchronize()
            plain_s = time.perf_counter() - t0
    if launches != 26:
        raise AssertionError(f"expected 26 kernel launches, got {launches}")
    if tuple(flow_kernel.shape) != (1, 2, 368, 496):
        raise AssertionError(f"flow shape {tuple(flow_kernel.shape)}")
    if not (torch.isfinite(flow_kernel).all() and torch.isfinite(flow_plain).all()):
        raise AssertionError("non-finite flow")
    peak = flow_plain.abs().max().item()
    diff = (flow_kernel - flow_plain).abs().max().item()
    if not peak > 0:
        raise AssertionError("flow is identically zero")
    if not diff <= MODEL_TOL * peak:
        raise AssertionError(f"kernel vs plain flow: {diff} > {MODEL_TOL} * {peak}")
    rec = dict(launches=launches, max_abs_diff=diff, max_abs_flow=peak,
               kernel_forward_s=kernel_s, plain_forward_s=plain_s)
    print(f"[model] fp32 full width: {json.dumps(rec)}", flush=True)
    return model


def phase_serve(fp32_model, n_requests: int = 3):
    import torch

    from perceiverio_pytorch_tpu_torch import PERFORMANCE, FlowInference
    from perceiverio_pytorch_tpu_torch.ops import flash_attention as fa

    model = _flow_model(PERFORMANCE)
    model.load_state_dict(fp32_model.state_dict())
    del fp32_model  # the caller keeps no reference: its memory is freed
    infer = FlowInference(model, device="cuda")
    gen = torch.Generator().manual_seed(SEED + 2)
    requests = []
    for i in range(n_requests + 1):  # the first one warms up
        frame = _smooth_frame(gen, 436, 1024)
        shifted = torch.roll(frame, shifts=(i + 1, 2 * i + 1), dims=(1, 2))
        requests.append((frame[None], shifted[None]))
    infer(*requests[0])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    latencies = []
    fa.LAUNCHES = fa.LAUNCHES_MERGE = 0
    t_all = time.perf_counter()
    for img1, img2 in requests[1:]:
        t0 = time.perf_counter()
        flow = infer(img1, img2)
        torch.cuda.synchronize()
        latencies.append(time.perf_counter() - t0)
        if tuple(flow.shape) != (1, 2, 436, 1024) or not torch.isfinite(flow).all():
            raise AssertionError(f"bad flow: shape {tuple(flow.shape)}")
    total = time.perf_counter() - t_all
    launches = fa.LAUNCHES
    if launches != 26 * n_requests:
        raise AssertionError(
            f"expected {26 * n_requests} kernel launches, got {launches}")
    rec = dict(requests=n_requests, tiles_per_request=6,
               latency_s=latencies, pairs_per_s=n_requests / total,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
               launches=launches, merge_launches=fa.LAUNCHES_MERGE)
    print(f"[serve] bf16 FlowInference 436x1024: {json.dumps(rec)}", flush=True)
    return rec


def _launch_counts():
    from perceiverio_pytorch_tpu_torch.ops import flash_attention as fa

    return {"K1": fa.LAUNCHES, "K2": fa.LAUNCHES_BWD_DKV, "K3": fa.LAUNCHES_BWD_DQ,
            "merge": fa.LAUNCHES_MERGE, "sum": fa.LAUNCHES_BWD_SUM}


def _reset_launch_counts():
    from perceiverio_pytorch_tpu_torch.ops import flash_attention as fa

    fa.LAUNCHES = fa.LAUNCHES_BWD_DKV = fa.LAUNCHES_BWD_DQ = fa.LAUNCHES_MERGE = 0
    fa.LAUNCHES_BWD_SUM = 0


def phase_gradients():
    """Full-width gradients through K1/K2/K3 against the same step with the
    flash forward and backward on their plain versions: the fp32 model
    (PARITY) through the CUDA-core backward, then the bf16 one
    (PERFORMANCE) through the wgmma kernels."""
    import torch

    from perceiverio_pytorch_tpu_torch import PERFORMANCE
    from perceiverio_pytorch_tpu_torch.config import PARITY

    records = {}
    for label, policy, launches, tol in (
            ("fp32", dataclasses.replace(PARITY, attn_impl="auto"), FP32_STEP_LAUNCHES,
             GRAD_TOL),
            ("bf16", PERFORMANCE, STEP_LAUNCHES, BF16_GRAD_TOL)):
        records[label] = _gradient_pass(label, policy, launches, tol)
        torch.cuda.empty_cache()
    return records


def _gradient_pass(label, policy, expected_launches, tol):
    import torch

    from perceiverio_pytorch_tpu_torch.examples.train_flow import synthetic_flow_pairs
    from perceiverio_pytorch_tpu_torch.ops import flash_attention as fa
    from perceiverio_pytorch_tpu_torch.training import flow_endpoint_error

    model = _flow_model(policy, remat=True).train()
    img1, img2, flow = (torch.from_numpy(a).cuda()
                        for a in synthetic_flow_pairs(1, (368, 496), seed=SEED + 4))
    # Relative loss gap: fp32 agrees to rounding; in bf16 the kernels'
    # outputs are rounded where the plain versions' are not (the gap
    # measured on an H100 was 1.1e-5).
    loss_tol = 1e-4 if label == "fp32" else 1e-3

    def gradients():
        model.zero_grad(set_to_none=True)
        t0 = time.perf_counter()
        loss = flow_endpoint_error(model(img1, img2), flow)
        loss.backward()
        torch.cuda.synchronize()
        grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()
                 if p.grad is not None}
        return loss.item(), grads, time.perf_counter() - t0

    first_s = gradients()[2]  # warm-up: the process's first backward of this dtype
    _reset_launch_counts()
    loss_k, grads_k, kernel_s = gradients()
    launches = _launch_counts()
    if launches != expected_launches:
        raise AssertionError(f"{label}: launches per step {launches}, expected "
                             f"{expected_launches}")
    with mock.patch.object(fa, "_flash_attention_cuda", fa.flash_attention_reference), \
            mock.patch.object(fa, "_flash_attention_backward_cuda",
                              fa.flash_attention_backward_reference):
        loss_p, grads_p, plain_s = gradients()
    if _launch_counts() != expected_launches:
        raise AssertionError(f"{label}: the plain run launched a kernel")
    if not (math.isfinite(loss_k) and abs(loss_k - loss_p) <= loss_tol * abs(loss_p)):
        raise AssertionError(f"{label}: loss through the kernels {loss_k}, plain {loss_p}")
    worst, worst_name, key_bias = _compare_grads(label, grads_k, grads_p, tol)
    rec = dict(launches=launches, loss_kernels=loss_k, loss_plain=loss_p,
               params=len(grads_k), worst_rel_grad_diff=worst, worst_param=worst_name,
               tolerance=tol, key_bias_grad_rel=key_bias, first_kernel_step_s=first_s,
               kernel_step_s=kernel_s, plain_step_s=plain_s)
    print(f"[gradients] {label} full width, remat: {json.dumps(rec)}", flush=True)
    return rec


def _compare_grads(label, grads_k, grads_p, tol):
    """Every parameter's gradient through the kernels against the plain
    run's, relative to that parameter's max |grad|; returns the worst ratio,
    its parameter and the key biases' largest |grad| against their weights'."""
    import torch

    if set(grads_k) != set(grads_p) or len(grads_k) < 100:
        raise AssertionError(f"{label}: the two runs give gradients to different parameters")
    worst, worst_name, key_bias = 0.0, None, 0.0
    for name, want in grads_p.items():
        got = grads_k[name].float()
        want = want.float()
        if not torch.isfinite(got).all():
            raise AssertionError(f"{label}: non-finite gradient of {name}")
        if name.endswith("proj_k.bias"):
            # Its exact gradient is 0 (softmax ignores a shift shared by a
            # row's logits): both runs hold rounding noise, which must stay
            # small against the same projection's weight gradient.
            weight = grads_p[name[: -len("bias")] + "weight"].abs().max().item()
            ratio = max(got.abs().max().item(), want.abs().max().item()) / weight
            if not ratio <= tol:
                raise AssertionError(f"{label}: {name}: |grad| {ratio} of its weight's")
            key_bias = max(key_bias, ratio)
            continue
        peak = want.abs().max().item()
        ratio = (got - want).abs().max().item() / peak if peak > 0 else 0.0
        if not ratio <= tol:
            raise AssertionError(
                f"{label}: {name}: max|dgrad| = {ratio} * max|grad| > {tol}")
        if ratio > worst:
            worst, worst_name = ratio, name
    return worst, worst_name, key_bias


def phase_train():
    """The port's train_flow example at --full-scale, through its Trainer,
    one step per fit() call so that each step is timed and counted."""
    from perceiverio_pytorch_tpu_torch.examples import train_flow

    total = 1 + TRAIN_STEPS
    metrics = _metrics_path("chip_smoke_train_metrics.jsonl")
    trainer, state, batches = train_flow.setup(
        total, full_scale=True, device="cuda", metrics_path=metrics, log_every=1)
    rec = _train_steps(trainer, state, batches, total, metrics, STEP_LAUNCHES)
    print(f"[train] bf16 full width, remat, batch 1: {json.dumps(rec)}", flush=True)
    return rec


def _metrics_path(name):
    metrics = os.path.join(ROOT, "build", name)
    if os.path.exists(metrics):
        os.remove(metrics)  # the logger appends
    return metrics


def _train_steps(trainer, state, batches, total, metrics, expected_launches,
                 eval_batches=None):
    """``total`` steps of ``trainer``, one per fit() call (with
    ``eval_batches``, evaluating at the trainer's cadence), each timed on the
    host clock and its kernel launches counted; an evaluation is timed apart
    and left out of its step's time.  The first step (the warmup's lr-0
    step) must leave the parameters where they were and the second move
    them.  Returns the steps' record (the first one untimed)."""
    import torch

    params = [p for g in state.optimizer.param_groups for p in g["params"] if p.numel()]
    initial = [p.detach().clone() for p in params]
    evaluate, eval_s = trainer.evaluate, []

    def timed_evaluate(*args, **kwargs):
        torch.cuda.synchronize()
        t = time.perf_counter()
        result = evaluate(*args, **kwargs)
        torch.cuda.synchronize()
        eval_s.append(time.perf_counter() - t)
        return result

    steps = []
    for n in range(1, total + 1):
        if n == 2:  # after the warm-up step
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        _reset_launch_counts()
        evals_before = len(eval_s)
        t0 = time.perf_counter()
        with mock.patch.object(trainer, "evaluate", timed_evaluate):
            state = trainer.fit(state, batches, num_steps=n, eval_batches=eval_batches)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0 - sum(eval_s[evals_before:])
        launches = _launch_counts()
        if state.step != n or launches != expected_launches:
            raise AssertionError(f"step {state.step}: launches {launches}, expected "
                                 f"{expected_launches}")
        moved = max((p.detach() - p0).abs().max().item() for p, p0 in zip(params, initial))
        with open(metrics) as f:  # the step's loss line (an evaluation line may follow)
            logged = [x for x in map(json.loads, f) if "loss" in x][-1]
        if logged["step"] != n or not math.isfinite(logged["loss"]):
            raise AssertionError(f"step {n}: logged {logged}")
        steps.append(dict(step=n, seconds=seconds, loss=logged["loss"], moved=moved,
                          launches=launches, logged_s=logged["elapsed_sec"]))
        if n == 1 and moved != 0.0:
            raise AssertionError("the warmup's first step (lr 0) moved the parameters")
        if n == 2 and not moved > 0.0:
            raise AssertionError("the parameters did not move at step 2")
    timed = steps[1:]
    step_s = [s["seconds"] for s in timed]
    return dict(
        steps=len(timed), loss=[s["loss"] for s in steps], step_s=step_s,
        steps_per_s=len(timed) / sum(step_s), median_step_s=sorted(step_s)[len(step_s) // 2],
        eval_s=eval_s, warmup_step_s=steps[0]["seconds"],
        logged_step_s=[s["logged_s"] for s in timed],
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
        launches_per_step=[s["launches"] for s in steps],
        launches={k: sum(s["launches"][k] for s in steps) for k in expected_launches},
    )


def _mm_model(policy, remat=False):
    import torch

    from perceiverio_pytorch_tpu_torch import MultiModalPerceiver

    return MultiModalPerceiver(policy=policy, remat=remat, device="cuda",
                               generator=torch.Generator().manual_seed(SEED)).eval()


def _smooth_clip(gen, frames=16, size=224, samples=30720):
    """A seeded synthetic clip on the card: smooth video [1, T, 3, H, W] in
    [0, 1] (sums of random space-time sinusoids) and audio [1, samples, 1]
    in [-1, 1] (a sum of random tones)."""
    import torch

    t = torch.linspace(0, 1, frames)[:, None, None]
    y = torch.linspace(0, 1, size)[None, :, None]
    x = torch.linspace(0, 1, size)[None, None, :]
    video = torch.zeros(frames, 3, size, size)
    for c in range(3):
        for _ in range(3):
            ft, fy, fx, ph = (torch.rand(4, generator=gen)
                              * torch.tensor([2.0, 4.0, 4.0, 6.28])).tolist()
            video[:, c] += torch.sin(2 * math.pi * (ft * t + fy * y + fx * x) + ph)
    video = (video - video.min()) / (video.max() - video.min())
    s = torch.linspace(0, 1, samples)
    audio = torch.zeros(samples)
    for _ in range(4):  # 20 to 2020 cycles over the clip
        f, ph = (torch.rand(2, generator=gen) * torch.tensor([2000.0, 6.28])).tolist()
        audio += torch.sin(2 * math.pi * (20.0 + f) * s + ph)
    audio = audio / audio.abs().max()
    return video[None].cuda(), audio[None, :, None].cuda()


def _check_mm_outputs(out, label):
    import torch

    want = {"image": (1, 16, 3, 224, 224), "audio": (1, 30720, 1), "label": (1, 700)}
    for key, shape in want.items():
        if tuple(out[key].shape) != shape or not torch.isfinite(out[key]).all():
            raise AssertionError(f"{label}: {key} of shape {tuple(out[key].shape)}, or not finite")


def phase_mm_model():
    """The full-width fp32 multimodal model, once through K1 (the encoder:
    one launch and its merge) and once with attention on the plain
    version; every output must agree."""
    import torch

    from perceiverio_pytorch_tpu_torch.config import PARITY
    from perceiverio_pytorch_tpu_torch.ops import attention as attention_ops
    from perceiverio_pytorch_tpu_torch.ops import flash_attention as fa

    model = _mm_model(dataclasses.replace(PARITY, attn_impl="auto"))
    images, audio = _smooth_clip(torch.Generator().manual_seed(SEED + 5))
    with torch.inference_mode():
        _reset_launch_counts()
        t0 = time.perf_counter()
        out_kernel = model(images, audio, n_chunks=MM_CHUNKS)
        torch.cuda.synchronize()
        kernel_s = time.perf_counter() - t0
        launches = _launch_counts()
        with mock.patch.object(attention_ops, "flash_attention",
                               fa.flash_attention_reference):
            t0 = time.perf_counter()
            out_plain = model(images, audio, n_chunks=MM_CHUNKS)
            torch.cuda.synchronize()
            plain_s = time.perf_counter() - t0
    if (launches["K1"], launches["merge"]) != (1, 1):
        raise AssertionError(f"expected one K1 launch and one merge, got {launches}")
    _check_mm_outputs(out_kernel, "kernel")
    _check_mm_outputs(out_plain, "plain")
    diffs = {}
    for key in out_plain:
        peak = out_plain[key].abs().max().item()
        diff = (out_kernel[key] - out_plain[key]).abs().max().item()
        if not (peak > 0 and diff <= MODEL_TOL * peak):
            raise AssertionError(f"kernel vs plain {key}: {diff} > {MODEL_TOL} * {peak}")
        diffs[key] = dict(max_abs_diff=diff, max_abs=peak)
    rec = dict(launches=launches["K1"], merge_launches=launches["merge"], n_chunks=MM_CHUNKS,
               outputs=diffs, tolerance=MODEL_TOL, first_kernel_forward_s=kernel_s,
               plain_forward_s=plain_s)
    print(f"[mm model] fp32 full width: {json.dumps(rec)}", flush=True)
    return model


def phase_mm_serve(fp32_model, n_clips: int = 3):
    """Three synthetic clips through the bf16 model (PERFORMANCE: bf16
    GEMMs, query-pad fold) after a warm-up clip, each on the card before
    its timed call; the last one also through the fp32 model."""
    import torch

    from perceiverio_pytorch_tpu_torch import PERFORMANCE

    model = _mm_model(PERFORMANCE)
    model.load_state_dict(fp32_model.state_dict())
    gen = torch.Generator().manual_seed(SEED + 6)
    clips = [_smooth_clip(gen) for _ in range(n_clips + 1)]
    with torch.inference_mode():
        model(*clips[0], n_chunks=MM_CHUNKS)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_launch_counts()
        latencies = []
        t_all = time.perf_counter()
        for images, audio in clips[1:]:
            t0 = time.perf_counter()
            out = model(images, audio, n_chunks=MM_CHUNKS)
            torch.cuda.synchronize()
            latencies.append(time.perf_counter() - t0)
            _check_mm_outputs(out, "bf16 serve")
        total = time.perf_counter() - t_all
        launches = _launch_counts()
        peak_mem = torch.cuda.max_memory_allocated()
        ref = fp32_model(*clips[-1], n_chunks=MM_CHUNKS)
    if (launches["K1"], launches["merge"]) != (n_clips, n_clips):
        raise AssertionError(f"expected one K1 launch and one merge a clip, got {launches}")
    rel = {key: (out[key].float() - ref[key]).abs().max().item() / ref[key].abs().max().item()
           for key in ref}
    if not all(r <= MM_BF16_TOL for r in rel.values()):
        raise AssertionError(f"bf16 vs fp32 outputs: {rel} (tolerance {MM_BF16_TOL})")
    rec = dict(clips=n_clips, n_chunks=MM_CHUNKS, latency_s=latencies,
               clips_per_s=n_clips / total, peak_mem_gb=peak_mem / 1e9,
               launches=launches["K1"], merge_launches=launches["merge"],
               k1_launches_per_clip=launches["K1"] / n_clips,
               merge_launches_per_clip=launches["merge"] / n_clips,
               bf16_vs_fp32_rel=rel, bf16_tolerance=MM_BF16_TOL)
    print(f"[mm serve] bf16 MultiModalPerceiver 16x224x224 + 30720 samples: {json.dumps(rec)}",
          flush=True)
    return rec


def phase_mm_gradients():
    """Full-width multimodal gradients (remat, 16 decoder chunks, one
    synthetic clip with a label, the training example's weighted loss)
    through K1/K2/K3 at the encoder's cross-attend against the same step
    with the flash forward and backward on their plain versions: the fp32
    model (PARITY) through the CUDA-core kernels, then the bf16 one
    (PERFORMANCE, the query-pad fold) through the wgmma kernels."""
    import torch

    from perceiverio_pytorch_tpu_torch import PERFORMANCE
    from perceiverio_pytorch_tpu_torch.config import PARITY

    images, audio = _smooth_clip(torch.Generator().manual_seed(SEED + 7))
    records = {}
    for label, policy, launches, tol in (
            ("fp32", dataclasses.replace(PARITY, attn_impl="auto"), MM_FP32_STEP_LAUNCHES,
             GRAD_TOL),
            ("bf16", PERFORMANCE, MM_STEP_LAUNCHES, BF16_GRAD_TOL)):
        records[label] = _mm_gradient_pass(label, policy, launches, tol, images, audio)
        torch.cuda.empty_cache()
    return records


def _mm_gradient_pass(label, policy, expected_launches, tol, images, audio):
    import torch

    from perceiverio_pytorch_tpu_torch.examples.train_multimodal import WEIGHTS
    from perceiverio_pytorch_tpu_torch.ops import flash_attention as fa
    from perceiverio_pytorch_tpu_torch.training import multimodal_autoencode_loss

    model = _mm_model(policy, remat=True).train()
    targets = {"image": images, "audio": audio,
               "label": torch.tensor([MM_LABEL], device="cuda")}
    loss_tol = 1e-4 if label == "fp32" else 1e-3  # as for flow (phase 7)

    def gradients():
        model.zero_grad(set_to_none=True)
        t0 = time.perf_counter()
        out = model(images, audio, n_chunks=MM_TRAIN_CHUNKS)
        loss = multimodal_autoencode_loss(out, targets, weights=WEIGHTS)
        loss.backward()
        torch.cuda.synchronize()
        grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()
                 if p.grad is not None}
        return loss.item(), grads, time.perf_counter() - t0

    first_s = gradients()[2]  # warm-up
    torch.cuda.reset_peak_memory_stats()
    _reset_launch_counts()
    loss_k, grads_k, kernel_s = gradients()
    launches = _launch_counts()
    peak_mem = torch.cuda.max_memory_allocated()
    if launches != expected_launches:
        raise AssertionError(f"multimodal {label}: launches per step {launches}, expected "
                             f"{expected_launches}")
    with mock.patch.object(fa, "_flash_attention_cuda", fa.flash_attention_reference), \
            mock.patch.object(fa, "_flash_attention_backward_cuda",
                              fa.flash_attention_backward_reference):
        loss_p, grads_p, plain_s = gradients()
    if _launch_counts() != expected_launches:
        raise AssertionError(f"multimodal {label}: the plain run launched a kernel")
    if not (math.isfinite(loss_k) and abs(loss_k - loss_p) <= loss_tol * abs(loss_p)):
        raise AssertionError(f"multimodal {label}: loss through the kernels {loss_k}, "
                             f"plain {loss_p}")
    worst, worst_name, key_bias = _compare_grads(f"multimodal {label}", grads_k, grads_p, tol)
    encoder_k = "perceiver._encoder.cross_attend.attention.proj_k.weight"
    if not grads_k[encoder_k].abs().max().item() > 0:
        raise AssertionError(f"multimodal {label}: no gradient reaches {encoder_k}")
    rec = dict(launches=launches, loss_kernels=loss_k, loss_plain=loss_p,
               params=len(grads_k), worst_rel_grad_diff=worst, worst_param=worst_name,
               tolerance=tol, key_bias_grad_rel=key_bias, first_kernel_step_s=first_s,
               kernel_step_s=kernel_s, plain_step_s=plain_s, peak_mem_gb=peak_mem / 1e9)
    print(f"[mm gradients] {label} full width, remat, {MM_TRAIN_CHUNKS} chunks: "
          f"{json.dumps(rec)}", flush=True)
    return rec


def phase_mm_train():
    """The port's train_multimodal example at --full-scale (bf16
    PERFORMANCE, remat, 16 decoder chunks, batch 1, synthetic clips)
    through its Trainer, one step per fit() call."""
    from perceiverio_pytorch_tpu_torch.examples import train_multimodal

    total = 1 + MM_TRAIN_STEPS
    metrics = _metrics_path("chip_smoke_mm_train_metrics.jsonl")
    trainer, state, batches = train_multimodal.setup(
        total, full_scale=True, device="cuda", metrics_path=metrics, log_every=1)
    rec = _train_steps(trainer, state, batches, total, metrics, MM_STEP_LAUNCHES)
    print(f"[mm train] bf16 full width, remat, {MM_TRAIN_CHUNKS} chunks, batch 1: "
          f"{json.dumps(rec)}", flush=True)
    return rec


def _cls_images(gen, batch, size=224):
    """A batch of seeded smooth images [B, 3, H, W] in [-1, 1] on the card."""
    import torch

    return torch.stack([_smooth_frame(gen, size, size) for _ in range(batch)]).cuda()


def _cls_model(prep, policy, remat=False):
    """The full-width classifier of one PrepType, seeded random weights; the
    convnet's BatchNorm gets random running statistics (a fresh module's
    mean 0 and variance 1 would make it nearly the identity)."""
    import torch

    from perceiverio_pytorch_tpu_torch import ClassificationPerceiver, PrepType

    gen = torch.Generator().manual_seed(SEED)
    model = ClassificationPerceiver(prep_type=PrepType[prep], policy=policy, remat=remat,
                                    device="cuda", generator=gen)
    for module in model.modules():
        if isinstance(module, torch.nn.BatchNorm2d):
            with torch.no_grad():
                module.running_mean.copy_(torch.randn(module.num_features, generator=gen) * 0.1)
                module.running_var.copy_(torch.rand(module.num_features, generator=gen) + 0.5)
    return model.eval()


def _expected_k1(prep, batch, dtype):
    """K1 launches and merges of one forward of the classifier: one K1 call
    at the pixel and 1x1-conv encoders (with a merge when its plan splits
    the keys), none in the convnet variant."""
    import torch

    from perceiverio_pytorch_tpu_torch.ops import flash_attention as fa

    site = CLS_SITE_OF[prep]
    if site is None:
        return 0, 0
    _, tq, tk, h, d, dv = CLS_SITES[site]
    q = torch.empty(batch, tq, h, d, device="meta", dtype=dtype)
    k = torch.empty(batch, tk, h, d, device="meta", dtype=dtype)
    v = torch.empty(batch, tk, h, dv, device="meta", dtype=dtype)
    return 1, fa.launch_plan(q, k, v)["cuda_launches"] - 1


def phase_cls_model(prep):
    """The full-width fp32 classifier (eval mode), two images, once through
    K1 and once with attention on the plain version; the logits must agree
    and K1 must run as planned."""
    import torch

    from perceiverio_pytorch_tpu_torch.config import PARITY
    from perceiverio_pytorch_tpu_torch.ops import attention as attention_ops
    from perceiverio_pytorch_tpu_torch.ops import flash_attention as fa

    model = _cls_model(prep, dataclasses.replace(PARITY, attn_impl="auto"))
    img = _cls_images(torch.Generator().manual_seed(SEED + 8), CLS_MODEL_BATCH)
    with torch.inference_mode():
        _reset_launch_counts()
        t0 = time.perf_counter()
        logits_kernel = model(img)
        torch.cuda.synchronize()
        kernel_s = time.perf_counter() - t0
        launches = _launch_counts()
        with mock.patch.object(attention_ops, "flash_attention", fa.flash_attention_reference):
            t0 = time.perf_counter()
            logits_plain = model(img)
            torch.cuda.synchronize()
            plain_s = time.perf_counter() - t0
    want = _expected_k1(prep, CLS_MODEL_BATCH, torch.float32)
    if (launches["K1"], launches["merge"]) != want:
        raise AssertionError(f"{prep}: K1 and merge launches {launches}, expected {want}")
    if tuple(logits_kernel.shape) != (CLS_MODEL_BATCH, 1000) or not (
            torch.isfinite(logits_kernel).all() and torch.isfinite(logits_plain).all()):
        raise AssertionError(f"{prep}: logits of shape {tuple(logits_kernel.shape)} or not finite")
    peak = logits_plain.abs().max().item()
    diff = (logits_kernel - logits_plain).abs().max().item()
    if not (peak > 0 and diff <= MODEL_TOL * peak):
        raise AssertionError(f"{prep}: kernel vs plain logits {diff} > {MODEL_TOL} * {peak}")
    rec = dict(prep=prep, batch=CLS_MODEL_BATCH, launches=launches["K1"],
               merge_launches=launches["merge"], max_abs_diff=diff, max_abs_logit=peak,
               tolerance=MODEL_TOL, first_kernel_forward_s=kernel_s, plain_forward_s=plain_s)
    print(f"[cls model] fp32 full width: {json.dumps(rec)}", flush=True)
    return model


def phase_cls_serve(prep, fp32_model):
    """Bf16 serving (PERFORMANCE) of one PrepType at batch 16: one warm-up
    request, then three timed ones on fresh seeded images; the last
    request's logits and top-1 against the fp32 model's."""
    import torch

    from perceiverio_pytorch_tpu_torch import PERFORMANCE

    model = _cls_model(prep, PERFORMANCE)
    model.load_state_dict(fp32_model.state_dict())
    gen = torch.Generator().manual_seed(SEED + 9)
    requests = [_cls_images(gen, CLS_SERVE_BATCH) for _ in range(CLS_REQUESTS + 1)]
    with torch.inference_mode():
        model(requests[0])  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_launch_counts()
        latencies = []
        t_all = time.perf_counter()
        for img in requests[1:]:
            t0 = time.perf_counter()
            logits = model(img)
            torch.cuda.synchronize()
            latencies.append(time.perf_counter() - t0)
            if tuple(logits.shape) != (CLS_SERVE_BATCH, 1000) or not torch.isfinite(logits).all():
                raise AssertionError(f"{prep}: bf16 logits of shape {tuple(logits.shape)}")
        total = time.perf_counter() - t_all
        launches = _launch_counts()
        peak_mem = torch.cuda.max_memory_allocated()
        ref = fp32_model(requests[-1])
    k1, merges = _expected_k1(prep, CLS_SERVE_BATCH, torch.bfloat16)
    if (launches["K1"], launches["merge"]) != (k1 * CLS_REQUESTS, merges * CLS_REQUESTS):
        raise AssertionError(f"{prep}: launches {launches}, expected {k1} K1 and {merges}"
                             " merges a request")
    rel = (logits.float() - ref).abs().max().item() / ref.abs().max().item()
    if not rel <= CLS_BF16_TOL:
        raise AssertionError(f"{prep}: bf16 vs fp32 logits {rel} > {CLS_BF16_TOL}")
    top1 = (logits.float().argmax(-1) == ref.argmax(-1)).float().mean().item()
    rec = dict(prep=prep, requests=CLS_REQUESTS, batch=CLS_SERVE_BATCH, latency_s=latencies,
               images_per_s=CLS_REQUESTS * CLS_SERVE_BATCH / total,
               peak_mem_gb=peak_mem / 1e9, launches=launches["K1"],
               merge_launches=launches["merge"], k1_launches_per_request=k1,
               bf16_vs_fp32_rel=rel, bf16_tolerance=CLS_BF16_TOL, top1_agreement=top1)
    print(f"[cls serve] bf16 ClassificationPerceiver 224x224: {json.dumps(rec)}", flush=True)
    return rec


def phase_cls():
    """Phases 13 and 14 for each PrepType in turn (one fp32 and one bf16
    model on the card at a time)."""
    import torch

    serves = {}
    for prep in CLS_SITE_OF:
        fp32_model = phase_cls_model(prep)
        serves[prep] = phase_cls_serve(prep, fp32_model)
        del fp32_model
        torch.cuda.empty_cache()
    return serves


def _lm_batch(seed):
    """LM_BATCH sequences of seeded text (words of random lowercase letters,
    1,500 to 2,048 bytes), byte-tokenized, the span LM_SPAN replaced by the
    mask token, right-padded to 2,048: ids [B, 2048] and the input mask."""
    import random

    import numpy as np
    import torch

    from perceiverio_pytorch_tpu_torch.utils import bytes_tokenizer as tok

    rng = random.Random(seed)
    rows, masks = [], []
    for _ in range(LM_BATCH):
        words, length = [], rng.randint(1500, 2048)
        while sum(len(w) + 1 for w in words) < length:
            words.append("".join(rng.choice("abcdefghijklmnopqrstuvwxyz")
                                 for _ in range(rng.randint(1, 10))))
        ids = tok.encode(" ".join(words))[:length]
        ids[LM_SPAN[0]:LM_SPAN[1]] = tok.BytesTokenizer.mask_token
        rows.append(np.pad(ids, (0, 2048 - len(ids))))
        masks.append(np.arange(2048) < len(ids))
    ids, mask = tok.pad_sequence(2048, np.stack(rows), np.stack(masks))
    return torch.from_numpy(ids).long().cuda(), torch.from_numpy(mask).cuda()


def phase_lm():
    """The full-width LanguagePerceiver: fp32 and bf16 (PERFORMANCE) on the
    same weights and tokens, the masked span's rows by predict_positions
    against the full decode, then three timed bf16 requests."""
    import torch

    from perceiverio_pytorch_tpu_torch import PERFORMANCE, LanguagePerceiver
    from perceiverio_pytorch_tpu_torch.config import PARITY

    models = {label: LanguagePerceiver(policy=policy, device="cuda",
                                       generator=torch.Generator().manual_seed(SEED)).eval()
              for label, policy in (("fp32", dataclasses.replace(PARITY, attn_impl="auto")),
                                    ("bf16", PERFORMANCE))}
    ids, mask = _lm_batch(SEED + 10)
    positions = torch.arange(*LM_SPAN, device="cuda")
    full, rows = {}, {}
    with torch.inference_mode():
        _reset_launch_counts()
        for label, model in models.items():
            full[label] = model(ids, mask)
            rows[label] = model(ids, mask, predict_positions=positions)
        torch.cuda.synchronize()
        checks = _launch_counts()
        if any(checks.values()):
            raise AssertionError(f"the language model launched a kernel: {checks}")
        rows_rec = {}
        for label in models:
            out = full[label]
            if (tuple(out.shape) != (LM_BATCH, 2048, 262) or out.dtype != torch.float32
                    or not torch.isfinite(out).all()):
                raise AssertionError(f"{label}: logits {tuple(out.shape)} {out.dtype}")
            want = out[:, positions]
            scale = out.abs().max().item()
            diff = (rows[label] - want).abs().max().item()
            if not diff <= LM_ROWS_TOL[label] * scale:
                raise AssertionError(f"{label}: predict_positions rows {diff} off the full"
                                     f" decode (max {scale})")
            rows_rec[label] = dict(rows_max_abs_diff=diff,
                                   rows_bitwise=torch.equal(rows[label], want),
                                   max_abs_logit=scale)
        rel = (full["bf16"] - full["fp32"]).abs().max().item() / full["fp32"].abs().max().item()
        if not rel <= LM_BF16_TOL:
            raise AssertionError(f"bf16 vs fp32 logits {rel} > {LM_BF16_TOL}")
        model = models["bf16"]
        del full, rows
        requests = [_lm_batch(SEED + 11 + i) for i in range(LM_REQUESTS + 1)]
        model(*requests[0])  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_launch_counts()
        latencies = []
        t_all = time.perf_counter()
        for batch in requests[1:]:
            t0 = time.perf_counter()
            logits = model(*batch)
            torch.cuda.synchronize()
            latencies.append(time.perf_counter() - t0)
            if not torch.isfinite(logits).all():
                raise AssertionError("non-finite bf16 logits")
        total = time.perf_counter() - t_all
        launches = _launch_counts()
        peak_mem = torch.cuda.max_memory_allocated()
        t0 = time.perf_counter()
        model(*requests[-1], predict_positions=positions)
        torch.cuda.synchronize()
        span_s = time.perf_counter() - t0
    if any(launches.values()):
        raise AssertionError(f"the language model launched a kernel: {launches}")
    rec = dict(requests=LM_REQUESTS, batch=LM_BATCH, latency_s=latencies,
               sequences_per_s=LM_REQUESTS * LM_BATCH / total, peak_mem_gb=peak_mem / 1e9,
               launches=launches["K1"], predict_positions=len(positions),
               predict_positions_request_s=span_s, bf16_vs_fp32_rel=rel,
               bf16_tolerance=LM_BF16_TOL, input_tokens=int(mask.sum()), **rows_rec)
    print(f"[lm serve] LanguagePerceiver 2048 bytes: {json.dumps(rec)}", flush=True)
    return rec


def phase_cls_gradients():
    """Full-width classification gradients (remat, batch 2, random labels,
    the cross-entropy) of the pixel and 1x1-conv variants through K1/K2/K3
    at the encoder's cross-attend (d = 261, 512) against the same step with
    the flash forward and backward on their plain versions: the fp32 model
    (PARITY) through the CUDA-core kernels, then the bf16 one (PERFORMANCE)
    through the wgmma kernels."""
    import torch

    from perceiverio_pytorch_tpu_torch import PERFORMANCE
    from perceiverio_pytorch_tpu_torch.config import PARITY

    img = _cls_images(torch.Generator().manual_seed(SEED + 12), CLS_MODEL_BATCH)
    labels = torch.randint(0, 1000, (CLS_MODEL_BATCH,),
                           generator=torch.Generator().manual_seed(SEED + 13)).cuda()
    records = {}
    for prep in ("FOURIER_POS_PIXEL", "LEARNED_POS_1X1CONV"):
        for label, policy, launches, tol in (
                ("fp32", dataclasses.replace(PARITY, attn_impl="auto"), CLS_FP32_STEP_LAUNCHES,
                 GRAD_TOL),
                ("bf16", PERFORMANCE, CLS_STEP_LAUNCHES, BF16_GRAD_TOL)):
            records[prep, label] = _cls_gradient_pass(prep, label, policy, launches, tol,
                                                      img, labels)
            torch.cuda.empty_cache()
    return records


def _cls_gradient_pass(prep, label, policy, expected_launches, tol, img, labels):
    import torch

    from perceiverio_pytorch_tpu_torch.ops import flash_attention as fa
    from perceiverio_pytorch_tpu_torch.training import classification_cross_entropy

    model = _cls_model(prep, policy, remat=True).train()
    loss_tol = 1e-4 if label == "fp32" else 1e-3  # as for flow (phase 7)

    def gradients():
        model.zero_grad(set_to_none=True)
        t0 = time.perf_counter()
        loss = classification_cross_entropy(model(img), labels)
        loss.backward()
        torch.cuda.synchronize()
        grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()
                 if p.grad is not None}
        return loss.item(), grads, time.perf_counter() - t0

    first_s = gradients()[2]  # warm-up
    torch.cuda.reset_peak_memory_stats()
    _reset_launch_counts()
    loss_k, grads_k, kernel_s = gradients()
    launches = _launch_counts()
    peak_mem = torch.cuda.max_memory_allocated()
    if launches != expected_launches:
        raise AssertionError(f"{prep} {label}: launches per step {launches}, expected "
                             f"{expected_launches}")
    with mock.patch.object(fa, "_flash_attention_cuda", fa.flash_attention_reference), \
            mock.patch.object(fa, "_flash_attention_backward_cuda",
                              fa.flash_attention_backward_reference):
        loss_p, grads_p, plain_s = gradients()
    if _launch_counts() != expected_launches:
        raise AssertionError(f"{prep} {label}: the plain run launched a kernel")
    if not (math.isfinite(loss_k) and abs(loss_k - loss_p) <= loss_tol * abs(loss_p)):
        raise AssertionError(f"{prep} {label}: loss through the kernels {loss_k}, "
                             f"plain {loss_p}")
    worst, worst_name, key_bias = _compare_grads(f"{prep} {label}", grads_k, grads_p, tol)
    encoder_k = "perceiver._encoder.cross_attend.attention.proj_k.weight"
    if not grads_k[encoder_k].abs().max().item() > 0:
        raise AssertionError(f"{prep} {label}: no gradient reaches {encoder_k}")
    rec = dict(prep=prep, batch=CLS_MODEL_BATCH, launches=launches, loss_kernels=loss_k,
               loss_plain=loss_p, params=len(grads_k), worst_rel_grad_diff=worst,
               worst_param=worst_name, tolerance=tol, key_bias_grad_rel=key_bias,
               first_kernel_step_s=first_s, kernel_step_s=kernel_s, plain_step_s=plain_s,
               peak_mem_gb=peak_mem / 1e9)
    print(f"[cls gradients] {label} full width, remat: {json.dumps(rec)}", flush=True)
    return rec


def phase_cls_train():
    """The port's train_classification example at --full-scale (bf16
    PERFORMANCE, remat, batch 8) for the convnet, then through the same
    setup for the pixel and 1x1-conv variants, one step per fit() call; for
    the convnet, the running averages must have moved and evaluation
    (``Trainer.evaluate``, eval mode) must read them."""
    import torch

    from perceiverio_pytorch_tpu_torch import PrepType
    from perceiverio_pytorch_tpu_torch.examples import train_classification

    total = 1 + CLS_TRAIN_STEPS
    records = {}
    for prep in CLS_SITE_OF:
        metrics = _metrics_path(f"chip_smoke_cls_train_{prep.lower()}.jsonl")
        trainer, state, batches, _ = train_classification.setup(
            total, full_scale=True, prep_type=PrepType[prep], device="cuda",
            metrics_path=metrics, log_every=1)
        norms = [m for m in state.model.modules() if isinstance(m, torch.nn.BatchNorm2d)]
        initial = [(bn.running_mean.clone(), bn.running_var.clone()) for bn in norms]
        expected = NO_LAUNCHES if CLS_SITE_OF[prep] is None else CLS_STEP_LAUNCHES
        rec = _train_steps(trainer, state, batches, total, metrics, expected)
        rec.update(prep=prep, batch=8, images_per_s=8 * rec["steps_per_s"])
        if prep == "FOURIER_POS_CONVNET":
            rec["batchnorm"] = _check_running_averages(trainer, state, batches, norms, initial,
                                                       total)
        print(f"[cls train] bf16 full width, remat, batch 8: {json.dumps(rec)}", flush=True)
        records[prep] = rec
        del trainer, state, batches
        torch.cuda.empty_cache()
    return records


def _check_running_averages(trainer, state, batches, norms, initial, steps):
    """The convnet's BatchNorm after ``steps`` train steps: the running
    averages moved, one update a step, and evaluation reads them (the
    evaluation loss changes when they are put back to their initial
    values)."""
    import torch

    if not norms:
        raise AssertionError("the convnet has no BatchNorm")
    moved = max(max((bn.running_mean - m0).abs().max().item(),
                    (bn.running_var - v0).abs().max().item())
                for bn, (m0, v0) in zip(norms, initial))
    tracked = [int(bn.num_batches_tracked) for bn in norms]
    if not moved > 0 or tracked != [steps] * len(norms):
        raise AssertionError(f"running averages moved by {moved}, updates {tracked}")
    held = [next(iter(batches(steps)))]
    evaluated = trainer.evaluate(state, held)
    saved = [(bn.running_mean.clone(), bn.running_var.clone()) for bn in norms]
    for bn, (m0, v0) in zip(norms, initial):
        bn.running_mean.copy_(m0)
        bn.running_var.copy_(v0)
    with_initial = trainer.evaluate(state, held)
    for bn, (m, v) in zip(norms, saved):
        bn.running_mean.copy_(m)
        bn.running_var.copy_(v)
    if not state.model.training or evaluated == with_initial:
        raise AssertionError(f"evaluation ignores the running averages: {evaluated}")
    if not all(math.isfinite(x) for x in evaluated.values()):
        raise AssertionError(f"non-finite evaluation {evaluated}")
    return dict(running_moved=moved, updates=tracked, eval=evaluated,
                eval_with_initial_averages=with_initial)


def phase_lm_train():
    """The port's train_mlm example at --full-scale (bf16 PERFORMANCE, batch
    8, 2,048 bytes), one step per fit() call, evaluating at the mid and
    final steps (timed apart from the steps); no site reaches a kernel."""
    from perceiverio_pytorch_tpu_torch.examples import train_mlm

    total = 1 + LM_TRAIN_STEPS
    metrics = _metrics_path("chip_smoke_lm_train_metrics.jsonl")
    trainer, state, batches, eval_batches = train_mlm.setup(
        total, full_scale=True, device="cuda", metrics_path=metrics, log_every=1)
    rec = _train_steps(trainer, state, batches, total, metrics, NO_LAUNCHES, eval_batches)
    with open(metrics) as f:
        evals = [x for x in map(json.loads, f) if "eval_loss" in x]
    if [x["step"] for x in evals] != [total // 2, total] or not all(
            math.isfinite(x["eval_loss"]) for x in evals):
        raise AssertionError(f"evaluation lines {evals}")
    rec.update(batch=8, sequences_per_s=8 * rec["steps_per_s"], evals=evals,
               params=sum(p.numel() for p in state.model.parameters()))
    print(f"[lm train] bf16 full width, batch 8, 2048 bytes: {json.dumps(rec)}", flush=True)
    return rec


def phase_bucket_kernels(reps: int = 3):
    """K1 at the classification encoders at the server's buckets 1, 2 and 4
    (bf16, with its lse, against the plain version, each plan's splits and
    merge asserted); then K1's torch.library op through torch.ops against
    the direct launch on the same tensors, bit for bit."""
    import torch

    from perceiverio_pytorch_tpu_torch.ops import flash_attention as fa

    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 20)
    records = [check_case(name, shape, "bf16", False, reps, gen, lse=True,
                          want_plan=dict(splits=BUCKET_SPLITS[shape[0]], cuda_launches=2))
               for name, shape in BUCKET_SITES.items()]
    for name, shape in BUCKET_SITES.items():
        q, k, v, _ = _case_inputs(*shape, torch.bfloat16, False, gen)
        with torch.inference_mode():
            out, lse = torch.ops.perceiverio_torch.flash_attention_fwd(
                q, k, v, None, None, None, None, True)
            want, want_lse = fa._flash_attention_cuda(
                q, k, v, q_mask=None, kv_mask=None, softmax_scale=None, kv_logical_len=None,
                return_lse=True)
            torch.cuda.synchronize()
        if not (torch.equal(out, want) and torch.equal(lse, want_lse)):
            raise AssertionError(f"{name}: the op differs from the direct launch")
    print(f"[buckets] op == direct launch bit for bit at {list(BUCKET_SITES)}; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return records


def _artifact_contents(blob, model, weights):
    """What the exported program holds: its K1 op nodes, its state (which
    must hold no parameter), its constants (each must be one of the model's
    non-persistent buffers) and their bytes."""
    import io

    import torch

    ep = torch.export.load(io.BytesIO(blob))
    op = torch.ops.perceiverio_torch.flash_attention_fwd.default
    derived = [b for name, b in model.named_buffers() if name.endswith("fourier_table")]
    for name, const in ep.constants.items():
        if not any(const.shape == b.shape and torch.equal(const, b) for b in derived):
            raise AssertionError(f"the artifact holds constant {name} {tuple(const.shape)},"
                                 " no derived buffer")
    if len(ep.state_dict):
        raise AssertionError(f"the artifact holds parameters: {list(ep.state_dict)[:5]}")
    return dict(k1_op_nodes=sum(n.target is op for n in ep.graph.nodes),
                artifact_bytes=len(blob), artifact_state_tensors=len(ep.state_dict),
                constant_bytes=sum(c.numel() * c.element_size() for c in ep.constants.values()),
                weights_bytes=sum(t.numel() * t.element_size() for t in weights.values()))


def _export_classifier(prep):
    """The full-width bf16 classifier (eval mode, PERFORMANCE) of one
    PrepType, its weights cast for inference, exported batch-polymorphic
    on the card and reloaded from the bytes; checks the artifact's
    contents."""
    import torch

    from perceiverio_pytorch_tpu_torch import PERFORMANCE, export_apply, load_exported
    from perceiverio_pytorch_tpu_torch.utils.params import cast_variables_for_inference

    model = _cls_model(prep, PERFORMANCE)
    weights = cast_variables_for_inference(model)
    example = torch.zeros((2, 3, 224, 224), device="cuda")
    t0 = time.perf_counter()
    blob = export_apply(model, weights, example, batch_polymorphic=True)
    export_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    fn = load_exported(blob)
    load_s = time.perf_counter() - t0
    contents = _artifact_contents(blob, model, weights)
    if contents["k1_op_nodes"] != 1:
        raise AssertionError(f"{prep}: {contents['k1_op_nodes']} K1 op nodes in the graph")
    return model, weights, blob, fn, dict(prep=prep, export_s=export_s, load_s=load_s,
                                          **contents)


def _check_artifact_call(prep, model, weights, fn, img):
    """One call of the reloaded artifact against the eager model on the same
    weights: K1 once (and its planned merges), logits within EXPORT_TOL."""
    import torch

    with torch.inference_mode():
        _reset_launch_counts()
        got = fn(weights, img)
        torch.cuda.synchronize()
        launches = _launch_counts()
        want = torch.func.functional_call(model, weights, (img,))
        torch.cuda.synchronize()
    expected = _expected_k1(prep, img.shape[0], torch.bfloat16)
    if (launches["K1"], launches["merge"]) != expected:
        raise AssertionError(f"{prep}: artifact launches {launches}, expected {expected}")
    if tuple(got.shape) != (img.shape[0], 1000) or not torch.isfinite(got).all():
        raise AssertionError(f"{prep}: artifact logits {tuple(got.shape)}")
    scale = want.float().abs().max().item()
    diff = (got.float() - want.float()).abs().max().item()
    if not diff <= EXPORT_TOL * scale:
        raise AssertionError(f"{prep}: artifact vs eager {diff} > {EXPORT_TOL} * {scale}")
    return dict(batch=img.shape[0], launches=launches["K1"], merge_launches=launches["merge"],
                max_abs_diff=diff, max_abs_logit=scale, bitwise=torch.equal(got, want))


def _latency(call, img, requests):
    """p50 and p99 host-clock latency of ``call(img)`` with the logits
    fetched, over ``requests`` calls after one, and images/s."""
    call(img).cpu()
    times = []
    for _ in range(requests):
        t0 = time.perf_counter()
        call(img).cpu()
        times.append(time.perf_counter() - t0)
    times.sort()
    return dict(p50_ms=times[len(times) // 2] * 1e3, p99_ms=times[-1] * 1e3,
                images_per_s=img.shape[0] * len(times) / sum(times))


def phase_export(smi, out_dir):
    """The full-width 1x1-conv classifier exported on the card: the graph
    holds K1's op once and no parameter; the artifact, reloaded from its
    bytes, at batches 1, 4 and 16 against the eager model (K1 once a call),
    then p50/p99 latency and images/s beside the eager model's; the
    artifact and the weights written to ``out_dir`` as the serving example
    writes them.  The pixel variant goes through export and one batch of 4.
    Returns the 1x1-conv model's weights and loaded artifact."""
    import torch

    from perceiverio_pytorch_tpu_torch.examples import serve
    from perceiverio_pytorch_tpu_torch.training.checkpoint import save_variables

    t0 = time.perf_counter()
    prep = "LEARNED_POS_1X1CONV"
    model, weights, blob, fn, rec = _export_classifier(prep)
    gen = torch.Generator().manual_seed(SEED + 21)
    calls, timing = [], {}
    for b in EXPORT_BATCHES:
        img = _cls_images(gen, b)
        calls.append(_check_artifact_call(prep, model, weights, fn, img))
        with torch.inference_mode():
            timing[b] = dict(
                artifact=_latency(lambda x: fn(weights, x), img, EXPORT_REQUESTS),
                eager=_latency(lambda x: torch.func.functional_call(model, weights, (x,)),
                               img, EXPORT_REQUESTS))
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, serve.ARTIFACT), "wb") as f:
        f.write(blob)
    save_variables(os.path.join(out_dir, serve.WEIGHTS), weights, overwrite=True)
    rec.update(calls=calls, timing=timing, card=smi, seconds=time.perf_counter() - t0)
    print(f"[export] bf16 1x1-conv classifier, torch.export: {json.dumps(rec)}", flush=True)
    del model

    t0 = time.perf_counter()
    pixel, pixel_weights, _, pixel_fn, pixel_rec = _export_classifier("FOURIER_POS_PIXEL")
    pixel_rec.update(call=_check_artifact_call("FOURIER_POS_PIXEL", pixel, pixel_weights,
                                               pixel_fn, _cls_images(gen, 4)),
                     card=smi, seconds=time.perf_counter() - t0)
    print(f"[export] bf16 pixel classifier, torch.export: {json.dumps(pixel_rec)}", flush=True)
    del pixel, pixel_weights, pixel_fn
    torch.cuda.empty_cache()
    return weights, fn, dict(k1=rec, pixel=pixel_rec)


def _direct_rows(fn, weights, images):
    """The artifact's logits for each image alone (a batch of one)."""
    import torch

    with torch.inference_mode():
        return [fn(weights, torch.from_numpy(img)[None].cuda())[0].float().cpu()
                for img in images]


def _check_rows(label, rows_by_client, direct):
    """Every answer of client ``i`` against ``direct[i]`` (SERVE_TOL)."""
    import torch

    pairs = [(torch.as_tensor(r).float(), direct[i])
             for i, rows in enumerate(rows_by_client) for r in rows]
    scale = max(d.abs().max().item() for d in direct)
    diff = max((r - d).abs().max().item() for r, d in pairs)
    if not diff <= SERVE_TOL * scale:
        raise AssertionError(f"{label}: served rows vs a batch of one {diff} > "
                             f"{SERVE_TOL} * {scale}")
    top1 = sum(int(r.argmax() == d.argmax()) for r, d in pairs) / len(pairs)
    return dict(rows_checked=len(pairs), max_abs_diff_vs_batch_of_one=diff,
                max_abs_logit=scale, top1_agreement=top1)


def _check_stack_launches(label, launches, stats):
    """K1 (and its merge: every bucket below 16 splits the keys) once per
    batch the server dispatched, and once per bucket for its warm-up."""
    want = stats["batches_dispatched"] + len(stats["bucket_dispatches"])
    if launches["K1"] != want or launches["merge"] != want:
        raise AssertionError(f"{label}: launches {launches}, expected {want} (batches "
                             f"{stats['batches_dispatched']} + the warm-up's)")


def phase_server(smi, weights, fn, out_dir):
    """The serving example's server_demo over the reloaded 1x1-conv
    artifact: 24 clients in closed loop for SERVE_WINDOW_S against
    BatchingServer(max_batch=8, max_wait_ms=3), pipeline off and on,
    alternated twice; every row against a batch-of-one call of the artifact
    (SERVE_TOL); K1 once per dispatched batch and warm-up bucket (the
    counts set to 0 before each window's server, read after it); req/s and
    p50/p99 over every request, occupancy, buckets.  Then a known grouping:
    4 requests that form one batch of 4, their rows bit for bit against a
    direct call of that batch."""
    import numpy as np
    import torch

    from perceiverio_pytorch_tpu_torch import BatchingServer
    from perceiverio_pytorch_tpu_torch.examples import serve

    t0 = time.perf_counter()
    images = [serve.image(i, 224) for i in range(SERVER_CLIENTS)]
    direct = _direct_rows(fn, weights, images)
    call = lambda x: fn(weights, x)  # noqa: E731
    runs = []
    for pipeline in SERVER_PIPELINES:
        _reset_launch_counts()
        res = serve.server_demo(out_dir, 224, clients=SERVER_CLIENTS, pipeline=pipeline,
                                seconds=SERVE_WINDOW_S, call=call)
        launches = _launch_counts()
        stats = res["stats"]
        _check_stack_launches(f"pipeline={pipeline}", launches, stats)
        runs.append(dict(
            pipeline=pipeline, clients=SERVER_CLIENTS, window_s=res["seconds"],
            requests=res["requests"], requests_per_s=res["requests_per_s"],
            p50_ms=res["p50_ms"], p99_ms=res["p99_ms"],
            occupancy=stats.get("mean_batch_occupancy"), buckets=stats["bucket_dispatches"],
            batches=stats["batches_dispatched"], launches=launches["K1"],
            merge_launches=launches["merge"],
            **_check_rows(f"pipeline={pipeline}", res["rows"], direct)))

    server = BatchingServer(call, max_batch=4, max_wait_ms=5000.0, pipeline=True)
    try:
        futs = [server.submit(img) for img in images[:4]]
        rows = [f.result(timeout=300) for f in futs]
        stats = server.stats()
    finally:
        server.stop()
    if stats["batches_dispatched"] != 1:
        raise AssertionError(f"the 4 requests took {stats['batches_dispatched']} batches")
    with torch.inference_mode():
        want = fn(weights, torch.from_numpy(np.stack(images[:4])).cuda()).cpu()
    if not all(torch.equal(r, w) for r, w in zip(rows, want)):
        raise AssertionError("served rows differ from the direct call of the same batch")
    rec = dict(runs=runs, grouped_rows_bitwise=True, card=smi,
               seconds=time.perf_counter() - t0)
    print(f"[server] BatchingServer over the 1x1-conv artifact: {json.dumps(rec)}", flush=True)
    return rec


def phase_http(smi, weights, fn, out_dir):
    """The serving example's http_demo over the reloaded 1x1-conv artifact:
    HttpFrontend on 127.0.0.1:0 over a pipelined BatchingServer, 12 clients
    in closed loop for SERVE_WINDOW_S, half JSON and half npz, each answer
    against a batch-of-one call (SERVE_TOL); /stats and /metrics count
    every request; K1 once per dispatched batch and warm-up bucket.  Then
    its multi_demo: the artifact as "imagenet" and the full-width
    LanguagePerceiver (2,048 bytes) as "mlm", max_batch 2, on one port, and
    a 30 ms deadline shed as HTTP 504."""
    import numpy as np
    import torch

    from perceiverio_pytorch_tpu_torch.examples import serve

    t0 = time.perf_counter()
    call = lambda x: fn(weights, x)  # noqa: E731
    direct = _direct_rows(fn, weights, [serve.image(i, 224) for i in range(HTTP_CLIENTS)])
    _reset_launch_counts()
    res = serve.http_demo(out_dir, 224, clients=HTTP_CLIENTS, seconds=SERVE_WINDOW_S, call=call)
    launches = _launch_counts()
    stats = res["stats"]
    if stats["requests_served"] != res["requests"]:
        raise AssertionError(f"/stats served {stats['requests_served']}, clients got "
                             f"{res['requests']}")
    _check_stack_launches("http", launches, stats)
    if f'perceiver_requests_served{{model="default"}} {res["requests"]}' not in res["metrics"]:
        raise AssertionError(f"/metrics lacks the served count:\n{res['metrics']}")
    rec = dict(clients=HTTP_CLIENTS, window_s=res["seconds"], requests=res["requests"],
               requests_per_s=res["requests_per_s"], p50_ms=res["p50_ms"],
               p99_ms=res["p99_ms"], json=res["json"], npz=res["npz"],
               server_p50_ms=stats["request_latency_ms"]["p50"],
               server_p99_ms=stats["request_latency_ms"]["p99"],
               occupancy=stats.get("mean_batch_occupancy"), buckets=stats["bucket_dispatches"],
               batches=stats["batches_dispatched"], launches=launches["K1"],
               merge_launches=launches["merge"], metrics_lines=len(res["metrics"].splitlines()),
               **_check_rows("http", res["outputs"], direct))
    t_multi = time.perf_counter()
    multi = serve.multi_demo(out_dir, 224, device="cuda", full_scale=True, call=call)
    if not np.isfinite(multi["mlm_logits"]).all() or multi["shed_status"] != 504:
        raise AssertionError(f"multi_demo: {multi['shed_status']}, non-finite MLM logits")
    rec.update(multi=dict(requests_served=multi["requests_served"],
                          shed_status=multi["shed_status"],
                          requests_expired=multi["requests_expired"],
                          seconds=time.perf_counter() - t_multi),
               card=smi, seconds=time.perf_counter() - t0)
    print(f"[http] HttpFrontend over the 1x1-conv artifact: {json.dumps(rec)}", flush=True)
    torch.cuda.empty_cache()
    return rec


def phase_serve_example(smi, out_dir):
    """The serving example as a user runs it: examples/serve.py --full-scale
    --server --http --requests 5 --seconds 2 (the convnet, which runs no
    kernel), into ``out_dir``.  Its multi-model demo ran in phase 23."""
    from perceiverio_pytorch_tpu_torch.examples import serve

    t0 = time.perf_counter()
    _reset_launch_counts()
    serve.main(["--full-scale", "--server", "--http", "--requests", "5", "--seconds", "2",
                "--out", out_dir])
    launches = _launch_counts()
    if any(launches.values()):
        raise AssertionError(f"the convnet's serving launched a kernel: {launches}")
    rec = dict(seconds=time.perf_counter() - t0, launches=launches["K1"], card=smi)
    print(f"[serve example] examples/serve.py --full-scale: {json.dumps(rec)}", flush=True)
    return rec


def _site_sums(records, keep, per_site):
    """Sums of the timed keys over the sites' launches (per_site: site ->
    launches), the records picked by ``keep``; None where a site has no
    time for a key (no SDPA backend took it)."""
    picked = [r for r in records if keep(r) and r["site"] in per_site]
    sums = {key: (None if any(r[key] is None for r in picked)
                  else sum(per_site[r["site"]] * r[key] for r in picked))
            for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
    sums["bound_by"] = ("operations" if all(r["bound_by"] == "operations" for r in picked)
                        else "bytes")
    return sums


def kernels_line(records, serve, backward, train, mm_serve, mm_train, cls_serve, cls_train,
                 cls_k1_train, buckets, serving):
    """One entry each for K1 on the flow path, K1 on the multimodal path,
    K2 and K3.  K1 (two sources: the bf16 wgmma
    kernel, which the serving forward runs, and the fp32 CUDA-core kernel
    with the split-KV merge): times summed over the 26 launches of one
    serving forward (6 tiles, bf16), the launches of the serving run (and,
    apart, of the training run), merges counted apart.  K2 and K3 (two sources
    each: the bf16 wgmma kernels with the sum of their split partials, which
    training runs, and the fp32 CUDA-core kernels): times summed over the 26
    launches of one training step (batch 1, bf16), the launches of the
    training run (the sums of both counted together); their plain and
    library times are the whole backward (dq, dk and dv in one call), the
    same for both.  K1 on the multimodal path (``flash_attention_fwd_d704``,
    the same sources at d = dv = 704, two value-column chunks): the bf16
    encoder site's times, the launches of the multimodal serving run.  K2
    and K3 on the multimodal path (``..._d704``, the same sources at d = dv
    = 704): the bf16 encoder site's times, the launches of the multimodal
    training run.  K1 at the classification encoders (``..._d261``, the
    pixel variant, and ``..._d512``, the 1x1-conv one; the same sources):
    the bf16 site's times at the served batch of 16, the launches of that
    variant's serving run, and apart (``..._train``) the bf16 site's times
    at the training batch of 8 and the launches of that variant's training
    run.  The same two entries count K1's launches on the serving stack
    apart: ``launches_export`` (the reloaded artifact's calls at batches 1,
    4 and 16 for the 1x1-conv variant, its one call for the pixel one),
    and for the 1x1-conv variant ``launches_server`` (the server windows'
    traffic and warm-ups) and ``launches_http``; their ``sites`` add K1 at
    the server's buckets 1, 2 and 4.  K2 and K3 at the classification encoders
    (``..._d261``, ``..._d512``; the same sources): the bf16 site's times at
    the training batch of 8, the launches of that variant's training run.
    Each entry's error is the largest of all its comparisons."""
    mm = [r for r in records if r["site"].startswith("mm_")]
    cls = [r for r in records if r["site"].startswith("cls_")]
    records = [r for r in records if not r["site"].startswith(("mm_", "cls_"))]
    mm_site = next(r for r in mm if r["site"] == "mm_encoder" and r["dtype"] == "bf16")
    k1_sources = {
        "sm90_wgmma": "perceiverio_pytorch_tpu_torch/csrc/flash_attention_fwd_sm90.cu",
        "cuda_cores": "perceiverio_pytorch_tpu_torch/csrc/flash_attention_fwd.cu",
    }
    entries = [dict(
        name="flash_attention_fwd",
        route="cuda",
        source="perceiverio_pytorch_tpu_torch/csrc/flash_attention_fwd_sm90.cu",
        sources={
            "sm90_wgmma": "perceiverio_pytorch_tpu_torch/csrc/flash_attention_fwd_sm90.cu",
            "cuda_cores": "perceiverio_pytorch_tpu_torch/csrc/flash_attention_fwd.cu",
        },
        routes={"bf16": "sm90_wgmma", "fp32": "cuda_cores"},
        replaces="perceiverio_pytorch_tpu/ops/pallas/flash_attention.py:77",
        launches=serve["launches"],
        merge_launches=serve["merge_launches"],
        launches_train=train["launches"]["K1"],
        merge_launches_train=train["launches"]["merge"],
        max_abs_err=max(rec["max_abs_err"] for rec in records),
        **_site_sums(records, lambda r: r["dtype"] == "bf16"
                     and r["shape"][0] == SERVE_TILES, SITE_LAUNCHES),
        sites=records,
    ), dict(
        name="flash_attention_fwd_d704",
        route="cuda",
        source=k1_sources["sm90_wgmma"],
        sources=k1_sources,
        routes={"bf16": "sm90_wgmma", "fp32": "cuda_cores"},
        replaces="perceiverio_pytorch_tpu/ops/pallas/flash_attention.py:77",
        launches=mm_serve["launches"],
        merge_launches=mm_serve["merge_launches"],
        max_abs_err=max(r["max_abs_err"] for r in mm),
        **{key: mm_site[key] for key in ("ms", "plain_ms", "library_ms", "bound_ms",
                                         "bound_by", "splits", "col_chunks")},
        sites=mm,
    )]
    for prep, site in CLS_SITE_OF.items():
        if site is None:
            continue
        mine = [r for r in cls if r["site"] in (site, f"{site}_masked")]
        site_rec = next(r for r in mine if r["site"] == site and r["dtype"] == "bf16")
        mine += [r for r in buckets if r["site"].startswith(f"{site}_bucket")]
        if site == "cls_1x1conv":
            stack = dict(
                launches_export=sum(c["launches"] for c in serving["export"]["k1"]["calls"]),
                launches_server=sum(r["launches"] for r in serving["server"]["runs"]),
                launches_http=serving["http"]["launches"])
        else:
            stack = dict(launches_export=serving["export"]["pixel"]["call"]["launches"])
        train_sites = [r for r in cls_k1_train if r["site"].startswith(f"{site}_train")]
        train_rec = next(r for r in train_sites
                         if r["site"] == f"{site}_train" and r["dtype"] == "bf16")
        entries.append(dict(
            name=f"flash_attention_fwd_d{CLS_SITES[site][4]}",
            route="cuda",
            source=k1_sources["sm90_wgmma"],
            sources=k1_sources,
            routes={"bf16": "sm90_wgmma", "fp32": "cuda_cores"},
            replaces="perceiverio_pytorch_tpu/ops/pallas/flash_attention.py:77",
            launches=cls_serve[prep]["launches"],
            merge_launches=cls_serve[prep]["merge_launches"],
            launches_train=cls_train[prep]["launches"]["K1"],
            merge_launches_train=cls_train[prep]["launches"]["merge"],
            **stack,
            max_abs_err=max(r["max_abs_err"] for r in mine + train_sites),
            **{key: site_rec[key] for key in ("ms", "plain_ms", "library_ms", "bound_ms",
                                              "bound_by", "splits", "col_chunks")},
            **{f"{key}_train": train_rec[key] for key in ("ms", "plain_ms", "library_ms",
                                                          "bound_ms", "bound_by", "splits")},
            sites=mine + train_sites,
        ))
    bwd_sources = {
        "sm90_wgmma": "perceiverio_pytorch_tpu_torch/csrc/flash_attention_bwd_sm90.cu",
        "cuda_cores": "perceiverio_pytorch_tpu_torch/csrc/flash_attention_bwd.cu",
    }
    for kernel, name, line in (("K2", "flash_attention_bwd_dkv", 473),
                               ("K3", "flash_attention_bwd_dq", 514)):
        mine = [r for r in backward
                if r["kernel"] == kernel and not r["site"].startswith(("mm_", "cls_"))]
        mm_bwd = [r for r in backward if r["kernel"] == kernel and r["site"].startswith("mm_")]
        mm_site = next(r for r in mm_bwd if r["site"] == "mm_encoder" and r["dtype"] == "bf16")
        common = dict(route="cuda", source=bwd_sources["sm90_wgmma"], sources=bwd_sources,
                      routes={"bf16": "sm90_wgmma", "fp32": "cuda_cores"},
                      replaces=f"perceiverio_pytorch_tpu/ops/pallas/flash_attention.py:{line}")
        entries.append(dict(
            name=name,
            **common,
            launches=train["launches"][kernel],
            sum_launches_train=train["launches"]["sum"],
            max_abs_err=max(r["max_abs_err"] for r in mine),
            **_site_sums(mine, lambda r: r["dtype"] == "bf16", SITE_LAUNCHES),
            sites=mine,
        ))
        entries.append(dict(
            name=f"{name}_d704",
            **common,
            launches=mm_train["launches"][kernel],
            sum_launches_train=mm_train["launches"]["sum"],
            max_abs_err=max(r["max_abs_err"] for r in mm_bwd),
            **{key: mm_site[key] for key in ("ms", "plain_ms", "library_ms", "bound_ms",
                                             "bound_by", "splits", "col_chunks")},
            sites=mm_bwd,
        ))
        for prep, site in CLS_SITE_OF.items():
            if site is None:
                continue
            cls_bwd = [r for r in backward if r["kernel"] == kernel and r["site"] == site]
            site_rec = next(r for r in cls_bwd if r["dtype"] == "bf16")
            entries.append(dict(
                name=f"{name}_d{CLS_TRAIN_SITES[site][4]}",
                **common,
                launches=cls_train[prep]["launches"][kernel],
                sum_launches_train=cls_train[prep]["launches"]["sum"],
                max_abs_err=max(r["max_abs_err"] for r in cls_bwd),
                **{key: site_rec[key] for key in ("ms", "plain_ms", "library_ms", "bound_ms",
                                                  "bound_by", "splits", "col_chunks")},
                sites=cls_bwd,
            ))
    return json.dumps({"kernels": entries})


def main() -> int:
    try:
        import torch
        import perceiverio_pytorch_tpu_torch  # noqa: F401
    except ImportError as exc:
        print(f"chip_smoke.py: {exc}; run it from the repository root",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    smi = phase_device()
    phase_build()
    records = phase_kernels()
    # Release the classification cases' large blocks, so that the flow and
    # multimodal phases start from the allocator state they had before them.
    torch.cuda.empty_cache()
    backward = phase_backward()
    torch.cuda.empty_cache()
    serve = phase_serve(phase_model())
    phase_gradients()
    train = phase_train()
    torch.cuda.empty_cache()
    mm_serve = phase_mm_serve(phase_mm_model())
    torch.cuda.empty_cache()
    phase_mm_gradients()
    mm_train = phase_mm_train()
    torch.cuda.empty_cache()
    cls_serve = phase_cls()
    phase_lm()
    torch.cuda.empty_cache()
    cls_k1_train, cls_backward = phase_cls_kernels()
    torch.cuda.empty_cache()
    phase_cls_gradients()
    cls_train = phase_cls_train()
    phase_lm_train()
    torch.cuda.empty_cache()
    buckets = phase_bucket_kernels()
    with tempfile.TemporaryDirectory() as tmp:
        weights, artifact, exported = phase_export(smi, os.path.join(tmp, "imagenet"))
        out_dir = os.path.join(tmp, "imagenet")
        serving = dict(export=exported, server=phase_server(smi, weights, artifact, out_dir),
                       http=phase_http(smi, weights, artifact, out_dir))
        del weights, artifact
        torch.cuda.empty_cache()
        phase_serve_example(smi, os.path.join(tmp, "example"))
    print(f"[done] {time.perf_counter() - t0:.1f} s")
    print(kernels_line(records, serve, backward + cls_backward, train, mm_serve, mm_train,
                       cls_serve, cls_train, cls_k1_train, buckets, serving))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
