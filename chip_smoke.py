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
     --full-scale (bf16 PERFORMANCE, remat under its remat_policy
     "dots_saveable", 16 chunks, batch 1, synthetic clips) through its
     Trainer: one warm-up step, then timed steps with finite losses,
     parameters that move once the warmup's lr-0 step is past, and the
     planned launches per step; then the same with full remat
     (--remat-policy nothing_saveable) beside it;
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
 25. flow from files: the port's tools/make_synthetic_data.py writes one
     scene of 6 frames of 436x1024 with .flo ground truth; the port's
     examples/train_flow.py --full-scale --data-dir (bf16, remat, batch 1,
     random 368x496 crops, 3 pairs trained, 2 held out and evaluated by the
     Trainer) runs 7 steps with checkpoints every 3 steps and at the end
     (synchronous) and batches prefetched 2 ahead (run A); a model drawn
     from another seed resumes from A's step 3 with fit(resume=True), async
     checkpoints and no prefetch (run B): the restored module, AdamW
     moments, step and learning rate equal A's at step 3 bit for bit, B's
     batches equal A's (sha256 each), step 4's loss is equal, and the final
     states are compared: where they differ, the largest difference is
     printed with the parameters whose gradient identical backward passes do
     not reproduce, by default and with cuDNN's deterministic algorithms;
     every step launches K1/K2/K3 as phase 8, every evaluation K1 26 times
     a pair;
     then step times with prefetch 2 and 0 in alternating windows, the
     decode ms of a batch, the seconds of each save, sync and async, the
     step that overlaps an async write, the restore, and the train state's
     bytes against the parameters;
 26. evaluate flow: examples/evaluate_flow.py over phase 25's 5 pairs at
     436x1024 (6 tiles each) from its final checkpoint: the model that
     restore_eval_variables gives equals the trained model in memory bit
     for bit, the script's numbers equal flow_error_stats on
     FlowInference's output, pairs/s, 26 K1 launches a pair;
 27. classification from files: the 1x1-conv classifier (d = 512) through
     examples/train_classification.py --full-scale --data-dir on 3 classes
     x 12 images of 224x224 at batch 8 (20 trained, 16 held out), 5 steps
     with async checkpoints every 2 and at the end, prefetch 2, resumed
     from step 2 with the checks of phase 25 and its timings (a synchronous
     save timed apart); then examples/evaluate_classification.py from the
     final checkpoint (top-1, top-5, images/s, K1 once a batch);
 28. evaluate multimodal: the port's tools/make_synthetic_data.py writes the
     val split of 36 labelled 16x224x224 clips with 48 kHz wav sidecars; a
     seeded published Kinetics autoencoder is written as a reference .pth
     and the port's convert.py turns it into a weights directory;
     examples/evaluate_multimodal.py (bf16, 16 chunks) scores all 36 clips
     (35 timed) from the directory and again from the .pth: the same
     numbers, the first
     clip's outputs equal to the in-memory model's on the arrays the script
     decoded, bit for bit, K1 and its merge once a clip, clips/s and peak
     memory;
 29. LoRA: examples/train_mlm.py --full-scale --lora 8 (bf16, batch 8), one
     warm-up step and 5 timed ones through the Trainer (evaluations at steps
     3 and 6, timed apart): the printed adapter count equals the sum of
     rank * (in + out) over the attention and MLP projections, every base
     weight is unchanged bit for bit, merge_lora's state_dict loads strictly
     into a fresh LanguagePerceiver whose loss on a held-out batch equals the
     wrapped model's; step time and peak memory beside phase 19's full
     fine-tune; the merged weights are saved for phase 30;
 30. evaluate MLM: examples/evaluate_mlm.py --full-scale --checkpoint (the
     merged weights) over 512 sequences of the port's synthetic text (63
     timed batches of 8), the masked rows alone, --full-decode, again
     --full-decode and the masked rows: the masked rows' logits against the
     full decode's rows at the same positions (relative to the largest
     logit, phase 15's tolerance), the same sequences and masked tokens, the
     accuracy within 1e-6 and the cross-entropy within 2e-3 (the bf16 gap
     reported, and both decodes held in fp32 where bf16 misses), sequences/s
     of each run, no kernel launch;
 31. EMA: the published flow model (bf16, remat, batch 1, synthetic pairs)
     through Trainer(ema_decay=0.99, lr_schedule=..., checkpoint_dir=...),
     one warm-up step and 3 more: after each step the EMA equals a
     recursion computed here from the step's parameters, bit for bit;
     launches as phase 8; evaluate() runs on the EMA weights by default;
     restore_eval_variables on the final checkpoint gives the EMA weights;
     the logged lr equals the schedule's; step time beside phase 8's;
 32. prints the run's seconds, the kernels line and, last, {"ok": true,
     "device": {...}} (after phases A to R below).

The rest of training runs in phases A to E, each where its inputs are
warm: B after phase 8, A after phase 12, C to E after phase 19.
  A. the multimodal step under dots_saveable: the published Kinetics
     autoencoder (bf16, remat, 16 chunks, one clip with a label), one step's
     gradients against full remat's bit for bit, K1/K2/K3 once a step each,
     step time and peak memory of both;
  B. the flow step under dots_saveable: the published flow model (bf16,
     remat, one roll pair), gradients against full remat's bit for bit, K1
     50 a step under both (26 forward, the 24 self-attends recomputed: the
     policy keeps products, not K1's output), K2 and K3 26;
  C. the published MLM (bf16, batch 8) through build_optimizer's Adafactor,
     Lion, SGD (momentum 0.9), accum_steps=2, skip_nonfinite_updates=2 and a
     decoder-only trainable mask beside AdamW, 1 + 3 steps each from the
     same weights: a NaN gradient leaves parameters, moments and the count
     bit for bit while the step counter moves, non-boundary micro-steps
     leave the parameters bit for bit, frozen weights stay bit for bit,
     Adafactor's state below AdamW's; step times, state bytes, the skip's
     host read;
  D. train_mlm --full-scale --steps-per-call 3 for 6 steps against
     --steps-per-call 1, both under torch.use_deterministic_algorithms (the
     token table's gradient, nn.Embedding's backward, differs between two
     backward passes of one batch otherwise, which the phase measures
     first): every loss and the final weights bit for bit, the log and
     evaluation lines at the same steps, the seconds of each;
  E. dropout 0.1 in every site of an encoder at the MLM's latent widths
     (26 self-attends, batch 8) with a CUDA generator: the kept share
     within 4 sigma of 0.9, eval mode equal to no dropout bit for bit, the
     gradients with remat (full and dots_saveable) equal to those without,
     bit for bit, under one seed; the Kinetics inputs' preprocessor with
     mask_probs 0.15 (image, audio) and 1 (label): masked shares within 4
     sigma, the same seed the same mask.

int8 (Policy.quant) runs in phases F to I, after phase 31, in the order G,
F, H, I (F takes G's shapes):
  F. every distinct int8 projection shape (M, K, N) of the full-width pixel
     and 1x1-conv classifiers at batch 16 and of the full-width MLM at
     batch 32 (one int8 request): torch._int_mm on operands zero-padded to
     its rules against the plain product (float64 on the card), int32 bit
     for bit; int8_dynamic_matmul and int8_static_matmul on the card
     against the CPU's on the same rows; times of both, of torch._int_mm
     alone and of bf16 F.linear, beside the bounds (1,979 int8 TOP/s,
     989 bf16 TFLOP/s, 3.35 TB/s);
  G. the full-width pixel and 1x1-conv classifiers at batch 16 under
     PERFORMANCE_INT8 and PERFORMANCE_INT8_STATIC (calibrated on two seeded
     batches), phase 14's weights and requests: K1 launches a request equal
     to the bf16 run's, one torch._int_mm a projection, quant_error_report
     against the model's exact bf16 pass (bounded), top-1 agreement,
     images/s and peak beside phase 14's;
  H. examples/serve.py build(full_scale=True, LEARNED_POS_1X1CONV,
     quant="static") and load: K1's op once and a torch._int_mm a
     projection in the graph, calibrated fp32 amax in the weights; the
     artifact at buckets 1, 4 and 16 against the eager int8 model, bit for
     bit; batch-1 latency beside phase 21's bf16 artifact;
  I. train_classification --full-scale --quant dynamic (1x1 conv, batch 8):
     1 + 3 steps through K1, K2 and K3 with the launches of phase 18's bf16
     step; one batch's gradients with the product on torch._int_mm against
     the plain product, bit for bit under deterministic algorithms; step
     time beside phase 18's.

The rest of the single-card surface runs in phases J to L, after phase I:
  J. the four reference demos (examples/opt_flow.py, img_classify.py for
     each PrepType, language.py, multimodal.py) at full width, fp32 as the
     demos run, each from a seeded reference-convention .pth given by
     --checkpoint, on media the phase writes at the demos' default paths (a
     436x1024 PNG frame pair: 6 tiles; a 375x500 JPEG; a 17-frame MJPG AVI;
     a stereo int16 48 kHz WAV): the demo's own forward against the same
     weights called directly on the same inputs, bit for bit; its K1
     launches against the serving phases' count a request (6, 14, 10: 26
     for flow, 1 for the pixel, 1x1-conv and multimodal models, none for the
     convnet and the MLM); each demo's seconds;
  K. ImagePostprocessor at the multimodal model's video shapes: "patches"
     from [1, 16, 56, 56, 48], "conv" over 16 frames of [56, 56, 512]
     (temporal_upsample 1, spatial 4), "conv" from [1, 8, 56, 56, 512]
     (temporal 2, spatial 4: a stride-1 time axis), "conv1x1" over the
     decoder's [1, 802816, 512]; all to [1, 16, 224, 224, 3], fp32 on the
     card against the CPU (1e-4 of the largest value), then bf16 ms and
     peak memory;
  L. utils.memory's compiled_memory_stats of a bf16 flow forward (6 tiles)
     against the allocator's high-water read around the same call,
     hbm_headroom's fit and its refusal of a request of twice the card's
     memory (the allocator usable after it); utils.profiling's trace of a
     served pair and op_stats finding K1's kernel as often as phase 6
     counts it; ThroughputMeter's pairs/s beside phase 6's; the full-width
     MLM under layer_scan "on" against "off", bit for bit.
The parallel layouts (parallel/) run in phases M to O, after phase L, each
on a (1, 1) mesh over the world-size-1 NCCL group that make_mesh((1, 1))
makes in this process (the card machine has one GPU; several ranks are
held on the CPU by the tests), each mesh run beside the same example run
without a mesh, for 1 + 3 steps:
  M. train_flow --full-scale (bf16 PERFORMANCE, remat, batch 1, phase 8's
     seed and batches) with --mesh 1 1 and with --mesh 1 1 --fsdp: the loss
     of every step and every state_dict entry after the last equal to the
     run without a mesh, bit for bit; K1/K2/K3 launches per step equal to
     phase 8's; the TP projections and the FSDP gathers counted; one more
     step profiled for its collectives (the c10d calls and the NCCL kernels,
     counts and ms); step time and peak memory beside phase 8's;
  N. train_classification --full-scale --prep-type LEARNED_POS_1X1CONV
     --mesh 1 1 --fsdp (K1/K2/K3 at d = 512, launches per step as phase 18's)
     and train_mlm --full-scale --mesh 1 1 (no kernel; evaluations at steps
     2 and 4), each held as in M, under deterministic algorithms for both
     runs;
  O. FlowInference on the mesh over phase 6's three pairs and weights: the
     flows equal phase 6's bit for bit, 26 K1 launches a request;
     evaluate_classification --full-scale --prep-type LEARNED_POS_1X1CONV
     --mesh 1 over 64 images: every batch's logits and the top-1/top-5
     equal the run without --mesh; then the process group is torn down.
Sequence parallelism, chunk_mesh and the mesh server run in phases P and
Q, after phase O, on a new (1, 1) mesh:
  P. (a) the ring's merge in one process: the flow encoder (1, 2048,
     182,528, 1, 322) and the multimodal encoder (1, 784, 52,097, 1, 704)
     in bf16 and fp32, their keys split into 2, 4 and 8 pieces (padded with
     masked keys where the count does not divide), K1 with its lse on each
     piece merged by the ring's own lse_merge with one-process reductions,
     then K2/K3 on each piece with the merged output and the global lse:
     the output, dK/dV concatenated and dQ summed against K1/K2/K3 on the
     whole site within TOL (relative to max |x|), the pieces' summed ms
     beside the whole site's; (b) the published flow model under
     Policy(sp_mesh=mesh) on phase 6's pairs and weights (the encoder
     through the ring once a request: the flows against phase 6's, bit for
     bit or the largest gap within MODEL_TOL, 26 K1 launches a request) and
     a phase-8 step (train_flow's model, loss and remat, bf16) with and
     without it (loss and every gradient, bit for bit or within
     BF16_GRAD_TOL; K1/K2/K3 launches as phase 8's); (c) the multimodal
     model under Policy(sp_mesh) on phase 10's clip and weights (the
     encoder's 52,097 keys through the ring, K1 once a clip, the outputs
     against phase 10's);
  Q. phase 10's clip through MultiModalPerceiver(chunk_mesh=mesh) (128
     waves of one chunk): every output bit for bit against phase 10's, K1
     once a clip; the full-width bf16 1x1-conv classifier behind
     serve_on_mesh (BatchingServer over make_data_parallel_apply, buckets 8
     and 16, pipeline on, 24 single-image requests): every batch the server
     ran bit for bit against the eager model on the same padded batch,
     every row its batch's, one K1 launch a batch (the two warm-ups apart);
     then the process group is torn down.
The pipelines run in phase R, after Q, on the published flow model of
phases 6 and 8 (24 self-attends of 2048 x 512 latents, 16 heads):
  R. (a) the schedule in one process (``parallel.pipeline``'s
     ``pipeline_layers(stages=S)``: the Policy route's tick loop and stage
     body, each stage's output handed on by a local hop in place of the
     ring's send): the latents the stack receives on phase 6's six tiles
     through GPipe at S = 2, 4, 8 with M = 2, 3, 6 and the circular
     schedule at S = 4, v = 2, M = 6, in bf16 (PERFORMANCE) and fp32
     (PARITY with flash), each timed after a warm-up at its shape, against
     the sequential stack within TOL (bit for bit said), K1's launches
     exactly 24 x M (the valid ticks), printed beside 24 x (v M + S - 1) / v
     (every stage every tick); (b) the backward at batch 2, M = 2, GPipe S
     = 4 and circular S = 2 (v = 2), loss sum(out * g) with a seeded g:
     every stack parameter's and the latents' gradient against the
     sequential stack's within GRAD_TOL / BF16_GRAD_TOL, K1, K2 and K3
     exactly 48 launches each; (c) a one-stage pipe mesh
     (``make_pipeline_mesh(1)``, a one-rank group): phase 6's flows under
     Policy(pp_mesh) bit for bit, 26 K1 a request, and a phase-8 step's
     loss and gradients bit for bit against the step without it, K1 50 /
     K2 26 / K3 26; then the process group is torn down.  No point-to-point
     send runs on one card.

It exits non-zero without a result when there is no GPU or when the port's
package is not beside it.
"""

from __future__ import annotations

import contextlib
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
SERVED = {}  # phase 6's requests, flows and weights, which phase O serves again
MM_SERVED = {}  # phase 10's last clip, its outputs and weights, which P and Q decode again
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
# The file-backed phases (25 to 27).  Flow: one scene of 6 frames of 436x1024
# (5 pairs; the example trains on 3 and holds the last 2 * batch out), 7
# steps with checkpoints every 3 and at the end, resumed from step 3.
FILE_FLOW_HW = (436, 1024)
FILE_FLOW_FRAMES = 6
FILE_FLOW_STEPS = 7
FILE_FLOW_EVERY = 3
# Classification: 3 classes x 12 images of 224x224 at batch 8, 5 steps with
# checkpoints (async) every 2 and at the end, resumed from 2.  The example
# holds the last 2 * batch files out in sorted order: with 2 classes of 12
# all 8 training images would be of one class; with 3, 20 images of two
# classes train and 16 of two are held out.
FILE_CLS_CLASSES = 3
FILE_CLS_IMAGES = 12
FILE_CLS_STEPS = 5
FILE_CLS_EVERY = 2
CLS_TRAIN_BATCH = 8
DECODE_REPS = 3  # batches decoded on one thread for the decode time
# Step times with and without prefetch: alternating windows of fits.
PREFETCH_WINDOW = 5
PREFETCH_ORDER = (2, 0, 0, 2)
# The train -> evaluate phases (28 to 31).  Multimodal evaluation: the port's
# tool writes the val split of 9 classes x 4 labelled 16x224x224 clips with
# 48 kHz wav sidecars; evaluate_multimodal scores all MM_EVAL_CLIPS (16
# decoder chunks, its default), the first one untimed.
MM_EVAL_CLIPS = 36
# LoRA: train_mlm --full-scale --lora LORA_RANK at batch 8, one warm-up step
# then LORA_STEPS timed ones (evaluations at steps 3 and 6, timed apart).
LORA_RANK = 8
LORA_STEPS = 5
# The attention and MLP projections' module names, which the adapter count
# is held against (counted from the base model's Linear modules, apart from
# the selection in training/lora.py).
LORA_TARGETS = ("proj_q", "proj_k", "proj_v", "final", "fc1", "fc2")
# The merged model's loss against the wrapped one's on one batch, relative:
# the same bf16 forward on weights W + (a @ b)^T that the two sides form
# with the same ops (measured: see "bitwise" in the phase's line).
LORA_MERGE_TOL = 1e-3
# MLM evaluation of the merged model: 512 sequences of 2,048 bytes of the
# port's synthetic text (its train split: the val split holds 146), batch 8,
# the first batch untimed; the masked rows alone against the full decode,
# run in this order for the rates, at the JAX test's tolerances
# (tests/test_evaluate_mlm.py).
MLM_EVAL_LIMIT = 512
MLM_EVAL_ORDER = ("partial", "full", "full", "partial")
MLM_EVAL_TOL = {"masked_accuracy": 1e-6, "masked_ce": 2e-3}
# EMA of the flow model's parameters over one warm-up and EMA_STEPS steps.
EMA_DECAY = 0.99
EMA_STEPS = 3
# The rest of training (phases A to E).  Remat policies: the multimodal
# training example's (the JAX example's) against full remat.
SAC_POLICY = "dots_saveable"
FULL_REMAT = "nothing_saveable"
# build_optimizer's variants on the published MLM (batch 8), each for one
# step and OPT_STEPS more at a constant OPT_LR with the clip, beside AdamW;
# the skip variant's gradient is NaN at step OPT_NAN_STEP.
OPT_LR = 3e-4
OPT_STEPS = 3
OPT_NAN_STEP = 2
OPT_VARIANTS = ("adamw", "adafactor", "lion", "sgd", "accum", "skip", "trainable")
FINITE_READS = 20  # timed reads of the skip's finiteness flag
# train_mlm --full-scale --steps-per-call SPC for SPC_STEPS steps (log and
# evaluation every SPC) against --steps-per-call 1.
SPC = 3
SPC_STEPS = 6
# Dropout on an encoder at the byte MLM's widths (2,048 inputs of 768
# channels, 256 x 1280 latents, 26 self-attends of 8 heads, qk width 256),
# batch 8, and stochastic masking of the Kinetics inputs.
DROPOUT = 0.1
MASK_PROB = 0.15
SIGMAS = 4.0
# int8 (phases F to I).  Peak dense int8 rate of one H100 SXM (NVIDIA data
# sheet), for the products' bound.
PEAK_INT8_OPS = 1979e12
INT8_PREPS = ("FOURIER_POS_PIXEL", "LEARNED_POS_1X1CONV")
INT8_MODES = {"dynamic": "PERFORMANCE_INT8", "static": "PERFORMANCE_INT8_STATIC"}
INT8_CALIB_BATCHES = 2  # seeded batches of 16 that calibrate the static models
# The int8 logits against the same model's exact bf16 pass, relative to its
# max |logit|, across 49 attention blocks of int8 projections (about 1% a
# GEMM on Gaussian data; static clips what exceeds its calibrated range).
INT8_REL_BOUND = {"dynamic": 0.25, "static": 0.5}
INT8_CPU_ROWS = 512  # rows of each product held against the CPU's functions
INT8_REPS = 5
INT8_TRAIN_STEPS = 3  # timed, after one warm-up step

# The rest of the single-card surface (phases J to L).
DEMO_FLOW_HW = (436, 1024)  # Sintel's frame size: 6 tiles of 368x496
DEMO_IMAGE_HW = (375, 500)
DEMO_CLIP_FRAMES = 17  # one more than the demo takes
DEMO_AUDIO_SAMPLES = 16 * 1920 + 480
POSTPROC_TOL = 1e-4
POSTPROC_REPS = 10
HBM_TOL = 0.02  # compiled_memory_stats against the allocator read around the same call
# The parallel layouts on one card (phases M to O): a (1, 1) mesh over a
# world-size-1 NCCL group.  Each mesh run takes 1 + MESH_STEPS steps beside
# the same example's run without a mesh, and must equal it bit for bit: on
# one rank every collective leaves its tensor as it is, a row-parallel
# projection's bias is added in its one product, FSDP's gather is a copy.
MESH_STEPS = 3
MESH_EVAL_LIMIT = 64  # images of evaluate_classification --full-scale, with and without --mesh
# Sequence parallelism, chunk_mesh and the mesh server (phases P and Q).  The
# published encoder sites whose keys the ring splits, and the numbers of
# pieces they are split into in one process.
SP_SITES = {"flow_encoder": FLOW_SITES["encoder"], "mm_encoder": MM_SITE}
# The pipelines (phase R): the GPipe (stages, microbatches) and circular
# (stages, repeats, microbatches) schedules over phase 6's six tiles, and
# the backward's cases (name, stages, repeats) at batch 2, two microbatches.
PP_GPIPE = tuple((s, m) for s in (2, 4, 8) for m in (2, 3, 6))
PP_CIRCULAR = (4, 2, 6)
PP_BACKWARD = (("gpipe", 4, 1), ("circular", 2, 2))
PP_LAYERS = 24
SP_PIECES = (2, 4, 8)
SP_REPS = 2
MESH_SERVER_REQUESTS = 24  # single images, served in buckets of 8 and 16



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
    latencies, flows = [], []
    fa.LAUNCHES = fa.LAUNCHES_MERGE = 0
    t_all = time.perf_counter()
    for img1, img2 in requests[1:]:
        t0 = time.perf_counter()
        flow = infer(img1, img2)
        torch.cuda.synchronize()
        latencies.append(time.perf_counter() - t0)
        if tuple(flow.shape) != (1, 2, 436, 1024) or not torch.isfinite(flow).all():
            raise AssertionError(f"bad flow: shape {tuple(flow.shape)}")
        flows.append(flow)
    total = time.perf_counter() - t_all
    # Phase O serves the same pairs with the same weights on a mesh.
    SERVED.update(requests=requests[1:], flows=[f.cpu() for f in flows], latency_s=latencies,
                  weights={k: v.cpu() for k, v in model.state_dict().items()})
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
    trainer, state, batches, _ = train_flow.setup(
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
        MM_SERVED.update(clip=clips[-1], outputs={k: v.cpu() for k, v in out.items()},
                         weights={k: v.cpu() for k, v in model.state_dict().items()},
                         latency_s=latencies)
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
    PERFORMANCE, remat under its dots_saveable, 16 decoder chunks, batch 1,
    synthetic clips) through its Trainer, one step per fit() call; then the
    same with full remat (--remat-policy nothing_saveable) beside it."""
    import torch

    from perceiverio_pytorch_tpu_torch.examples import train_multimodal

    total = 1 + MM_TRAIN_STEPS
    recs = {}
    for policy in (None, FULL_REMAT):  # None: the example's own
        metrics = _metrics_path(f"chip_smoke_mm_train_metrics_{policy or 'default'}.jsonl")
        trainer, state, batches = train_multimodal.setup(
            total, full_scale=True, device="cuda", metrics_path=metrics, log_every=1,
            remat_policy=policy)
        name = state.model.perceiver.policy.remat_policy
        if name != (policy or SAC_POLICY):
            raise AssertionError(f"train_multimodal --full-scale runs remat_policy {name}")
        recs[name] = _train_steps(trainer, state, batches, total, metrics, MM_STEP_LAUNCHES)
        del trainer, state
        torch.cuda.empty_cache()
    rec = dict(recs[SAC_POLICY], remat_policy=SAC_POLICY, full_remat=recs[FULL_REMAT])
    print(f"[mm train] bf16 full width, remat ({SAC_POLICY}; full remat beside it), "
          f"{MM_TRAIN_CHUNKS} chunks, batch 1: {json.dumps(rec)}", flush=True)
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
    """What the exported program holds: its K1 op nodes, its int8 products
    (aten._int_mm nodes), its state (which must hold no parameter), its constants (each must be one of the model's
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
                int_mm_nodes=sum(n.target is torch.ops.aten._int_mm.default
                                 for n in ep.graph.nodes),
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


def _flow_eval_launches(batches):
    """Launches of the flow model's evaluation forward at batch 1 (eval
    mode): K1 at the 26 sites, the encoder's key splits merged once."""
    return dict(NO_LAUNCHES, K1=26 * batches, merge=batches)


def _cls_eval_launches(batches):
    """Launches of the 1x1-conv classifier's evaluation forward at batch 8:
    K1 once at the encoder, its 4 key splits merged once."""
    return dict(NO_LAUNCHES, K1=batches, merge=batches)


def _decode_ms(dataset, batch_size, reps=DECODE_REPS):
    """Host milliseconds to read and decode one batch of ``dataset`` on one
    thread (``dataset_iterator(num_workers=0)``), the mean of ``reps``."""
    from perceiverio_pytorch_tpu_torch.training import dataset_iterator

    stream = dataset_iterator(dataset, batch_size, shuffle=True, epochs=None, num_workers=0)
    next(stream)  # warm-up: imports and first file reads
    t0 = time.perf_counter()
    for _ in range(reps):
        next(stream)
    return (time.perf_counter() - t0) / reps * 1e3


def _hashed(batches, hashes, main_thread_s):
    """``batches(start)`` with each batch's sha256 recorded under its
    absolute index; a batch already on the card is copied to the host for
    it, and that time (spent between two steps on the main thread) is kept
    to be taken out of the step times."""
    import hashlib

    import numpy as np
    import torch

    def wrapped(start):
        for k, batch in enumerate(batches(start)):
            t = time.perf_counter()
            digest = hashlib.sha256()
            for a in batch:
                a = a.cpu().numpy() if isinstance(a, torch.Tensor) else a
                digest.update(np.ascontiguousarray(a).tobytes())
            hashes[start + k] = digest.hexdigest()
            if isinstance(batch[0], torch.Tensor) and batch[0].is_cuda:
                main_thread_s.append(time.perf_counter() - t)
            yield batch

    return wrapped


def _host_state(state):
    """The step, learning rate, module and optimizer tensors of ``state``,
    copied to the host (the moments under their parameter's name)."""
    names = {id(p): n for n, p in state.model.named_parameters()}
    params = [p for g in state.optimizer.param_groups for p in g["params"]]
    opt = state.optimizer.state_dict()
    return dict(step=state.step, lr=state.optimizer.param_groups[0]["lr"],
                model={k: v.detach().cpu().clone() for k, v in state.model.state_dict().items()},
                moments={names[id(params[i])]: {k: v.detach().cpu().clone()
                                                for k, v in e.items()}
                         for i, e in opt["state"].items()})


def _nondeterministic_grads(trainer, state, batch, pairs=3):
    """The parameters (with their module's class) whose gradient differs
    between backward passes of one batch from the same weights (up to
    ``pairs`` pairs), with cuDNN's default algorithms and with
    ``cudnn.deterministic``: the cause of a resumed run's final state that
    is not bit for bit."""
    import torch

    model = state.model.train()

    def grads():
        model.zero_grad(set_to_none=True)
        trainer.loss_fn(model, *batch).backward()
        torch.cuda.synchronize()
        return {n: p.grad.detach().clone() for n, p in model.named_parameters()
                if p.grad is not None}

    out = {}
    for deterministic in (False, True):
        differ = set()
        torch.backends.cudnn.deterministic = deterministic
        try:
            for _ in range(pairs):
                first, second = grads(), grads()
                differ |= {n for n in first if not torch.equal(first[n], second[n])}
                if differ:
                    break
        finally:
            torch.backends.cudnn.deterministic = False
        out["cudnn_deterministic" if deterministic else "default"] = sorted(
            f"{n} ({type(model.get_submodule(n.rsplit('.', 1)[0])).__name__})"
            for n in differ)
    model.zero_grad(set_to_none=True)
    return out


def _state_diff(got, want):
    """(the largest |difference| over the module and optimizer tensors, the
    tensor it is at); (0.0, None) when they are equal bit for bit."""
    import torch

    worst, where = 0.0, None
    pairs = [(f"model {k}", got["model"][k], v) for k, v in want["model"].items()]
    pairs += [(f"optimizer {i} {k}", got["moments"][i][k], v)
              for i, e in want["moments"].items() for k, v in e.items()]
    for name, a, b in pairs:
        if not torch.equal(a, b):
            diff = (a.double() - b.double()).abs().max().item()
            if diff >= worst:
                worst, where = diff, name
    return worst, where


def _files_fit(trainer, state, batches, eval_batches, num_steps, expected, *, resume=False,
               on_save=None, on_restore=None, hash_s=()):
    """One ``fit`` (log_every=1) of a file-backed example: each step's time
    (its logged window less the evaluations, saves and batch hashes in it)
    and launches (less the evaluations'), every save's and evaluation's
    seconds and launches, the restore's seconds and the logged losses.  The
    first step of the fit includes its first batch's decode and is kept
    apart."""
    import torch

    from perceiverio_pytorch_tpu_torch.training import checkpoint as ckpt

    rec = dict(saves=[], evals=[], steps=[])
    pending = dict(seconds=0.0, launches={k: 0 for k in expected})
    mark = dict(t=None, counts={k: 0 for k in expected}, hashes=len(hash_s))
    log, save, evaluate = trainer.logger.log, trainer._save_checkpoint, trainer.evaluate
    restore = ckpt.restore_train_state

    def timed(fn, *args, **kwargs):
        torch.cuda.synchronize()
        counts, t = _launch_counts(), time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t
        launches = {k: v - counts[k] for k, v in _launch_counts().items()}
        pending["seconds"] += seconds
        for k in pending["launches"]:
            pending["launches"][k] += launches[k]
        return out, seconds, launches

    def timed_log(**metrics):
        if "loss" in metrics:
            now, counts = time.perf_counter(), _launch_counts()
            launches = {k: counts[k] - mark["counts"][k] - pending["launches"][k]
                        for k in expected}
            if launches != expected:
                raise AssertionError(f"step {metrics['step']}: launches {launches}, "
                                     f"expected {expected}")
            if mark["t"] is not None:
                hashes = sum(hash_s[mark["hashes"]:])
                rec["steps"].append(dict(step=metrics["step"], loss=metrics["loss"],
                                         seconds=now - mark["t"] - pending["seconds"] - hashes))
            else:
                rec["first"] = dict(step=metrics["step"], loss=metrics["loss"])
            mark.update(t=now, counts=counts, hashes=len(hash_s))
            pending["seconds"], pending["launches"] = 0.0, {k: 0 for k in expected}
        log(**metrics)

    def timed_save(st, step):
        _, seconds, _ = timed(save, st, step)
        rec["saves"].append(dict(step=step, seconds=seconds, async_=trainer.checkpoint_async))
        if on_save is not None:
            on_save(st, step)

    def timed_evaluate(*args, **kwargs):
        out, seconds, launches = timed(evaluate, *args, **kwargs)
        rec["evals"].append(dict(seconds=seconds, launches=launches, metrics=out))
        return out

    def timed_restore(path, st):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = restore(path, st)
        torch.cuda.synchronize()
        rec["restore_s"] = time.perf_counter() - t
        if on_restore is not None:
            on_restore(out)
        return out

    _reset_launch_counts()
    t0 = time.perf_counter()
    with mock.patch.object(trainer.logger, "log", timed_log), \
            mock.patch.object(trainer, "_save_checkpoint", timed_save), \
            mock.patch.object(trainer, "evaluate", timed_evaluate), \
            mock.patch.object(ckpt, "restore_train_state", timed_restore):
        state = trainer.fit(state, batches, num_steps=num_steps, eval_batches=eval_batches,
                            resume=resume)
    torch.cuda.synchronize()
    rec["fit_s"] = time.perf_counter() - t0
    if state.step != num_steps or len(rec["steps"]) + 1 != num_steps - (
            rec["first"]["step"] - 1):
        raise AssertionError(f"fit stopped at step {state.step}: {rec['steps']}")
    if any(not math.isfinite(s["loss"]) for s in rec["steps"]):
        raise AssertionError(f"non-finite loss: {rec['steps']}")
    return state, rec


def _median(values):
    values = sorted(values)
    return values[len(values) // 2] if values else None


def _resume_check(label, setup, total, every, expected, eval_expected, tmp):
    """Run A (weights from seed 0, batches prefetched 2 ahead) for ``total``
    steps, checkpointing every ``every`` and at the end; run B (weights from
    seed 1, no prefetch) resumed from A's first checkpoint, copied into a
    directory of its own, to ``total``.  Holds the restored state against
    A's at that step (bit for bit: module, moments, step, learning rate),
    B's batches against A's (sha256 each), the first resumed step's loss,
    the launches of every step (``expected``) and evaluation
    (``eval_expected(n_eval_batches)``), and compares the final states.
    Returns (record, A's state, A's checkpoint directory)."""
    import shutil

    import torch

    from perceiverio_pytorch_tpu_torch.training import latest_checkpoint

    ck_a, ck_b = os.path.join(tmp, f"{label}_a"), os.path.join(tmp, f"{label}_b")
    hashes_a, hashes_b, hash_s = {}, {}, []
    saved = {}

    def on_save(state, step):
        if step == every:
            saved.update(_host_state(state))

    trainer, state_a, batches, eval_batches = setup(seed=0, checkpoint_dir=ck_a, prefetch=2)
    trainer.checkpoint_final = True
    n_eval = len(eval_batches or [])
    state_a, run_a = _files_fit(trainer, state_a, _hashed(batches, hashes_a, hash_s),
                                eval_batches, total, expected, on_save=on_save)
    final_a = _host_state(state_a)
    shutil.copytree(os.path.join(ck_a, f"step_{every:08d}"),
                    os.path.join(ck_b, f"step_{every:08d}"))
    del trainer, batches
    torch.cuda.empty_cache()

    restored = {}
    trainer, state_b, batches, eval_batches = setup(seed=1, checkpoint_dir=ck_b, prefetch=0)
    other_weights = any(not torch.equal(v.cpu(), saved["model"][k])
                        for k, v in state_b.model.state_dict().items())
    state_b, run_b = _files_fit(
        trainer, state_b, _hashed(batches, hashes_b, hash_s), eval_batches, total, expected,
        resume=True, on_restore=lambda st: restored.update(_host_state(st)), hash_s=hash_s)
    if not other_weights or not restored:
        raise AssertionError(f"{label}: run B did not start from other weights and restore")
    restore_diff = _state_diff(restored, saved)
    if restore_diff != (0.0, None) or (restored["step"], restored["lr"]) != (
            saved["step"], saved["lr"]):
        raise AssertionError(f"{label}: restored state != saved state: {restore_diff}, "
                             f"step/lr {restored['step']}/{restored['lr']} vs "
                             f"{saved['step']}/{saved['lr']}")
    differ = [k for k in range(every, total) if hashes_b.get(k) != hashes_a.get(k)]
    if differ or len([k for k in range(every, total) if k in hashes_b]) != total - every:
        raise AssertionError(f"{label}: run B's batches differ from run A's at {differ}")
    losses_a = {s["step"]: s["loss"] for s in run_a["steps"]}
    losses_a[run_a["first"]["step"]] = run_a["first"]["loss"]
    if run_b["first"]["step"] != every + 1 or run_b["first"]["loss"] != losses_a[every + 1]:
        raise AssertionError(f"{label}: step {every + 1} loss {run_b['first']} vs A's "
                             f"{losses_a[every + 1]}")
    for run in (run_a, run_b):
        for ev in run["evals"]:
            if ev["launches"] != eval_expected(n_eval):
                raise AssertionError(f"{label}: evaluation launches {ev['launches']}, "
                                     f"expected {eval_expected(n_eval)}")
    final_diff, final_where = _state_diff(_host_state(state_b), final_a)
    cause = None
    if final_diff != 0.0:
        # Not bit for bit, though the restored state, the batches and the
        # first loss were: name the gradients that identical backward passes
        # do not reproduce, by default and with cuDNN's deterministic
        # algorithms.
        cause = _nondeterministic_grads(trainer, state_b, next(iter(batches(0))))
    latest = latest_checkpoint(ck_a)
    if not latest.endswith(f"step_{total:08d}"):
        raise AssertionError(f"{label}: A's newest checkpoint is {latest}")
    size = os.path.getsize(os.path.join(latest, "train_state.pt"))
    params = sum(p.numel() for p in state_a.model.parameters())
    rec = dict(
        steps=total, resumed_from=every, restored_bit_for_bit=True, batches_equal=True,
        first_resumed_loss=run_b["first"]["loss"],
        losses_a=[losses_a[k] for k in sorted(losses_a)],
        losses_b=[run_b["first"]["loss"]] + [s["loss"] for s in run_b["steps"]],
        final_bit_for_bit=final_diff == 0.0, final_max_abs_diff=final_diff,
        final_worst_tensor=final_where, nondeterministic_grads=cause,
        step_s_run_a=[s["seconds"] for s in run_a["steps"]],
        step_s_run_b=[s["seconds"] for s in run_b["steps"]],
        saves_a=run_a["saves"], saves_b=run_b["saves"], restore_s=run_b["restore_s"],
        evals=[dict(seconds=e["seconds"], launches=e["launches"], metrics=e["metrics"])
               for e in run_a["evals"] + run_b["evals"]],
        hash_s=sum(hash_s), fit_s=[run_a["fit_s"], run_b["fit_s"]],
        train_state_bytes=size, params=params, bytes_per_param=size / params,
        launches_per_step=expected,
        launches=dict(
            train={k: v * (total + total - every) for k, v in expected.items()},
            eval={k: sum(e["launches"][k] for e in run_a["evals"] + run_b["evals"])
                  for k in expected}),
    )
    del trainer, batches, state_b
    torch.cuda.empty_cache()
    return rec, state_a, latest


def _prefetch_windows(setup, expected):
    """Step times of the example from files with its batches prefetched 2
    ahead and with none, in alternating windows of PREFETCH_WINDOW steps
    (2, 0, 0, 2; the first step of each window, which waits for its first
    batch, left out), without evaluations or checkpoints."""
    import torch

    runs = {p: setup(seed=2, checkpoint_dir=None, prefetch=p) for p in (2, 0)}
    times = {2: [], 0: []}
    for prefetch in PREFETCH_ORDER:
        trainer, state, batches, _ = runs[prefetch]
        state, rec = _files_fit(trainer, state, batches, None, state.step + PREFETCH_WINDOW,
                                expected)
        times[prefetch] += [s["seconds"] for s in rec["steps"]]
    del runs
    torch.cuda.empty_cache()
    return dict(window_step_s_prefetch2=times[2], window_step_s_prefetch0=times[0],
                median_step_s_prefetch2=_median(times[2]),
                median_step_s_prefetch0=_median(times[0]))


def _stalls(rec, median_step_s):
    """Each step that ran while an async save was written (the step after
    the save), its time, and its time over ``median_step_s``."""
    out = []
    for run, saves, first in (("a", rec["saves_a"], 2), ("b", rec["saves_b"],
                                                          rec["resumed_from"] + 2)):
        times = dict(zip(range(first, rec["steps"] + 1), rec[f"step_s_run_{run}"]))
        for save in saves:
            if save["step"] + 1 in times and save["async_"]:
                during = times[save["step"] + 1]
                out.append(dict(run=run, step=save["step"] + 1, seconds=during,
                                stall_s=during - median_step_s))
    return out


def phase_flow_files(tmp):
    """The published flow model trained from files: the port's tool writes
    one 436x1024 scene, train_flow --full-scale --data-dir trains 7 steps
    with checkpoints (sync) every 3 and at the end and batches prefetched 2
    ahead, then a model of other weights resumes from step 3 with async
    checkpoints and no prefetch; see _resume_check."""
    from perceiverio_pytorch_tpu_torch.examples import train_flow
    from perceiverio_pytorch_tpu_torch.tools import make_synthetic_data

    t0 = time.perf_counter()
    root = os.path.join(tmp, "data")
    make_synthetic_data.make_flow(root, hw=FILE_FLOW_HW,
                                  scenes={"train": (1, FILE_FLOW_FRAMES)})
    scene = os.path.join(root, "flow_synth", "train", "scene_00")
    tree_s = time.perf_counter() - t0
    train_ds, held_out = train_flow.flow_datasets(scene, train_flow.FULL_SCALE_HW, 1)
    decode_ms = _decode_ms(train_ds, 1)

    def setup(seed, checkpoint_dir, prefetch):
        return train_flow.setup(
            FILE_FLOW_STEPS, full_scale=True, device="cuda", log_every=1,
            metrics_path=_metrics_path(f"chip_smoke_flow_files_{seed}.jsonl"), data_dir=scene,
            checkpoint_dir=checkpoint_dir, checkpoint_every=FILE_FLOW_EVERY,
            checkpoint_async=seed == 1, prefetch=prefetch, seed=seed)

    rec, state, latest = _resume_check(
        "flow", setup, FILE_FLOW_STEPS, FILE_FLOW_EVERY, STEP_LAUNCHES,
        _flow_eval_launches, tmp)
    rec.update(_prefetch_windows(setup, STEP_LAUNCHES))
    rec.update(async_steps=_stalls(rec, rec["median_step_s_prefetch0"]),
               frames=FILE_FLOW_FRAMES, frame_hw=FILE_FLOW_HW, pairs_train=len(train_ds),
               pairs_held_out=len(held_out), tree_s=tree_s, decode_ms_per_batch=decode_ms,
               sync_save_s=[s["seconds"] for s in rec["saves_a"]],
               async_save_s=[s["seconds"] for s in rec["saves_b"]],
               seconds=time.perf_counter() - t0)
    print(f"[flow files] bf16 full width, train_flow --data-dir, resume: {json.dumps(rec)}",
          flush=True)
    return dict(rec, model=state.model, checkpoint=latest, scene=scene)


def phase_evaluate_flow(flow_files):
    """examples/evaluate_flow.py over phase 25's scene (5 pairs of 436x1024,
    6 tiles each) from its final checkpoint: the model restore_eval_variables
    gives equals the trained model in memory bit for bit, the script's
    numbers equal flow_error_stats on FlowInference's output, 26 K1 launches
    a pair."""
    import torch

    from perceiverio_pytorch_tpu_torch import FlowInference
    from perceiverio_pytorch_tpu_torch.examples import evaluate_flow
    from perceiverio_pytorch_tpu_torch.utils.flow_io import flow_error_stats, read_flo

    t0 = time.perf_counter()
    scene, ckpt = flow_files["scene"], flow_files["checkpoint"]
    trained = FlowInference(flow_files["model"], device="cuda")
    restored = FlowInference(evaluate_flow.build_model(checkpoint=ckpt, device="cuda"),
                             device="cuda")
    totals, pixels, pairs = {}, 0, 0
    for f1, f2, gt in evaluate_flow.frame_pairs(scene):
        a, b = evaluate_flow.load_frame(f1), evaluate_flow.load_frame(f2)
        want, got = trained(a, b), restored(a, b)
        if not torch.equal(got, want):
            raise AssertionError(f"restored model != trained model at {f1}: "
                                 f"{(got - want).abs().max().item()}")
        stats = flow_error_stats(want[0].cpu().numpy(), read_flo(gt))
        w = stats.pop("pixels")
        pixels += w
        pairs += 1
        for k, v in stats.items():
            totals[k] = totals.get(k, 0.0) + v * w
    del trained, restored
    torch.cuda.empty_cache()
    _reset_launch_counts()
    t = time.perf_counter()
    result = evaluate_flow.main(scene, checkpoint=ckpt, device="cuda")
    seconds = time.perf_counter() - t
    launches = _launch_counts()
    mine = {k: round(v / pixels, 4) for k, v in totals.items()}
    if result["pairs"] != pairs or any(result[k] != v for k, v in mine.items()):
        raise AssertionError(f"evaluate_flow {result} vs flow_error_stats {mine}")
    if launches["K1"] != _flow_eval_launches(pairs)["K1"] or launches["K2"] or launches["K3"]:
        raise AssertionError(f"evaluate_flow launches {launches} for {pairs} pairs")
    rec = dict(result=result, flow_error_stats=mine, pairs=pairs, tiles_per_pair=SERVE_TILES,
               restored_bit_for_bit=True, launches=launches,
               k1_launches_per_pair=launches["K1"] / pairs, script_s=seconds,
               seconds=time.perf_counter() - t0)
    print(f"[evaluate flow] 436x1024 from the checkpoint: {json.dumps(rec)}", flush=True)
    return rec


def phase_cls_files(tmp):
    """The 1x1-conv classifier (d = 512) trained from an image folder: 2
    classes x 12 images of 224x224 (8 trained, 16 held out at batch 8), 5
    steps with async checkpoints every 2 and at the end, resumed from step
    2 as in phase 25 (_resume_check); a synchronous save timed apart; then
    examples/evaluate_classification.py from the final checkpoint."""
    from perceiverio_pytorch_tpu_torch import PrepType
    from perceiverio_pytorch_tpu_torch.examples import (
        evaluate_classification,
        train_classification,
    )
    from perceiverio_pytorch_tpu_torch.tools import make_synthetic_data
    from perceiverio_pytorch_tpu_torch.training import (
        ImageFolderDataset,
        Subset,
        save_train_state,
    )

    import torch

    t0 = time.perf_counter()
    root = os.path.join(tmp, "data")
    make_synthetic_data.make_gratings(root, "cls", n_classes=FILE_CLS_CLASSES, amplitude=40,
                                      noise=48,
                                      per_split={"train": FILE_CLS_IMAGES}, splits=("train",))
    data = os.path.join(root, "cls", "train")
    tree_s = time.perf_counter() - t0
    full = ImageFolderDataset(data, image_size=(224, 224))
    decode_ms = _decode_ms(Subset(full, range(len(full) - 2 * CLS_TRAIN_BATCH)),
                           CLS_TRAIN_BATCH)
    prep = PrepType.LEARNED_POS_1X1CONV

    def setup(seed, checkpoint_dir, prefetch):
        return train_classification.setup(
            FILE_CLS_STEPS, batch_size=CLS_TRAIN_BATCH, full_scale=True, prep_type=prep,
            device="cuda", log_every=1,
            metrics_path=_metrics_path(f"chip_smoke_cls_files_{seed}.jsonl"), data_dir=data,
            checkpoint_dir=checkpoint_dir, checkpoint_every=FILE_CLS_EVERY,
            checkpoint_async=True, prefetch=prefetch, seed=seed)

    rec, state, latest = _resume_check(
        "cls", setup, FILE_CLS_STEPS, FILE_CLS_EVERY, CLS_STEP_LAUNCHES,
        _cls_eval_launches, tmp)
    rec.update(_prefetch_windows(setup, CLS_STEP_LAUNCHES))
    rec.update(async_steps=_stalls(rec, rec["median_step_s_prefetch2"]))
    torch.cuda.synchronize()
    t = time.perf_counter()
    save_train_state(os.path.join(tmp, "cls_sync"), state)
    sync_s = time.perf_counter() - t
    del state
    torch.cuda.empty_cache()
    _reset_launch_counts()
    t = time.perf_counter()
    result = evaluate_classification.main(data_dir=data, checkpoint=latest,
                                          batch_size=CLS_TRAIN_BATCH, full_scale=True,
                                          prep_type=prep, device="cuda")
    eval_s = time.perf_counter() - t
    launches = _launch_counts()
    n_batches = len(full) // CLS_TRAIN_BATCH
    if result["images"] != n_batches * CLS_TRAIN_BATCH or not 0 <= result["top1"] <= 1:
        raise AssertionError(f"evaluate_classification {result}")
    if launches != _cls_eval_launches(n_batches):
        raise AssertionError(f"evaluate_classification launches {launches}")
    rec.update(images=len(full), classes=FILE_CLS_CLASSES, batch=CLS_TRAIN_BATCH, tree_s=tree_s,
               decode_ms_per_batch=decode_ms, sync_save_s=[sync_s],
               async_save_s=[s["seconds"] for s in rec["saves_a"] + rec["saves_b"]],
               evaluate=dict(result=result, launches=launches, seconds=eval_s),
               seconds=time.perf_counter() - t0)
    print(f"[cls files] bf16 1x1-conv, train_classification --data-dir, resume, evaluate: "
          f"{json.dumps(rec)}", flush=True)
    return rec


def phase_evaluate_multimodal(tmp):
    """examples/evaluate_multimodal.py over the port's synthetic clips, from
    a seeded published model written as a reference .pth and converted by
    convert.py into a weights directory: the two runs (directory, .pth)
    print the same numbers, the first clip's outputs equal the in-memory
    model's on the same decoded arrays bit for bit, K1 once a clip."""
    import torch

    from perceiverio_pytorch_tpu_torch import PERFORMANCE, convert
    from perceiverio_pytorch_tpu_torch.examples import evaluate_multimodal as em
    from perceiverio_pytorch_tpu_torch.tools import make_synthetic_data

    t0 = time.perf_counter()
    root = os.path.join(tmp, "clips")
    make_synthetic_data.make_clips(root, per_class={"val": MM_EVAL_CLIPS // 9})
    data = os.path.join(root, "kinetics_synth", "val")
    tree_s = time.perf_counter() - t0
    model = _mm_model(PERFORMANCE)
    pth = os.path.join(tmp, "video_autoencoding_checkpoint.pth")
    torch.save({"model_state_dict": model.state_dict()}, pth)
    ckpt = os.path.join(tmp, "mm_weights")
    t = time.perf_counter()
    convert.main([pth, ckpt, "--family", "multimodal"])
    convert_s = time.perf_counter() - t

    runs, first = {}, {}
    build = em.build_model

    def recording_build(*args, **kwargs):
        built = build(*args, **kwargs)

        def keep_first(module, inputs, out):
            if not first:
                first.update(inputs=[x.clone() for x in inputs],
                             out={k: v.clone() for k, v in out.items()})

        built.register_forward_hook(keep_first)
        return built

    for source, kw in (("checkpoint", dict(checkpoint=ckpt)),
                       ("torch_checkpoint", dict(torch_checkpoint=pth))):
        first.clear()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_launch_counts()
        t = time.perf_counter()
        with mock.patch.object(em, "build_model", recording_build):
            result = em.main(data, limit=MM_EVAL_CLIPS, device="cuda", **kw)
        runs[source] = dict(result=result, seconds=time.perf_counter() - t,
                            launches=_launch_counts(),
                            peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
        # The first clip through the model in memory, on the arrays the
        # script decoded and passed.
        with torch.inference_mode():
            want = model(*first["inputs"], n_chunks=16)
        differ = [k for k in want if not torch.equal(want[k], first["out"][k])]
        if differ:
            raise AssertionError(f"evaluate_multimodal ({source}): the first clip's {differ}"
                                 " differ from the in-memory model's")
    a, b = (dict(r["result"]) for r in runs.values())
    a.pop("clips_per_sec", None)
    b.pop("clips_per_sec", None)
    if a != b:
        raise AssertionError(f"evaluate_multimodal: --checkpoint {a} vs --torch-checkpoint {b}")
    for source, run in runs.items():
        res, launches = run["result"], run["launches"]
        if (res["clips"], res.get("labeled_clips")) != (MM_EVAL_CLIPS, MM_EVAL_CLIPS) or not (
                math.isfinite(res["video_psnr"]) and math.isfinite(res["audio_psnr"])
                and 0 <= res["top1"] <= res["top5"] <= 1):
            raise AssertionError(f"evaluate_multimodal ({source}): {res}")
        if launches != dict(NO_LAUNCHES, K1=MM_EVAL_CLIPS, merge=MM_EVAL_CLIPS):
            raise AssertionError(f"evaluate_multimodal ({source}): launches {launches} for "
                                 f"{MM_EVAL_CLIPS} clips")
    rec = dict(clips_written=MM_EVAL_CLIPS, clips=MM_EVAL_CLIPS, n_chunks=16, tree_s=tree_s,
               pth_bytes=os.path.getsize(pth), convert_s=convert_s,
               first_clip_bit_for_bit=True, runs=runs,
               k1_launches_per_clip=runs["checkpoint"]["launches"]["K1"] / MM_EVAL_CLIPS,
               seconds=time.perf_counter() - t0)
    print(f"[evaluate multimodal] bf16 16x224x224 clips, convert.py .pth -> directory: "
          f"{json.dumps(rec)}", flush=True)
    return rec


def phase_lora(lm_train, tmp):
    """examples/train_mlm.py --full-scale --lora 8 (bf16, batch 8): one
    warm-up step and LORA_STEPS timed ones through the Trainer; the printed
    adapter count against the projections' shapes, the frozen base bit for
    bit, merge_lora's state_dict strictly into a fresh model, its loss
    against the wrapped model's.  Writes the merged weights for phase 30."""
    import contextlib
    import io

    import torch

    from perceiverio_pytorch_tpu_torch import PERFORMANCE, LanguagePerceiver
    from perceiverio_pytorch_tpu_torch.examples import train_mlm
    from perceiverio_pytorch_tpu_torch.training import lora, merge_lora, save_variables

    total = 1 + LORA_STEPS
    metrics = _metrics_path("chip_smoke_lora_metrics.jsonl")
    recorded = {}

    def recording_wrap(loss_fn, base, **kwargs):
        recorded["base"] = base
        return lora.wrap_loss(loss_fn, base, **kwargs)

    printed = io.StringIO()
    with mock.patch.object(train_mlm, "wrap_loss", recording_wrap), \
            contextlib.redirect_stdout(printed):
        trainer, state, batches, eval_batches = train_mlm.setup(
            total, full_scale=True, device="cuda", metrics_path=metrics, log_every=1,
            lora_rank=LORA_RANK)
    print(printed.getvalue(), end="", flush=True)
    base = recorded["base"]
    want = sum(LORA_RANK * (m.in_features + m.out_features) for name, m in base.named_modules()
               if isinstance(m, torch.nn.Linear) and name.rsplit(".", 1)[-1] in LORA_TARGETS)
    line = next(x for x in printed.getvalue().splitlines() if x.startswith("LoRA rank"))
    count = int(line.split("training ")[1].split(" adapter")[0].replace(",", ""))
    n_adapters = sum(p.numel() for p in state.model.parameters())
    if not count == n_adapters == want:
        raise AssertionError(f"adapter parameters: printed {count}, module {n_adapters}, "
                             f"projections {want}")
    base_before = {k: v.detach().clone() for k, v in base.state_dict().items()}
    if any(p.requires_grad for p in base.parameters()):
        raise AssertionError("the base model has trainable parameters")
    rec = _train_steps(trainer, state, batches, total, metrics, NO_LAUNCHES, eval_batches)
    changed = [k for k, v in base.state_dict().items() if not torch.equal(v, base_before[k])]
    if changed:
        raise AssertionError(f"LoRA training changed base weights: {changed[:5]}")
    merged = merge_lora(base.state_dict(), state.model)
    fresh = LanguagePerceiver(policy=PERFORMANCE, device="cuda",
                              generator=torch.Generator().manual_seed(SEED + 20))
    fresh.load_state_dict(merged, strict=True)
    fresh.eval()
    state.model.eval()
    batch = eval_batches[0]
    with torch.no_grad():
        loss_merged = train_mlm.loss_fn(fresh, *batch).item()
        loss_wrapped = trainer.eval_fn(state.model, *batch).item()
    if not (math.isfinite(loss_merged)
            and abs(loss_merged - loss_wrapped) <= LORA_MERGE_TOL * abs(loss_wrapped)):
        raise AssertionError(f"merged model's loss {loss_merged}, wrapped {loss_wrapped}")
    weights = os.path.join(tmp, "mlm_lora_merged")
    save_variables(weights, merged)
    rec.update(rank=LORA_RANK, adapter_params=n_adapters, base_params=sum(
        p.numel() for p in base.parameters()), base_bit_for_bit=True,
        loss_merged=loss_merged, loss_wrapped=loss_wrapped,
        merged_bitwise=loss_merged == loss_wrapped, merge_tolerance=LORA_MERGE_TOL,
        full_fine_tune=dict(median_step_s=lm_train["median_step_s"],
                            peak_mem_gb=lm_train["peak_mem_gb"]))
    print(f"[lora] bf16 full-width MLM, rank {LORA_RANK}, batch 8: {json.dumps(rec)}",
          flush=True)
    del trainer, state, base, fresh, merged
    torch.cuda.empty_cache()
    return rec, weights


def phase_evaluate_mlm(tmp, weights):
    """examples/evaluate_mlm.py --full-scale --checkpoint (phase 29's merged
    weights) over the port's synthetic text, in MLM_EVAL_ORDER: the masked
    rows' logits of the first partial run against the first full run's rows
    at the same positions, relative to the largest logit (LM_ROWS_TOL, as
    phase 15); the same sequences and masked tokens in every run, accuracy
    and cross-entropy within MLM_EVAL_TOL; where bf16 misses, the gap is
    reported and the two decodes are held in fp32."""
    import torch

    from perceiverio_pytorch_tpu_torch import LanguagePerceiver
    from perceiverio_pytorch_tpu_torch.config import Policy
    from perceiverio_pytorch_tpu_torch.examples import evaluate_mlm
    from perceiverio_pytorch_tpu_torch.tools import make_synthetic_data

    make_synthetic_data.make_text(tmp)
    text = os.path.join(tmp, "text", "corpus_train.txt")

    def both(label):
        runs, rows = [], {}
        for decode in MLM_EVAL_ORDER:
            partial = decode == "partial"
            keep = decode not in rows
            calls = rows.setdefault(decode, dict(positions=[], rows=[], max_abs=[]))

            def recording(*args, **kwargs):
                model = LanguagePerceiver(*args, **kwargs)

                def hook(module, args, kwargs, out):
                    # the full decode's rows at the positions of the partial
                    # run's call of the same index (one seeded draw a batch)
                    if not keep:
                        return
                    if partial:
                        calls["positions"].append(kwargs["predict_positions"].clone())
                        calls["rows"].append(out.clone())
                    else:
                        where = rows["partial"]["positions"][len(calls["rows"])]
                        calls["rows"].append(out[:, where].clone())
                        calls["max_abs"].append(out.abs().amax())

                model.register_forward_hook(hook, with_kwargs=True)
                return model

            _reset_launch_counts()
            torch.cuda.synchronize()
            t = time.perf_counter()
            with mock.patch.object(evaluate_mlm, "LanguagePerceiver", recording):
                result = evaluate_mlm.main(text_file=text, checkpoint=weights, full_scale=True,
                                           limit=MLM_EVAL_LIMIT, partial_decode=partial,
                                           device="cuda")
            run = dict(decode=decode, result=result, seconds=time.perf_counter() - t,
                       launches=_launch_counts())
            if any(run["launches"].values()):
                raise AssertionError(f"evaluate_mlm launched a kernel: {run}")
            runs.append(run)
        p, f = (rows[d]["rows"] for d in ("partial", "full"))
        if len(p) != len(f) or len(p) != MLM_EVAL_LIMIT // 8:
            raise AssertionError(f"evaluate_mlm {label}: {len(p)} partial, {len(f)} full calls")
        diff = max((a - b).abs().max().item() for a, b in zip(p, f))
        scale = torch.stack(rows["full"]["max_abs"]).max().item()
        bitwise = all(torch.equal(a, b) for a, b in zip(p, f))
        del rows, p, f
        if not diff <= LM_ROWS_TOL[label] * scale:
            raise AssertionError(f"evaluate_mlm {label}: predict_positions rows {diff} off the"
                                 f" full decode's (max {scale})")
        first = runs[0]["result"]
        for run in runs:
            r = run["result"]
            if (r["sequences"], r["masked_tokens"]) != (first["sequences"],
                                                        first["masked_tokens"]) or (
                    r["sequences"] != MLM_EVAL_LIMIT or not math.isfinite(r["masked_ce"])):
                raise AssertionError(f"evaluate_mlm {label}: {[x['result'] for x in runs]}")
        gaps = {k: max(abs(a["result"][k] - b["result"][k]) for a in runs for b in runs)
                for k in MLM_EVAL_TOL}
        return dict(runs=runs, rows_max_abs_diff=diff, max_abs_logit=scale,
                    rows_bitwise=bitwise, rows_tolerance=LM_ROWS_TOL[label], gaps=gaps,
                    seq_per_sec={d: [r["result"]["seq_per_sec"] for r in runs
                                     if r["decode"] == d] for d in ("partial", "full")},
                    within=all(gaps[k] <= MLM_EVAL_TOL[k] for k in MLM_EVAL_TOL))

    rec = dict(bf16=both("bf16"), tolerance=MLM_EVAL_TOL)
    if not rec["bf16"]["within"]:
        with mock.patch.object(evaluate_mlm, "PERFORMANCE", Policy()):
            rec["fp32"] = both("fp32")
        if not rec["fp32"]["within"]:
            raise AssertionError(f"evaluate_mlm fp32: partial vs full gaps {rec['fp32']['gaps']}")
    print(f"[evaluate mlm] full width, 2048 bytes, merged LoRA weights: {json.dumps(rec)}",
          flush=True)
    return rec


def phase_ema(train, tmp):
    """The published flow model (bf16, remat, batch 1, synthetic pairs)
    through Trainer(ema_decay=EMA_DECAY, lr_schedule=..., checkpoint_dir=...)
    for one warm-up step and EMA_STEPS more, one step a fit() call: the EMA
    against a recursion computed here from each step's parameters, bit for
    bit; launches as phase 8; evaluate() on the EMA by default; the final
    checkpoint's restore_eval_variables gives the EMA; the logged lr equal
    the schedule's."""
    import torch

    from perceiverio_pytorch_tpu_torch import PERFORMANCE, FlowPerceiver
    from perceiverio_pytorch_tpu_torch.examples import train_flow
    from perceiverio_pytorch_tpu_torch.training import (
        Trainer,
        latest_checkpoint,
        restore_eval_variables,
    )

    total = 1 + EMA_STEPS
    metrics = _metrics_path("chip_smoke_ema_metrics.jsonl")
    ck = os.path.join(tmp, "flow_ema")
    example, state, batches, _ = train_flow.setup(total, full_scale=True, device="cuda")
    schedule = example.tx.schedule
    trainer = Trainer(example.loss_fn, example.tx, metrics_path=metrics, log_every=1,
                      eval_fn=example.loss_fn, checkpoint_dir=ck, checkpoint_every=total,
                      ema_decay=EMA_DECAY, lr_schedule=schedule)
    state = trainer.init_state(state.model)
    params = dict(state.model.named_parameters())
    hand = {n: p.detach().clone() for n, p in params.items()}
    if set(state.ema_params) != set(params) or any(
            not torch.equal(state.ema_params[n], hand[n]) for n in params):
        raise AssertionError("the EMA does not start as a copy of the parameters")
    steps = []
    for n in range(1, total + 1):
        if n == 2:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        _reset_launch_counts()
        t = time.perf_counter()
        state = trainer.fit(state, batches, num_steps=n)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t
        launches = _launch_counts()
        if state.step != n or launches != STEP_LAUNCHES:
            raise AssertionError(f"EMA step {state.step}: launches {launches}, expected "
                                 f"{STEP_LAUNCHES}")
        with torch.no_grad():
            for name, p in params.items():
                hand[name] = hand[name].mul(EMA_DECAY).add(p.detach().mul(1.0 - EMA_DECAY))
        differ = [k for k in hand if not torch.equal(hand[k], state.ema_params[k])]
        if differ:
            worst = max((hand[k] - state.ema_params[k]).abs().max().item() for k in differ)
            raise AssertionError(f"step {n}: the EMA differs from the recursion at "
                                 f"{len(differ)} tensors, by up to {worst}")
        with open(metrics) as f:
            logged = [x for x in map(json.loads, f) if "loss" in x][-1]
        if logged["step"] != n or logged["lr"] != round(schedule(n - 1), 8) or not (
                math.isfinite(logged["loss"])):
            raise AssertionError(f"step {n}: logged {logged}, schedule {schedule(n - 1)}")
        steps.append(dict(step=n, seconds=seconds, logged_s=logged["elapsed_sec"],
                          loss=logged["loss"], lr=logged["lr"], launches=launches))
    peak_mem = torch.cuda.max_memory_allocated() / 1e9
    moved = max((state.ema_params[k] - p.detach()).abs().max().item()
                for k, p in params.items() if p.numel())
    if not moved > 0:
        raise AssertionError("the EMA equals the live parameters after the steps")
    batch = next(iter(batches(0)))
    ran_on = []
    hook = state.model.register_forward_pre_hook(lambda m, args: ran_on.append(all(
        p.data_ptr() == state.ema_params[k].data_ptr() for k, p in params.items())))
    _reset_launch_counts()
    default = trainer.evaluate(state, [batch])
    with_ema = trainer.evaluate(state, [batch], use_ema=True)
    live = trainer.evaluate(state, [batch], use_ema=False)
    hook.remove()
    if ran_on != [True, True, False] or default != with_ema:
        raise AssertionError(f"evaluate(): on the EMA weights {ran_on}; default {default}, "
                             f"EMA {with_ema}, live {live}")
    if _launch_counts()["K1"] != 3 * 26:
        raise AssertionError(f"evaluations launched {_launch_counts()}")
    latest = latest_checkpoint(ck)
    fresh = FlowPerceiver(policy=PERFORMANCE, remat=True, device="cuda",
                          generator=torch.Generator().manual_seed(SEED + 30))
    restore_eval_variables(fresh, checkpoint=latest)
    differ = [n for n, p in fresh.named_parameters()
              if not torch.equal(p, state.ema_params[n])]
    if differ or not latest.endswith(f"step_{total:08d}"):
        raise AssertionError(f"restore_eval_variables({latest}): not the EMA at {differ[:5]}")
    timed = [s["logged_s"] for s in steps[1:]]
    rec = dict(decay=EMA_DECAY, steps=steps, ema_bit_for_bit=True,
               ema_vs_live_max_abs=moved, eval_default=default, eval_ema=with_ema,
               eval_live=live, restored_ema_bit_for_bit=True, lr_logged=True,
               peak_mem_gb=peak_mem, median_logged_step_s=_median(timed),
               phase8_median_logged_step_s=_median(train["logged_step_s"]),
               phase8_median_step_s=train["median_step_s"],
               launches_per_step=[s["launches"] for s in steps],
               launches={k: sum(s["launches"][k] for s in steps) for k in STEP_LAUNCHES})
    print(f"[ema] bf16 full-width flow, remat, batch 1, decay {EMA_DECAY}: {json.dumps(rec)}",
          flush=True)
    del trainer, state, fresh
    torch.cuda.empty_cache()
    return rec


def _bitwise(label, grads, want):
    """Every gradient of ``grads`` against ``want``'s, bit for bit; raises
    with the largest difference and its parameter."""
    import torch

    if set(grads) != set(want) or len(want) < 100:
        raise AssertionError(f"{label}: the two runs give gradients to different parameters")
    differ = [n for n in want if not torch.equal(grads[n], want[n])]
    if differ:
        worst, where = max(((grads[n].float() - want[n].float()).abs().max().item(), n)
                           for n in differ)
        raise AssertionError(f"{label}: {len(differ)} gradients differ, the largest by "
                             f"{worst} at {where}")


def _policy_step(label, model, loss_fn, expected_launches):
    """One warm-up step, then one step of ``model`` timed (host clock ending
    in a synchronize), its launches counted and its peak memory read from a
    reset; returns the record and the step's gradients."""
    import torch

    def step():
        model.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = loss_fn(model)
        loss.backward()
        torch.cuda.synchronize()
        return loss.item(), time.perf_counter() - t0

    first_s = step()[1]
    model.zero_grad(set_to_none=True)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _reset_launch_counts()
    loss, seconds = step()
    launches = _launch_counts()
    peak = torch.cuda.max_memory_allocated()
    if launches != expected_launches or not math.isfinite(loss):
        raise AssertionError(f"{label}: launches {launches}, expected {expected_launches};"
                             f" loss {loss}")
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()
             if p.grad is not None}
    return dict(loss=loss, step_s=seconds, first_step_s=first_s, launches=launches,
                peak_mem_gb=peak / 1e9, step_mem_gb=(peak - before) / 1e9), grads


def _policy_pair(label, build, loss_fn, expected_launches):
    """The same step under SAC_POLICY and under full remat, on models built
    alike (the same seeded weights): gradients bit for bit, launches, step
    time and peak memory of each."""
    import torch

    recs, grads = {}, {}
    for name in (SAC_POLICY, FULL_REMAT):
        model = build(name)
        recs[name], grads[name] = _policy_step(f"{label} {name}", model, loss_fn,
                                               expected_launches)
        del model
        torch.cuda.empty_cache()
    _bitwise(f"{label}: {SAC_POLICY} against full remat", grads[SAC_POLICY],
             grads[FULL_REMAT])
    rec = dict(recs, gradients_bit_for_bit=True, params=len(grads[FULL_REMAT]),
               peak_mem_gb_delta=recs[SAC_POLICY]["peak_mem_gb"]
               - recs[FULL_REMAT]["peak_mem_gb"],
               step_s_ratio=recs[SAC_POLICY]["step_s"] / recs[FULL_REMAT]["step_s"])
    print(f"[{label}] {SAC_POLICY} against full remat: {json.dumps(rec)}", flush=True)
    return rec


def phase_mm_sac():
    """A: the published Kinetics autoencoder (bf16 PERFORMANCE, remat, 16
    decoder chunks, batch 1, one synthetic clip with a label) under
    dots_saveable against full remat: one step's gradients bit for bit (the
    same kernels on the same operands: the saved products are the ones full
    remat recomputes), K1, K2 and K3 once a step each (the encoder's
    cross-attend is outside both regions), step time and peak memory."""
    import torch

    from perceiverio_pytorch_tpu_torch import PERFORMANCE
    from perceiverio_pytorch_tpu_torch.examples.train_multimodal import WEIGHTS
    from perceiverio_pytorch_tpu_torch.training import multimodal_autoencode_loss

    images, audio = _smooth_clip(torch.Generator().manual_seed(SEED + 7))
    targets = {"image": images, "audio": audio,
               "label": torch.tensor([MM_LABEL], device="cuda")}

    def build(name):
        return _mm_model(dataclasses.replace(PERFORMANCE, remat_policy=name),
                         remat=True).train()

    def loss_fn(model):
        out = model(images, audio, n_chunks=MM_TRAIN_CHUNKS)
        return multimodal_autoencode_loss(out, targets, weights=WEIGHTS)

    return _policy_pair("A mm sac", build, loss_fn, MM_STEP_LAUNCHES)


def phase_flow_sac():
    """B: the published flow model (bf16 PERFORMANCE, remat, batch 1, one
    synthetic roll pair) under dots_saveable against full remat: gradients
    bit for bit, and K1 50 times a step under both (26 forward, 24
    recomputed: the policy keeps products, not the flash op's output, as JAX
    recomputes a pallas_call), K2 and K3 26."""
    import torch

    from perceiverio_pytorch_tpu_torch import PERFORMANCE
    from perceiverio_pytorch_tpu_torch.examples.train_flow import synthetic_flow_pairs
    from perceiverio_pytorch_tpu_torch.training import flow_endpoint_error

    img1, img2, flow = (torch.from_numpy(a).cuda()
                        for a in synthetic_flow_pairs(1, (368, 496), seed=SEED + 4))

    def build(name):
        return _flow_model(dataclasses.replace(PERFORMANCE, remat_policy=name),
                           remat=True).train()

    def loss_fn(model):
        return flow_endpoint_error(model(img1, img2), flow)

    return _policy_pair("B flow sac", build, loss_fn, STEP_LAUNCHES)


def _opt_state_bytes(opt):
    return sum(t.numel() * t.element_size() for entry in opt.state.values()
               for t in entry.values() if hasattr(t, "element_size"))


def _snapshot_state(state):
    params = {n: p.detach().clone() for n, p in state.model.named_parameters()}
    opt = {id(p): {k: v.clone() for k, v in entry.items()}
           for p, entry in state.optimizer.state.items()}
    return params, opt, dict(state.optimizer.chain)


def _unchanged(label, state, snapshot, names=None):
    """Parameters (all, or ``names``) and, without ``names``, the optimizer
    state and counts equal ``snapshot`` bit for bit."""
    import torch

    params, opt, chain = snapshot
    live = dict(state.model.named_parameters())
    moved = [n for n in (names or params) if not torch.equal(live[n], params[n])]
    if moved:
        raise AssertionError(f"{label}: {len(moved)} parameters moved, e.g. {moved[:3]}")
    if names is None:
        now = {id(p): e for p, e in state.optimizer.state.items()}
        if set(now) != set(opt) or any(not torch.equal(now[i][k], v)
                                       for i, e in opt.items() for k, v in e.items()):
            raise AssertionError(f"{label}: the optimizer state changed")
        if state.optimizer.chain["count"] != chain["count"]:
            raise AssertionError(f"{label}: the count moved {chain} -> "
                                 f"{state.optimizer.chain}")


def phase_optimizers():
    """C: the published MLM (201,108,230 parameters, bf16, batch 8) through
    build_optimizer's variants, each from the same initial weights for one
    step and OPT_STEPS more (constant lr, clip 1.0): Adafactor, Lion, SGD
    (momentum 0.9), accum_steps=2, skip_nonfinite_updates=2 and the
    trainable mask with only the decoder trainable, beside AdamW.  Held: a
    NaN gradient leaves parameters, moments and the count bit for bit while
    the step counter moves; the non-boundary micro-steps leave the
    parameters bit for bit; frozen weights stay bit for bit; Adafactor's
    state is smaller than AdamW's.  Measured: each variant's step time and
    state bytes, and the skip's host read of its finiteness flag."""
    import torch

    from perceiverio_pytorch_tpu_torch.examples import train_mlm
    from perceiverio_pytorch_tpu_torch.training import Trainer, build_optimizer

    total = 1 + OPT_STEPS
    _, state0, batches, _ = train_mlm.setup(
        total, full_scale=True, device="cuda",
        metrics_path=_metrics_path("chip_smoke_opt_setup.jsonl"))
    model = state0.model
    del state0
    initial = {k: v.clone() for k, v in model.state_dict().items()}
    names = [n for n, _ in model.named_parameters()]
    decoder = {n: n.startswith("perceiver._decoder.") for n in names}
    kwargs = {"adamw": {}, "adafactor": dict(optimizer="adafactor"),
              "lion": dict(optimizer="lion"), "sgd": dict(optimizer="sgd", momentum=0.9),
              "accum": dict(accum_steps=2), "skip": dict(skip_nonfinite_updates=2),
              "trainable": dict(trainable_mask=lambda m: decoder)}
    poison = {"on": False}

    def loss_fn(m, *batch):
        loss = train_mlm.loss_fn(m, *batch)
        return loss * float("nan") if poison["on"] else loss

    recs = {}
    for name in OPT_VARIANTS:
        model.load_state_dict(initial)
        trainer = Trainer(loss_fn, build_optimizer(OPT_LR, clip_norm=1.0, **kwargs[name]),
                          log_every=0, metrics_path=_metrics_path(f"chip_smoke_opt_{name}.jsonl"))
        state = trainer.init_state(model)
        steps, checks = [], []
        for n in range(1, total + 1):
            poison["on"] = name == "skip" and n == OPT_NAN_STEP
            quiet = poison["on"] or (name == "accum" and n % 2)
            snapshot = _snapshot_state(state) if quiet else None
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state = trainer.fit(state, batches, num_steps=n)
            torch.cuda.synchronize()
            steps.append(time.perf_counter() - t0)
            if state.step != n:
                raise AssertionError(f"{name}: step {state.step} after fit to {n}")
            if quiet:
                _unchanged(f"{name} step {n}", state, snapshot,
                           names=None if poison["on"] else names)
                checks.append(f"step {n} unchanged bit for bit")
        poison["on"] = False
        params = dict(model.named_parameters())
        frozen = [n for n in names if not decoder[n]] if name == "trainable" else []
        if frozen:
            moved = [n for n in frozen if not torch.equal(params[n], initial[n])]
            if moved:
                raise AssertionError(f"trainable: frozen weights moved: {moved[:3]}")
            checks.append(f"{len(frozen)} frozen weights bit for bit")
        trained = [n for n in names if name != "trainable" or decoder[n]]
        if not any(not torch.equal(params[n], initial[n]) for n in trained) or not all(
                torch.isfinite(params[n]).all() for n in trained):
            raise AssertionError(f"{name}: the trained weights did not move, or not finite")
        chain = dict(state.optimizer.chain)
        rec = dict(step_s=steps[1:], median_step_s=_median(steps[1:]), first_step_s=steps[0],
                   state_bytes=_opt_state_bytes(state.optimizer), chain=chain, checks=checks)
        if name == "skip":
            if chain["total_notfinite"] != 1 or chain["count"] != total - 1:
                raise AssertionError(f"skip: counts {chain}")
            rec["poisoned_step_s"] = steps[OPT_NAN_STEP - 1]
            opt = state.optimizer
            opt.grads_finite()  # the same read the step takes, grads left by the last step
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(FINITE_READS):
                opt.grads_finite()
            rec["finite_read_ms"] = (time.perf_counter() - t0) / FINITE_READS * 1e3
        recs[name] = rec
        print(f"[C optimizer {name}] {json.dumps(rec)}", flush=True)
        del trainer, state
        torch.cuda.empty_cache()
    if not recs["adafactor"]["state_bytes"] < recs["adamw"]["state_bytes"]:
        raise AssertionError("Adafactor's state is not smaller than AdamW's")
    summary = {name: dict(median_step_s=r["median_step_s"], state_bytes=r["state_bytes"])
               for name, r in recs.items()}
    rec = dict(params=len(names), numel=sum(v.numel() for v in model.parameters()),
               variants=summary, finite_read_ms=recs["skip"]["finite_read_ms"])
    print(f"[C optimizers] MLM bf16 batch 8: {json.dumps(rec)}", flush=True)
    del model, initial
    torch.cuda.empty_cache()
    return rec


@contextlib.contextmanager
def _deterministic_algorithms():
    """torch.use_deterministic_algorithms for the block (warn_only: cuBLAS's
    GEMMs are already reproducible on one stream; the warnings are muted)."""
    import warnings

    import torch

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            yield
        finally:
            torch.use_deterministic_algorithms(False)


def _repeat_differs(loss_fn, model, batch):
    """The parameters whose gradient differs between two backward passes of
    one batch from the same weights, with the default algorithms and with
    deterministic ones, and the largest difference of each."""
    import torch

    def grads():
        model.zero_grad(set_to_none=True)
        loss_fn(model, *batch).backward()
        torch.cuda.synchronize()
        return {n: p.grad.detach().clone() for n, p in model.named_parameters()
                if p.grad is not None}

    out = {}
    for mode in ("default", "deterministic_algorithms"):
        with (_deterministic_algorithms() if mode != "default" else contextlib.nullcontext()):
            first, second = grads(), grads()
        out[mode] = {n: (first[n].float() - second[n].float()).abs().max().item()
                     for n in first if not torch.equal(first[n], second[n])}
    model.zero_grad(set_to_none=True)
    return out


def phase_steps_per_call():
    """D: train_mlm --full-scale --steps-per-call SPC for SPC_STEPS steps
    against --steps-per-call 1 (each from the same seeded weights and
    batches): every step's loss and the final weights bit for bit, the log
    and evaluation lines at the same steps; the seconds of each run, the
    evaluations timed apart.  Both run under deterministic algorithms: the
    token table's gradient (nn.Embedding's backward) is not reproducible
    otherwise, between two backward passes of one batch, which the phase
    measures first."""
    import torch

    from perceiverio_pytorch_tpu_torch.examples import train_mlm

    runs, repeats = {}, None
    for k in (1, SPC):
        metrics = _metrics_path(f"chip_smoke_spc{k}.jsonl")
        trainer, state, batches, eval_batches = train_mlm.setup(
            SPC_STEPS, full_scale=True, device="cuda", metrics_path=metrics, log_every=SPC,
            steps_per_call=k)
        if repeats is None:
            repeats = _repeat_differs(trainer.loss_fn, state.model.train(),
                                      next(iter(batches(0))))
        losses, eval_s = [], []
        inner, evaluate = trainer.loss_fn, trainer.evaluate

        def recorded(m, *batch, inner=inner, losses=losses):
            loss = inner(m, *batch)
            losses.append(loss.detach())
            return loss

        def timed_evaluate(*args, evaluate=evaluate, eval_s=eval_s, **kwargs):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = evaluate(*args, **kwargs)
            torch.cuda.synchronize()
            eval_s.append(time.perf_counter() - t)
            return out

        trainer.loss_fn = recorded
        with _deterministic_algorithms(), mock.patch.object(trainer, "evaluate",
                                                            timed_evaluate):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state = trainer.fit(state, batches, num_steps=SPC_STEPS, eval_batches=eval_batches)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0 - sum(eval_s)
        with open(metrics) as f:
            lines = [json.loads(x) for x in f]
        runs[k] = dict(step=state.step, losses=[float(x) for x in losses],
                       log_steps=[x["step"] for x in lines if "loss" in x],
                       eval_steps=[x["step"] for x in lines if "eval_loss" in x],
                       seconds=seconds, step_s=seconds / state.step,
                       weights={n: p.detach().clone() for n, p in state.model.named_parameters()})
        del trainer, state
        torch.cuda.empty_cache()
    if repeats["deterministic_algorithms"]:
        raise AssertionError(f"two backward passes differ under deterministic algorithms: "
                             f"{repeats}")
    one, many = runs[1], runs[SPC]
    for key in ("step", "losses", "log_steps", "eval_steps"):
        if one[key] != many[key]:
            raise AssertionError(f"steps_per_call {SPC} against 1: {key} {many[key]} vs "
                                 f"{one[key]}")
    _bitwise(f"steps_per_call {SPC} against 1 (final weights)", many["weights"],
             one["weights"])
    rec = {f"steps_per_call_{k}": {key: v for key, v in r.items() if key != "weights"}
           for k, r in runs.items()}
    rec.update(losses_bit_for_bit=True, weights_bit_for_bit=True,
               deterministic_algorithms=True, repeat_backward_differs=repeats,
               step_s_ratio=many["step_s"] / one["step_s"])
    print(f"[D steps_per_call] MLM bf16 batch 8: {json.dumps(rec)}", flush=True)
    return rec


def _within_sigmas(share, prob, n):
    sigma = (prob * (1.0 - prob) / n) ** 0.5
    return abs(share - prob) <= SIGMAS * sigma, sigma


def phase_dropout():
    """E: an encoder at the byte MLM's published latent widths with
    dropout_prob = dropout_attn_prob = DROPOUT in train mode, its draws from
    a CUDA torch.Generator (every site dense: no kernel launch): the kept
    share of all masks within SIGMAS sigma of 1 - DROPOUT; eval mode equal to
    the encoder without dropout, bit for bit; with remat (full and
    dots_saveable) the gradients of the encoder without remat, bit for bit,
    under one seed.  Then the Kinetics inputs' preprocessor with mask_probs
    {image, audio: MASK_PROB, label: 1}: the masked shares within SIGMAS
    sigma, the same seed the same mask."""
    import torch

    from perceiverio_pytorch_tpu_torch import PERFORMANCE
    from perceiverio_pytorch_tpu_torch.core.perceiver import (
        MultimodalPreprocessor,
        PerceiverEncoder,
    )
    from perceiverio_pytorch_tpu_torch.ops import attention_dense

    def encoder(drop, remat=False, name=None):
        return PerceiverEncoder(
            num_input_channels=768, num_self_attends_per_block=26, num_blocks=1,
            num_latents=256, num_latent_channels=1280, num_cross_attend_heads=8,
            num_self_attend_heads=8, qk_channels=256, v_channels=1280,
            policy=dataclasses.replace(PERFORMANCE, remat_policy=name), remat=remat,
            dropout_prob=drop, dropout_attn_prob=drop,
            generator=torch.Generator().manual_seed(SEED + 40)).cuda()

    inputs = torch.randn(8, 2048, 768, generator=torch.Generator().manual_seed(SEED + 41))
    inputs = inputs.cuda()

    def run(model, seed):
        gen = None if seed is None else torch.Generator(device="cuda").manual_seed(seed)
        return model(inputs, model.latents(inputs), generator=gen)

    kept, drawn = [], []
    real = attention_dense.keep_mask

    def counted(*args, **kwargs):
        mask = real(*args, **kwargs)
        kept.append(mask.sum())
        drawn.append(mask.numel())
        return mask

    model = encoder(DROPOUT).train()
    _reset_launch_counts()
    with torch.no_grad(), mock.patch.object(attention_dense, "keep_mask", counted):
        run(model, 1)
    share = float(torch.stack(kept).sum().item()) / sum(drawn)
    ok, sigma = _within_sigmas(share, 1.0 - DROPOUT, sum(drawn))
    if not ok or len(drawn) != 3 * 27:
        raise AssertionError(f"kept share {share} over {len(drawn)} masks ({sum(drawn)} draws),"
                             f" sigma {sigma}")
    with torch.no_grad():
        evaluated = run(model.eval(), None)
        plain = run(encoder(0.0).eval(), None)
    if not torch.equal(evaluated, plain):
        raise AssertionError("eval mode with dropout differs from the encoder without it")
    grads = {}
    for remat, name in ((False, None), (True, None), (True, SAC_POLICY)):
        model = encoder(DROPOUT, remat=remat, name=name).train()
        run(model, 2).float().square().mean().backward()
        grads[remat, name] = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
        del model
    for key in ((True, None), (True, SAC_POLICY)):
        _bitwise(f"dropout encoder, remat {key[1] or FULL_REMAT} against none", grads[key],
                 grads[False, None])
    if _launch_counts() != NO_LAUNCHES:
        raise AssertionError(f"a dropout site launched a kernel: {_launch_counts()}")
    del grads
    torch.cuda.empty_cache()

    mm = _mm_model(PERFORMANCE)
    pre = MultimodalPreprocessor(
        input_preprocessors=dict(mm.perceiver._multi_preprocessor._preprocessors),
        mask_probs={"image": MASK_PROB, "audio": MASK_PROB, "label": 1.0},
        min_padding_size=4).cuda()
    images, audio = _smooth_clip(torch.Generator().manual_seed(SEED + 42))
    clip = {"image": images, "audio": audio, "label": torch.zeros(1, 700, device="cuda")}
    outs = []
    with torch.no_grad():
        for seed in (3, 3, 4):
            out, sizes, _ = pre(clip, generator=torch.Generator(device="cuda").manual_seed(seed))
            outs.append(out)
    start, shares = 0, {}
    for modality in sorted(sizes):
        rows = outs[0][0, start:start + sizes[modality]]
        token = pre.mask_tokens[modality].pos_embs[0].to(rows.dtype)
        masked = (rows == token).all(-1).float().mean().item()
        shares[modality] = masked
        prob = {"label": 1.0}.get(modality, MASK_PROB)
        ok = masked == 1.0 if prob == 1.0 else _within_sigmas(masked, prob, sizes[modality])[0]
        if not ok:
            raise AssertionError(f"{modality}: masked share {masked} of {sizes[modality]}")
        start += sizes[modality]
    if not torch.equal(outs[0], outs[1]) or torch.equal(outs[0], outs[2]):
        raise AssertionError("the same seed gave another mask, or another seed the same")
    rec = dict(dropout=DROPOUT, kept_share=share, kept_sigma=sigma, masks=len(drawn),
               draws=sum(drawn), eval_bit_for_bit=True, remat_grads_bit_for_bit=True,
               mask_prob=MASK_PROB, masked_shares=shares, tokens=sizes,
               same_seed_same_mask=True)
    print(f"[E dropout and masking] {json.dumps(rec)}", flush=True)
    del mm, pre
    torch.cuda.empty_cache()
    return rec


def _quant_sites(model):
    return [m for m in model.modules() if getattr(m, "quant", None)]


def _int8_calls(model):
    """The int8 products a forward of a classifier runs, and those of them
    in the weight-shared self-attend blocks (which remat recomputes)."""
    named = [n for n, m in model.named_modules() if getattr(m, "quant", None)]
    shared = sum(".self_attends." in n for n in named)
    blocks = model.perceiver._encoder.num_blocks
    return len(named) - shared + blocks * shared, blocks * shared


def _record_shapes(model, shapes):
    """Forward pre-hooks adding each int8 projection's (M, K, N) to
    ``shapes``; returns the hooks."""
    def hook(module, args):
        x = args[0]
        shapes.add((x.numel() // x.shape[-1], module.in_features, module.out_features))

    return [m.register_forward_pre_hook(hook) for m in _quant_sites(model)]


def phase_int8_serve(smi, cls_serve):
    """G: the full-width pixel and 1x1-conv classifiers at batch 16 under
    PERFORMANCE_INT8 and PERFORMANCE_INT8_STATIC (the static one calibrated
    on two seeded batches), phase 14's weights and requests: one warm-up
    request (its projections' shapes recorded for phase F), three timed; K1
    launches a request equal to the bf16 run's, one torch._int_mm a
    projection; quant_error_report against the same model's exact bf16
    pass over the timed requests, top-1 agreement on the last."""
    import torch

    import perceiverio_pytorch_tpu_torch as port
    from perceiverio_pytorch_tpu_torch.ops import quant

    records, shapes = {}, {}
    for prep in INT8_PREPS:
        records[prep], shapes[prep] = {}, set()
        bf16 = cls_serve[prep]
        for mode, preset in INT8_MODES.items():
            t0 = time.perf_counter()
            model = _cls_model(prep, getattr(port, preset))
            sites, _ = _int8_calls(model)
            gen = torch.Generator().manual_seed(SEED + 9)  # phase 14's requests
            requests = [_cls_images(gen, CLS_SERVE_BATCH) for _ in range(CLS_REQUESTS + 1)]
            with torch.inference_mode():
                if mode == "static":
                    calib = torch.Generator().manual_seed(SEED + 40)
                    quant.calibrate(model, [(_cls_images(calib, CLS_SERVE_BATCH),)
                                            for _ in range(INT8_CALIB_BATCHES)])
                hooks = _record_shapes(model, shapes[prep])
                model(requests[0])  # warm-up
                for hook in hooks:
                    hook.remove()
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                _reset_launch_counts()
                quant.LAUNCHES = 0
                latencies = []
                t_all = time.perf_counter()
                for img in requests[1:]:
                    t1 = time.perf_counter()
                    logits = model(img)
                    torch.cuda.synchronize()
                    latencies.append(time.perf_counter() - t1)
                total = time.perf_counter() - t_all
                launches, gemms = _launch_counts(), quant.LAUNCHES
                peak_mem = torch.cuda.max_memory_allocated()
                report = quant.quant_error_report(model, [(img,) for img in requests[1:]])
                with quant.quant_pass(model, "exact"):
                    exact = model(requests[-1])
            want = (bf16["k1_launches_per_request"] * CLS_REQUESTS, bf16["merge_launches"])
            if (launches["K1"], launches["merge"]) != want:
                raise AssertionError(f"{prep} {mode}: launches {launches}, bf16's {want}")
            if gemms != sites * CLS_REQUESTS:
                raise AssertionError(f"{prep} {mode}: {gemms} torch._int_mm calls, expected"
                                     f" {sites} a request")
            if tuple(logits.shape) != (CLS_SERVE_BATCH, 1000) or not torch.isfinite(logits).all():
                raise AssertionError(f"{prep} {mode}: int8 logits {tuple(logits.shape)}")
            rel = report["output"]["max_rel"]
            if not 0.0 < rel <= INT8_REL_BOUND[mode]:
                raise AssertionError(f"{prep} {mode}: int8 vs exact logits {rel} not in"
                                     f" (0, {INT8_REL_BOUND[mode]}]")
            top1 = (logits.float().argmax(-1) == exact.float().argmax(-1)).float().mean().item()
            rec = dict(prep=prep, mode=mode, batch=CLS_SERVE_BATCH, requests=CLS_REQUESTS,
                       projections=len(_quant_sites(model)), int_mm_per_request=sites,
                       int_mm_calls=gemms, launches=launches["K1"],
                       merge_launches=launches["merge"], latency_s=latencies,
                       images_per_s=CLS_REQUESTS * CLS_SERVE_BATCH / total,
                       bf16_images_per_s=bf16["images_per_s"], peak_mem_gb=peak_mem / 1e9,
                       bf16_peak_mem_gb=bf16["peak_mem_gb"], quant_error_report=report,
                       rel_bound=INT8_REL_BOUND[mode], top1_agreement=top1, card=smi,
                       seconds=time.perf_counter() - t0)
            print(f"[int8 serve] {json.dumps(rec)}", flush=True)
            records[prep][mode] = rec
            del model, requests, logits, exact
            torch.cuda.empty_cache()
    return records, shapes


def _int8_gemm_case(label, m, k, n, gen, smi):
    """One product shape: torch._int_mm (padded) against the plain version
    on the card, int32 bit for bit; int8_dynamic_matmul and
    int8_static_matmul on the card against the CPU's on the same rows, bit
    for bit (each output row depends on its input row alone);
    times of both, of torch._int_mm alone and of bf16 F.linear, beside the
    bounds."""
    import torch
    import torch.nn.functional as F

    from perceiverio_pytorch_tpu_torch.ops import quant

    xq = torch.randint(-127, 128, (m, k), generator=gen, device="cuda", dtype=torch.int8)
    wq = torch.randint(-127, 128, (n, k), generator=gen, device="cuda", dtype=torch.int8)
    got, want = quant.int8_gemm(xq, wq), quant.int8_gemm_reference(xq, wq)
    if got.dtype != torch.int32 or not torch.equal(got, want):
        raise AssertionError(f"{label} {(m, k, n)}: torch._int_mm differs from the plain product")
    del got, want
    x = torch.randn(m, k, generator=gen, device="cuda").bfloat16()
    w = torch.randn(n, k, generator=gen, device="cuda") / math.sqrt(k)
    amax = x.float().abs().max() * 0.9
    rows = min(m, INT8_CPU_ROWS)
    cpu = {}
    for name, fn, args in (("dynamic", quant.int8_dynamic_matmul, ()),
                           ("static", quant.int8_static_matmul, (amax,))):
        card = fn(x, w, *args)[:rows].cpu()
        ref = fn(x[:rows].cpu(), w.cpu(), *(a.cpu() for a in args))
        if not torch.equal(card, ref):
            diff = (card.float() - ref.float()).abs().max().item()
            raise AssertionError(f"{label} {(m, k, n)} {name}: card vs CPU differ by {diff}")
        cpu[name] = dict(bitwise=True)
    pad_m = 0 if m > 16 else 17
    xp = F.pad(xq, (0, -k % 8, 0, pad_m))
    wp = F.pad(wq, (0, -k % 8, 0, -n % 8))
    w16 = w.bfloat16()
    ops = 2 * m * n * k
    rec = dict(
        model=label, m=m, k=k, n=n,
        dynamic_ms=time_ms(lambda: quant.int8_dynamic_matmul(x, w), INT8_REPS),
        static_ms=time_ms(lambda: quant.int8_static_matmul(x, w, amax), INT8_REPS),
        int_mm_ms=time_ms(lambda: torch._int_mm(xp, wp.t()), INT8_REPS),
        bf16_linear_ms=time_ms(lambda: F.linear(x, w16), INT8_REPS),
        # the int8 product: int8 operands read once, the int32 result written
        int_mm_bound_ms=max(ops / PEAK_INT8_OPS, (m * k + n * k + 4 * m * n) / PEAK_BYTES) * 1e3,
        # the whole int8 matmul: bf16 x and fp32 w read, bf16 y written
        bound_ms=max(ops / PEAK_INT8_OPS, (2 * m * k + 4 * n * k + 2 * m * n) / PEAK_BYTES) * 1e3,
        bf16_bound_ms=max(ops / PEAK_FLOPS["bf16"],
                          (2 * m * k + 2 * n * k + 2 * m * n) / PEAK_BYTES) * 1e3,
        padded=dict(m=xp.shape[0], k=xp.shape[1], n=wp.shape[0]), cpu_rows=rows, cpu=cpu,
        card=smi)
    print(f"[int8 gemm] {json.dumps(rec)}", flush=True)
    return rec


def phase_int8_gemm(smi, cls_shapes):
    """F: every distinct int8 projection shape (M, K, N) of the full-width
    pixel and 1x1-conv classifiers at batch 16 (phase G's warm-up
    requests) and of the full-width MLM at batch 32 (one PERFORMANCE_INT8
    request here), each held and timed by ``_int8_gemm_case``."""
    import torch

    from perceiverio_pytorch_tpu_torch import PERFORMANCE_INT8, LanguagePerceiver

    t0 = time.perf_counter()
    model = LanguagePerceiver(policy=PERFORMANCE_INT8, device="cuda",
                              generator=torch.Generator().manual_seed(SEED)).eval()
    ids, mask = _lm_batch(SEED + 10)
    shapes = dict(cls_shapes, MLM=set())
    hooks = _record_shapes(model, shapes["MLM"])
    with torch.inference_mode():
        logits = model(ids, mask)
    for hook in hooks:
        hook.remove()
    if not torch.isfinite(logits).all():
        raise AssertionError("the int8 MLM's logits are not finite")
    del model, logits
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 41)
    records = []
    with torch.inference_mode():
        for label, found in shapes.items():
            for m, k, n in sorted(found):
                records.append(_int8_gemm_case(label, m, k, n, gen, smi))
                torch.cuda.empty_cache()
    print(f"[int8 gemm] {len(records)} shapes in {time.perf_counter() - t0:.1f} s", flush=True)
    return records


def phase_int8_export(smi, exported):
    """H: examples/serve.py build(full_scale=True, LEARNED_POS_1X1CONV,
    quant="static") and load: the graph holds K1's op once, a
    torch._int_mm a projection and no parameter; the artifact at buckets 1,
    4 and 16 against the eager int8 model on the same weights, bit for bit;
    batch-1 latency beside phase 21's bf16 artifact."""
    import torch

    from perceiverio_pytorch_tpu_torch import (
        PERFORMANCE_INT8_STATIC,
        ClassificationPerceiver,
        PrepType,
    )
    from perceiverio_pytorch_tpu_torch.examples import serve
    from perceiverio_pytorch_tpu_torch.ops import quant
    from perceiverio_pytorch_tpu_torch.training.checkpoint import restore_variables

    prep = "LEARNED_POS_1X1CONV"
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as out:
        built = serve.build(out, full_scale=True, prep_type=PrepType[prep], device="cuda",
                            quant="static")
        t1 = time.perf_counter()
        call = serve.load(out, device="cuda")
        built["load_s"] = time.perf_counter() - t1
        weights = restore_variables(os.path.join(out, serve.WEIGHTS), device="cuda")
        with open(os.path.join(out, serve.ARTIFACT), "rb") as f:
            blob = f.read()
    model = ClassificationPerceiver(num_classes=1000, img_size=(224, 224),
                                    prep_type=PrepType[prep], policy=PERFORMANCE_INT8_STATIC,
                                    device="cuda").eval()
    sites, _ = _int8_calls(model)
    contents = _artifact_contents(blob, model, weights)
    if contents["k1_op_nodes"] != 1 or contents["int_mm_nodes"] != sites:
        raise AssertionError(f"int8 artifact: {contents['k1_op_nodes']} K1 op nodes,"
                             f" {contents['int_mm_nodes']} torch._int_mm nodes for {sites}"
                             " products a call")
    amax = [t for n, t in weights.items() if n.endswith(".amax")]
    if len(amax) != len(_quant_sites(model)) or any(t.dtype != torch.float32 or t.item() <= 0 for t in amax):
        raise AssertionError("int8 artifact's weights: amax missing, not fp32 or uncalibrated")
    gen = torch.Generator().manual_seed(SEED + 42)
    calls = []
    for b in EXPORT_BATCHES:
        img = _cls_images(gen, b)
        with torch.inference_mode():
            _reset_launch_counts()
            got = call(img)  # the graph calls aten._int_mm itself (counted above)
            torch.cuda.synchronize()
            launches = _launch_counts()
            quant.LAUNCHES = 0
            want = torch.func.functional_call(model, weights, (img,))
            gemms = quant.LAUNCHES
        expected = _expected_k1(prep, b, torch.bfloat16)
        if (launches["K1"], launches["merge"]) != expected or gemms != sites:
            raise AssertionError(f"int8 artifact at {b}: launches {launches}, eager {gemms}"
                                 f" torch._int_mm, expected {expected} and {sites}")
        if not torch.equal(got, want):
            diff = (got.float() - want.float()).abs().max().item()
            raise AssertionError(f"int8 artifact vs eager at batch {b}: {diff}")
        calls.append(dict(batch=b, launches=launches["K1"], merge_launches=launches["merge"],
                          eager_int_mm_calls=gemms, bitwise=True))
    with torch.inference_mode():
        latency = _latency(call, _cls_images(gen, 1), EXPORT_REQUESTS)
    rec = dict(prep=prep, quant="static", build=built, projections=len(amax),
               int_mm_per_call=sites,
               **contents, calls=calls, batch1=latency,
               bf16_batch1=exported["k1"]["timing"][1]["artifact"], card=smi,
               seconds=time.perf_counter() - t0)
    print(f"[int8 export] {json.dumps(rec)}", flush=True)
    del model, weights, call
    torch.cuda.empty_cache()
    return rec


def _grads(loss_fn, model, batch):
    import torch

    model.zero_grad(set_to_none=True)
    loss_fn(model, *batch).backward()
    torch.cuda.synchronize()
    return {n: p.grad.detach().clone() for n, p in model.named_parameters()
            if p.grad is not None}


def phase_int8_train(smi, cls_train):
    """I: train_classification --full-scale --quant dynamic, 1x1 conv, batch
    8: one warm-up step and three timed through K1, K2 and K3 (finite
    losses, parameters that move, K1/K2/K3 launches a step equal to the
    bf16 step's, one torch._int_mm a projection a step and one more a
    recomputed self-attend projection); then one batch's gradients with the
    product on torch._int_mm against the product on the plain version,
    under deterministic algorithms, bit for bit (a parameter whose gradient
    two torch._int_mm passes do not reproduce is reported apart)."""
    import torch

    from perceiverio_pytorch_tpu_torch import PrepType
    from perceiverio_pytorch_tpu_torch.examples import train_classification
    from perceiverio_pytorch_tpu_torch.ops import quant

    prep = "LEARNED_POS_1X1CONV"
    total = 1 + INT8_TRAIN_STEPS
    t0 = time.perf_counter()
    metrics = _metrics_path("chip_smoke_int8_train.jsonl")
    trainer, state, batches, _ = train_classification.setup(
        total, full_scale=True, prep_type=PrepType[prep], device="cuda",
        metrics_path=metrics, log_every=1, quant="dynamic")
    forward, recomputed = _int8_calls(state.model)
    quant.LAUNCHES = 0
    rec = _train_steps(trainer, state, batches, total, metrics, CLS_STEP_LAUNCHES)
    if quant.LAUNCHES != total * (forward + recomputed):
        raise AssertionError(f"{quant.LAUNCHES} torch._int_mm calls in {total} steps, expected"
                             f" {forward} + {recomputed} a step")
    batch = next(iter(batches(0)))
    model = state.model.train()
    torch.backends.cudnn.deterministic = True
    try:
        with _deterministic_algorithms():
            card = _grads(trainer.loss_fn, model, batch)
            with mock.patch.object(quant, "int8_gemm", quant.int8_gemm_reference):
                plain = _grads(trainer.loss_fn, model, batch)
            again = _grads(trainer.loss_fn, model, batch)
    finally:
        torch.backends.cudnn.deterministic = False
    model.zero_grad(set_to_none=True)
    unstable = sorted(n for n in card if not torch.equal(card[n], again[n]))
    differ = sorted(n for n in card if n not in unstable and not torch.equal(card[n], plain[n]))
    if differ or len(card) < 100:
        raise AssertionError(f"int8 step: {len(differ)} gradients differ from the plain"
                             f" product's: {differ[:5]}")
    bf16 = cls_train[prep]
    rec.update(prep=prep, quant="dynamic", batch=8, int_mm_forward=forward,
               int_mm_recomputed=recomputed, int_mm_calls=quant.LAUNCHES,
               images_per_s=8 * rec["steps_per_s"], bf16_median_step_s=bf16["median_step_s"],
               bf16_peak_mem_gb=bf16["peak_mem_gb"], grads_bitwise=len(card) - len(unstable),
               grads_not_reproducible=unstable, card=smi, seconds=time.perf_counter() - t0)
    print(f"[int8 train] {json.dumps(rec)}", flush=True)
    del trainer, state, batches, model, card, plain, again
    torch.cuda.empty_cache()
    return rec



def _write_demo_media(gen):
    """The demos' default media under ./sample_data: a 436x1024 PNG frame
    pair (the second rolled by (2, 3) pixels), a 375x500 JPEG, a 17-frame
    MJPG AVI of 256x320 and a stereo int16 48 kHz WAV."""
    import cv2
    import numpy as np
    import scipy.io.wavfile
    from PIL import Image

    def to_uint8(chw):
        return ((chw + 1) * 127.5).round().clamp(0, 255).byte().permute(1, 2, 0).numpy()

    os.makedirs("sample_data", exist_ok=True)
    frame = _smooth_frame(gen, *DEMO_FLOW_HW)
    Image.fromarray(to_uint8(frame)).save("sample_data/frame_0016.png")
    Image.fromarray(to_uint8(frame.roll((2, 3), (1, 2)))).save("sample_data/frame_0017.png")
    Image.fromarray(to_uint8(_smooth_frame(gen, *DEMO_IMAGE_HW))).save(
        "sample_data/dalmation.jpg", quality=95)
    writer = cv2.VideoWriter("sample_data/video.avi", cv2.VideoWriter_fourcc(*"MJPG"), 25,
                             (320, 256))
    for i in range(DEMO_CLIP_FRAMES):
        writer.write(np.ascontiguousarray(to_uint8(_smooth_frame(gen, 256, 320))[..., ::-1]))
    writer.release()
    t = np.arange(DEMO_AUDIO_SAMPLES)[:, None] / 48000.0
    audio = 0.4 * np.sin(2 * np.pi * np.array([440.0, 523.25]) * t)
    scipy.io.wavfile.write("sample_data/audio.wav", 48000, (audio * 2**15).astype(np.int16))


@contextlib.contextmanager
def _captured_model(module, name):
    """Patch the demo module's model constructor to keep the model it builds
    and every output of its forward (the demo's own model, its own call)."""
    import torch

    seen = {"outputs": []}
    cls = getattr(module, name)

    def build(*args, **kwargs):
        model = cls(*args, **kwargs)
        seen["model"] = model

        def hook(mod, inputs, output):
            seen["outputs"].append(output)
        model.register_forward_hook(hook)
        return model

    with mock.patch.object(module, name, build), torch.inference_mode():
        yield seen


def _same(label, got, want):
    import torch

    if isinstance(want, dict):
        for key in want:
            _same(f"{label}[{key}]", got[key], want[key])
        return
    if not (got.shape == want.shape and torch.equal(got, want)):
        diff = (got.float() - want.float()).abs().max().item() if got.shape == want.shape else None
        raise AssertionError(f"{label}: the demo's output is not the model's (max diff {diff})")


def phase_demos(serve, cls_serve, mm_serve):
    """J: the four reference demos at full width on the card, from a seeded
    reference-convention .pth each (--checkpoint) and synthetic media at the
    demos' default paths; each demo's own forward against the same weights
    called directly on the same inputs, bit for bit; K1 launches against the
    serving phases' counts a request."""
    import numpy as np
    import scipy.io.wavfile
    import torch

    from perceiverio_pytorch_tpu_torch import DEFAULT, FlowInference, LanguagePerceiver
    from perceiverio_pytorch_tpu_torch.examples import img_classify, language, multimodal
    from perceiverio_pytorch_tpu_torch.examples import opt_flow
    from perceiverio_pytorch_tpu_torch.utils.bytes_tokenizer import BytesTokenizer, pad_sequence
    from perceiverio_pytorch_tpu_torch.utils.image import (
        center_crop_resize,
        load_image,
        load_video,
        normalize_imagenet,
    )

    _write_demo_media(torch.Generator().manual_seed(SEED + 40))
    records = {}

    def run(label, module, name, demo, direct, want_k1):
        model = direct["model"]
        torch.save({"model_state_dict": model.state_dict()}, f"{label}.pth")
        _reset_launch_counts()
        with _captured_model(module, name) as seen:
            t0 = time.perf_counter()
            result = demo(f"{label}.pth")
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
        launches = _launch_counts()
        if launches["K1"] != want_k1:
            raise AssertionError(f"{label} demo: {launches['K1']} K1 launches, the serving"
                                 f" phase holds {want_k1} a request")
        with torch.inference_mode():
            _reset_launch_counts()
            want = direct["call"]()
            torch.cuda.synchronize()
            direct_k1 = _launch_counts()["K1"]
        got = seen["outputs"][-1] if direct.get("hooked", True) else result
        _same(f"{label} demo", got, want)
        records[label] = dict(seconds=seconds, launches=launches["K1"],
                              merge_launches=launches["merge"], direct_launches=direct_k1,
                              result=direct["describe"](result))
        print(f"[demo] {label}: {json.dumps(records[label])}", flush=True)
        del seen, model, direct
        torch.cuda.empty_cache()

    # Flow: the tiled 436x1024 pair, 6 tiles in one forward.
    flow_model = _flow_model(DEFAULT)
    img1 = torch.from_numpy(2 * (load_image("sample_data/frame_0016.png") / 255.0) - 1.0)
    img2 = torch.from_numpy(2 * (load_image("sample_data/frame_0017.png") / 255.0) - 1.0)
    infer = FlowInference(flow_model, device="cuda")
    run("opt_flow", opt_flow, "FlowPerceiver",
        lambda pth: torch.from_numpy(opt_flow.flow_example(checkpoint=pth)),
        dict(model=flow_model, hooked=False, call=lambda: infer(img1, img2).cpu(),
             describe=lambda f: dict(shape=list(f.shape),
                                     max_abs_flow=float(f.abs().max()))),
        serve["launches"] // serve["requests"])
    del flow_model, infer
    for prep in CLS_SITE_OF:
        model = _cls_model(prep, DEFAULT)
        img = torch.from_numpy(normalize_imagenet(center_crop_resize(
            load_image("sample_data/dalmation.jpg"), (224, 224)))).cuda()
        run(f"img_classify_{prep}", img_classify, "ClassificationPerceiver",
            lambda pth, prep=prep: img_classify.img_classify_example(
                img_classify.PrepType[prep], checkpoint=pth),
            dict(model=model, call=lambda model=model, img=img: model(img),
                 describe=lambda top5: top5),
            cls_serve[prep]["k1_launches_per_request"])
        del model
    # Language: the masked sentence, 2,048 bytes.
    lm = LanguagePerceiver(device="cuda", generator=torch.Generator().manual_seed(SEED)).eval()
    tokenizer = BytesTokenizer()
    tokens = tokenizer.to_int("This is an incomplete sentence where some words are missing.")
    tokens[51:60] = tokenizer.mask_token
    ids, mask = pad_sequence(2048, tokens[None], np.ones_like(tokens[None]),
                             tokenizer.pad_token)
    ids = torch.as_tensor(ids, dtype=torch.long, device="cuda")
    mask = torch.as_tensor(mask, dtype=torch.bool, device="cuda")
    run("language", language, "LanguagePerceiver",
        lambda pth: language.language_example(checkpoint=pth),
        dict(model=lm, call=lambda: lm(ids, mask), describe=lambda text: text), 0)
    del lm
    # Multimodal: 16 frames of 224x224, 30,720 samples, 16 chunks.
    mm = _mm_model(DEFAULT)
    video = load_video("sample_data/video.avi", resize=(224, 224))
    _, audio = scipy.io.wavfile.read("sample_data/audio.wav")
    video = torch.from_numpy(np.ascontiguousarray(np.moveaxis(video[None, :16], -1, -3))).cuda()
    audio = torch.from_numpy(
        (audio[None, :16 * 1920, 0:1].astype(np.float32) / 2**15)).cuda()
    run("multimodal", multimodal, "MultiModalPerceiver",
        lambda pth: multimodal.multimodal_example(checkpoint=pth),
        dict(model=mm, call=lambda: mm(video, audio, multimodal.N_CHUNKS),
             describe=lambda out: {k: list(v.shape) for k, v in out.items()}),
        mm_serve["k1_launches_per_clip"])
    for name in ("flow_prediction.png", "audio_reconstruction.wav", "video_reconstruction.avi"):
        if not os.path.getsize(name):
            raise AssertionError(f"the demos wrote an empty {name}")
    return records


def phase_postprocessor(smi):
    """K: ImagePostprocessor at the multimodal model's video shapes, every
    type with weights: fp32 on the card against the CPU (the same weights
    and inputs), then bf16 ms and peak memory."""
    import torch

    from perceiverio_pytorch_tpu_torch.io_processors import ImagePostprocessor

    cases = [
        ("patches", dict(postproc_type="patches", spatial_upsample=4), (1, 16, 56, 56, 48)),
        ("conv_t1_s4", dict(postproc_type="conv", spatial_upsample=4, n_outputs=3),
         (1, 16, 56, 56, 512)),
        ("conv_t2_s4", dict(postproc_type="conv", temporal_upsample=2, spatial_upsample=4,
                            n_outputs=3), (1, 8, 56, 56, 512)),
        ("conv1x1", dict(postproc_type="conv1x1", n_outputs=3,
                         input_reshape_size=(16, 224, 224)), (1, 16 * 224 * 224, 512)),
    ]
    gen = torch.Generator().manual_seed(SEED + 41)
    records = {}
    for label, kw, shape in cases:
        module = ImagePostprocessor(img_size=(224, 224), input_channels=shape[-1],
                                    generator=gen, **kw)
        x = torch.randn(shape, generator=gen)
        with torch.inference_mode():
            want = module(x)
            card = module.cuda()
            got = card(x.cuda())
            torch.cuda.synchronize()
            if tuple(got.shape) != (1, 16, 224, 224, 3) or tuple(want.shape) != tuple(got.shape):
                raise AssertionError(f"postprocessor {label}: shape {tuple(got.shape)}")
            diff = (got.cpu() - want).abs().max().item()
            peak = want.abs().max().item()
            if not diff <= POSTPROC_TOL * peak:
                raise AssertionError(f"postprocessor {label}: card vs CPU {diff} >"
                                     f" {POSTPROC_TOL} * {peak}")
            card = card.to(torch.bfloat16)
            xb = x.cuda().to(torch.bfloat16)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            ms = time_ms(lambda: card(xb), POSTPROC_REPS)
            peak_mem = torch.cuda.max_memory_allocated() - base
        records[label] = dict(input=list(shape), fp32_max_abs_diff=diff, max_abs=peak,
                              tolerance=POSTPROC_TOL, bf16_ms=ms, bf16_peak_mem_gb=peak_mem / 1e9)
        print(f"[postprocessor] {label}: {json.dumps(records[label])} | {smi}", flush=True)
        del module, card, x, xb, got, want
        torch.cuda.empty_cache()
    return records


def phase_utilities(smi, serve):
    """L: compiled_memory_stats and hbm_headroom of a bf16 flow serving
    forward (6 tiles), an over-sized request; trace and op_stats of that
    forward; ThroughputMeter's pairs/s; the MLM with layer_scan "on" against
    "off"."""
    import torch

    from perceiverio_pytorch_tpu_torch import (
        PERFORMANCE,
        FlowInference,
        LanguagePerceiver,
        compute_grid_indices,
    )
    from perceiverio_pytorch_tpu_torch.utils import memory, profiling

    model = _flow_model(PERFORMANCE)
    gen = torch.Generator().manual_seed(SEED + 42)
    frame = _smooth_frame(gen, *DEMO_FLOW_HW)
    img1, img2 = frame[None].cuda(), frame.roll((2, 3), (1, 2))[None].cuda()
    infer = FlowInference(model, device="cuda")
    h, w = model.img_size
    grid = compute_grid_indices(DEMO_FLOW_HW, (h, w))  # FlowInference's 6 tiles
    t1 = torch.cat([img1[..., y:y + h, x:x + w] for y, x in grid])
    t2 = torch.cat([img2[..., y:y + h, x:x + w] for y, x in grid])
    with torch.inference_mode():
        model(t1, t2)  # warm-up
        stats = memory.compiled_memory_stats(model, t1, t2)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        model(t1, t2)
        torch.cuda.synchronize()
        around = torch.cuda.max_memory_allocated() - before
        measured = stats["peak_bytes"] - stats["argument_bytes"]
        if abs(measured - around) > HBM_TOL * around:
            raise AssertionError(f"compiled_memory_stats high-water {measured} against the"
                                 f" allocator's {around}")
        fits = memory.hbm_headroom(model, t1, t2)
        if not fits["fits"]:
            raise AssertionError(f"hbm_headroom: the flow forward does not fit: {fits}")
        total = torch.cuda.get_device_properties(0).total_memory
        # fp32 elements: twice the card's memory.
        over = memory.hbm_headroom(lambda t: t.new_empty(total // 2 + 1), t1)
        if over["fits"] or over["headroom_bytes"] >= 0:
            raise AssertionError(f"hbm_headroom: a {total} byte request fits: {over}")
        again = model(t1, t2)  # the allocator is usable afterwards
        torch.cuda.synchronize()
        if not torch.isfinite(again).all():
            raise AssertionError("the flow forward after the refused request is not finite")
        with tempfile.TemporaryDirectory() as trace_dir:
            _reset_launch_counts()
            with profiling.trace(trace_dir):
                infer(img1, img2)
                torch.cuda.synchronize()
            launches = _launch_counts()
            rows = profiling.op_stats(trace_dir)
        k1_rows = [r for r in rows if "flash_fwd" in r["op"] and r["type"] == "kernel"]
        k1_seen = sum(r["occurrences"] for r in k1_rows)
        merge_seen = sum(r["occurrences"] for r in rows if "merge_kernel" in r["op"])
        want_k1 = serve["launches"] // serve["requests"]
        if (k1_seen, launches["K1"]) != (want_k1, want_k1) or merge_seen != launches["merge"]:
            raise AssertionError(f"op_stats: {k1_seen} K1 kernels and {merge_seen} merges in the"
                                 f" trace, the counters {launches}, phase 6 {want_k1}")
        pairs_per_s = profiling.ThroughputMeter(warmup=1).measure(infer, img1, img2, iters=3)
    del model, infer
    torch.cuda.empty_cache()
    lm = {value: LanguagePerceiver(policy=dataclasses.replace(PERFORMANCE, layer_scan=value),
                                   device="cuda",
                                   generator=torch.Generator().manual_seed(SEED)).eval()
          for value in ("off", "on")}
    lm["on"].load_state_dict(lm["off"].state_dict())
    ids, mask = _lm_batch(SEED + 43)
    with torch.inference_mode():
        out = {value: model(ids[:8], mask[:8]) for value, model in lm.items()}
    if not torch.equal(out["on"], out["off"]):
        raise AssertionError("layer_scan='on' differs from 'off'")
    rec = dict(memory_stats=stats, allocator_high_water=around, fits=fits["fits"],
               headroom_gb=fits["headroom_bytes"] / 1e9, over_fits=over["fits"],
               over_peak_gb=over["peak_bytes"] / 1e9, k1_kernels_traced=k1_seen,
               merges_traced=merge_seen,
               k1_self_us=sum(r["total_self_us"] for r in k1_rows),
               top_kernels=[(r["op"][:60], r["occurrences"], r["total_self_us"])
                            for r in rows[:5]],
               meter_pairs_per_s=pairs_per_s, phase6_pairs_per_s=serve["pairs_per_s"],
               layer_scan_on_equals_off=True)
    print(f"[utilities] {json.dumps(rec)} | {smi}", flush=True)
    return dict(k1_traced=k1_seen, pairs_per_s=pairs_per_s)


def _same_run(label, rec, state, want):
    """A mesh run's losses and final state_dict against the run without a
    mesh, bit for bit."""
    import torch

    got = state.model.state_dict()
    differ = {k: (got[k].double() - v.double()).abs().max().item()
              for k, v in want["state"].items() if not torch.equal(got[k], v)}
    if rec["loss"] != want["loss"] or set(got) != set(want["state"]) or differ:
        worst = max(differ.items(), key=lambda kv: kv[1]) if differ else None
        raise AssertionError(f"{label}: losses {rec['loss']} vs {want['loss']};"
                             f" {len(differ)} state entries differ (worst {worst})")


def _collectives(trainer, state, batches, step):
    """One more step of ``trainer`` to ``step`` under torch.profiler: the
    collectives it issues, as c10d calls on the host and NCCL kernels on the
    card, with their counts and times."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        trainer.fit(state, batches, num_steps=step)
        torch.cuda.synchronize()
    calls, kernels = {}, {}
    for event in prof.key_averages():
        name = event.key
        if name.startswith(("nccl:", "c10d::")):
            calls[name] = dict(count=event.count, cpu_ms=event.cpu_time_total / 1e3)
        elif "nccl" in name.lower():
            device_us = getattr(event, "device_time_total", None)
            if device_us is None:
                device_us = getattr(event, "cuda_time_total", 0.0)
            kernels[name] = dict(count=event.count, ms=device_us / 1e3)
    return dict(calls=calls, kernels=kernels,
                kernel_launches=sum(k["count"] for k in kernels.values()),
                kernel_ms=sum(k["ms"] for k in kernels.values()))


def _mesh_runs(label, setup, expected, eval_batches=False):
    """The example's ``setup`` for 1 + MESH_STEPS steps without a mesh, then
    on a (1, 1) mesh for each entry of ``MESH_RUNS``-style ``runs``: each
    mesh run's losses and final state bit for bit against the first run,
    its launches per step ``expected``, then one profiled step for its
    collectives.  Returns the records by run."""
    import torch

    from perceiverio_pytorch_tpu_torch.core.attention import Dense
    from perceiverio_pytorch_tpu_torch.parallel import layout_of

    total = 1 + MESH_STEPS
    records, want = {}, None
    for run, kw in setup["runs"]:
        metrics = _metrics_path(f"chip_smoke_mesh_{label}_{run}.jsonl")
        trainer, state, batches, evals = setup["fn"](total, metrics, **kw)
        rec = _train_steps(trainer, state, batches, total, metrics, expected,
                           evals if eval_batches else None)
        with open(metrics) as f:
            rec["eval_lines"] = [x for x in map(json.loads, f) if "loss" not in x
                                 and "resumed_from" not in x]
        if want is None:
            want = dict(loss=rec["loss"], evals=rec["eval_lines"],
                        state={k: v.clone() for k, v in state.model.state_dict().items()})
        else:
            _same_run(f"{label} {run}", rec, state, want)
            if [e for e in rec["eval_lines"]] != want["evals"]:
                raise AssertionError(f"{label} {run}: evaluations {rec['eval_lines']} vs"
                                     f" {want['evals']}")
            layout = layout_of(state.model)
            rec["fsdp_gathered_params"] = len(layout.gathers)
            rec["tp_projections"] = sum(isinstance(m, Dense) and m.tp is not None
                                        for m in state.model.modules())
            if kw.get("fsdp") and not rec["fsdp_gathered_params"]:
                raise AssertionError(f"{label} {run}: FSDP gathers no parameter")
            if not rec["tp_projections"]:
                raise AssertionError(f"{label} {run}: no projection is tensor-parallel")
            rec["collectives"] = _collectives(trainer, state, batches, total + 1)
        records[run] = rec
        del trainer, state, batches, evals
        torch.cuda.empty_cache()
    return records


def _mesh_summary(records, reference):
    return {run: dict(losses=r["loss"], median_step_s=r["median_step_s"],
                      step_s=r["step_s"], peak_mem_gb=r["peak_mem_gb"],
                      launches_per_step=r["launches_per_step"][-1],
                      **{k: r[k] for k in ("fsdp_gathered_params", "tp_projections",
                                           "collectives") if k in r})
            for run, r in records.items()} | {"reference_phase": reference}


def phase_mesh_flow(smi, train):
    """Phase M: train_flow --full-scale on a (1, 1) mesh, and with --fsdp,
    beside the run without a mesh."""
    from perceiverio_pytorch_tpu_torch.examples import train_flow

    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")  # one host, one rank
    setup = dict(
        fn=lambda total, metrics, **kw: train_flow.setup(
            total, full_scale=True, device="cuda", metrics_path=metrics, log_every=1, **kw),
        runs=(("single", {}), ("mesh", dict(mesh_shape=(1, 1))),
              ("mesh_fsdp", dict(mesh_shape=(1, 1), fsdp=True))))
    records = _mesh_runs("flow", setup, STEP_LAUNCHES)
    summary = _mesh_summary(records, dict(phase=8, median_step_s=train["median_step_s"],
                                          peak_mem_gb=train["peak_mem_gb"]))
    print(f"[mesh flow] {smi}: bf16 full width, remat, batch 1, 1 + {MESH_STEPS} steps,"
          f" bit for bit: {json.dumps(summary)}", flush=True)
    return records


@contextlib.contextmanager
def _cudnn_deterministic():
    import torch

    before = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = before


def phase_mesh_cls_mlm(smi, cls_train, lm_train):
    """Phase N: train_classification --full-scale --prep-type
    LEARNED_POS_1X1CONV on a (1, 1) mesh with --fsdp, and train_mlm
    --full-scale on a (1, 1) mesh, each beside its run without a mesh, all
    under deterministic algorithms (cuDNN's conv and the token table's
    backward are not reproducible otherwise, phases 25 and D)."""
    from perceiverio_pytorch_tpu_torch import PrepType
    from perceiverio_pytorch_tpu_torch.examples import train_classification, train_mlm

    prep = "LEARNED_POS_1X1CONV"
    cls_setup = dict(
        fn=lambda total, metrics, **kw: train_classification.setup(
            total, full_scale=True, prep_type=PrepType[prep], device="cuda",
            metrics_path=metrics, log_every=1, **kw),
        runs=(("single", {}), ("mesh_fsdp", dict(mesh_shape=(1, 1), fsdp=True))))
    mlm_setup = dict(
        fn=lambda total, metrics, **kw: train_mlm.setup(
            total, full_scale=True, device="cuda", metrics_path=metrics, log_every=1, **kw),
        runs=(("single", {}), ("mesh", dict(mesh_shape=(1, 1)))))
    with _deterministic_algorithms(), _cudnn_deterministic():
        cls = _mesh_runs("cls", cls_setup, CLS_STEP_LAUNCHES)
        mlm = _mesh_runs("mlm", mlm_setup, NO_LAUNCHES, eval_batches=True)
    cls_ref = cls_train[prep]
    print(f"[mesh cls] {smi}: 1x1 conv, bf16 full width, remat, batch 8, 1 + {MESH_STEPS}"
          " steps, bit for bit: " + json.dumps(_mesh_summary(cls, dict(
              phase=18, median_step_s=cls_ref["median_step_s"],
              peak_mem_gb=cls_ref["peak_mem_gb"]))), flush=True)
    print(f"[mesh mlm] {smi}: bf16 full width, batch 8, 1 + {MESH_STEPS} steps, bit for"
          " bit, evaluations at steps 2 and 4: " + json.dumps(_mesh_summary(mlm, dict(
              phase=19, median_step_s=lm_train["median_step_s"],
              peak_mem_gb=lm_train["peak_mem_gb"]))), flush=True)
    return dict(cls=cls, mlm=mlm)


def phase_mesh_serve(smi):
    """Phase O: FlowInference on a (1, 1) mesh over phase 6's pairs and
    weights (the flows equal phase 6's, bit for bit, 26 K1 launches a
    request); evaluate_classification --full-scale --prep-type
    LEARNED_POS_1X1CONV with --mesh 1 against the run without (the same
    logits, bit for bit, the same top-1 and top-5); then the process group
    is torn down."""
    import torch

    from perceiverio_pytorch_tpu_torch import PERFORMANCE, FlowInference, PrepType
    from perceiverio_pytorch_tpu_torch.examples import evaluate_classification
    from perceiverio_pytorch_tpu_torch.models.classification import ClassificationPerceiver
    from perceiverio_pytorch_tpu_torch.ops import flash_attention as fa
    from perceiverio_pytorch_tpu_torch.parallel import make_mesh

    model = _flow_model(PERFORMANCE)
    model.load_state_dict(SERVED["weights"])
    infer = FlowInference(model, mesh=make_mesh((1, 1)))
    infer(*SERVED["requests"][0])  # warm-up
    torch.cuda.synchronize()
    latencies = []
    fa.LAUNCHES = fa.LAUNCHES_MERGE = 0
    for (img1, img2), want in zip(SERVED["requests"], SERVED["flows"]):
        t0 = time.perf_counter()
        flow = infer(img1, img2)
        torch.cuda.synchronize()
        latencies.append(time.perf_counter() - t0)
        if not torch.equal(flow.cpu(), want):
            raise AssertionError("FlowInference(mesh) differs from phase 6: max"
                                 f" {(flow.cpu() - want).abs().max().item()}")
    n = len(SERVED["requests"])
    launches = dict(K1=fa.LAUNCHES, merge=fa.LAUNCHES_MERGE)
    if launches["K1"] != 26 * n:
        raise AssertionError(f"FlowInference(mesh): {launches} for {n} requests")
    del model, infer
    torch.cuda.empty_cache()
    logits, results, k1 = {}, {}, {}
    forward = ClassificationPerceiver.forward
    for mesh in (None, 1):
        logits[mesh] = []

        def recording(self, *args, _into=logits[mesh], **kwargs):
            out = forward(self, *args, **kwargs)
            _into.append(out.detach().clone())
            return out

        fa.LAUNCHES = 0
        with mock.patch.object(ClassificationPerceiver, "forward", recording):
            results[mesh] = evaluate_classification.main(
                full_scale=True, mesh_devices=mesh, limit=MESH_EVAL_LIMIT,
                prep_type=PrepType.LEARNED_POS_1X1CONV, device="cuda")
        k1[mesh] = fa.LAUNCHES
        torch.cuda.empty_cache()
    same = len(logits[None]) == len(logits[1]) and all(
        torch.equal(a, b) for a, b in zip(logits[None], logits[1]))
    keys = ("images", "top1", "top5")
    if not same or any(results[None][k] != results[1][k] for k in keys) or k1[None] != k1[1]:
        raise AssertionError(f"evaluate_classification --mesh 1: {results[1]}, K1 {k1[1]}"
                             f" vs {results[None]}, K1 {k1[None]}; logits equal: {same}")
    torch.distributed.destroy_process_group()
    rec = dict(flow=dict(requests=n, latency_s=latencies, launches=launches,
                         phase6_latency_s=SERVED.get("latency_s")),
               evaluate_classification={"mesh": results[1], "no_mesh": results[None],
                                        "k1_launches": k1[1], "batches": len(logits[1])})
    print(f"[mesh serve] {smi}: bit for bit: {json.dumps(rec)}", flush=True)
    return rec


def _rel(got, want):
    """max |got - want| over max |want|, in fp32."""
    want = want.float()
    return (got.float() - want).abs().max().item() / want.abs().max().item()


def _sp_pieces(k, v, n):
    """k and v padded with masked keys to a multiple of ``n`` and split into
    ``n`` pieces of keys: [(k_i, v_i, kv_mask_i)]."""
    import torch

    from perceiverio_pytorch_tpu_torch.parallel.sequence_parallel import pad_tokens

    (k, v), mask = pad_tokens((k, v), None, n)
    if mask is None:  # nothing padded: every key valid
        mask = torch.ones(k.shape[:2], dtype=torch.bool, device=k.device)
    return [tuple(t.contiguous() for t in piece)
            for piece in zip(k.chunk(n, 1), v.chunk(n, 1), mask.chunk(n, 1))]


def _one_process_ring(q, pieces):
    """The ring's forward in one process: K1 with its lse on each piece, then
    ``lse_merge`` with reductions over the stacked pieces."""
    from perceiverio_pytorch_tpu_torch.ops import flash_attention as fa

    b, tq, h, _ = q.shape
    dv = pieces[0][1].shape[3]
    parts = [fa.flash_attention(q, k, v, kv_mask=m, return_lse=True) for k, v, m in pieces]
    return _merge_pieces(parts, b, tq, h, dv, q.dtype)


def _merge_pieces(parts, b, tq, h, dv, dtype):
    import torch

    from perceiverio_pytorch_tpu_torch.parallel import sequence_parallel as sp

    out, lse = sp.lse_merge(torch.stack([o.view(b, tq, h, dv) for o, _ in parts]),
                            torch.stack([lse for _, lse in parts]),
                            lambda t: t.amax(0, keepdim=True), lambda t: t.sum(0, keepdim=True))
    return out[0].reshape(b, tq, h * dv).to(dtype), lse[0]


def _pieces_backward(q, pieces, out, lse, grad, tk):
    """K2/K3 on each piece with the merged output and the global lse: dQ
    summed over the pieces (fp32), dK and dV concatenated (pads cut)."""
    import torch

    from perceiverio_pytorch_tpu_torch.ops import flash_attention as fa

    grads = [fa.flash_attention_backward(q, k, v, out, lse, grad, kv_mask=m)
             for k, v, m in pieces]
    dq = torch.stack([g[0].float() for g in grads]).sum(0)
    dk = torch.cat([g[1] for g in grads], dim=1)[:, :tk]
    dv = torch.cat([g[2] for g in grads], dim=1)[:, :tk]
    return dq, dk, dv


def phase_sp_merge(smi):
    """Phase P(a): the ring's merge and backward in one process at the
    published encoder sites, against K1/K2/K3 on the whole site."""
    import torch

    from perceiverio_pytorch_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(SEED + 16)
    records = []
    for site, shape in SP_SITES.items():
        b, tq, tk, h, d, dv = shape
        for dtype_name, dtype in (("bf16", torch.bfloat16), ("fp32", torch.float32)):
            q, k, v, _ = _case_inputs(*shape, dtype, False, gen)
            grad = torch.randn(b, tq, h * dv, generator=gen, device="cuda").to(dtype)
            out_w, lse_w = fa.flash_attention(q, k, v, return_lse=True)
            dq_w, dk_w, dv_w = fa.flash_attention_backward(q, k, v, out_w, lse_w, grad)
            whole_k1 = time_ms(lambda: fa.flash_attention(q, k, v, return_lse=True), SP_REPS)
            whole_bwd = time_ms(lambda: fa.flash_attention_backward(q, k, v, out_w, lse_w, grad),
                                SP_REPS)
            for n in SP_PIECES:
                pieces = _sp_pieces(k, v, n)
                out, lse = _one_process_ring(q, pieces)
                dq, dk, dvv = _pieces_backward(q, pieces, out, lse, grad, tk)
                finite = torch.isfinite(lse_w)
                rec = dict(site=site, dtype=dtype_name, shape=list(shape), pieces=n,
                           keys_per_piece=pieces[0][0].shape[1],
                           out_rel=_rel(out, out_w),
                           lse_max_abs_diff=(lse - lse_w)[finite].abs().max().item(),
                           dq_rel=_rel(dq, dq_w), dk_rel=_rel(dk, dk_w), dv_rel=_rel(dvv, dv_w))
                worst = max(rec[key] for key in ("out_rel", "dq_rel", "dk_rel", "dv_rel"))
                if not (torch.equal(torch.isfinite(lse), finite) and worst <= TOL[dtype_name]):
                    raise AssertionError(f"one-process ring vs whole site: {rec}")
                parts = [fa.flash_attention(q, pk, pv, kv_mask=m, return_lse=True)
                         for pk, pv, m in pieces]
                rec.update(
                    whole_k1_ms=whole_k1, whole_bwd_ms=whole_bwd,
                    pieces_k1_ms=time_ms(lambda: [fa.flash_attention(
                        q, pk, pv, kv_mask=m, return_lse=True) for pk, pv, m in pieces], SP_REPS),
                    merge_ms=time_ms(lambda: _merge_pieces(parts, b, tq, h, dv, dtype), SP_REPS),
                    pieces_bwd_ms=time_ms(lambda: [fa.flash_attention_backward(
                        q, pk, pv, out, lse, grad, kv_mask=m) for pk, pv, m in pieces], SP_REPS),
                    tolerance=TOL[dtype_name])
                records.append(rec)
                del pieces, parts, out, lse, dq, dk, dvv
            del q, k, v, grad, out_w, lse_w, dq_w, dk_w, dv_w
            torch.cuda.empty_cache()
    print(f"[sp merge] {smi}: {json.dumps(records)}", flush=True)
    return records


@contextlib.contextmanager
def _ring_calls():
    """Counts the ring's merges (one a site the ring runs) within the block."""
    from perceiverio_pytorch_tpu_torch.parallel import sequence_parallel as sp

    with mock.patch.object(sp, "lse_merge", wraps=sp.lse_merge) as merges:
        yield merges


def _sp_flow_step(policy):
    """Phase 8's step (train_flow's model, loss and remat, bf16) on one
    synthetic pair, once to warm up and once counted and timed: the loss,
    every gradient, the launches and seconds."""
    import torch

    from perceiverio_pytorch_tpu_torch.examples.train_flow import synthetic_flow_pairs
    from perceiverio_pytorch_tpu_torch.training import flow_endpoint_error

    model = _flow_model(policy, remat=True).train()
    img1, img2, flow = (torch.from_numpy(a).cuda()
                        for a in synthetic_flow_pairs(1, (368, 496), seed=SEED + 4))
    for _ in range(2):
        model.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        _reset_launch_counts()
        t0 = time.perf_counter()
        loss = flow_endpoint_error(model(img1, img2), flow)
        loss.backward()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()
             if p.grad is not None}
    return loss.item(), grads, _launch_counts(), seconds


def phase_sp_models(smi, mesh):
    """Phase P(b), (c): the published flow model under Policy(sp_mesh) on
    phase 6's pairs and weights and a phase-8 step, and the multimodal model
    on phase 10's clip, on the (1, 1) mesh."""
    import torch

    from perceiverio_pytorch_tpu_torch import PERFORMANCE, FlowInference

    policy = dataclasses.replace(PERFORMANCE, sp_mesh=mesh)
    model = _flow_model(policy)
    model.load_state_dict(SERVED["weights"])
    infer = FlowInference(model, device="cuda")
    latencies, gaps = [], []
    with torch.inference_mode(), _ring_calls() as merges:
        infer(*SERVED["requests"][0])  # warm-up
        torch.cuda.synchronize()
        _reset_launch_counts()
        merges.reset_mock()
        for (img1, img2), want in zip(SERVED["requests"], SERVED["flows"]):
            t0 = time.perf_counter()
            flow = infer(img1, img2)
            torch.cuda.synchronize()
            latencies.append(time.perf_counter() - t0)
            gaps.append((flow.cpu() - want).abs().max().item() / want.abs().max().item())
        launches, rings = _launch_counts(), merges.call_count
    n = len(SERVED["requests"])
    if launches["K1"] != 26 * n or rings != n or not max(gaps) <= MODEL_TOL:
        raise AssertionError(f"flow under Policy(sp_mesh): launches {launches}, ring {rings}"
                             f" for {n} requests, gaps {gaps}")
    flow_rec = dict(requests=n, bitwise=max(gaps) == 0.0, max_rel_gap=max(gaps),
                    latency_s=latencies, phase6_latency_s=SERVED["latency_s"],
                    launches=launches, ring_merges=rings)
    del model, infer
    torch.cuda.empty_cache()
    with _ring_calls() as merges:
        loss_sp, grads_sp, launches_sp, seconds_sp = _sp_flow_step(policy)
        rings = merges.call_count
    loss, grads, launches_ref, seconds = _sp_flow_step(PERFORMANCE)
    if launches_sp != STEP_LAUNCHES or launches_ref != STEP_LAUNCHES or rings != 2:
        raise AssertionError(f"sp step launches {launches_sp}, ring {rings}; without sp"
                             f" {launches_ref}; expected {STEP_LAUNCHES}")
    if loss_sp != loss and not abs(loss_sp - loss) <= 1e-3 * abs(loss):
        raise AssertionError(f"sp step loss {loss_sp} vs {loss}")
    worst, worst_name, _ = _compare_grads("sp step", grads_sp, grads, BF16_GRAD_TOL)
    bitwise = loss_sp == loss and all(torch.equal(grads_sp[k], g) for k, g in grads.items())
    step_rec = dict(loss=loss_sp, loss_without_sp=loss, bitwise=bitwise, ring_merges=rings,
                    worst_rel_grad_diff=worst, worst_param=worst_name, launches=launches_sp,
                    step_s=seconds_sp, step_s_without_sp=seconds,
                    phase8_median_step_s=None)
    del grads, grads_sp
    torch.cuda.empty_cache()
    mm = _mm_model(dataclasses.replace(PERFORMANCE, sp_mesh=mesh))
    mm.load_state_dict(MM_SERVED["weights"])
    with torch.inference_mode(), _ring_calls() as merges:
        mm(*MM_SERVED["clip"], n_chunks=MM_CHUNKS)  # warm-up
        torch.cuda.synchronize()
        _reset_launch_counts()
        merges.reset_mock()
        t0 = time.perf_counter()
        out = mm(*MM_SERVED["clip"], n_chunks=MM_CHUNKS)
        torch.cuda.synchronize()
        clip_s = time.perf_counter() - t0
        launches, rings = _launch_counts(), merges.call_count
    _check_mm_outputs(out, "multimodal under Policy(sp_mesh)")
    gaps = {k: _rel(out[k].cpu(), v) for k, v in MM_SERVED["outputs"].items()}
    if (launches["K1"], launches["merge"], rings) != (1, 1, 1) or not max(
            gaps.values()) <= MODEL_TOL:
        raise AssertionError(f"multimodal under Policy(sp_mesh): {launches}, ring {rings},"
                             f" gaps {gaps}")
    mm_rec = dict(bitwise=max(gaps.values()) == 0.0, max_rel_gap=gaps, launches=launches,
                  ring_merges=rings, clip_s=clip_s, phase10_latency_s=MM_SERVED["latency_s"])
    del mm
    torch.cuda.empty_cache()
    return dict(flow=flow_rec, step=step_rec, multimodal=mm_rec)


def phase_sp(smi, train):
    """Phase P: sequence parallelism on the card (see the module docstring)."""
    from perceiverio_pytorch_tpu_torch.parallel import make_mesh

    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")  # one host, one rank
    merge = phase_sp_merge(smi)
    models = phase_sp_models(smi, make_mesh((1, 1)))
    models["step"]["phase8_median_step_s"] = train["median_step_s"]
    print(f"[sp models] {smi}: {json.dumps(models)}", flush=True)
    return dict(merge=merge, **models)


def phase_chunk_mesh_and_server(smi):
    """Phase Q: phase 10's clip through chunk_mesh on the (1, 1) mesh, and
    the full-width 1x1-conv classifier behind serve_on_mesh; then the process
    group is torn down."""
    import torch

    from perceiverio_pytorch_tpu_torch import PERFORMANCE
    from perceiverio_pytorch_tpu_torch.parallel import (
        make_data_parallel_apply,
        make_mesh,
        serve_on_mesh,
    )

    mesh = make_mesh((1, 1))
    model = _mm_model(PERFORMANCE)
    model.load_state_dict(MM_SERVED["weights"])
    with torch.inference_mode():
        model(*MM_SERVED["clip"], n_chunks=MM_CHUNKS, chunk_mesh=mesh)  # warm-up
        torch.cuda.synchronize()
        _reset_launch_counts()
        t0 = time.perf_counter()
        out = model(*MM_SERVED["clip"], n_chunks=MM_CHUNKS, chunk_mesh=mesh)
        torch.cuda.synchronize()
        clip_s = time.perf_counter() - t0
        launches = _launch_counts()
    differ = {k: _rel(out[k].cpu(), v) for k, v in MM_SERVED["outputs"].items()
              if not torch.equal(out[k].cpu(), v)}
    if differ or (launches["K1"], launches["merge"]) != (1, 1):
        raise AssertionError(f"chunk_mesh clip: outputs differ from phase 10's {differ},"
                             f" launches {launches}")
    chunk_rec = dict(bitwise=True, n_chunks=MM_CHUNKS, waves=MM_CHUNKS, launches=launches,
                     clip_s=clip_s, phase10_latency_s=MM_SERVED["latency_s"])
    del model, out
    torch.cuda.empty_cache()

    prep = "LEARNED_POS_1X1CONV"
    cls = _cls_model(prep, PERFORMANCE)
    weights = {k: v.detach().clone() for k, v in cls.state_dict().items()}
    fn, place = make_data_parallel_apply(cls, mesh)
    ran = []

    def recorded(variables, *rows):
        out = fn(variables, *rows)
        ran.append((rows[0].clone(), out.clone()))
        return out

    images = list(_cls_images(torch.Generator().manual_seed(SEED + 17),
                              MESH_SERVER_REQUESTS).cpu())
    server = serve_on_mesh(recorded, place(weights)[0], mesh, max_batch=16,
                           batch_sizes=(8, 16), max_wait_ms=20.0, pipeline=True)
    try:
        _reset_launch_counts()
        server.warmup(images[0])
        warmups = _launch_counts()
        _reset_launch_counts()
        t0 = time.perf_counter()
        futures = [server.submit(img) for img in images]
        rows = [f.result(timeout=300) for f in futures]
        served_s = time.perf_counter() - t0
        served = _launch_counts()
        stats = server.stats()
    finally:
        server.stop()
    batches = ran[len(ran) - stats["batches_dispatched"]:]
    if served["K1"] != len(batches) or warmups["K1"] != 2 or stats["requests_served"] != len(
            images):
        raise AssertionError(f"mesh server: K1 {served} for {len(batches)} batches, warm-ups"
                             f" {warmups}, stats {stats}")
    with torch.inference_mode():
        for batch, got in ran:
            if not torch.equal(cls(batch), got):
                raise AssertionError("mesh server: a batch differs from the eager model's")
    for i, (img, row) in enumerate(zip(images, rows)):
        j, r = next((j, r) for j, (batch, _) in enumerate(batches)
                    for r in range(batch.shape[0]) if torch.equal(batch[r].cpu(), img))
        if not torch.equal(row, batches[j][1][r].cpu()):
            raise AssertionError(f"mesh server: request {i}'s row differs from its batch's")
    torch.distributed.destroy_process_group()
    server_rec = dict(requests=len(images), seconds=served_s, launches=served,
                      warmup_launches=warmups, batches=[b.shape[0] for b, _ in batches],
                      stats={k: stats[k] for k in ("batches_dispatched", "rows_padded",
                                                   "bucket_dispatches")}, bitwise=True)
    rec = dict(chunk_mesh=chunk_rec, server=server_rec)
    print(f"[chunk mesh, mesh server] {smi}: {json.dumps(rec)}", flush=True)
    return rec


def _stack_input(policy):
    """The flow model under ``policy`` on phase 6's weights, and the latents
    its self-attend stack receives on phase 6's first request (6 tiles)."""
    import torch

    from perceiverio_pytorch_tpu_torch import FlowInference

    model = _flow_model(policy)
    model.load_state_dict(SERVED["weights"])
    seen = []
    stack = model.perceiver._encoder.self_attends
    hook = stack.register_forward_pre_hook(lambda module, args: seen.append(args[0].detach()))
    try:
        with torch.inference_mode():
            FlowInference(model, device="cuda")(*SERVED["requests"][0])
    finally:
        hook.remove()
    return model, seen[0].clone()


def _schedule(stack, latents, policy, n_stages, num_mb, circ):
    """The ``Policy.pp_mesh`` route (``pipeline_layers``: its tick loop and
    stage body on the stack's own layers) over ``n_stages`` stages in this
    process, the ring's sends replaced by a local hop."""
    from perceiverio_pytorch_tpu_torch.parallel import pipeline as pp

    policy = dataclasses.replace(policy, pp_microbatches=num_mb, pp_circ_repeats=circ)
    return pp.pipeline_layers(stack, latents, policy, stages=n_stages)


def phase_pp_schedule(smi):
    """Phase R(a), (b): the schedules in one process at the flow stack's
    width, forward and backward, against the sequential stack."""
    import torch

    from perceiverio_pytorch_tpu_torch import PERFORMANCE
    from perceiverio_pytorch_tpu_torch.config import PARITY

    forward, backward = [], []
    for dtype, policy in (("bf16", PERFORMANCE),
                          ("fp32", dataclasses.replace(PARITY, attn_impl="auto"))):
        model, latents = _stack_input(policy)
        stack = model.perceiver._encoder.self_attends
        with torch.inference_mode():
            stack(latents)  # warm-up
            torch.cuda.synchronize()
            _reset_launch_counts()
            t0 = time.perf_counter()
            want = stack(latents)
            torch.cuda.synchronize()
            seq_ms, seq_k1 = 1e3 * (time.perf_counter() - t0), _launch_counts()["K1"]
            cases = [(s, 1, m) for s, m in PP_GPIPE] + [PP_CIRCULAR]
            for n_stages, circ, num_mb in cases:
                _schedule(stack, latents, policy, n_stages, num_mb, circ)  # warm-up
                torch.cuda.synchronize()
                _reset_launch_counts()
                t0 = time.perf_counter()
                out = _schedule(stack, latents, policy, n_stages, num_mb, circ)
                torch.cuda.synchronize()
                ms, launches = 1e3 * (time.perf_counter() - t0), _launch_counts()
                rec = dict(dtype=dtype, stages=n_stages, circ_repeats=circ,
                           microbatches=num_mb, tiles=latents.shape[0],
                           max_rel_diff=_rel(out, want), bitwise=torch.equal(out, want),
                           k1_launches=launches["K1"], valid_ticks_k1=PP_LAYERS * num_mb,
                           every_tick_k1=PP_LAYERS * (circ * num_mb + n_stages - 1) // circ,
                           ms=ms, sequential_ms=seq_ms, sequential_k1=seq_k1,
                           tolerance=TOL[dtype])
                # the bubble computes nothing: K1 once a layer a valid tick
                if not (rec["max_rel_diff"] <= TOL[dtype]
                        and launches["K1"] == rec["valid_ticks_k1"]):
                    raise AssertionError(f"pipeline schedule vs the sequential stack: {rec}")
                forward.append(rec)
        gen = torch.Generator(device="cuda").manual_seed(SEED + 18)
        x = latents[:2].detach().clone()
        g = torch.randn(x.shape, generator=gen, device="cuda")
        tol = GRAD_TOL if dtype == "fp32" else BF16_GRAD_TOL

        def gradients(run):
            model.zero_grad(set_to_none=True)
            xg = x.clone().requires_grad_()
            torch.cuda.synchronize()
            _reset_launch_counts()
            loss = (run(xg).float() * g).sum()
            loss.backward()
            torch.cuda.synchronize()
            grads = {n: p.grad.detach().clone() for n, p in stack.named_parameters()}
            return loss.item(), grads, xg.grad.detach().clone(), _launch_counts()

        loss_s, grads_s, dx_s, launches_s = gradients(stack)
        for name, n_stages, circ in PP_BACKWARD:
            loss_p, grads_p, dx_p, launches_p = gradients(
                lambda xg: _schedule(stack, xg, policy, n_stages, 2, circ))
            worst, worst_name, key_bias = _compare_grads(f"pp {name} {dtype}", grads_p,
                                                         grads_s, tol)
            rec = dict(dtype=dtype, schedule=name, stages=n_stages, circ_repeats=circ,
                       microbatches=2, batch=2, loss=loss_p, sequential_loss=loss_s,
                       latents_grad_rel=_rel(dx_p, dx_s), worst_rel_grad_diff=worst,
                       worst_param=worst_name, key_bias_grad_rel=key_bias,
                       bitwise=all(torch.equal(grads_p[k], v) for k, v in grads_s.items()),
                       launches=launches_p, sequential_launches=launches_s, tolerance=tol)
            if not (rec["latents_grad_rel"] <= tol
                    and all(launches_p[k] == PP_LAYERS * 2 for k in ("K1", "K2", "K3"))):
                raise AssertionError(f"pipeline backward vs the sequential stack: {rec}")
            backward.append(rec)
        del model, stack, latents, x, g, grads_s, dx_s
        torch.cuda.empty_cache()
    print(f"[pp schedule] {smi}: {json.dumps(forward)}", flush=True)
    print(f"[pp backward] {smi}: {json.dumps(backward)}", flush=True)
    return forward, backward


def phase_pp_one_stage(smi):
    """Phase R(c): the published flow model under Policy(pp_mesh) on a
    one-stage pipe mesh: phase 6's flows and a phase-8 step, bit for bit
    (the sequential stack runs); then the process group is torn down."""
    import torch

    from perceiverio_pytorch_tpu_torch import PERFORMANCE, FlowInference
    from perceiverio_pytorch_tpu_torch.parallel import make_pipeline_mesh

    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")  # one host, one rank
    policy = dataclasses.replace(PERFORMANCE, pp_mesh=make_pipeline_mesh(1))
    model = _flow_model(policy)
    model.load_state_dict(SERVED["weights"])
    infer = FlowInference(model, device="cuda")
    latencies = []
    with torch.inference_mode():
        infer(*SERVED["requests"][0])  # warm-up
        torch.cuda.synchronize()
        _reset_launch_counts()
        for (img1, img2), want in zip(SERVED["requests"], SERVED["flows"]):
            t0 = time.perf_counter()
            flow = infer(img1, img2)
            torch.cuda.synchronize()
            latencies.append(time.perf_counter() - t0)
            if not torch.equal(flow.cpu(), want):
                raise AssertionError("flow under a one-stage Policy(pp_mesh) differs from"
                                     " phase 6's")
        launches = _launch_counts()
    n = len(SERVED["requests"])
    if launches["K1"] != 26 * n:
        raise AssertionError(f"one-stage pp flows: launches {launches} for {n} requests")
    serve_rec = dict(requests=n, bitwise=True, latency_s=latencies,
                     phase6_latency_s=SERVED["latency_s"], launches=launches)
    del model, infer
    torch.cuda.empty_cache()
    loss_pp, grads_pp, launches_pp, seconds_pp = _sp_flow_step(policy)
    loss, grads, launches_ref, seconds = _sp_flow_step(PERFORMANCE)
    if launches_pp != STEP_LAUNCHES or launches_ref != STEP_LAUNCHES:
        raise AssertionError(f"one-stage pp step launches {launches_pp}; without"
                             f" {launches_ref}; expected {STEP_LAUNCHES}")
    if loss_pp != loss or not all(torch.equal(grads_pp[k], g) for k, g in grads.items()) or (
            set(grads_pp) != set(grads)):
        raise AssertionError(f"one-stage pp step: loss {loss_pp} vs {loss}, or a gradient"
                             " differs")
    step_rec = dict(loss=loss_pp, bitwise=True, launches=launches_pp, step_s=seconds_pp,
                    step_s_without_pp=seconds)
    del grads, grads_pp
    torch.distributed.destroy_process_group()
    torch.cuda.empty_cache()
    return dict(serve=serve_rec, step=step_rec)


def phase_pp(smi):
    """Phase R: the pipelines on the card (see the module docstring)."""
    forward, backward = phase_pp_schedule(smi)
    one_stage = phase_pp_one_stage(smi)
    print(f"[pp one stage] {smi}: {json.dumps(one_stage)}", flush=True)
    return dict(schedule=forward, backward=backward, **one_stage)


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
                 cls_k1_train, buckets, serving, files, int8, demos, utilities, mesh):
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
    The file-backed phases' launches are counted apart: on the flow entries
    of K1, K2 and K3 ``launches_files_train`` (the training steps of phase
    25's two runs, with their merges or sums) and on K1's
    ``launches_files_eval`` (the Trainer's evaluations there) and
    ``launches_evaluate_flow`` (phase 26); on the d = 512 entries the same
    for phase 27 (``launches_evaluate_classification``).  The train ->
    evaluate phases' launches too: ``launches_evaluate_multimodal`` (phase
    28's two runs, with their merges) on the d = 704 K1 entry, and
    ``launches_ema_train`` (phase 31's steps, with their merges or sums) on
    the flow entries of K1, K2 and K3.  The rest of training's: phase B's
    one flow step under each remat policy (``launches_dots_saveable_step``,
    ``launches_nothing_saveable_step``) on the flow entries, and on the d =
    704 K2/K3 entries the multimodal training run's launches under its
    dots_saveable (``launches``) and under full remat
    (``launches_full_remat_train``).  The int8 phases' launches: on the d =
    261 and d = 512 K1 entries ``launches_int8_serve`` (phase G's requests
    under both int8 modes, with their merges), on the d = 512 one
    ``launches_int8_export`` (phase H's artifact calls) and on the d = 512
    K1, K2 and K3 entries ``launches_int8_train`` (phase I's steps, with
    their merges or sums).  The reference demos' (phase J, fp32, one
    request each): ``launches_demo`` (with ``merge_launches_demo``) on the
    flow, d = 704, d = 261 and d = 512 K1 entries, and on the flow one
    ``launches_traced`` (phase L: the K1 kernels ``op_stats`` found in a
    traced bf16 serving forward).  The mesh phases' (M to O):
    ``launches_mesh_train`` (with its merges or sums) on the flow entries of
    K1, K2 and K3 (phase M's two mesh runs) and on the d = 512 ones (phase
    N's classifier), ``launches_mesh_serve`` on the flow K1 entry and
    ``launches_mesh_evaluate`` on the d = 512 one (phase O).  Sequence
    parallelism and the mesh server's (P, Q): ``launches_sp_serve`` (phase
    P's flow requests under Policy(sp_mesh)) on the flow K1 entry and
    ``launches_sp_train`` (its step) on the flow K1, K2 and K3 entries,
    ``launches_sp_clip`` and ``launches_chunk_mesh`` on the d = 704 K1
    entry, ``launches_mesh_server`` (and its warm-ups) on the d = 512 one;
    ``sp_pieces`` on the flow and d = 704 entries: phase P(a)'s errors and
    times at that site.  The pipelines' (R): ``launches_pp_schedule`` (R(a)'s
    one-process schedules, with ``pp_schedule``: each case's error, launches
    and ms) and ``launches_pp_serve`` (R(c)'s requests) on the flow K1 entry,
    ``launches_pp_backward`` (R(b)) and ``launches_pp_train`` (R(c)'s step)
    on the flow K1, K2 and K3 entries.  Each entry's error is the largest of
    all its comparisons."""
    flow_files, cls_files = files["flow"]["launches"], files["cls"]["launches"]
    mm_eval_runs = files["evaluate_multimodal"]["runs"].values()

    def sac_counts(kernel, extra):
        """Phase B's launches: one flow step under each remat policy."""
        out = {}
        for policy, rec in files["flow_sac"].items():
            if isinstance(rec, dict) and "launches" in rec:
                out[f"launches_{policy}_step"] = rec["launches"][kernel]
                out[f"{extra}_launches_{policy}_step"] = rec["launches"][extra]
        return out

    def mesh_counts(kernel, extra, runs):
        """The mesh runs' launches (phases M and N)."""
        return {"launches_mesh_train": sum(r["launches"][kernel] for r in runs),
                f"{extra}_launches_mesh_train": sum(r["launches"][extra] for r in runs)}

    flow_mesh = [r for run, r in mesh["flow"].items() if run != "single"]
    cls_mesh = [r for run, r in mesh["cls"].items() if run != "single"]
    sp, chunk_server = mesh["sp"], mesh["chunk_server"]

    def sp_counts(kernel, extra):
        """Phase P(b)'s step under Policy(sp_mesh)."""
        return {"launches_sp_train": sp["step"]["launches"][kernel],
                f"{extra}_launches_sp_train": sp["step"]["launches"][extra]}

    pp = mesh["pp"]

    def pp_counts(kernel, extra):
        """Phase R's launches: the one-process schedules' backward (R(b)) and
        the one-stage pipe mesh's step (R(c))."""
        return {"launches_pp_backward": sum(r["launches"][kernel] for r in pp["backward"]),
                f"{extra}_launches_pp_backward": sum(r["launches"][extra]
                                                     for r in pp["backward"]),
                "launches_pp_train": pp["step"]["launches"][kernel],
                f"{extra}_launches_pp_train": pp["step"]["launches"][extra]}

    def sp_pieces(site, keys):
        """Phase P(a)'s one-process ring at this site: errors and times."""
        return [{k: r[k] for k in ("dtype", "pieces") + keys} for r in sp["merge"]
                if r["site"] == site]

    def demo_counts(demo):
        """Phase J's launches: the demo's one request."""
        return dict(launches_demo=demos[demo]["launches"],
                    merge_launches_demo=demos[demo]["merge_launches"])

    def file_counts(kernel, extra, counts, evaluated=None, evaluate_key=None):
        out = {"launches_files_train": counts["train"][kernel],
               f"{extra}_launches_files_train": counts["train"][extra]}
        if kernel == "K1":
            out.update(launches_files_eval=counts["eval"]["K1"],
                       merge_launches_files_eval=counts["eval"]["merge"])
            out[evaluate_key] = evaluated
        return out

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
        **file_counts("K1", "merge", flow_files, files["evaluate_flow"]["launches"]["K1"],
                      "launches_evaluate_flow"),
        launches_ema_train=files["ema"]["launches"]["K1"],
        merge_launches_ema_train=files["ema"]["launches"]["merge"],
        **sac_counts("K1", "merge"),
        **demo_counts("opt_flow"),
        launches_traced=utilities["k1_traced"],
        **mesh_counts("K1", "merge", flow_mesh),
        launches_mesh_serve=mesh["serve"]["flow"]["launches"]["K1"],
        launches_sp_serve=sp["flow"]["launches"]["K1"],
        merge_launches_sp_serve=sp["flow"]["launches"]["merge"],
        **sp_counts("K1", "merge"),
        sp_pieces=sp_pieces("flow_encoder", ("out_rel", "whole_k1_ms", "pieces_k1_ms",
                                             "merge_ms")),
        launches_pp_schedule=sum(r["k1_launches"] for r in pp["schedule"]),
        launches_pp_serve=pp["serve"]["launches"]["K1"],
        merge_launches_pp_serve=pp["serve"]["launches"]["merge"],
        **pp_counts("K1", "merge"),
        pp_schedule=[{k: r[k] for k in ("dtype", "stages", "circ_repeats", "microbatches",
                                        "max_rel_diff", "bitwise", "k1_launches", "ms",
                                        "sequential_ms")} for r in pp["schedule"]],
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
        launches_train=mm_train["launches"]["K1"],
        launches_full_remat_train=mm_train["full_remat"]["launches"]["K1"],
        launches_evaluate_multimodal=sum(r["launches"]["K1"] for r in mm_eval_runs),
        merge_launches_evaluate_multimodal=sum(r["launches"]["merge"] for r in mm_eval_runs),
        **demo_counts("multimodal"),
        launches_sp_clip=sp["multimodal"]["launches"]["K1"],
        merge_launches_sp_clip=sp["multimodal"]["launches"]["merge"],
        launches_chunk_mesh=chunk_server["chunk_mesh"]["launches"]["K1"],
        merge_launches_chunk_mesh=chunk_server["chunk_mesh"]["launches"]["merge"],
        sp_pieces=sp_pieces("mm_encoder", ("out_rel", "whole_k1_ms", "pieces_k1_ms",
                                           "merge_ms")),
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
                launches_http=serving["http"]["launches"],
                **file_counts("K1", "merge", cls_files,
                              files["cls"]["evaluate"]["launches"]["K1"],
                              "launches_evaluate_classification"))
        else:
            stack = dict(launches_export=serving["export"]["pixel"]["call"]["launches"])
        stack.update(demo_counts(f"img_classify_{prep}"))
        served = int8["serve"][prep].values()
        stack.update(launches_int8_serve=sum(r["launches"] for r in served),
                     merge_launches_int8_serve=sum(r["merge_launches"] for r in served))
        if site == "cls_1x1conv":
            server = chunk_server["server"]
            stack.update(**mesh_counts("K1", "merge", cls_mesh),
                         launches_mesh_evaluate=mesh["serve"]["evaluate_classification"][
                             "k1_launches"],
                         launches_mesh_server=server["launches"]["K1"],
                         merge_launches_mesh_server=server["launches"]["merge"],
                         launches_mesh_server_warmup=server["warmup_launches"]["K1"])
        if prep == int8["train"]["prep"]:
            stack.update(
                launches_int8_export=sum(c["launches"] for c in int8["export"]["calls"]),
                merge_launches_int8_export=sum(c["merge_launches"]
                                               for c in int8["export"]["calls"]),
                launches_int8_train=int8["train"]["launches"]["K1"],
                merge_launches_int8_train=int8["train"]["launches"]["merge"])
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
            **file_counts(kernel, "sum", flow_files),
            launches_ema_train=files["ema"]["launches"][kernel],
            sum_launches_ema_train=files["ema"]["launches"]["sum"],
            **sac_counts(kernel, "sum"),
            **mesh_counts(kernel, "sum", flow_mesh),
            **sp_counts(kernel, "sum"),
            **pp_counts(kernel, "sum"),
            sp_pieces=sp_pieces("flow_encoder", (
                "dk_rel", "dv_rel", "whole_bwd_ms", "pieces_bwd_ms") if kernel == "K2" else (
                "dq_rel", "whole_bwd_ms", "pieces_bwd_ms")),
            max_abs_err=max(r["max_abs_err"] for r in mine),
            **_site_sums(mine, lambda r: r["dtype"] == "bf16", SITE_LAUNCHES),
            sites=mine,
        ))
        entries.append(dict(
            name=f"{name}_d704",
            **common,
            launches=mm_train["launches"][kernel],
            sum_launches_train=mm_train["launches"]["sum"],
            launches_full_remat_train=mm_train["full_remat"]["launches"][kernel],
            sp_pieces=sp_pieces("mm_encoder", (
                "dk_rel", "dv_rel", "whole_bwd_ms", "pieces_bwd_ms") if kernel == "K2" else (
                "dq_rel", "whole_bwd_ms", "pieces_bwd_ms")),
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
                **(file_counts(kernel, "sum", cls_files) if site == "cls_1x1conv" else {}),
                **(dict(launches_int8_train=int8["train"]["launches"][kernel],
                        sum_launches_int8_train=int8["train"]["launches"]["sum"])
                   if prep == int8["train"]["prep"] else {}),
                **(mesh_counts(kernel, "sum", cls_mesh) if site == "cls_1x1conv" else {}),
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
    flow_sac = phase_flow_sac()
    torch.cuda.empty_cache()
    mm_serve = phase_mm_serve(phase_mm_model())
    torch.cuda.empty_cache()
    phase_mm_gradients()
    mm_train = phase_mm_train()
    torch.cuda.empty_cache()
    phase_mm_sac()
    torch.cuda.empty_cache()
    cls_serve = phase_cls()
    phase_lm()
    torch.cuda.empty_cache()
    cls_k1_train, cls_backward = phase_cls_kernels()
    torch.cuda.empty_cache()
    phase_cls_gradients()
    cls_train = phase_cls_train()
    lm_train = phase_lm_train()
    torch.cuda.empty_cache()
    phase_optimizers()
    phase_steps_per_call()
    phase_dropout()
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
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        flow_files = phase_flow_files(tmp)
        evaluated = phase_evaluate_flow(flow_files)
        del flow_files["model"]
        torch.cuda.empty_cache()
        cls_files = phase_cls_files(tmp)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        mm_eval = phase_evaluate_multimodal(tmp)
        torch.cuda.empty_cache()
        _, merged_weights = phase_lora(lm_train, tmp)
        phase_evaluate_mlm(tmp, merged_weights)
        torch.cuda.empty_cache()
        ema = phase_ema(train, tmp)
    files = dict(flow=flow_files, evaluate_flow=evaluated, cls=cls_files,
                 evaluate_multimodal=mm_eval, ema=ema, flow_sac=flow_sac)
    torch.cuda.empty_cache()
    t_int8 = time.perf_counter()
    int8_serve, int8_shapes = phase_int8_serve(smi, cls_serve)
    int8 = dict(serve=int8_serve, gemm=phase_int8_gemm(smi, int8_shapes),
                export=phase_int8_export(smi, serving["export"]),
                train=phase_int8_train(smi, cls_train))
    print(f"[int8] phases F-I in {time.perf_counter() - t_int8:.1f} s", flush=True)
    torch.cuda.empty_cache()
    t_demos = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        cwd = os.getcwd()
        os.chdir(tmp)  # the demos read ./sample_data and write into the working directory
        try:
            demos = phase_demos(serve, cls_serve, mm_serve)
        finally:
            os.chdir(cwd)
    torch.cuda.empty_cache()
    t_post = time.perf_counter()
    phase_postprocessor(smi)
    t_util = time.perf_counter()
    utilities = phase_utilities(smi, serve)
    t_end = time.perf_counter()
    print(f"[surface] phases J {t_post - t_demos:.1f} s, K {t_util - t_post:.1f} s,"
          f" L {t_end - t_util:.1f} s; J-L in {t_end - t_demos:.1f} s", flush=True)
    torch.cuda.empty_cache()
    mesh = dict(flow=phase_mesh_flow(smi, train))
    t_n = time.perf_counter()
    mesh.update(phase_mesh_cls_mlm(smi, cls_train, lm_train))
    t_o = time.perf_counter()
    mesh["serve"] = phase_mesh_serve(smi)
    t_mesh = time.perf_counter()
    print(f"[mesh] phases M {t_n - t_end:.1f} s, N {t_o - t_n:.1f} s, O {t_mesh - t_o:.1f} s;"
          f" M-O in {t_mesh - t_end:.1f} s", flush=True)
    torch.cuda.empty_cache()
    mesh["sp"] = phase_sp(smi, train)
    t_q = time.perf_counter()
    mesh["chunk_server"] = phase_chunk_mesh_and_server(smi)
    t_sp = time.perf_counter()
    print(f"[sp] phases P {t_q - t_mesh:.1f} s, Q {t_sp - t_q:.1f} s; P-Q in"
          f" {t_sp - t_mesh:.1f} s", flush=True)
    torch.cuda.empty_cache()
    mesh["pp"] = phase_pp(smi)
    print(f"[pp] phase R {time.perf_counter() - t_sp:.1f} s", flush=True)
    print(f"[done] {time.perf_counter() - t0:.1f} s")
    print(kernels_line(records, serve, backward + cls_backward, train, mm_serve, mm_train,
                       cls_serve, cls_train, cls_k1_train, buckets, serving, files, int8,
                       demos, utilities, mesh))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
