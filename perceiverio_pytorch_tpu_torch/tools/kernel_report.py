"""Quick report on the flash attention kernels, for kernel development.

On a machine with an NVIDIA GPU, from the repository root:

    python -m perceiverio_pytorch_tpu_torch.tools.kernel_report

  1. compiles each ``csrc/*.cu`` source with ``nvcc -Xptxas -v`` and prints
     every kernel instantiation's registers, spills, stack and shared memory
     (static; the dynamic size of the sm90 instantiations at the three flow
     sites, of K1's, K2's and K3's at the multimodal encoder, in both
     dtypes, of the four narrow-route instantiations of K1, K2 and K3 is
     printed beside, and after the build the long-KV K1, K2 and K3
     instantiations' as their sources compute them, with their ring slots:
     K1's three, K2's and K3's four, 704 wide too);
  2. counts the ``HGMMA`` (wgmma) instructions per kernel in
     ``cuobjdump -sass`` of the built libraries, which shows that the bf16
     forward and backward run on the tensor cores;
  3. holds K1 against its plain version at small shapes, fp32 and bf16,
     with masks, strided inputs, ragged widths, widths above 512 (split
     over two value-column chunks) and forced split counts;
  4. holds the backward (K2 then K3) against its plain version at the same
     kind of shapes (widths above 512 too), the bf16 kernels also at forced
     split counts;
  5. times K1 and K2, K3 apart, in both dtypes at the three flow sites at
     batch 1 and at the multimodal encoder (CUDA events), with each call's
     plan; K1 alone at the classification encoders (batch 16: the pixel
     variant's d = 261, the 1x1-conv variant's d = 512), with the loader
     its strides take;
  6. the full-width bf16 multimodal model (PERFORMANCE, seeded random
     weights, one random clip, 128 chunks): a clip's wall time and its
     encode's (host clock ending in a synchronize), with the query-pad fold
     and without; then one clip under ``torch.profiler``: device time by
     kernel, its sum against the wall time (the device's busy share) and
     the number of kernel launches;
  7. one full-scale bf16 training step of ``examples/train_multimodal.py``
     (16 chunks, remat): forward with the loss, backward and optimizer
     update timed apart, then one step under ``torch.profiler`` as in 6;
  8. one bf16 serving request of each full-width classifier (batch 16) and
     of the language model (batch 32, right-padded masks) under
     ``torch.profiler`` as in 6, after a warm-up request;
  9. K2 and K3 at the classification encoders at the training batch of 8
     (d = 261 and 512, and 261 padded to 264 for the load width), both
     dtypes, with each call's plan and load width (the dynamic shared memory
     of their sm90 instantiations is printed in 1);
 10. one full-scale bf16 training step each of
     ``examples/train_classification.py`` with the 1x1-conv variant (batch
     8, remat) and of ``examples/train_mlm.py`` (batch 8): timed in parts
     as in 7, then under ``torch.profiler`` as in 6;
 11. one batch-1 bf16 request of the full-width 1x1-conv classifier through
     its reloaded ``torch.export`` artifact beside the eager model: host
     wall time of each, the ATen ops each dispatches, the artifact's host
     time by Python function (``cProfile``: the input-spec pre-hook, the
     pytree flatten, the graph's own Python, the op calls), and each under
     ``torch.profiler`` as in 6 with the host time of its top ATen ops;
 12. the host time of decoding one 224x224 image request body as the HTTP
     front end's handler threads do: JSON and npz;
 13. one full-scale bf16 step of ``examples/train_mlm.py --lora 8`` beside
     the full fine-tune's (full, LoRA, LoRA, full), each timed in parts as
     in 7, then under ``torch.profiler`` as in 6;
 14. ``examples/evaluate_mlm.py --full-scale``'s batch (8 sequences, 307
     masked positions) through the masked rows alone and the full decode
     (partial, full, full, partial): the median wall of a call, and of a
     call with the copy of the rows to the host, a call's host enqueue,
     wait, device time (CUDA events) and copy apart, then each under
     ``torch.profiler`` as in 6;
 15. (``noise``) the flow self-attend stack in bf16 (``chip_smoke.py``'s
     full-width model and synthetic requests, batch 2; run from the
     repository root): the largest gradient of a key projection's bias,
     whose exact value is 0, against that projection's weight gradient, on
     12 inputs (the first is ``chip_smoke.py`` phase R(b)'s), under the
     planned backward (K2/K3's narrow route) and under the wgmma one (one
     forced split) on the same inputs;
 16. (``k1``) bf16 K1 alone at the main path's sites (the flow sites at
     batch 1 and 6, the classification encoders at 16, 8 and the server's
     buckets 1, 2, 4, the multimodal encoder), each timed as
     ``chip_smoke.py`` times a kernel: at least 3 launches and at least
     10 ms of them, with its route; at the classification encoders also
     SDPA over the same window and the device memory one K1 call takes at
     its peak beyond its inputs and output (the long-KV route's copies into
     aligned rows).  It needs nothing of K1 but ``flash_attention`` and
     ``launch_plan``, so run as a file it times the checkout that
     ``PYTHONPATH`` names: to compare two checkouts on one card, run
     ``PYTHONPATH=DIR python perceiverio_pytorch_tpu_torch/tools/kernel_report.py k1``
     with DIR the other one, this one, this one, the other one;
 17. (``bwd``) bf16 K2 and K3 alone at the main path's sites (the flow
     self-attend at batch 1 and 2, the flow encoder and decoder, the
     multimodal encoder, the classification encoders at 8, whose K2 and
     K3 take the long-KV route, as the multimodal encoder's do), timed as
     ``k1`` times K1, at the multimodal encoder also on the wgmma route
     (K2 unsplit in blocks of 16 keys, K3 in 10 key splits and two dQ
     column chunks: the plan that route had there), and, beside the
     flow sites, the classification and multimodal encoders, SDPA's
     backward (a
     backend's backward op alone where one takes the tensors, and forward
     and backward less the forward, the same windows); at every site K2
     then K3 as one backward calls them (K3 reading K2's copies into
     aligned rows where there are any; K2 or K3 timed alone makes its own),
     and at the long-KV sites the device memory one such backward takes at
     its peak and still holds after it, beyond its inputs; like ``k1`` it
     needs nothing but ``flash_attention`` and ``BackwardKernels``, so run
     as a file it times the checkout that ``PYTHONPATH`` names.

``python -m perceiverio_pytorch_tpu_torch.tools.kernel_report artifact``
(or any of ``SECTIONS``' names) runs only those parts, after the build;
``ptxas`` is parts 1 and 2.

It checks and prints; ``chip_smoke.py`` is the test that fails.
"""

from __future__ import annotations

import os
import re
import subprocess
import tempfile

import torch

from perceiverio_pytorch_tpu_torch.ops import flash_attention as fa

FLOW_SITES = ((1, 2048, 2048, 16, 32, 32), (1, 2048, 182528, 1, 322, 322),
              (1, 182528, 2048, 1, 512, 512))
SMALL_CASES = ((2, 100, 777, 2, 41, 64, True, False), (3, 50, 333, 2, 41, 24, True, False),
               (1, 130, 300, 1, 322, 322, False, False), (2, 70, 129, 1, 512, 512, True, False),
               (1, 256, 256, 16, 32, 32, False, False), (2, 90, 150, 3, 48, 48, False, True),
               (3, 65, 64, 3, 200, 100, True, False), (2, 90, 700, 3, 41, 41, True, True),
               (2, 70, 300, 1, 512, 300, True, False))
# Widths above 512: the multimodal encoder's, a ragged wide one (unaligned
# when strided) and a 704-wide Q with Dv 512.
WIDE_CASES = ((2, 100, 777, 1, 704, 704, True, False), (2, 90, 300, 2, 690, 690, True, True),
              (2, 100, 257, 1, 704, 512, True, False))
MULTIMODAL_SITE = (1, 784, 52097, 1, 704, 704)
# The classification encoders at the served batch: pixel and 1x1-conv; and
# the pixel site with its width padded to 264, a multiple of 8 (528-byte
# bf16 rows, which allow 16-byte loads where 261's allow 2).
CLASSIFICATION_SITES = ((16, 512, 50176, 1, 261, 261), (16, 512, 50176, 1, 512, 512),
                        (16, 512, 50176, 1, 264, 264))
# The same encoders at the training batch (examples/train_classification.py
# --full-scale), for K2 and K3.
CLASSIFICATION_TRAIN_SITES = ((8, 512, 50176, 1, 261, 261), (8, 512, 50176, 1, 512, 512),
                              (8, 512, 50176, 1, 264, 264))


def ptxas_report():
    with tempfile.TemporaryDirectory() as tmp:
        for name in sorted(os.listdir(fa._CSRC)):
            if not name.endswith(".cu"):
                continue
            proc = subprocess.run(
                [fa._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
                 "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
                 "-o", os.path.join(tmp, "k.so"), os.path.join(fa._CSRC, name)],
                capture_output=True, text=True)
            print(f"[ptxas] {name}: nvcc exit {proc.returncode}")
            kernel = None
            for line in (proc.stdout + proc.stderr).splitlines():
                entry = re.search(r"Compiling entry function '(\w+)'", line)
                if entry:
                    kernel = entry.group(1)
                elif ("Used" in line or "spill" in line or "error" in line
                      or "warning" in line or "C75" in line):
                    print(f"  {kernel}: {line.strip()}")
    # The flow sites, d = dv: (d, K1 <NV, BK>, K2 <NKW, NM>, K3 <NH, BK>) as
    # the launchers of the two sm90 sources pick them.
    for d, (nv, bk), (nkw, nm), (nh, bk3) in ((32, (16, 128), (32, 1), (16, 128)),
                                              (322, (168, 128), (16, 6), (168, 64)),
                                              (512, (256, 64), (16, 8), (256, 32))):
        dp = -(-d // 16) * 16
        smem = ((64 + bk) * dp + bk * 2 * nv + 64 * bk) * 2 + 4 * 64 * 4
        print(f"[smem] flash_fwd_sm90_kernel<{nv}, {bk}> at d = dv = {d}: {smem} bytes dynamic")
        smem = ((2 * 2 * nkw + 2 * 64) * 64 * nm + 2 * 64 * 2 * nkw) * 2
        print(f"[smem] flash_bwd_dkv_sm90_kernel<{nkw}, {nm}> at d = dv = {d}: {smem} bytes"
              " dynamic")
        smem = ((64 + bk3) * (2 * nh + dp) + 64 * bk3) * 2
        print(f"[smem] flash_bwd_dq_sm90_kernel<{nh}, {bk3}> at d = dv = {d}: {smem} bytes"
              " dynamic")
    # K1 at the multimodal encoder, d = dv = 704 in two column chunks of 352:
    # <176, 32> in bf16; the fp32 kernel's resident Q, K, P and V tiles.
    smem = ((64 + 32) * 704 + 32 * 352 + 64 * 32) * 2 + 4 * 64 * 4
    print(f"[smem] flash_fwd_sm90_kernel<176, 32> at d = dv = 704: {smem} bytes dynamic")
    smem = 4 * (704 * 64 + 32 * 68 + 64 * 68 + 64 * 64)
    print(f"[smem] flash_fwd_kernel<6> at d = dv = 704: {smem} bytes dynamic")
    # K2 and K3 at 704 off the long-KV route (short key ranges, a forced
    # split count): bf16 K2 <8, 11> (16 keys a block, 11 tiles of 64
    # columns), K3 <176, 16, chunked> (Q, dO, K and V at 704, dQ in chunks of
    # 352); fp32 K2 and K3 <6, chunked> (dK/dV or dQ in chunks of 384 + 320).
    smem = ((2 * 2 * 8 + 2 * 64) * 64 * 11 + 2 * 64 * 2 * 8) * 2
    print(f"[smem] flash_bwd_dkv_sm90_kernel<8, 11> at d = dv = 704: {smem} bytes dynamic")
    smem = ((64 + 16) * (704 + 704) + 64 * 16) * 2
    print(f"[smem] flash_bwd_dq_sm90_kernel<176, 16, chunked> at d = dv = 704: {smem} bytes"
          " dynamic")
    smem = 4 * (2 * 704 * 32 + 32 * 68 + 2 * 64 * 36 + 64 * 64 + 2 * 64)
    print(f"[smem] flash_bwd_dkv_kernel<6, chunked> at d = dv = 704: {smem} bytes dynamic")
    smem = 4 * (704 * 64 + 32 * 68 + 32 * 64 + 64 * 68 + 64 * 64)
    print(f"[smem] flash_bwd_dq_kernel<6, chunked> at d = dv = 704: {smem} bytes dynamic")
    # The narrow route: 128 query rows (K1, K3) or keys (K2) resident, 4
    # stages of 64 keys (K1, K3) or query rows with their lse and delta (K2),
    # 8 mbarriers.
    for dp, nv in ((32, 32), (32, 64), (64, 32), (64, 64)):
        smem = (128 * dp + 4 * 64 * (dp + nv)) * 2 + 2 * 4 * 8
        print(f"[smem] flash_fwd_narrow_kernel<{dp}, {nv}>: {smem} bytes dynamic")
        smem = (128 + 4 * 64) * (dp + nv) * 2 + 4 * 2 * 64 * 4 + 2 * 4 * 8
        print(f"[smem] flash_bwd_dkv_narrow_kernel<{dp}, {nv}>: {smem} bytes dynamic")
        smem = (128 + 4 * 64) * (dp + nv) * 2 + 2 * 4 * 8
        print(f"[smem] flash_bwd_dq_narrow_kernel<{dp}, {nv}>: {smem} bytes dynamic")
    # K2 and K3 at the classification encoders: d = 261 takes the flow
    # encoder's <16, 6> (6 tiles of 64 columns) and <168, 64> (Q and K tiles
    # of 336 columns, dO and V of 272); d = 512 the flow decoder's <16, 8> and
    # <256, 32>.
    for d, (nkw, nm), (nh, bk3) in ((261, (16, 6), (168, 64)), (512, (16, 8), (256, 32))):
        dp = -(-d // 16) * 16
        smem = ((2 * 2 * nkw + 2 * 64) * 64 * nm + 2 * 64 * 2 * nkw) * 2
        print(f"[smem] flash_bwd_dkv_sm90_kernel<{nkw}, {nm}> at d = dv = {d}: {smem} bytes"
              " dynamic")
        smem = ((64 + bk3) * (2 * nh + dp) + 64 * bk3) * 2
        print(f"[smem] flash_bwd_dq_sm90_kernel<{nh}, {bk3}> at d = dv = {d}: {smem} bytes"
              " dynamic")


def longkv_smem_report(paths):
    """The long-KV kernels' dynamic shared memory and ring slots, as their
    sources compute them (``flash_attention_fwd_longkv_smem``,
    ``flash_attention_bwd_longkv_smem``,
    ``flash_attention_bwd_dq_longkv_smem``), at the widths whose
    instantiations they launch."""
    import ctypes

    fwd = ctypes.CDLL(paths["fwd_longkv"])
    fwd.flash_attention_fwd_longkv_smem.argtypes = (ctypes.c_int, ctypes.POINTER(ctypes.c_int),
                                                     ctypes.POINTER(ctypes.c_int))
    lib = ctypes.CDLL(paths["bwd_longkv"])
    for fn in (lib.flash_attention_bwd_longkv_smem, lib.flash_attention_bwd_dq_longkv_smem):
        fn.argtypes = (ctypes.c_int, ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int))
    for width, nm in ((261, 5), (322, 6), (512, 8), (704, 11)):
        slots_k, slots_v = ctypes.c_int(0), ctypes.c_int(0)
        smem = fwd.flash_attention_fwd_longkv_smem(width, ctypes.byref(slots_k),
                                                   ctypes.byref(slots_v))
        print(f"[smem] flash_fwd_longkv_kernel<{nm}> at width {width}: K ring"
              f" {slots_k.value} slots, V ring {slots_v.value}, {smem} bytes dynamic")
        slots_q, slots_o = ctypes.c_int(0), ctypes.c_int(0)
        smem = lib.flash_attention_bwd_longkv_smem(width, ctypes.byref(slots_q),
                                                   ctypes.byref(slots_o))
        print(f"[smem] flash_bwd_dkv_longkv_kernel<{nm}> at width {width}: Q ring"
              f" {slots_q.value} slots, dO ring {slots_o.value}, {smem} bytes dynamic")
        smem = lib.flash_attention_bwd_dq_longkv_smem(width, ctypes.byref(slots_k),
                                                      ctypes.byref(slots_v))
        print(f"[smem] flash_bwd_dq_longkv_kernel<{nm}> at width {width}: K ring"
              f" {slots_k.value} slots, V ring {slots_v.value}, {smem} bytes dynamic")


def sass_report(paths):
    cuobjdump = os.path.join(os.path.dirname(fa._nvcc()), "cuobjdump")
    for name, path in sorted(paths.items()):
        proc = subprocess.run([cuobjdump, "-sass", path], capture_output=True, text=True)
        counts, kernel = {}, None
        for line in proc.stdout.splitlines():
            func = re.search(r"Function : (\S+)", line)
            if func:
                kernel = func.group(1)
            elif "HGMMA" in line:
                counts[kernel] = counts.get(kernel, 0) + 1
        print(f"[sass] {name}: cuobjdump exit {proc.returncode}, HGMMA per kernel: "
              f"{counts or 'none'}", flush=True)


def _case(b, tq, tk, h, d, dv, dtype, masked, strided, gen):
    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

    q, k, v = randn(b, tq, h, d), randn(b, tk, h, d), randn(b, tk, h, dv)
    if strided:  # [B, H, T, D] storage seen as [B, T, H, D]
        q, k, v = (x.transpose(1, 2).contiguous().transpose(1, 2) for x in (q, k, v))
    kw = {}
    if masked:
        kv_mask = torch.rand(b, tk, generator=gen, device="cuda") > 0.3
        kv_mask[-1] = False  # every key of the last batch entry
        kw = dict(kv_mask=kv_mask, kv_logical_len=tk - 50,
                  q_mask=torch.rand(b, tq, generator=gen, device="cuda") > 0.2)
    return (q, k, v), kw


def check_forward(gen):
    for dtype in (torch.float32, torch.bfloat16):
        for *shape, masked, strided in SMALL_CASES + WIDE_CASES:
            (q, k, v), kw = _case(*shape, dtype, masked, strided, gen)
            want, want_lse = fa.flash_attention_reference(
                q.float(), k.float(), v.float(), return_lse=True, **kw)
            parts = []
            for splits in (None, 1, 2, 64):
                out, lse = fa._flash_attention_cuda(
                    q, k, v, q_mask=kw.get("q_mask"), kv_mask=kw.get("kv_mask"),
                    softmax_scale=None, kv_logical_len=kw.get("kv_logical_len"),
                    return_lse=True, num_splits=splits)
                torch.cuda.synchronize()
                finite = torch.isfinite(want_lse)
                err = (out.float() - want).abs().max().item() / want.abs().max().item()
                lse_err = (lse[finite] - want_lse[finite]).abs().max().item()
                same_inf = torch.equal(finite, torch.isfinite(lse))
                plan = fa.launch_plan(q, k, v, kv_logical_len=kw.get("kv_logical_len"),
                                      num_splits=splits)
                parts.append(f"splits {plan['splits']}: out {err:.2g} lse {lse_err:.2g}"
                             f"{'' if same_inf else ' INF ROWS DIFFER'}")
            print(f"[check K1] {tuple(shape)} {dtype} masked={masked} strided={strided} "
                  f"route {plan['route']}: " + "; ".join(parts), flush=True)


def check_backward(gen):
    for dtype in (torch.float32, torch.bfloat16):
        for *shape, masked, strided in SMALL_CASES + WIDE_CASES:
            (q, k, v), kw = _case(*shape, dtype, masked, strided, gen)
            out, lse = fa.flash_attention(q, k, v, return_lse=True, **kw)
            args = (q, k, v, out, lse, torch.randn(out.shape, generator=gen,
                                                   device="cuda").to(dtype))
            want = fa.flash_attention_backward_reference(*(x.float() for x in args), **kw)
            splits_list = (None, 1, 2, 64) if dtype == torch.bfloat16 else (None,)
            for splits in splits_list:
                got = fa._flash_attention_backward_cuda(*args, num_splits=splits, **kw)
                torch.cuda.synchronize()
                plan = fa.backward_plan(q, k, v, kv_logical_len=kw.get("kv_logical_len"),
                                        num_splits=splits)
                parts = []
                for name, x, y in zip(("dq", "dk", "dv"), got, want):
                    err = (x.float() - y).abs().max().item()
                    parts.append(f"{name} {err / max(y.abs().max().item(), 1e-30):.2g}")
                if masked:
                    tail = kw["kv_logical_len"]
                    parts.append("wiped max " + str(max(
                        got[0][-1].abs().max().item(),
                        got[0][~kw["q_mask"]].abs().max().item(),
                        got[1][:, tail:].abs().max().item(),
                        got[2][:, tail:].abs().max().item())))
                print(f"[check K2/K3] {tuple(shape)} {dtype} masked={masked} "
                      f"strided={strided} route {plan['route']} splits "
                      f"{plan['dkv']['splits']}/{plan['dq']['splits']}: " + ", ".join(parts),
                      flush=True)


def _time(fn, reps):
    fn()  # warm-up
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def time_flow_sites(gen, reps=2):
    for shape in FLOW_SITES:
        for dtype in (torch.float32, torch.bfloat16):
            (q, k, v), _ = _case(*shape, dtype, False, False, gen)
            plan = fa.launch_plan(q, k, v)
            ms = _time(lambda: fa.flash_attention(q, k, v), reps)
            print(f"[time] {shape} {dtype}: K1 {ms:.3f} ms ({plan})", flush=True)
            out, lse = fa.flash_attention(q, k, v, return_lse=True)
            grad = torch.randn(out.shape, generator=gen, device="cuda").to(dtype)
            kernels = fa.BackwardKernels(q, k, v, out, lse, grad, q_mask=None, kv_mask=None,
                                         softmax_scale=None, kv_logical_len=None)
            ms2, ms3 = _time(kernels.dkv, reps), _time(kernels.dq, reps)
            print(f"[time] {shape} {dtype}: K2 {ms2:.3f} ms, K3 {ms3:.3f} ms "
                  f"({kernels.plan})", flush=True)
    for dtype in (torch.float32, torch.bfloat16):
        (q, k, v), _ = _case(*MULTIMODAL_SITE, dtype, False, False, gen)
        ms = _time(lambda: fa.flash_attention(q, k, v), reps)
        print(f"[time] {MULTIMODAL_SITE} {dtype}: K1 {ms:.3f} ms ({fa.launch_plan(q, k, v)})",
              flush=True)
        out, lse = fa.flash_attention(q, k, v, return_lse=True)
        grad = torch.randn(out.shape, generator=gen, device="cuda").to(dtype)
        kernels = fa.BackwardKernels(q, k, v, out, lse, grad, q_mask=None, kv_mask=None,
                                     softmax_scale=None, kv_logical_len=None)
        ms2, ms3 = _time(kernels.dkv, reps), _time(kernels.dq, reps)
        print(f"[time] {MULTIMODAL_SITE} {dtype}: K2 {ms2:.3f} ms, K3 {ms3:.3f} ms "
              f"({kernels.plan})", flush=True)
    for shape in CLASSIFICATION_SITES:
        for dtype in (torch.float32, torch.bfloat16):
            (q, k, v), _ = _case(*shape, dtype, False, False, gen)
            ms = _time(lambda: fa.flash_attention(q, k, v), reps)
            b, tq, tk, h, d, dv = shape
            tflops = 2 * b * tq * tk * h * (d + dv) / ms / 1e9
            print(f"[time] {shape} {dtype}: K1 {ms:.3f} ms, {tflops:.1f} TFLOP/s "
                  f"({fa.launch_plan(q, k, v)})", flush=True)


def time_classification_backward(gen, reps=2):
    """K2 and K3 per launch at the classification encoders at batch 8, with
    the width of the loads their strides allow."""
    for shape in CLASSIFICATION_TRAIN_SITES:
        for dtype in (torch.float32, torch.bfloat16):
            (q, k, v), _ = _case(*shape, dtype, False, False, gen)
            out, lse = fa.flash_attention(q, k, v, return_lse=True)
            grad = torch.randn(out.shape, generator=gen, device="cuda").to(dtype)
            kernels = fa.BackwardKernels(q, k, v, out, lse, grad, q_mask=None, kv_mask=None,
                                         softmax_scale=None, kv_logical_len=None)
            ms2, ms3 = _time(kernels.dkv, reps), _time(kernels.dq, reps)
            b, tq, tk, h, d, dv = shape
            pairs = b * tq * tk * h
            tflops2 = (4 * d + 4 * dv) * pairs / ms2 / 1e9
            tflops3 = (4 * d + 2 * dv) * pairs / ms3 / 1e9
            loads = (f", loads of {fa._copy_bytes(k, k.shape[3])} bytes"
                     if dtype == torch.bfloat16 else "")
            print(f"[time] {shape} {dtype}: K2 {ms2:.3f} ms ({tflops2:.1f} TFLOP/s), K3"
                  f" {ms3:.3f} ms ({tflops3:.1f} TFLOP/s){loads} ({kernels.plan})", flush=True)
            del q, k, v, out, lse, grad, kernels
            torch.cuda.empty_cache()


def profile_multimodal(n_chunks=128, top=12):
    import dataclasses
    import time

    from perceiverio_pytorch_tpu_torch import PERFORMANCE, MultiModalPerceiver

    gen = torch.Generator(device="cuda").manual_seed(1)
    video = torch.rand(1, 16, 3, 224, 224, generator=gen, device="cuda")
    audio = torch.rand(1, 30720, 1, generator=gen, device="cuda") * 2 - 1
    inputs = {"image": video, "audio": audio, "label": video.new_zeros(1, 700)}

    def wall(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    for fold in (False, True):  # the served policy last: it is profiled below
        model = MultiModalPerceiver(
            policy=dataclasses.replace(PERFORMANCE, fold_query_pad=fold),
            generator=torch.Generator().manual_seed(0)).eval()
        with torch.inference_mode():
            model(video, audio, n_chunks)  # warm-up
            clips = [wall(lambda: model(video, audio, n_chunks)) for _ in range(3)]
            encode = wall(lambda: model.perceiver.encode(inputs))
        print(f"[mm] bf16 fold_query_pad={fold}: clip {[round(c * 1e3, 2) for c in clips]} ms,"
              f" encode {encode * 1e3:.2f} ms", flush=True)
    with torch.inference_mode(), torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA]) as prof:
        seconds = wall(lambda: model(video, audio, n_chunks))
    _print_device_profile("mm profile", prof, seconds, top)


def _print_device_profile(label, prof, seconds, top):
    from torch.autograd import DeviceType

    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    device_us = sum(e.self_device_time_total for e in kernels)
    launches = sum(e.count for e in kernels)
    print(f"[{label}] wall {seconds * 1e3:.2f} ms, device {device_us / 1e3:.2f} ms"
          f" ({device_us / 1e4 / seconds:.1f}% busy), {launches} kernel launches", flush=True)
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:5d}  {e.key[:110]}",
              flush=True)


def profile_multimodal_training(top=15):
    """One full-scale bf16 training step of the port's train_multimodal
    example (16 chunks, remat), as ``_profile_train_step`` takes it."""
    from perceiverio_pytorch_tpu_torch.examples import train_multimodal

    trainer, state, batches = train_multimodal.setup(8, full_scale=True, metrics_path=None,
                                                     log_every=0)
    _profile_train_step("mm train", trainer, state, next(iter(batches())), top)


def profile_training(top=15):
    """One full-scale bf16 training step of the port's train_classification
    example with the 1x1-conv variant (batch 8, remat: K1, K2 and K3 at the
    encoder) and of its train_mlm example (batch 8, all sites dense), as
    ``_profile_train_step`` takes it."""
    from perceiverio_pytorch_tpu_torch import PrepType
    from perceiverio_pytorch_tpu_torch.examples import train_classification, train_mlm

    for label, make in (
            ("cls LEARNED_POS_1X1CONV train", lambda: train_classification.setup(
                8, full_scale=True, prep_type=PrepType.LEARNED_POS_1X1CONV, metrics_path=None,
                log_every=0)),
            ("lm train", lambda: train_mlm.setup(8, full_scale=True, metrics_path=None,
                                                 log_every=0))):
        trainer, state, batches, _ = make()
        _profile_train_step(label, trainer, state, next(iter(batches())), top)
        del trainer, state, batches
        torch.cuda.empty_cache()


def profile_lora(top=15):
    """One full-scale bf16 step of train_mlm with rank-8 LoRA adapters over
    the frozen model, beside the full fine-tune's, each as
    ``_profile_train_step`` takes it (full, LoRA, LoRA, full)."""
    from perceiverio_pytorch_tpu_torch.examples import train_mlm

    runs = {rank: train_mlm.setup(8, full_scale=True, metrics_path=None, log_every=0,
                                  lora_rank=rank) for rank in (0, 8)}
    for rank in (0, 8, 8, 0):
        trainer, state, batches, _ = runs[rank]
        _profile_train_step("lm train" if rank == 0 else f"lm lora {rank} train", trainer,
                            state, next(iter(batches())), top)


def _call_parts(fn):
    """One call of ``fn`` in parts, ms: (wall, host enqueue until it
    returns, the wait for the device after that, device time between CUDA
    events around it, the copy of its finished output to the host)."""
    import time

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    out = fn()
    end.record()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    out.float().cpu()
    t3 = time.perf_counter()
    return ((t2 - t0) * 1e3, (t1 - t0) * 1e3, (t2 - t1) * 1e3, start.elapsed_time(end),
            (t3 - t2) * 1e3)


def profile_mlm_eval(top=12, calls=20):
    """``examples/evaluate_mlm.py --full-scale``'s batch (bf16, 8 sequences
    of 2,048 bytes, 307 masked positions) through the masked rows alone
    (``predict_positions``) and the full decode, in the order partial, full,
    full, partial: the median host wall of ``calls`` model calls, each ending
    in a synchronize, and of as many calls with the copy of the scored rows
    to the host, as the script makes it; then one call of each under
    ``torch.profiler``."""
    from perceiverio_pytorch_tpu_torch import PERFORMANCE, LanguagePerceiver
    from perceiverio_pytorch_tpu_torch.examples.evaluate_mlm import MASK_TOKEN

    gen = torch.Generator(device="cuda").manual_seed(3)
    model = LanguagePerceiver(policy=PERFORMANCE, generator=torch.Generator().manual_seed(0))
    model.eval()
    tokens = torch.randint(0, 262, (8, 2048), generator=gen, device="cuda")
    positions = torch.randperm(2048, generator=gen, device="cuda")[:307].sort().values
    tokens[:, positions] = MASK_TOKEN
    valid = torch.ones_like(tokens, dtype=torch.bool)
    decodes = {"partial": lambda: model(tokens, valid, predict_positions=positions),
               "full": lambda: model(tokens, valid)[:, positions]}
    with torch.inference_mode():
        for fn in decodes.values():
            fn()  # warm-up
        for name in ("partial", "full", "full", "partial"):
            fn = decodes[name]
            call = _median_wall_ms(fn, calls)
            copied = _median_wall_ms(lambda: fn().float().cpu(), calls)
            parts = sorted(_call_parts(fn) for _ in range(calls))[calls // 2]
            print(f"[mlm eval] {name}: call {call:.2f} ms, with the copy to the host"
                  f" {copied:.2f} ms; the median call's parts: enqueue {parts[1]:.2f},"
                  f" wait {parts[2]:.2f}, device {parts[3]:.2f}, copy of the finished"
                  f" rows {parts[4]:.2f} ms (of {calls})", flush=True)
        for name, fn in decodes.items():
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                seconds = _median_wall_ms(fn, 1) / 1e3
            _print_device_profile(f"mlm eval {name} profile", prof, seconds, top)


def _profile_train_step(label, trainer, state, batch, top):
    """A training step's forward with the loss, its backward and its
    optimizer update timed apart (host clock ending in a synchronize, after
    a warm-up step), twice, then one whole step under ``torch.profiler``."""
    import time

    model, opt = state.model, state.optimizer

    def step():
        parts = []
        for phase in ("forward", "backward", "update"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if phase == "forward":
                opt.zero_grad(set_to_none=True)
                loss = trainer.loss_fn(model, *batch)
            elif phase == "backward":
                loss.backward()
            else:
                trainer.tx.update(opt)
                state.step += 1
            torch.cuda.synchronize()
            parts.append(time.perf_counter() - t0)
        return parts

    model.train()
    step()  # warm-up
    for _ in range(2):
        forward, backward, update = step()
        print(f"[{label}] bf16 step: forward+loss {forward * 1e3:.2f} ms, backward"
              f" {backward * 1e3:.2f} ms, update {update * 1e3:.2f} ms", flush=True)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        seconds = sum(step())
    _print_device_profile(f"{label} profile", prof, seconds, top)


def profile_serving(top=12):
    """One bf16 request of each new served model under ``torch.profiler``,
    after a warm-up request: the three classifiers at batch 16, the language
    model at batch 32 (the second sequence of each pair right-padded)."""
    import time

    from perceiverio_pytorch_tpu_torch import (PERFORMANCE, ClassificationPerceiver,
                                               LanguagePerceiver, PrepType)

    gen = torch.Generator(device="cuda").manual_seed(2)
    img = torch.rand(16, 3, 224, 224, generator=gen, device="cuda") * 2 - 1
    ids = torch.randint(0, 262, (32, 2048), generator=gen, device="cuda")
    mask = torch.arange(2048, device="cuda")[None] < torch.tensor([[2048], [1600]] * 16,
                                                                  device="cuda")
    cases = [(f"cls {prep.name}", ClassificationPerceiver(prep_type=prep, policy=PERFORMANCE),
              (img,)) for prep in PrepType]
    cases.append(("lm", LanguagePerceiver(policy=PERFORMANCE), (ids, mask)))
    for label, model, args in cases:
        model.eval()
        with torch.inference_mode():
            model(*args)  # warm-up
            torch.cuda.synchronize()
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                model(*args)
                torch.cuda.synchronize()
                seconds = time.perf_counter() - t0
        _print_device_profile(f"{label} profile", prof, seconds, top)
        del model
        torch.cuda.empty_cache()


def _median_wall_ms(fn, calls):
    import time

    times = []
    for _ in range(calls):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return sorted(times)[calls // 2] * 1e3


def profile_artifact(top=10, calls=10):
    """One batch-1 bf16 request of the full-width 1x1-conv classifier
    through the artifact ``export_apply`` writes and ``load_exported``
    reads back, beside the eager model on the same weights and image: the
    median host wall time of ``calls`` requests each (after warm-up); the
    ATen ops each dispatches, counted by a dispatch mode; the artifact's
    host time by Python function under ``cProfile`` (``calls`` requests);
    then one request of each under ``torch.profiler``: device time,
    launches, and the host self time of the top ATen ops."""
    import cProfile
    import collections
    import io
    import pstats
    import time

    from torch.autograd import DeviceType
    from torch.utils._python_dispatch import TorchDispatchMode

    from perceiverio_pytorch_tpu_torch import (PERFORMANCE, ClassificationPerceiver, PrepType,
                                               export_apply, load_exported)
    from perceiverio_pytorch_tpu_torch.utils.params import cast_variables_for_inference

    class _Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = collections.Counter()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops[str(func)] += 1
            return func(*args, **(kwargs or {}))

    model = ClassificationPerceiver(prep_type=PrepType.LEARNED_POS_1X1CONV, policy=PERFORMANCE,
                                    generator=torch.Generator().manual_seed(0)).eval()
    weights = cast_variables_for_inference(model)
    fn = load_exported(export_apply(model, weights, torch.zeros(2, 3, 224, 224, device="cuda"),
                                    batch_polymorphic=True))
    img = torch.rand(1, 3, 224, 224, generator=torch.Generator().manual_seed(3)).cuda()
    cases = (("artifact", lambda: fn(weights, img)),
             ("eager", lambda: torch.func.functional_call(model, weights, (img,))))
    with torch.inference_mode():
        for label, call in cases:
            for _ in range(3):
                call()  # warm-up
            wall = _median_wall_ms(call, calls)
            with _Count() as count:
                call()
            torch.cuda.synchronize()
            print(f"[artifact] {label} batch 1: median wall {wall:.2f} ms over {calls} calls,"
                  f" {sum(count.ops.values())} ATen ops: {count.ops.most_common(6)}", flush=True)
        prof = cProfile.Profile()
        t0 = time.perf_counter()
        prof.enable()
        for _ in range(calls):
            cases[0][1]()
        torch.cuda.synchronize()
        prof.disable()
        wall = (time.perf_counter() - t0) / calls
        text = io.StringIO()
        pstats.Stats(prof, stream=text).sort_stats("tottime").print_stats(top)
        print(f"[artifact] cProfile, {calls} artifact calls ({wall * 1e3:.2f} ms a call under"
              f" the profiler), by own time:\n{text.getvalue()}", flush=True)
        text = io.StringIO()
        pstats.Stats(prof, stream=text).sort_stats("cumulative").print_stats(top)
        print(f"[artifact] cProfile by cumulative time:\n{text.getvalue()}", flush=True)
        for label, call in cases:
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                    torch.profiler.ProfilerActivity.CUDA]) as p:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                call()
                torch.cuda.synchronize()
                seconds = time.perf_counter() - t0
            _print_device_profile(f"artifact {label} profile", p, seconds, top)
            ops = [e for e in p.key_averages() if e.device_type == DeviceType.CPU]
            print(f"[artifact {label} host] ATen ops' host self time"
                  f" {sum(e.self_cpu_time_total for e in ops) / 1e3:.2f} ms; top:", flush=True)
            for e in sorted(ops, key=lambda e: -e.self_cpu_time_total)[:top]:
                print(f"  {e.self_cpu_time_total / 1e3:9.3f} ms  x{e.count:5d}  {e.key[:90]}",
                      flush=True)


def time_codecs(calls=10):
    """Median host time of decoding one [3, 224, 224] float32 request body
    as ``HttpFrontend``'s handler does, ``calls`` times each: JSON
    (``json.loads``, then ``decode_inputs``) and npz (``decode_npz``);
    with the bodies' bytes."""
    import json
    import time

    import numpy as np

    from perceiverio_pytorch_tpu_torch.serving_http import (decode_inputs, decode_npz,
                                                            encode_npz)

    img = np.random.RandomState(0).uniform(-1, 1, (3, 224, 224)).astype(np.float32)
    bodies = dict(json=json.dumps({"inputs": {"image": img.tolist()}}).encode(),
                  npz=encode_npz({"image": img}))
    decoders = dict(json=lambda b: decode_inputs(json.loads(b)["inputs"]), npz=decode_npz)
    for name, body in bodies.items():
        times = []
        for _ in range(calls):
            t0 = time.perf_counter()
            out = decoders[name](body)
            times.append(time.perf_counter() - t0)
        if not np.array_equal(out["image"], img):
            raise AssertionError(f"{name}: the decoded image differs")
        print(f"[codecs] {name}: {len(body)} bytes, decode median "
              f"{sorted(times)[calls // 2] * 1e3:.2f} ms over {calls}", flush=True)


def key_bias_noise():
    """Section 15: the key biases' gradient noise of the flow self-attend
    stack through K1, K2 and K3: the planned backward, then the wgmma one
    (a forced split count of 1) on the same inputs."""
    import functools
    from unittest import mock

    import chip_smoke
    from perceiverio_pytorch_tpu_torch import PERFORMANCE, FlowInference

    model = chip_smoke._flow_model(PERFORMANCE)
    stack = model.perceiver._encoder.self_attends
    gen = torch.Generator().manual_seed(chip_smoke.SEED + 2)
    frames = [chip_smoke._smooth_frame(gen, 436, 1024) for _ in range(4)]

    def stack_input(i):  # chip_smoke.py phase 6's request i (1 to 3)
        seen = []
        hook = stack.register_forward_pre_hook(lambda m, a: seen.append(a[0].detach()))
        with torch.inference_mode():
            FlowInference(model, device="cuda")(
                frames[i][None],
                torch.roll(frames[i], shifts=(i + 1, 2 * i + 1), dims=(1, 2))[None])
        hook.remove()
        return seen[0].clone()

    def ratio(x, g):
        model.zero_grad(set_to_none=True)
        (stack(x.clone().requires_grad_()).float() * g).sum().backward()
        torch.cuda.synchronize()
        grads = {n: p.grad.float() for n, p in stack.named_parameters()}
        return max(grads[n].abs().max().item()
                   / grads[n[:-len("bias")] + "weight"].abs().max().item()
                   for n in grads if n.endswith("proj_k.bias"))

    wgmma = functools.partial(fa._flash_attention_backward_cuda, num_splits=1)
    ratios = {"planned": [], "wgmma": []}
    for i in range(1, 4):
        latents = stack_input(i)
        for seed in range(4):
            ggen = torch.Generator(device="cuda").manual_seed(chip_smoke.SEED + 18 + seed)
            x = latents[2 * seed % latents.shape[0]:][:2].detach().clone()
            g = torch.randn(x.shape, generator=ggen, device="cuda")
            ratios["planned"].append(ratio(x, g))
            with mock.patch.object(fa, "_flash_attention_backward_cuda", wgmma):
                ratios["wgmma"].append(ratio(x, g))
            print(f"[noise] request {i}, tiles {2 * seed % 6}-{2 * seed % 6 + 1}, upstream"
                  f" seed {chip_smoke.SEED + 18 + seed}: {ratios['planned'][-1]:.4f}"
                  f" (wgmma backward {ratios['wgmma'][-1]:.4f})", flush=True)
    route = fa.backward_plan(*(torch.empty(2, 2048, 16, 32, dtype=torch.bfloat16,
                                           device="meta"),) * 3)["route"]
    for name, found in ratios.items():
        vals = sorted(found)
        print(f"[noise] {name} backward ({route if name == 'planned' else 'sm90_wgmma'}),"
              f" {len(vals)} inputs, key-bias |grad| / weight's: median"
              f" {vals[len(vals) // 2]:.4f}, range {vals[0]:.4f}-{vals[-1]:.4f}, above 0.1:"
              f" {sum(v > 0.1 for v in vals)}", flush=True)


def _window_ms(call, reps, window_ms):
    """``call``'s mean over at least ``reps`` launches and at least
    ``window_ms`` of them (``chip_smoke.timing_reps``), and the count."""
    import math

    n = max(reps, math.ceil(window_ms / max(_time(call, 1), 1e-3)))
    return _time(call, n), n


def time_k1_sites(reps=3, window_ms=10.0):
    """Section 16: bf16 K1 alone at the main path's sites, each beside one
    call's peak memory beyond its output, SDPA over the same window and the
    host time of ``launch_plan`` (the mean of 2,000 calls, which every K1
    call makes)."""
    import time

    gen = torch.Generator(device="cuda").manual_seed(0)
    sites = (FLOW_SITES + tuple((6,) + shape[1:] for shape in FLOW_SITES)
             + CLASSIFICATION_SITES[:2] + CLASSIFICATION_TRAIN_SITES[:2]
             + tuple((b, 512, 50176, 1, d, d) for d in (261, 512) for b in (1, 2, 4))
             + (MULTIMODAL_SITE,))
    import torch.nn.functional as F

    for shape in sites:
        (q, k, v), _ = _case(*shape, torch.bfloat16, False, False, gen)
        ms, n = _window_ms(lambda: fa.flash_attention(q, k, v), reps, window_ms)
        plan = fa.launch_plan(q, k, v)
        start = time.perf_counter()
        for _ in range(2000):
            fa.launch_plan(q, k, v)
        plan_us = (time.perf_counter() - start) / 2000 * 1e6
        line = (f"[k1] {shape}: {ms:.4f} ms over {n} launches ({plan['route']}, splits"
                f" {plan['splits']}, blocks {plan['blocks']}, loader {plan['loader']}, copies"
                f" {plan.get('copies', ())}); launch_plan {plan_us:.1f} us")
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = fa.flash_attention(q, k, v)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base - out.numel() * out.element_size()
        del out
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        try:
            sdpa, _ = _window_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt), reps,
                                 window_ms)
            sdpa = f"{sdpa:.4f} ms"
        except RuntimeError as exc:  # no SDPA backend takes them
            sdpa = f"none ({exc})"[:200]
        line += f"; one call's peak beyond its output {peak / 1e6:.1f} MB; SDPA {sdpa}"
        print(line, flush=True)
        del q, k, v
        torch.cuda.empty_cache()


def _sdpa_backward_op(q, k, v, grad):
    """SDPA's backward as one backend op on these tensors, after its forward
    gave the output and lse: the flash backend's where it takes them (bf16
    heads up to 256 wide), else the memory-efficient backend's; None where
    neither takes them."""
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    b, tq, h = q.shape[:3]
    g = grad.view(b, tq, h, -1).transpose(1, 2)
    scale = q.shape[3] ** -0.5
    try:
        if max(q.shape[3], v.shape[3]) <= 256:
            out, lse, cq, ck, mq, mk, seed, offset, _ = (
                torch.ops.aten._scaled_dot_product_flash_attention(
                    qt, kt, vt, 0.0, False, False, scale=scale))
            return "flash", lambda: torch.ops.aten._scaled_dot_product_flash_attention_backward(
                g, qt, kt, vt, out, lse, cq, ck, mq, mk, 0.0, False, seed, offset, scale=scale)
        out, lse, seed, offset = torch.ops.aten._scaled_dot_product_efficient_attention(
            qt, kt, vt, None, True, 0.0, False, scale=scale)
        return "efficient", lambda: (
            torch.ops.aten._scaled_dot_product_efficient_attention_backward(
                g, qt, kt, vt, None, out, lse, seed, offset, 0.0, [True, True, True, False],
                False, scale=scale))
    except (RuntimeError, TypeError) as exc:  # no backend takes them, or another signature
        print(f"[bwd] no SDPA backend op at {tuple(q.shape)} x {tuple(k.shape)}: {exc}"[:300],
              flush=True)
        return None


def _backward_memory(q, k, v, out, lse, grad):
    """The device memory (MB) one backward (K2 then K3) on these tensors
    takes at its peak and still holds after K3, while its
    ``BackwardKernels`` lives, beyond what was allocated before it."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    kernels = fa.BackwardKernels(q, k, v, out, lse, grad, q_mask=None, kv_mask=None,
                                 softmax_scale=None, kv_logical_len=None)
    kernels.dkv()
    kernels.dq()
    torch.cuda.synchronize()
    peak, held = torch.cuda.max_memory_allocated() - base, torch.cuda.memory_allocated() - base
    del kernels
    return peak / 1e6, held / 1e6


def time_bwd_sites(reps=3, window_ms=10.0):
    """Section 17: bf16 K2 and K3 alone at the main path's sites, and SDPA's
    backward beside the flow sites and the classification encoders: a
    backend's backward op alone where one takes the tensors
    (``_sdpa_backward_op``), and forward and backward less the forward, each
    over the same window."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(0)
    self_sites = (FLOW_SITES[0], (2,) + FLOW_SITES[0][1:])
    sites = self_sites + FLOW_SITES[1:] + (MULTIMODAL_SITE,) + CLASSIFICATION_TRAIN_SITES[:2]
    sdpa_sites = self_sites + FLOW_SITES[1:] + CLASSIFICATION_TRAIN_SITES + (MULTIMODAL_SITE,)
    for shape in sites:
        (q, k, v), _ = _case(*shape, torch.bfloat16, False, False, gen)
        out, lse = fa.flash_attention(q, k, v, return_lse=True)
        grad = torch.randn(out.shape, generator=gen, device="cuda").to(torch.bfloat16)
        kernels = fa.BackwardKernels(q, k, v, out, lse, grad, q_mask=None, kv_mask=None,
                                     softmax_scale=None, kv_logical_len=None)
        (k2, n2), (k3, n3), (both, n) = (
            _window_ms(call, reps, window_ms)
            for call in (kernels.dkv, kernels.dq, lambda: (kernels.dkv(), kernels.dq())))
        line = (f"[bwd] {shape}: K2 {k2:.4f} ms over {n2}, K3 {k3:.4f} ms over {n3}, K2 + K3"
                f" {k2 + k3:.4f}, K2 then K3 {both:.4f} ms over {n} ({kernels.plan['route']}")
        if kernels.plan["route"] == "sm90_longkv":
            peak, held = _backward_memory(q, k, v, out, lse, grad)
            line += (f", loader {kernels.plan['dkv'].get('loader')}, copies"
                     f" {kernels.plan['dkv'].get('copies')}; one backward's memory: peak"
                     f" {peak:.1f} MB, held after K3 {held:.1f} MB")
        line += ")"
        if shape == MULTIMODAL_SITE and kernels.plan["route"] == "sm90_longkv":
            # The wgmma route's plan at this site: K2 unsplit (a forced split
            # count of 1), K3 over 10 key splits.
            wk2 = fa.BackwardKernels(q, k, v, out, lse, grad, q_mask=None, kv_mask=None,
                                     softmax_scale=None, kv_logical_len=None, num_splits=1)
            wk3 = fa.BackwardKernels(q, k, v, out, lse, grad, q_mask=None, kv_mask=None,
                                     softmax_scale=None, kv_logical_len=None,
                                     num_splits=kernels.plan["dq"]["splits"])
            (w2, m2), (w3, m3), (wboth, m) = (
                _window_ms(call, reps, window_ms)
                for call in (wk2.dkv, wk3.dq, lambda: (wk2.dkv(), wk3.dq())))
            line += (f"; wgmma route: K2 {w2:.4f} ms over {m2}, K3 {w3:.4f} ms over {m3},"
                     f" K2 then K3 {wboth:.4f} ms over {m}")
            del wk2, wk3
        if shape in sdpa_sites:
            op = _sdpa_backward_op(q, k, v, grad)
            if op is not None:
                ms, n = _window_ms(op[1], reps, window_ms)
                line += f"; SDPA {op[0]} backward op {ms:.4f} ms over {n}"
            qt, kt, vt = (x.detach().transpose(1, 2).requires_grad_() for x in (q, k, v))
            g = grad.view(*out.shape[:2], shape[3], -1).transpose(1, 2)
            fwd = lambda: F.scaled_dot_product_attention(qt, kt, vt)  # noqa: E731
            with torch.enable_grad():
                total, _ = _window_ms(lambda: torch.autograd.grad(fwd(), (qt, kt, vt), g),
                                      reps, window_ms)
                forward, _ = _window_ms(fwd, reps, window_ms)
            line += (f"; SDPA forward + backward less forward {total - forward:.4f} ms"
                     f" ({total:.4f} - {forward:.4f})")
        print(line, flush=True)
        del q, k, v, out, lse, grad, kernels
        torch.cuda.empty_cache()


SECTIONS = ("ptxas", "forward", "backward", "flow", "mm", "mm_train", "serving",
            "cls_backward", "training", "artifact", "codecs", "lora", "mlm_eval", "noise",
            "k1", "bwd")


def main(argv=None):
    import sys

    if not torch.cuda.is_available():
        raise SystemExit("kernel_report needs a CUDA device")
    sections = list(sys.argv[1:] if argv is None else argv)
    if any(name not in SECTIONS for name in sections):
        raise SystemExit(f"unknown sections {sections}; choose from {SECTIONS}")
    torch.backends.cuda.matmul.allow_tf32 = False
    sections = sections or list(SECTIONS)
    if "ptxas" in sections:
        ptxas_report()
    paths = fa.build()
    print(f"[build] {paths}", flush=True)
    if "ptxas" in sections:
        longkv_smem_report(paths)
        sass_report(paths)
    gen = torch.Generator(device="cuda").manual_seed(0)
    runs = dict(ptxas=lambda: None, forward=lambda: check_forward(gen),
                backward=lambda: check_backward(gen),
                flow=lambda: time_flow_sites(gen), mm=profile_multimodal,
                mm_train=profile_multimodal_training, serving=profile_serving,
                cls_backward=lambda: time_classification_backward(gen),
                training=profile_training, artifact=profile_artifact, codecs=time_codecs,
                lora=profile_lora, mlm_eval=profile_mlm_eval, noise=key_bias_noise,
                k1=time_k1_sites, bwd=time_bwd_sites)
    for name in sections:
        runs[name]()


if __name__ == "__main__":
    main()
