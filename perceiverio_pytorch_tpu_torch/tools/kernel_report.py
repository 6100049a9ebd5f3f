"""Quick report on the flash attention kernels, for kernel development.

On a machine with an NVIDIA GPU, from the repository root:

    python -m perceiverio_pytorch_tpu_torch.tools.kernel_report

  1. compiles each ``csrc/*.cu`` source with ``nvcc -Xptxas -v`` and prints
     every kernel's registers, spills and stack;
  2. holds the backward (K2 then K3, through ``flash_attention_backward``)
     against its plain version at small shapes, fp32 and bf16, with masks,
     strided inputs and ragged widths, printing the errors relative to
     max|grad| and the exact zeros of wiped rows and tail keys;
  3. times the backward (K2 + K3 together, CUDA events) at the three flow
     sites in fp32 at batch 1.

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
               (3, 65, 64, 3, 200, 100, True, False))


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
                elif "Used" in line or "spill" in line or "error" in line:
                    print(f"  {kernel}: {line.strip()}")


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
    out, lse = fa.flash_attention(q, k, v, return_lse=True, **kw)
    return (q, k, v, out, lse, randn(b, tq, h * dv)), kw


def check_small(gen):
    for dtype in (torch.float32, torch.bfloat16):
        for *shape, masked, strided in SMALL_CASES:
            args, kw = _case(*shape, dtype, masked, strided, gen)
            got = fa.flash_attention_backward(*args, **kw)
            want = fa.flash_attention_backward_reference(*(x.float() for x in args), **kw)
            torch.cuda.synchronize()
            parts = []
            for name, x, y in zip(("dq", "dk", "dv"), got, want):
                err = (x.float() - y).abs().max().item()
                parts.append(f"{name} {err / max(y.abs().max().item(), 1e-30):.2g}")
            if masked:
                tail = kw["kv_logical_len"]
                parts.append("wiped max " + str(max(
                    got[0][-1].abs().max().item(), got[0][~kw["q_mask"]].abs().max().item(),
                    got[1][:, tail:].abs().max().item(), got[2][:, tail:].abs().max().item())))
            print(f"[check] {tuple(shape)} {dtype} masked={masked} strided={strided}: "
                  + ", ".join(parts), flush=True)


def time_flow_sites(gen, reps=2):
    for shape in FLOW_SITES:
        args, kw = _case(*shape, torch.float32, False, False, gen)
        fa.flash_attention_backward(*args)  # warm-up
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(reps):
            fa.flash_attention_backward(*args)
        end.record()
        torch.cuda.synchronize()
        print(f"[time] {shape} fp32: K2+K3 {start.elapsed_time(end) / reps:.3f} ms", flush=True)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("kernel_report needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    ptxas_report()
    print(f"[build] {fa.build()}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    check_small(gen)
    time_flow_sites(gen)


if __name__ == "__main__":
    main()
