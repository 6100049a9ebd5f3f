"""Flash attention forward: a hand-written CUDA kernel and its plain version.

Counterpart of ``perceiverio_pytorch_tpu/ops/pallas/flash_attention.py``
(``_flash_kernel`` and its wrappers).  The kernel is
``csrc/flash_attention_fwd.cu``; the source note at its head says what
bounds it on an H100 and what its design does about that.

  * ``flash_attention`` keeps the JAX signature and layout: q [B,Tq,H,Dqk],
    k [B,Tk,H,Dqk], v [B,Tk,H,Dv] -> [B,Tq,H*Dv] (and lse [B,H,Tq]).
    A CUDA tensor goes to the kernel, or the call raises; a CPU tensor goes
    to the plain version, the counterpart of Pallas ``interpret=True``.
  * ``flash_attention_reference`` is that plain version: fp32, chunked over
    query rows so that a flow-size call never holds the whole [Tq, Tk]
    logit matrix.
  * ``LAUNCHES`` counts kernel launches (never plain-version calls).

The kernel is built with ``nvcc`` at first use, from the sources in this
package, into ``build/kernels/`` under the repository root, and bound with
``ctypes``.  Only the forward exists: the backward kernels (K2/K3 of the
JAX package) come with the training slice.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import shutil
import subprocess
import threading
from typing import Optional

import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
_SOURCE = os.path.join(os.path.dirname(_HERE), "csrc", "flash_attention_fwd.cu")
_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build", "kernels")

# Limits of the kernel's shared-memory plan (see the .cu source note).
MAX_HEAD_DIM = 512

# Kernel launches since import (or since the caller last reset it).
LAUNCHES = 0

_lib = None
_lib_lock = threading.Lock()
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def build() -> str:
    """Compile the kernel (if its source changed) and return the .so path."""
    with open(_SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    os.makedirs(_BUILD_DIR, exist_ok=True)
    lib_path = os.path.join(_BUILD_DIR, f"flash_attention_fwd_{digest}.so")
    if not os.path.exists(lib_path):
        tmp = f"{lib_path}.{os.getpid()}.tmp"
        cmd = [
            _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
            "-O3", "-shared", "-Xcompiler", "-fPIC", "-o", tmp, _SOURCE,
        ]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                "nvcc failed to build the flash attention kernel:\n"
                + proc.stdout + proc.stderr
            )
        os.replace(tmp, lib_path)
    return lib_path


def _load():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            fn = lib.flash_attention_fwd
            fn.argtypes = (
                [ctypes.c_void_p] * 7  # q, k, v, kv_mask, q_mask, out, lse
                + [ctypes.c_int] * 8  # dtype, B, H, Tq, Tk, kv_len, D, Dv
                + [ctypes.c_longlong] * 9  # q/k/v strides (batch, token, head)
                + [ctypes.c_float, ctypes.c_void_p]  # scale, stream
            )
            fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def _check_inputs(q, k, v, q_mask, kv_mask):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be [B, T, H, D]")
    b, tq, h, d = q.shape
    if (k.shape[0], k.shape[2], k.shape[3]) != (b, h, d):
        raise ValueError(f"k shape {tuple(k.shape)} does not match q {tuple(q.shape)}")
    if v.shape[:3] != k.shape[:3]:
        raise ValueError(f"v shape {tuple(v.shape)} does not match k {tuple(k.shape)}")
    if q_mask is not None and tuple(q_mask.shape) != (b, tq):
        raise ValueError(f"q_mask must be [B, Tq] = {(b, tq)}")
    if kv_mask is not None and tuple(kv_mask.shape) != (b, k.shape[1]):
        raise ValueError(f"kv_mask must be [B, Tk] = {(b, k.shape[1])}")


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    q_mask: Optional[torch.Tensor] = None,
    kv_mask: Optional[torch.Tensor] = None,
    softmax_scale: Optional[float] = None,
    kv_logical_len: Optional[int] = None,
    return_lse: bool = False,
):
    """Flash multi-head attention forward.

    Args:
      q: [B, Tq, H, Dqk]; k: [B, Tk, H, Dqk]; v: [B, Tk, H, Dv].
      q_mask: optional [B, Tq] bool; invalid rows are wiped to zero.
      kv_mask: optional [B, Tk] bool; invalid keys are excluded.
      softmax_scale: logit scale, applied after the matmul; 1/sqrt(Dqk)
        by default.
      kv_logical_len: keys at or beyond this index are masked.
      return_lse: also return the log-sum-exp [B, H, Tq] in fp32, +inf on
        rows whose keys are all masked.

    Returns:
      [B, Tq, H*Dv] in q's dtype (and lse when return_lse).
    """
    _check_inputs(q, k, v, q_mask, kv_mask)
    if q.device.type == "cpu":
        return flash_attention_reference(
            q, k, v, q_mask=q_mask, kv_mask=kv_mask,
            softmax_scale=softmax_scale, kv_logical_len=kv_logical_len,
            return_lse=return_lse,
        )
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on CUDA or CPU, not {q.device}")
    return _flash_attention_cuda(
        q, k, v, q_mask=q_mask, kv_mask=kv_mask,
        softmax_scale=softmax_scale, kv_logical_len=kv_logical_len,
        return_lse=return_lse,
    )


def _flash_attention_cuda(q, k, v, *, q_mask, kv_mask, softmax_scale,
                          kv_logical_len, return_lse):
    global LAUNCHES
    if torch.is_grad_enabled() and (
        q.requires_grad or k.requires_grad or v.requires_grad
    ):
        raise NotImplementedError(
            "flash_attention has no backward yet: the dK/dV and dQ kernels"
            " (K2/K3) come with the training slice"
        )
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != q.dtype:
            raise ValueError(f"{name} is {t.dtype}, q is {q.dtype}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must be contiguous in its last dim")
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"flash_attention takes fp32 or bf16, not {q.dtype}")
    b, tq, h, d = q.shape
    tk, dv = k.shape[1], v.shape[3]
    if not (1 <= d <= MAX_HEAD_DIM and 1 <= dv <= MAX_HEAD_DIM):
        raise ValueError(
            f"head widths Dqk={d}, Dv={dv} exceed the kernel's {MAX_HEAD_DIM}"
        )
    kv_len = tk if kv_logical_len is None else min(int(kv_logical_len), tk)
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(d)

    masks = []
    for name, m in (("kv_mask", kv_mask), ("q_mask", q_mask)):
        if m is None:
            masks.append(None)
            continue
        if m.device != q.device:
            raise ValueError(f"{name} is on {m.device}, q on {q.device}")
        masks.append(m.to(torch.bool).contiguous())
    kv_mask_c, q_mask_c = masks

    out = torch.empty((b, tq, h * dv), dtype=q.dtype, device=q.device)
    lse = (
        torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
        if return_lse else None
    )
    if b * tq * h == 0:
        return (out, lse) if return_lse else out

    lib = _load()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            kv_mask_c.data_ptr() if kv_mask_c is not None else None,
            q_mask_c.data_ptr() if q_mask_c is not None else None,
            out.data_ptr(), lse.data_ptr() if lse is not None else None,
            _DTYPE_CODES[q.dtype], b, h, tq, tk, kv_len, d, dv,
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            float(scale), stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_attention_fwd launch failed: CUDA error {err}")
    LAUNCHES += 1
    return (out, lse) if return_lse else out


def flash_attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    q_mask: Optional[torch.Tensor] = None,
    kv_mask: Optional[torch.Tensor] = None,
    softmax_scale: Optional[float] = None,
    kv_logical_len: Optional[int] = None,
    return_lse: bool = False,
    max_chunk_elems: int = 1 << 26,
):
    """Plain PyTorch version of the kernel: same signature and semantics.

    Runs in fp32, ``max_chunk_elems`` logits at a time (256 MB in fp32),
    chunked over query rows.  Returns the output in q's dtype.
    """
    _check_inputs(q, k, v, q_mask, kv_mask)
    b, tq, h, d = q.shape
    tk, dv = k.shape[1], v.shape[3]
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(d)
    kv_len = tk if kv_logical_len is None else min(int(kv_logical_len), tk)

    valid = torch.arange(tk, device=q.device) < kv_len  # [Tk]
    valid = valid[None, :].expand(b, tk)
    if kv_mask is not None:
        valid = valid & kv_mask.to(torch.bool)
    valid = valid[:, None, None, :]  # [B, 1, 1, Tk]

    kf = k.float().permute(0, 2, 3, 1)  # [B, H, D, Tk]
    vf = v.float().permute(0, 2, 1, 3)  # [B, H, Tk, Dv]
    out = torch.empty((b, h, tq, dv), dtype=torch.float32, device=q.device)
    lse = torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
    chunk = max(1, max_chunk_elems // max(1, b * h * tk))
    for t0 in range(0, tq, chunk):
        qc = q[:, t0:t0 + chunk].float().permute(0, 2, 1, 3)  # [B, H, c, D]
        s = torch.matmul(qc, kf) * scale
        s = s.masked_fill(~valid, -math.inf)
        m = s.amax(dim=-1, keepdim=True)
        m = torch.where(m == -math.inf, torch.zeros_like(m), m)
        p = torch.exp(s - m)
        l = p.sum(dim=-1, keepdim=True)
        l_safe = torch.where(l == 0, torch.ones_like(l), l)
        out[:, :, t0:t0 + chunk] = torch.matmul(p, vf) / l_safe
        lse[:, :, t0:t0 + chunk] = torch.where(
            l == 0, torch.full_like(l, math.inf), m + torch.log(l_safe)
        )[..., 0]
    out = out.permute(0, 2, 1, 3)  # [B, Tq, H, Dv]
    if q_mask is not None:
        out = out.masked_fill(~q_mask.to(torch.bool)[:, :, None, None], 0.0)
    out = out.reshape(b, tq, h * dv).to(q.dtype)
    return (out, lse) if return_lse else out
