"""Flash attention, forward and backward: hand-written CUDA kernels and
their plain versions.

Counterpart of ``perceiverio_pytorch_tpu/ops/pallas/flash_attention.py``:
``_flash_kernel`` (K1) is ``csrc/flash_attention_fwd.cu``; ``_bwd_dkv_kernel``
(K2) and ``_bwd_dq_kernel`` (K3) are ``csrc/flash_attention_bwd.cu``.  The
source note at the head of each says what bounds it on an H100 and what its
design does about that.

  * ``flash_attention`` keeps the JAX signature and layout: q [B,Tq,H,Dqk],
    k [B,Tk,H,Dqk], v [B,Tk,H,Dv] -> [B,Tq,H*Dv] (and lse [B,H,Tq]).
    When q, k or v needs a gradient it goes through a
    ``torch.autograd.Function`` (the counterpart of ``_flash_attention_vjp``)
    whose forward saves the lse and whose backward runs K2 then K3.
    A CUDA tensor goes to the kernels, or the call raises; a CPU tensor goes
    to the plain versions, the counterpart of Pallas ``interpret=True``.
  * ``flash_attention_reference`` is the plain version of K1 and
    ``flash_attention_backward_reference`` that of K2 and K3: fp32, chunked
    over query rows so that a flow-size call never holds the whole
    [Tq, Tk] logit matrix.
  * ``LAUNCHES``, ``LAUNCHES_BWD_DKV`` and ``LAUNCHES_BWD_DQ`` count kernel
    launches of K1, K2 and K3 (never plain-version calls).

The kernels are built with ``nvcc`` at first use, from the sources in this
package, into ``build/kernels/`` under the repository root (one ``nvcc``
per source, all started together), and bound with ``ctypes``.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import shutil
import subprocess
import threading
from typing import Dict, Optional

import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
_CSRC = os.path.join(os.path.dirname(_HERE), "csrc")
_SOURCES = {"fwd": "flash_attention_fwd.cu", "bwd": "flash_attention_bwd.cu"}
_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build", "kernels")

# Limits of the kernels' shared-memory plans (see the .cu source notes).
MAX_HEAD_DIM = 512

# Kernel launches since import (or since the caller last reset them): K1,
# K2 and K3.
LAUNCHES = 0
LAUNCHES_BWD_DKV = 0
LAUNCHES_BWD_DQ = 0

_libs: Optional[Dict[str, ctypes.CDLL]] = None
_lib_lock = threading.Lock()
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_STRIDES = [ctypes.c_longlong] * 3  # batch, token, head


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def build() -> Dict[str, str]:
    """Compile each kernel source whose library is missing (the library's
    name carries its source's hash), one ``nvcc`` per source, all started
    together; return the .so paths by name ("fwd", "bwd")."""
    os.makedirs(_BUILD_DIR, exist_ok=True)
    paths, jobs = {}, []
    for name, filename in _SOURCES.items():
        source = os.path.join(_CSRC, filename)
        with open(source, "rb") as f:
            digest = hashlib.sha256(f.read()).hexdigest()[:16]
        stem = os.path.splitext(filename)[0]
        paths[name] = os.path.join(_BUILD_DIR, f"{stem}_{digest}.so")
        if os.path.exists(paths[name]):
            continue
        tmp = f"{paths[name]}.{os.getpid()}.tmp"
        cmd = [
            _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
            "-O3", "-shared", "-Xcompiler", "-fPIC", "-o", tmp, source,
        ]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs.append((filename, tmp, paths[name], proc))
    failures = []
    for filename, tmp, path, proc in jobs:
        output, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"nvcc failed to build {filename}:\n{output}")
        else:
            os.replace(tmp, path)
    if failures:
        raise RuntimeError("\n".join(failures))
    return paths


def _load() -> Dict[str, ctypes.CDLL]:
    global _libs
    with _lib_lock:
        if _libs is None:
            paths = build()
            fwd = ctypes.CDLL(paths["fwd"])
            fwd.flash_attention_fwd.argtypes = (
                [ctypes.c_void_p] * 7  # q, k, v, kv_mask, q_mask, out, lse
                + [ctypes.c_int] * 8  # dtype, B, H, Tq, Tk, kv_len, D, Dv
                + _STRIDES * 3  # q, k, v
                + [ctypes.c_float, ctypes.c_void_p]  # scale, stream
            )
            fwd.flash_attention_fwd.restype = ctypes.c_int
            bwd = ctypes.CDLL(paths["bwd"])
            for fn in (bwd.flash_attention_bwd_dkv, bwd.flash_attention_bwd_dq):
                fn.argtypes = (
                    # q, k, v, dout, lse, delta, kv_mask, dq, dk, dv
                    [ctypes.c_void_p] * 10
                    + [ctypes.c_int] * 8  # dtype, B, H, Tq, Tk, kv_len, D, Dv
                    + _STRIDES * 4  # q, k, v, dout
                    + [ctypes.c_float, ctypes.c_void_p]  # scale, stream
                )
                fn.restype = ctypes.c_int
            _libs = {"fwd": fwd, "bwd": bwd}
    return _libs


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


def _scale_and_len(q, k, softmax_scale, kv_logical_len):
    tk = k.shape[1]
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(q.shape[3])
    kv_len = tk if kv_logical_len is None else min(int(kv_logical_len), tk)
    return float(scale), kv_len


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
    """Flash multi-head attention, differentiable in q, k and v.

    Args:
      q: [B, Tq, H, Dqk]; k: [B, Tk, H, Dqk]; v: [B, Tk, H, Dv].
      q_mask: optional [B, Tq] bool; invalid rows are wiped to zero.
      kv_mask: optional [B, Tk] bool; invalid keys are excluded.
      softmax_scale: logit scale, applied after the matmul; 1/sqrt(Dqk)
        by default.
      kv_logical_len: keys at or beyond this index are masked.
      return_lse: also return the log-sum-exp [B, H, Tq] in fp32, +inf on
        rows whose keys are all masked.  It carries no gradient.

    Returns:
      [B, Tq, H*Dv] in q's dtype (and lse when return_lse).
    """
    _check_inputs(q, k, v, q_mask, kv_mask)
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention runs on CUDA or CPU, not {q.device}")
    if torch.is_grad_enabled() and (
        q.requires_grad or k.requires_grad or v.requires_grad
    ):
        out, lse = _FlashAttention.apply(
            q, k, v, kv_mask, q_mask, softmax_scale, kv_logical_len)
        return (out, lse) if return_lse else out
    return _forward(q, k, v, q_mask=q_mask, kv_mask=kv_mask,
                    softmax_scale=softmax_scale, kv_logical_len=kv_logical_len,
                    return_lse=return_lse)


def _forward(q, k, v, **kw):
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, **kw)
    return _flash_attention_cuda(q, k, v, **kw)


class _FlashAttention(torch.autograd.Function):
    """Counterpart of ``_flash_attention_vjp``: K1 with its lse in the
    forward, K2 and K3 in the backward (the plain versions on the CPU)."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask, q_mask, softmax_scale, kv_logical_len):
        out, lse = _forward(q, k, v, q_mask=q_mask, kv_mask=kv_mask,
                            softmax_scale=softmax_scale,
                            kv_logical_len=kv_logical_len, return_lse=True)
        ctx.save_for_backward(q, k, v, kv_mask, q_mask, out, lse)
        ctx.softmax_scale = softmax_scale
        ctx.kv_logical_len = kv_logical_len
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    @torch.autograd.function.once_differentiable  # the kernels have no backward
    def backward(ctx, grad_out, grad_lse):
        del grad_lse  # the lse is not differentiable
        q, k, v, kv_mask, q_mask, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(
            q, k, v, out, lse, grad_out, q_mask=q_mask, kv_mask=kv_mask,
            softmax_scale=ctx.softmax_scale, kv_logical_len=ctx.kv_logical_len,
        )
        return dq, dk, dv, None, None, None, None


def flash_attention_backward(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    out: torch.Tensor,
    lse: torch.Tensor,
    grad_out: torch.Tensor,
    *,
    q_mask: Optional[torch.Tensor] = None,
    kv_mask: Optional[torch.Tensor] = None,
    softmax_scale: Optional[float] = None,
    kv_logical_len: Optional[int] = None,
):
    """Gradients (dq, dk, dv) of ``flash_attention``, in q's dtype.

    ``out`` and ``lse`` are what the forward returned on the same inputs,
    ``grad_out`` the gradient of ``out`` ([B, Tq, H*Dv]).  A CUDA tensor goes
    to K2 and K3, or the call raises; a CPU tensor to the plain version.
    """
    _check_inputs(q, k, v, q_mask, kv_mask)
    fn = (flash_attention_backward_reference if q.device.type == "cpu"
          else _flash_attention_backward_cuda)
    return fn(q, k, v, out, lse, grad_out, q_mask=q_mask, kv_mask=kv_mask,
              softmax_scale=softmax_scale, kv_logical_len=kv_logical_len)


def _check_cuda(q, tensors, masks):
    """What every kernel wrapper checks before it hands pointers over."""
    if q.device.type != "cuda":
        raise ValueError(f"the flash attention kernels run on CUDA, not {q.device}")
    for name, t in tensors:
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != q.dtype:
            raise ValueError(f"{name} is {t.dtype}, q is {q.dtype}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must be contiguous in its last dim")
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"flash_attention takes fp32 or bf16, not {q.dtype}")
    d, dv = q.shape[3], tensors[2][1].shape[3]
    if not (1 <= d <= MAX_HEAD_DIM and 1 <= dv <= MAX_HEAD_DIM):
        raise ValueError(
            f"head widths Dqk={d}, Dv={dv} exceed the kernels' {MAX_HEAD_DIM}"
        )
    checked = []
    for name, m in masks:
        if m is not None and m.device != q.device:
            raise ValueError(f"{name} is on {m.device}, q on {q.device}")
        checked.append(None if m is None else m.to(torch.bool).contiguous())
    return checked


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _flash_attention_cuda(q, k, v, *, q_mask, kv_mask, softmax_scale,
                          kv_logical_len, return_lse):
    global LAUNCHES
    kv_mask_c, q_mask_c = _check_cuda(
        q, (("q", q), ("k", k), ("v", v)), (("kv_mask", kv_mask), ("q_mask", q_mask)))
    b, tq, h, d = q.shape
    tk, dv = k.shape[1], v.shape[3]
    scale, kv_len = _scale_and_len(q, k, softmax_scale, kv_logical_len)

    out = torch.empty((b, tq, h * dv), dtype=q.dtype, device=q.device)
    lse = (
        torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
        if return_lse else None
    )
    if b * tq * h == 0:
        return (out, lse) if return_lse else out

    lib = _load()["fwd"]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            _ptr(kv_mask_c), _ptr(q_mask_c), out.data_ptr(), _ptr(lse),
            _DTYPE_CODES[q.dtype], b, h, tq, tk, kv_len, d, dv,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            scale, stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_attention_fwd launch failed: CUDA error {err}")
    LAUNCHES += 1
    return (out, lse) if return_lse else out


def _prepare_grad(q, v, out, grad_out, q_mask):
    """do = grad_out as [B, Tq, H, Dv], zero on q-masked rows, and
    delta = rowsum(do * out) in fp32, as [B, H, Tq] (the JAX package's
    ``_pallas_attention_bwd`` does both in XLA before its sweeps)."""
    b, tq, h = q.shape[:3]
    do = grad_out.reshape(b, tq, h, v.shape[3])
    if q_mask is not None:
        do = do.masked_fill(~q_mask.to(torch.bool)[:, :, None, None], 0)
    delta = (do.float() * out.reshape(do.shape).float()).sum(-1).transpose(1, 2)
    return do, delta


def _flash_attention_backward_cuda(q, k, v, out, lse, grad_out, **kw):
    launch = BackwardKernels(q, k, v, out, lse, grad_out, **kw)
    launch.dkv()
    launch.dq()
    return launch.grad_q, launch.grad_k, launch.grad_v


class BackwardKernels:
    """K2 and K3 on one backward's inputs: the checks, ``do`` and ``delta``
    once, then ``dkv()`` launches K2 into ``grad_k``/``grad_v`` and ``dq()``
    K3 into ``grad_q``; each launch counts one.  ``flash_attention_backward``
    runs both; a caller that times the kernels apart calls them apart."""

    def __init__(self, q, k, v, out, lse, grad_out, *, q_mask, kv_mask,
                 softmax_scale, kv_logical_len):
        b, tq, h, d = q.shape
        tk, dv = k.shape[1], v.shape[3]
        for name, t, shape in (("out", out, (b, tq, h * dv)), ("lse", lse, (b, h, tq)),
                               ("grad_out", grad_out, (b, tq, h * dv))):
            if tuple(t.shape) != shape or t.device != q.device:
                raise ValueError(f"{name} must be {list(shape)} on {q.device}, got"
                                 f" {list(t.shape)} on {t.device}")
        do, delta = _prepare_grad(q, v, out, grad_out.to(q.dtype), q_mask)
        if do.stride(-1) != 1:
            do = do.contiguous()
        (kv_mask_c,) = _check_cuda(
            q, (("q", q), ("k", k), ("v", v), ("grad_out", do)), (("kv_mask", kv_mask),))
        scale, kv_len = _scale_and_len(q, k, softmax_scale, kv_logical_len)
        lse = lse.float().contiguous()
        delta = delta.contiguous()
        self._empty = b * h == 0 or tq == 0 or tk == 0
        alloc = torch.zeros if self._empty else torch.empty  # the kernels write all
        self.grad_q = alloc((b, tq, h, d), dtype=q.dtype, device=q.device)
        self.grad_k = alloc((b, tk, h, d), dtype=q.dtype, device=q.device)
        self.grad_v = alloc((b, tk, h, dv), dtype=q.dtype, device=q.device)
        self._device = q.device
        # The tensors stay referenced here while the kernels may read them.
        self._keep = (q, k, v, do, lse, delta, kv_mask_c)
        self._args = (
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), _ptr(kv_mask_c),
            self.grad_q.data_ptr(), self.grad_k.data_ptr(), self.grad_v.data_ptr(),
            _DTYPE_CODES[q.dtype], b, h, tq, tk, kv_len, d, dv,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *do.stride()[:3],
            scale,
        )

    def _launch(self, name):
        if self._empty:
            return False
        fn = getattr(_load()["bwd"], name)
        with torch.cuda.device(self._device):
            err = fn(*self._args, torch.cuda.current_stream(self._device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"{name} launch failed: CUDA error {err}")
        return True

    def dkv(self):
        """K2: dk and dv."""
        global LAUNCHES_BWD_DKV
        if self._launch("flash_attention_bwd_dkv"):
            LAUNCHES_BWD_DKV += 1

    def dq(self):
        """K3: dq."""
        global LAUNCHES_BWD_DQ
        if self._launch("flash_attention_bwd_dq"):
            LAUNCHES_BWD_DQ += 1


def _valid_keys(q, k, kv_mask, kv_len):
    """[B, 1, 1, Tk] bool: keys below kv_len that kv_mask keeps."""
    b, tk = q.shape[0], k.shape[1]
    valid = (torch.arange(tk, device=q.device) < kv_len)[None, :].expand(b, tk)
    if kv_mask is not None:
        valid = valid & kv_mask.to(torch.bool)
    return valid[:, None, None, :]


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
    """Plain PyTorch version of K1: same signature and semantics.

    Runs in fp32, ``max_chunk_elems`` logits at a time (256 MB in fp32),
    chunked over query rows.  Returns the output in q's dtype.
    """
    _check_inputs(q, k, v, q_mask, kv_mask)
    b, tq, h, d = q.shape
    tk, dv = k.shape[1], v.shape[3]
    scale, kv_len = _scale_and_len(q, k, softmax_scale, kv_logical_len)
    valid = _valid_keys(q, k, kv_mask, kv_len)

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


def flash_attention_backward_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    out: torch.Tensor,
    lse: torch.Tensor,
    grad_out: torch.Tensor,
    *,
    q_mask: Optional[torch.Tensor] = None,
    kv_mask: Optional[torch.Tensor] = None,
    softmax_scale: Optional[float] = None,
    kv_logical_len: Optional[int] = None,
    max_chunk_elems: int = 1 << 26,
):
    """Plain PyTorch version of K2 and K3: same arguments as
    ``flash_attention_backward``, same semantics as the kernels.

    Recomputes p = exp(scale * q k^T - lse) in fp32, ``max_chunk_elems``
    logits at a time, chunked over query rows (the counterpart of
    ``_chunked_attention_bwd``).  Rows whose keys are all masked (lse =
    +inf) and q-masked rows carry zero gradient; keys at or beyond
    ``kv_logical_len`` get dk = dv = 0 exactly.  Returns (dq, dk, dv) in q's
    dtype.
    """
    _check_inputs(q, k, v, q_mask, kv_mask)
    b, tq, h, d = q.shape
    tk, dv = k.shape[1], v.shape[3]
    scale, kv_len = _scale_and_len(q, k, softmax_scale, kv_logical_len)
    valid = _valid_keys(q, k, kv_mask, kv_len)
    do, delta = _prepare_grad(q, v, out, grad_out, q_mask)
    do = do.float()

    kf = k.float().permute(0, 2, 1, 3)  # [B, H, Tk, D]
    vf = v.float().permute(0, 2, 1, 3)  # [B, H, Tk, Dv]
    lse = lse.float()
    dq = torch.empty((b, h, tq, d), dtype=torch.float32, device=q.device)
    dk = torch.zeros((b, h, tk, d), dtype=torch.float32, device=q.device)
    dv_ = torch.zeros((b, h, tk, dv), dtype=torch.float32, device=q.device)
    chunk = max(1, max_chunk_elems // max(1, b * h * tk))
    for t0 in range(0, tq, chunk):
        rows = slice(t0, t0 + chunk)
        qc = q[:, rows].float().permute(0, 2, 1, 3)  # [B, H, c, D]
        doc = do[:, rows].permute(0, 2, 1, 3)  # [B, H, c, Dv]
        s = torch.matmul(qc, kf.transpose(-1, -2)) * scale
        s = s.masked_fill(~valid, -math.inf)
        p = torch.exp(s - lse[:, :, rows, None])  # 0 on masked keys and rows
        dp = torch.matmul(doc, vf.transpose(-1, -2))
        ds = p * (dp - delta[:, :, rows, None])
        dv_ += torch.matmul(p.transpose(-1, -2), doc)
        dk += torch.matmul(ds.transpose(-1, -2), qc)
        dq[:, :, rows] = torch.matmul(ds, kf)
    return (
        (dq * scale).permute(0, 2, 1, 3).to(q.dtype),
        (dk * scale).permute(0, 2, 1, 3).to(q.dtype),
        dv_.permute(0, 2, 1, 3).to(q.dtype),
    )
