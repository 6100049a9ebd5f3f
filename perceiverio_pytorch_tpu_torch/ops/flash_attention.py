"""Flash attention, forward and backward: hand-written CUDA kernels and
their plain versions.

Counterpart of ``perceiverio_pytorch_tpu/ops/pallas/flash_attention.py``:
``_flash_kernel`` (K1) is ``csrc/flash_attention_fwd_sm90.cu`` for bf16
inputs (wgmma on the tensor cores, route ``sm90_wgmma``) and
``csrc/flash_attention_fwd.cu`` for fp32 ones (IEEE fp32 on the CUDA cores,
route ``cuda_cores``), which also holds the merge of split-KV partials;
``_bwd_dkv_kernel`` (K2) and ``_bwd_dq_kernel`` (K3) are
``csrc/flash_attention_bwd_sm90.cu`` for bf16 inputs (wgmma, route
``sm90_wgmma``, with the ordered sum of their split partials) and
``csrc/flash_attention_bwd.cu`` for fp32 ones (route ``cuda_cores``).  The
source note at the head of each says what bounds it on an H100 and what its
design does about that.

  * ``flash_attention`` keeps the JAX signature and layout: q [B,Tq,H,Dqk],
    k [B,Tk,H,Dqk], v [B,Tk,H,Dv] -> [B,Tq,H*Dv] (and lse [B,H,Tq]).
    When q, k or v needs a gradient it goes through a
    ``torch.autograd.Function`` (the counterpart of ``_flash_attention_vjp``)
    whose forward saves the lse and whose backward runs K2 then K3.
    A CUDA tensor goes to the kernels, or the call raises; a CPU tensor goes
    to the plain versions, the counterpart of Pallas ``interpret=True``.
    The forward goes through K1's ``torch.library`` op
    (``flash_attention_fwd``, ``OP_NAME``) on both devices, so that
    ``torch.export`` traces it into a graph (``serving.export_apply``).
  * ``flash_attention_reference`` is the plain version of K1 and
    ``flash_attention_backward_reference`` that of K2 and K3: fp32, chunked
    over query rows so that a flow-size call never holds the whole
    [Tq, Tk] logit matrix.
  * ``LAUNCHES``, ``LAUNCHES_BWD_DKV`` and ``LAUNCHES_BWD_DQ`` count kernel
    launches of K1, K2 and K3 (never plain-version calls): one per call,
    however many CUDA launches it makes.  ``LAUNCHES_MERGE`` counts the
    merge kernel's launches (K1 calls with more than one key split) and
    ``LAUNCHES_BWD_SUM`` the sum kernel's (K2 or K3 calls with more than one
    split).
  * ``launch_plan`` says what a K1 call on given tensors launches: route,
    key splits (``_split_plan``), value-column chunks (``_col_chunks``),
    blocks and CUDA launches; ``backward_plan`` the same for K2 (query
    splits, ``_dkv_split_plan``) and K3 (key splits, ``_split_plan``), with
    their output-column chunks.
  * Each kernel states its own head-width limit: K1 takes Dqk and Dv up to
    ``MAX_HEAD_DIM_FWD`` = 704 (the multimodal encoder's single head; above
    512 its grid splits the value columns in two), K2 and K3 up to
    ``MAX_HEAD_DIM_BWD`` = 704 (above 512, K3's grid splits the dQ columns
    in chunks of 352, the fp32 K2's the dK and dV columns in two, and the
    bf16 K2 takes 16 keys a block).  A CUDA call above a kernel's limit
    raises ``ValueError`` before anything is launched.

The kernels are built with ``nvcc`` at first use, from the sources in this
package, into ``build/kernels/`` under the repository root (one ``nvcc``
per source, all started together), and bound with ``ctypes``.
``set_build_dir`` (``utils.compilation_cache.enable_compilation_cache``)
moves that directory before the first use.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import shutil
import subprocess
import threading
from typing import Dict, Optional, Tuple

import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
_CSRC = os.path.join(os.path.dirname(_HERE), "csrc")
_SOURCES = {"fwd": "flash_attention_fwd.cu", "fwd_sm90": "flash_attention_fwd_sm90.cu",
            "bwd": "flash_attention_bwd.cu", "bwd_sm90": "flash_attention_bwd_sm90.cu"}
_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build", "kernels")

# Head-width limits (Dqk and Dv) of the kernels' shared-memory and register
# plans (see the .cu source notes): K1 forward, K2/K3 backward.  Above
# COL_CHUNK columns the grids split output columns into chunks: K1's value
# columns in at most COL_CHUNK, K3's dQ columns in WIDE_DQ_CHUNK (the bf16
# kernel's; the fp32 one splits them as evenly), and the fp32 K2's dK and dV
# columns as K1 splits its values.
MAX_HEAD_DIM_FWD = 704
MAX_HEAD_DIM_BWD = 704
COL_CHUNK = 512
WIDE_DQ_CHUNK = 352
# K1's blocks: query rows per block and keys per tile (both kernels); the
# tiles of every split plan (K2's query ranges, K1's and K3's key ranges).
BLOCK_Q = 64
BLOCK_K = 64
# The split-KV plan: SMs of an H100, the card the kernels are built for, and
# the fewest key tiles worth a split of their own.
NUM_SMS = 132
MIN_SPLIT_TILES = 8

# Kernel launches since import (or since the caller last reset them): K1,
# K2 and K3, the merge of K1's split-KV partials and the sum of K2's or K3's
# split partials.
LAUNCHES = 0
LAUNCHES_BWD_DKV = 0
LAUNCHES_BWD_DQ = 0
LAUNCHES_MERGE = 0
LAUNCHES_BWD_SUM = 0

# K1's ``torch.library`` op (``flash_attention_fwd``), which the forward
# calls on every device, so that an exported program holds it.
OP_NAME = "perceiverio_torch::flash_attention_fwd"

_libs: Optional[Dict[str, ctypes.CDLL]] = None
_lib_lock = threading.Lock()
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_STRIDES = [ctypes.c_longlong] * 3  # batch, token, head


def build_dir() -> str:
    """The directory the kernel libraries are built into and loaded from."""
    return _BUILD_DIR


def set_build_dir(path: str) -> str:
    """Build and load the kernel libraries in ``path`` (created at the
    build); returns its absolute form.  Raises ``RuntimeError`` once the
    kernels are loaded from another directory."""
    global _BUILD_DIR
    path = os.path.abspath(path)
    with _lib_lock:
        if _libs is not None and path != _BUILD_DIR:
            raise RuntimeError(
                f"the flash attention kernels are already loaded from {_BUILD_DIR}; set the"
                " build directory before their first use")
        _BUILD_DIR = path
    return path


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def library_paths() -> Dict[str, str]:
    """The .so path of each kernel source by name ("fwd", "fwd_sm90",
    "bwd", "bwd_sm90"): the name carries the hash of the source and of every
    ``csrc/*.cuh`` header, so an edit to either builds a new library."""
    headers = b""
    for name in sorted(os.listdir(_CSRC)):
        if name.endswith(".cuh"):
            with open(os.path.join(_CSRC, name), "rb") as f:
                headers += name.encode() + f.read()
    paths = {}
    for name, filename in _SOURCES.items():
        with open(os.path.join(_CSRC, filename), "rb") as f:
            digest = hashlib.sha256(f.read() + headers).hexdigest()[:16]
        stem = os.path.splitext(filename)[0]
        paths[name] = os.path.join(_BUILD_DIR, f"{stem}_{digest}.so")
    return paths


def build() -> Dict[str, str]:
    """Compile each kernel source whose library (``library_paths``) is
    missing, one ``nvcc`` per source, all started together; return the .so
    paths by name."""
    os.makedirs(_BUILD_DIR, exist_ok=True)
    paths, jobs = library_paths(), []
    for name, filename in _SOURCES.items():
        source = os.path.join(_CSRC, filename)
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
            fwd_sm90 = ctypes.CDLL(paths["fwd_sm90"])
            for fn in (fwd.flash_attention_fwd, fwd_sm90.flash_attention_fwd_sm90):
                fn.argtypes = (
                    # q, k, v, kv_mask, q_mask, out, lse, part_o, part_m, part_l
                    [ctypes.c_void_p] * 10
                    # B, H, Tq, Tk, kv_len, D, Dv, splits, tiles_per_split,
                    # col_chunks
                    + [ctypes.c_int] * 10
                    + _STRIDES * 3  # q, k, v
                    + [ctypes.c_float, ctypes.c_void_p]  # scale, stream
                )
                fn.restype = ctypes.c_int
            fwd.flash_attention_fwd_merge.argtypes = (
                [ctypes.c_void_p] * 6  # part_o, part_m, part_l, q_mask, out, lse
                + [ctypes.c_int] * 6  # dtype, splits, B, H, Tq, Dv
                + [ctypes.c_void_p]  # stream
            )
            fwd.flash_attention_fwd_merge.restype = ctypes.c_int
            bwd = ctypes.CDLL(paths["bwd"])
            for fn in (bwd.flash_attention_bwd_dkv, bwd.flash_attention_bwd_dq):
                fn.argtypes = (
                    # q, k, v, dout, lse, delta, kv_mask, dq, dk, dv
                    [ctypes.c_void_p] * 10
                    + [ctypes.c_int] * 8  # B, H, Tq, Tk, kv_len, D, Dv, col_chunks
                    + _STRIDES * 4  # q, k, v, dout
                    + [ctypes.c_float, ctypes.c_void_p]  # scale, stream
                )
                fn.restype = ctypes.c_int
            bwd_sm90 = ctypes.CDLL(paths["bwd_sm90"])
            for fn in (bwd_sm90.flash_attention_bwd_dkv_sm90,
                       bwd_sm90.flash_attention_bwd_dq_sm90):
                fn.argtypes = (
                    # q, k, v, dout, lse, delta, kv_mask, dq, dk, dv,
                    # part_q, part_k, part_v
                    [ctypes.c_void_p] * 13
                    # B, H, Tq, Tk, kv_len, D, Dv, splits, tiles_per_split,
                    # col_chunks
                    + [ctypes.c_int] * 10
                    + _STRIDES * 4  # q, k, v, dout
                    + [ctypes.c_float, ctypes.c_void_p]  # scale, stream
                )
                fn.restype = ctypes.c_int
            bwd_sm90.flash_attention_bwd_sum.argtypes = (
                [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong] * 2  # part, out, n
                + [ctypes.c_int, ctypes.c_void_p]  # splits, stream
            )
            bwd_sm90.flash_attention_bwd_sum.restype = ctypes.c_int
            _libs = {"fwd": fwd, "fwd_sm90": fwd_sm90, "bwd": bwd, "bwd_sm90": bwd_sm90}
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


def _forward(q, k, v, *, q_mask, kv_mask, softmax_scale, kv_logical_len, return_lse):
    out, lse = flash_attention_fwd(q, k, v, kv_mask, q_mask, softmax_scale, kv_logical_len,
                                   return_lse)
    return (out, lse) if return_lse else out


@torch.library.custom_op(OP_NAME, mutates_args=(), device_types="cuda")
def flash_attention_fwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_mask: Optional[torch.Tensor],
    q_mask: Optional[torch.Tensor],
    softmax_scale: Optional[float],
    kv_logical_len: Optional[int],
    return_lse: bool,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1 as a ``torch.library`` op, so that ``torch.export`` traces it: the
    CUDA implementation launches the kernels (``_flash_attention_cuda``: the
    plan reads the concrete batch at run time), the CPU one runs the plain
    version.  Returns (out, lse); without ``return_lse`` the lse is empty
    and no kernel writes one."""
    return _with_lse(_flash_attention_cuda, q, k, v, kv_mask, q_mask, softmax_scale,
                     kv_logical_len, return_lse)


@flash_attention_fwd.register_kernel("cpu")
def _flash_attention_fwd_cpu(q, k, v, kv_mask, q_mask, softmax_scale, kv_logical_len,
                             return_lse):
    return _with_lse(flash_attention_reference, q, k, v, kv_mask, q_mask, softmax_scale,
                     kv_logical_len, return_lse)


def _with_lse(fn, q, k, v, kv_mask, q_mask, softmax_scale, kv_logical_len, return_lse):
    got = fn(q, k, v, q_mask=q_mask, kv_mask=kv_mask, softmax_scale=softmax_scale,
             kv_logical_len=kv_logical_len, return_lse=return_lse)
    return got if return_lse else (got, _no_lse(q))


def _no_lse(q):
    return torch.empty(0, dtype=torch.float32, device=q.device)


@flash_attention_fwd.register_fake
def _flash_attention_fwd_fake(q, k, v, kv_mask, q_mask, softmax_scale, kv_logical_len,
                              return_lse):
    b, tq, h = q.shape[:3]
    out = q.new_empty((b, tq, h * v.shape[3]))
    return out, q.new_empty((b, h, tq), dtype=torch.float32) if return_lse else _no_lse(q)


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


def _check_cuda(q, tensors, masks, max_dim, kernel):
    """What every kernel wrapper checks before it hands pointers over;
    ``max_dim`` is the head-width limit of ``kernel`` (named in the
    message)."""
    d, dv = q.shape[3], tensors[2][1].shape[3]
    if not (1 <= d <= max_dim and 1 <= dv <= max_dim):
        raise ValueError(f"head widths Dqk={d}, Dv={dv}: {kernel} takes 1 to {max_dim}")
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
    checked = []
    for name, m in masks:
        if m is not None and m.device != q.device:
            raise ValueError(f"{name} is on {m.device}, q on {q.device}")
        checked.append(None if m is None else m.to(torch.bool).contiguous())
    return checked


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _split_bounds(length: int, splits: int):
    """(splits, tiles_per_split) for at most ``splits`` ranges of whole
    tiles of 64 (keys, or K2's query rows) over [0, length), none of them
    empty.  Split s walks tiles [s * tiles_per_split, (s + 1) *
    tiles_per_split)."""
    tiles = -(-length // BLOCK_K)
    if tiles == 0:
        return 1, 0
    per = -(-tiles // max(1, min(splits, tiles)))
    return -(-tiles // per), per


def _col_chunks(dv: int) -> int:
    """Value-column chunks of K1's grid (and dK/dV-column chunks of the fp32
    K2's, for the wider of d and dv): 1 up to COL_CHUNK columns, 2 up to
    MAX_HEAD_DIM_FWD (the multimodal encoder's 704 as 2 x 352)."""
    return max(1, -(-dv // COL_CHUNK))


def _split_plan(b: int, tq: int, h: int, tk: int, col_chunks: int = 1):
    """K1's split-KV plan: (splits, tiles_per_split) for B, Tq, H, the
    keys' length and the value-column chunks of the grid.

    A grid of at least two blocks per SM takes one split.  A shorter one
    (the flow encoder: 32 query blocks a batch entry) starts from enough
    splits for two blocks per SM, at least MIN_SPLIT_TILES tiles each, and
    drops splits while that does not lengthen the kernel, counted as waves
    of one block per SM times the tiles a block walks: 8 splits (256
    blocks) at batch 1, 2 at the 6-tile serving batch; the multimodal
    encoder (13 query blocks x 2 column chunks) takes 10 (260 blocks).
    """
    blocks = -(-tq // BLOCK_Q) * h * b * col_chunks
    tiles = -(-tk // BLOCK_K)
    if blocks == 0 or blocks >= 2 * NUM_SMS:
        return _split_bounds(tk, 1)

    def cost(splits):
        n, per = _split_bounds(tk, splits)
        return -(-blocks * n // NUM_SMS) * per

    splits = min(-(-2 * NUM_SMS // blocks), max(1, tiles // MIN_SPLIT_TILES))
    while splits > 1 and cost(splits - 1) <= cost(splits):
        splits -= 1
    return _split_bounds(tk, splits)


def launch_plan(q, k, v, *, kv_logical_len=None, num_splits=None) -> Dict:
    """What a K1 call on these tensors launches: ``route`` ("sm90_wgmma"
    for bf16 on CUDA, "cuda_cores" for fp32), ``splits`` and
    ``tiles_per_split`` (``_split_plan``, or ``num_splits`` ranges when
    given), ``col_chunks`` (``_col_chunks``: the grid's split of the value
    columns), ``blocks`` of the main kernel's grid and ``cuda_launches``
    (the kernel, and the merge when there is more than one split)."""
    b, tq, h = q.shape[:3]
    _, kv_len = _scale_and_len(q, k, None, kv_logical_len)
    chunks = _col_chunks(v.shape[3])
    splits, per = (_split_plan(b, tq, h, kv_len, chunks) if num_splits is None
                   else _split_bounds(kv_len, num_splits))
    return dict(
        route="sm90_wgmma" if q.dtype == torch.bfloat16 else "cuda_cores",
        splits=splits, tiles_per_split=per, col_chunks=chunks,
        blocks=-(-tq // BLOCK_Q) * h * b * chunks * splits,
        cuda_launches=1 + (splits > 1),
    )


def _dkv_split_plan(b: int, tq: int, h: int, tk: int):
    """K2's plan: (splits, tiles_per_split) over the query rows, for B, Tq,
    H and Tk.  It is K1's plan with the roles of queries and keys swapped,
    the keys counted in blocks of 64 as K1 counts query rows: the flow
    decoder's 2048 keys at batch 1 take 8 query splits (512 blocks of 32
    keys), as the encoder's 2048 queries take 8 key splits in K1 and K3;
    the encoder (182,528 keys) and the self-attends (16 heads) take 1."""
    return _split_plan(b, tk, h, tq)


def backward_plan(q, k, v, *, kv_logical_len=None, num_splits=None) -> Dict:
    """What a backward (K2, then K3) on these tensors launches: ``route``
    ("sm90_wgmma" for bf16 on CUDA, "cuda_cores" for fp32) and, under
    "dkv" (K2) and "dq" (K3), ``splits`` and ``tiles_per_split`` (K2's
    query ranges by ``_dkv_split_plan``, K3's key ranges by ``_split_plan``
    counted with K3's column chunks, or ``num_splits`` ranges for both when
    given), ``col_chunks`` (the grid's split of the kernel's output columns:
    above COL_CHUNK columns of d or dv, K3 splits dQ's into ceil(d /
    WIDE_DQ_CHUNK) on both routes and the fp32 K2 dK's and dV's in two; the
    bf16 K2 takes 16 keys a block there instead), ``blocks`` of the
    kernel's grid and ``cuda_launches`` (the kernel, and the sum of its
    partials when there is more than one split).  The fp32 kernels never
    split: one block walks all of its query (K2) or key (K3) tiles."""
    b, tq, h, d = q.shape
    tk, dv = k.shape[1], v.shape[3]
    _, kv_len = _scale_and_len(q, k, None, kv_logical_len)
    q_blocks = -(-tq // BLOCK_Q) * h * b
    width = max(d, dv)
    dq_chunks = -(-d // WIDE_DQ_CHUNK) if width > COL_CHUNK else 1
    if q.dtype != torch.bfloat16:  # the CUDA-core K2 takes 32 keys a block
        dkv_chunks = _col_chunks(width)
        return dict(
            route="cuda_cores",
            dkv=dict(splits=1, tiles_per_split=-(-tq // BLOCK_Q), col_chunks=dkv_chunks,
                     blocks=-(-tk // 32) * h * b * dkv_chunks, cuda_launches=1),
            dq=dict(splits=1, tiles_per_split=-(-kv_len // BLOCK_K), col_chunks=dq_chunks,
                    blocks=q_blocks * dq_chunks, cuda_launches=1),
        )
    if num_splits is None:
        plans = (_dkv_split_plan(b, tq, h, tk), _split_plan(b, tq, h, kv_len, dq_chunks))
    else:
        plans = (_split_bounds(tq, num_splits), _split_bounds(kv_len, num_splits))
    # K2's keys a block: 64 up to 256 columns, 32 up to 512, else 16 (the
    # register and shared-memory walls).
    keys = 64 if width <= 256 else 32 if width <= COL_CHUNK else 16
    k_blocks = -(-tk // keys) * h * b
    return dict(route="sm90_wgmma", **{
        name: dict(splits=splits, tiles_per_split=per, col_chunks=chunks,
                   blocks=blocks * chunks * splits, cuda_launches=1 + (splits > 1))
        for name, (splits, per), chunks, blocks in (("dkv", plans[0], 1, k_blocks),
                                                    ("dq", plans[1], dq_chunks, q_blocks))
    })


def _flash_attention_cuda(q, k, v, *, q_mask, kv_mask, softmax_scale,
                          kv_logical_len, return_lse, num_splits=None):
    """K1 on CUDA tensors: the sm90 kernel for bf16, the CUDA-core kernel
    for fp32, then the merge when the plan splits the keys.  ``num_splits``
    overrides the plan (for tests that hold split counts against each
    other)."""
    global LAUNCHES, LAUNCHES_MERGE
    kv_mask_c, q_mask_c = _check_cuda(
        q, (("q", q), ("k", k), ("v", v)), (("kv_mask", kv_mask), ("q_mask", q_mask)),
        MAX_HEAD_DIM_FWD, "K1 (flash attention forward)")
    b, tq, h, d = q.shape
    tk, dv = k.shape[1], v.shape[3]
    scale, kv_len = _scale_and_len(q, k, softmax_scale, kv_logical_len)
    plan = launch_plan(q, k, v, kv_logical_len=kv_logical_len, num_splits=num_splits)
    splits = plan["splits"]

    out = torch.empty((b, tq, h * dv), dtype=q.dtype, device=q.device)
    lse = (
        torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
        if return_lse else None
    )
    if b * tq * h == 0:
        return (out, lse) if return_lse else out
    part_o = part_ml = None
    if splits > 1:
        part_o = torch.empty((splits, b, h, tq, dv), dtype=torch.float32, device=q.device)
        part_ml = torch.empty((2, splits, b, h, tq), dtype=torch.float32, device=q.device)

    libs = _load()
    kernel = (libs["fwd_sm90"].flash_attention_fwd_sm90 if plan["route"] == "sm90_wgmma"
              else libs["fwd"].flash_attention_fwd)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = kernel(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            _ptr(kv_mask_c), _ptr(q_mask_c), out.data_ptr(), _ptr(lse),
            _ptr(part_o), _ptr(None if part_ml is None else part_ml[0]),
            _ptr(None if part_ml is None else part_ml[1]),
            b, h, tq, tk, kv_len, d, dv, splits, plan["tiles_per_split"], plan["col_chunks"],
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            scale, stream,
        )
        if err != 0:
            raise RuntimeError(f"K1 ({plan['route']}) launch failed: CUDA error {err}")
        if splits > 1:
            err = libs["fwd"].flash_attention_fwd_merge(
                part_o.data_ptr(), part_ml[0].data_ptr(), part_ml[1].data_ptr(),
                _ptr(q_mask_c), out.data_ptr(), _ptr(lse), _DTYPE_CODES[q.dtype],
                splits, b, h, tq, dv, stream,
            )
            if err != 0:
                raise RuntimeError(f"flash_attention_fwd_merge launch failed: CUDA error {err}")
            LAUNCHES_MERGE += 1
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


def _flash_attention_backward_cuda(q, k, v, out, lse, grad_out, *, q_mask=None, kv_mask=None,
                                   softmax_scale=None, kv_logical_len=None, num_splits=None):
    """K2 then K3 on CUDA tensors.  ``num_splits`` overrides the split plans
    of the bf16 kernels (for tests that hold split counts against each
    other)."""
    launch = BackwardKernels(q, k, v, out, lse, grad_out, q_mask=q_mask, kv_mask=kv_mask,
                             softmax_scale=softmax_scale, kv_logical_len=kv_logical_len,
                             num_splits=num_splits)
    launch.dkv()
    launch.dq()
    return launch.grad_q, launch.grad_k, launch.grad_v


class BackwardKernels:
    """K2 and K3 on one backward's inputs: the checks, ``do`` and ``delta``
    once, then ``dkv()`` launches K2 into ``grad_k``/``grad_v`` and ``dq()``
    K3 into ``grad_q``, each on the route and splits of ``plan``
    (``backward_plan``) and followed by the sum of its partials when it
    splits; each kernel counts one launch.  ``flash_attention_backward``
    runs both; a caller that times the kernels apart calls them apart."""

    def __init__(self, q, k, v, out, lse, grad_out, *, q_mask, kv_mask,
                 softmax_scale, kv_logical_len, num_splits=None):
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
            q, (("q", q), ("k", k), ("v", v), ("grad_out", do)), (("kv_mask", kv_mask),),
            MAX_HEAD_DIM_BWD, "K2/K3 (flash attention backward)")
        scale, kv_len = _scale_and_len(q, k, softmax_scale, kv_logical_len)
        self.plan = backward_plan(q, k, v, kv_logical_len=kv_logical_len, num_splits=num_splits)
        self._sm90 = self.plan["route"] == "sm90_wgmma"
        if not self._sm90 and num_splits not in (None, 1):
            raise ValueError("the fp32 backward kernels do not split their walks")
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
        self._inputs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                        lse.data_ptr(), delta.data_ptr(), _ptr(kv_mask_c),
                        self.grad_q.data_ptr(), self.grad_k.data_ptr(),
                        self.grad_v.data_ptr())
        self._dims = (b, h, tq, tk, kv_len, d, dv)
        self._strides = (*q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *do.stride()[:3])
        self._scale = scale

    def _run(self, kernel, grads):
        """Launch ``kernel`` (K2 "dkv" or K3 "dq") into ``grads``, and the
        sum of its partials when its plan splits; False when there is
        nothing to do."""
        global LAUNCHES_BWD_SUM
        if self._empty:
            return False
        libs = _load()
        name = f"flash_attention_bwd_{kernel}"
        plan = self.plan[kernel]
        splits, per, chunks = plan["splits"], plan["tiles_per_split"], plan["col_chunks"]
        parts = [torch.empty((splits, *g.shape), dtype=torch.float32, device=self._device)
                 if splits > 1 else None for g in grads]
        with torch.cuda.device(self._device):
            stream = torch.cuda.current_stream(self._device).cuda_stream
            if self._sm90:
                part_q, part_k, part_v = ((parts[0], None, None) if kernel == "dq"
                                          else (None, *parts))
                err = getattr(libs["bwd_sm90"], name + "_sm90")(
                    *self._inputs, _ptr(part_q), _ptr(part_k), _ptr(part_v), *self._dims,
                    splits, per, chunks, *self._strides, self._scale, stream)
            else:
                err = getattr(libs["bwd"], name)(
                    *self._inputs, *self._dims, chunks, *self._strides, self._scale, stream)
            if err != 0:
                raise RuntimeError(f"{name} ({self.plan['route']}) launch failed: CUDA error {err}")
            if splits > 1:
                pairs = [(_ptr(part), g.data_ptr(), g.numel()) for part, g in zip(parts, grads)]
                pairs += [(None, None, 0)] * (2 - len(pairs))
                err = libs["bwd_sm90"].flash_attention_bwd_sum(*pairs[0], *pairs[1], splits, stream)
                if err != 0:
                    raise RuntimeError(f"flash_attention_bwd_sum launch failed: CUDA error {err}")
                LAUNCHES_BWD_SUM += 1
        return True

    def dkv(self):
        """K2: dk and dv."""
        global LAUNCHES_BWD_DKV
        if self._run("dkv", (self.grad_k, self.grad_v)):
            LAUNCHES_BWD_DKV += 1

    def dq(self):
        """K3: dq."""
        global LAUNCHES_BWD_DQ
        if self._run("dq", (self.grad_q,)):
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
    num_splits: int = 1,
):
    """Plain PyTorch version of K1: same signature and semantics.

    Runs in fp32, ``max_chunk_elems`` logits at a time (256 MB in fp32),
    chunked over query rows.  Returns the output in q's dtype.
    ``num_splits`` > 1 walks the keys in that many ranges of whole key
    tiles, as the kernels' split-KV grid does (``_split_bounds``), and
    combines the partial (O, m, l) with ``merge_partials``, the plain
    version of the merge kernel; the tests set it, the wrappers never do.
    """
    _check_inputs(q, k, v, q_mask, kv_mask)
    b, tq, h, d = q.shape
    tk, dv = k.shape[1], v.shape[3]
    scale, kv_len = _scale_and_len(q, k, softmax_scale, kv_logical_len)
    valid = _valid_keys(q, k, kv_mask, kv_len)
    splits, per = _split_bounds(kv_len, num_splits)
    edges = [s * per * BLOCK_K for s in range(splits)] + [tk]

    kf = k.float().permute(0, 2, 3, 1)  # [B, H, D, Tk]
    vf = v.float().permute(0, 2, 1, 3)  # [B, H, Tk, Dv]
    out = torch.empty((b, h, tq, dv), dtype=torch.float32, device=q.device)
    lse = torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
    chunk = max(1, max_chunk_elems // max(1, b * h * tk))
    for t0 in range(0, tq, chunk):
        qc = q[:, t0:t0 + chunk].float().permute(0, 2, 1, 3)  # [B, H, c, D]
        parts = []
        for k0, k1 in zip(edges[:-1], edges[1:]):
            s = torch.matmul(qc, kf[..., k0:k1]) * scale
            s = s.masked_fill(~valid[..., k0:k1], -math.inf)
            m = s.amax(dim=-1, keepdim=True)
            m_safe = torch.where(m == -math.inf, torch.zeros_like(m), m)
            p = torch.exp(s - m_safe)
            parts.append((torch.matmul(p, vf[:, :, k0:k1]), m, p.sum(dim=-1, keepdim=True)))
        o, m, l = (torch.stack(x) for x in zip(*parts))
        out[:, :, t0:t0 + chunk], lse[:, :, t0:t0 + chunk] = merge_partials(o, m, l)
    out = out.permute(0, 2, 1, 3)  # [B, Tq, H, Dv]
    if q_mask is not None:
        out = out.masked_fill(~q_mask.to(torch.bool)[:, :, None, None], 0.0)
    out = out.reshape(b, tq, h * dv).to(q.dtype)
    return (out, lse) if return_lse else out


def merge_partials(o: torch.Tensor, m: torch.Tensor, l: torch.Tensor):
    """Plain version of the merge kernel: the splits' unnormalised outputs
    o [S, ..., Dv], maxima m and sums l [S, ..., 1] to (out [..., Dv], lse
    [...]).  out = sum_s o_s exp(m_s - M) / L with M = max m_s and L = sum_s
    l_s exp(m_s - M); a split with l_s = 0 (all its keys masked) drops out;
    where L = 0, out is 0 and lse is +inf."""
    live = l > 0
    m_max = torch.where(live, m, torch.full_like(m, -math.inf)).amax(dim=0)
    m_max = torch.where(m_max == -math.inf, torch.zeros_like(m_max), m_max)
    w = torch.where(live, torch.exp(m - m_max), torch.zeros_like(m))
    total = (l * w).sum(dim=0)
    total_safe = torch.where(total == 0, torch.ones_like(total), total)
    out = (o * w).sum(dim=0) / total_safe
    lse = torch.where(total == 0, torch.full_like(total, math.inf),
                      m_max + torch.log(total_safe))
    return out, lse[..., 0]


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
    num_splits: int = 1,
):
    """Plain PyTorch version of K2 and K3: same arguments as
    ``flash_attention_backward``, same semantics as the kernels.

    Recomputes p = exp(scale * q k^T - lse) in fp32, ``max_chunk_elems``
    logits at a time, chunked over query rows (the counterpart of
    ``_chunked_attention_bwd``).  Rows whose keys are all masked (lse =
    +inf) and q-masked rows carry zero gradient; keys at or beyond
    ``kv_logical_len`` get dk = dv = 0 exactly.  Returns (dq, dk, dv) in q's
    dtype.  ``num_splits`` > 1 sums dk and dv over that many ranges of whole
    query tiles and dq over that many ranges of whole key tiles
    (``_split_bounds``), each range's partial added in order, as the bf16
    kernels' split grids and their sum do; the tests set it, the wrappers
    never do.
    """
    _check_inputs(q, k, v, q_mask, kv_mask)
    b, tq, h, d = q.shape
    tk, dv = k.shape[1], v.shape[3]
    scale, kv_len = _scale_and_len(q, k, softmax_scale, kv_logical_len)
    valid = _valid_keys(q, k, kv_mask, kv_len)
    do, delta = _prepare_grad(q, v, out, grad_out, q_mask)
    do = do.float()
    q_splits, q_per = _split_bounds(tq, num_splits)
    q_edges = [s * q_per * BLOCK_Q for s in range(q_splits)] + [tq]
    k_splits, k_per = _split_bounds(kv_len, num_splits)
    k_edges = [s * k_per * BLOCK_K for s in range(k_splits)] + [tk]

    kf = k.float().permute(0, 2, 1, 3)  # [B, H, Tk, D]
    vf = v.float().permute(0, 2, 1, 3)  # [B, H, Tk, Dv]
    lse = lse.float()
    dq = torch.empty((b, h, tq, d), dtype=torch.float32, device=q.device)
    dk = torch.zeros((b, h, tk, d), dtype=torch.float32, device=q.device)
    dv_ = torch.zeros((b, h, tk, dv), dtype=torch.float32, device=q.device)
    chunk = max(1, max_chunk_elems // max(1, b * h * tk))
    for q0, q1 in zip(q_edges[:-1], q_edges[1:]):
        # One range sums into dk and dv directly; more sum their partials.
        whole = q_splits == 1
        dk_part = dk if whole else torch.zeros_like(dk)
        dv_part = dv_ if whole else torch.zeros_like(dv_)
        for t0 in range(q0, q1, chunk):
            rows = slice(t0, min(t0 + chunk, q1))
            qc = q[:, rows].float().permute(0, 2, 1, 3)  # [B, H, c, D]
            doc = do[:, rows].permute(0, 2, 1, 3)  # [B, H, c, Dv]
            s = torch.matmul(qc, kf.transpose(-1, -2)) * scale
            s = s.masked_fill(~valid, -math.inf)
            p = torch.exp(s - lse[:, :, rows, None])  # 0 on masked keys and rows
            dp = torch.matmul(doc, vf.transpose(-1, -2))
            ds = p * (dp - delta[:, :, rows, None])
            dv_part += torch.matmul(p.transpose(-1, -2), doc)
            dk_part += torch.matmul(ds.transpose(-1, -2), qc)
            k0, k1 = k_edges[:2]
            dq_rows = torch.matmul(ds[..., k0:k1], kf[:, :, k0:k1])
            for k0, k1 in zip(k_edges[1:-1], k_edges[2:]):
                dq_rows += torch.matmul(ds[..., k0:k1], kf[:, :, k0:k1])
            dq[:, :, rows] = dq_rows
        if not whole:
            dk += dk_part
            dv_ += dv_part
    return (
        (dq * scale).permute(0, 2, 1, 3).to(q.dtype),
        (dk * scale).permute(0, 2, 1, 3).to(q.dtype),
        dv_.permute(0, 2, 1, 3).to(q.dtype),
    )
