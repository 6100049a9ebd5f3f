"""Flash attention, forward and backward: hand-written CUDA kernels and
their plain versions.

Counterpart of ``perceiverio_pytorch_tpu/ops/pallas/flash_attention.py``:
``_flash_kernel`` (K1) is ``csrc/flash_attention_fwd_narrow_sm90.cu`` for
bf16 inputs whose head widths are at most ``NARROW_HEAD_DIM`` = 64 (the flow
self-attends: wgmma with P in registers, a producer warp feeding a K/V ring,
route ``sm90_narrow``), ``csrc/flash_attention_fwd_longkv_sm90.cu`` for bf16
calls with a short query range against many keys at widths of 257 to 704
(the classification and flow encoders, 257 to 512; the multimodal encoder,
704: Q resident, a producer warpgroup feeding K/V rings by TMA, route
``sm90_longkv``), ``csrc/flash_attention_fwd_longq_sm90.cu`` for bf16 calls
with many query rows against a short key range at widths of 257 to 512
(the flow decoder: persistent blocks walking the query tiles, route
``sm90_longq``),
``csrc/flash_attention_fwd_sm90.cu`` for other wider bf16 heads (wgmma,
route ``sm90_wgmma``) and ``csrc/flash_attention_fwd.cu`` for
fp32 ones (IEEE fp32 on the CUDA cores, route ``cuda_cores``), which also
holds the merge of split-KV partials;
``_bwd_dkv_kernel`` (K2) and ``_bwd_dq_kernel`` (K3) are
``csrc/flash_attention_bwd_narrow_sm90.cu`` for bf16 inputs whose head widths
are at most ``NARROW_HEAD_DIM`` (the flow self-attends: wgmma with P and dS
in registers, a producer warp feeding a ring, route ``sm90_narrow``),
``csrc/flash_attention_bwd_sm90.cu`` for wider bf16 heads (wgmma, route
``sm90_wgmma``, with the ordered sum of their split partials) and
``csrc/flash_attention_bwd.cu`` for fp32 ones (route ``cuda_cores``); where a
bf16 backward has a short query range against many keys at widths of 257 to
704 (the classification encoders, 257 to 512; the multimodal encoder, 704),
K2 and K3 are
``csrc/flash_attention_bwd_longkv_sm90.cu`` (a producer warpgroup feeding
rings of column chunks by TMA, route ``sm90_longkv``: K2 in persistent
blocks of keys, K3 in blocks of query rows with Q and dO resident; rows
that are not 16-byte aligned are copied into aligned ones first by its copy
kernel, once for both; the forward's copies are its own).  The
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
    however many CUDA launches it makes; ``LAUNCHES_NARROW`` counts the K1
    launches that took the narrow route (each also counts in ``LAUNCHES``)
    and ``LAUNCHES_BWD_NARROW`` the K2 and K3 launches that did (each also
    counts in ``LAUNCHES_BWD_DKV`` or ``LAUNCHES_BWD_DQ``).
    ``LAUNCHES_LONGKV`` counts the K1 launches on the long-KV route (each
    also in ``LAUNCHES``), ``LAUNCHES_LONGQ`` those on the long-Q route
    (each also in ``LAUNCHES``) and ``LAUNCHES_FWD_COPY`` the launches of
    their copies into aligned rows (``launch_plan``'s ``copies``).
    ``LAUNCHES_BWD_LONGKV`` counts the K2 launches on the long-KV route
    (each also counts in ``LAUNCHES_BWD_DKV``), ``LAUNCHES_BWD_DQ_LONGKV``
    the K3 launches there (each also in ``LAUNCHES_BWD_DQ``) and
    ``LAUNCHES_BWD_COPY`` the launches of their copies into aligned rows
    (``_longkv_copies``; K3 reuses K2's).
    ``LAUNCHES_MERGE`` counts the merge kernel's launches (K1 calls with
    more than one key split) and ``LAUNCHES_BWD_SUM`` the sum kernel's (K2
    or K3 calls with more than one split).
  * ``launch_plan`` says what a K1 call on given tensors launches: route,
    key splits (``_split_plan``; the narrow route never splits), value-column
    chunks (``_col_chunks``), blocks, CUDA launches and the bf16 kernels'
    ``loader`` (cp.async copies, the realigning loader for rows that
    cp.async cannot copy, or 2-byte copies: ``_loader``); ``backward_plan`` the same
    for K2 (query splits, ``_dkv_split_plan``) and K3 (key splits,
    ``_split_plan``, or ``_longkv_dq_split_plan`` on the long-KV route; the
    narrow and long-KV routes never split K2), with their output-column
    chunks and the long-KV kernels' ``loader`` (``_longkv_loader``).
  * Each kernel states its own head-width limit: K1 takes Dqk and Dv up to
    ``MAX_HEAD_DIM_FWD`` = 704 (the multimodal encoder's single head; above
    512, off the long-KV route, its grid splits the value columns in two),
    K2 and K3 up to
    ``MAX_HEAD_DIM_BWD`` = 704 (above 512, off the long-KV route, K3's grid
    splits the dQ columns in chunks of 352, the fp32 K2's the dK and dV
    columns in two, and the bf16 K2 takes 16 keys a block; the long-KV K2
    keeps 32 keys an item and K3 takes 16 keys a step, unsplit columns).  A
    CUDA call above a kernel's limit
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
            "fwd_narrow": "flash_attention_fwd_narrow_sm90.cu",
            "fwd_longkv": "flash_attention_fwd_longkv_sm90.cu",
            "fwd_longq": "flash_attention_fwd_longq_sm90.cu",
            "bwd": "flash_attention_bwd.cu", "bwd_sm90": "flash_attention_bwd_sm90.cu",
            "bwd_narrow": "flash_attention_bwd_narrow_sm90.cu",
            "bwd_longkv": "flash_attention_bwd_longkv_sm90.cu"}
_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build", "kernels")

# Head-width limits (Dqk and Dv) of the kernels' shared-memory and register
# plans (see the .cu source notes): K1 forward, K2/K3 backward.  Above
# COL_CHUNK columns the grids split output columns into chunks: K1's value
# columns in at most COL_CHUNK, K3's dQ columns in WIDE_DQ_CHUNK (the bf16
# kernel's; the fp32 one splits them as evenly), and the fp32 K2's dK and dV
# columns as K1 splits its values.
MAX_HEAD_DIM_FWD = 704
MAX_HEAD_DIM_BWD = 704
# bf16 K1, K2 and K3 calls whose Dqk and Dv are both at most this take the
# narrow-head kernels (two warpgroups of 64 query rows, or of 64 keys for K2,
# a block; never a split).
NARROW_HEAD_DIM = 64
NARROW_BLOCK_Q = 128
NARROW_BLOCK_K = 128
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
# bf16 calls whose wider head is LONGKV_MIN_WIDTH to COL_CHUNK columns wide
# (where the wgmma K2 holds 32 keys a block), with at most LONGKV_MAX_Q
# query rows a (batch, head) (8 tiles of 64; K1 LONGKV_K1_MAX_Q, 32 tiles:
# the flow encoder, 2,048 latents over 182,528 pixels, 322 wide), or
# COL_CHUNK + 1 to MAX_HEAD_DIM_FWD (= MAX_HEAD_DIM_BWD) wide with at most
# LONGKV_WIDE_MAX_Q (16 tiles: the multimodal encoder, 784 latents over
# 52,097 keys, 704 wide), over at least LONGKV_MIN_K keys (a key block of
# LONGKV_BLOCK_K for every SM), take the long-KV kernels when no split
# count is forced (``_longkv_shape``): K1 forward, K2 and K3 backward.  K2:
# persistent blocks, at most one an SM, walking work items of
# LONGKV_BLOCK_K keys.  K3: a block of 64 query rows walks its key split in
# steps of LONGKV_BLOCK_K keys (16 above COL_CHUNK columns), the keys split
# so that every block runs in one wave (``_longkv_dq_split_plan``).  K1: a
# block of 64 query rows walks its key split in steps of 64 keys, its value
# columns never split, the keys split as K3's or, at the rows only K1 takes
# (the flow encoder), as K3's or for whole waves, whichever ends sooner
# (``_longkv_fwd_split_plan``: a block's walk counted as its key tiles plus
# LONGKV_BLOCK_TILES for its Q load, its first chunks and its epilogue).
LONGKV_MIN_WIDTH = 257
LONGKV_MAX_Q = 512
LONGKV_K1_MAX_Q = 2048
LONGKV_WIDE_MAX_Q = 1024
LONGKV_BLOCK_K = 32
LONGKV_MIN_K = NUM_SMS * LONGKV_BLOCK_K
LONGKV_BLOCK_TILES = 4
# bf16 K1 calls whose wider head is LONGKV_MIN_WIDTH to COL_CHUNK columns
# wide with at least LONGQ_MIN_Q query rows a (batch, head) (a tile of 64
# for every SM) over at most LONGQ_MAX_K keys (K and V of a batch entry, 16
# MB at 512 wide, stay in L2 while every query tile reads them) take the
# long-Q kernel when no split count is forced (``_longq_shape``: the flow
# decoder, 182,528 queries over 2,048 latents, 512 wide): persistent
# blocks, min(query tiles x B x H, NUM_SMS), walking the query tiles, the
# keys never split.
LONGQ_MIN_Q = NUM_SMS * BLOCK_Q
LONGQ_MAX_K = 8192

# Kernel launches since import (or since the caller last reset them): K1,
# K2 and K3, the merge of K1's split-KV partials and the sum of K2's or K3's
# split partials.
LAUNCHES = 0
LAUNCHES_NARROW = 0
LAUNCHES_LONGKV = 0
LAUNCHES_FWD_COPY = 0
LAUNCHES_LONGQ = 0
LAUNCHES_BWD_DKV = 0
LAUNCHES_BWD_NARROW = 0
LAUNCHES_BWD_LONGKV = 0
LAUNCHES_BWD_DQ_LONGKV = 0
LAUNCHES_BWD_COPY = 0
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
    "fwd_narrow", "fwd_longkv", "bwd", "bwd_sm90", "bwd_narrow",
    "bwd_longkv"): the name
    carries the hash of the source and of every ``csrc/*.cuh`` header, so an
    edit to either builds a new library."""
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
            fwd_narrow = ctypes.CDLL(paths["fwd_narrow"])
            fwd_narrow.flash_attention_fwd_narrow_sm90.argtypes = (
                [ctypes.c_void_p] * 7  # q, k, v, kv_mask, q_mask, out, lse
                + [ctypes.c_int] * 7  # B, H, Tq, Tk, kv_len, D, Dv
                + _STRIDES * 3  # q, k, v
                + [ctypes.c_float, ctypes.c_void_p]  # scale, stream
            )
            fwd_narrow.flash_attention_fwd_narrow_sm90.restype = ctypes.c_int
            fwd_longkv = ctypes.CDLL(paths["fwd_longkv"])
            fwd_longkv.flash_attention_fwd_longkv_sm90.argtypes = (
                # q, k, v, kv_mask, q_mask, out, lse, part_o, part_m, part_l
                [ctypes.c_void_p] * 10
                # B, H, Tq, Tk, kv_len, D, Dv, splits, tiles_per_split
                + [ctypes.c_int] * 9
                + _STRIDES * 3  # q, k, v
                + [ctypes.c_float, ctypes.c_void_p]  # scale, stream
            )
            fwd_longkv.flash_attention_fwd_longkv_sm90.restype = ctypes.c_int
            fwd_longq = ctypes.CDLL(paths["fwd_longq"])
            fwd_longq.flash_attention_fwd_longq_sm90.argtypes = (
                [ctypes.c_void_p] * 7  # q, k, v, kv_mask, q_mask, out, lse
                + [ctypes.c_int] * 7  # B, H, Tq, Tk, kv_len, D, Dv
                + _STRIDES * 3  # q, k, v
                + [ctypes.c_float, ctypes.c_void_p]  # scale, stream
            )
            fwd_longq.flash_attention_fwd_longq_sm90.restype = ctypes.c_int
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
            bwd_narrow = ctypes.CDLL(paths["bwd_narrow"])
            for fn in (bwd_narrow.flash_attention_bwd_dkv_narrow_sm90,
                       bwd_narrow.flash_attention_bwd_dq_narrow_sm90):
                fn.argtypes = (
                    # q, k, v, dout, lse, delta, kv_mask, dq, dk, dv
                    [ctypes.c_void_p] * 10
                    + [ctypes.c_int] * 7  # B, H, Tq, Tk, kv_len, D, Dv
                    + _STRIDES * 4  # q, k, v, dout
                    + [ctypes.c_float, ctypes.c_void_p]  # scale, stream
                )
                fn.restype = ctypes.c_int
            bwd_longkv = ctypes.CDLL(paths["bwd_longkv"])
            bwd_longkv.flash_attention_bwd_dkv_longkv_sm90.argtypes = (
                [ctypes.c_void_p] * 9  # q, k, v, dout, lse, delta, kv_mask, dk, dv
                + [ctypes.c_int] * 8  # B, H, Tq, Tk, kv_len, D, Dv, blocks
                + _STRIDES * 4  # q, k, v, dout
                + [ctypes.c_float, ctypes.c_void_p]  # scale, stream
            )
            bwd_longkv.flash_attention_bwd_dkv_longkv_sm90.restype = ctypes.c_int
            bwd_longkv.flash_attention_bwd_dq_longkv_sm90.argtypes = (
                # q, k, v, dout, lse, delta, kv_mask, dq, part_q
                [ctypes.c_void_p] * 9
                # B, H, Tq, Tk, kv_len, D, Dv, splits, tiles_per_split
                + [ctypes.c_int] * 9
                + _STRIDES * 4  # q, k, v, dout
                + [ctypes.c_float, ctypes.c_void_p]  # scale, stream
            )
            bwd_longkv.flash_attention_bwd_dq_longkv_sm90.restype = ctypes.c_int
            for fn in (fwd_longkv.flash_attention_fwd_longkv_copy_rows,
                       bwd_longkv.flash_attention_bwd_longkv_copy_rows):
                fn.argtypes = (
                    [ctypes.c_void_p] * 2  # src, dst
                    + [ctypes.c_int] * 4  # B, T, H, W
                    + _STRIDES  # src
                    + [ctypes.c_void_p]  # stream
                )
                fn.restype = ctypes.c_int
            _libs = {"fwd": fwd, "fwd_sm90": fwd_sm90, "fwd_narrow": fwd_narrow,
                     "fwd_longkv": fwd_longkv, "fwd_longq": fwd_longq, "bwd": bwd,
                     "bwd_sm90": bwd_sm90, "bwd_narrow": bwd_narrow, "bwd_longkv": bwd_longkv}
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
    """The wgmma and fp32 K1's split-KV plan: (splits, tiles_per_split) for
    B, Tq, H, the keys' length and the value-column chunks of the grid
    (the wgmma K3's too).

    A grid of at least two blocks per SM takes one split.  A shorter one
    (the flow encoder's shape: 32 query blocks a batch entry) starts from enough
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


def _byte_addr(t: torch.Tensor) -> int:
    """``t``'s address (on ``meta``, its storage offset in bytes)."""
    return t.storage_offset() * t.element_size() if t.device.type == "meta" else t.data_ptr()


def _copy_bytes(t: torch.Tensor, width: int) -> int:
    """The widest cp.async copy (16, 8, 4 or 2 bytes) that ``t``'s address,
    batch, token and head strides and row width all allow (csrc/sm90.cuh
    ``copy_vec``)."""
    size = t.element_size()
    sizes = [_byte_addr(t), width * size] + [st * size for st in t.stride()[:3]]
    return next(n for n in (16, 8, 4, 2) if all(x % n == 0 for x in sizes))


def _covers(width: int, tile: int) -> bool:
    """csrc/sm90.cuh ``cover_fits``: the aligned 16-byte chunks that cover a
    bf16 row of ``width`` at any 2-byte alignment fit a tile row of ``tile``
    columns."""
    return width + 7 <= tile


def _loader(q, k, v, narrow: bool) -> str:
    """How K1's bf16 kernels bring q, k and v into shared memory:
    "cp.async16", "cp.async8" or "cp.async4" when every operand takes cp.async
    copies of at least that many bytes, "realign" when one or more takes the
    realigning loader (aligned 16-byte chunks shifted into place: the narrow
    route's rows that are not 16-byte aligned, such as 41 wide; the wgmma
    route's rows aligned to 2 bytes only, such as the pixel encoder's 261
    wide or an odd offset view), "copy2" when the wgmma route copies one or
    more 2 bytes at a time (rows aligned to 2 bytes only whose covering
    chunks do not fit the tile: ``_covers`` at Q's and K's padded width and
    at the value columns of the kernel's instantiation, 128, 336 or 512);
    the fp32 kernel loads elements ("elements")."""
    if q.dtype != torch.bfloat16:
        return "elements"
    least = min(_copy_bytes(t, t.shape[3]) for t in (q, k, v))
    if narrow:
        return "realign" if least < 16 else "cp.async16"
    if least >= 4:
        return f"cp.async{least}"
    d, dv = q.shape[3], v.shape[3]
    cw = -(-(-(-dv // _col_chunks(dv))) // 16) * 16  # value columns of chunk 0
    half = cw // 2
    tiles = (-(-d // 16) * 16,) * 2 + (2 * (64 if half <= 64 else 168 if half <= 168 else 256),)
    widths = (d, d, min(cw, dv))
    covered = all(_covers(w, c) for t, w, c in zip((q, k, v), widths, tiles)
                  if _copy_bytes(t, t.shape[3]) == 2)
    return "realign" if covered else "copy2"


def launch_plan(q, k, v, *, kv_logical_len=None, num_splits=None) -> Dict:
    """What a K1 call on these tensors launches: ``route`` ("sm90_narrow"
    for bf16 on CUDA with Dqk and Dv at most NARROW_HEAD_DIM, "sm90_longq"
    for bf16 of the long-Q shape (``_longq_shape``: the flow decoder),
    "sm90_longkv" for bf16 of K1's long-KV shape (``_longkv_shape``: the
    classification, flow and multimodal encoders), "sm90_wgmma" for other
    wider bf16 heads, "cuda_cores" for fp32), ``splits`` and
    ``tiles_per_split`` (``_split_plan``; on the long-KV route
    ``_longkv_fwd_split_plan``, whole waves of blocks; or ``num_splits``
    ranges when given; the narrow and long-Q routes walk all keys in one
    split, and a forced ``num_splits`` takes the split-KV kernel,
    "sm90_wgmma"), ``col_chunks`` (``_col_chunks``: the grid's split of the
    value columns; 1 on the long-KV and long-Q routes, whose blocks hold all
    of them), ``blocks`` of the main kernel's grid (on the long-Q route the
    persistent blocks, min(query tiles x B x H, NUM_SMS)),
    ``cuda_launches`` (the kernel, the merge when there is more than one
    split, and on the long-KV and long-Q routes one copy launch for each of
    its ``copies``) and ``loader`` (``_loader``; on the long-KV and long-Q
    routes ``_longkv_loader``, with ``copies``: the operands first copied
    into 16-byte aligned rows, ``_k1_copies``)."""
    b, tq, h, d = q.shape
    _, kv_len = _scale_and_len(q, k, None, kv_logical_len)
    if (q.dtype == torch.bfloat16 and num_splits is None
            and max(d, v.shape[3]) <= NARROW_HEAD_DIM):
        return dict(route="sm90_narrow", splits=1, tiles_per_split=-(-kv_len // BLOCK_K),
                    col_chunks=1, blocks=-(-tq // NARROW_BLOCK_Q) * h * b, cuda_launches=1,
                    loader=_loader(q, k, v, narrow=True))
    width = max(d, v.shape[3])
    if q.dtype == torch.bfloat16 and num_splits is None and _longq_shape(tq, k.shape[1], width):
        copies = _k1_copies(q, k, v)
        return dict(route="sm90_longq", splits=1, tiles_per_split=-(-kv_len // BLOCK_K),
                    col_chunks=1, blocks=min(-(-tq // BLOCK_Q) * h * b, NUM_SMS),
                    cuda_launches=1 + len(copies), loader=_longkv_loader(k, v), copies=copies)
    if (q.dtype == torch.bfloat16 and num_splits is None
            and _longkv_shape(tq, k.shape[1], width, LONGKV_K1_MAX_Q)):
        splits, per = _longkv_fwd_split_plan(b, tq, h, kv_len, width)
        copies = _k1_copies(q, k, v)
        return dict(route="sm90_longkv", splits=splits, tiles_per_split=per, col_chunks=1,
                    blocks=-(-tq // BLOCK_Q) * h * b * splits,
                    cuda_launches=1 + (splits > 1) + len(copies),
                    loader=_longkv_loader(k, v), copies=copies)
    chunks = _col_chunks(v.shape[3])
    splits, per = (_split_plan(b, tq, h, kv_len, chunks) if num_splits is None
                   else _split_bounds(kv_len, num_splits))
    return dict(
        route="sm90_wgmma" if q.dtype == torch.bfloat16 else "cuda_cores",
        splits=splits, tiles_per_split=per, col_chunks=chunks,
        blocks=-(-tq // BLOCK_Q) * h * b * chunks * splits,
        cuda_launches=1 + (splits > 1), loader=_loader(q, k, v, narrow=False),
    )


def _longkv_shape(tq: int, tk: int, width: int, max_q: int) -> bool:
    """The shape that bf16 K1, K2 and K3 take the long-KV kernels at: a
    short query range over at least LONGKV_MIN_K keys, at a wider head of
    LONGKV_MIN_WIDTH to COL_CHUNK columns at most ``max_q`` query rows (K2
    and K3: LONGKV_MAX_Q, the classification encoders; K1:
    LONGKV_K1_MAX_Q, also the flow encoder, 2,048 latents over 182,528
    pixels, 322 wide, whose K2 and K3 keep the wgmma kernels), or at most
    LONGKV_WIDE_MAX_Q at COL_CHUNK + 1 to MAX_HEAD_DIM_BWD (the multimodal
    encoder: 784 latents over 52,097 keys, 704 wide)."""
    max_q = (max_q if LONGKV_MIN_WIDTH <= width <= COL_CHUNK
             else LONGKV_WIDE_MAX_Q if COL_CHUNK < width <= MAX_HEAD_DIM_BWD else -1)
    return tq <= max_q and tk >= LONGKV_MIN_K


def _longq_shape(tq: int, tk: int, width: int) -> bool:
    """The shape that bf16 K1 takes the long-Q kernel at: a wider head of
    LONGKV_MIN_WIDTH to COL_CHUNK columns, at least LONGQ_MIN_Q query rows
    over at most LONGQ_MAX_K keys (the flow decoder: 182,528 queries over
    2,048 latents, 512 wide)."""
    return LONGKV_MIN_WIDTH <= width <= COL_CHUNK and tq >= LONGQ_MIN_Q and tk <= LONGQ_MAX_K


def _k1_copies(q, k, v) -> Tuple[str, ...]:
    """The operands the long-KV and long-Q K1 read from copies in 16-byte
    aligned rows (one copy kernel launch each): those whose rows TMA cannot
    address (``_tma_rows``: the flow encoder's 644-byte rows, offset
    views)."""
    return tuple(name for name, t in (("q", q), ("k", k), ("v", v)) if not _tma_rows(t))


def _tma_rows(t: torch.Tensor) -> bool:
    """A start and batch, token and head strides of ``t`` that are multiples
    of 16 bytes: what a TMA copy addresses (a row may end anywhere)."""
    size = t.element_size()
    return all(x % 16 == 0 for x in [_byte_addr(t)] + [st * size for st in t.stride()[:3]])


def _longkv_loader(k, v) -> str:
    """How the long-KV K1, K2 and K3 bring the K and V rows into shared memory:
    "tma" when both have 16-byte aligned rows (``_tma_rows``), else "copy":
    those not aligned are first copied into 16-byte aligned rows
    (``_longkv_copies``), then "tma"."""
    return "tma" if _tma_rows(k) and _tma_rows(v) else "copy"


def _longkv_copies(q, k, v) -> Tuple[str, ...]:
    """The operands the long-KV kernels read from copies in 16-byte aligned
    rows (one copy kernel launch each): q, the output's gradient (made
    contiguous by the wrapper: rows dv wide), k and v wherever their rows
    are not aligned (the pixel encoder's 522-byte rows: all four, 843 MB of
    K and V at batch 8).  K2 makes them and K3 reads the same copies; K3
    makes them itself when ``dkv()`` did not run first."""
    return tuple((["q"] if not _tma_rows(q) else []) + (["dout"] if v.shape[3] % 8 else [])
                 + [name for name, t in (("k", k), ("v", v)) if not _tma_rows(t)])


def _longkv_fwd_split_plan(b: int, tq: int, h: int, kv_len: int, width: int):
    """The long-KV K1's key splits: (splits, tiles_per_split).  K3's
    one-wave plan (``_longkv_dq_split_plan``) where K2 and K3 take the
    long-KV route too (the classification and multimodal encoders).  At the
    rows only K1 takes (more than LONGKV_MAX_Q at LONGKV_MIN_WIDTH to
    COL_CHUNK columns: the flow encoder), of that plan and the fewest
    splits whose blocks fill whole waves (NUM_SMS / gcd(blocks, NUM_SMS),
    each split at least MIN_SPLIT_TILES key tiles), the one whose blocks
    end sooner, counted as waves of NUM_SMS blocks times the key tiles a
    block walks plus LONGKV_BLOCK_TILES; the one-wave plan on a tie.  The
    flow encoder: 4 splits at batch 1 (128 blocks, one wave), 11 at its 6
    tiles (2,112 blocks, 16 waves, where one split left 1.45)."""
    one_wave = _longkv_dq_split_plan(b, tq, h, kv_len)
    if tq <= LONGKV_MAX_Q or width > COL_CHUNK:
        return one_wave
    blocks = -(-tq // BLOCK_Q) * h * b
    tiles = -(-kv_len // BLOCK_K)
    whole = _split_bounds(kv_len, min(NUM_SMS // math.gcd(blocks, NUM_SMS),
                                      max(1, tiles // MIN_SPLIT_TILES)))
    return min((one_wave, whole),
               key=lambda plan: -(-blocks * plan[0] // NUM_SMS) * (plan[1] + LONGKV_BLOCK_TILES))


def _longkv_dq_split_plan(b: int, tq: int, h: int, kv_len: int):
    """The long-KV K3's and K1's key splits: (splits, tiles_per_split).  As
    many as keep all blocks in one wave of one block an SM (NUM_SMS // the
    blocks of a split, each block 64 query rows), at least MIN_SPLIT_TILES
    key tiles each: at the classification encoders (8 query tiles a batch
    entry) 1 at batch 16, 2 at 8, 4, 8 and 16 at the server's buckets 4, 2
    and 1 (128 blocks each); at the multimodal encoder (13 query tiles) 10
    of 82 tiles at batch 1 (130 blocks, K1 and K3 alike), 5 at batch 2; 1
    where a split's blocks outnumber the SMs (batch 16 there: 208 blocks,
    two waves)."""
    blocks = -(-tq // BLOCK_Q) * h * b
    tiles = -(-kv_len // BLOCK_K)
    return _split_bounds(kv_len, max(1, min(NUM_SMS // blocks, tiles // MIN_SPLIT_TILES)))


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
    ("sm90_narrow" for bf16 with Dqk and Dv at most NARROW_HEAD_DIM and no
    forced split: one launch each, K2 a block per NARROW_BLOCK_K keys, K3 per
    NARROW_BLOCK_Q query rows, never split; "sm90_wgmma" for wider bf16
    heads or a forced ``num_splits``; "sm90_longkv" for bf16 calls of
    ``_longkv_shape`` (K1's too: the wider head LONGKV_MIN_WIDTH to COL_CHUNK
    columns wide with at most LONGKV_MAX_Q query rows, or up to
    MAX_HEAD_DIM_BWD with at most LONGKV_WIDE_MAX_Q, over at least
    LONGKV_MIN_K keys) and no forced
    split: K2 the long-KV kernel, ``blocks`` persistent blocks (at most one
    an SM) walking ``items`` blocks of LONGKV_BLOCK_K keys, its ``loader``
    (``_longkv_loader``) and the ``copies`` it first makes into aligned rows
    (``_longkv_copies``, one launch each before the kernel's); K3 the
    long-KV kernel, ``blocks`` of 64 query rows over
    ``_longkv_dq_split_plan``'s key splits, reading the same ``loader`` and
    ``copies`` (K2's: its ``cuda_launches`` count none, as when ``dkv()``
    runs first); "cuda_cores" for fp32) and, under
    "dkv" (K2) and "dq" (K3), ``splits`` and ``tiles_per_split`` (K2's
    query ranges by ``_dkv_split_plan``, K3's key ranges by ``_split_plan``
    counted with K3's column chunks, or ``num_splits`` ranges for both when
    given), ``col_chunks`` (the grid's split of the kernel's output columns:
    above COL_CHUNK columns of d or dv, K3 splits dQ's into ceil(d /
    WIDE_DQ_CHUNK) on the wgmma and fp32 routes and the fp32 K2 dK's and
    dV's in two; the wgmma K2 takes 16 keys a block there instead; the
    long-KV kernels never split columns), ``blocks`` of the
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
    if num_splits is None and width <= NARROW_HEAD_DIM:
        return dict(
            route="sm90_narrow",
            dkv=dict(splits=1, tiles_per_split=-(-tq // BLOCK_Q), col_chunks=1,
                     blocks=-(-tk // NARROW_BLOCK_K) * h * b, cuda_launches=1),
            dq=dict(splits=1, tiles_per_split=-(-kv_len // BLOCK_K), col_chunks=1,
                    blocks=-(-tq // NARROW_BLOCK_Q) * h * b, cuda_launches=1),
        )
    if num_splits is None and _longkv_shape(tq, tk, width, LONGKV_MAX_Q):
        items = -(-tk // LONGKV_BLOCK_K) * h * b
        copies, loader = _longkv_copies(q, k, v), _longkv_loader(k, v)
        splits, per = _longkv_dq_split_plan(b, tq, h, kv_len)
        return dict(
            route="sm90_longkv",
            dkv=dict(splits=1, tiles_per_split=-(-tq // BLOCK_Q), col_chunks=1,
                     blocks=min(items, NUM_SMS), cuda_launches=1 + len(copies), items=items,
                     loader=loader, copies=copies),
            dq=dict(splits=splits, tiles_per_split=per, col_chunks=1, blocks=q_blocks * splits,
                    cuda_launches=1 + (splits > 1), loader=loader, copies=copies))
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
    """K1 on CUDA tensors: the narrow-head kernel for bf16 heads up to
    NARROW_HEAD_DIM wide, the long-Q and long-KV kernels for bf16 calls of
    their shapes (after copies of the operands whose rows they cannot
    address), the sm90 kernel for other wider bf16 heads, the CUDA-core
    kernel for fp32, then
    the merge when the plan splits the keys.  ``num_splits`` overrides the
    plan (for tests that hold split counts against each other; it takes the
    split-KV kernels)."""
    global LAUNCHES, LAUNCHES_MERGE, LAUNCHES_NARROW, LAUNCHES_LONGKV, LAUNCHES_LONGQ
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
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        strides = (*q.stride()[:3], *k.stride()[:3], *v.stride()[:3])
        if plan["route"] == "sm90_narrow":
            err = libs["fwd_narrow"].flash_attention_fwd_narrow_sm90(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(kv_mask_c), _ptr(q_mask_c),
                out.data_ptr(), _ptr(lse), b, h, tq, tk, kv_len, d, dv, *strides, scale,
                stream)
        elif plan["route"] == "sm90_longkv":
            err = _longkv_forward(libs["fwd_longkv"], plan, q, k, v, kv_mask_c, q_mask_c, out,
                                  lse, part_o, part_ml, kv_len, scale, stream)
        elif plan["route"] == "sm90_longq":
            err, args = _aligned_rows(libs["fwd_longkv"], plan["copies"], q, k, v, stream)
            if err == 0:
                err = libs["fwd_longq"].flash_attention_fwd_longq_sm90(
                    *(t.data_ptr() for t in args), _ptr(kv_mask_c), _ptr(q_mask_c),
                    out.data_ptr(), _ptr(lse), b, h, tq, tk, kv_len, d, dv,
                    *(x for t in args for x in t.stride()[:3]), scale, stream)
        else:
            kernel = (libs["fwd_sm90"].flash_attention_fwd_sm90
                      if plan["route"] == "sm90_wgmma" else libs["fwd"].flash_attention_fwd)
            err = kernel(
                q.data_ptr(), k.data_ptr(), v.data_ptr(),
                _ptr(kv_mask_c), _ptr(q_mask_c), out.data_ptr(), _ptr(lse),
                _ptr(part_o), _ptr(None if part_ml is None else part_ml[0]),
                _ptr(None if part_ml is None else part_ml[1]),
                b, h, tq, tk, kv_len, d, dv, splits, plan["tiles_per_split"],
                plan["col_chunks"], *strides, scale, stream,
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
    LAUNCHES_NARROW += plan["route"] == "sm90_narrow"
    LAUNCHES_LONGKV += plan["route"] == "sm90_longkv"
    LAUNCHES_LONGQ += plan["route"] == "sm90_longq"
    return (out, lse) if return_lse else out


def _copy_rows(fn, t, stream):
    """(error, copy): ``t`` [B, T, H, W] copied by ``fn`` (a long-KV
    library's copy kernel) into contiguous rows of W rounded up to 8 (16
    bytes), zeros in the pad columns."""
    b, n, h, w = t.shape
    copy = torch.empty((b, n, h, -(-w // 8) * 8), dtype=t.dtype, device=t.device)
    return fn(t.data_ptr(), copy.data_ptr(), b, n, h, w, *t.stride()[:3], stream), copy


def _aligned_rows(lib, copies, q, k, v, stream):
    """(error, [q, k, v]) with the operands named in ``copies`` copied into
    16-byte aligned rows by the long-KV library's copy kernel (let go once
    the kernel that reads them is enqueued: the caching allocator reuses
    them only after it, in stream order); the first nonzero error."""
    global LAUNCHES_FWD_COPY
    ops = {"q": q, "k": k, "v": v}
    for name in copies:
        err, ops[name] = _copy_rows(lib.flash_attention_fwd_longkv_copy_rows, ops[name], stream)
        if err != 0:
            return err, None
        LAUNCHES_FWD_COPY += 1
    return 0, [ops[name] for name in ("q", "k", "v")]


def _longkv_forward(lib, plan, q, k, v, kv_mask, q_mask, out, lse, part_o, part_ml, kv_len,
                    scale, stream):
    """The long-KV K1: the operands named in ``plan["copies"]`` copied into
    16-byte aligned rows (``_aligned_rows``), then the kernel; the first
    nonzero error."""
    err, args = _aligned_rows(lib, plan["copies"], q, k, v, stream)
    if err != 0:
        return err
    b, tq, h, d = q.shape
    return lib.flash_attention_fwd_longkv_sm90(
        *(t.data_ptr() for t in args), _ptr(kv_mask), _ptr(q_mask), out.data_ptr(), _ptr(lse),
        _ptr(part_o), _ptr(None if part_ml is None else part_ml[0]),
        _ptr(None if part_ml is None else part_ml[1]), b, h, tq, k.shape[1], kv_len, d,
        v.shape[3], plan["splits"], plan["tiles_per_split"],
        *(x for t in args for x in t.stride()[:3]), scale, stream)


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
        if self.plan["route"] == "sm90_longkv" and not (
                do.is_contiguous() and do.data_ptr() % 16 == 0):
            do = do.clone(memory_format=torch.contiguous_format)  # as _longkv_copies assumes
        if self.plan["route"] == "cuda_cores" and num_splits not in (None, 1):
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
        self._copies = {}  # the long-KV kernels' aligned copies, by operand, until K3's launch

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
        route = self.plan["route"]
        with torch.cuda.device(self._device):
            stream = torch.cuda.current_stream(self._device).cuda_stream
            if route == "sm90_narrow":
                err = getattr(libs["bwd_narrow"], name + "_narrow_sm90")(
                    *self._inputs, *self._dims, *self._strides, self._scale, stream)
            elif route == "sm90_longkv" and kernel == "dkv":
                err = self._longkv_dkv(libs["bwd_longkv"], plan, stream)
            elif route == "sm90_longkv":
                err = self._longkv_dq(libs["bwd_longkv"], plan, parts[0], stream)
            elif route == "sm90_wgmma":
                part_q, part_k, part_v = ((parts[0], None, None) if kernel == "dq"
                                          else (None, *parts))
                err = getattr(libs["bwd_sm90"], name + "_sm90")(
                    *self._inputs, _ptr(part_q), _ptr(part_k), _ptr(part_v), *self._dims,
                    splits, per, chunks, *self._strides, self._scale, stream)
            else:
                err = getattr(libs["bwd"], name)(
                    *self._inputs, *self._dims, chunks, *self._strides, self._scale, stream)
            if err != 0:
                raise RuntimeError(f"{name} ({route}) launch failed: CUDA error {err}")
            if splits > 1:
                pairs = [(_ptr(part), g.data_ptr(), g.numel()) for part, g in zip(parts, grads)]
                pairs += [(None, None, 0)] * (2 - len(pairs))
                err = libs["bwd_sm90"].flash_attention_bwd_sum(*pairs[0], *pairs[1], splits, stream)
                if err != 0:
                    raise RuntimeError(f"flash_attention_bwd_sum launch failed: CUDA error {err}")
                LAUNCHES_BWD_SUM += 1
        return True

    def _aligned(self, lib, names, stream, made):
        """(error, [q, k, v, dout]) with the operands in ``names`` taken from
        copies in 16-byte aligned rows: those in ``made`` as they are, the
        others each copied by one copy kernel launch into ``made``, which
        the caller keeps while the kernel may read them; the first nonzero
        error and None if a copy fails."""
        global LAUNCHES_BWD_COPY
        q, k, v, do = self._keep[:4]
        ops = {"q": q, "k": k, "v": v, "dout": do}
        for name in names:
            if name not in made:
                err, made[name] = _copy_rows(lib.flash_attention_bwd_longkv_copy_rows,
                                             ops[name], stream)
                if err != 0:
                    return err, None
                LAUNCHES_BWD_COPY += 1
            ops[name] = made[name]
        return 0, [ops[name] for name in ("q", "k", "v", "dout")]

    def _longkv_dkv(self, lib, plan, stream):
        """The long-KV K2: its operands named in ``plan["copies"]`` copied
        into 16-byte aligned rows (every call; kept for K3), then the
        kernel; the first nonzero error."""
        self._copies = {}
        err, args = self._aligned(lib, plan["copies"], stream, self._copies)
        if err != 0:
            return err
        strides = [x for t in args for x in t.stride()[:3]]
        return lib.flash_attention_bwd_dkv_longkv_sm90(
            *(t.data_ptr() for t in args), *self._inputs[4:7], *self._inputs[8:],
            *self._dims, plan["blocks"], *strides, self._scale, stream)

    def _longkv_dq(self, lib, plan, part_q, stream):
        """The long-KV K3: its operands named in ``plan["copies"]`` from
        K2's aligned copies (made by this call where ``dkv()`` did not run
        first), then the kernel, into ``grad_q`` or, split, ``part_q``; the
        copies are let go once the kernel is enqueued (the caching allocator
        reuses their memory only after it, in stream order).  The first
        nonzero error."""
        err, args = self._aligned(lib, plan["copies"], stream, self._copies)
        if err == 0:
            strides = [x for t in args for x in t.stride()[:3]]
            err = lib.flash_attention_bwd_dq_longkv_sm90(
                *(t.data_ptr() for t in args), *self._inputs[4:8], _ptr(part_q), *self._dims,
                plan["splits"], plan["tiles_per_split"], *strides, self._scale, stream)
        self._copies = {}
        return err

    def dkv(self):
        """K2: dk and dv."""
        global LAUNCHES_BWD_DKV, LAUNCHES_BWD_NARROW, LAUNCHES_BWD_LONGKV
        if self._run("dkv", (self.grad_k, self.grad_v)):
            LAUNCHES_BWD_DKV += 1
            LAUNCHES_BWD_NARROW += self.plan["route"] == "sm90_narrow"
            LAUNCHES_BWD_LONGKV += self.plan["route"] == "sm90_longkv"

    def dq(self):
        """K3: dq."""
        global LAUNCHES_BWD_DQ, LAUNCHES_BWD_NARROW, LAUNCHES_BWD_DQ_LONGKV
        if self._run("dq", (self.grad_q,)):
            LAUNCHES_BWD_DQ += 1
            LAUNCHES_BWD_NARROW += self.plan["route"] == "sm90_narrow"
            LAUNCHES_BWD_DQ_LONGKV += self.plan["route"] == "sm90_longkv"


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
