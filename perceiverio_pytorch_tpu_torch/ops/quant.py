"""int8 matrix products for inference and quantization-aware training.

Counterpart of ``perceiverio_pytorch_tpu/ops/quant.py``.  The recipe is the
JAX package's (standard dynamic quantization):

  * weights: symmetric per-output-channel scales, quantized from the stored
    weights at every call (``max|w|`` over each output row of nn.Linear's
    ``[out, in]`` weight, where the JAX package reduces its ``[in, out]``
    kernel over axis 0);
  * activations: symmetric per-row scales computed on the fly
    (``int8_dynamic_matmul``), or one calibrated scalar per projection
    (``int8_static_matmul``: ``amax``, recorded by ``calibrate``; values
    beyond it clip at +-127);
  * an int8 x int8 -> int32 product, dequantized by the two scales.

The arithmetic keeps the JAX package's order, so the int8 codes are its
codes: scales are divided, not multiplied by a reciprocal (on the card too,
``_per_127``), both scales are clamped at 1e-12, ``torch.round`` rounds
half to even as ``jnp.round`` does, only the static path clips, and the
dynamic path dequantizes as ``(y * x_scale) * w_scale``, the static one as
``y * (x_scale * w_scale)``.
Inputs are quantized from their own dtype via fp32; the result is fp32,
cast to ``out_dtype`` (default: the input's).

The backward is the exact product's (a straight-through estimator), so a
training step under ``Policy.quant`` is quantization-aware training: the
forward runs the int8 products a deployment will run, the gradients are
those of ``x @ w.T`` in fp32.

The int8 product (``int8_gemm``): on a CUDA tensor ``torch._int_mm``
(cuBLASLt's int8 GEMM), whose operands must have more than 16 rows and a
contraction and output width that are multiples of 8; the operands are
zero-padded to those rules and the padded rows and columns of the exact
int32 result are sliced away.  On a CPU tensor its plain version
(``int8_gemm_reference``), which is exact: the codes as float64 products,
cast to int32.  Neither falls back on the other.

``calibrate`` and ``quant_error_report`` put a model's int8 projections in
a pass mode for their duration: "calibrate" (an ``int8_static`` projection
records the running ``max|x|`` of its exact fp32 input and runs the exact
product, as the JAX package's mutable ``quant_stats`` pass does) or "exact"
(every projection runs the exact product: the model's unquantized twin).
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterable, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils import _pytree as pytree

__all__ = [
    "calibrate",
    "int8_dynamic_matmul",
    "int8_gemm",
    "int8_gemm_reference",
    "int8_static_matmul",
    "quant_error_report",
]

# torch._int_mm calls on CUDA tensors (one per int8 projection a forward).
LAUNCHES = 0

# torch._int_mm's shape rules on CUDA: more than MIN_ROWS rows, K and N
# multiples of ALIGN.
_MIN_ROWS = 16
_ALIGN = 8


def int8_gemm_reference(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """``xq [M, K] int8 @ wq [N, K]^T int8 -> [M, N] int32``, exact: every
    partial sum is an integer below 2^53 for K below 2^39."""
    return (xq.double() @ wq.double().t()).to(torch.int32)


def int8_gemm_padded(xq: torch.Tensor, wq: torch.Tensor, gemm) -> torch.Tensor:
    """``gemm`` on operands zero-padded to ``torch._int_mm``'s CUDA shape
    rules, its result sliced back to [M, N].  ``gemm(x [Mp, Kp], w [Np, Kp])``
    returns int32 [Mp, Np].  The row count is padded by MIN_ROWS + 1 unless
    it is a concrete int above MIN_ROWS: a branch on a symbolic batch (under
    ``torch.export``) would specialise it."""
    m, k = xq.shape
    n = wq.shape[0]
    pad_k, pad_n = -k % _ALIGN, -n % _ALIGN
    pad_m = 0 if isinstance(m, int) and m > _MIN_ROWS else _MIN_ROWS + 1
    if pad_k or pad_m:
        xq = F.pad(xq, (0, pad_k, 0, pad_m))
    if pad_k or pad_n:
        wq = F.pad(wq, (0, pad_k, 0, pad_n))
    y = gemm(xq, wq)
    return y[:m, :n] if pad_m or pad_n else y


def _int_mm(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    # The [N, K] codes transposed are the column-major [K, N] operand.
    return torch._int_mm(xq, wq.t())


def int8_gemm(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """``xq [M, K] int8 @ wq [N, K]^T int8 -> [M, N] int32``: ``torch._int_mm``
    on a CUDA tensor (padded to its shape rules), the plain version on a CPU
    tensor."""
    global LAUNCHES
    if xq.is_cuda:
        LAUNCHES += 1
        return int8_gemm_padded(xq, wq, _int_mm)
    return int8_gemm_reference(xq, wq)


def _per_127(t: torch.Tensor) -> torch.Tensor:
    """``t / 127``, divided: on a CUDA tensor PyTorch turns a division by a
    Python number into a product with its rounded reciprocal, which is off
    by an ulp for some ``t``; a 0-d tensor on ``t``'s device is divided by.
    """
    return t / torch.full((), 127.0, device=t.device)


def _quantize_weights(w32: torch.Tensor):
    """Symmetric per-output-channel int8 codes [N, K] and scales [N]."""
    w_scale = _per_127(w32.abs().amax(dim=1))
    w_scale = torch.clamp_min(w_scale, 1e-12)
    return torch.round(w32 / w_scale[:, None]).to(torch.int8), w_scale


def _product(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """The int32 product of [..., K] codes and [N, K] codes: [..., N]."""
    y = int8_gemm(xq.reshape(-1, xq.shape[-1]), wq)
    return y.reshape(*xq.shape[:-1], wq.shape[0])


def _dynamic(x32: torch.Tensor, w32: torch.Tensor) -> torch.Tensor:
    wq, w_scale = _quantize_weights(w32)
    x_scale = _per_127(x32.abs().amax(dim=-1, keepdim=True))  # [..., 1]
    x_scale = torch.clamp_min(x_scale, 1e-12)
    xq = torch.round(x32 / x_scale).to(torch.int8)
    return _product(xq, wq).float() * x_scale * w_scale


def _static(x32: torch.Tensor, w32: torch.Tensor, amax: torch.Tensor) -> torch.Tensor:
    # An uncalibrated site (amax 0) takes scale 1.0, as the JAX package does.
    wq, w_scale = _quantize_weights(w32)
    x_scale = _per_127(torch.where(amax > 0, amax, 127.0))
    xq = torch.clamp(torch.round(x32 / x_scale), -127, 127).to(torch.int8)
    return _product(xq, wq).float() * (x_scale * w_scale)


def _exact_grads(x: torch.Tensor, w: torch.Tensor, g: torch.Tensor):
    """The exact product's gradients in fp32, cast to the inputs' dtypes."""
    g = g.float()
    x32, w32 = x.float(), w.float()
    dx = g @ w32
    dw = g.reshape(-1, g.shape[-1]).t() @ x32.reshape(-1, x32.shape[-1])
    return dx.to(x.dtype), dw.to(w.dtype)


class _DynamicMatmul(torch.autograd.Function):
    """The dynamic product with the straight-through backward.  Saves the
    inputs in their own dtypes (a bf16 activation is not kept in fp32)."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _dynamic(x.float(), w.float())

    @staticmethod
    def backward(ctx, g):
        return _exact_grads(*ctx.saved_tensors, g)


class _StaticMatmul(torch.autograd.Function):
    """The static product with the straight-through backward (no gradient
    reaches ``amax``)."""

    @staticmethod
    def forward(ctx, x, w, amax):
        ctx.save_for_backward(x, w)
        return _static(x.float(), w.float(), amax)

    @staticmethod
    def backward(ctx, g):
        return (*_exact_grads(*ctx.saved_tensors, g), None)


def _needs_grad(*tensors: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def int8_dynamic_matmul(x: torch.Tensor, weight: torch.Tensor, *,
                        out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``x @ weight.T`` as an int8 product with dynamic scales.

    Args:
      x: [..., K] activations (any float dtype).
      weight: [N, K] float weights (nn.Linear's layout), quantized per
        output channel here.
      out_dtype: the result's dtype (default: ``x.dtype``).
    """
    out_dtype = out_dtype or x.dtype
    if _needs_grad(x, weight):
        y = _DynamicMatmul.apply(x, weight)
    else:
        y = _dynamic(x.float(), weight.float())
    return y.to(out_dtype)


def int8_static_matmul(x: torch.Tensor, weight: torch.Tensor, amax: torch.Tensor, *,
                       out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``x @ weight.T`` as an int8 product with one calibrated activation
    scale.

    Args:
      x: [..., K] activations (any float dtype).
      weight: [N, K] float weights, quantized per output channel here.
      amax: the site's calibrated ``max|x|`` (a 0-d fp32 tensor, see
        ``calibrate``); 0 means uncalibrated (scale 1.0).
      out_dtype: the result's dtype (default: ``x.dtype``).
    """
    out_dtype = out_dtype or x.dtype
    amax = torch.as_tensor(amax, dtype=torch.float32, device=x.device)
    if _needs_grad(x, weight):
        y = _StaticMatmul.apply(x, weight, amax)
    else:
        y = _static(x.float(), weight.float(), amax)
    return y.to(out_dtype)


@contextlib.contextmanager
def quant_pass(model: nn.Module, mode: str):
    """Every int8 projection of ``model`` (a module with a ``quant`` mode)
    in pass ``mode`` ("calibrate" or "exact") for the block's duration."""
    if mode not in ("calibrate", "exact"):
        raise ValueError(f"quant pass must be 'calibrate' or 'exact'; got {mode!r}")
    sites = [m for m in model.modules() if getattr(m, "quant", None)]
    for site in sites:
        site.quant_pass = mode
    try:
        yield sites
    finally:
        for site in sites:
            site.quant_pass = None


def calibrate(model: nn.Module, batches: Iterable, **kwargs) -> nn.Module:
    """Record each ``int8_static`` projection's ``max|x|`` (its ``amax``
    buffer, a running max) over representative batches; returns ``model``.

    Runs ``model(*args, **kwargs)`` once per batch under ``no_grad``, every
    projection on the exact product.  The model runs in the mode it is in:
    put it in eval mode first for inference (the convnet's BatchNorm would
    otherwise update its running averages).

    Args:
      model: a module built with ``Policy(quant="int8_static")``.
      batches: iterable of positional-argument tuples for ``model``.
      **kwargs: keyword arguments for every call (e.g. ``n_chunks=16``).
    """
    with torch.no_grad(), quant_pass(model, "calibrate"):
        for args in batches:
            model(*args, **kwargs)
    return model


def quant_error_report(model: nn.Module, batches: Iterable,
                       **kwargs) -> Dict[str, Dict[str, float]]:
    """Quantized against exact outputs on representative batches.

    Runs each batch through ``model`` and through the same module with every
    projection on the exact product (its unquantized twin: the same weights,
    no ``amax``), under ``no_grad``.

    Returns:
      a dict mapping each output leaf's path (``['image']`` for a dict's
      entry, "output" for a bare tensor) to ``{"max_rel", "max_abs",
      "mean_abs"}``, where max_rel is the largest absolute error over the
      leaf divided by the exact leaf's largest magnitude.
    """
    stats: dict = {}
    with torch.no_grad():
        for args in batches:
            got = model(*args, **kwargs)
            with quant_pass(model, "exact"):
                want = model(*args, **kwargs)
            flat_got, _ = pytree.tree_flatten_with_path(got)
            for (path, g), w in zip(flat_got, pytree.tree_leaves(want)):
                g, w = g.detach().float(), w.detach().float()
                err = (g - w).abs()
                s = stats.setdefault(pytree.keystr(path) or "output",
                                     {"max_rel": 0.0, "max_abs": 0.0, "_sum": 0.0, "_n": 0})
                max_err = float(err.max())
                s["max_rel"] = max(s["max_rel"], max_err / max(float(w.abs().max()), 1e-12))
                s["max_abs"] = max(s["max_abs"], max_err)
                s["_sum"] += float(err.double().sum())
                s["_n"] += err.numel()
    return {k: {"max_rel": s["max_rel"], "max_abs": s["max_abs"],
                "mean_abs": s["_sum"] / max(s["_n"], 1)}
            for k, s in stats.items()}
