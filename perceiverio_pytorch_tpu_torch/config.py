"""Numerical policy for the PyTorch/CUDA port: compute dtype and attention path.

Counterpart of ``perceiverio_pytorch_tpu/config.py``.  The attention
selector values are ``"dense"`` (plain matmul + softmax, the JAX package's
``"xla"``), ``"flash"`` (the hand-written CUDA kernel, or its plain PyTorch
version on a CPU tensor) and ``"auto"``.

The sequence-parallel fields are ported: with ``sp_mesh`` set, an
attention site with at least ``sp_min_kv`` keys (the encoder's
cross-attend) runs ``parallel.sequence_parallel_attention`` over the mesh
axis ``sp_axis``, its route ``sp_impl`` named as ``attn_impl``'s ("dense",
the JAX package's "xla"; "flash"; "auto").  The pipeline fields are
ported: with ``pp_mesh`` set (``parallel.make_pipeline_mesh``), the latent
self-attend stack runs as a pipeline over its ``pp_axis``
(``parallel.pipeline``).  ``layer_scan`` and ``layer_scan_min`` are taken
with the JAX package's values and validation; eager PyTorch has no scan and
compiles nothing, so every value runs the self-attend stack as one loop,
whose outputs are the unrolled loop's (JAX's scan is exact against its
unrolled loop too).  ``quant`` and ``quant_scope`` are ported: int8
projections (``ops.quant``, ``core.attention.Dense``), validated with the
JAX package's messages (``quant_enabled``).  ``fold_query_pad`` is ported:
the multimodal decoder folds its constant query-pad channels through the
query LayerNorm and projection (``core.attention.FoldedQuery``).
``remat_policy`` is
ported for the ``jax.checkpoint_policies`` names that have a meaning here
(``REMAT_POLICIES``): ``remat_call`` runs a checkpointed region under
``torch.utils.checkpoint`` with a selective policy that keeps the outputs
of the matrix products JAX's ``dot_general`` becomes (``aten.mm``,
``addmm``, ``bmm``, ``baddbmm``) and recomputes everything else, the flash
kernel's ``torch.library`` op included, as JAX recomputes a
``pallas_call``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Optional

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

ATTN_DENSE = "dense"  # plain matmul + softmax, materialises [B,H,Tq,Tk]
ATTN_FLASH = "flash"  # streaming-KV CUDA kernel (ops/flash_attention.py)
ATTN_AUTO = "auto"  # flash on a CUDA tensor at long sequence lengths

LAYER_SCAN_VALUES = ("auto", "on", "off")

_aten = torch.ops.aten
# The products with batch dims (an attention's einsum) and without (a
# projection: [B, T, C] x [C, D] lowers to mm or addmm).
_NO_BATCH_DOTS = frozenset({_aten.mm.default, _aten.addmm.default})
_DOTS = _NO_BATCH_DOTS | {_aten.bmm.default, _aten.baddbmm.default}

# jax.checkpoint_policies names the port takes -> the aten ops whose outputs
# the backward keeps (None: every op's; empty: none, full remat).
REMAT_POLICIES = {
    "nothing_saveable": frozenset(),
    "everything_saveable": None,
    "dots_saveable": _DOTS,
    "checkpoint_dots": _DOTS,
    "dots_with_no_batch_dims_saveable": _NO_BATCH_DOTS,
    "checkpoint_dots_with_no_batch_dims": _NO_BATCH_DOTS,
}


@dataclasses.dataclass(frozen=True)
class Policy:
    """Numerical policy for a model.

    Attributes:
      compute_dtype: dtype activations and matmuls run in (None = input dtype).
      softmax_dtype: accumulation dtype of the dense path's softmax.
      attn_impl: one of "dense" | "flash" | "auto".
      flash_min_kv / flash_min_self / flash_long_q_min_kv: the thresholds of
        the "auto" dispatch, the JAX package's values (ops/attention.py).
      gelu_approximate: tanh-approximate GELU instead of the exact erf form.
      fold_query_pad: pass a decoder query whose pad channels are constant
        (the multimodal model's) in factored form, never materialising the
        padded [B, Tq, C] concat; no effect where no query is padded.
      remat_policy: what a model built with ``remat=True`` keeps for the
        backward of its checkpointed regions: None (full remat, as
        "nothing_saveable") or a name of ``REMAT_POLICIES``; any other name
        raises ValueError.
      quant: None, "int8_dynamic" (the attention and MLP projections as int8
        GEMMs, per-token activation scales and per-output-channel weight
        scales, ``ops.quant``) or "int8_static" (one calibrated activation
        scale per projection, ``ops.quant.calibrate``); the backward of
        either is the exact product's (a straight-through estimator).
      quant_scope: which projections quantize: "all", or "latent" (the
        self-attention stack only; the cross-attention blocks stay exact).
      layer_scan, layer_scan_min: the JAX package's switch for scanning the
        self-attend stack ("off" | "auto" | "on"; "auto" from
        ``layer_scan_min`` layers); any other value raises ValueError.  Every
        value runs the same loop here (see the module docstring).
      sp_mesh / sp_axis / sp_min_kv: with a mesh (``parallel.make_mesh``),
        a site whose keys number at least ``sp_min_kv`` and that has no
        pre-built mask, bias, dropout or returned matrix runs sequence
        parallel: its keys split over ``sp_axis`` (``ops.attention``).
      sp_impl: the sequence-parallel route, "dense" (local logits and an
        all-reduce of the softmax statistics), "flash" (K1 with its lse on
        the local keys, merged over the axis: ring attention) or "auto"
        (flash on a CUDA tensor whose local keys number at least 8192); any
        other value raises ValueError.
      pp_mesh / pp_axis / pp_microbatches / pp_circ_repeats: with a mesh
        (``parallel.make_pipeline_mesh``) whose ``pp_axis`` has more than
        one rank, every self-attend stack whose layer count divides into
        its stages x ``pp_circ_repeats`` runs as a pipeline over that axis
        (``parallel.pipeline``), ``pp_microbatches`` microbatches a block
        (the batch must divide into them), the circular schedule with
        ``pp_circ_repeats`` > 1 (then ``pp_microbatches`` >= the stages).
        A ``pp_axis`` the mesh lacks or a ``pp_circ_repeats`` below 1
        raises ValueError.
    """

    compute_dtype: Optional[torch.dtype] = None
    softmax_dtype: torch.dtype = torch.float32
    attn_impl: str = ATTN_AUTO
    flash_min_kv: int = 8192
    flash_min_self: int = 2048
    flash_long_q_min_kv: int = 1024
    gelu_approximate: bool = False
    quant: Optional[str] = None
    sp_mesh: Any = None
    sp_axis: str = "model"
    sp_min_kv: int = 32768
    sp_impl: str = ATTN_AUTO
    pp_mesh: Any = None
    pp_axis: str = "pipe"
    pp_microbatches: int = 2
    pp_circ_repeats: int = 1
    layer_scan: str = "off"
    layer_scan_min: int = 16
    remat_policy: Optional[str] = None
    fold_query_pad: bool = False
    quant_scope: str = "all"

    def __post_init__(self):
        if self.attn_impl not in (ATTN_DENSE, ATTN_FLASH, ATTN_AUTO):
            raise ValueError(
                "Policy.attn_impl must be 'dense', 'flash' or 'auto'; got"
                f" {self.attn_impl!r}"
            )
        if self.sp_impl not in (ATTN_DENSE, ATTN_FLASH, ATTN_AUTO):
            raise ValueError(
                "Policy.sp_impl must be 'dense', 'flash' or 'auto'; got"
                f" {self.sp_impl!r}"
            )
        if self.remat_policy is not None and self.remat_policy not in REMAT_POLICIES:
            raise ValueError(
                f"Policy.remat_policy {self.remat_policy!r} is not one the port takes;"
                f" take one of {sorted(REMAT_POLICIES)} or None (full remat)"
            )
        quant_enabled(self)
        if self.layer_scan not in LAYER_SCAN_VALUES:
            raise ValueError(
                "Policy.layer_scan must be 'auto', 'on' or 'off'; got"
                f" {self.layer_scan!r}"
            )
        if self.pp_mesh is not None:
            # JAX checks these at apply (core/perceiver.py:197-206), with
            # the same messages.
            names = tuple(getattr(self.pp_mesh, "mesh_dim_names", None) or ())
            if self.pp_axis not in names:
                raise ValueError(
                    f"Policy.pp_axis {self.pp_axis!r} is not an axis of pp_mesh {names}")
            if self.pp_circ_repeats < 1:
                raise ValueError(
                    f"Policy.pp_circ_repeats must be >= 1; got {self.pp_circ_repeats}")


def quant_enabled(policy: Policy, site: str = "latent") -> bool:
    """Validate Policy.quant/quant_scope; is int8 on at this ``site``?

    ``site`` is "latent" (the self-attention stack) or "cross" (the
    cross-attention blocks: the encoder's input attend, the decoder).
    """
    if policy.quant_scope not in ("all", "latent"):
        raise ValueError(
            "Policy.quant_scope must be 'all' or 'latent'; got"
            f" {policy.quant_scope!r}"
        )
    if policy.quant is None:
        return False
    if policy.quant in ("int8_dynamic", "int8_static"):
        return policy.quant_scope == "all" or site == "latent"
    raise ValueError(
        "Policy.quant must be None, 'int8_dynamic' or 'int8_static'; got"
        f" {policy.quant!r}"
    )


def quant_mode(policy: Policy, site: str = "latent") -> Optional[str]:
    """The validated Policy.quant mode at this site, or None when off."""
    return policy.quant if quant_enabled(policy, site) else None


def _save_policy(saved, ctx, op, *args, **kwargs):
    if saved is None or op in saved:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def remat_call(policy: Policy, fn: Callable, *args, **kwargs):
    """``fn(*args, **kwargs)`` as a checkpointed region under
    ``policy.remat_policy`` (non-reentrant ``torch.utils.checkpoint``; full
    remat without a selective policy for None and "nothing_saveable")."""
    saved = REMAT_POLICIES[policy.remat_policy or "nothing_saveable"]
    if saved is not None and not saved:
        return checkpoint(fn, *args, use_reentrant=False, **kwargs)
    context_fn = functools.partial(create_selective_checkpoint_contexts,
                                   functools.partial(_save_policy, saved))
    return checkpoint(fn, *args, use_reentrant=False, context_fn=context_fn, **kwargs)


# fp32 everywhere, dense attention: the parity policy.
PARITY = Policy(compute_dtype=torch.float32, attn_impl=ATTN_DENSE)

# bf16 compute with fp32 softmax and LayerNorm, tanh GELU, and the query-pad
# fold (which only changes the multimodal decoder), as the JAX preset.
PERFORMANCE = Policy(
    compute_dtype=torch.bfloat16,
    attn_impl=ATTN_AUTO,
    gelu_approximate=True,
    fold_query_pad=True,
)

# PERFORMANCE with dynamic int8 projections (approximate: about 1% relative
# error a GEMM).
PERFORMANCE_INT8 = dataclasses.replace(PERFORMANCE, quant="int8_dynamic")

# The static (calibrated) variant: run ops.quant.calibrate before inference.
PERFORMANCE_INT8_STATIC = dataclasses.replace(PERFORMANCE, quant="int8_static")

DEFAULT = Policy()
