"""Weight initializers on an explicit ``torch.Generator``.

Counterpart of ``perceiverio_pytorch_tpu/utils/initializers.py`` (the
``jax.nn.initializers`` the JAX package uses).  The two frameworks draw
different numbers from the same seed; the distributions are the same:

  * ``variance_scaling_``: fan-in truncated normal with
    std = sqrt(scale / fan_in) / 0.87962566103423978, cut at +-2 std;
  * ``lecun_normal_``: ``variance_scaling_`` with scale 1;
  * ``trunc_normal_``: std * (a standard normal cut at +-2).
"""

from __future__ import annotations

import math

import torch

# std of a standard normal truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978


def default_generator(generator=None) -> torch.Generator:
    """The caller's generator, or a CPU generator seeded with 0."""
    return generator if generator is not None else torch.Generator().manual_seed(0)


@torch.no_grad()
def _truncated_standard_normal_(t: torch.Tensor, generator: torch.Generator):
    """Fill ``t`` with a standard normal truncated to [-2, 2] (inverse CDF)."""
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
    hi = 0.5 * (1.0 + math.erf(2.0 / math.sqrt(2.0)))
    t.uniform_(2 * lo - 1, 2 * hi - 1, generator=generator)
    t.erfinv_().mul_(math.sqrt(2.0)).clamp_(-2.0, 2.0)
    return t


@torch.no_grad()
def trunc_normal_(t: torch.Tensor, std: float, generator: torch.Generator):
    return _truncated_standard_normal_(t, generator).mul_(std)


@torch.no_grad()
def variance_scaling_(
    weight: torch.Tensor, scale: float, generator: torch.Generator, fan_in=None
):
    """Init a torch Linear weight [out, in]: fan_in is its last dim unless
    given (a conv kernel's: input channels times the receptive field)."""
    fan_in = weight.shape[-1] if fan_in is None else fan_in
    std = math.sqrt(scale / max(1, fan_in)) / _TRUNC_STD
    return trunc_normal_(weight, std, generator)


def lecun_normal_(weight: torch.Tensor, generator: torch.Generator, fan_in=None):
    return variance_scaling_(weight, 1.0, generator, fan_in)
