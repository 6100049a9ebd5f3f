"""Compatibility shim: the input pipeline lives in ``training.data``.

Counterpart of ``perceiverio_pytorch_tpu/utils/data.py``, so that code
written against the JAX package's module path finds the same names here:
``batch_iterator`` and ``prefetch_to_device``, and ``epoch_batches``, the
single-epoch spelling of ``batch_iterator``.  Import from
``perceiverio_pytorch_tpu_torch.training`` in new code.
"""

from perceiverio_pytorch_tpu_torch.training.data import (  # noqa: F401
    batch_iterator,
    epoch_batches,
    prefetch_to_device,
)

__all__ = ["batch_iterator", "epoch_batches", "prefetch_to_device"]
