"""Where the port's compiled artifacts live across processes.

Counterpart of ``perceiverio_pytorch_tpu/utils/compilation_cache.py``.  The
JAX package caches XLA programs on disk; the port compiles no program per
shape (eager PyTorch), and its only compiled artifacts are the flash
attention kernels, which ``nvcc`` builds from ``csrc/`` at first use
(``ops/flash_attention.py``).  Each kernel's library is cached whole under
a name that hashes its source, so a later process that points at the same
directory loads it without building:

    from perceiverio_pytorch_tpu_torch.utils.compilation_cache import (
        enable_compilation_cache)
    enable_compilation_cache()          # before the first kernel launch

Without a call the libraries are built into ``build/kernels/`` under the
repository root.
"""

from __future__ import annotations

import os
from typing import Optional

from perceiverio_pytorch_tpu_torch.ops import flash_attention

__all__ = [
    "add_cache_arg",
    "enable_cache_if_requested",
    "enable_compilation_cache",
]


def enable_compilation_cache(path: Optional[str] = None, *,
                             min_compile_time_secs: float = 1.0) -> str:
    """Build and load the kernels in ``path``; returns the directory used.

    Args:
      path: the directory (created if missing).  Defaults to
        ``$PERCEIVER_CACHE_DIR`` or
        ``~/.cache/perceiverio_pytorch_tpu_torch/kernels``.
      min_compile_time_secs: taken for the JAX signature and ignored: every
        kernel's build is cached whole.

    Raises ``RuntimeError`` when the kernels are already loaded from another
    directory: call it before the first kernel use.
    """
    del min_compile_time_secs
    path = (
        path
        or os.environ.get("PERCEIVER_CACHE_DIR")
        or os.path.expanduser("~/.cache/perceiverio_pytorch_tpu_torch/kernels")
    )
    os.makedirs(path, exist_ok=True)
    return flash_attention.set_build_dir(path)


def add_cache_arg(parser) -> None:
    """Add the shared ``--cache-dir`` flag to an argparse parser."""
    parser.add_argument(
        "--cache-dir",
        default=None,
        help="directory of the built flash attention kernels, kept across"
        " processes (default: build/kernels/ under the repository root)",
    )


def enable_cache_if_requested(args) -> Optional[str]:
    """Enable the cache when ``args.cache_dir`` is set; returns the dir."""
    cache_dir = getattr(args, "cache_dir", None)
    if cache_dir:
        return enable_compilation_cache(cache_dir)
    return None
