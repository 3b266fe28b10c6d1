"""Where the CUDA kernels are built (counterpart of the JAX package's
``utils/cache.py``).

The JAX package caches XLA executables on disk, because every first fit at a
new shape pays a compile.  The port's compile tax is the ``nvcc`` build of
``ops/csrc/`` (all sources in parallel, then a link), paid once per kernel
library: ``ops/_build.py`` names the
library by a hash of the sources and flags and reuses it when it exists.  By
default it builds into ``build/nbmf_mm_tpu_torch/`` of the checkout.  This
module points that directory elsewhere, so that the build is paid once per
machine instead of once per checkout::

    from nbmf_mm_tpu_torch.utils import enable_compilation_cache
    enable_compilation_cache()          # ~/.cache/nbmf_mm_tpu_torch/kernels

or implicitly by setting ``NBMF_CACHE_DIR`` before importing
:mod:`nbmf_mm_tpu_torch` (the package root calls
:func:`maybe_enable_compilation_cache`).  Nothing is built here: the
directory is used at the first kernel launch.  A library already loaded in
this process stays loaded.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional

__all__ = ["enable_compilation_cache", "maybe_enable_compilation_cache"]

_DEFAULT_DIR = os.path.join("~", ".cache", "nbmf_mm_tpu_torch", "kernels")


def enable_compilation_cache(path: Optional[str] = None) -> str:
    """Build the kernel library into ``path`` (created if missing), or into
    ``$NBMF_CACHE_DIR``, or ``~/.cache/nbmf_mm_tpu_torch/kernels``.  Returns
    the resolved directory."""
    from ..ops import _build

    path = os.path.expanduser(path or os.environ.get("NBMF_CACHE_DIR") or _DEFAULT_DIR)
    os.makedirs(path, exist_ok=True)
    _build.BUILD_DIR = Path(path)
    return path


def maybe_enable_compilation_cache() -> Optional[str]:
    """Opt-in hook called on package import: point the build at the cache
    only if the user set ``NBMF_CACHE_DIR``; otherwise leave it where it is
    and return ``None``."""
    if not os.environ.get("NBMF_CACHE_DIR"):
        return None
    return enable_compilation_cache()
