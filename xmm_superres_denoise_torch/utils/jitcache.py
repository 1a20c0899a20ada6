"""Where the port's compiled programs are cached.

The port of the JAX package's `utils/jitcache.py`. The port compiles no XLA
and does not use `torch.compile`: its compiled programs are the CUDA kernel
libraries that `ops/cuda_build.py` builds with nvcc, and this is the policy
for their directory. JAX's other half, pointing jax at the cache through an
environment variable and its config, has no counterpart: the builder is
the only reader.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional


def default_cache_dir(checkout: Optional[Path] = None) -> Path:
    """`<checkout>/build/torch_kernels` when the package runs from a
    writable checkout; the user's `~/.cache/xmmsr_torch_kernels` when it is
    installed (site-packages may be read-only or shared across users).
    `checkout` is the directory that holds the package."""
    root = Path(checkout) if checkout is not None else Path(__file__).resolve().parents[2]
    installed = root.name in ("site-packages", "dist-packages")
    if not installed and os.access(root, os.W_OK):
        return root / "build" / "torch_kernels"
    return Path.home() / ".cache" / "xmmsr_torch_kernels"
