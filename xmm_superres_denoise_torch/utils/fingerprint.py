"""Parameter-tree fingerprint: binds saved int8 scales to a checkpoint.

The port of the JAX package's `utils/fingerprint.py`, in numpy. int8
activation scales hold only for the checkpoint they were calibrated on; the
scales file carries this digest, and a mismatch is caught when the file is
loaded (`cli.py ... --int8_scales`).

The digest is the JAX package's, byte for byte, for the same Flax tree, so
one scales file binds in both packages: over the leaves in the order of
their key paths (JAX flattens a dict in sorted key order), each leaf's path
as `jax.tree_util.keystr` prints it (`['params']['HRconv']['bias']`), its
shape as a Python tuple, its dtype and its float64 sum. Hash the Flax
layout (HWIO kernels, as a checkpoint stores them), never a torch
state_dict: other keys, shapes and sums give another digest.
"""

from __future__ import annotations

import hashlib
from typing import Iterator, Mapping, Tuple

import numpy as np


def _leaves(tree: Mapping, path: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], object]]:
    for key in sorted(tree):
        value = tree[key]
        if isinstance(value, Mapping):
            yield from _leaves(value, path + (key,))
        else:
            yield path + (key,), value


def params_fingerprint(params: Mapping) -> str:
    """Digest of a nested dict of arrays (e.g. `{"params": {...}}`): key
    paths, shapes, dtypes and per-leaf float64 sums; value-sensitive and
    cheap, enough to tell checkpoints apart, not a cryptographic commitment."""
    h = hashlib.sha256()
    for path, leaf in _leaves(params):
        arr = np.asarray(leaf)
        h.update("".join(f"[{k!r}]" for k in path).encode())
        h.update(str(arr.shape).encode())
        h.update(str(arr.dtype).encode())
        h.update(np.float64(arr.astype(np.float64).sum()).tobytes())
    return h.hexdigest()[:32]
