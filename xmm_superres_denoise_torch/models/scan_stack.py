"""Layout converters between unrolled and scan-compressed layer stacks.

The JAX package's `scan_layers = true` traces one group body and
`lax.scan`s it over per-group parameters stacked on a leading axis, to keep
its production train graphs under a compile-size cap. Its math is the
unrolled model's, and the port builds the unrolled stack in either case:
PyTorch runs eagerly and has no such cap. Only the Flax parameter layout
differs, and checkpoints carry it:

  unrolled:  params["layers_0"] ... params["layers_{n-1}"]   (n subtrees)
  scanned:   params["layers_scan"]                           (leaves stacked
                                                              on axis 0)

The port's numpy copies of the JAX package's `stack_layer_params` and
`unstack_layer_params`, over nested dicts of arrays; `utils/weights.py`
reads and writes the scanned layout when a model's `scan_layers` is set.
"""

from __future__ import annotations

import re
from typing import Dict

import numpy as np

_LAYER_RE = re.compile(r"^layers_(\d+)$")


def _structure(tree):
    if isinstance(tree, dict):
        return {k: _structure(v) for k, v in sorted(tree.items())}
    return None


def _stack(groups):
    if isinstance(groups[0], dict):
        return {k: _stack([g[k] for g in groups]) for k in groups[0]}
    return np.stack([np.asarray(g) for g in groups], axis=0)


def _index(tree, i: int):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


def stack_layer_params(params: Dict, dest: str = "layers_scan") -> Dict:
    """Unrolled -> scanned: stack the `layers_i` subtrees on a new leading
    axis. `params` is the model's "params" collection. Raises if the
    subtrees are not numbered 0..n-1 or not structurally equal."""
    idx = sorted((int(m.group(1)), k) for k in params if (m := _LAYER_RE.match(k)))
    if not idx:
        raise ValueError("no layers_<i> subtrees to stack")
    found = [i for i, _ in idx]
    if found != list(range(len(idx))):
        raise ValueError(
            f"layers_<i> indices are not contiguous from 0 (found {found}); a gapped tree "
            "would silently restack under renumbered group identities")
    groups = [params[k] for _, k in idx]
    if any(_structure(g) != _structure(groups[0]) for g in groups):
        raise ValueError("layer groups are not structurally identical - cannot scan-stack")
    out = {k: v for k, v in params.items() if not _LAYER_RE.match(k)}
    out[dest] = _stack(groups)
    return out


def unstack_layer_params(params: Dict, src: str = "layers_scan",
                         prefix: str = "layers_") -> Dict:
    """Scanned -> unrolled: split the stacked axis back into `layers_i`."""
    if src not in params:
        raise ValueError(f"no {src!r} subtree to unstack")
    stacked = params[src]
    leaves = []

    def collect(t):
        if isinstance(t, dict):
            for v in t.values():
                collect(v)
        else:
            leaves.append(t)

    collect(stacked)
    if not leaves:
        raise ValueError(f"{src!r} subtree is empty")
    out = {k: v for k, v in params.items() if k != src}
    for i in range(np.asarray(leaves[0]).shape[0]):
        out[f"{prefix}{i}"] = _index(stacked, i)
    return out
