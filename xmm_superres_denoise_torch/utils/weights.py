"""Flax parameter tree -> PyTorch state_dict for the RRDB generators.

`params_from_flax` takes the Flax tree the JAX package trains and saves
(e.g. `docs/convergence_esr_gen/best_params.npz`: keys such as
`params/trunk/rrdb_0/RDB1/conv1/kernel`, HWIO layout) as an npz path, an
open npz, a flat dict with '/'-joined keys or a nested dict, and returns a
state_dict for `GeneratorRRDB_SR`/`GeneratorRRDB_DN`:

* `nn.Conv2d` weights (conv_first, trunk_conv, upconv_i, HRconv,
  conv_last) are transposed HWIO -> OIHW;
* dense-block weights stay HWIO, contiguous: the kernel's layout, so the
  conversion happens once here and never per forward.

It raises on a key it does not know (extra) and on an incomplete model
(missing): every conv needs kernel and bias, the RRDBs must be numbered
0..N-1 with all 15 dense-block convs, and HRconv comes with the upconvs.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Dict, Mapping, Union

import numpy as np
import torch

_DENSE = re.compile(r"^trunk/rrdb_(\d+)/RDB([123])/conv([1-5])/(kernel|bias)$")
_PLAIN = re.compile(
    r"^(trunk/conv_first|trunk/trunk_conv|upconv_(\d+)|HRconv|conv_last)/(kernel|bias)$"
)


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, Mapping):
            out.update(_flatten(v, key + "/"))
        else:
            out[key] = np.asarray(v)
    return out


def _flat_params(src) -> Dict[str, np.ndarray]:
    if isinstance(src, (str, Path)):
        with np.load(src) as npz:
            src = {k: npz[k] for k in npz.files}
    flat = _flatten(src)  # an open NpzFile is a Mapping too
    return {k[len("params/"):] if k.startswith("params/") else k: v for k, v in flat.items()}


def params_from_flax(src: Union[str, Path, Mapping]) -> Dict[str, torch.Tensor]:
    """Flax RRDB generator params -> state_dict (f32, CPU tensors)."""
    flat = _flat_params(src)
    state: Dict[str, torch.Tensor] = {}
    rrdbs, upconvs = set(), set()
    for key, arr in flat.items():
        arr = np.array(arr, np.float32)  # a writable f32 copy
        dense, plain = _DENSE.match(key), _PLAIN.match(key)
        if dense:
            i, k, j, kind = dense.groups()
            rrdbs.add(int(i))
            name = f"trunk.rrdb_{i}.RDB{k}.conv{j}."
        elif plain:
            module, up, kind = plain.groups()
            if up is not None:
                upconvs.add(int(up))
            name = module.replace("/", ".") + "."
            if kind == "kernel":
                arr = arr.transpose(3, 2, 0, 1)  # HWIO -> OIHW
        else:
            raise KeyError(f"unexpected parameter {key!r} for an RRDB generator")
        name += "weight" if kind == "kernel" else "bias"
        state[name] = torch.from_numpy(np.ascontiguousarray(arr))

    expected = {"trunk.conv_first", "trunk.trunk_conv", "conv_last"}
    expected |= {
        f"trunk.rrdb_{i}.RDB{k}.conv{j}"
        for i in range(max(rrdbs, default=-1) + 1) for k in (1, 2, 3) for j in range(1, 6)
    }
    if upconvs:
        expected |= {f"upconv_{i}" for i in range(max(upconvs) + 1)} | {"HRconv"}
    expected_keys = {f"{m}.{p}" for m in expected for p in ("weight", "bias")}
    missing = sorted(expected_keys - set(state))
    extra = sorted(set(state) - expected_keys)
    if missing or extra:
        raise KeyError(f"Flax params do not form an RRDB generator: missing "
                       f"{missing}, unexpected {extra}")
    return state
