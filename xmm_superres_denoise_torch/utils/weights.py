"""Flax parameter trees <-> PyTorch state_dicts, for every model of the registry.

The JAX package trains and saves Flax trees (e.g.
`docs/convergence_esr_gen/best_params.npz`: keys such as
`params/trunk/rrdb_0/RDB1/conv1/kernel`); they come here as an npz path, an
open npz, a flat dict with '/'-joined keys or a nested dict. The port's
modules keep the Flax names, so a state_dict key is the Flax key with '.'
for '/', and each array maps by its kind:

* a Flax `Dense` kernel (in, out) is an `nn.Linear` weight (out, in);
* a Flax `Conv` kernel HWIO is an `nn.Conv2d` weight OIHW, except the RRDB
  dense-block convs (`trunk/rrdb_i/RDBk/convj`), which stay HWIO,
  contiguous: the kernel's layout, converted once here, never per forward;
* everything else is copied under its own name: LayerNorm `scale` and
  `bias` (the port's `swin_common.LayerNorm` keeps Flax's names), the
  relative-position bias tables, Restormer's `temperature` and its
  `ChannelLayerNorm` weights, and every bias.

A model built with `scan_layers` has the JAX package's scan-compressed
layout in Flax (`layers_scan`, the groups stacked on axis 0,
`models/scan_stack.py`) and the unrolled `layers_i` in torch.

* `params_from_flax(src)` converts an RRDB generator's tree and raises on a
  key it does not know (extra) and on an incomplete generator (missing):
  every conv needs kernel and bias, the RRDBs numbered 0..N-1 with all 15
  dense-block convs, and HRconv with the upconvs. `params_from_flax(src,
  model)` converts any model's tree (either layout) and holds it to the
  model's state_dict, keys and shapes.
* `flax_tree` goes the other way: any of those sources, or a state_dict,
  becomes the nested Flax tree of numpy arrays (no `params` root) that the
  JAX package's S2D and int8 builders read; `scan_layers=True` stacks it.
* `load_params_npz` reads from an npz checkpoint the arrays a given model
  has, in the checkpoint's layout, as the JAX package's loader fills its
  model's template (a DN model takes an SR checkpoint's trunk and
  conv_last and leaves its upsampler).
* `save_params_npz` writes a model (or a state_dict) as an npz in the Flax
  key layout (`params/...`), scanned when the model's `scan_layers` is set,
  which this module, the port's CLI and the JAX package's
  `load_params_npz` read.
* `vgg_state_from_flax` converts the JAX package's Flax `VGGFeatures` tree
  (`conv_i/kernel` HWIO) to the port's `metrics/vgg.py` state_dict
  (torchvision's `features.N.weight` OIHW).
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Dict, Mapping, Optional, Union

import numpy as np
import torch

from ..models.scan_stack import stack_layer_params, unstack_layer_params

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


def _check_rrdb(keys) -> None:
    """Raise KeyError unless the Flax keys (no `params` root) form an RRDB
    generator: every conv with kernel and bias, RRDBs numbered 0..N-1 with
    all 15 dense-block convs, HRconv with the upconvs."""
    rrdbs, upconvs = set(), set()
    for key in keys:
        dense, plain = _DENSE.match(key), _PLAIN.match(key)
        if dense:
            rrdbs.add(int(dense.group(1)))
        elif plain:
            if plain.group(2) is not None:
                upconvs.add(int(plain.group(2)))
        else:
            raise KeyError(f"unexpected parameter {key!r} for an RRDB generator")
    expected = {"trunk/conv_first", "trunk/trunk_conv", "conv_last"}
    expected |= {
        f"trunk/rrdb_{i}/RDB{k}/conv{j}"
        for i in range(max(rrdbs, default=-1) + 1) for k in (1, 2, 3) for j in range(1, 6)
    }
    if upconvs:
        expected |= {f"upconv_{i}" for i in range(max(upconvs) + 1)} | {"HRconv"}
    expected_keys = {f"{m}/{p}" for m in expected for p in ("kernel", "bias")}
    missing, extra = sorted(expected_keys - set(keys)), sorted(set(keys) - expected_keys)
    if missing or extra:
        raise KeyError(f"Flax params do not form an RRDB generator: missing "
                       f"{missing}, unexpected {extra}")


def _nest(flat: Mapping[str, np.ndarray]) -> Dict:
    tree: Dict = {}
    for key, arr in flat.items():
        node = tree
        *path, leaf = key.split("/")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = arr
    return tree


def _unrolled(flat: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """A flat Flax dict in the unrolled layout (`layers_scan` split)."""
    if not any(k.startswith("layers_scan/") for k in flat):
        return flat
    return _flatten(unstack_layer_params(_nest(flat)))


def _to_state(key: str, arr: np.ndarray):
    """One Flax array -> (state_dict key, array in the port's layout)."""
    *module, leaf = key.split("/")
    if leaf == "kernel":
        if arr.ndim == 2:
            arr = arr.T  # Dense (in, out) -> Linear (out, in)
        elif arr.ndim == 4 and not _DENSE.match(key):
            arr = arr.transpose(3, 2, 0, 1)  # HWIO -> OIHW
        leaf = "weight"
    return ".".join([*module, leaf]), arr


def flax_key(state_key: str, ndim: int) -> str:
    """A state_dict key -> its Flax key, '/'-joined without the `params`
    root: `trunk.conv_first.weight` -> `trunk/conv_first/kernel`. A weight
    of `ndim` 2 or 4 (Linear, Conv2d) is a Flax kernel; any other name is
    kept (`norm.scale`, `attn.relative_position_bias_table`, Restormer's
    `norm1.weight`)."""
    module, leaf = state_key.rsplit(".", 1)
    if leaf == "weight" and ndim in (2, 4):
        leaf = "kernel"
    return module.replace(".", "/") + "/" + leaf


def _to_flax(state_key: str, arr: np.ndarray):
    """One state_dict array -> (Flax key, array in the Flax layout)."""
    key = flax_key(state_key, arr.ndim)
    if key.endswith("/kernel"):
        if arr.ndim == 2:
            arr = arr.T
        elif not _DENSE.match(key):
            arr = arr.transpose(2, 3, 1, 0)  # OIHW -> HWIO
    return key, arr


def params_from_flax(src: Union[str, Path, Mapping], model: Optional[torch.nn.Module] = None
                     ) -> Dict[str, torch.Tensor]:
    """Flax params -> state_dict (f32, contiguous CPU tensors): of an RRDB
    generator without `model`, of `model` (any registry model, either
    layout) with it."""
    flat = _unrolled(_flat_params(src))
    if model is None:
        _check_rrdb(flat)
    state = {}
    for key, arr in flat.items():
        name, arr = _to_state(key, np.array(arr, np.float32))  # a writable f32 copy
        state[name] = torch.from_numpy(np.ascontiguousarray(arr))
    if model is None:
        return state
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    missing, extra = sorted(set(want) - set(state)), sorted(set(state) - set(want))
    if missing or extra:
        raise KeyError(f"Flax params do not form a {type(model).__name__}: missing "
                       f"{missing}, unexpected {extra}")
    bad = [k for k in want if tuple(state[k].shape) != want[k]]
    if bad:
        raise ValueError(f"Flax params of the wrong shape for {type(model).__name__}: " + ", ".join(
            f"{k} {tuple(state[k].shape)} != {want[k]}" for k in bad))
    return state


def load_params_npz(path: Union[str, Path], model: torch.nn.Module) -> Dict[str, np.ndarray]:
    """The Flax arrays of `model`'s parameters from an npz checkpoint,
    float32, keyed as in the checkpoint without the `params` root (the
    `layers_scan` layout when the model's `scan_layers` is set). Raises
    KeyError for a missing array and ValueError for one of the wrong shape."""
    template = _flatten(flax_tree(model.state_dict(),
                                  scan_layers=getattr(model, "scan_layers", False)))
    out = {}
    with np.load(path) as npz:
        for key, want in template.items():
            arr = npz[f"params/{key}"]
            if arr.shape != want.shape:
                raise ValueError(f"{key}: shape {arr.shape} != the model's {want.shape}")
            out[key] = np.asarray(arr, np.float32)
    return out


def save_params_npz(path: Union[str, Path],
                    src: Union[torch.nn.Module, Mapping[str, torch.Tensor]],
                    scan_layers: Optional[bool] = None) -> None:
    """Write a model's parameters (or a state_dict's) as an npz in the Flax
    key layout; scanned when `scan_layers` (by default the model's own)."""
    if isinstance(src, torch.nn.Module):
        if scan_layers is None:
            scan_layers = getattr(src, "scan_layers", False)
        src = src.state_dict()
    flat = _flatten(flax_tree(src, scan_layers=bool(scan_layers)))
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, **{f"params/{k}": v for k, v in flat.items()})


def flax_tree(src, scan_layers: bool = False) -> Dict:
    """Flax params (any source `params_from_flax` takes) or a state_dict ->
    nested dict of numpy f32 arrays, without the `params` root, e.g.
    tree["trunk"]["rrdb_0"]["RDB1"]["conv1"]["kernel"] (HWIO). A state_dict
    becomes the scanned layout when `scan_layers`."""
    if isinstance(src, Mapping) and src and all(
        isinstance(v, torch.Tensor) for v in src.values()
    ):
        flat = dict(_to_flax(k, t.detach().cpu().float().numpy()) for k, t in src.items())
        tree = _nest({k: np.array(v, np.float32) for k, v in flat.items()})
        return stack_layer_params(tree) if scan_layers else tree
    return _nest({k: np.array(v, np.float32) for k, v in _flat_params(src).items()})


def vgg_state_from_flax(src, vgg_model: str = "vgg19", layers: int = 8) -> Dict[str, torch.Tensor]:
    """The JAX package's Flax `VGGFeatures` params (any source
    `params_from_flax` takes) -> the state_dict of the port's `VGGFeatures`:
    the i-th conv's `conv_i/kernel` (HWIO) becomes `features.N.weight`
    (OIHW) at its torchvision module index N."""
    from ..metrics.vgg import VGG_CONFIGS, _torchvision_modules

    flat = _flat_params(src)
    state, conv_i = {}, 0
    for seq_i, (kind, _) in enumerate(_torchvision_modules(VGG_CONFIGS[vgg_model])[: layers + 1]):
        if kind != "conv":
            continue
        kernel = np.asarray(flat.pop(f"conv_{conv_i}/kernel"), np.float32)
        state[f"features.{seq_i}.weight"] = torch.from_numpy(
            np.ascontiguousarray(kernel.transpose(3, 2, 0, 1)))
        state[f"features.{seq_i}.bias"] = torch.from_numpy(
            np.array(flat.pop(f"conv_{conv_i}/bias"), np.float32))
        conv_i += 1
    if flat:
        raise KeyError(f"keys of no conv of {vgg_model}[:{layers + 1}]: {sorted(flat)}")
    return state
