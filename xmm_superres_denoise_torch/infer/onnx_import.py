"""ONNX weight import and export without the onnx package.

The port of the JAX package's `infer/onnx_import.py`. The reference ships
its production models as ONNX graphs (XMM-SuperRes.onnx / XMM-DeNoise.onnx,
consumed via onnxruntime in `utils/run_inference_on_file.py:42-48`). An ONNX
ModelProto is protobuf, so this module parses the wire format directly and
lifts the initializers onto the Flax parameter layout that
`utils/weights.params_from_flax` takes:

  * minimal protobuf reader (varint / length-delimited) for
    ModelProto -> GraphProto -> TensorProto fields,
  * flax<->torch naming for EVERY model family (RRDB + SwinIR/SwinFIR/
    DRCT/HAT/Restormer — :func:`flax_to_torch_name`), with conv
    "weight" (O, I, kh, kw) -> HWIO kernel via (2, 3, 1, 0) transpose and
    Linear (out, in) -> (in, out),
  * shape-order fallback for exporter-renamed graphs, REFUSED when shapes
    are ambiguous (repeated transformer blocks would silently scramble).

A parameter tree here is a nested dict of numpy arrays in the Flax layout
(no `params` root), e.g. `utils/weights.flax_tree(model.state_dict(),
scan_layers=...)`; its leaves are visited in sorted-key order, the order in
which the JAX package flattens a Flax tree, so the shape fallback pairs
exactly as there. Full runnable graph EXPORT lives in onnx_export.py; graph
EXECUTION in onnx_runtime_lite.py.
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import Any, Dict, Iterator, List, Mapping, Optional, Tuple, Union

import numpy as np

# --------------------------------------------------------------------------- #
# Protobuf wire-format reader
# --------------------------------------------------------------------------- #


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _iter_fields(buf: bytes) -> Iterator[Tuple[int, int, Union[int, bytes]]]:
    """Yield (field_number, wire_type, value) over a message buffer."""
    pos = 0
    n = len(buf)
    while pos < n:
        key, pos = _read_varint(buf, pos)
        field, wtype = key >> 3, key & 7
        if wtype == 0:
            val, pos = _read_varint(buf, pos)
        elif wtype == 1:
            val = buf[pos : pos + 8]
            pos += 8
        elif wtype == 2:
            ln, pos = _read_varint(buf, pos)
            val = buf[pos : pos + ln]
            pos += ln
        elif wtype == 5:
            val = buf[pos : pos + 4]
            pos += 4
        else:
            raise ValueError(f"Unsupported wire type {wtype}")
        yield field, wtype, val


_ONNX_DTYPES = {
    1: np.float32,
    2: np.uint8,
    3: np.int8,
    6: np.int32,
    7: np.int64,
    10: np.float16,
    11: np.float64,
}


def _parse_tensor(buf: bytes) -> Tuple[str, np.ndarray]:
    """TensorProto -> (name, array)."""
    dims: List[int] = []
    data_type = 1
    name = ""
    raw: Optional[bytes] = None
    float_data: List[float] = []
    int64_data: List[int] = []
    for field, wtype, val in _iter_fields(buf):
        if field == 1:
            if wtype == 0:
                dims.append(val)
            else:  # packed
                p = 0
                while p < len(val):
                    v, p = _read_varint(val, p)
                    dims.append(v)
        elif field == 2:
            data_type = val
        elif field == 4:
            if wtype == 2:
                float_data.extend(struct.unpack(f"<{len(val) // 4}f", val))
            else:
                float_data.append(struct.unpack("<f", val)[0])
        elif field == 7:
            if wtype == 2:
                p = 0
                while p < len(val):
                    v, p = _read_varint(val, p)
                    int64_data.append(v)
            else:
                int64_data.append(val)
        elif field == 8:
            name = val.decode("utf-8")
        elif field == 9:
            raw = val

    dtype = _ONNX_DTYPES.get(data_type, np.float32)
    if raw is not None:
        arr = np.frombuffer(raw, dtype=dtype)
    elif float_data:
        arr = np.asarray(float_data, np.float32)
    elif int64_data:
        arr = np.asarray(int64_data, np.int64)
    else:
        arr = np.zeros(0, dtype)
    return name, arr.reshape(dims) if dims else arr


def read_onnx_initializers(path: Union[str, Path, bytes]) -> Dict[str, np.ndarray]:
    """All graph initializers of an ONNX file, in graph order."""
    blob = path if isinstance(path, bytes) else Path(path).read_bytes()
    out: Dict[str, np.ndarray] = {}
    for field, wtype, val in _iter_fields(blob):  # ModelProto
        if field == 7 and wtype == 2:  # graph: GraphProto
            for gfield, gw, gval in _iter_fields(val):
                if gfield == 5 and gw == 2:  # initializer: TensorProto
                    name, arr = _parse_tensor(gval)
                    out[name] = arr
    return out


# --------------------------------------------------------------------------- #
# Mapping onto Flax pytrees
# --------------------------------------------------------------------------- #


def flatten_tree(tree: Mapping, prefix: str = "") -> List[Tuple[str, Any]]:
    """(path, leaf) pairs of a nested dict, '/'-joined paths, keys sorted at
    every level (the JAX package's tree-flattening order)."""
    out: List[Tuple[str, Any]] = []
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, Mapping):
            out.extend(flatten_tree(v, f"{prefix}{k}/"))
        else:
            out.append((f"{prefix}{k}", v))
    return out


def _nest(pairs) -> Dict:
    tree: Dict = {}
    for key, arr in pairs:
        node = tree
        *path, leaf = key.split("/")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = arr
    return tree


def _as_tree(params: Any) -> Dict:
    """A Flax tree (no `params` root) from a nested dict of arrays, with or
    without the `params` root, a torch module or a state_dict."""
    import torch

    if isinstance(params, torch.nn.Module):
        params = params.state_dict()
    if params and all(isinstance(v, torch.Tensor) for v in params.values()):
        from ..utils.weights import flax_tree

        return flax_tree(params)
    if "params" in params:
        params = params["params"]
    return dict(params)


# Flax module segments whose trailing "_<k>" is part of the NAME, not a
# torch ModuleList index (Restormer level-transition modules).
_ATOMIC_SEGMENTS = {
    "down1_2", "down2_3", "down3_4", "up4_3", "up3_2", "up2_1",
}


def flax_to_torch_name(path: str) -> str:
    """Flax param path -> reference torch state-dict name, for every model
    family (RRDB rrdb.py / Swin zoo swin_common.py+swinir.py+drct.py+hat.py /
    Restormer restormer.py). The flax module names deliberately mirror the
    reference's torch attribute names, so this is a small set of idiom
    bridges (cited to the reference definitions):

      RRDB   trunk/<m>            -> <m>     (trunk is flattened in torch)
             trunk/rrdb_<i>       -> rrdb.<i>
             upconv_<i>           -> upsampling.<3i>  (conv,lrelu,PS per
                                     stage — generator_rrdb.py:92-101)
      Swin   layers_<i>/...       -> layers.<i>...
             blocks_<j>/overlap_attn directly under layers_<i> gain the
             torch `residual_group` level (hat.py:553-563; my HAT flattens)
             patch_embed_norm     -> patch_embed.norm (modules.py:450-455)
             conv_before_upsample -> conv_before_upsample.0 (Sequential)
             upsample/conv_<k>    -> upsample.<2k> (conv,PixelShuffle pairs)
      SwinFIR conv/F/conv1        -> conv.F.conv1.0 (Sequential conv+lrelu,
                                     swinfir.py:70-73)
             conv/S/body_<k>      -> conv.S.body.<k>
      HAT    conv_block/cab_<k>   -> conv_block.cab.<k> (hat.py:36-41)
             conv_block/ca/attention_<k> -> conv_block.cab.3.attention.<k>
                                     (ChannelAttention is cab[3], hat.py:19-26)
      Restormer patch_embed       -> patch_embed.proj (restormer.py:173)
             encoder_level1_<j>   -> encoder_level1.<j> (Sequential)
             down*/up*/body       -> body.0 (Sequential conv+PixelShuffle)
             norm1|norm2 weight/bias -> norm<k>.body.* (LayerNorm wrapper,
                                     restormer.py:60-71)

    Leaves: kernel/scale/weight -> weight; bias -> bias; everything else
    (relative_position_bias_table, temperature, ...) unchanged.
    """
    parts = path.split("/")
    leaf = {"kernel": "weight", "scale": "weight"}.get(parts[-1], parts[-1])
    mods = parts[:-1]
    out: List[str] = []
    for i, m in enumerate(mods):
        prev = out[-1] if out else ""
        if m == "trunk":
            continue  # RRDB trunk flattened in torch naming
        if m.startswith("rrdb_"):
            out.extend(["rrdb", m.split("_")[1]])
        elif m.startswith("upconv_"):
            out.extend(["upsampling", str(int(m.split("_")[1]) * 3)])
        elif m == "patch_embed_norm":
            out.extend(["patch_embed", "norm"])
        elif m == "conv_before_upsample":
            out.extend(["conv_before_upsample", "0"])
        elif m.startswith("conv_") and prev == "upsample" and m[5:].isdigit():
            out.append(str(int(m[5:]) * 2))
        elif m == "conv1" and prev == "F":
            out.extend(["conv1", "0"])
        elif m == "ca" and prev == "conv_block":
            out.extend(["cab", "3"])
        elif (
            (m.startswith("blocks_") or m == "overlap_attn")
            and prev.startswith("layers.")  # HAT: flax flattens residual_group
        ) or (
            (m.startswith("blocks_") or m == "overlap_attn")
            and out
            and out[-1].isdigit()
            and len(out) >= 2
            and out[-2] == "layers"
        ):
            out.append("residual_group")
            if m == "overlap_attn":
                out.append(m)
            else:
                out.extend(["blocks", m.split("_")[1]])
        elif m == "patch_embed" and leaf == "weight" and i == len(mods) - 1:
            out.extend(["patch_embed", "proj"])  # Restormer OverlapPatchEmbed
        elif m == "body" and prev.split(".")[-1] in (
            "down1_2", "down2_3", "down3_4", "up4_3", "up3_2", "up2_1",
        ):
            out.extend(["body", "0"])
        elif m in _ATOMIC_SEGMENTS:
            out.append(m)
        elif "_" in m and m.rsplit("_", 1)[1].isdigit() and m.rsplit("_", 1)[
            0
        ] not in ("norm", "swin", "adjust", "conv", "fc"):
            stem, idx = m.rsplit("_", 1)
            out.extend([stem, idx])
        else:
            out.append(m)
    # Restormer LayerNorm wrapper: norm1.weight -> norm1.body.weight. Only
    # Restormer norms carry a literal `weight` leaf (ChannelLayerNorm);
    # Swin LayerNorms use flax `scale`, already mapped above — distinguish
    # by the ORIGINAL leaf name.
    if parts[-1] in ("weight", "bias") and out and out[-1] in ("norm1", "norm2"):
        is_restormer_norm = parts[-1] == "weight" or any(
            s in path for s in ("encoder_level", "decoder_level", "latent",
                                "refinement")
        )
        if is_restormer_norm:
            out.append("body")
    return ".".join(out + [leaf])


def _normalize_torch_name(name: str) -> str:
    """torch state-dict name -> flax RRDB path (legacy direction, kept for
    checkpoints whose names survive ONNX export; the primary import path
    now matches flax->torch via :func:`flax_to_torch_name`)."""
    for prefix in ("model.", "module.", "net."):
        if name.startswith(prefix):
            name = name[len(prefix) :]
    parts = name.split(".")
    leaf = {"weight": "kernel", "bias": "bias"}.get(parts[-1], parts[-1])
    mods = parts[:-1]
    out: List[str] = []
    i = 0
    while i < len(mods):
        m = mods[i]
        if m in ("conv_first", "trunk_conv"):
            out.extend(["trunk", m])
        elif m == "rrdb" and i + 1 < len(mods) and mods[i + 1].isdigit():
            out.extend(["trunk", f"rrdb_{mods[i + 1]}"])
            i += 1
        elif m == "upsampling" and i + 1 < len(mods) and mods[i + 1].isdigit():
            out.append(f"upconv_{int(mods[i + 1]) // 3}")
            i += 1
        else:
            out.append(m)
        i += 1
    return "/".join(out + [leaf])


def import_onnx_params(
    onnx_path: Union[str, Path],
    params_template: Any,
    allow_shape_fallback: bool = True,
) -> Any:
    """Initializers -> Flax params (a nested dict of numpy arrays with the
    template's structure and dtypes), NCHW->HWIO transposed. The template
    is any tree `_as_tree` takes, e.g. `flax_tree(model.state_dict(),
    scan_layers=model.scan_layers)`.

    Matching order:
      1. direct: torch name computed from each flax path
         (:func:`flax_to_torch_name` — covers RRDB + the full transformer
         zoo, so real torch-exported checkpoints map without guessing);
      2. legacy normalized-name map (RRDB conventions);
      3. shape fallback in graph order (exporter renamings like
         `onnx::Conv_123`) — REFUSED when the shape is ambiguous among the
         remaining targets (repeated same-shape Swin blocks would silently
         scramble); disable entirely with allow_shape_fallback=False.

    A scan-compressed template (DRCT/HAT `scan_layers=True`, stacked
    `layers_scan` subtree) is handled transparently: the import runs
    against the unrolled layout and the result is re-stacked.
    """
    params_template = _as_tree(params_template)
    if "layers_scan" in params_template:
        from ..models.scan_stack import (
            stack_layer_params,
            unstack_layer_params,
        )

        unrolled = import_onnx_params(
            onnx_path,
            unstack_layer_params(params_template),
            allow_shape_fallback,
        )
        return stack_layer_params(unrolled)

    inits = read_onnx_initializers(onnx_path)

    targets = [(path, np.asarray(leaf)) for path, leaf in flatten_tree(params_template)]
    assigned: Dict[int, np.ndarray] = {}
    used = set()

    def _converted(
        arr: np.ndarray, target_shape, is_kernel: bool = True
    ) -> Optional[np.ndarray]:
        if arr.ndim == 4 and tuple(arr.transpose(2, 3, 1, 0).shape) == tuple(
            target_shape
        ):
            return np.ascontiguousarray(arr.transpose(2, 3, 1, 0))
        if (
            arr.ndim == 2
            and is_kernel
            and tuple(arr.T.shape) == tuple(target_shape)
            and (arr.shape != tuple(target_shape) or arr.shape[0] == arr.shape[1])
        ):
            return np.ascontiguousarray(arr.T)  # torch Linear (out, in) -> (in, out)
        if tuple(arr.shape) == tuple(target_shape):
            return arr
        return None

    # pass 1: direct flax -> torch names
    for i, (path, leaf) in enumerate(targets):
        key = flax_to_torch_name(path)
        if key not in inits:
            continue
        conv = _converted(inits[key], leaf.shape, path.endswith("/kernel"))
        if conv is not None:
            assigned[i] = conv.astype(np.asarray(leaf).dtype)
            used.add(key)

    # pass 1b: legacy torch-name normalization (RRDB conventions)
    norm_map = {_normalize_torch_name(k): k for k in inits if k not in used}
    for i, (path, leaf) in enumerate(targets):
        if i in assigned:
            continue
        key = norm_map.get(path)
        if key is None or key in used:
            continue
        conv = _converted(inits[key], leaf.shape, path.endswith("/kernel"))
        if conv is not None:
            assigned[i] = conv.astype(np.asarray(leaf).dtype)
            used.add(key)

    # pass 2: leftovers by shape in graph order, ambiguity-guarded
    if allow_shape_fallback:
        def _shape_key(shape):
            return tuple(shape)

        remaining = [i for i in range(len(targets)) if i not in assigned]
        shape_counts: Dict[tuple, int] = {}
        for i in remaining:
            shape_counts[_shape_key(targets[i][1].shape)] = (
                shape_counts.get(_shape_key(targets[i][1].shape), 0) + 1
            )
        leftovers = [k for k in inits if k not in used]
        for i in remaining:
            path, leaf = targets[i]
            if shape_counts[_shape_key(leaf.shape)] > 1:
                raise ValueError(
                    f"ONNX import: unmatched parameter {path!r} has a shape "
                    f"shared by {shape_counts[_shape_key(leaf.shape)]} "
                    "unmatched targets — shape-order fallback would be "
                    "ambiguous (repeated transformer blocks). The checkpoint "
                    "names don't follow a known convention."
                )
            for k in leftovers:
                conv = _converted(inits[k], leaf.shape)
                if conv is not None:
                    assigned[i] = conv.astype(np.asarray(leaf).dtype)
                    leftovers.remove(k)
                    break

    missing = [targets[i][0] for i in range(len(targets)) if i not in assigned]
    if missing:
        raise ValueError(
            f"ONNX import could not match {len(missing)} parameters: "
            f"{missing[:5]}..."
        )

    return _nest((targets[i][0], assigned[i]) for i in range(len(targets)))


# --------------------------------------------------------------------------- #
# Writer (testing / export parity without the onnx package)
# --------------------------------------------------------------------------- #


def _varint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _field(num: int, wtype: int, payload: bytes) -> bytes:
    head = _varint((num << 3) | wtype)
    if wtype == 2:
        return head + _varint(len(payload)) + payload
    return head + payload


def write_onnx_initializers(
    path: Union[str, Path], tensors: Dict[str, np.ndarray]
) -> Path:
    """Minimal ModelProto containing only named float initializers — enough
    to exercise the import path end-to-end in tests."""
    graph = b""
    for name, arr in tensors.items():
        arr = np.asarray(arr, np.float32)
        t = b""
        for d in arr.shape:
            t += _field(1, 0, _varint(d))
        t += _field(2, 0, _varint(1))  # FLOAT
        t += _field(8, 2, name.encode())
        t += _field(9, 2, arr.astype("<f4").tobytes())
        graph += _field(5, 2, t)
    model = _field(7, 2, graph)
    path = Path(path)
    path.write_bytes(model)
    return path


def export_onnx_params(params: Any, path: Union[str, Path]) -> Path:
    """Export parameters (any tree `_as_tree` takes, of any model family) as
    ONNX initializers with torch state-dict naming (HWIO -> OIHW, Linear
    (in,out) -> (out,in)), interchangeable with the reference's shipped
    checkpoint format."""
    params = _as_tree(params)
    if "layers_scan" in params:
        # scan-compressed checkpoint (DRCT/HAT scan_layers=True): unstack
        # to the torch-name-compatible unrolled layout first
        from ..models.scan_stack import unstack_layer_params

        params = unstack_layer_params(params)
    tensors: Dict[str, np.ndarray] = {}
    for fpath, leaf in flatten_tree(params):
        name = flax_to_torch_name(fpath)
        arr = np.asarray(leaf)
        if arr.ndim == 4:  # HWIO -> OIHW
            arr = np.ascontiguousarray(arr.transpose(3, 2, 0, 1))
        elif arr.ndim == 2 and fpath.endswith("/kernel"):
            arr = np.ascontiguousarray(arr.T)  # Linear (in, out) -> (out, in)
        tensors[name] = arr
    return write_onnx_initializers(path, tensors)
