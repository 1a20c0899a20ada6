"""Full ONNX graph export for the RRDB models (nodes + initializers).

The port of the JAX package's `infer/onnx_export.py`. The reference ships
deployment artifacts as complete ONNX graphs executed by onnxruntime
(`utils/run_inference_on_file.py:42-48`). `export_onnx_params`
(onnx_import.py) covers the WEIGHTS; this module emits the GRAPH — Conv /
LeakyRelu / Concat / Mul / Add / DepthToSpace(CRD) / Clip nodes in NCHW with
OIHW weights and torch state-dict initializer names — so the artifact is
runnable by any ONNX runtime elsewhere. The graph is built from the port's
model and its state dict; nodes, attributes and initializers are the JAX
package's, in its order (the files differ in the producer name only).

Validated by `onnx_runtime_lite.run_graph`, an independent executor of the
emitted op subset, against the port's forward.

Semantics mirrored exactly (models/rrdb.py / reference generator_rrdb.py):
dense 5C blocks (LeakyReLU 0.2), 0.2-scaled residuals, SR head with
LeakyReLU 0.01 + PixelShuffle(2) == DepthToSpace mode=CRD, DN input skip,
final Clip(0, 1).
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np

from ..models.rrdb import GeneratorRRDB_DN, GeneratorRRDB_SR
from .onnx_import import _as_tree, _field, _varint, flatten_tree, flax_to_torch_name

PRODUCER = b"xmm_superres_denoise_torch"

# AttributeProto.type enum
_ATTR_FLOAT, _ATTR_INT, _ATTR_STRING, _ATTR_INTS = 1, 2, 3, 7


def _attr(name: str, value, typ: int) -> bytes:
    a = _field(1, 2, name.encode())
    if typ == _ATTR_FLOAT:
        a += _field(2, 5, struct.pack("<f", float(value)))
    elif typ == _ATTR_INT:
        a += _field(3, 0, _varint(int(value)))
    elif typ == _ATTR_STRING:
        a += _field(4, 2, value.encode())
    elif typ == _ATTR_INTS:
        for v in value:
            a += _field(8, 0, _varint(int(v)))
    a += _field(20, 0, _varint(typ))
    return a


def _node(op: str, inputs: Sequence[str], outputs: Sequence[str],
          attrs: Sequence[bytes] = (), name: str = "") -> bytes:
    n = b""
    for i in inputs:
        n += _field(1, 2, i.encode())
    for o in outputs:
        n += _field(2, 2, o.encode())
    if name:
        n += _field(3, 2, name.encode())
    n += _field(4, 2, op.encode())
    for a in attrs:
        n += _field(5, 2, a)
    return n


def _tensor_proto(name: str, arr: np.ndarray) -> bytes:
    arr = np.asarray(arr, np.float32)
    t = b""
    for d in arr.shape:
        t += _field(1, 0, _varint(d))
    t += _field(2, 0, _varint(1))  # FLOAT
    t += _field(8, 2, name.encode())
    t += _field(9, 2, arr.astype("<f4").tobytes())
    return t


def _value_info(name: str, shape: Sequence[Union[int, str]]) -> bytes:
    dims = b""
    for d in shape:
        if isinstance(d, str):
            dims += _field(1, 2, _field(2, 2, d.encode()))
        else:
            dims += _field(1, 2, _field(1, 0, _varint(d)))
    tensor = _field(1, 0, _varint(1)) + _field(2, 2, dims)  # elem FLOAT + shape
    return _field(1, 2, name.encode()) + _field(2, 2, _field(1, 2, tensor))


class _GraphBuilder:
    def __init__(self, params_flat: Dict[str, np.ndarray]):
        self.nodes: List[bytes] = []
        self.inits: Dict[str, np.ndarray] = {}
        self.params = params_flat  # flax path -> array (HWIO)
        self._n = 0

    def tname(self, flax_path: str) -> str:
        """Register the conv weight/bias pair as torch-named initializers."""
        return flax_to_torch_name(flax_path)

    def fresh(self, stem: str) -> str:
        self._n += 1
        return f"{stem}_{self._n}"

    def const(self, name: str, arr) -> str:
        self.inits[name] = np.asarray(arr, np.float32)
        return name

    def conv(self, x: str, flax_prefix: str) -> str:
        w = self.params[flax_prefix + "/kernel"]
        b = self.params[flax_prefix + "/bias"]
        wn = self.tname(flax_prefix + "/kernel")
        bn = self.tname(flax_prefix + "/bias")
        self.inits[wn] = np.ascontiguousarray(
            np.asarray(w, np.float32).transpose(3, 2, 0, 1)
        )  # HWIO -> OIHW
        self.inits[bn] = np.asarray(b, np.float32)
        out = self.fresh("conv")
        k = self.inits[wn].shape[2]
        p = k // 2
        self.nodes.append(
            _node(
                "Conv", [x, wn, bn], [out],
                attrs=[
                    _attr("dilations", [1, 1], _ATTR_INTS),
                    _attr("group", 1, _ATTR_INT),
                    _attr("kernel_shape", [k, k], _ATTR_INTS),
                    _attr("pads", [p, p, p, p], _ATTR_INTS),
                    _attr("strides", [1, 1], _ATTR_INTS),
                ],
                name=flax_prefix.replace("/", "."),
            )
        )
        return out

    def lrelu(self, x: str, alpha: float) -> str:
        out = self.fresh("lrelu")
        self.nodes.append(
            _node("LeakyRelu", [x], [out], [_attr("alpha", alpha, _ATTR_FLOAT)])
        )
        return out

    def concat(self, xs: Sequence[str]) -> str:
        out = self.fresh("cat")
        self.nodes.append(
            _node("Concat", list(xs), [out], [_attr("axis", 1, _ATTR_INT)])
        )
        return out

    def mul_const(self, x: str, c: float) -> str:
        cname = self.const(self.fresh("scale"), np.float32(c))
        out = self.fresh("mul")
        self.nodes.append(_node("Mul", [x, cname], [out]))
        return out

    def add(self, a: str, b: str) -> str:
        out = self.fresh("add")
        self.nodes.append(_node("Add", [a, b], [out]))
        return out

    def depth_to_space(self, x: str, block: int) -> str:
        out = self.fresh("d2s")
        self.nodes.append(
            _node(
                "DepthToSpace", [x], [out],
                [_attr("blocksize", block, _ATTR_INT),
                 _attr("mode", "CRD", _ATTR_STRING)],
            )
        )
        return out

    def clip01(self, x: str, out_name: str) -> str:
        lo = self.const("clip_min", np.float32(0.0))
        hi = self.const("clip_max", np.float32(1.0))
        self.nodes.append(_node("Clip", [x, lo, hi], [out_name]))
        return out_name


def _flatten_params(params: Any) -> Dict[str, np.ndarray]:
    return {k: np.asarray(v) for k, v in flatten_tree(_as_tree(params))}


def _dense_block(g: _GraphBuilder, x: str, prefix: str) -> str:
    feats = [x]
    for j in range(1, 5):
        h = g.conv(feats[0] if j == 1 else g.concat(feats), f"{prefix}/conv{j}")
        feats.append(g.lrelu(h, 0.2))
    x5 = g.conv(g.concat(feats), f"{prefix}/conv5")
    return g.add(g.mul_const(x5, 0.2), x)


def export_rrdb_onnx_model(
    model: Union[GeneratorRRDB_SR, GeneratorRRDB_DN],
    params: Optional[Any],
    path: Union[str, Path],
    input_hw=("H", "W"),
) -> Path:
    """Emit a complete, runnable ONNX ModelProto for an RRDB model.

    `params` is the model's state dict, or any tree `onnx_import._as_tree`
    takes; None exports the model's own weights. NCHW input `input` (1,
    in_channels, H, W) -> output `output`; weights are torch-named
    initializers so `import_onnx_params` round-trips the same file. Spatial
    dims are symbolic by default (fully convolutional graph).
    """
    sr = isinstance(model, GeneratorRRDB_SR)
    g = _GraphBuilder(_flatten_params(model.state_dict() if params is None else params))
    in_channels = model.trunk.conv_first.weight.shape[1]
    out_channels = model.conv_last.weight.shape[0]

    x = "input"
    fea = g.conv(x, "trunk/conv_first")
    t = fea
    for i in range(model.trunk.num_res_blocks):
        inner = t
        for k in (1, 2, 3):
            inner = _dense_block(g, inner, f"trunk/rrdb_{i}/RDB{k}")
        t = g.add(g.mul_const(inner, 0.2), t)
    fea = g.add(fea, g.conv(t, "trunk/trunk_conv"))

    if sr:
        for i in range(model.num_upsample):
            up = g.conv(fea, f"upconv_{i}")
            up = g.lrelu(up, 0.01)
            fea = g.depth_to_space(up, 2)
        hr = g.lrelu(g.conv(fea, "HRconv"), 0.2)
        out = g.conv(hr, "conv_last")
    else:
        out = g.add(g.conv(fea, "conv_last"), x)
    g.clip01(out, "output")

    scale = 2 ** model.num_upsample if sr else 1
    out_hw = [
        d * scale if isinstance(d, int) else f"{scale}*{d}" if scale != 1 else d
        for d in input_hw
    ]
    graph = b""
    for n in g.nodes:
        graph += _field(1, 2, n)
    graph += _field(2, 2, b"xmm_rrdb")
    for name, arr in g.inits.items():
        graph += _field(5, 2, _tensor_proto(name, arr))
    graph += _field(11, 2, _value_info("input", [1, in_channels, *input_hw]))
    graph += _field(12, 2, _value_info("output", [1, out_channels, *out_hw]))

    modelp = _field(1, 0, _varint(8))  # ir_version 8
    modelp += _field(2, 2, PRODUCER)
    modelp += _field(8, 2, _field(1, 2, b"") + _field(2, 0, _varint(13)))  # opset 13
    modelp += _field(7, 2, graph)

    path = Path(path)
    path.write_bytes(modelp)
    return path
