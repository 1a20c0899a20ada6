"""Minimal ONNX graph executor for the RRDB deployment graphs, in PyTorch.

The port of the JAX package's `infer/onnx_runtime_lite.py`. It fills the
role of onnxruntime in the reference's ONNX serve path
(`utils/run_inference_on_file.py:42-48`): it parses a ModelProto (wire
format, no onnx package) into nodes + initializers and evaluates the op
subset emitted by `onnx_export.export_rrdb_onnx_model` (Conv, LeakyRelu,
Concat, Mul, Add, DepthToSpace in CRD and DCR, Clip, and the Relu and
Constant nodes of torch's exporter) with `torch.nn.functional` ops on the
device it is given, f32 with TF32 off.

It is the independent validator of the exporter: the graph is executed
purely from its own parsed structure (attrs, wiring, initializer names),
never from the port's model. It is no kernel of the serving path.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Union

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.precision import true_f32
from .onnx_import import _iter_fields, _parse_tensor


@dataclass
class OnnxNode:
    op_type: str
    inputs: List[str]
    outputs: List[str]
    name: str = ""
    attrs: Dict[str, object] = field(default_factory=dict)


@dataclass
class OnnxGraph:
    nodes: List[OnnxNode]
    initializers: Dict[str, np.ndarray]
    inputs: List[str]
    outputs: List[str]


def _parse_attr(buf: bytes):
    name, f, i, s, t, ints = "", None, None, None, None, []
    floats: list = []
    for fieldno, wtype, val in _iter_fields(buf):
        if fieldno == 1:
            name = val.decode()
        elif fieldno == 2:
            f = struct.unpack("<f", val)[0]
        elif fieldno == 3:
            i = val
        elif fieldno == 4:
            s = val.decode()
        elif fieldno == 5:
            # t (TensorProto): torch's exporter emits Clip bounds / scalar
            # multipliers as Constant nodes with a tensor `value` attr
            t = _parse_tensor(val)[1]
        elif fieldno == 7:
            if wtype == 5:
                floats.append(struct.unpack("<f", val)[0])
            else:  # packed repeated float: 4-byte little-endian chunks
                floats.extend(
                    struct.unpack(f"<{len(val) // 4}f", val[: len(val) // 4 * 4])
                )
        elif fieldno == 8:
            if wtype == 0:
                ints.append(val)
            else:  # packed
                p = 0
                while p < len(val):
                    v, shift = 0, 0
                    while True:
                        v |= (val[p] & 0x7F) << shift
                        shift += 7
                        p += 1
                        if not val[p - 1] & 0x80:
                            break
                    ints.append(v)
    if ints:
        return name, ints
    if floats:
        return name, floats
    for v in (i, f, s, t):
        if v is not None:
            return name, v
    return name, None


def _parse_node(buf: bytes) -> OnnxNode:
    node = OnnxNode("", [], [])
    for fieldno, _, val in _iter_fields(buf):
        if fieldno == 1:
            node.inputs.append(val.decode())
        elif fieldno == 2:
            node.outputs.append(val.decode())
        elif fieldno == 3:
            node.name = val.decode()
        elif fieldno == 4:
            node.op_type = val.decode()
        elif fieldno == 5:
            k, v = _parse_attr(val)
            node.attrs[k] = v
    return node


def _vi_name(buf: bytes) -> str:
    for fieldno, _, val in _iter_fields(buf):
        if fieldno == 1:
            return val.decode()
    return ""


def read_onnx_model(path: Union[str, Path, bytes]) -> OnnxGraph:
    blob = path if isinstance(path, bytes) else Path(path).read_bytes()
    graph = OnnxGraph([], {}, [], [])
    for fieldno, wtype, val in _iter_fields(blob):  # ModelProto
        if fieldno == 7 and wtype == 2:
            for g, gw, gval in _iter_fields(val):
                if g == 1:
                    graph.nodes.append(_parse_node(gval))
                elif g == 5:
                    name, arr = _parse_tensor(gval)
                    graph.initializers[name] = arr
                elif g == 11:
                    graph.inputs.append(_vi_name(gval))
                elif g == 12:
                    graph.outputs.append(_vi_name(gval))
    return graph


def _depth_to_space(x: torch.Tensor, block: int, mode: str) -> torch.Tensor:
    n, c, h, w = x.shape
    co = c // (block * block)
    if mode == "CRD":  # torch pixel_shuffle ordering
        x = x.reshape(n, co, block, block, h, w).permute(0, 1, 4, 2, 5, 3)
    else:  # DCR (ONNX default)
        x = x.reshape(n, block, block, co, h, w).permute(0, 3, 4, 1, 5, 2)
    return x.reshape(n, co, h * block, w * block)


def _conv(ins, a) -> torch.Tensor:
    x, w = ins[0], ins[1]
    pads = list(a.get("pads", [0, 0, 0, 0]))
    strides = tuple(a.get("strides", [1, 1]))
    groups = int(a.get("group", 1))
    # ONNX pads are (top, left, bottom, right)
    if pads[0] == pads[2] and pads[1] == pads[3]:
        padding = (pads[0], pads[1])
    else:
        x = F.pad(x, (pads[1], pads[3], pads[0], pads[2]))
        padding = (0, 0)
    bias = ins[2] if len(ins) > 2 else None
    return F.conv2d(x, w, bias, stride=strides, padding=padding, groups=groups)


def _constant(node: OnnxNode) -> np.ndarray:
    # torch's legacy exporter (dynamo=False) emits Clip bounds and scalar
    # multipliers as Constant nodes rather than initializers, under any of
    # the value_* attribute spellings
    a = node.attrs
    if "value" in a:
        return np.asarray(a["value"])
    if "value_float" in a:
        return np.asarray(a["value_float"], dtype=np.float32)
    if "value_int" in a:
        return np.asarray(a["value_int"], dtype=np.int64)
    if "value_floats" in a:
        return np.asarray(a["value_floats"], dtype=np.float32)
    if "value_ints" in a:
        return np.asarray(a["value_ints"], dtype=np.int64)
    raise NotImplementedError(
        "onnx_runtime_lite: Constant node "
        f"{node.outputs[0]!r} has no supported value attribute "
        f"(attrs: {sorted(a)})"
    )


def _tensor(arr, device: torch.device) -> torch.Tensor:
    t = arr if isinstance(arr, torch.Tensor) else torch.from_numpy(np.array(arr))
    if t.is_floating_point():
        t = t.float()
    return t.to(device)


@torch.inference_mode()
def run_graph(
    graph: OnnxGraph,
    feeds: Dict[str, Union[np.ndarray, torch.Tensor]],
    device: Union[str, torch.device] = "cuda:0",
) -> Dict[str, torch.Tensor]:
    """Evaluate the graph on NCHW float inputs on `device` (f32, TF32 off);
    returns the graph outputs as tensors on `device`."""
    device = torch.device(device)
    env: Dict[str, torch.Tensor] = {
        k: _tensor(v, device) for k, v in graph.initializers.items()
    }
    env.update({k: _tensor(v, device) for k, v in feeds.items()})

    with true_f32():
        for node in graph.nodes:
            a = node.attrs
            ins = [env[i] for i in node.inputs]
            op = node.op_type
            if op == "Conv":
                out = _conv(ins, a)
            elif op == "LeakyRelu":
                out = F.leaky_relu(ins[0], float(a.get("alpha", 0.01)))
            elif op == "Relu":
                out = torch.relu(ins[0])
            elif op == "Concat":
                out = torch.cat(ins, dim=int(a.get("axis", 0)))
            elif op == "Mul":
                out = ins[0] * ins[1]
            elif op == "Add":
                out = ins[0] + ins[1]
            elif op == "DepthToSpace":
                out = _depth_to_space(ins[0], int(a["blocksize"]), a.get("mode", "DCR"))
            elif op == "Constant":
                out = _tensor(_constant(node), device)
            elif op == "Clip":
                lo = float(ins[1].reshape(-1)[0]) if len(ins) > 1 else float(a.get("min", -np.inf))
                hi = float(ins[2].reshape(-1)[0]) if len(ins) > 2 else float(a.get("max", np.inf))
                out = torch.clamp(ins[0], lo, hi)
            else:
                raise NotImplementedError(f"onnx_runtime_lite: unsupported op {op!r}")
            env[node.outputs[0]] = out

    return {o: env[o] for o in graph.outputs}
