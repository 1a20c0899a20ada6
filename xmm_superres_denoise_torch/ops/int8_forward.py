"""int8 (w8a8) space-to-depth serving for the RRDB generators.

The port of the JAX package's `ops/int8_forward.py`: a statically
calibrated w8a8 forward in the S2D domain, on the weight transform of
`ops/s2d_forward.py`.

* weights: symmetric per-output-channel int8;
* activations: symmetric per-tensor int8, with scales baked from a
  calibration batch run through the f32 S2D graph (max-abs, 8 % headroom);
* every int8 convolution runs on K3 (`ops/conv_i8.py`) with its epilogue
  (dequantisation, bias, LeakyReLU, the dense block's and trunk's
  residuals, requantisation) inside the kernel on the card, where XLA fuses
  it into the convolution in the JAX package: dense levels 1-4 write their
  int8 codes straight into the next level's slice of the int8 concat, and
  conv_first, level 5 of a dense block followed by another in its RRDB, and
  trunk_conv (before an int8 upconv) write the codes of their output beside
  it, as the next convolution's input. On the CPU each convolution is its
  plain version, the exact float64 convolution and the same epilogue as
  torch ops requantising through `_quantize`, with the scalars rounded to
  the epilogue dtype as JAX rounds them (`ops/precision.py: scalar_like`);
* the dense-block concat mixes levels with different activation scales;
  each input group's scale is folded into that group's weight scale so the
  int32 sum dequantises with one per-output-channel factor:
      x_j ~ x8_j * (s_j/127),  w_j ~ w8_j * q_jo,
      q_jo = 127 * c_o / s_j   =>   y ~ y32 * c_o,
      c_o = max_j (s_j * max|w_j[..., o]|) / 127^2.

The scales dict has the JAX package's keys (`conv_first`,
`b{i}d{j}l{k}j{g}`, `trunk_conv`, `__trunk_out__`, `__hrconv_in__`), so one
scales JSON serves both packages. On a card the forward's builder first runs
P (`ops/int8_gemm.py: check_int8_exact`), the check that the card's int8
tensor-core sums are exact. `params` is the Flax-layout tree (any source
`utils.weights.flax_tree` takes).
"""

from __future__ import annotations

import copy
import math
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from ..models.rrdb import GeneratorRRDB_DN, GeneratorRRDB_SR, conv3x3_nhwc
from ..utils.weights import flax_tree, params_from_flax
from .conv_i8 import Epilogue, conv_i8, pack_weights, quantize_i8
from .int8_gemm import check_int8_exact
from .precision import lrelu, scalar_like, true_f32
from .s2d_forward import _conv_ready, _maybe_true_f32, _transform_trunk, _xform
from .space_to_depth import d2s, s2d

Tensor = torch.Tensor

HEADROOM = 1.08
SCALE_FLOOR = 1e-6


# --------------------------------------------------------------------------
# calibration: the f32 S2D trunk, recording per-tensor max-abs
# --------------------------------------------------------------------------

def _conv_f32(x: Tensor, w: Tensor, b: Tensor) -> Tensor:
    """f32 SAME convolution with HWIO weights (calibration only)."""
    return conv3x3_nhwc(x, w.permute(3, 2, 0, 1), b)


def _calibrate_trunk(tp: Dict[str, Any], x4: Tensor):
    """The f32 S2D trunk, plain per-level convolutions, recording max|t| of
    every convolution's input (what gets quantised); keys name the consuming
    convolution. Returns (amax, trunk output)."""
    amax: Dict[str, float] = {}

    def rec(key: str, t: Tensor) -> Tensor:
        amax[key] = float(t.abs().max())
        return t

    fea = _conv_f32(rec("conv_first", x4), *tp["conv_first"])
    t = fea
    for bi, rrdb in enumerate(tp["blocks"]):
        block_in = t
        for di, rdb in enumerate(rrdb):
            x = t
            feats = [x]
            for level, (w, b) in enumerate(rdb):
                for j, f in enumerate(feats):
                    rec(f"b{bi}d{di}l{level}j{j}", f)
                h = _conv_f32(torch.cat(feats, -1) if level else x, w, b)
                if level < 4:
                    h = lrelu(h, 0.2)
                    feats.append(h)
            t = h * 0.2 + x
        t = t * 0.2 + block_in
    trunk = _conv_f32(rec("trunk_conv", t), *tp["trunk_conv"])
    out = rec("__trunk_out__", fea + trunk)
    return amax, out


def _check_model(model) -> bool:
    """True for SR (num_upsample == 1), False for DN; raise otherwise."""
    if isinstance(model, GeneratorRRDB_SR):
        if model.num_upsample != 1:
            raise ValueError(f"the int8 path is built for num_upsample == 1, got {model.num_upsample}")
        return True
    if not isinstance(model, GeneratorRRDB_DN):
        raise ValueError(f"int8 serving takes the RRDB generators, got {type(model).__name__}")
    return False


@torch.inference_mode()
def calibrate_int8_scales(model, params, calib, device="cuda:0") -> Dict[str, float]:
    """Run the f32 S2D trunk (and for SR the upconv) on a calibration batch
    (normalised NHWC) and return the per-tensor activation scales, max-abs
    times 1.08 with a floor of 1e-6, as a JSON-serialisable dict."""
    is_sr = _check_model(model)
    p = flax_tree(params)
    tp32 = _transform_trunk(p["trunk"], model.trunk.num_res_blocks, torch.float32, device)
    if not isinstance(calib, Tensor):
        calib = torch.from_numpy(np.asarray(calib, np.float32))
    x4c = s2d(calib.to(device, torch.float32))
    with true_f32():
        amax, fea = _calibrate_trunk(tp32, x4c)
        if is_sr:
            # HRconv consumes d2s(lrelu(upconv(.))): max-abs does not see the d2s
            up = lrelu(_conv_f32(fea, *_xform(p["upconv_0"], 1, torch.float32, device)), 0.01)
            amax["__hrconv_in__"] = float(up.abs().max())
    return {k: max(v * HEADROOM, SCALE_FLOOR) for k, v in amax.items()}


def check_scales(model, scales: Dict[str, float]) -> None:
    """Raise ValueError unless `scales` holds every key the model's int8
    forward needs (`__hrconv_in__` is optional: it only switches the SR head
    to int8), each a positive finite number."""
    _check_model(model)
    keys = ["conv_first", "trunk_conv", "__trunk_out__"]
    for bi in range(model.trunk.num_res_blocks):
        for di in range(3):
            for level in range(5):
                keys += [f"b{bi}d{di}l{level}j{j}" for j in range(level + 1)]
    missing = [k for k in keys if k not in scales]
    if missing:
        raise ValueError(f"int8 scales lack {len(missing)} keys, e.g. {missing[:3]}")
    bad = [k for k, v in scales.items() if not (isinstance(v, (int, float)) and math.isfinite(v) and v > 0)]
    if bad:
        raise ValueError(f"int8 scales must be positive finite numbers: {bad[:3]}")


# --------------------------------------------------------------------------
# quantisation helpers
# --------------------------------------------------------------------------

def _quant_weights_grouped(w: np.ndarray, group_scales: Sequence[float], group_size: int):
    """Quantise a (3, 3, K, Cout) kernel whose K concatenates input groups
    with activation scales s_j. Returns numpy (w8 int8, c_o float32) with
    y ~ conv_int32 * c_o (module docstring)."""
    w = np.asarray(w, np.float64)
    n_groups = w.shape[2] // group_size
    if len(group_scales) != n_groups:
        raise ValueError(f"{len(group_scales)} group scales for {n_groups} groups")
    c_o = np.zeros(w.shape[3])
    for j, s_j in enumerate(group_scales):
        wj = w[:, :, j * group_size : (j + 1) * group_size, :]
        c_o = np.maximum(c_o, float(s_j) * np.abs(wj).max(axis=(0, 1, 2)))
    c_o = np.maximum(c_o / (127.0 * 127.0), 1e-30)
    w8 = np.zeros_like(w)
    for j, s_j in enumerate(group_scales):
        sl = slice(j * group_size, (j + 1) * group_size)
        w8[:, :, sl, :] = w[:, :, sl, :] * float(s_j) / (127.0 * c_o)
    w8 = np.clip(np.rint(w8), -127, 127).astype(np.int8)
    return w8, c_o.astype(np.float32)


def _quantize(x: Tensor, scale: float) -> Tensor:
    """-> int8 with a per-tensor symmetric scale (x ~ x8 * scale / 127):
    round half to even (as `jnp.round`), clip to +-127. Every torch
    requantisation of the forward goes through this name (K3's epilogue does
    the same on the card)."""
    return quantize_i8(x, scale)


# --------------------------------------------------------------------------
# forward builder
# --------------------------------------------------------------------------

def _requantize(x: Tensor, scale: float) -> Tensor:
    """The plain epilogues' requantiser: `_quantize`, looked up when called."""
    return _quantize(x, scale)


class _QConv:
    """One quantised convolution with its epilogue: packed int8 weights
    (whole, and per input group for the concat-free form) and the
    `Epilogue` (c_o and bias in f32 on the device, the output dtype, and the
    optional LeakyReLU slope, residual scale and requantisation scale; with
    `values`, the codes are written beside the values)."""

    def __init__(self, w: np.ndarray, b: Tensor, scales: Sequence[float], group: int,
                 device, dtype, slope: Optional[float] = None,
                 res_scale: Optional[float] = None, qscale: Optional[float] = None,
                 values: bool = False, split: bool = False):
        w8, c_o = _quant_weights_grouped(w, scales, group)
        self.packed = pack_weights(w8, device)
        self.groups = [pack_weights(np.ascontiguousarray(w8[:, :, j * group : (j + 1) * group]),
                                    device) for j in range(len(scales))] if split else []
        self.epi = Epilogue(torch.from_numpy(c_o).to(device), b.to(device, torch.float32), dtype,
                            slope=slope, res_scale=res_scale, qscale=qscale, values=values,
                            quantize=_requantize)

    def __call__(self, x8: Tensor, residual: Optional[Tensor] = None,
                 out: Optional[Tensor] = None, codes: Optional[Tensor] = None):
        """The convolution and its epilogue (`conv_i8`): one K3 launch on a
        card, the plain version on the CPU."""
        return conv_i8(x8, self.packed, self.epi, residual=residual, out=out, codes=codes)


def make_int8_s2d_forward(
    model,
    params,
    calib=None,
    dtype=torch.bfloat16,
    scales: Optional[Dict[str, float]] = None,
    concat_free: bool = False,
    device="cuda:0",
):
    """A statically calibrated w8a8 S2D forward.

    model: `GeneratorRRDB_SR` (num_upsample == 1) or `GeneratorRRDB_DN`.
    calib: a representative normalised NHWC batch, used once to bake the
    activation scales, or pass `scales` (from `calibrate_int8_scales`).
    Returns forward(x) -> clip(model-equivalent output, 0, 1) in `dtype`:
    the trunk's 60 dense convolutions, conv_first, trunk_conv and (when the
    scales hold `__hrconv_in__`) the SR head's upconv and HRconv run on K3;
    epilogues in `dtype`; conv_last stays a `dtype` convolution.

    concat_free: each dense level is a sum of per-group int8 convolutions
    (one per concat input, on weight slices) instead of one convolution over
    the concat: the same int32 sums."""
    is_sr = _check_model(model)
    device = torch.device(device)
    p = flax_tree(params)
    n_blocks = model.trunk.num_res_blocks
    if scales is None:
        if calib is None:
            raise ValueError("need either a calibration batch or scales")
        scales = calibrate_int8_scales(model, params, calib, device)
    check_scales(model, scales)
    if device.type == "cuda":
        check_int8_exact(device)

    tp32 = _transform_trunk(p["trunk"], n_blocks, torch.float32)
    gsz = model.num_filters * 4  # S2D group width (128 at esr_gen width)
    quant_head = is_sr and "__hrconv_in__" in scales
    sb = [[[[scales[f"b{bi}d{di}l{level}j{j}"] for j in range(level + 1)]
            for level in range(5)] for di in range(3)] for bi in range(n_blocks)]
    w_first, b_first = tp32["conv_first"]
    # conv_first: fea, and its codes as the first dense block's input
    q_first = _QConv(w_first.numpy(), b_first, [scales["conv_first"]], w_first.shape[2], device,
                     dtype, qscale=sb[0][0][0][0], values=True)
    # trunk_conv: fea + trunk, and with an int8 head its codes as upconv's input
    q_tconv = _QConv(tp32["trunk_conv"][0].numpy(), tp32["trunk_conv"][1],
                     [scales["trunk_conv"]], gsz, device, dtype, res_scale=1.0,
                     qscale=scales["__trunk_out__"] if quant_head else None, values=True)

    def _level(bi, di, level):
        """levels 1-4: LeakyReLU(0.2), then the codes of the next level's
        input; level 5: 0.2 * y + x0, and when another dense block of the
        RRDB follows, its codes as that block's input."""
        if level < 4:
            return dict(slope=0.2, qscale=sb[bi][di][level + 1][level + 1])
        return dict(res_scale=0.2, qscale=sb[bi][di + 1][0][0] if di < 2 else None, values=True)

    q_blocks = [[[_QConv(w.numpy(), b, sb[bi][di][level], gsz, device, dtype,
                         split=concat_free, **_level(bi, di, level))
                  for level, (w, b) in enumerate(tp32["blocks"][bi][di])]
                 for di in range(3)] for bi in range(n_blocks)]

    if quant_head:
        w_up, b_up = _xform(p["upconv_0"], 1, torch.float32)
        q_up = _QConv(w_up.numpy(), b_up, [scales["__trunk_out__"]], w_up.shape[2], device,
                      dtype, slope=0.01)
        w_hr, b_hr = _xform(p["HRconv"], 1, torch.float32)
        q_hr = _QConv(w_hr.numpy(), b_hr, [scales["__hrconv_in__"]], w_hr.shape[2], device,
                      dtype, slope=0.2)
    elif is_sr:
        upconv = _conv_ready(_xform(p["upconv_0"], 1, dtype, device))
        hrconv = _conv_ready(_xform(p["HRconv"], 1, dtype, device))
    conv_last = _conv_ready(_xform(p["conv_last"], 1, dtype, device))

    def concat8(t: Tensor) -> Tensor:
        """A dense block's int8 concat, filled level by level and read in place."""
        b, h, w, _ = t.shape
        return torch.empty((b, h, w, 5 * gsz), dtype=torch.int8, device=t.device)

    def with_codes(q: _QConv, x8: Tensor, t: Tensor, **kw):
        """Run q, whose epilogue writes its values and the codes of the next
        dense block's input (t's shape): (values, that block's x8)."""
        if concat_free:
            return q(x8, **kw)
        nxt = concat8(t)
        return q(x8, codes=nxt[..., :gsz], **kw)[0], nxt

    def dense_block_i8(x0: Tensor, x8: Tensor, qb):
        """One dense block on x0, whose codes `x8` holds (concat-free: the
        codes; else the concat, with the codes in its first group). Returns
        (output, the next dense block's x8, or None at the end of the RRDB)."""
        last = qb[4].epi.qscale is None
        if concat_free:  # raw sums per group, then the epilogue as torch ops
            feats8 = [x8]
            for level, q in enumerate(qb):
                y32 = conv_i8(feats8[0], q.groups[0])
                for j in range(1, level + 1):
                    y32 = y32 + conv_i8(feats8[j], q.groups[j])
                feats8.append(q.epi.apply(y32, x0 if level == 4 else None))
            return (feats8[-1], None) if last else feats8[-1]
        for level in range(4):  # levels 1-4 write the next level's codes into the concat
            qb[level](x8[..., : (level + 1) * gsz],
                      codes=x8[..., (level + 1) * gsz : (level + 2) * gsz])
        if last:
            return qb[4](x8, residual=x0), None
        return with_codes(qb[4], x8, x0, residual=x0)

    def forward(x: Tensor) -> Tensor:
        x4 = s2d(x.to(dtype))
        fea, x8 = with_codes(q_first, _quantize(x4, scales["conv_first"]), x4)
        t = fea
        for bi in range(n_blocks):
            block_in = t
            for di in range(3):
                t, x8 = dense_block_i8(t, x8, q_blocks[bi][di])
            t = t * scalar_like(t, 0.2) + block_in
            if bi + 1 < n_blocks:  # the next RRDB's input
                x8 = _quantize(t, sb[bi + 1][0][0][0])
                if not concat_free:
                    cat8 = concat8(t)
                    cat8[..., :gsz] = x8
                    x8 = cat8
        fea = q_tconv(_quantize(t, scales["trunk_conv"]), residual=fea)
        if is_sr:
            if quant_head:
                fea, fea8 = fea
                up = q_up(fea8)
                h = q_hr(_quantize(d2s(up), scales["__hrconv_in__"]))
            else:
                up = lrelu(conv3x3_nhwc(fea, *upconv), 0.01)
                h = lrelu(conv3x3_nhwc(d2s(up), *hrconv), 0.2)
            out = conv3x3_nhwc(h, *conv_last)
        else:
            out = conv3x3_nhwc(fea, *conv_last) + x4
        return torch.clamp(d2s(out), 0.0, 1.0)

    return _maybe_true_f32(forward, dtype)


@torch.inference_mode()
def quantization_psnr(model, params, x, calib=None, device="cuda:0") -> float:
    """PSNR (dB) of the f32-epilogue int8 forward against the f32 model on x."""
    if not isinstance(x, Tensor):
        x = torch.from_numpy(np.asarray(x, np.float32))
    x = x.to(device, torch.float32)
    f8 = make_int8_s2d_forward(model, params, x if calib is None else calib,
                               dtype=torch.float32, device=device)
    y8 = f8(x).double()
    ref = copy.deepcopy(model).to(device, torch.float32)
    ref.load_state_dict(params_from_flax(flax_tree(params)))
    with true_f32():
        yf = torch.clamp(ref(x), 0.0, 1.0).double()
    mse = float(torch.mean((y8 - yf) ** 2))
    return float(10.0 * np.log10(1.0 / max(mse, 1e-12)))
