"""The RRDB residual dense block on a hand-written Hopper kernel.

Replaces the Pallas TPU kernel
`ops/pallas_rrdb.py::dense_block_pallas` of the JAX package: one
`ResidualDenseBlock5C` forward, NHWC input, HWIO weights, f32 accumulation,
output `0.2 * x5 + x`.

* `dense_block(x, w1, b1, ..., w5, b5)` is the entry point. For a CUDA
  tensor it launches the kernel of `csrc/dense_block.cu` (five launches,
  one per level, over one NHWC concat buffer) or raises; there is no
  fallback. For a CPU tensor it runs the plain version.
* `dense_block_reference` is the plain version of the same function
  (`F.conv2d` + cat + LeakyReLU), used on the CPU and as the kernel's
  yardstick on the card.
* `dense_block.launches` counts kernel launches (five per call on the card).
* `launch_levels` is the five-launch loop over one concat buffer, shared
  with K1 (`ops/dense_block_s2d.py`, whose f32 levels are this kernel's).
* Drivers, the counterparts of `ops/pallas_rrdb.py:194-324`: `rrdb_fused`
  (JAX `rrdb_pallas`), `rrdb_params_from_flax` and `make_fast_rrdb_forward`,
  which runs the trunk on this kernel in the space-to-depth domain;
  `rrdb_chain` is the RRDB loop they share with `ops/s2d_forward.py`.

What bounds the block and what the kernel's design does about it are in the
note at the top of `csrc/dense_block.cu`. The library is built at first use
(`ops/cuda_build.py`: `nvcc` for `sm_90a` into `build/torch_kernels/`) and
loaded with `ctypes`.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from . import cuda_build

Tensor = torch.Tensor

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_OUT_CHANNELS_PER_BLOCK = 32  # CO in the kernel source (a multiple of its CK)
_MAX_GRID_Z = 65535
_SIGNATURES = {
    "dense_block_level": [cuda_build.I, cuda_build.I, cuda_build.P, *[cuda_build.I] * 5,
                          cuda_build.P, cuda_build.P, cuda_build.I, cuda_build.P,
                          cuda_build.I, cuda_build.I, cuda_build.P],
}


def _check_args(x: Tensor, weights) -> None:
    """Raise on anything the kernel does not take."""
    if x.dim() != 4:
        raise ValueError(f"dense_block expects NHWC (B, H, W, C), got {tuple(x.shape)}")
    b, h, w, c = x.shape
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"dense_block kernel takes float32 or bfloat16, got {x.dtype}")
    if c % _OUT_CHANNELS_PER_BLOCK:
        raise ValueError(f"dense_block kernel needs C % 32 == 0, got C={c}")
    if b * (c // _OUT_CHANNELS_PER_BLOCK) > _MAX_GRID_Z or b * h * w == 0:
        raise ValueError(f"dense_block kernel cannot take shape {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("dense_block kernel needs a contiguous NHWC input")
    for k in range(1, 6):
        wk, bk = weights[2 * (k - 1)], weights[2 * (k - 1) + 1]
        if tuple(wk.shape) != (3, 3, k * c, c) or tuple(bk.shape) != (c,):
            raise ValueError(
                f"level {k}: expected w (3, 3, {k * c}, {c}) and b ({c},), got "
                f"{tuple(wk.shape)} and {tuple(bk.shape)}"
            )
        for t in (wk, bk):
            if t.device != x.device or t.dtype != x.dtype or not t.is_contiguous():
                raise ValueError(
                    f"level {k}: weights must be contiguous {x.dtype} on {x.device}"
                )


def dense_block_reference(
    x: Tensor,
    w1: Tensor, b1: Tensor,
    w2: Tensor, b2: Tensor,
    w3: Tensor, b3: Tensor,
    w4: Tensor, b4: Tensor,
    w5: Tensor, b5: Tensor,
) -> Tensor:
    """Plain PyTorch version of the block: NHWC in and out, HWIO weights.

    Each level convolves the concat in f32 and rounds its output to the
    input's dtype, as the kernel does (so in bf16 both accumulate in f32 and
    store bf16 activations)."""
    dtype = x.dtype
    feats = [x.permute(0, 3, 1, 2)]
    pairs = ((w1, b1), (w2, b2), (w3, b3), (w4, b4), (w5, b5))
    y = None
    for level, (w, b) in enumerate(pairs, start=1):
        cat = torch.cat(feats, dim=1).float()
        y = F.conv2d(cat, w.float().permute(3, 2, 0, 1), b.float(), padding=1)
        if level < 5:
            feats.append(F.leaky_relu(y, 0.2).to(dtype))
    out = y * 0.2 + feats[0].float()
    return out.to(dtype).permute(0, 2, 3, 1)


def dense_block(
    x: Tensor,
    w1: Tensor, b1: Tensor,
    w2: Tensor, b2: Tensor,
    w3: Tensor, b3: Tensor,
    w4: Tensor, b4: Tensor,
    w5: Tensor, b5: Tensor,
) -> Tensor:
    """One ResidualDenseBlock5C forward (SAME padding), NHWC, HWIO weights.

    A CUDA input runs the hand-written kernel (or raises); a CPU input runs
    `dense_block_reference`."""
    weights = (w1, b1, w2, b2, w3, b3, w4, b4, w5, b5)
    if x.device.type == "cpu":
        return dense_block_reference(x, *weights)
    if x.device.type != "cuda":
        raise ValueError(f"dense_block runs on cuda or cpu, got {x.device}")
    _check_args(x, weights)
    lib, level = level_kernel(x.dtype)
    return launch_levels(x, weights[0::2], weights[1::2], lib, "dense_block", level, dense_block)


def level_kernel(dtype: torch.dtype):
    """(library, level launcher) of this kernel for `dtype`, built at first
    use; the launcher takes `launch_levels`'s `level` arguments."""
    lib = cuda_build.library("dense_block", _SIGNATURES)
    code = _DTYPE_CODE[dtype]
    return lib, lambda device, *args: lib.dense_block_level(device, code, *args)


def launch_levels(x: Tensor, weights, biases, lib, lib_name: str, level, counter) -> Tensor:
    """The five level launches of one block, shared by K2 and K1.

    One NHWC concat buffer (B, H, W, 5C) holds x in channels [0, C); level
    k < 5 writes channels [kC, (k+1)C), level 5 the output. `level(device,
    buf, B, H, W, buf_stride, cin, w, bias, C, dst, dst_stride, residual,
    stream)` launches one level of `lib` (named `lib_name`) and returns its
    cudaError_t; `weights[k-1]` is in the layout that level reads.
    `counter.launches` goes up by one per launch."""
    b, h, w, c = x.shape
    buf = torch.empty((b, h, w, 5 * c), dtype=x.dtype, device=x.device)
    buf[..., :c] = x
    out = torch.empty_like(x)
    stream = cuda_build.stream_of(x)
    device = cuda_build.device_index(x)
    for k in range(1, 6):
        last = k == 5
        dst = out.data_ptr() if last else buf[..., k * c :].data_ptr()
        err = level(
            device, buf.data_ptr(), b, h, w, 5 * c, k * c, weights[k - 1].data_ptr(),
            biases[k - 1].data_ptr(), c, dst, c if last else 5 * c, int(last), stream,
        )
        cuda_build.check(lib, lib_name, err, f"{counter.__name__} level {k}")
        counter.launches += 1
    return out


dense_block.launches = 0


# --------------------------------------------------------------------------
# Drivers: the RRDB on K2, and the fast forward with the trunk in the S2D
# domain
# --------------------------------------------------------------------------


def rrdb_chain(x: Tensor, rrdbs, block) -> Tensor:
    """RRDBs in sequence: each runs `block(t, params)` over the params of
    its three dense blocks, then out * 0.2 + its input (the scalar in
    `x.dtype`, as JAX rounds it)."""
    from .precision import scalar_like

    t = x
    for rrdb in rrdbs:
        block_in = t
        for params in rrdb:
            t = block(t, params)
        t = t * scalar_like(t, 0.2) + block_in
    return t


def rrdb_fused(x: Tensor, block_params) -> Tensor:
    """One RRDB through three `dense_block` calls: out * 0.2 + x.

    block_params: three dense blocks, each five (w, b) pairs (HWIO)."""
    return rrdb_chain(
        x, [block_params],
        lambda t, pairs: dense_block(t.contiguous(), *[a for pair in pairs for a in pair]),
    )


def rrdb_params_from_flax(params, n_blocks: int):
    """[[(w, b) x 5] x 3] per RRDB, as f32 CPU tensors (HWIO), from the Flax
    tree of a generator (any source `utils.weights.flax_tree` takes)."""
    from ..utils.weights import flax_tree

    trunk = flax_tree(params)["trunk"]
    out = []
    for i in range(n_blocks):
        rrdb = trunk[f"rrdb_{i}"]
        out.append([
            [
                (torch.from_numpy(rrdb[f"RDB{k}"][f"conv{j}"]["kernel"]),
                 torch.from_numpy(rrdb[f"RDB{k}"][f"conv{j}"]["bias"]))
                for j in range(1, 6)
            ]
            for k in (1, 2, 3)
        ])
    return out


def make_fast_rrdb_forward(model, params, dtype=torch.bfloat16, device="cuda:0"):
    """A forward for `GeneratorRRDB_SR`/`_DN` with the trunk's dense blocks
    on K2 in the 2x2 space-to-depth domain (C = 4 * num_filters = 128 at
    esr_gen width), equal to clip(model(x), 0, 1) up to dtype.

    `params` is the Flax-layout tree (any source `utils.weights.flax_tree`
    takes, a state_dict included); the S2D weights are transformed in f32
    numpy and only then cast to `dtype` (`s2d_forward._transform_trunk`).
    conv_first, trunk_conv and the head stay cuDNN convolutions at full
    resolution. f32 runs with TF32 off. The JAX version's `tile` and
    `interpret` arguments choose the TPU kernel's tiling and its interpreter
    and have no counterpart here."""
    from ..models.rrdb import GeneratorRRDB_SR, conv3x3_nhwc, pixel_shuffle
    from ..utils.weights import flax_tree
    from .precision import lrelu
    from .s2d_forward import _maybe_true_f32, _transform_trunk
    from .space_to_depth import d2s, s2d

    p = flax_tree(params)
    trunk = p["trunk"]
    blocks = [
        [[t for pair in rdb for t in pair] for rdb in rrdb]
        for rrdb in _transform_trunk(trunk, model.trunk.num_res_blocks, dtype, device)["blocks"]
    ]

    def conv_w(node):  # HWIO -> OIHW, once
        w = np.ascontiguousarray(node["kernel"].transpose(3, 2, 0, 1))
        return torch.from_numpy(w).to(device, dtype), torch.from_numpy(node["bias"]).to(device, dtype)

    first, tconv, last = conv_w(trunk["conv_first"]), conv_w(trunk["trunk_conv"]), conv_w(p["conv_last"])
    is_sr = isinstance(model, GeneratorRRDB_SR)
    if is_sr:
        ups = [conv_w(p[f"upconv_{i}"]) for i in range(model.num_upsample)]
        hr = conv_w(p["HRconv"])

    def forward(x: Tensor) -> Tensor:
        x = x.to(dtype)
        fea = conv3x3_nhwc(x, *first)
        t = rrdb_chain(s2d(fea).contiguous(), blocks, lambda t, flat: dense_block(t, *flat))
        fea = fea + conv3x3_nhwc(d2s(t), *tconv)
        if is_sr:
            for up in ups:
                fea = pixel_shuffle(lrelu(conv3x3_nhwc(fea, *up), 0.01), 2)
            out = conv3x3_nhwc(lrelu(conv3x3_nhwc(fea, *hr), 0.2), *last)
        else:
            out = conv3x3_nhwc(fea, *last) + x
        return torch.clamp(out, 0.0, 1.0)

    return _maybe_true_f32(forward, dtype)
