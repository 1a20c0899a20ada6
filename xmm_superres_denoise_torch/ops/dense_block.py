"""The RRDB residual dense block on a hand-written Hopper kernel.

Replaces the Pallas TPU kernel
`ops/pallas_rrdb.py::dense_block_pallas` of the JAX package: one
`ResidualDenseBlock5C` forward, NHWC input, HWIO weights, f32 accumulation,
output `0.2 * x5 + x`.

* `dense_block(x, w1, b1, ..., w5, b5)` or `dense_block(x, packed)` is the
  entry point. For a CUDA tensor it launches the kernel of
  `csrc/dense_block.cu` (five launches, one per level, over one NHWC concat
  buffer) or raises; there is no fallback. When autograd must see the block
  (grad enabled and `x` or a weight requires grad) a CUDA call goes through
  `_DenseBlockFn`, whose forward is the same launches and whose backward
  recomputes the block through the plain version (see its docstring). bf16 levels run on the tensor
  cores and read the weights packed as (9, C, k*C); f32 levels run on the
  CUDA cores (`csrc/conv3x3_f32.cuh`, FFMA only: TF32 would leave the f32
  parity class) and read HWIO. Both copy weights in 16-byte pieces, so
  weights off a 16-byte boundary are refused. For a CPU tensor it runs the
  plain version.
* `pack_weights` casts and lays a block's weights out once (`PackedBlock`),
  for a caller that runs the block many times: the model's
  `ResidualDenseBlock5C` keeps its pack, `make_fast_rrdb_forward` and the
  S2D forwards pack when they are built. Ten raw tensors are packed on
  every call.
* `dense_block_reference` is the plain version of the same function
  (`F.conv2d` + cat + LeakyReLU), used on the CPU and as the kernel's
  yardstick on the card.
* `dense_block.launches` counts kernel launches (five per call on the card).
* `launch_levels` is the five-launch loop over one concat buffer, and
  `check_packed` the check of a packed block, both shared with K1
  (`ops/dense_block_s2d.py`, whose f32 levels are this kernel's and whose
  bf16 levels are the same tensor-core level).
* Drivers, the counterparts of `ops/pallas_rrdb.py:194-324`: `rrdb_fused`
  (JAX `rrdb_pallas`), `rrdb_params_from_flax` and `make_fast_rrdb_forward`,
  which runs the trunk on this kernel in the space-to-depth domain;
  `rrdb_chain` is the RRDB loop they share with `ops/s2d_forward.py`.
  `rrdb_fused` and the fast forward serve inference only and raise
  (`refuse_grad`) when a gradient is asked of them.

What bounds the block and what the kernel's design does about it are in the
note at the top of `csrc/dense_block.cu`. The library is built at first use
(`ops/cuda_build.py`: `nvcc` for `sm_90a` into `build/torch_kernels/`) and
loaded with `ctypes`.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from . import cuda_build
from .precision import true_f32

Tensor = torch.Tensor

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_OUT_CHANNELS_PER_BLOCK = 32  # channels of the narrowest bf16 block (its grid z is B * C / 32)
_MAX_GRID_Z = 65535
_SIGNATURES = {
    "dense_block_level": [cuda_build.I, cuda_build.I, cuda_build.P, *[cuda_build.I] * 5,
                          cuda_build.P, cuda_build.P, cuda_build.I, cuda_build.P,
                          cuda_build.I, cuda_build.I, cuda_build.P],
}


class PackedBlock(NamedTuple):
    """The weights of one block, cast and laid out once."""

    hwio: Tuple[Tensor, ...]  # w_k (3, 3, k*C, C), for the plain version
    biases: Tuple[Tensor, ...]  # b_k (C,)
    kernel: Tuple[Tensor, ...]  # what the kernel reads: bf16 (9, C, k*C), f32 HWIO


def pack_weights(
    weights: Sequence[Tensor], biases: Sequence[Tensor], dtype: torch.dtype
) -> PackedBlock:
    """Cast the block's weights and biases to `dtype` and lay them out for
    the kernel, on the weights' device: bf16 as (9, C, k*C), the K-major
    order of the tensor cores' B operand; any other dtype as HWIO."""
    hwio = tuple(w.to(dtype).contiguous() for w in weights)
    bs = tuple(b.to(dtype).contiguous() for b in biases)
    if dtype == torch.bfloat16:
        kernel = tuple(
            w.reshape(9, w.shape[2], w.shape[3]).transpose(1, 2).contiguous() for w in hwio
        )
    else:
        kernel = hwio
    return PackedBlock(hwio, bs, kernel)


def _check_input(x: Tensor, name: str, multiple: int) -> None:
    """Raise on an input the level kernels do not take: not NHWC, not f32
    or bf16, C not a multiple of `multiple`, a bf16 grid too large (the f32
    level launches a one-dimensional persistent grid), or not
    contiguous."""
    if x.dim() != 4:
        raise ValueError(f"{name} expects NHWC (B, H, W, C), got {tuple(x.shape)}")
    b, h, w, c = x.shape
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"{name} kernel takes float32 or bfloat16, got {x.dtype}")
    if c % multiple:
        raise ValueError(f"{name} kernel needs C % {multiple} == 0, got C={c}")
    too_many = x.dtype == torch.bfloat16 and b * (c // _OUT_CHANNELS_PER_BLOCK) > _MAX_GRID_Z
    if too_many or b * h * w == 0:
        raise ValueError(f"{name} kernel cannot take shape {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} kernel needs a contiguous NHWC input")


def _check_tensors(x: Tensor, level: int, tensors) -> None:
    for t in tensors:
        if t.device != x.device or t.dtype != x.dtype or not t.is_contiguous():
            raise ValueError(f"level {level}: weights must be contiguous {x.dtype} on {x.device}")


def check_packed(x: Tensor, packed: PackedBlock, name: str = "dense_block",
                 multiple: int = _OUT_CHANNELS_PER_BLOCK) -> None:
    """Raise on anything the level kernels do not take from `x` and a
    `PackedBlock` (K2: C % 32 == 0; K1 passes its C % 128); the weights
    must also start on a 16-byte boundary."""
    _check_input(x, name, multiple)
    c = x.shape[-1]
    if len(packed.kernel) != 5 or len(packed.biases) != 5:
        raise ValueError(f"{name} takes five weights and five biases")
    for k in range(1, 6):
        wk, bk = packed.kernel[k - 1], packed.biases[k - 1]
        want = (9, c, k * c) if x.dtype == torch.bfloat16 else (3, 3, k * c, c)
        if tuple(wk.shape) != want or tuple(bk.shape) != (c,):
            raise ValueError(
                f"level {k}: expected packed w {want} and b ({c},), got "
                f"{tuple(wk.shape)} and {tuple(bk.shape)}"
            )
        _check_tensors(x, k, (wk, bk))
        # the levels copy weights in 16-byte pieces (TMA boxes in f32 and in
        # bf16 at C % 128 == 0, cp.async in bf16 at C = 32); TMA refuses an
        # unaligned base
        if wk.data_ptr() % 16:
            raise ValueError(
                f"level {k}: packed w must start on a 16-byte boundary for the kernel's "
                f"copies, got an address {wk.data_ptr() % 16} bytes past one"
            )


def _check_args(x: Tensor, weights) -> None:
    """Raise on anything the kernel does not take from `x` and ten raw
    tensors (w1, b1, ..., w5, b5), HWIO, of `x`'s dtype."""
    _check_input(x, "dense_block", _OUT_CHANNELS_PER_BLOCK)
    c = x.shape[-1]
    for k in range(1, 6):
        wk, bk = weights[2 * (k - 1)], weights[2 * (k - 1) + 1]
        if tuple(wk.shape) != (3, 3, k * c, c) or tuple(bk.shape) != (c,):
            raise ValueError(
                f"level {k}: expected w (3, 3, {k * c}, {c}) and b ({c},), got "
                f"{tuple(wk.shape)} and {tuple(bk.shape)}"
            )
        _check_tensors(x, k, (wk, bk))


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


def grad_needed(*tensors) -> bool:
    """Whether autograd records a function of `tensors` here: grad mode is
    on and one of them requires grad."""
    return torch.is_grad_enabled() and any(
        isinstance(t, Tensor) and t.requires_grad for t in tensors)


def refuse_grad(name: str, *tensors) -> None:
    """Raise where an inference-only kernel would be asked for a gradient:
    its output would carry no `grad_fn`, and a loss through it would
    silently leave the parameters before it without a gradient."""
    if grad_needed(*tensors):
        raise RuntimeError(
            f"{name} serves inference only and has no backward: run it under "
            "torch.no_grad() or torch.inference_mode(), or differentiate the model's own "
            "forward (its dense blocks run K2 through dense_block's autograd route)"
        )


def _launch(x: Tensor, packed: PackedBlock) -> Tensor:
    check_packed(x, packed)  # f32 packs keep the caller's tensors: their alignment too
    lib, level = level_kernel(x.dtype)
    return launch_levels(x, packed.kernel, packed.biases, lib, "dense_block", level, dense_block)


class _DenseBlockFn(torch.autograd.Function):
    """The block as one autograd node: forward on K2, backward recomputed.

    `apply(x, w1, b1, ..., w5, b5)` takes the ten raw parameters (HWIO, of
    `x`'s dtype), so that autograd sees them. The forward packs them
    (`pack_weights`) and launches K2's five levels on a CUDA input (the
    plain version on a CPU one); it keeps only `x` and the parameters. The
    backward runs the block again through `dense_block_reference` on
    detached copies (cuDNN convolutions on the card, under `true_f32` in
    f32 so that TF32 cannot enter) and returns `torch.autograd.grad` of it.

    The JAX package differentiates Flax convolutions through the whole
    model and has no backward kernel to port (no backward Pallas kernel and
    no `custom_vjp`), so the backward is the plain composition's autograd.
    Recomputing the block instead of storing its four intermediate
    activations is per-block activation checkpointing: a step holds one
    (B, H, W, C) input per block, not its (B, H, W, 5C) concat."""

    @staticmethod
    def forward(ctx, x: Tensor, *weights: Tensor) -> Tensor:
        ctx.save_for_backward(x, *weights)
        if x.device.type == "cpu":
            return dense_block_reference(x, *weights)
        _check_args(x, weights)
        return _launch(x, pack_weights(weights[0::2], weights[1::2], x.dtype))

    @staticmethod
    def backward(ctx, grad_out: Tensor):
        x, *weights = ctx.saved_tensors
        needs = ctx.needs_input_grad
        inputs = [t.detach().requires_grad_(need) for t, need in zip((x, *weights), needs)]
        precision = true_f32() if x.dtype == torch.float32 else contextlib.nullcontext()
        with torch.enable_grad(), precision:
            y = dense_block_reference(*inputs)
            wanted = [t for t, need in zip(inputs, needs) if need]
            grads = iter(torch.autograd.grad(y, wanted, grad_out))
        return tuple(next(grads) if need else None for need in needs)


def dense_block(x: Tensor, *weights) -> Tensor:
    """One ResidualDenseBlock5C forward (SAME padding), NHWC.

    `weights` is ten tensors (w1, b1, ..., w5, b5), HWIO, or one
    `PackedBlock` of `x`'s dtype. A CUDA input runs the hand-written kernel
    (or raises): through `_DenseBlockFn` when autograd must see the block
    (`grad_needed` of `x` and the weights; a pack's tensors stand for the
    weights then), straight otherwise. A CPU input runs
    `dense_block_reference`."""
    packed = weights[0] if len(weights) == 1 and isinstance(weights[0], PackedBlock) else None
    if packed is None and len(weights) != 10:
        raise TypeError("dense_block takes ten weight tensors or one PackedBlock")
    raw = weights if packed is None else [t for pair in zip(packed.hwio, packed.biases) for t in pair]
    if x.device.type == "cpu":
        return dense_block_reference(x, *raw)
    if x.device.type != "cuda":
        raise ValueError(f"dense_block runs on cuda or cpu, got {x.device}")
    if grad_needed(x, *raw):
        return _DenseBlockFn.apply(x, *raw)
    if packed is None:
        _check_args(x, weights)
        packed = pack_weights(weights[0::2], weights[1::2], x.dtype)
    return _launch(x, packed)


def level_kernel(dtype: torch.dtype):
    """(library, level launcher) of this kernel for `dtype`, built at first
    use; the launcher takes `launch_levels`'s `level` arguments, with the
    weights in `pack_weights`'s kernel layout for `dtype`."""
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

    block_params: three dense blocks, each five (w, b) pairs (HWIO).
    Inference only: raises when a gradient is asked of it."""
    refuse_grad("rrdb_fused", x, *[a for rdb in block_params for pair in rdb for a in pair])
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
    numpy and only then cast to `dtype` (`s2d_forward._transform_trunk`),
    and each dense block is packed once, here. conv_first, trunk_conv and
    the head stay cuDNN convolutions at full resolution. f32 runs with TF32
    off. Inference only: the forward raises when a gradient is asked of it
    (`refuse_grad`). The JAX version's `tile` and `interpret` arguments choose the TPU
    kernel's tiling and its interpreter and have no counterpart here."""
    from ..models.rrdb import GeneratorRRDB_SR, conv3x3_nhwc, pixel_shuffle
    from ..utils.weights import flax_tree
    from .precision import lrelu
    from .s2d_forward import _maybe_true_f32, _transform_trunk
    from .space_to_depth import d2s, s2d

    p = flax_tree(params)
    trunk = p["trunk"]
    blocks = [
        [pack_weights([w for w, _ in rdb], [b for _, b in rdb], dtype) for rdb in rrdb]
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
        refuse_grad("make_fast_rrdb_forward's forward", x)
        x = x.to(dtype)
        fea = conv3x3_nhwc(x, *first)
        t = rrdb_chain(s2d(fea).contiguous(), blocks, dense_block)
        fea = fea + conv3x3_nhwc(d2s(t), *tconv)
        if is_sr:
            for up in ups:
                fea = pixel_shuffle(lrelu(conv3x3_nhwc(fea, *up), 0.01), 2)
            out = conv3x3_nhwc(lrelu(conv3x3_nhwc(fea, *hr), 0.2), *last)
        else:
            out = conv3x3_nhwc(fea, *last) + x
        return torch.clamp(out, 0.0, 1.0)

    return _maybe_true_f32(forward, dtype)
