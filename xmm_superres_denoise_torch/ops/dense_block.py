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

What bounds the block and what the kernel's design does about it are in the
note at the top of `csrc/dense_block.cu`. The library is built at first use
with `nvcc` for `sm_90a` into `build/torch_kernels/` under the checkout,
keyed by a hash of the source and flags, and loaded with `ctypes`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

Tensor = torch.Tensor

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "dense_block.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
BUILD_TIMEOUT_S = 300

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_OUT_CHANNELS_PER_BLOCK = 32  # CO in the kernel source (a multiple of its CK)
_MAX_GRID_Z = 65535

_lib: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(nvcc).exists():
        raise RuntimeError("nvcc not found: the dense-block kernel cannot be built")
    return nvcc


def build(build_dir: Path = BUILD_DIR) -> Tuple[Path, str, float]:
    """Compile the kernel library (or find it already built).

    Returns (library path, compiler output with the `-Xptxas -v` report,
    seconds spent). The output file name carries a hash of the source and
    flags; the library is written under a temporary name and renamed into
    place, so an interrupted build leaves nothing that a later one trusts.
    """
    src = SOURCE.read_bytes()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    build_dir = Path(build_dir)
    lib_path = build_dir / f"libdense_block_{key}.so"
    log_path = lib_path.with_suffix(".log")
    if lib_path.exists():
        return lib_path, log_path.read_text() if log_path.exists() else "", 0.0
    build_dir.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=build_dir)
    os.close(fd)
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(SOURCE)],
            capture_output=True, text=True, timeout=BUILD_TIMEOUT_S,
        )
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
        log_path.write_text(log)
        os.replace(tmp, lib_path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib_path, log, time.perf_counter() - t0


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        path, _, _ = build()
        lib = ctypes.CDLL(str(path))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.dense_block_level.argtypes = [
            i, i, p, i, i, i, i, i, p, p, i, p, i, i, p,
        ]
        lib.dense_block_level.restype = i
        lib.dense_block_error_string.argtypes = [i]
        lib.dense_block_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


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
    lib = _library()
    b, h, w, c = x.shape
    buf = torch.empty((b, h, w, 5 * c), dtype=x.dtype, device=x.device)
    buf[..., :c] = x
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    code = _DTYPE_CODE[x.dtype]
    device = x.device.index if x.device.index is not None else torch.cuda.current_device()
    for k in range(1, 6):
        last = k == 5
        dst = out.data_ptr() if last else buf[..., k * c :].data_ptr()
        err = lib.dense_block_level(
            device, code, buf.data_ptr(), b, h, w, 5 * c, k * c,
            weights[2 * (k - 1)].data_ptr(), weights[2 * (k - 1) + 1].data_ptr(),
            c, dst, c if last else 5 * c, int(last), stream,
        )
        if err != 0:
            msg = lib.dense_block_error_string(err).decode()
            raise RuntimeError(f"dense_block level {k} launch failed: {msg} ({err})")
        dense_block.launches += 1
    return out


dense_block.launches = 0
