"""Build and load the port's hand-written CUDA kernels.

Each kernel library is one source `csrc/<name>.cu` (which may include the
`csrc/*.cuh` headers) with a plain C interface. `build(name)` compiles it
with `nvcc` for `sm_90a` into `BUILD_DIR` (`build/torch_kernels/` under a
writable checkout, the user's cache directory for an installed package:
`utils/jitcache.py`), keyed by a hash of the sources and flags;
`library(name, signatures)` loads it once with `ctypes`; `check` turns a
nonzero cudaError_t returned by a launch into an exception. Nothing is
built when a module is imported: the first launch on a card builds, and
the CPU never does.
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
from typing import Dict, Sequence, Tuple

from ..utils.jitcache import default_cache_dir

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = default_cache_dir()
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
BUILD_TIMEOUT_S = 300
LIBRARIES = ("dense_block", "dense_block_s2d", "int8_gemm", "conv_i8", "window_attention",
             "mlp_block", "mdta_gram", "window_qkv")

P, I, F32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(nvcc).exists():
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return nvcc


def build(name: str, build_dir: Path = BUILD_DIR) -> Tuple[Path, str, float]:
    """Compile `csrc/<name>.cu` (or find it already built).

    Returns (library path, compiler output with the `-Xptxas -v` report,
    seconds spent). The file name carries a hash of the source, the headers
    and the flags; the library is written under a temporary name and
    renamed into place, so an interrupted build leaves nothing that a later
    one trusts. Builds of different libraries may run at the same time."""
    source = CSRC / f"{name}.cu"
    digest = hashlib.sha256(source.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    build_dir = Path(build_dir)
    lib_path = build_dir / f"lib{name}_{digest.hexdigest()[:16]}.so"
    log_path = lib_path.with_suffix(".log")
    if lib_path.exists():
        return lib_path, log_path.read_text() if log_path.exists() else "", 0.0
    build_dir.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=build_dir)
    os.close(fd)
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(source)],
            capture_output=True, text=True, timeout=BUILD_TIMEOUT_S,
        )
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {source.name} ({proc.returncode}):\n{log}")
        log_path.write_text(log)
        os.replace(tmp, lib_path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib_path, log, time.perf_counter() - t0


def library(name: str, signatures: Dict[str, Sequence]) -> ctypes.CDLL:
    """The built library `name`, loaded once; `signatures` maps each entry
    point to its ctypes argument types (all return an int error code)."""
    lib = _loaded.get(name)
    if lib is None:
        path, _, _ = build(name)
        lib = ctypes.CDLL(str(path))
        for fn, argtypes in signatures.items():
            getattr(lib, fn).argtypes = list(argtypes)
            getattr(lib, fn).restype = I
        err_fn = getattr(lib, f"{name}_error_string")
        err_fn.argtypes = [I]
        err_fn.restype = ctypes.c_char_p
        _loaded[name] = lib
    return lib


def check(lib: ctypes.CDLL, name: str, err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if err != 0:
        msg = getattr(lib, f"{name}_error_string")(err).decode()
        raise RuntimeError(f"{what} launch failed: {msg} ({err})")


def device_index(t) -> int:
    """The CUDA device index of tensor `t`."""
    import torch

    return t.device.index if t.device.index is not None else torch.cuda.current_device()


def stream_of(t) -> int:
    """The current CUDA stream of `t`'s device, as an int for ctypes: the
    raw handle, read without making a `torch.cuda.Stream` object (a host
    cost that a launch of a few microseconds notices)."""
    import torch

    return torch._C._cuda_getCurrentRawStream(device_index(t))
