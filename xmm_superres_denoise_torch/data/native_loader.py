"""ctypes bindings for the native FITS decoder (native/fits_reader.cc).

The port of the JAX package's `data/native_loader.py`. The training loop's
host side (per-sample gunzip + FITS decode) runs in C with a pthread batch
pool, in place of the reference's 12 DataLoader worker processes.

The library is compiled with g++ at first use from the shared, unchanged
`native/fits_reader.cc` into the gitignored `build/native/` of the checkout
(not next to the source, where the JAX package builds its own copy): it is
written under a temporary name and renamed into place, so two processes
(two test workers, or the two packages) never load a half-written file.
Every entry point falls back to the Python reader (`io/fits.py`) when the
toolchain or the build is unavailable: a choice of host-side reader, as in
the JAX package; the device path does not depend on it.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

log = logging.getLogger("xmmsr")

_ROOT = Path(__file__).resolve().parents[2]
_SRC = _ROOT / "native" / "fits_reader.cc"
BUILD_DIR = _ROOT / "build" / "native"
_LIB = BUILD_DIR / "libxmmsr_fits.so"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _build() -> bool:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = ["g++", "-O2", "-shared", "-fPIC", "-o", tmp, str(_SRC), "-lz", "-lpthread"]
    try:
        proc = subprocess.run(cmd, capture_output=True, timeout=120)
        if proc.returncode != 0:
            log.debug("native FITS build failed: %s", proc.stderr.decode())
            return False
        os.replace(tmp, _LIB)
        return True
    except (OSError, subprocess.TimeoutExpired) as e:
        log.debug("native FITS build failed to launch: %s", e)
        return False
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def get_lib() -> Optional[ctypes.CDLL]:
    """The bound library, building it on first use; None when unavailable."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not _SRC.exists():
            return None
        if not _LIB.exists() or _LIB.stat().st_mtime < _SRC.stat().st_mtime:
            if not _build():
                return None
        try:
            lib = ctypes.CDLL(str(_LIB))
        except OSError as e:
            log.debug("native FITS dlopen failed: %s", e)
            return None
        lib.xmmsr_fits_dims.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_long),
            ctypes.POINTER(ctypes.c_long),
        ]
        lib.xmmsr_fits_dims.restype = ctypes.c_int
        lib.xmmsr_fits_read.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_long,
            ctypes.POINTER(ctypes.c_long),
            ctypes.POINTER(ctypes.c_long),
        ]
        lib.xmmsr_fits_read.restype = ctypes.c_int
        lib.xmmsr_fits_read_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.c_long,
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_long,
            ctypes.c_int,
        ]
        lib.xmmsr_fits_read_batch.restype = ctypes.c_int
        _lib = lib
        log.info("native FITS decoder loaded (%s)", _LIB)
        return _lib


def native_available() -> bool:
    return get_lib() is not None


def read_image_native(path: Path) -> Optional[np.ndarray]:
    """Primary-HDU image as float32 (H, W); None if the native path fails.

    One decode in the common case: a dims query costs a full gunzip too
    (the C reader inflates before parsing), so the image is decoded straight
    into a buffer sized for the largest standard product (864^2 covers 832^2
    and the native 411x403); only a larger image pays a second, exactly
    sized decode (the reader reports dims even on the too-small rc)."""
    lib = get_lib()
    if lib is None:
        return None
    h = ctypes.c_long()
    w = ctypes.c_long()
    p = str(path).encode()
    buf = np.empty(864 * 864, np.float32)
    rc = lib.xmmsr_fits_read(
        p,
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        buf.size,
        ctypes.byref(h),
        ctypes.byref(w),
    )
    if rc == -4:  # larger than the guess: dims are set, retry exact
        buf = np.empty(h.value * w.value, np.float32)
        rc = lib.xmmsr_fits_read(
            p,
            buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            buf.size,
            ctypes.byref(h),
            ctypes.byref(w),
        )
        if rc != 0:
            return None
        return buf.reshape(h.value, w.value)
    if rc != 0:
        return None
    return buf[: h.value * w.value].reshape(h.value, w.value).copy()


def read_batch_native(
    paths: Sequence[Path], shape_hw, n_threads: int = 8
) -> Optional[np.ndarray]:
    """Decode same-shape images in parallel -> (N, H, W) float32; None on failure."""
    lib = get_lib()
    if lib is None or not paths:
        return None
    h, w = shape_hw
    out = np.empty((len(paths), h, w), np.float32)
    arr = (ctypes.c_char_p * len(paths))(*[str(p).encode() for p in paths])
    rc = lib.xmmsr_fits_read_batch(
        arr,
        len(paths),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        h * w,
        n_threads,
    )
    return out if rc == 0 else None


def load_fits(path: Path) -> np.ndarray:
    """The Python reader: primary-HDU image as float32, (1, H, W)."""
    from ..io.fits import read_image

    img, _ = read_image(path)
    return np.ascontiguousarray(img, dtype=np.float32)[None, ...]


def load_fits_fast(path: Path) -> np.ndarray:
    """Native-or-Python read of a primary-HDU image -> (1, H, W) float32."""
    img = read_image_native(path)
    if img is not None:
        return img[None, ...]
    return load_fits(path)
