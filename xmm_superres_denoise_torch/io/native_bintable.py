"""Native-or-fallback binary-table reads (ctypes over native/fits_reader.cc).

The port of the JAX package's `io/native_bintable.py`. The event-list load
is the dominant host cost of the SAS-free obsid chain: a multi-million-row
EVENTS extension decoded column by column. The C reader (built at first use
by `data/native_loader.get_lib`) walks the HDUs once and extracts all
requested columns in one multithreaded pass with byteswap, writing
native-endian arrays straight into numpy-owned buffers. Any failure (no
toolchain, unsupported TFORM, malformed file) returns None and callers fall
back to `io.fits.read_bintable`: a choice of host-side reader, as in the JAX
package; the device path does not depend on it.
"""

from __future__ import annotations

import ctypes
import io as _io
from pathlib import Path
from typing import Dict, List, Optional, Tuple, Union

import numpy as np

from ..data.native_loader import get_lib
from .fits import Header, _read_header, read_bintable

# TFORM letter -> native-endian numpy dtype written by xmmsr_bt_read_cols
_LETTER_DTYPE = {
    ord("B"): np.dtype(np.uint8),
    ord("L"): np.dtype(np.uint8),
    ord("A"): np.dtype(np.uint8),
    ord("I"): np.dtype(np.int16),
    ord("J"): np.dtype(np.int32),
    ord("K"): np.dtype(np.int64),
    ord("E"): np.dtype(np.float32),
    ord("D"): np.dtype(np.float64),
}

_bound = False


def _bind(lib) -> None:
    """Declare the bintable entry points once per process."""
    global _bound
    if _bound:
        return
    lib.xmmsr_bt_open.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
    lib.xmmsr_bt_open.restype = ctypes.c_void_p
    lib.xmmsr_bt_nrows.argtypes = [ctypes.c_void_p]
    lib.xmmsr_bt_nrows.restype = ctypes.c_long
    lib.xmmsr_bt_header.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_long,
    ]
    lib.xmmsr_bt_header.restype = ctypes.c_long
    lib.xmmsr_bt_col_info.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_long),
    ]
    lib.xmmsr_bt_col_info.restype = ctypes.c_int
    lib.xmmsr_bt_read_cols.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
        ctypes.POINTER(ctypes.c_void_p), ctypes.c_int,
    ]
    lib.xmmsr_bt_read_cols.restype = ctypes.c_int
    lib.xmmsr_bt_close.argtypes = [ctypes.c_void_p]
    lib.xmmsr_bt_close.restype = None
    _bound = True


def read_bintable_native(
    path: Union[str, Path],
    columns: List[str],
    extname: Optional[str] = None,
    n_threads: int = 8,
) -> Optional[Tuple[Dict[str, np.ndarray], Header]]:
    """Requested columns + parsed header, or None when the native path
    cannot serve this file (caller falls back).

    Semantics match io.fits.read_bintable for the served subset: columns
    absent from the table are silently omitted (load_event_list treats
    PATTERN/FLAG/X/Y as optional); values are identical, dtypes are the
    native-endian equivalents of the big-endian on-disk types.
    """
    lib = get_lib()
    if lib is None:
        return None
    _bind(lib)

    h = lib.xmmsr_bt_open(
        str(path).encode(), (extname or "").encode()
    )
    if not h:
        return None
    try:
        nrows = lib.xmmsr_bt_nrows(h)

        present: List[Tuple[str, np.dtype, int, int]] = []
        for name in columns:
            letter = ctypes.c_int()
            repeat = ctypes.c_long()
            rc = lib.xmmsr_bt_col_info(
                h, name.encode(), ctypes.byref(letter), ctypes.byref(repeat)
            )
            if rc == -1:
                continue  # absent column: same as the Python reader
            dt = _LETTER_DTYPE.get(letter.value)
            if rc != 0 or dt is None:
                return None  # bit arrays etc.: let the fallback decide
            present.append((name, dt, int(repeat.value), letter.value))

        out: Dict[str, np.ndarray] = {}
        bufs = []
        for name, dt, repeat, _ in present:
            arr = np.empty(
                (nrows, repeat) if repeat > 1 else nrows, dt
            )
            out[name] = arr
            bufs.append(arr)
        if present:
            names_arr = (ctypes.c_char_p * len(present))(
                *[n.encode() for n, _, _, _ in present]
            )
            outs_arr = (ctypes.c_void_p * len(present))(
                *[b.ctypes.data_as(ctypes.c_void_p).value for b in bufs]
            )
            rc = lib.xmmsr_bt_read_cols(
                h, names_arr, len(present), outs_arr, n_threads
            )
            if rc != 0:
                return None
            # 'A' (character) columns: match the pure-Python reader's
            # S{repeat} strings of shape (nrows,), not raw uint8 bytes
            for name, _, repeat, letter in present:
                if letter == ord("A"):
                    out[name] = np.ascontiguousarray(
                        out[name]
                    ).view(f"S{repeat}").reshape(nrows)

        hlen = lib.xmmsr_bt_header(h, None, 0)
        hbuf = ctypes.create_string_buffer(hlen)
        lib.xmmsr_bt_header(h, hbuf, hlen)
        header = _read_header(_io.BytesIO(hbuf.raw))
        return out, header
    finally:
        lib.xmmsr_bt_close(h)


def read_bintable_fast(
    path: Union[str, Path],
    columns: List[str],
    extname: Optional[str] = None,
) -> Tuple[Dict[str, np.ndarray], Header]:
    """Native bintable read with transparent fallback to the pure-Python
    reader — the drop-in used by the event pipeline's hot load."""
    res = read_bintable_native(path, columns, extname=extname)
    if res is not None:
        return res
    return read_bintable(path, columns=columns, extname=extname)
