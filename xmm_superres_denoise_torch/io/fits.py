"""Minimal, dependency-free FITS image reader/writer (numpy only).

The port's own copy of the image half of the JAX package's codec
(its `io/fits.py`): primary image HDUs, optional gzip,
BSCALE/BZERO scaling, header cards with the long-string convention.
Binary tables (event lists) are not part of the serving path and are not
copied yet.

* 2880-byte header blocks of 80-char ASCII cards, ``END`` terminated.
* Big-endian data, BITPIX in {8, 16, 32, 64, -32, -64}.
* ``BSCALE``/``BZERO`` linear scaling (used by XMM uint16-as-int16 images).
* Transparent ``.gz`` handling by magic bytes.

Everything returns plain numpy; device placement happens downstream.
"""

from __future__ import annotations

import gzip
import io as _io
import re
from pathlib import Path
from typing import Any, Dict, Iterator, List, Optional, Tuple, Union

import numpy as np

# gzip level for FITS writes: 1 (fastest); decoders are level-agnostic.
_GZIP_LEVEL = 1

BLOCK = 2880
CARD = 80

_BITPIX_DTYPE = {
    8: np.dtype(">u1"),
    16: np.dtype(">i2"),
    32: np.dtype(">i4"),
    64: np.dtype(">i8"),
    -32: np.dtype(">f4"),
    -64: np.dtype(">f8"),
}

_NUM_RE = re.compile(r"^[+-]?(\d+\.?\d*|\.\d+)([eEdD][+-]?\d+)?$")


class Header(dict):
    """An ordered FITS header: dict of KEY -> value, plus per-key comments."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.comments: Dict[str, str] = {}

    def set(self, key: str, value: Any, comment: str = "") -> None:
        self[key] = value
        if comment:
            self.comments[key] = comment


def _parse_value(raw: str) -> Any:
    raw = raw.strip()
    if raw == "":
        return None
    if raw.startswith("'"):
        # String value: quotes doubled inside. Find closing quote.
        out = []
        i = 1
        while i < len(raw):
            if raw[i] == "'":
                if i + 1 < len(raw) and raw[i + 1] == "'":
                    out.append("'")
                    i += 2
                    continue
                break
            out.append(raw[i])
            i += 1
        return "".join(out).rstrip()
    if raw == "T":
        return True
    if raw == "F":
        return False
    if _NUM_RE.match(raw):
        low = raw.lower().replace("d", "e")
        if "." in low or "e" in low:
            return float(low)
        return int(raw)
    return raw


def _split_card(card: str) -> Tuple[str, str, str]:
    """Return (key, raw_value, comment) for one 80-char card."""
    key = card[:8].strip()
    rest = card[8:]
    if not rest.startswith("= "):
        return key, "", rest.strip()
    body = rest[2:]
    # Comment starts at first '/' outside a quoted string.
    in_str = False
    i = 0
    while i < len(body):
        c = body[i]
        if c == "'":
            if in_str and i + 1 < len(body) and body[i + 1] == "'":
                i += 2
                continue
            in_str = not in_str
        elif c == "/" and not in_str:
            return key, body[:i], body[i + 1 :].strip()
        i += 1
    return key, body, ""


def _read_header(stream) -> Header:
    hdr = Header()
    last_key: Optional[str] = None
    while True:
        block = stream.read(BLOCK)
        if len(block) < BLOCK:
            raise ValueError("Truncated FITS header")
        text = block.decode("ascii", "replace")
        for off in range(0, BLOCK, CARD):
            card = text[off : off + CARD]
            key, raw, comment = _split_card(card)
            if key == "END":
                return hdr
            if key in ("COMMENT", "HISTORY", ""):
                continue
            if key == "CONTINUE":
                # Long-string convention: previous value ended with '&'.
                if last_key is not None and isinstance(hdr.get(last_key), str):
                    prev = hdr[last_key]
                    if prev.endswith("&"):
                        prev = prev[:-1]
                    cont = _parse_value(raw if raw else comment)
                    if isinstance(cont, str):
                        hdr[last_key] = prev + cont
                continue
            value = _parse_value(raw)
            hdr[key] = value
            if comment:
                hdr.comments[key] = comment
            last_key = key


def _data_nbytes(hdr: Header) -> int:
    naxis = int(hdr.get("NAXIS", 0))
    if naxis == 0:
        return 0
    n = abs(int(hdr["BITPIX"])) // 8
    for i in range(1, naxis + 1):
        n *= int(hdr[f"NAXIS{i}"])
    n *= int(hdr.get("GCOUNT", 1))
    # PCOUNT: heap bytes of table extensions.
    n += int(hdr.get("PCOUNT", 0))
    return n


def _padded(n: int) -> int:
    return ((n + BLOCK - 1) // BLOCK) * BLOCK


def _open_stream(path_or_bytes: Union[str, Path, bytes]):
    if isinstance(path_or_bytes, bytes):
        raw = path_or_bytes
    else:
        raw = Path(path_or_bytes).read_bytes()
    if raw[:2] == b"\x1f\x8b":
        raw = gzip.decompress(raw)
    return _io.BytesIO(raw)


def _iter_hdus(stream) -> Iterator[Tuple[Header, bytes]]:
    while True:
        pos = stream.tell()
        probe = stream.read(CARD)
        if len(probe) < CARD:
            return
        stream.seek(pos)
        hdr = _read_header(stream)
        nbytes = _data_nbytes(hdr)
        data = stream.read(_padded(nbytes))[:nbytes]
        yield hdr, data


def read_hdus(path: Union[str, Path, bytes]) -> List[Tuple[Header, bytes]]:
    return list(_iter_hdus(_open_stream(path)))


def read_header(path: Union[str, Path, bytes], hdu: int = 0) -> Header:
    """Header of one HDU without decoding (or, for hdu=0, even reading)
    the data — shape/exposure probes over many files (e.g. serve_files'
    geometry grouping) skip the full gunzip+parse this way."""
    stream = _open_stream(path)
    for i in range(hdu + 1):
        hdr = _read_header(stream)
        if i == hdu:
            return hdr
        stream.read(_padded(_data_nbytes(hdr)))
    raise ValueError(f"HDU {hdu} not found")


def _image_from(hdr: Header, raw: bytes) -> np.ndarray:
    bitpix = int(hdr["BITPIX"])
    dtype = _BITPIX_DTYPE[bitpix]
    naxis = int(hdr["NAXIS"])
    shape = tuple(int(hdr[f"NAXIS{i}"]) for i in range(naxis, 0, -1))
    arr = np.frombuffer(raw, dtype=dtype).reshape(shape)
    bscale = hdr.get("BSCALE", 1)
    bzero = hdr.get("BZERO", 0)
    if bscale != 1 or bzero != 0:
        nbits = 8 * arr.dtype.itemsize
        if arr.dtype.kind == "i" and bscale == 1 and bzero == 1 << (nbits - 1):
            # FITS unsigned-integer convention (stored = value - 2^(n-1)):
            # recover exactly in the matching unsigned dtype. The generic
            # `arr + bzero` would raise OverflowError under NumPy 2 (the
            # python int doesn't fit the array dtype) — this is how real
            # XMM uint16-as-int16 products are encoded.
            udt = np.dtype(f"u{arr.dtype.itemsize}").newbyteorder(
                arr.dtype.byteorder
            )
            u = arr.view(udt)
            arr = u + np.asarray(bzero, udt)  # wraps mod 2^n -> value
        else:
            arr = arr * np.float64(bscale) + np.float64(bzero)
    return arr


def read_image(path: Union[str, Path, bytes], hdu: int = 0) -> Tuple[np.ndarray, Header]:
    """Read an image HDU (data, header). hdu=0 is the primary HDU."""
    hdus = read_hdus(path)
    hdr, raw = hdus[hdu]
    return _image_from(hdr, raw), hdr


# ---------------------------------------------------------------------------
# Writing
# ---------------------------------------------------------------------------


def _split_escaped(s: str, width: int) -> list:
    """Chunk a quote-escaped string without splitting an escaped '' pair."""
    chunks = []
    while s:
        c = s[:width]
        if len(s) > width:
            trailing = len(c) - len(c.rstrip("'"))
            if trailing % 2 == 1:  # would split an escaped quote pair
                c = c[:-1]
        chunks.append(c)
        s = s[len(c):]
    return chunks


def _format_card(key: str, value: Any, comment: str = "") -> str:
    """One FITS card — or SEVERAL concatenated 80-char cards when needed:
    COMMENT/HISTORY become commentary cards (no '=', wrapped every 72
    chars) and over-long strings use the OGIP long-string convention
    ('...&' + CONTINUE cards, which `_read_header` parses), so no value is
    truncated and every string card keeps its closing quote."""
    if key.upper() in ("COMMENT", "HISTORY"):
        text = str(value) or " "
        w = CARD - 8
        return "".join(
            f"{key:<8}{text[i:i + w]}".ljust(CARD)
            for i in range(0, len(text), w)
        )
    if isinstance(value, bool):
        body = f"{'T' if value else 'F':>20}"
    elif isinstance(value, (int, np.integer)):
        body = f"{int(value):>20}"
    elif isinstance(value, (float, np.floating)):
        body = f"{float(value):>20.14G}"
    elif value is None:
        body = " " * 20
    else:
        s = str(value).replace("'", "''")
        one = f"{key:<8}= '{s:<8}'" + (f" / {comment}" if comment else "")
        if len(one) <= CARD:
            return one.ljust(CARD)
        # long-string convention: each chunk ends with '&' except the last
        chunks = _split_escaped(s, CARD - 13)  # "KEY...= '" + "&'" margin
        cards = []
        for i, c in enumerate(chunks):
            lead = f"{key:<8}= " if i == 0 else "CONTINUE  "
            amp = "&" if i < len(chunks) - 1 else ""
            cards.append(f"{lead}'{c}{amp}'".ljust(CARD))
        if comment and len(cards[-1].rstrip()) + 3 + len(comment) <= CARD:
            cards[-1] = (
                f"{cards[-1].rstrip()} / {comment}".ljust(CARD)
            )
        return "".join(cards)
    card = f"{key:<8}= {body}"
    if comment:
        card = f"{card} / {comment}"
    return card[:CARD].ljust(CARD)


def write_image(
    path: Union[str, Path],
    data: np.ndarray,
    header: Optional[Dict[str, Any]] = None,
    overwrite: bool = True,
    compress: Optional[bool] = None,
) -> Path:
    """Write a 2-D (or N-D) numpy array as a primary-HDU FITS file.

    ``.gz`` suffix (or compress=True) gzip-compresses the output, matching the
    reference's `.fits.gz` products (`utils/filehandling.py:116-120`).
    """
    path = Path(path)
    if path.exists() and not overwrite:
        raise FileExistsError(path)

    data = np.asarray(data)
    out_bzero = 0
    if data.dtype == np.float64:
        bitpix = -64
    elif data.dtype.kind == "f":
        data = data.astype(np.float32)
        bitpix = -32
    elif data.dtype.kind == "u":
        # unsigned: promote one signed width up so large values survive
        # (uint16 49k would wrap in int16; FITS integers are signed).
        # uint64 has no wider signed type: use the FITS unsigned convention
        # (BZERO = 2^63, stored = value - 2^63) so values >= 2^63 survive.
        if data.dtype.itemsize <= 1:
            data, bitpix = data.astype(np.int16), 16
        elif data.dtype.itemsize <= 2:
            data, bitpix = data.astype(np.int32), 32
        elif data.dtype.itemsize <= 4:
            data, bitpix = data.astype(np.int64), 64
        else:
            data = (data.astype(np.uint64) ^ np.uint64(1 << 63)).view(np.int64)
            bitpix, out_bzero = 64, 1 << 63
    elif data.dtype.itemsize <= 2:
        data = data.astype(np.int16)
        bitpix = 16
    elif data.dtype.itemsize <= 4:
        data = data.astype(np.int32)
        bitpix = 32
    else:
        data = data.astype(np.int64)
        bitpix = 64

    cards = [
        _format_card("SIMPLE", True, "conforms to FITS standard"),
        _format_card("BITPIX", bitpix, "array data type"),
        _format_card("NAXIS", data.ndim, "number of array dimensions"),
    ]
    for i, n in enumerate(reversed(data.shape), start=1):
        cards.append(_format_card(f"NAXIS{i}", n))
    if header:
        comments = getattr(header, "comments", {})
        for k, v in header.items():
            ku = str(k).upper()[:8]
            if ku in ("SIMPLE", "BITPIX", "NAXIS") or ku.startswith("NAXIS"):
                continue
            if ku in ("BSCALE", "BZERO"):
                # `data` holds physical values; a scaling card inherited from
                # a source header would be applied AGAIN on the next read.
                continue
            if ku in ("XTENSION", "PCOUNT", "GCOUNT", "TFIELDS"):
                # extension-structure cards inherited from a bintable
                # header: a nonzero PCOUNT would make this primary image
                # unreadable (data size = image + heap)
                continue
            cards.append(_format_card(ku, v, comments.get(k, "")))
    if out_bzero:
        cards.append(
            _format_card("BZERO", out_bzero, "unsigned-integer offset")
        )
    cards.append("END".ljust(CARD))

    htext = "".join(cards)
    hbytes = htext.encode("ascii")
    hbytes += b" " * (_padded(len(hbytes)) - len(hbytes))

    big = data.astype(_BITPIX_DTYPE[bitpix])
    dbytes = big.tobytes()
    dbytes += b"\x00" * (_padded(len(dbytes)) - len(dbytes))

    blob = hbytes + dbytes
    if compress is None:
        compress = path.name.endswith(".gz")
    if compress:
        blob = gzip.compress(blob, _GZIP_LEVEL)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(blob)
    return path
