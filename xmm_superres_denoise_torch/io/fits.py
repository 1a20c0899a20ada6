"""Minimal, dependency-free FITS reader/writer (numpy only).

The port's own copy of the JAX package's codec (its `io/fits.py`): primary
image HDUs, optional gzip, BSCALE/BZERO scaling, header cards with the
long-string convention, and binary tables (the event lists, rate curves,
attitude and GTI tables of the obsid chain), read and written byte for byte
as the JAX package does.

* 2880-byte header blocks of 80-char ASCII cards, ``END`` terminated.
* Big-endian data, BITPIX in {8, 16, 32, 64, -32, -64}.
* ``BSCALE``/``BZERO`` linear scaling (used by XMM uint16-as-int16 images).
* Transparent ``.gz`` handling by magic bytes.
* Binary-table (``XTENSION='BINTABLE'``) column reads and single-table
  writes with TLMIN/TLMAX bounds.

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

# TFORM letter -> numpy big-endian dtype for binary tables.
_TFORM_DTYPE = {
    "L": np.dtype("u1"),
    "B": np.dtype("u1"),
    "I": np.dtype(">i2"),
    "J": np.dtype(">i4"),
    "K": np.dtype(">i8"),
    "E": np.dtype(">f4"),
    "D": np.dtype(">f8"),
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


def load_fits(path: Union[str, Path]) -> np.ndarray:
    """Primary-HDU image as float32 with a leading channel axis (1, H, W)."""
    img, _ = read_image(path)
    return np.ascontiguousarray(img, dtype=np.float32)[None, ...]


def read_bintable(
    path: Union[str, Path, bytes],
    columns: Optional[List[str]] = None,
    extname: Optional[str] = None,
    hdu: Optional[int] = None,
) -> Tuple[Dict[str, np.ndarray], Header]:
    """Read columns of a binary-table HDU (e.g. an XMM EVENTS extension).
    Columns absent from the table are omitted; bit columns are skipped."""
    hdus = read_hdus(path)
    target = None
    if hdu is not None:
        target = hdus[hdu]
    else:
        for h, raw in hdus[1:]:
            if h.get("XTENSION", "").strip() != "BINTABLE":
                continue
            if extname is None or h.get("EXTNAME", "").strip() == extname:
                target = (h, raw)
                break
    if target is None:
        raise ValueError(f"No BINTABLE HDU (extname={extname!r}) found")
    hdr, raw = target

    nrows = int(hdr["NAXIS2"])
    rowlen = int(hdr["NAXIS1"])
    ncols = int(hdr["TFIELDS"])

    fields = []  # (name, dtype, repeat, offset)
    offset = 0
    for i in range(1, ncols + 1):
        name = str(hdr[f"TTYPE{i}"]).strip()
        tform = str(hdr[f"TFORM{i}"]).strip()
        m = re.match(r"^(\d*)([LXBIJKAED])", tform)
        if not m:
            raise ValueError(f"Unsupported TFORM {tform!r}")
        repeat = int(m.group(1)) if m.group(1) else 1
        letter = m.group(2)
        if letter == "X":  # bit array
            fields.append((name, None, repeat, offset))
            offset += (repeat + 7) // 8
            continue
        if letter == "A":
            fields.append((name, np.dtype(f"S{repeat}"), 1, offset))
            offset += repeat
            continue
        dt = _TFORM_DTYPE[letter]
        fields.append((name, dt, repeat, offset))
        offset += dt.itemsize * repeat
    if offset != rowlen:
        raise ValueError(f"Row length mismatch: computed {offset}, NAXIS1={rowlen}")

    table_raw = np.frombuffer(raw[: nrows * rowlen], dtype=np.uint8).reshape(nrows, rowlen)
    out: Dict[str, np.ndarray] = {}
    for name, dt, repeat, off in fields:
        if columns is not None and name not in columns:
            continue
        if dt is None:
            continue  # bit columns are not needed
        width = dt.itemsize * (repeat if dt.kind != "S" else 1)
        # one strided gather and a zero-copy view (not .tobytes(), which
        # would copy the column a second time)
        col = np.ascontiguousarray(table_raw[:, off : off + width]).view(dt)
        col = col.reshape(nrows, repeat) if (repeat > 1 and dt.kind != "S") \
            else col.reshape(nrows)
        out[name] = col
    return out, hdr


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


_NP_TFORM = {
    np.dtype(np.float64): ("D", np.dtype(">f8")),
    np.dtype(np.float32): ("E", np.dtype(">f4")),
    np.dtype(np.int64): ("K", np.dtype(">i8")),
    np.dtype(np.int32): ("J", np.dtype(">i4")),
    np.dtype(np.int16): ("I", np.dtype(">i2")),
    np.dtype(np.uint8): ("B", np.dtype("u1")),
}


def write_bintable(
    path: Union[str, Path],
    columns: Dict[str, np.ndarray],
    extname: str = "EVENTS",
    header: Optional[Dict[str, Any]] = None,
    column_limits: Optional[Dict[str, Tuple[int, int]]] = None,
    primary_header: Optional[Dict[str, Any]] = None,
) -> Path:
    """Write a single-BINTABLE FITS file (primary HDU + table extension):
    scalar columns of f8/f4/i8/i4/i2/u1 (anything else as f8), EXTNAME,
    per-column TLMIN/TLMAX bounds; gzip when the name ends in `.gz`."""
    path = Path(path)
    names = list(columns)
    arrs = []
    tforms = []
    for name in names:
        a = np.asarray(columns[name])
        if a.dtype not in _NP_TFORM:
            a = a.astype(np.float64)
        letter, be = _NP_TFORM[a.dtype]
        arrs.append(np.ascontiguousarray(a.astype(be)))
        tforms.append(letter)
    nrows = len(arrs[0]) if arrs else 0
    rowlen = sum(a.dtype.itemsize for a in arrs)

    cards = [
        _format_card("SIMPLE", True),
        _format_card("BITPIX", 8),
        _format_card("NAXIS", 0),
        _format_card("EXTEND", True),
    ]
    if primary_header:
        for k, v in primary_header.items():
            cards.append(_format_card(str(k).upper()[:8], v))
    cards.append("END".ljust(CARD))
    pblock = "".join(cards).encode("ascii")
    pblock += b" " * (_padded(len(pblock)) - len(pblock))

    tcards = [
        _format_card("XTENSION", "BINTABLE"),
        _format_card("BITPIX", 8),
        _format_card("NAXIS", 2),
        _format_card("NAXIS1", rowlen),
        _format_card("NAXIS2", nrows),
        _format_card("PCOUNT", 0),
        _format_card("GCOUNT", 1),
        _format_card("TFIELDS", len(names)),
    ]
    for i, (name, tf) in enumerate(zip(names, tforms), start=1):
        tcards.append(_format_card(f"TTYPE{i}", name))
        tcards.append(_format_card(f"TFORM{i}", tf))
        if column_limits and name in column_limits:
            lo, hi = column_limits[name]
            tcards.append(_format_card(f"TLMIN{i}", int(lo)))
            tcards.append(_format_card(f"TLMAX{i}", int(hi)))
    tcards.append(_format_card("EXTNAME", extname))
    if header:
        comments = getattr(header, "comments", {})
        for k, v in header.items():
            tcards.append(_format_card(str(k).upper()[:8], v, comments.get(k, "")))
    tcards.append("END".ljust(CARD))
    tblock = "".join(tcards).encode("ascii")
    tblock += b" " * (_padded(len(tblock)) - len(tblock))

    rows = np.empty((nrows, rowlen), np.uint8)
    off = 0
    for a in arrs:
        w = a.dtype.itemsize
        rows[:, off : off + w] = a.view(np.uint8).reshape(nrows, w)
        off += w
    data = rows.tobytes()
    data += b"\x00" * (_padded(len(data)) - len(data))

    path.parent.mkdir(parents=True, exist_ok=True)
    blob = pblock + tblock + data
    if path.name.endswith(".gz"):
        blob = gzip.compress(blob, _GZIP_LEVEL)
    path.write_bytes(blob)
    return path


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
