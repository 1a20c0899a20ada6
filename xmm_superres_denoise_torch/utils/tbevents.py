"""Dependency-free TensorBoard scalar event writer.

The port's copy of the JAX package's framework-free `utils/tbevents.py`
(copied, not imported: the port imports nothing of the JAX package). The
reference's Lightning Trainer logs scalars through its default
TensorBoardLogger; this writes the same event files without the
tensorboard package: TFRecord-framed protobuf `Event` messages.

Format facts (stable across TB versions):

* TFRecord frame: u64le(len) + u32le(maskedcrc(len bytes)) + payload +
  u32le(maskedcrc(payload)); crc is CRC-32C (Castagnoli), masked as
  ((crc >> 15 | crc << 17) + 0xa282ead8) mod 2^32.
* `Event` proto: 1=double wall_time, 2=int64 step, 3=string file_version
  (first record: "brain.Event:2"), 5=Summary.
* `Summary` proto: repeated 1=Value; `Value`: 1=string tag,
  2=float simple_value.
* TensorBoard discovers files whose basename contains "tfevents".

The trainer (`train/loop.py: Trainer._append_history`) writes every
numeric epoch metric as a scalar at step=epoch under `<run>/tb/`.
"""

from __future__ import annotations

import socket
import struct
import time
from pathlib import Path
from typing import Optional

# ---------------------------------------------------------------------- #
# CRC-32C (Castagnoli), software table; check value crc32c(b"123456789")
# == 0xE3069283 (pinned in tests).

_CRC_TABLE = []


def _build_table() -> None:
    poly = 0x82F63B78  # reflected 0x1EDC6F41
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ poly if c & 1 else c >> 1
        _CRC_TABLE.append(c)


_build_table()


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ---------------------------------------------------------------------- #
# Minimal protobuf wire encoding: varint keys, length-delimited
# submessages.


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _ld(field: int, payload: bytes) -> bytes:  # length-delimited
    return _key(field, 2) + _varint(len(payload)) + payload


def _double(field: int, v: float) -> bytes:
    return _key(field, 1) + struct.pack("<d", v)


def _float(field: int, v: float) -> bytes:
    return _key(field, 5) + struct.pack("<f", v)


def _int64(field: int, v: int) -> bytes:
    return _key(field, 0) + _varint(v & 0xFFFFFFFFFFFFFFFF)


def encode_scalar_event(
    tag: str, value: float, step: int, wall_time: Optional[float] = None
) -> bytes:
    """One `Event{wall_time, step, summary{value{tag, simple_value}}}`."""
    val = _ld(1, tag.encode("utf-8")) + _float(2, float(value))
    summary = _ld(1, val)
    return (
        _double(1, time.time() if wall_time is None else wall_time)
        + _int64(2, int(step))
        + _ld(5, summary)
    )


def encode_file_version_event(wall_time: Optional[float] = None) -> bytes:
    return (
        _double(1, time.time() if wall_time is None else wall_time)
        + _ld(3, b"brain.Event:2")
    )


def frame_record(payload: bytes) -> bytes:
    """TFRecord framing: len + crc(len) + payload + crc(payload)."""
    header = struct.pack("<Q", len(payload))
    return (
        header
        + struct.pack("<I", _masked_crc(header))
        + payload
        + struct.pack("<I", _masked_crc(payload))
    )


class TBEventWriter:
    """Append-mode scalar event file under `logdir`.

    File naming follows the TB discovery convention
    (`events.out.tfevents.<ts>.<host>`); one writer per run directory.
    """

    def __init__(self, logdir: Path):
        self.logdir = Path(logdir)
        self.logdir.mkdir(parents=True, exist_ok=True)
        name = f"events.out.tfevents.{int(time.time())}.{socket.gethostname()}"
        self.path = self.logdir / name
        self._f = open(self.path, "ab")
        if self._f.tell() == 0:
            self._f.write(frame_record(encode_file_version_event()))
            self._f.flush()

    def add_scalar(
        self, tag: str, value: float, step: int,
        wall_time: Optional[float] = None,
    ) -> None:
        self._f.write(
            frame_record(encode_scalar_event(tag, value, step, wall_time))
        )

    def add_scalars(self, scalars: dict, step: int) -> None:
        now = time.time()
        for tag, value in scalars.items():
            self.add_scalar(tag, value, step, wall_time=now)
        self.flush()

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        try:
            self._f.flush()
        finally:
            self._f.close()


# ---------------------------------------------------------------------- #
# Reader (used by tests; also handy for inspecting runs without TB).


def read_scalar_events(path: Path):
    """Parse a scalar event file back into [(wall_time, step, tag, value)].

    Validates the TFRecord CRCs; raises ValueError on corruption.
    """
    out = []
    data = Path(path).read_bytes()
    pos = 0
    while pos < len(data):
        if pos + 12 > len(data):
            raise ValueError("truncated record header")
        (length,) = struct.unpack_from("<Q", data, pos)
        (hcrc,) = struct.unpack_from("<I", data, pos + 8)
        if _masked_crc(data[pos : pos + 8]) != hcrc:
            raise ValueError("header crc mismatch")
        payload = data[pos + 12 : pos + 12 + length]
        if len(payload) != length:
            raise ValueError("truncated payload")
        (pcrc,) = struct.unpack_from("<I", data, pos + 12 + length)
        if _masked_crc(payload) != pcrc:
            raise ValueError("payload crc mismatch")
        pos += 12 + length + 4
        out.extend(_decode_event(payload))
    return out


def _read_varint(data: bytes, pos: int):
    result = 0
    shift = 0
    while True:
        b = data[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _fields(data: bytes):
    pos = 0
    while pos < len(data):
        key, pos = _read_varint(data, pos)
        field, wire = key >> 3, key & 7
        if wire == 0:
            val, pos = _read_varint(data, pos)
        elif wire == 1:
            val = data[pos : pos + 8]
            pos += 8
        elif wire == 2:
            n, pos = _read_varint(data, pos)
            val = data[pos : pos + n]
            pos += n
        elif wire == 5:
            val = data[pos : pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, val


def _decode_event(payload: bytes):
    wall_time = 0.0
    step = 0
    scalars = []
    for field, wire, val in _fields(payload):
        if field == 1 and wire == 1:
            (wall_time,) = struct.unpack("<d", val)
        elif field == 2 and wire == 0:
            step = val
        elif field == 5 and wire == 2:  # Summary
            for f2, w2, v2 in _fields(val):
                if f2 == 1 and w2 == 2:  # Value
                    tag, value = None, None
                    for f3, w3, v3 in _fields(v2):
                        if f3 == 1 and w3 == 2:
                            tag = v3.decode("utf-8")
                        elif f3 == 2 and w3 == 5:
                            (value,) = struct.unpack("<f", v3)
                    if tag is not None and value is not None:
                        scalars.append((wall_time, step, tag, value))
    return scalars
