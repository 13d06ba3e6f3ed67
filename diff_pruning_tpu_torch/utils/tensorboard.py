"""Minimal TensorBoard scalar-event writer, without a tensorflow or
tensorboard dependency: the port's own copy of
``diff_pruning_tpu/utils/tensorboard.py`` (standard library only; the port
imports nothing of the JAX package).

The reference logs training scalars through accelerate's TensorBoard
tracker (ddpm_train.py:180-188,519-530; ddpm_exp/main.py:126-156). This
writes the same artifact natively: a TFRecord stream of Event protobufs
(`events.out.tfevents.*`) that TensorBoard/`tensorboard.backend` reads
directly. Only the pieces needed are implemented:

* protobuf wire encoding for Event{wall_time, step, file_version|summary}
  and Summary.Value{tag, simple_value};
* TFRecord framing: u64 length + masked CRC32C(length) + payload +
  masked CRC32C(payload), mask = rotr15(crc)+0xa282ead8.
"""

from __future__ import annotations

import os
import socket
import struct
import time
from typing import Optional

# ---- CRC32C (Castagnoli), table-driven ------------------------------------

_CRC_TABLE = []


def _crc_table():
    global _CRC_TABLE
    if _CRC_TABLE:
        return _CRC_TABLE
    poly = 0x82F63B78
    tbl = []
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ poly if c & 1 else c >> 1
        tbl.append(c)
    _CRC_TABLE = tbl
    return tbl


def crc32c(data: bytes) -> int:
    tbl = _crc_table()
    crc = 0xFFFFFFFF
    for b in data:
        crc = tbl[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ---- protobuf wire helpers -------------------------------------------------

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


def _field_varint(num: int, val: int) -> bytes:
    return _varint(num << 3) + _varint(val)


def _field_bytes(num: int, payload: bytes) -> bytes:
    return _varint((num << 3) | 2) + _varint(len(payload)) + payload


def _field_double(num: int, val: float) -> bytes:
    return _varint((num << 3) | 1) + struct.pack("<d", val)


def _field_float(num: int, val: float) -> bytes:
    return _varint((num << 3) | 5) + struct.pack("<f", val)


def _event(wall_time: float, step: Optional[int] = None,
           file_version: Optional[str] = None,
           summary: Optional[bytes] = None) -> bytes:
    msg = _field_double(1, wall_time)
    if step is not None:
        msg += _field_varint(2, step)
    if file_version is not None:
        msg += _field_bytes(3, file_version.encode())
    if summary is not None:
        msg += _field_bytes(5, summary)
    return msg


def _scalar_summary(tag: str, value: float) -> bytes:
    v = _field_bytes(1, tag.encode()) + _field_float(2, float(value))
    return _field_bytes(1, v)  # Summary.value (repeated)


# ---- writer ----------------------------------------------------------------

class SummaryWriter:
    """Scalar-only events-file writer (TensorBoard-compatible)."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        fname = f"events.out.tfevents.{int(time.time())}.{socket.gethostname()}"
        self.path = os.path.join(logdir, fname)
        self._f = open(self.path, "ab")
        self._write(_event(time.time(), file_version="brain.Event:2"))

    def _write(self, record: bytes) -> None:
        hdr = struct.pack("<Q", len(record))
        self._f.write(hdr)
        self._f.write(struct.pack("<I", _masked_crc(hdr)))
        self._f.write(record)
        self._f.write(struct.pack("<I", _masked_crc(record)))

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self._write(_event(time.time(), step=step,
                           summary=_scalar_summary(tag, value)))

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        self._f.close()


def read_scalars(path: str):
    """Parse an events file back to [(step, tag, value)] — used by tests and
    as a dependency-free inspection tool."""
    out = []
    with open(path, "rb") as f:
        data = f.read()
    off = 0
    while off < len(data):
        (ln,) = struct.unpack_from("<Q", data, off)
        hdr = data[off:off + 8]
        (hcrc,) = struct.unpack_from("<I", data, off + 8)
        if hcrc != _masked_crc(hdr):
            raise ValueError("corrupt record header")
        rec = data[off + 12:off + 12 + ln]
        (dcrc,) = struct.unpack_from("<I", data, off + 12 + ln)
        if dcrc != _masked_crc(rec):
            raise ValueError("corrupt record payload")
        off += 12 + ln + 4
        out.extend(_parse_event(rec))
    return out


def _read_varint(buf: bytes, i: int):
    n = shift = 0
    while True:
        b = buf[i]
        i += 1
        n |= (b & 0x7F) << shift
        if not b & 0x80:
            return n, i
        shift += 7


def _parse_event(buf: bytes):
    i = 0
    step = 0
    scalars = []
    while i < len(buf):
        key, i = _read_varint(buf, i)
        num, wt = key >> 3, key & 7
        if wt == 1:
            i += 8
        elif wt == 5:
            i += 4
        elif wt == 0:
            val, i = _read_varint(buf, i)
            if num == 2:
                step = val
        elif wt == 2:
            ln, i = _read_varint(buf, i)
            payload = buf[i:i + ln]
            i += ln
            if num == 5:  # summary
                j = 0
                while j < len(payload):
                    k2, j = _read_varint(payload, j)
                    if k2 >> 3 == 1 and k2 & 7 == 2:
                        vl, j = _read_varint(payload, j)
                        scalars.append(_parse_value(payload[j:j + vl], step))
                        j += vl
                    else:
                        raise ValueError("unexpected summary field")
        else:
            raise ValueError(f"wire type {wt}")
    return scalars


def _parse_value(buf: bytes, step: int):
    i = 0
    tag, val = "", 0.0
    while i < len(buf):
        key, i = _read_varint(buf, i)
        num, wt = key >> 3, key & 7
        if num == 1 and wt == 2:
            ln, i = _read_varint(buf, i)
            tag = buf[i:i + ln].decode()
            i += ln
        elif num == 2 and wt == 5:
            (val,) = struct.unpack_from("<f", buf, i)
            i += 4
        elif wt == 0:
            _, i = _read_varint(buf, i)
        elif wt == 2:
            ln, i = _read_varint(buf, i)
            i += ln
        else:
            raise ValueError(f"wire type {wt}")
    return (step, tag, val)
