"""TFRecord container + tf.train.Example codec, dependency-free.

The reference reads/writes TFRecords through tensorflow
(``python/ray/data/read_api.py`` ``read_tfrecords`` /
``Dataset.write_tfrecords``). tensorflow is not in this image, and the
formats are small enough to implement directly:

* TFRecord framing: ``uint64le length | uint32le masked_crc32c(length) |
  data | uint32le masked_crc32c(data)`` (masked_crc = rotr15(crc) +
  0xa282ead8).
* ``tf.train.Example`` protobuf wire format: Example{features=1} →
  Features{map<string, Feature> feature=1} → Feature{bytes_list=1 |
  float_list=2 | int64_list=3}, each a repeated ``value`` field (floats
  and ints packed).

CRC32C (Castagnoli) has no stdlib implementation; the table-driven one
below is pure Python (~1 MB/s/core) — fine for the per-file task
parallelism the readers use, and verification is optional on read.
"""

from __future__ import annotations

import struct
from typing import Any, Dict, Iterator, List, Optional

_CRC_TABLE: Optional[List[int]] = None


def _crc32c_table() -> List[int]:
    global _CRC_TABLE
    if _CRC_TABLE is None:
        poly = 0x82F63B78  # reflected Castagnoli
        table = []
        for i in range(256):
            c = i
            for _ in range(8):
                c = (c >> 1) ^ poly if c & 1 else c >> 1
            table.append(c)
        _CRC_TABLE = table
    return _CRC_TABLE


def crc32c(data: bytes) -> int:
    table = _crc32c_table()
    c = 0xFFFFFFFF
    for b in data:
        c = table[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    c = crc32c(data)
    return (((c >> 15) | (c << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def read_tfrecord_frames(path: str, *, verify: bool = False
                         ) -> Iterator[bytes]:
    """Yield the raw record payloads of one TFRecord file."""
    with open(path, "rb") as f:
        while True:
            hdr = f.read(12)
            if not hdr:
                return
            if len(hdr) < 12:
                raise ValueError(f"truncated TFRecord header in {path}")
            (length,) = struct.unpack("<Q", hdr[:8])
            if verify:
                (lcrc,) = struct.unpack("<I", hdr[8:12])
                if _masked_crc(hdr[:8]) != lcrc:
                    raise ValueError(f"length CRC mismatch in {path}")
            data = f.read(length)
            tail = f.read(4)
            if len(data) < length or len(tail) < 4:
                raise ValueError(f"truncated TFRecord body in {path}")
            if verify:
                (dcrc,) = struct.unpack("<I", tail)
                if _masked_crc(data) != dcrc:
                    raise ValueError(f"data CRC mismatch in {path}")
            yield data


def frame_tfrecord(data: bytes) -> bytes:
    """One TFRecord frame (length/CRC header + payload + payload CRC)."""
    hdr = struct.pack("<Q", len(data))
    return b"".join((hdr, struct.pack("<I", _masked_crc(hdr)), data,
                     struct.pack("<I", _masked_crc(data))))


def write_tfrecord_frames(path: str, payloads) -> int:
    """Write raw payloads as a TFRecord file; returns record count."""
    n = 0
    with open(path, "wb") as f:
        for data in payloads:
            f.write(frame_tfrecord(data))
            n += 1
    return n


# ------------------------------------------------ protobuf wire helpers

def _read_varint(buf: memoryview, pos: int):
    out = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, pos
        shift += 7


def _write_varint(out: bytearray, v: int):
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def _fields(data: memoryview) -> Iterator[tuple]:
    """Yield (field_number, wire_type, value) over one message."""
    pos = 0
    n = len(data)
    while pos < n:
        tag, pos = _read_varint(data, pos)
        field, wt = tag >> 3, tag & 7
        if wt == 0:  # varint
            v, pos = _read_varint(data, pos)
        elif wt == 1:  # fixed64
            v = bytes(data[pos:pos + 8])
            pos += 8
        elif wt == 2:  # length-delimited
            ln, pos = _read_varint(data, pos)
            v = data[pos:pos + ln]
            pos += ln
        elif wt == 5:  # fixed32
            v = bytes(data[pos:pos + 4])
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wt}")
        yield field, wt, v


def _zigzag_to_signed(v: int) -> int:
    # int64 fields are plain (not zigzag) varints in Example; handle
    # two's-complement for negatives.
    return v - (1 << 64) if v >= (1 << 63) else v


def parse_example(payload: bytes) -> Dict[str, Any]:
    """tf.train.Example bytes -> {feature_name: list | scalar}.

    Single-element lists collapse to scalars (matching the reference
    reader's default ``Dataset`` row shape for Examples)."""
    out: Dict[str, Any] = {}
    mv = memoryview(payload)
    for field, _wt, features_msg in _fields(mv):
        if field != 1:  # Example.features
            continue
        for ffield, _fwt, entry in _fields(features_msg):
            if ffield != 1:  # Features.feature map entry
                continue
            name = None
            value: Any = None
            for mfield, _mwt, mval in _fields(entry):
                if mfield == 1:
                    name = bytes(mval).decode()
                elif mfield == 2:  # Feature message
                    value = _parse_feature(mval)
            if name is not None:
                out[name] = value
    return out


def _parse_feature(msg: memoryview) -> Any:
    for field, wt, val in _fields(msg):
        if field == 1:  # BytesList
            vals = [bytes(v) for f, _w, v in _fields(val) if f == 1]
            return vals[0] if len(vals) == 1 else vals
        if field == 2:  # FloatList (packed or repeated fixed32)
            floats: List[float] = []
            for f, w, v in _fields(val):
                if f != 1:
                    continue
                if w == 2:  # packed
                    floats.extend(struct.unpack(f"<{len(v) // 4}f",
                                                bytes(v)))
                else:
                    floats.extend(struct.unpack("<f", v))
            return floats[0] if len(floats) == 1 else floats
        if field == 3:  # Int64List (packed or repeated varint)
            ints: List[int] = []
            for f, w, v in _fields(val):
                if f != 1:
                    continue
                if w == 2:  # packed varints
                    pos = 0
                    vv = memoryview(v)
                    while pos < len(vv):
                        iv, pos = _read_varint(vv, pos)
                        ints.append(_zigzag_to_signed(iv))
                else:
                    ints.append(_zigzag_to_signed(v))
            return ints[0] if len(ints) == 1 else ints
    return None


def _encode_len_delimited(out: bytearray, field: int, payload: bytes):
    _write_varint(out, (field << 3) | 2)
    _write_varint(out, len(payload))
    out.extend(payload)


def encode_example(row: Dict[str, Any]) -> bytes:
    """{name: value} -> tf.train.Example bytes. bytes/str -> BytesList,
    float -> FloatList, int/bool -> Int64List; lists/arrays of those
    likewise."""
    import numpy as np

    features = bytearray()
    for name, value in row.items():
        if isinstance(value, np.ndarray):
            value = value.tolist()
        vals = value if isinstance(value, (list, tuple)) else [value]
        feature = bytearray()
        if all(isinstance(v, (bytes, str)) for v in vals):
            blist = bytearray()
            for v in vals:
                _encode_len_delimited(
                    blist, 1, v.encode() if isinstance(v, str) else v)
            _encode_len_delimited(feature, 1, bytes(blist))
        elif all(isinstance(v, (int, np.integer, bool)) for v in vals):
            ilist = bytearray()
            packed = bytearray()
            for v in vals:
                _write_varint(packed, int(v) & ((1 << 64) - 1))
            _encode_len_delimited(ilist, 1, bytes(packed))
            _encode_len_delimited(feature, 3, bytes(ilist))
        elif all(isinstance(v, (int, float, np.integer, np.floating, bool))
                 for v in vals):
            flist = bytearray()
            packed = struct.pack(f"<{len(vals)}f",
                                 *[float(v) for v in vals])
            _encode_len_delimited(flist, 1, packed)
            _encode_len_delimited(feature, 2, bytes(flist))
        else:
            bad = next(v for v in vals
                       if not isinstance(v, (bytes, str, int, float,
                                             np.integer, np.floating,
                                             bool)))
            raise TypeError(
                f"write_tfrecords: feature {name!r} has unsupported value "
                f"type {type(bad).__name__} (tf.train.Example features "
                f"are bytes/str, int, or float lists)")
        entry = bytearray()
        _encode_len_delimited(entry, 1, name.encode())
        _encode_len_delimited(entry, 2, bytes(feature))
        _encode_len_delimited(features, 1, bytes(entry))
    example = bytearray()
    _encode_len_delimited(example, 1, bytes(features))
    return bytes(example)
