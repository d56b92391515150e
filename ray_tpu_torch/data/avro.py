"""Dependency-free Avro Object Container File reader.

The reference's ``ray.data.read_avro`` (``python/ray/data/read_api.py:1492``)
delegates to pyarrow's Avro support / fastavro; neither ships in this image,
so the container format (spec 1.11.1) is decoded directly: zigzag-varint
primitives, JSON-schema-driven record decoding, ``null``/``deflate`` codecs.
Covers the types Avro files in the wild use: primitives, records, enums,
arrays, maps, unions, fixed, and nested combinations thereof.
"""

from __future__ import annotations

import io
import json
import struct
import zlib
from typing import Any, Dict, List

_MAGIC = b"Obj\x01"


class _Reader:
    def __init__(self, buf: bytes):
        self._b = buf
        self._i = 0

    def read(self, n: int) -> bytes:
        if self._i + n > len(self._b):
            raise EOFError("truncated avro data")
        out = self._b[self._i:self._i + n]
        self._i += n
        return out

    def at_end(self) -> bool:
        return self._i >= len(self._b)

    def long(self) -> int:
        # zigzag varint
        shift = 0
        acc = 0
        while True:
            byte = self.read(1)[0]
            acc |= (byte & 0x7F) << shift
            if not byte & 0x80:
                break
            shift += 7
        return (acc >> 1) ^ -(acc & 1)

    def bytes_(self) -> bytes:
        return self.read(self.long())

    def string(self) -> str:
        return self.bytes_().decode("utf-8")


def _decode(r: _Reader, schema: Any, names: Dict[str, Any]) -> Any:
    if isinstance(schema, str):
        t = schema
        if t == "null":
            return None
        if t == "boolean":
            return r.read(1)[0] != 0
        if t in ("int", "long"):
            return r.long()
        if t == "float":
            return struct.unpack("<f", r.read(4))[0]
        if t == "double":
            return struct.unpack("<d", r.read(8))[0]
        if t == "bytes":
            return r.bytes_()
        if t == "string":
            return r.string()
        if t in names:  # named-type reference
            return _decode(r, names[t], names)
        raise ValueError(f"unknown avro type {t!r}")
    if isinstance(schema, list):  # union: long index picks the branch
        return _decode(r, schema[r.long()], names)
    t = schema["type"]
    if t == "record":
        return {f["name"]: _decode(r, f["type"], names)
                for f in schema["fields"]}
    if t == "enum":
        return schema["symbols"][r.long()]
    if t == "fixed":
        return r.read(schema["size"])
    if t == "array":
        out: List[Any] = []
        while True:
            n = r.long()
            if n == 0:
                break
            if n < 0:  # negative count: a byte size follows (skippable)
                n = -n
                r.long()
            for _ in range(n):
                out.append(_decode(r, schema["items"], names))
        return out
    if t == "map":
        m: Dict[str, Any] = {}
        while True:
            n = r.long()
            if n == 0:
                break
            if n < 0:
                n = -n
                r.long()
            for _ in range(n):
                k = r.string()  # key before value (RHS-first eval order)
                m[k] = _decode(r, schema["values"], names)
        return m
    # {"type": "string", ...} style wrapping of a primitive
    return _decode(r, t, names)


def _collect_names(schema: Any, names: Dict[str, Any]):
    if isinstance(schema, dict):
        t = schema.get("type")
        if t in ("record", "enum", "fixed") and "name" in schema:
            names[schema["name"]] = schema
            ns = schema.get("namespace")
            if ns:
                names[f"{ns}.{schema['name']}"] = schema
        if t == "record":
            for f in schema.get("fields", []):
                _collect_names(f.get("type"), names)
        for key in ("items", "values"):
            if key in schema:
                _collect_names(schema[key], names)
    elif isinstance(schema, list):
        for s in schema:
            _collect_names(s, names)


def read_avro_file(path: str) -> List[dict]:
    """All records of one Avro container file as a list of row dicts
    (non-record top-level schemas come back as {"value": ...} rows)."""
    with open(path, "rb") as f:
        data = f.read()
    r = _Reader(data)
    if r.read(4) != _MAGIC:
        raise ValueError(f"{path}: not an avro container file")
    meta: Dict[str, bytes] = {}
    while True:
        n = r.long()
        if n == 0:
            break
        if n < 0:
            n = -n
            r.long()
        for _ in range(n):
            k = r.string()  # key first: RHS-first evaluation order would
            meta[k] = r.bytes_()  # otherwise read the value bytes as the key
    sync = r.read(16)
    schema = json.loads(meta["avro.schema"].decode("utf-8"))
    codec = meta.get("avro.codec", b"null").decode("ascii")
    if codec not in ("null", "deflate"):
        raise ValueError(f"{path}: unsupported avro codec {codec!r}")
    names: Dict[str, Any] = {}
    _collect_names(schema, names)
    rows: List[dict] = []
    while not r.at_end():
        count = r.long()
        size = r.long()
        payload = r.read(size)
        if codec == "deflate":
            payload = zlib.decompress(payload, -15)
        br = _Reader(payload)
        for _ in range(count):
            val = _decode(br, schema, names)
            rows.append(val if isinstance(val, dict) else {"value": val})
        if r.read(16) != sync:
            raise ValueError(f"{path}: sync marker mismatch")
    return rows


class _Writer:
    def __init__(self):
        self.buf = io.BytesIO()

    def long(self, v: int):
        v = (v << 1) ^ (v >> 63)  # zigzag
        while True:
            b = v & 0x7F
            v >>= 7
            if v:
                self.buf.write(bytes([b | 0x80]))
            else:
                self.buf.write(bytes([b]))
                break

    def bytes_(self, b: bytes):
        self.long(len(b))
        self.buf.write(b)

    def string(self, s: str):
        self.bytes_(s.encode("utf-8"))


def _union_branch(schema: List[Any], v: Any) -> int:
    """Index of the union branch whose type matches ``v`` — 'null' may
    sit at any position, and non-null values must type-match rather than
    taking the first non-null branch blindly."""
    def matches(s: Any) -> bool:
        t = s["type"] if isinstance(s, dict) else s
        if v is None:
            return t == "null"
        if isinstance(v, bool):
            return t == "boolean"
        if isinstance(v, int):
            return t in ("int", "long")
        if isinstance(v, float):
            return t in ("float", "double")
        if isinstance(v, str):
            return t in ("string", "enum")
        if isinstance(v, (bytes, bytearray)):
            return t in ("bytes", "fixed")
        if isinstance(v, dict):
            return t in ("record", "map")
        if isinstance(v, (list, tuple)):
            return t == "array"
        return False

    for i, s in enumerate(schema):
        if matches(s):
            return i
    raise ValueError(
        f"no union branch in {schema!r} matches {type(v).__name__} value")


def _encode(w: _Writer, schema: Any, v: Any):
    if isinstance(schema, str):
        t = schema
        if t == "null":
            return
        if t == "boolean":
            w.buf.write(b"\x01" if v else b"\x00")
        elif t in ("int", "long"):
            w.long(int(v))
        elif t == "float":
            w.buf.write(struct.pack("<f", float(v)))
        elif t == "double":
            w.buf.write(struct.pack("<d", float(v)))
        elif t == "bytes":
            w.bytes_(bytes(v))
        elif t == "string":
            w.string(str(v))
        else:
            raise ValueError(f"unknown avro type {t!r}")
        return
    if isinstance(schema, list):
        idx = _union_branch(schema, v)
        w.long(idx)
        _encode(w, schema[idx], v)
        return
    t = schema["type"]
    if t == "record":
        for f in schema["fields"]:
            _encode(w, f["type"], v[f["name"]])
    elif t == "array":
        if v:
            w.long(len(v))
            for item in v:
                _encode(w, schema["items"], item)
        w.long(0)
    elif t == "map":
        if v:
            w.long(len(v))
            for k, item in v.items():
                w.string(k)
                _encode(w, schema["values"], item)
        w.long(0)
    else:
        _encode(w, t, v)


def write_avro_file(path: str, rows: List[dict], schema: dict,
                    codec: str = "deflate"):
    """Write rows as one Avro container file (used by tests and as the
    inverse of ``read_avro``)."""
    sync = b"ray_tpu_avrosync"  # any 16 bytes
    head = _Writer()
    head.buf.write(_MAGIC)
    meta = {"avro.schema": json.dumps(schema).encode("utf-8"),
            "avro.codec": codec.encode("ascii")}
    head.long(len(meta))
    for k, v in meta.items():
        head.string(k)
        head.bytes_(v)
    head.long(0)
    head.buf.write(sync)

    body = _Writer()
    for row in rows:
        _encode(body, schema, row)
    payload = body.buf.getvalue()
    if codec == "deflate":
        c = zlib.compressobj(9, zlib.DEFLATED, -15)
        payload = c.compress(payload) + c.flush()
    elif codec != "null":
        raise ValueError(f"unsupported codec {codec!r}")
    head.long(len(rows))
    head.bytes_(payload)
    head.buf.write(sync)
    with open(path, "wb") as f:
        f.write(head.buf.getvalue())
