"""Canonical binary serialization (a copy of tpubft/utils/serialize.py).

The reference's rebuild of concord-bft's CMF (Concord Message Format):
messages are Python dataclasses with a field-spec table; the codec
supports fixed-width little-endian ints, bool, bytes/string
(uvarint-length-prefixed), lists, fixed lists, maps, optionals, oneof (by
message id), and nested messages. Deterministic (canonical) encoding:
maps are sorted by key. The ledger's block rows and block-updates blobs
are encoded here, so they are byte-identical to the reference's.
"""
from __future__ import annotations

import struct
from dataclasses import dataclass, fields, is_dataclass
from typing import Any, Dict, List, Optional, Tuple, Type, get_args, get_origin


class SerializeError(Exception):
    pass


# ---------------- low-level primitives ----------------

def write_uint(buf: bytearray, v: int, width: int) -> None:
    if v < 0 or v >= 1 << (8 * width):
        raise SerializeError(f"uint{8*width} out of range: {v}")
    buf += v.to_bytes(width, "little")


def read_uint(data: memoryview, off: int, width: int) -> Tuple[int, int]:
    if off + width > len(data):
        raise SerializeError("truncated uint")
    return int.from_bytes(data[off:off + width], "little"), off + width


def write_bytes(buf: bytearray, b: bytes) -> None:
    write_uvarint(buf, len(b))
    buf += b


def read_bytes(data: memoryview, off: int) -> Tuple[bytes, int]:
    n, off = read_uvarint(data, off)
    if off + n > len(data):
        raise SerializeError("truncated bytes")
    return bytes(data[off:off + n]), off + n


def write_uvarint(buf: bytearray, v: int) -> None:
    if v < 0:
        raise SerializeError("uvarint must be >= 0")
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            buf.append(b | 0x80)
        else:
            buf.append(b)
            return


def read_uvarint(data: memoryview, off: int) -> Tuple[int, int]:
    """Decode a uvarint, rejecting non-minimal (overlong) encodings and
    values >= 2^64 so every value has exactly one byte representation."""
    shift = 0
    result = 0
    while True:
        if off >= len(data) or shift > 63:
            raise SerializeError("truncated/overlong uvarint")
        b = data[off]
        off += 1
        if shift == 63 and b > 1:
            raise SerializeError("uvarint exceeds 64 bits")
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            if b == 0 and shift != 0:
                raise SerializeError("non-minimal uvarint encoding")
            return result, off
        shift += 7


# ---------------- typed field codec ----------------
# Field specs: ("u8"|"u16"|"u32"|"u64"|"bool"|"bytes"|"str"|
#               ("list", spec) | ("fixed", spec, n) | ("map", kspec, vspec) |
#               ("opt", spec) | ("msg", cls))

def encode_value(buf: bytearray, spec: Any, v: Any) -> None:
    if spec == "u8":
        write_uint(buf, v, 1)
    elif spec == "u16":
        write_uint(buf, v, 2)
    elif spec == "u32":
        write_uint(buf, v, 4)
    elif spec == "u64":
        write_uint(buf, v, 8)
    elif spec == "i64":
        if not -(1 << 63) <= v < 1 << 63:
            raise SerializeError(f"i64 out of range: {v}")
        write_uint(buf, v & 0xFFFFFFFFFFFFFFFF, 8)
    elif spec == "bool":
        buf.append(1 if v else 0)
    elif spec == "bytes":
        write_bytes(buf, v)
    elif spec == "str":
        write_bytes(buf, v.encode("utf-8"))
    elif isinstance(spec, tuple):
        tag = spec[0]
        if tag == "list":
            write_uvarint(buf, len(v))
            for item in v:
                encode_value(buf, spec[1], item)
        elif tag == "fixed":
            if len(v) != spec[2]:
                raise SerializeError(f"fixed list length {len(v)} != {spec[2]}")
            for item in v:
                encode_value(buf, spec[1], item)
        elif tag == "map":
            write_uvarint(buf, len(v))
            for k in sorted(v):
                encode_value(buf, spec[1], k)
                encode_value(buf, spec[2], v[k])
        elif tag == "pair":
            # CMF `kvpair` — ordered 2-tuple (order-preserving, unlike map)
            encode_value(buf, spec[1], v[0])
            encode_value(buf, spec[2], v[1])
        elif tag == "opt":
            if v is None:
                buf.append(0)
            else:
                buf.append(1)
                encode_value(buf, spec[1], v)
        elif tag == "msg":
            encode_msg_into(buf, v)
        else:
            raise SerializeError(f"bad spec {spec}")
    else:
        raise SerializeError(f"bad spec {spec}")


def decode_value(data: memoryview, off: int, spec: Any) -> Tuple[Any, int]:
    if spec == "u8":
        return read_uint(data, off, 1)
    if spec == "u16":
        return read_uint(data, off, 2)
    if spec == "u32":
        return read_uint(data, off, 4)
    if spec == "u64":
        return read_uint(data, off, 8)
    if spec == "i64":
        v, off = read_uint(data, off, 8)
        return v - (1 << 64) if v >= 1 << 63 else v, off
    if spec == "bool":
        v, off = read_uint(data, off, 1)
        return bool(v), off
    if spec == "bytes":
        return read_bytes(data, off)
    if spec == "str":
        b, off = read_bytes(data, off)
        return b.decode("utf-8"), off
    if isinstance(spec, tuple):
        tag = spec[0]
        if tag == "list":
            n, off = read_uvarint(data, off)
            out = []
            for _ in range(n):
                v, off = decode_value(data, off, spec[1])
                out.append(v)
            return out, off
        if tag == "fixed":
            out = []
            for _ in range(spec[2]):
                v, off = decode_value(data, off, spec[1])
                out.append(v)
            return out, off
        if tag == "map":
            n, off = read_uvarint(data, off)
            out = {}
            for _ in range(n):
                k, off = decode_value(data, off, spec[1])
                v, off = decode_value(data, off, spec[2])
                out[k] = v
            return out, off
        if tag == "pair":
            a, off = decode_value(data, off, spec[1])
            b, off = decode_value(data, off, spec[2])
            return (a, b), off
        if tag == "opt":
            flag, off = read_uint(data, off, 1)
            if not flag:
                return None, off
            return decode_value(data, off, spec[1])
        if tag == "msg":
            return decode_msg_from(data, off, spec[1])
    raise SerializeError(f"bad spec {spec}")


# ---------------- dataclass message codec ----------------
# A serializable message is a dataclass with a class attr SPEC:
#   SPEC = [("field_name", spec), ...]  in canonical field order.
#
# Hot path: the generic SPEC walk (a dict-dispatch + function call per
# field) was a top profiler entry on the consensus dispatcher, so each
# message class gets a GENERATED encoder/decoder compiled once and
# cached — fixed-width ints, bool, bytes, str and list<bytes> are
# inlined; every other spec shape falls back to the interpretive
# encode_value/decode_value (identical wire format either way, covered
# by the same round-trip tests).

_INT_WIDTH = {"u8": 1, "u16": 2, "u32": 4, "u64": 8}
_ENC_CACHE: Dict[type, Any] = {}
_DEC_CACHE: Dict[type, Any] = {}


def _compile_encoder(cls: Type):
    specs = [s for _, s in cls.SPEC]
    lines = ["def _enc(buf, msg):"]
    for i, (name, spec) in enumerate(cls.SPEC):
        v = f"_v{i}"
        lines.append(f"    {v} = msg.{name}")
        if spec in _INT_WIDTH:
            w = _INT_WIDTH[spec]
            lines += [
                f"    if {v} < 0 or {v} >= {1 << (8 * w)}:",
                f"        raise SerializeError('uint{8*w} out of range: "
                f"%r' % ({v},))",
                f"    buf += {v}.to_bytes({w}, 'little')",
            ]
        elif spec == "i64":
            lines += [
                f"    if not {-(1 << 63)} <= {v} < {1 << 63}:",
                f"        raise SerializeError('i64 out of range: "
                f"%r' % ({v},))",
                f"    buf += ({v} & {(1 << 64) - 1}).to_bytes(8, 'little')",
            ]
        elif spec == "bool":
            lines.append(f"    buf.append(1 if {v} else 0)")
        elif spec == "bytes":
            lines += [f"    write_uvarint(buf, len({v}))",
                      f"    buf += {v}"]
        elif spec == "str":
            lines += [f"    {v} = {v}.encode('utf-8')",
                      f"    write_uvarint(buf, len({v}))",
                      f"    buf += {v}"]
        elif spec == ("list", "bytes"):
            lines += [f"    write_uvarint(buf, len({v}))",
                      f"    for _it in {v}:",
                      "        write_uvarint(buf, len(_it))",
                      "        buf += _it"]
        else:
            lines.append(f"    encode_value(buf, _specs[{i}], {v})")
    lines.append("    return None")
    ns = {"_specs": specs, "encode_value": encode_value,
          "write_uvarint": write_uvarint, "SerializeError": SerializeError}
    exec("\n".join(lines), ns)  # noqa: S102 — codegen from static SPECs
    return ns["_enc"]


def _compile_decoder(cls: Type):
    specs = [s for _, s in cls.SPEC]
    names = [n for n, _ in cls.SPEC]
    lines = ["def _dec(data, off):",
             "    _n = len(data)"]
    for i, (name, spec) in enumerate(cls.SPEC):
        v = f"_v{i}"
        if spec in _INT_WIDTH:
            w = _INT_WIDTH[spec]
            lines += [
                f"    if off + {w} > _n:",
                "        raise SerializeError('truncated uint')",
                f"    {v} = int.from_bytes(data[off:off + {w}], 'little')",
                f"    off += {w}",
            ]
        elif spec == "i64":
            lines += [
                "    if off + 8 > _n:",
                "        raise SerializeError('truncated uint')",
                f"    {v} = int.from_bytes(data[off:off + 8], 'little')",
                "    off += 8",
                f"    if {v} >= {1 << 63}:",
                f"        {v} -= {1 << 64}",
            ]
        elif spec == "bool":
            lines += [
                "    if off >= _n:",
                "        raise SerializeError('truncated uint')",
                f"    {v} = bool(data[off]); off += 1",
            ]
        elif spec in ("bytes", "str"):
            lines += [
                "    _ln, off = read_uvarint(data, off)",
                "    if off + _ln > _n:",
                "        raise SerializeError('truncated bytes')",
                f"    {v} = bytes(data[off:off + _ln]); off += _ln",
            ]
            if spec == "str":
                lines.append(f"    {v} = {v}.decode('utf-8')")
        elif spec == ("list", "bytes"):
            lines += [
                "    _cnt, off = read_uvarint(data, off)",
                f"    {v} = []",
                "    for _ in range(_cnt):",
                "        _ln, off = read_uvarint(data, off)",
                "        if off + _ln > _n:",
                "            raise SerializeError('truncated bytes')",
                f"        {v}.append(bytes(data[off:off + _ln]))",
                "        off += _ln",
            ]
        else:
            lines.append(
                f"    {v}, off = decode_value(data, off, _specs[{i}])")
    kwargs = ", ".join(f"{n}={f'_v{i}'}" for i, n in enumerate(names))
    lines.append(f"    return _cls({kwargs}), off")
    ns = {"_specs": specs, "_cls": cls, "decode_value": decode_value,
          "read_uvarint": read_uvarint, "SerializeError": SerializeError}
    exec("\n".join(lines), ns)  # noqa: S102 — codegen from static SPECs
    return ns["_dec"]


def encode_msg_into(buf: bytearray, msg: Any) -> None:
    enc = _ENC_CACHE.get(type(msg))
    if enc is None:
        if not is_dataclass(msg):
            raise SerializeError(f"not a message: {msg!r}")
        enc = _ENC_CACHE[type(msg)] = _compile_encoder(type(msg))
    enc(buf, msg)


def encode_msg(msg: Any) -> bytes:
    buf = bytearray()
    encode_msg_into(buf, msg)
    return bytes(buf)


def decode_msg_from(data: memoryview, off: int, cls: Type) -> Tuple[Any, int]:
    dec = _DEC_CACHE.get(cls)
    if dec is None:
        dec = _DEC_CACHE[cls] = _compile_decoder(cls)
    return dec(data, off)


def decode_msg(data: bytes, cls: Type) -> Any:
    msg, off = decode_msg_from(memoryview(data), 0, cls)
    if off != len(data):
        raise SerializeError(f"{cls.__name__}: {len(data)-off} trailing bytes")
    return msg
