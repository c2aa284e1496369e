"""A small pure-Python msgpack codec for the checkpoint format.

Covers the subset the format uses — maps, arrays, str, bin, int, bool and
nil — and writes the same bytes as
``msgpack.packb(obj, use_bin_type=True)``: the smallest encoding of each
value.  Reading decodes str as UTF-8 and bin as ``bytes``, as
``msgpack.unpackb(data, raw=False)`` does.  Lets the port read and write
checkpoints where the ``msgpack`` package is not installed.
"""
from __future__ import annotations

import struct
from typing import Any


def packb(obj: Any) -> bytes:
    out: list[bytes] = []
    _pack(obj, out)
    return b"".join(out)


def _pack(obj: Any, out: list[bytes]) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif obj is True:
        out.append(b"\xc3")
    elif obj is False:
        out.append(b"\xc2")
    elif isinstance(obj, int):
        out.append(_pack_int(obj))
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        n = len(data)
        if n <= 31:
            out.append(bytes([0xA0 | n]))
        elif n <= 0xFF:
            out.append(b"\xd9" + struct.pack(">B", n))
        elif n <= 0xFFFF:
            out.append(b"\xda" + struct.pack(">H", n))
        else:
            out.append(b"\xdb" + struct.pack(">I", n))
        out.append(data)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        n = len(obj) if not isinstance(obj, memoryview) else obj.nbytes
        if n <= 0xFF:
            out.append(b"\xc4" + struct.pack(">B", n))
        elif n <= 0xFFFF:
            out.append(b"\xc5" + struct.pack(">H", n))
        else:
            out.append(b"\xc6" + struct.pack(">I", n))
        out.append(bytes(obj))
    elif isinstance(obj, (list, tuple)):
        n = len(obj)
        out.append(_container_header(n, 0x90, b"\xdc", b"\xdd"))
        for item in obj:
            _pack(item, out)
    elif isinstance(obj, dict):
        out.append(_container_header(len(obj), 0x80, b"\xde", b"\xdf"))
        for key, value in obj.items():
            _pack(key, out)
            _pack(value, out)
    else:
        raise TypeError(f"cannot serialize {type(obj).__name__} object")


def _container_header(n: int, fix: int, code16: bytes, code32: bytes) -> bytes:
    if n <= 15:
        return bytes([fix | n])
    if n <= 0xFFFF:
        return code16 + struct.pack(">H", n)
    return code32 + struct.pack(">I", n)


def _pack_int(n: int) -> bytes:
    if n >= 0:
        if n <= 0x7F:
            return bytes([n])
        if n <= 0xFF:
            return b"\xcc" + struct.pack(">B", n)
        if n <= 0xFFFF:
            return b"\xcd" + struct.pack(">H", n)
        if n <= 0xFFFFFFFF:
            return b"\xce" + struct.pack(">I", n)
        if n <= 0xFFFFFFFFFFFFFFFF:
            return b"\xcf" + struct.pack(">Q", n)
        raise OverflowError(f"integer {n} does not fit msgpack's uint64")
    if n >= -32:
        return struct.pack(">b", n)
    if n >= -0x80:
        return b"\xd0" + struct.pack(">b", n)
    if n >= -0x8000:
        return b"\xd1" + struct.pack(">h", n)
    if n >= -0x80000000:
        return b"\xd2" + struct.pack(">i", n)
    if n >= -0x8000000000000000:
        return b"\xd3" + struct.pack(">q", n)
    raise OverflowError(f"integer {n} does not fit msgpack's int64")


# fixed-width codes: code → (struct format, byte count)
_FIXED = {
    0xCC: (">B", 1), 0xCD: (">H", 2), 0xCE: (">I", 4), 0xCF: (">Q", 8),
    0xD0: (">b", 1), 0xD1: (">h", 2), 0xD2: (">i", 4), 0xD3: (">q", 8),
}
# length-prefixed codes: code → (kind, length format, length bytes)
_SIZED = {
    0xC4: ("bin", ">B", 1), 0xC5: ("bin", ">H", 2), 0xC6: ("bin", ">I", 4),
    0xD9: ("str", ">B", 1), 0xDA: ("str", ">H", 2), 0xDB: ("str", ">I", 4),
    0xDC: ("array", ">H", 2), 0xDD: ("array", ">I", 4),
    0xDE: ("map", ">H", 2), 0xDF: ("map", ">I", 4),
}


def unpackb(data: bytes) -> Any:
    view = memoryview(data)
    obj, pos = _unpack(view, 0)
    if pos != len(view):
        raise ValueError(f"{len(view) - pos} trailing bytes after the msgpack object")
    return obj


def _unpack(view: memoryview, pos: int) -> tuple[Any, int]:
    code = view[pos]
    pos += 1
    if code <= 0x7F:
        return code, pos
    if code >= 0xE0:
        return code - 0x100, pos
    if 0x80 <= code <= 0x8F:
        return _unpack_map(view, pos, code & 0x0F)
    if 0x90 <= code <= 0x9F:
        return _unpack_array(view, pos, code & 0x0F)
    if 0xA0 <= code <= 0xBF:
        n = code & 0x1F
        return str(view[pos:pos + n], "utf-8"), pos + n
    if code == 0xC0:
        return None, pos
    if code == 0xC2:
        return False, pos
    if code == 0xC3:
        return True, pos
    if code in _FIXED:
        fmt, size = _FIXED[code]
        return struct.unpack_from(fmt, view, pos)[0], pos + size
    if code in _SIZED:
        kind, fmt, size = _SIZED[code]
        n = struct.unpack_from(fmt, view, pos)[0]
        pos += size
        if kind == "bin":
            return bytes(view[pos:pos + n]), pos + n
        if kind == "str":
            return str(view[pos:pos + n], "utf-8"), pos + n
        if kind == "array":
            return _unpack_array(view, pos, n)
        return _unpack_map(view, pos, n)
    raise ValueError(f"unsupported msgpack type code 0x{code:02x} at byte {pos - 1}")


def _unpack_array(view: memoryview, pos: int, n: int) -> tuple[list, int]:
    out = []
    for _ in range(n):
        item, pos = _unpack(view, pos)
        out.append(item)
    return out, pos


def _unpack_map(view: memoryview, pos: int, n: int) -> tuple[dict, int]:
    out = {}
    for _ in range(n):
        key, pos = _unpack(view, pos)
        value, pos = _unpack(view, pos)
        out[key] = value
    return out, pos
