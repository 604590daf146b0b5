"""A msgpack encoder and decoder for the types a checkpoint payload holds:
map, str, bin, int, array, nil, bool and float.

The checkpoint format (``checkpoint.py``) is msgpack, and the machines the
port runs on need not have the ``msgpack`` package, so the port carries its
own.  ``packb`` chooses the same encodings as ``msgpack.packb(obj,
use_bin_type=True)`` — the smallest form of every int, str, bin, array and
map; floats as float64 — so the bytes are identical; ``unpackb`` reads what
either writes (also float32) and returns str for str and bytes for bin, as
``msgpack.unpackb(raw=False)`` does.
"""
from __future__ import annotations

import struct


def packb(obj) -> bytes:
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


def _pack_len(n: int, out: bytearray, fix: int | None, fix_max: int,
              codes: tuple[int, int, int]) -> None:
    """Header of a str / bin / array / map of length ``n``: the fix form
    (``fix`` | n) when there is one and n fits, else the 8-, 16- or 32-bit
    length form (``codes``; a 0 entry means the form does not exist)."""
    c8, c16, c32 = codes
    if fix is not None and n <= fix_max:
        out.append(fix | n)
    elif c8 and n < 1 << 8:
        out += bytes((c8, n))
    elif n < 1 << 16:
        out += struct.pack(">BH", c16, n)
    elif n < 1 << 32:
        out += struct.pack(">BI", c32, n)
    else:
        raise ValueError(f"msgpack: length {n} does not fit 32 bits")


def _pack(obj, out: bytearray) -> None:
    if obj is None:
        out.append(0xC0)
    elif obj is True:
        out.append(0xC3)
    elif obj is False:
        out.append(0xC2)
    elif isinstance(obj, int):
        _pack_int(obj, out)
    elif isinstance(obj, float):
        out += struct.pack(">Bd", 0xCB, obj)
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        _pack_len(len(data), out, 0xA0, 31, (0xD9, 0xDA, 0xDB))
        out += data
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        data = bytes(obj)
        _pack_len(len(data), out, None, -1, (0xC4, 0xC5, 0xC6))
        out += data
    elif isinstance(obj, (list, tuple)):
        _pack_len(len(obj), out, 0x90, 15, (0, 0xDC, 0xDD))
        for x in obj:
            _pack(x, out)
    elif isinstance(obj, dict):
        _pack_len(len(obj), out, 0x80, 15, (0, 0xDE, 0xDF))
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"msgpack: cannot pack {type(obj).__name__}")


def _pack_int(n: int, out: bytearray) -> None:
    if 0 <= n < 0x80:
        out.append(n)
    elif -32 <= n < 0:
        out.append(n & 0xFF)
    elif n >= 0:
        for code, fmt, top in ((0xCC, ">BB", 1 << 8), (0xCD, ">BH", 1 << 16),
                               (0xCE, ">BI", 1 << 32),
                               (0xCF, ">BQ", 1 << 64)):
            if n < top:
                out += struct.pack(fmt, code, n)
                return
        raise ValueError(f"msgpack: int {n} does not fit 64 bits")
    else:
        for code, fmt, bot in ((0xD0, ">Bb", -(1 << 7)),
                               (0xD1, ">Bh", -(1 << 15)),
                               (0xD2, ">Bi", -(1 << 31)),
                               (0xD3, ">Bq", -(1 << 63))):
            if n >= bot:
                out += struct.pack(fmt, code, n)
                return
        raise ValueError(f"msgpack: int {n} does not fit 64 bits")


class MsgpackError(ValueError):
    pass


def unpackb(data: bytes):
    view = memoryview(data)
    obj, pos = _unpack(view, 0)
    if pos != len(view):
        raise MsgpackError(f"msgpack: {len(view) - pos} bytes of trailing "
                           f"data")
    return obj


_FIXED = {  # code -> (struct format, size) of int / float payloads
    0xCA: (">f", 4), 0xCB: (">d", 8),
    0xCC: (">B", 1), 0xCD: (">H", 2), 0xCE: (">I", 4), 0xCF: (">Q", 8),
    0xD0: (">b", 1), 0xD1: (">h", 2), 0xD2: (">i", 4), 0xD3: (">q", 8),
}
_LEN = {  # code -> (kind, size of the length field)
    0xD9: ("str", 1), 0xDA: ("str", 2), 0xDB: ("str", 4),
    0xC4: ("bin", 1), 0xC5: ("bin", 2), 0xC6: ("bin", 4),
    0xDC: ("array", 2), 0xDD: ("array", 4),
    0xDE: ("map", 2), 0xDF: ("map", 4),
}


def _take(view: memoryview, pos: int, n: int) -> memoryview:
    if pos + n > len(view):
        raise MsgpackError("msgpack: truncated data")
    return view[pos:pos + n]


def _unpack(view: memoryview, pos: int):
    code = _take(view, pos, 1)[0]
    pos += 1
    if code < 0x80:
        return code, pos
    if code >= 0xE0:
        return code - 0x100, pos
    if 0x80 <= code <= 0x8F:
        return _unpack_map(view, pos, code & 0x0F)
    if 0x90 <= code <= 0x9F:
        return _unpack_array(view, pos, code & 0x0F)
    if 0xA0 <= code <= 0xBF:
        n = code & 0x1F
        return str(_take(view, pos, n), "utf-8"), pos + n
    if code == 0xC0:
        return None, pos
    if code in (0xC2, 0xC3):
        return code == 0xC3, pos
    if code in _FIXED:
        fmt, size = _FIXED[code]
        return struct.unpack(fmt, _take(view, pos, size))[0], pos + size
    if code in _LEN:
        kind, size = _LEN[code]
        n = int.from_bytes(_take(view, pos, size), "big")
        pos += size
        if kind == "array":
            return _unpack_array(view, pos, n)
        if kind == "map":
            return _unpack_map(view, pos, n)
        raw = _take(view, pos, n)
        return (str(raw, "utf-8") if kind == "str" else bytes(raw)), pos + n
    raise MsgpackError(f"msgpack: unsupported type code 0x{code:02x}")


def _unpack_array(view: memoryview, pos: int, n: int):
    out = []
    for _ in range(n):
        x, pos = _unpack(view, pos)
        out.append(x)
    return out, pos


def _unpack_map(view: memoryview, pos: int, n: int):
    out = {}
    for _ in range(n):
        k, pos = _unpack(view, pos)
        v, pos = _unpack(view, pos)
        out[k] = v
    return out, pos
