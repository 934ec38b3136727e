"""The msgpack subset the wire frames use, encoded and decoded in Python.

The frames of the transport (``framing.py``) and the daemon's pattern
payloads (``core/daemon.py``) are msgpack maps.  This module packs and
unpacks exactly the types they hold, byte for byte as
``msgpack.packb(obj, use_bin_type=True)`` and
``msgpack.unpackb(data, raw=False, strict_map_key=False)`` do, so a frame
from either side decodes on the other:

  * ``None``, ``bool``;
  * ``int`` in the smallest encoding that holds it (positive and negative
    fixint, uint 8/16/32/64, int 8/16/32/64; ints outside 64 bits raise
    ``OverflowError``);
  * ``float`` (a ``numpy.float64`` is one) always as float 64 (``0xcb``);
  * ``str`` as UTF-8 in fixstr / str 8 / str 16 / str 32;
  * ``bytes``, ``bytearray`` and ``memoryview`` as bin 8 / 16 / 32;
  * ``list`` and ``tuple`` as arrays, ``dict`` as maps (keys of any packable
    type, in insertion order).

Any other type (a ``numpy.float32``, a ``numpy.int64``, a set, an object)
raises ``TypeError``, as msgpack does: nothing is converted quietly.  The
decoder also reads float 32 (``0xca``); extension types, malformed input,
truncated input and trailing bytes raise ``ValueError``.
"""
from __future__ import annotations

import struct
from typing import Any, List, Tuple

_B = struct.Struct(">B")
_H = struct.Struct(">H")
_I = struct.Struct(">I")
_Q = struct.Struct(">Q")
_b = struct.Struct(">b")
_h = struct.Struct(">h")
_i = struct.Struct(">i")
_q = struct.Struct(">q")
_f = struct.Struct(">f")
_d = struct.Struct(">d")

#: msgpack's nesting limit (its default Packer/Unpacker recursion bound)
MAX_DEPTH = 511


def packb(obj: Any) -> bytes:
    """``obj`` as msgpack bytes (``msgpack.packb(obj, use_bin_type=True)``)."""
    out: List[bytes] = []
    _pack(obj, out, MAX_DEPTH)
    return b"".join(out)


def _pack_int(n: int, out: List[bytes]) -> None:
    if n >= 0:
        if n < 0x80:
            out.append(_B.pack(n))
        elif n < 0x100:
            out.append(b"\xcc" + _B.pack(n))
        elif n < 0x10000:
            out.append(b"\xcd" + _H.pack(n))
        elif n < 0x100000000:
            out.append(b"\xce" + _I.pack(n))
        elif n < 0x10000000000000000:
            out.append(b"\xcf" + _Q.pack(n))
        else:
            raise OverflowError("Integer value out of range")
    elif n >= -0x20:
        out.append(_b.pack(n))
    elif n >= -0x80:
        out.append(b"\xd0" + _b.pack(n))
    elif n >= -0x8000:
        out.append(b"\xd1" + _h.pack(n))
    elif n >= -0x80000000:
        out.append(b"\xd2" + _i.pack(n))
    elif n >= -0x8000000000000000:
        out.append(b"\xd3" + _q.pack(n))
    else:
        raise OverflowError("Integer value out of range")


def _header(n: int, fix: int, fix_max: int, codes: Tuple[int, ...],
            out: List[bytes], what: str) -> None:
    """A length header: fix form below ``fix_max``, then 8/16/32-bit forms
    (``codes`` lists the type bytes that exist, widest last)."""
    if fix_max and n < fix_max:
        out.append(_B.pack(fix | n))
        return
    widths = {1: (0x100, _B), 2: (0x10000, _H), 4: (0x100000000, _I)}
    for code, width in zip(codes, (1, 2, 4)[-len(codes):]):
        limit, st = widths[width]
        if n < limit:
            out.append(_B.pack(code) + st.pack(n))
            return
    raise ValueError(f"{what} is too large")


def _pack(obj: Any, out: List[bytes], depth: int) -> None:
    if depth < 0:
        raise ValueError("recursion limit exceeded.")
    if obj is None:
        out.append(b"\xc0")
    elif obj is True:
        out.append(b"\xc3")
    elif obj is False:
        out.append(b"\xc2")
    elif isinstance(obj, int):
        _pack_int(int(obj), out)
    elif isinstance(obj, float):
        out.append(b"\xcb" + _d.pack(float(obj)))
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        _header(len(raw), 0xa0, 32, (0xd9, 0xda, 0xdb), out, "str")
        out.append(raw)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        raw = bytes(obj)
        _header(len(raw), 0, 0, (0xc4, 0xc5, 0xc6), out, "bin")
        out.append(raw)
    elif isinstance(obj, (list, tuple)):
        _header(len(obj), 0x90, 16, (0xdc, 0xdd), out, "array")
        for item in obj:
            _pack(item, out, depth - 1)
    elif isinstance(obj, dict):
        _header(len(obj), 0x80, 16, (0xde, 0xdf), out, "map")
        for key, value in obj.items():
            _pack(key, out, depth - 1)
            _pack(value, out, depth - 1)
    else:
        raise TypeError(f"can not serialize {type(obj).__name__!r} object")


def unpackb(data) -> Any:
    """One msgpack object from ``data``
    (``msgpack.unpackb(data, raw=False, strict_map_key=False)``)."""
    buf = memoryview(bytes(data))
    obj, pos = _unpack(buf, 0, MAX_DEPTH)
    if pos != len(buf):
        raise ValueError(f"{len(buf) - pos} bytes of extra data after the "
                         f"object")
    return obj


def _take(buf: memoryview, pos: int, n: int) -> Tuple[memoryview, int]:
    end = pos + n
    if end > len(buf):
        raise ValueError("Unpack failed: incomplete input")
    return buf[pos:end], end


def _num(buf: memoryview, pos: int, st: struct.Struct) -> Tuple[Any, int]:
    raw, pos = _take(buf, pos, st.size)
    return st.unpack(raw)[0], pos


#: fixed-width scalar codes -> struct
_SCALARS = {0xcc: _B, 0xcd: _H, 0xce: _I, 0xcf: _Q, 0xd0: _b, 0xd1: _h,
            0xd2: _i, 0xd3: _q, 0xca: _f, 0xcb: _d}
#: length-prefixed codes -> (what, struct of the length)
_SIZED = {0xd9: ("str", _B), 0xda: ("str", _H), 0xdb: ("str", _I),
          0xc4: ("bin", _B), 0xc5: ("bin", _H), 0xc6: ("bin", _I),
          0xdc: ("array", _H), 0xdd: ("array", _I),
          0xde: ("map", _H), 0xdf: ("map", _I)}


def _unpack(buf: memoryview, pos: int, depth: int) -> Tuple[Any, int]:
    if depth < 0:
        raise ValueError("recursion limit exceeded.")
    if pos >= len(buf):
        raise ValueError("Unpack failed: incomplete input")
    code = buf[pos]
    pos += 1
    if code < 0x80:
        return code, pos
    if code >= 0xe0:
        return code - 0x100, pos
    if code == 0xc0:
        return None, pos
    if code == 0xc2:
        return False, pos
    if code == 0xc3:
        return True, pos
    if code in _SCALARS:
        return _num(buf, pos, _SCALARS[code])
    if 0xa0 <= code <= 0xbf:
        what, n = "str", code & 0x1f
    elif 0x90 <= code <= 0x9f:
        what, n = "array", code & 0x0f
    elif 0x80 <= code <= 0x8f:
        what, n = "map", code & 0x0f
    elif code in _SIZED:
        what, st = _SIZED[code]
        n, pos = _num(buf, pos, st)
    else:
        raise ValueError(f"msgpack type byte 0x{code:02x} is not in the wire "
                         f"subset (extension types are not used)")
    if what == "str":
        raw, pos = _take(buf, pos, n)
        return str(raw, "utf-8"), pos
    if what == "bin":
        raw, pos = _take(buf, pos, n)
        return bytes(raw), pos
    if what == "array":
        items = []
        for _ in range(n):
            item, pos = _unpack(buf, pos, depth - 1)
            items.append(item)
        return items, pos
    out = {}
    for _ in range(n):
        key, pos = _unpack(buf, pos, depth - 1)
        value, pos = _unpack(buf, pos, depth - 1)
        out[key] = value
    return out, pos
