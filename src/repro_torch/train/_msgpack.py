"""The part of MessagePack that the checkpoint format uses, by hand.

``arrays.msgpack`` (``train/checkpoint.py``) is a stream of maps
``{"key", "dtype", "shape", "data"}`` as the reference writes them with
``msgpack.Packer()``: str keys and values, a list of non-negative ints,
and the raw buffer as bin.  This codec packs exactly those types to the
same bytes and unpacks them; any other type or format byte raises.

  * maps: fixmap, map16;  arrays: fixarray, array16;
  * str (UTF-8): fixstr, str8, str16;  bin: bin8, bin16, bin32;
  * ints >= 0: positive fixint, uint8, uint16, uint32, uint64.
"""
from __future__ import annotations

import struct


def _head(n: int, fix: int, fix_max: int, wide: tuple) -> bytes:
    """The header of a length-``n`` item: the fix form below
    ``fix_max``, else the first (format byte, struct code, limit) of
    ``wide`` that holds ``n``."""
    if fix is not None and n <= fix_max:
        return bytes([fix | n])
    for fmt, code, limit in wide:
        if n <= limit:
            return bytes([fmt]) + struct.pack(">" + code, n)
    raise ValueError(f"length {n} is beyond this codec")


def pack(obj) -> bytes:
    """``msgpack.packb(obj)`` for the types above."""
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


def _pack(obj, out: bytearray) -> None:
    if isinstance(obj, bool) or obj is None or isinstance(obj, float):
        raise TypeError(f"{type(obj).__name__} is not in the checkpoint "
                        f"format")
    if isinstance(obj, int):
        if obj < 0:
            raise TypeError("negative ints are not in the checkpoint format")
        out += _head(obj, 0x00, 0x7F, ((0xCC, "B", 0xFF),
                                       (0xCD, "H", 0xFFFF),
                                       (0xCE, "I", 0xFFFFFFFF),
                                       (0xCF, "Q", 0xFFFFFFFFFFFFFFFF)))
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        out += _head(len(raw), 0xA0, 31, ((0xD9, "B", 0xFF),
                                          (0xDA, "H", 0xFFFF)))
        out += raw
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        raw = memoryview(obj).cast("B")
        out += _head(len(raw), None, -1, ((0xC4, "B", 0xFF),
                                          (0xC5, "H", 0xFFFF),
                                          (0xC6, "I", 0xFFFFFFFF)))
        out += raw
    elif isinstance(obj, (list, tuple)):
        out += _head(len(obj), 0x90, 15, ((0xDC, "H", 0xFFFF),))
        for x in obj:
            _pack(x, out)
    elif isinstance(obj, dict):
        out += _head(len(obj), 0x80, 15, ((0xDE, "H", 0xFFFF),))
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"{type(obj).__name__} is not in the checkpoint "
                        f"format")


# format byte -> (kind, struct code of the length / value)
_WIDE = {0xCC: ("int", "B"), 0xCD: ("int", "H"), 0xCE: ("int", "I"),
         0xCF: ("int", "Q"), 0xD9: ("str", "B"), 0xDA: ("str", "H"),
         0xC4: ("bin", "B"), 0xC5: ("bin", "H"), 0xC6: ("bin", "I"),
         0xDC: ("array", "H"), 0xDE: ("map", "H")}


def unpack_stream(buf) -> list:
    """Every object packed back to back in ``buf`` (bytes or a
    memoryview); bin values come back as memoryviews into ``buf``."""
    view = memoryview(buf).cast("B")
    out, pos = [], 0
    while pos < len(view):
        obj, pos = _unpack(view, pos)
        out.append(obj)
    return out


def _unpack(view: memoryview, pos: int):
    if pos >= len(view):
        raise ValueError("truncated msgpack stream")
    b = view[pos]
    pos += 1
    if b <= 0x7F:
        return b, pos
    if 0x80 <= b <= 0x8F:
        kind, n = "map", b & 0x0F
    elif 0x90 <= b <= 0x9F:
        kind, n = "array", b & 0x0F
    elif 0xA0 <= b <= 0xBF:
        kind, n = "str", b & 0x1F
    elif b in _WIDE:
        kind, code = _WIDE[b]
        size = struct.calcsize(code)
        if pos + size > len(view):
            raise ValueError("truncated msgpack stream")
        (n,) = struct.unpack(">" + code, view[pos:pos + size])
        pos += size
        if kind == "int":
            return n, pos
    else:
        raise ValueError(f"msgpack format byte 0x{b:02x} is not in the "
                         f"checkpoint format")
    if kind in ("str", "bin"):
        if pos + n > len(view):
            raise ValueError("truncated msgpack stream")
        raw = view[pos:pos + n]
        return (str(raw, "utf-8") if kind == "str" else raw), pos + n
    if kind == "array":
        items = []
        for _ in range(n):
            x, pos = _unpack(view, pos)
            items.append(x)
        return items, pos
    obj = {}
    for _ in range(n):
        k, pos = _unpack(view, pos)
        obj[k], pos = _unpack(view, pos)
    return obj, pos
