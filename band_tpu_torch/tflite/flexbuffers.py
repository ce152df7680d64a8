"""A FlexBuffers reader: decodes a TFLite custom op's options.

Custom ops (e.g. ``TFLite_Detection_PostProcess``) carry their options
as a FlexBuffer, a schema-less binary map.  This reader decodes one
into Python values (dict, list, int, float, bool, str, bytes, None)
without the ``flatbuffers`` package, which a serving machine may lack:
without it the detection post-process would run on its defaults and
give other boxes.  Format: flatbuffers/docs/source/FlexBuffers.md.
"""

from __future__ import annotations

import struct
from typing import Any

# FlexBuffer value types (flexbuffers.h Type)
NULL, INT, UINT, FLOAT, KEY, STRING = 0, 1, 2, 3, 4, 5
INDIRECT_INT, INDIRECT_UINT, INDIRECT_FLOAT = 6, 7, 8
MAP, VECTOR = 9, 10
VECTOR_INT, VECTOR_UINT, VECTOR_FLOAT, VECTOR_KEY = 11, 12, 13, 14
VECTOR_STRING_DEPRECATED = 15
BLOB, BOOL, VECTOR_BOOL = 25, 26, 36

_INT_FMT = {1: "<b", 2: "<h", 4: "<i", 8: "<q"}
_UINT_FMT = {1: "<B", 2: "<H", 4: "<I", 8: "<Q"}
_FLOAT_FMT = {4: "<f", 8: "<d"}


class _Buf:
    def __init__(self, data: bytes):
        self.b = bytes(data)

    def uint(self, off: int, width: int) -> int:
        return struct.unpack_from(_UINT_FMT[width], self.b, off)[0]

    def int(self, off: int, width: int) -> int:
        return struct.unpack_from(_INT_FMT[width], self.b, off)[0]

    def float(self, off: int, width: int) -> float:
        if width not in _FLOAT_FMT:
            raise ValueError(f"flexbuffer float of {width} bytes")
        return struct.unpack_from(_FLOAT_FMT[width], self.b, off)[0]

    def indirect(self, off: int, width: int) -> int:
        return off - self.uint(off, width)

    def cstring(self, off: int) -> str:
        end = self.b.index(b"\0", off)
        return self.b[off:end].decode("utf-8")


def _typed_vector_element(t: int) -> int:
    if VECTOR_INT <= t <= VECTOR_STRING_DEPRECATED:
        return t - VECTOR_INT + INT
    if t == VECTOR_BOOL:
        return BOOL
    return INT + (t - 16) % 3  # fixed-length typed vectors 16..24


def _fixed_length(t: int) -> int:
    return 0 if t < 16 or t > 24 else (t - 16) // 3 + 2


def _value(buf: _Buf, off: int, parent_width: int, packed: int) -> Any:
    """The value stored at ``off`` in a slot ``parent_width`` bytes wide,
    of packed type ``packed`` (type << 2 | log2 of its own width)."""
    t, width = packed >> 2, 1 << (packed & 3)
    if t == NULL:
        return None
    if t == BOOL:
        return bool(buf.uint(off, parent_width))
    if t == INT:
        return buf.int(off, parent_width)
    if t == UINT:
        return buf.uint(off, parent_width)
    if t == FLOAT:
        return buf.float(off, parent_width)
    target = buf.indirect(off, parent_width)
    if t == INDIRECT_INT:
        return buf.int(target, width)
    if t == INDIRECT_UINT:
        return buf.uint(target, width)
    if t == INDIRECT_FLOAT:
        return buf.float(target, width)
    if t == KEY:
        return buf.cstring(target)
    if t in (STRING, BLOB):
        size = buf.uint(target - width, width)
        raw = buf.b[target:target + size]
        return raw.decode("utf-8") if t == STRING else raw
    if t in (VECTOR, MAP):
        size = buf.uint(target - width, width)
        types = target + size * width
        items = [_value(buf, target + i * width, width, buf.b[types + i])
                 for i in range(size)]
        if t == VECTOR:
            return items
        keys_at = target - 3 * width
        keys = buf.indirect(keys_at, width)
        key_width = buf.uint(target - 2 * width, width)
        names = [buf.cstring(buf.indirect(keys + i * key_width, key_width))
                 for i in range(size)]
        return dict(zip(names, items))
    if VECTOR_INT <= t <= 24 or t == VECTOR_BOOL:
        n = _fixed_length(t)
        size = n if n else buf.uint(target - width, width)
        elem = _typed_vector_element(t) << 2  # elements are `width` wide
        return [_value(buf, target + i * width, width, elem)
                for i in range(size)]
    raise ValueError(f"flexbuffer type {t} is not supported")


def loads(data: bytes) -> Any:
    """Decode a whole FlexBuffer (its root value)."""
    buf = _Buf(data)
    if len(buf.b) < 3:
        raise ValueError("flexbuffer too short")
    root_width = buf.b[-1]
    packed = buf.b[-2]
    return _value(buf, len(buf.b) - 2 - root_width, root_width, packed)
