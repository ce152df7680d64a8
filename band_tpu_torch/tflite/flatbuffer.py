"""Minimal from-scratch FlatBuffer reader.

Implements just enough of the FlatBuffers wire format (vtables, tables,
vectors, strings, inline scalars) to walk a ``.tflite`` file.  No
generated code, no dependency on the ``flatbuffers`` package.

Wire format recap:
 * file root: uint32 offset at byte 0 -> root table position
 * table: int32 soffset at table pos; vtable pos = table_pos - soffset
 * vtable: uint16 vtable_bytes, uint16 table_bytes, then uint16 field
   offsets (relative to table pos) indexed by field slot; 0 = absent
 * offset fields (string/vector/table): uint32 relative offset, target =
   field_loc + value
 * string: uint32 length then utf-8 bytes
 * vector: uint32 length then inline elements (scalars) or uoffsets
"""

from __future__ import annotations

import struct
from typing import List, Optional

import numpy as np

_U8 = struct.Struct("<B")
_I8 = struct.Struct("<b")
_U16 = struct.Struct("<H")
_I16 = struct.Struct("<h")
_U32 = struct.Struct("<I")
_I32 = struct.Struct("<i")
_U64 = struct.Struct("<Q")
_I64 = struct.Struct("<q")
_F32 = struct.Struct("<f")
_F64 = struct.Struct("<d")


class Table:
    """A view of one FlatBuffer table inside a shared byte buffer."""

    __slots__ = ("buf", "pos")

    def __init__(self, buf: memoryview, pos: int):
        self.buf = buf
        self.pos = pos

    # --- low-level ---
    def _field_pos(self, slot: int) -> int:
        """Absolute position of field `slot`, or 0 if absent."""
        vtable = self.pos - _I32.unpack_from(self.buf, self.pos)[0]
        vtable_len = _U16.unpack_from(self.buf, vtable)[0]
        entry = 4 + 2 * slot
        if entry >= vtable_len:
            return 0
        rel = _U16.unpack_from(self.buf, vtable + entry)[0]
        return self.pos + rel if rel else 0

    def _indirect(self, pos: int) -> int:
        return pos + _U32.unpack_from(self.buf, pos)[0]

    # --- scalars ---
    def _scalar(self, slot: int, st: struct.Struct, default):
        p = self._field_pos(slot)
        return st.unpack_from(self.buf, p)[0] if p else default

    def u8(self, slot: int, default: int = 0) -> int:
        return self._scalar(slot, _U8, default)

    def i8(self, slot: int, default: int = 0) -> int:
        return self._scalar(slot, _I8, default)

    def bool_(self, slot: int, default: bool = False) -> bool:
        return bool(self._scalar(slot, _U8, int(default)))

    def i16(self, slot: int, default: int = 0) -> int:
        return self._scalar(slot, _I16, default)

    def u16(self, slot: int, default: int = 0) -> int:
        return self._scalar(slot, _U16, default)

    def i32(self, slot: int, default: int = 0) -> int:
        return self._scalar(slot, _I32, default)

    def u32(self, slot: int, default: int = 0) -> int:
        return self._scalar(slot, _U32, default)

    def i64(self, slot: int, default: int = 0) -> int:
        return self._scalar(slot, _I64, default)

    def u64(self, slot: int, default: int = 0) -> int:
        return self._scalar(slot, _U64, default)

    def f32(self, slot: int, default: float = 0.0) -> float:
        return self._scalar(slot, _F32, default)

    def f64(self, slot: int, default: float = 0.0) -> float:
        return self._scalar(slot, _F64, default)

    # --- offsets ---
    def string(self, slot: int) -> Optional[str]:
        p = self._field_pos(slot)
        if not p:
            return None
        s = self._indirect(p)
        n = _U32.unpack_from(self.buf, s)[0]
        return bytes(self.buf[s + 4 : s + 4 + n]).decode("utf-8", "replace")

    def table(self, slot: int) -> Optional["Table"]:
        p = self._field_pos(slot)
        if not p:
            return None
        return Table(self.buf, self._indirect(p))

    def union(self, slot: int) -> Optional["Table"]:
        # union value fields are stored like table offsets
        return self.table(slot)

    # --- vectors ---
    def _vector(self, slot: int):
        """Returns (elements_pos, length) or None."""
        p = self._field_pos(slot)
        if not p:
            return None
        v = self._indirect(p)
        n = _U32.unpack_from(self.buf, v)[0]
        return v + 4, n

    def vector_len(self, slot: int) -> int:
        v = self._vector(slot)
        return v[1] if v else 0

    def scalar_vector(self, slot: int, dtype) -> np.ndarray:
        """Zero-copy numpy view of a scalar vector field."""
        v = self._vector(slot)
        if not v:
            return np.empty(0, dtype=dtype)
        pos, n = v
        dt = np.dtype(dtype).newbyteorder("<")
        return np.frombuffer(self.buf, dtype=dt, count=n, offset=pos)

    def table_vector(self, slot: int) -> List["Table"]:
        v = self._vector(slot)
        if not v:
            return []
        pos, n = v
        out = []
        for i in range(n):
            p = pos + 4 * i
            out.append(Table(self.buf, self._indirect(p)))
        return out

    def string_vector(self, slot: int) -> List[str]:
        v = self._vector(slot)
        if not v:
            return []
        pos, n = v
        out = []
        for i in range(n):
            p = pos + 4 * i
            s = self._indirect(p)
            ln = _U32.unpack_from(self.buf, s)[0]
            out.append(bytes(self.buf[s + 4 : s + 4 + ln]).decode("utf-8", "replace"))
        return out

    def bytes_vector(self, slot: int) -> bytes:
        v = self._vector(slot)
        if not v:
            return b""
        pos, n = v
        return bytes(self.buf[pos : pos + n])


def root_table(data: bytes) -> Table:
    buf = memoryview(data)
    pos = _U32.unpack_from(buf, 0)[0]
    return Table(buf, pos)


def file_identifier(data: bytes) -> str:
    return bytes(data[4:8]).decode("ascii", "replace")
