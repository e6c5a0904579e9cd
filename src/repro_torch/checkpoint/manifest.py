"""The checkpoint manifest's msgpack subset, written and read without msgpack.

The JAX package writes its manifest with ``msgpack.packb``
(``repro.checkpoint``); the GPU machine's Python has no msgpack, and nothing
may be installed there.  A manifest holds only a map of str keys whose values
are ints, strs, lists of strs and lists of lists of ints, so this module packs
and unpacks that subset itself:

* ints: positive and negative fixint, uint8/16/32/64, int8/16/32/64;
* strs: fixstr, str8/16/32 (UTF-8);
* lists: fixarray, array16/32;
* maps: fixmap, map16/32, str keys.

``pack`` picks the smallest encoding of each value, as ``msgpack.packb``
does, so the two give the same bytes; ``unpack`` returns lists and strs, as
``msgpack.unpackb`` does.  Both raise ``TypeError`` on anything outside the
subset (floats, bools, None, bytes, tuples) and ``ValueError`` on malformed
input.
"""
from __future__ import annotations

import struct
from typing import Any, List, Tuple

_INT_LIMIT = 1 << 64


def _int(v: int) -> bytes:
    if v >= 0:
        if v < 0x80:
            return bytes([v])
        for code, fmt, top in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16),
                               (0xCE, ">I", 1 << 32), (0xCF, ">Q", _INT_LIMIT)):
            if v < top:
                return bytes([code]) + struct.pack(fmt, v)
        raise OverflowError(f"int {v} does not fit msgpack's uint64")
    if v >= -32:
        return struct.pack(">b", v)
    for code, fmt, low in ((0xD0, ">b", -(1 << 7)), (0xD1, ">h", -(1 << 15)),
                           (0xD2, ">i", -(1 << 31)), (0xD3, ">q", -(1 << 63))):
        if v >= low:
            return bytes([code]) + struct.pack(fmt, v)
    raise OverflowError(f"int {v} does not fit msgpack's int64")


def _header(n: int, fix: int, fix_max: int, forms: Tuple[Tuple[int, str], ...],
            what: str) -> bytes:
    """A length header: the fix form below ``fix_max``, else the first of
    ``forms`` (type byte, length format) whose length field holds ``n``."""
    if n < fix_max:
        return bytes([fix | n])
    for code, fmt in forms:
        if n < 1 << (8 * struct.calcsize(fmt)):
            return bytes([code]) + struct.pack(fmt, n)
    raise OverflowError(f"{what} of length {n} is too long for msgpack")


_STR = ((0xD9, ">B"), (0xDA, ">H"), (0xDB, ">I"))
_LIST = ((0xDC, ">H"), (0xDD, ">I"))
_MAP = ((0xDE, ">H"), (0xDF, ">I"))
_STR_CODES, _LIST_CODES, _MAP_CODES = dict(_STR), dict(_LIST), dict(_MAP)
_INT_FORMATS = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}


def _pack(obj: Any, out: List[bytes]) -> None:
    if isinstance(obj, bool) or not isinstance(obj, (int, str, list, dict)):
        raise TypeError(f"{type(obj).__name__} is outside the manifest's msgpack subset "
                        "(int, str, list, dict with str keys)")
    if isinstance(obj, int):
        out.append(_int(obj))
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        out.append(_header(len(raw), 0xA0, 32, _STR, "str"))
        out.append(raw)
    elif isinstance(obj, list):
        out.append(_header(len(obj), 0x90, 16, _LIST, "list"))
        for x in obj:
            _pack(x, out)
    else:
        out.append(_header(len(obj), 0x80, 16, _MAP, "map"))
        for k, v in obj.items():
            if not isinstance(k, str):
                raise TypeError(f"map key {k!r}: the manifest's maps have str keys")
            _pack(k, out)
            _pack(v, out)


def pack(obj: Any) -> bytes:
    """``obj`` in msgpack, the same bytes as ``msgpack.packb(obj)``."""
    out: List[bytes] = []
    _pack(obj, out)
    return b"".join(out)


class _Reader:
    def __init__(self, data: bytes):
        self.data, self.pos = memoryview(data), 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos:self.pos + n].tobytes()
        self.pos += n
        return out

    def num(self, fmt: str) -> int:
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def str_(self, n: int) -> str:
        return self.take(n).decode("utf-8")

    def value(self) -> Any:
        code = self.num(">B")
        if code < 0x80:
            return code
        if code >= 0xE0:
            return code - 0x100
        if 0xA0 <= code <= 0xBF:
            return self.str_(code & 0x1F)
        if 0x90 <= code <= 0x9F:
            return self.list_(code & 0x0F)
        if 0x80 <= code <= 0x8F:
            return self.map_(code & 0x0F)
        if code in _INT_FORMATS:
            return self.num(_INT_FORMATS[code])
        if code in _STR_CODES:
            return self.str_(self.num(_STR_CODES[code]))
        if code in _LIST_CODES:
            return self.list_(self.num(_LIST_CODES[code]))
        if code in _MAP_CODES:
            return self.map_(self.num(_MAP_CODES[code]))
        raise TypeError(f"msgpack type byte 0x{code:02x} is outside the manifest's subset")

    def list_(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map_(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value()
            if not isinstance(k, str):
                raise TypeError(f"map key {k!r}: the manifest's maps have str keys")
            out[k] = self.value()
        return out


def unpack(data: bytes) -> Any:
    """The value packed in ``data`` (lists for arrays, strs for strs), as
    ``msgpack.unpackb`` returns it; raises ``ValueError`` on bytes left over."""
    r = _Reader(data)
    out = r.value()
    if r.pos != len(r.data):
        raise ValueError(f"{len(r.data) - r.pos} bytes left over after the msgpack value")
    return out
