"""flax's msgpack wire format, read and written in plain Python and numpy
(counterpart of ``flax.serialization.msgpack_restore`` and
``msgpack_serialize``, the format of the JAX store's ``state.msgpack`` and
``history.msgpack``).

A tree is nested dicts (str keys) and lists over these leaves: None, bool,
int, float, str, bytes and arrays.  An array travels as msgpack ext type 1
whose payload is the msgpack array ``[shape, dtype name, C-order bytes]``;
a numpy scalar as ext type 3 with the same payload; a Python complex as
ext type 2 holding ``[real, imag]``.  flax splits a leaf of more than
2**30 bytes (its ``MAX_CHUNK_SIZE``) into a map
``{'__msgpack_chunked_array__': True, 'shape': {'0': ...}, 'chunks':
{'0': ...}}`` (tuples travel as maps keyed '0', '1', ...); the reader
joins such maps back into one array, the writer writes every array
whole.

Reading gives numpy arrays (a numpy scalar comes back as a 0-d array), or
for flax's ``'bfloat16'``, which numpy lacks, a ``torch.bfloat16`` tensor.
Writing takes numpy arrays and scalars and CPU torch tensors, and gives
the bytes msgpack-python would give with flax's settings, which flax's
``msgpack_restore`` reads back to an equal tree.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

CHUNKED = "__msgpack_chunked_array__"
EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3

_FIXEXT = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
_FIXEXT_LEN = {v: k for k, v in _FIXEXT.items()}
# marker -> struct format of a fixed-width scalar
_SCALARS = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
            0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
# marker -> (kind, width of the big-endian length that follows)
_SIZED = {0xC4: ("bin", 1), 0xC5: ("bin", 2), 0xC6: ("bin", 4),
          0xC7: ("ext", 1), 0xC8: ("ext", 2), 0xC9: ("ext", 4),
          0xD9: ("str", 1), 0xDA: ("str", 2), 0xDB: ("str", 4),
          0xDC: ("array", 2), 0xDD: ("array", 4),
          0xDE: ("map", 2), 0xDF: ("map", 4)}
_LEN = {1: ">B", 2: ">H", 4: ">I"}


# -- reading -----------------------------------------------------------------

class _Reader:
    def __init__(self, data):
        self.buf = memoryview(data).cast("B")
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError(f"msgpack: truncated at byte {self.pos} "
                             f"(wants {n} of {len(self.buf) - self.pos})")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def read(self):
        m = self.take(1)[0]
        if m <= 0x7F:
            return m
        if m >= 0xE0:
            return m - 0x100
        if 0x80 <= m <= 0x8F:
            return self.map(m & 0x0F)
        if 0x90 <= m <= 0x9F:
            return [self.read() for _ in range(m & 0x0F)]
        if 0xA0 <= m <= 0xBF:
            return str(self.take(m & 0x1F), "utf-8")
        if m == 0xC0:
            return None
        if m in (0xC2, 0xC3):
            return m == 0xC3
        if m in _SCALARS:
            return self.unpack(_SCALARS[m])
        if m in _FIXEXT_LEN:
            return self.ext(_FIXEXT_LEN[m])
        if m not in _SIZED:
            raise ValueError(f"msgpack: unknown marker 0x{m:02x} at byte "
                             f"{self.pos - 1}")
        kind, width = _SIZED[m]
        n = self.unpack(_LEN[width])
        if kind == "bin":
            return bytes(self.take(n))
        if kind == "str":
            return str(self.take(n), "utf-8")
        if kind == "array":
            return [self.read() for _ in range(n)]
        if kind == "map":
            return self.map(n)
        return self.ext(n)

    def map(self, n: int):
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        if out.get(CHUNKED) is True:
            return _unchunk(out)
        return out

    def ext(self, n: int):
        code = self.unpack(">b")
        end = self.pos + n
        if code == EXT_COMPLEX:
            re, im = self.read()
            value = complex(re, im)
        elif code in (EXT_NDARRAY, EXT_NPSCALAR):
            value = self.array()
        else:
            raise ValueError(f"msgpack: unknown ext type {code}")
        if self.pos != end:
            raise ValueError(f"msgpack: ext type {code} payload of {n} bytes "
                             f"read as {n + self.pos - end}")
        return value

    def array(self):
        """An ext 1 / ext 3 payload: [shape, dtype name, bytes], its bytes
        read in place and copied once into a writable array."""
        m = self.take(1)[0]
        if m != 0x93:
            raise ValueError(f"msgpack: array payload opens with 0x{m:02x}, "
                             "not a 3-array")
        shape = tuple(self.read())
        name = self.read()
        if isinstance(name, bytes):
            name = name.decode()
        m = self.take(1)[0]
        if m not in (0xC4, 0xC5, 0xC6):
            raise ValueError(f"msgpack: array data under 0x{m:02x}, not bin")
        raw = self.take(self.unpack(_LEN[_SIZED[m][1]]))
        if name == "bfloat16":
            u16 = np.frombuffer(raw, np.uint16).reshape(shape).copy()
            return torch.from_numpy(u16).view(torch.bfloat16)
        return np.frombuffer(raw, np.dtype(name)).reshape(shape).copy()


def _from_tuple_map(d: dict) -> list:
    return [d[str(i)] for i in range(len(d))]


def _unchunk(d: dict) -> np.ndarray:
    shape = tuple(_from_tuple_map(d["shape"]))
    return np.concatenate(_from_tuple_map(d["chunks"])).reshape(shape)


def msgpack_restore(data) -> object:
    """Bytes of flax's format -> the tree (dicts, lists, numpy arrays)."""
    r = _Reader(data)
    tree = r.read()
    if r.pos != len(r.buf):
        raise ValueError(f"msgpack: {len(r.buf) - r.pos} bytes after the "
                         "tree")
    return tree


# -- writing -----------------------------------------------------------------

def _int(n: int) -> bytes:
    if 0 <= n <= 0x7F:
        return bytes((n,))
    if -32 <= n < 0:
        return bytes((n & 0xFF,))
    if n > 0:
        for m, top in ((0xCC, 0xFF), (0xCD, 0xFFFF), (0xCE, 0xFFFFFFFF),
                       (0xCF, 0xFFFFFFFFFFFFFFFF)):
            if n <= top:
                return bytes((m,)) + struct.pack(_SCALARS[m], n)
    else:
        for m, low in ((0xD0, -0x80), (0xD1, -0x8000), (0xD2, -0x80000000),
                       (0xD3, -0x8000000000000000)):
            if n >= low:
                return bytes((m,)) + struct.pack(_SCALARS[m], n)
    raise OverflowError(f"msgpack: integer {n} out of range")


def _header(kind: str, n: int) -> bytes:
    """The marker and length of a str, bin, array or map of ``n``."""
    fix = {"str": (0xA0, 31), "array": (0x90, 15), "map": (0x80, 15)}
    if kind in fix and n <= fix[kind][1]:
        return bytes((fix[kind][0] | n,))
    for m, (k, width) in _SIZED.items():
        if k == kind and n < 1 << (8 * width):
            return bytes((m,)) + struct.pack(_LEN[width], n)
    raise ValueError(f"msgpack: {kind} of {n} too long")


def _ext_header(code: int, n: int) -> bytes:
    if n in _FIXEXT:
        head = bytes((_FIXEXT[n],))
    else:
        head = _header("ext", n)
    return head + struct.pack(">b", code)


def _array_parts(arr, code: int, out: list) -> None:
    """One array as ext ``code``: headers, then its bytes in place (one
    copy for a non-contiguous array)."""
    name = None
    if isinstance(arr, torch.Tensor):
        arr = arr.detach().cpu()
        if arr.dtype == torch.bfloat16:  # numpy has no bfloat16
            name, arr = "bfloat16", arr.view(torch.int16)
        arr = arr.numpy()
    elif arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("msgpack: object and structured dtypes are not "
                         "supported")
    name = name or arr.dtype.name
    if not arr.flags.c_contiguous:
        arr = np.ascontiguousarray(arr)  # (which would make a 0-d one 1-d)
    shape = b"".join([_header("array", arr.ndim)]
                     + [_int(int(s)) for s in arr.shape])
    inner = (b"\x93" + shape + _header("str", len(name)) + name.encode()
             + _header("bin", arr.nbytes))
    out.append(_ext_header(code, len(inner) + arr.nbytes) + inner)
    out.append(memoryview(arr.reshape(-1).view(np.uint8)))


def _parts(x, out: list) -> None:
    if x is None:
        out.append(b"\xc0")
    elif x is True or x is False:
        out.append(b"\xc3" if x else b"\xc2")
    elif type(x) is int:
        out.append(_int(x))
    elif type(x) is float:
        out.append(b"\xcb" + struct.pack(">d", x))
    elif type(x) is str:
        b = x.encode()
        out.append(_header("str", len(b)) + b)
    elif type(x) is bytes:
        out.append(_header("bin", len(x)) + x)
    elif isinstance(x, dict):
        out.append(_header("map", len(x)))
        for k, v in x.items():
            _parts(k, out)
            _parts(v, out)
    elif isinstance(x, (list, tuple)):
        out.append(_header("array", len(x)))
        for v in x:
            _parts(v, out)
    elif isinstance(x, (np.ndarray, torch.Tensor)):
        _array_parts(x, EXT_NDARRAY, out)
    elif isinstance(x, np.generic):
        _array_parts(np.asarray(x), EXT_NPSCALAR, out)
    elif type(x) is complex:
        body = b"\x92" + b"\xcb" + struct.pack(">d", x.real) + b"\xcb" \
            + struct.pack(">d", x.imag)
        out.append(_ext_header(EXT_COMPLEX, len(body)) + body)
    else:
        raise TypeError(f"msgpack: cannot write {type(x).__name__}")


def msgpack_serialize(tree) -> bytes:
    """The tree -> bytes of flax's format.  Each array's bytes are copied
    once, into the result."""
    out: list = []
    _parts(tree, out)
    return b"".join(out)
