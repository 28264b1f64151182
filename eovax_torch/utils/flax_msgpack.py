"""The ``.msgpack`` checkpoints of the JAX package, read and written without
flax or the ``msgpack`` package.

``flax.serialization.to_bytes`` writes a tree of dicts as one msgpack
document whose array leaves are msgpack extension objects: type 1 (an
ndarray) or 3 (a numpy scalar), each holding a packed ``(shape, dtype name,
raw C-order bytes)``; arrays above 2**30 bytes are split into chunks under a
``__msgpack_chunked_array__`` dict. This module implements that subset of
msgpack (nil, bool, int, float, str, bin, array, map, ext) in pure Python:

- :func:`unpackb` returns the tree with numpy leaves; ``bfloat16`` arrays,
  which numpy lacks, come as ``torch.bfloat16`` tensors read through their
  raw 16-bit words;
- :func:`packb` writes numpy arrays, torch tensors (``bfloat16`` included)
  and Python scalars, byte for byte as ``to_bytes`` writes the same tree.

:func:`read` and :func:`write` do the same with a file.
"""

from __future__ import annotations

import struct
from typing import Any

import numpy as np
import torch

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3
_MAX_CHUNK_SIZE = 2**30  # flax.serialization.MAX_CHUNK_SIZE
_CHUNKED = "__msgpack_chunked_array__"

# --------------------------------------------------------------------- encode


def _pack_header(out: list, n: int, fix: int | None, fix_max: int, c8: int | None, c16: int,
                 c32: int) -> None:
    """A length header: ``fix | n`` where n fits the fixed form, else the
    8-bit (where the type has one), 16-bit or 32-bit form."""
    if fix is not None and n <= fix_max:
        out.append(bytes([fix | n]))
    elif c8 is not None and n <= 0xFF:
        out.append(bytes([c8, n]))
    elif n <= 0xFFFF:
        out.append(struct.pack(">BH", c16, n))
    else:
        out.append(struct.pack(">BI", c32, n))


def _pack_int(out: list, v: int) -> None:
    if 0 <= v < 0x80:
        out.append(bytes([v]))
    elif -0x20 <= v < 0:
        out.append(struct.pack(">b", v))
    elif 0 <= v <= 0xFF:
        out.append(struct.pack(">BB", 0xCC, v))
    elif -0x80 <= v < 0:
        out.append(struct.pack(">Bb", 0xD0, v))
    elif 0 <= v <= 0xFFFF:
        out.append(struct.pack(">BH", 0xCD, v))
    elif -0x8000 <= v < 0:
        out.append(struct.pack(">Bh", 0xD1, v))
    elif 0 <= v <= 0xFFFFFFFF:
        out.append(struct.pack(">BI", 0xCE, v))
    elif -0x80000000 <= v < 0:
        out.append(struct.pack(">Bi", 0xD2, v))
    elif 0 <= v <= 0xFFFFFFFFFFFFFFFF:
        out.append(struct.pack(">BQ", 0xCF, v))
    elif -0x8000000000000000 <= v < 0:
        out.append(struct.pack(">Bq", 0xD3, v))
    else:
        raise OverflowError(f"integer {v} does not fit in 64 bits")


def _pack_str(out: list, s: str) -> None:
    data = s.encode("utf-8")
    _pack_header(out, len(data), 0xA0, 31, 0xD9, 0xDA, 0xDB)
    out.append(data)


def _pack_bin(out: list, data) -> None:
    _pack_header(out, len(data), None, 0, 0xC4, 0xC5, 0xC6)
    out.append(data)


def _pack_ext(out: list, code: int, data: bytes) -> None:
    n = len(data)
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        out.append(bytes([fixed[n], code]))
    elif n <= 0xFF:
        out.append(struct.pack(">BBb", 0xC7, n, code))
    elif n <= 0xFFFF:
        out.append(struct.pack(">BHb", 0xC8, n, code))
    else:
        out.append(struct.pack(">BIb", 0xC9, n, code))
    out.append(data)


def _array_parts(leaf) -> tuple[tuple[int, ...], str, bytes]:
    """(shape, dtype name, raw C-order bytes) of a numpy array or a tensor."""
    if torch.is_tensor(leaf):
        t = leaf.detach().cpu().contiguous()
        name = str(t.dtype).removeprefix("torch.")
        raw = t.view(torch.uint8).numpy().tobytes() if t.numel() else b""
        return tuple(t.shape), name, raw
    arr = np.asarray(leaf)
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("Object and structured dtypes not supported for serialization of "
                         "ndarrays.")
    return arr.shape, arr.dtype.name, arr.tobytes("C")


def _ndarray_bytes(leaf) -> bytes:
    shape, name, raw = _array_parts(leaf)
    out: list = []
    _pack(out, (shape, name, raw))
    return b"".join(out)


def _chunk(leaf) -> dict | None:
    """flax's chunked form of an array above 2**30 bytes, else None."""
    if torch.is_tensor(leaf):
        nbytes, itemsize = leaf.numel() * leaf.element_size(), leaf.element_size()
    else:
        nbytes, itemsize = leaf.size * leaf.dtype.itemsize, leaf.dtype.itemsize
    if nbytes <= _MAX_CHUNK_SIZE:
        return None
    size = max(1, int(_MAX_CHUNK_SIZE / itemsize))
    flat = leaf.reshape(-1)
    chunks = [flat[i:i + size] for i in range(0, flat.shape[0], size)]
    return {_CHUNKED: True, "shape": {str(i): d for i, d in enumerate(leaf.shape)},
            "chunks": {str(i): c for i, c in enumerate(chunks)}}


def _pack(out: list, obj: Any) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif obj is True or obj is False:
        out.append(b"\xc3" if obj else b"\xc2")
    elif type(obj) is int:
        _pack_int(out, obj)
    elif type(obj) is float:
        out.append(struct.pack(">Bd", 0xCB, obj))
    elif type(obj) is str:
        _pack_str(out, obj)
    elif type(obj) in (bytes, bytearray, memoryview):
        _pack_bin(out, bytes(obj))
    elif type(obj) in (list, tuple):
        _pack_header(out, len(obj), 0x90, 15, None, 0xDC, 0xDD)
        for v in obj:
            _pack(out, v)
    elif isinstance(obj, dict):
        _pack_header(out, len(obj), 0x80, 15, None, 0xDE, 0xDF)
        for k, v in obj.items():
            _pack(out, k)
            _pack(out, v)
    elif isinstance(obj, np.ndarray) or torch.is_tensor(obj):
        _pack_ext(out, _EXT_NDARRAY, _ndarray_bytes(obj))
    elif isinstance(obj, np.generic):
        _pack_ext(out, _EXT_NPSCALAR, _ndarray_bytes(np.asarray(obj)))
    else:
        raise TypeError(f"cannot serialize {type(obj).__name__}")


def _chunk_in_place(tree):
    if isinstance(tree, dict):
        return {k: _chunk_in_place(v) for k, v in tree.items()}
    if isinstance(tree, np.ndarray) or torch.is_tensor(tree):
        return _chunk(tree) or tree
    return tree


def packb(tree) -> bytes:
    """The msgpack document ``flax.serialization.to_bytes`` writes for a tree of
    dicts (string keys), lists, arrays and Python scalars."""
    out: list = []
    _pack(out, _chunk_in_place(tree))
    return b"".join(out)


# --------------------------------------------------------------------- decode


class _Reader:
    def __init__(self, data):
        self.buf = memoryview(data).cast("B")
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("truncated msgpack data")
        view = self.buf[self.pos:self.pos + n]
        self.pos += n
        return view

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def read(self):
        b = self.unpack(">B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.read() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return str(self.take(b & 0x1F), "utf-8")
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        lengths = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}
        if b in lengths:
            return bytes(self.take(self.unpack(lengths[b])))
        ext = {0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}
        if b in ext:
            n = self.unpack(ext[b])
            return self.ext(self.unpack(">b"), self.take(n))
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            return self.ext(self.unpack(">b"), self.take(fixext[b]))
        numbers = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                   0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in numbers:
            return self.unpack(numbers[b])
        strs = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}
        if b in strs:
            return str(self.take(self.unpack(strs[b])), "utf-8")
        if b in (0xDC, 0xDD):
            return [self.read() for _ in range(self.unpack(">H" if b == 0xDC else ">I"))]
        if b in (0xDE, 0xDF):
            return self.map(self.unpack(">H" if b == 0xDE else ">I"))
        raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        return out

    def ext(self, code: int, data: memoryview):
        if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
            raise ValueError(f"unsupported msgpack extension type {code}")
        inner = _Reader(data)
        shape, name, raw = inner.read_raw_array()
        arr = _array(shape, name, raw)
        return arr[()] if code == _EXT_NPSCALAR else arr

    def read_raw_array(self):
        """The packed (shape, dtype name, bytes) of an ndarray extension, the
        bytes as a view into the document."""
        if self.unpack(">B") != 0x93:
            raise ValueError("malformed ndarray extension")
        shape = tuple(self.read())
        name = self.read()
        name = name.decode() if isinstance(name, bytes) else name
        b = self.unpack(">B")
        lengths = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}
        if b not in lengths:
            raise ValueError("malformed ndarray extension")
        return shape, name, self.take(self.unpack(lengths[b]))


def _array(shape: tuple, name: str, raw: memoryview):
    """A read-only numpy view of ``raw``; bfloat16 as a torch.bfloat16 tensor."""
    if name == "bfloat16":
        words = np.frombuffer(raw, dtype=np.uint16).reshape(shape).copy()
        return torch.from_numpy(words).view(torch.bfloat16)
    return np.frombuffer(raw, dtype=np.dtype(name)).reshape(shape, order="C")


def _unchunk(tree):
    if isinstance(tree, dict):
        if _CHUNKED in tree:
            shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
            chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
            if torch.is_tensor(chunks[0]):
                return torch.cat(chunks).reshape(shape)
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def unpackb(data) -> Any:
    """The tree of a msgpack document (``flax.serialization.msgpack_restore``)."""
    reader = _Reader(data)
    tree = reader.read()
    if reader.pos != len(reader.buf):
        raise ValueError("trailing bytes after the msgpack document")
    return _unchunk(tree)


def read(path: str) -> Any:
    """The tree of a ``.msgpack`` file."""
    with open(path, "rb") as f:
        return unpackb(f.read())


def write(path: str, tree) -> None:
    """Write ``tree`` as a ``.msgpack`` file (through a temporary name)."""
    import os

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.tmp"
    with open(tmp, "wb") as f:
        f.write(packb(tree))
    os.replace(tmp, path)
