"""Native (C++) data-path kernels, built on first use and bound via ctypes.

A copy of ``eovax/native/__init__.py``. ``blosc_decompress(frame)`` decodes
a blosc1 frame (LZ4 / blosclz / memcpy codecs + byte-shuffle), the chunk
format of the TerraMesh zip-zarr shards. zlib-coded blosc frames are
decoded by the Python layer (``eovax_torch/data/zarrzip.py``).

This is host code, not a GPU kernel. Nothing is compiled when the module is
imported: the first decode builds ``blosc.cc`` with ``g++`` into
``build/eovax_torch/`` at the root of the checkout (beside the CUDA
kernels), under a name that carries the hash of the source, the compiler
flags and the CPU target that ``-march=native`` resolves to on this host, so
that a build tree copied to another machine is rebuilt there instead of
loading code its CPU may not run. A failed build raises
:class:`NativeBuildError`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import struct
import subprocess
import threading
from pathlib import Path

from eovax_torch.kernels.build import BUILD_DIR

_SRC = Path(__file__).resolve().parent / "blosc.cc"
_LOCK = threading.Lock()
_LIB = None


class NativeBuildError(RuntimeError):
    pass


_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-std=c++17"]


def _gxx(*args: str) -> str:
    try:
        return subprocess.run(["g++", *args], check=True, capture_output=True, text=True).stdout
    except (OSError, subprocess.CalledProcessError) as e:
        raise NativeBuildError(f"native build failed: {getattr(e, 'stderr', None) or e}") from e


def _build() -> Path:
    key = hashlib.sha256(_SRC.read_bytes())
    key.update(" ".join(_FLAGS).encode())
    key.update(_gxx(*_FLAGS, "-Q", "--help=target").encode())  # the host's resolved target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib_path = BUILD_DIR / f"libeovaxblosc-{key.hexdigest()[:16]}.so"
    if lib_path.exists():
        return lib_path
    # Another process may build the same library at once: each writes its own
    # file and renames it into place, which is atomic.
    tmp = lib_path.with_name(f"{lib_path.name}.tmp{os.getpid()}")
    _gxx(*_FLAGS, str(_SRC), "-o", str(tmp))
    os.replace(tmp, lib_path)
    return lib_path


def _lib():
    global _LIB
    if _LIB is None:
        with _LOCK:
            if _LIB is None:
                lib = ctypes.CDLL(str(_build()))
                lib.eovax_blosc_decompress.restype = ctypes.c_long
                lib.eovax_blosc_decompress.argtypes = [
                    ctypes.c_char_p, ctypes.c_long, ctypes.c_void_p, ctypes.c_long]
                lib.eovax_lz4_decompress.restype = ctypes.c_int
                lib.eovax_lz4_decompress.argtypes = [
                    ctypes.c_char_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int]
                lib.eovax_unshuffle.restype = None
                lib.eovax_unshuffle.argtypes = [
                    ctypes.c_int, ctypes.c_long, ctypes.c_char_p, ctypes.c_void_p]
                _LIB = lib
    return _LIB


def blosc_header(frame: bytes) -> dict:
    """Parse the 16-byte blosc1 header."""
    if len(frame) < 16:
        raise ValueError("truncated blosc frame")
    version, versionlz, flags, typesize = frame[0], frame[1], frame[2], frame[3]
    nbytes, blocksize, cbytes = struct.unpack_from("<iii", frame, 4)
    return {
        "version": version,
        "versionlz": versionlz,
        "flags": flags,
        "typesize": typesize,
        "nbytes": nbytes,
        "blocksize": blocksize,
        "cbytes": cbytes,
        "codec": (flags >> 5) & 0x7,
        "byte_shuffle": bool(flags & 0x1),
        "memcpyed": bool(flags & 0x2),
        "bit_shuffle": bool(flags & 0x4),
    }


def blosc_decompress(frame: bytes) -> bytes:
    """Decode a blosc1 frame natively. Raises NotImplementedError for a codec
    the C++ side does not handle (zlib, zstd); the caller decodes those."""
    hdr = blosc_header(frame)
    out = ctypes.create_string_buffer(hdr["nbytes"])
    r = _lib().eovax_blosc_decompress(frame, len(frame), out, hdr["nbytes"])
    if r == -2:
        raise NotImplementedError(f"blosc codec id {hdr['codec']} not handled natively")
    if r != hdr["nbytes"]:
        raise ValueError(f"blosc decode failed (rc={r}, expected {hdr['nbytes']})")
    return out.raw


def lz4_decompress(block: bytes, out_size: int) -> bytes:
    out = ctypes.create_string_buffer(out_size)
    r = _lib().eovax_lz4_decompress(block, len(block), out, out_size)
    if r != out_size:
        raise ValueError(f"lz4 decode failed (rc={r}, expected {out_size})")
    return out.raw


def unshuffle(typesize: int, data: bytes) -> bytes:
    out = ctypes.create_string_buffer(len(data))
    _lib().eovax_unshuffle(typesize, len(data), data, out)
    return out.raw
