"""Minimal zarr-v2 zip-store reader (no zarr/numcodecs dependency).

A numpy copy of ``eovax/data/zarrzip.py``. The TerraMesh samples are zip
archives holding a consolidated zarr group with arrays like ``bands``,
``time``, ``center_lon``, ``center_lat``, ``cloud_mask`` (the reference
decodes them through fsspec+zarr). This reader parses the store directly:
JSON metadata + chunk assembly, with blosc chunks decoded by the native C++
decoder (eovax_torch.native) and zlib/gzip chunks by the stdlib.
"""

from __future__ import annotations

import io
import json
import zipfile
import zlib
from typing import Any

import numpy as np


def _decompress(chunk: bytes, compressor: dict | None, out_nbytes: int) -> bytes:
    if compressor is None:
        return chunk
    cid = compressor.get("id")
    if cid == "blosc":
        from eovax_torch import native

        try:
            return native.blosc_decompress(chunk)
        except NotImplementedError:
            # A zlib-coded blosc frame: the C++ decoder has no zlib codec, so
            # its blocks are decoded in Python. A failed build raises instead.
            return _blosc_zlib_python(chunk)
    if cid in ("zlib", "gzip"):
        return zlib.decompress(chunk, 47 if cid == "gzip" else 15)
    raise NotImplementedError(f"Unsupported zarr compressor: {cid}")


def _blosc_zlib_python(frame: bytes) -> bytes:
    """Decode a blosc frame whose codec is zlib (codec id 3) in Python."""
    from eovax_torch.native import blosc_header, unshuffle

    hdr = blosc_header(frame)
    if hdr["memcpyed"]:
        return frame[16 : 16 + hdr["nbytes"]]
    nblocks = -(-hdr["nbytes"] // hdr["blocksize"])
    bstarts = np.frombuffer(frame, "<i4", count=nblocks, offset=16)
    out = bytearray()
    for b in range(nblocks):
        off = int(bstarts[b])
        want = min(hdr["blocksize"], hdr["nbytes"] - b * hdr["blocksize"])
        csize = int(np.frombuffer(frame, "<i4", count=1, offset=off)[0])
        raw = frame[off + 4 : off + 4 + abs(csize)]
        block = raw if abs(csize) == want else zlib.decompress(raw)
        if hdr["byte_shuffle"]:
            block = unshuffle(hdr["typesize"], block)
        out += block
    return bytes(out)


def _stored_entry_index(data: bytes) -> dict[str, tuple[int, int]] | None:
    """Parse the zip central directory; if every entry is STORED
    (uncompressed — the zarr zip-store default), return name → (offset,
    size) so members can be sliced without zipfile/CRC overhead."""
    import struct

    eocd = data.rfind(b"PK\x05\x06", max(0, len(data) - 66000))
    if eocd < 0:
        return None
    count = struct.unpack_from("<H", data, eocd + 10)[0]
    cd_off = struct.unpack_from("<I", data, eocd + 16)[0]
    index: dict[str, tuple[int, int]] = {}
    p = cd_off
    for _ in range(count):
        if data[p : p + 4] != b"PK\x01\x02":
            return None
        method = struct.unpack_from("<H", data, p + 10)[0]
        csize = struct.unpack_from("<I", data, p + 20)[0]
        name_len = struct.unpack_from("<H", data, p + 28)[0]
        extra_len = struct.unpack_from("<H", data, p + 30)[0]
        comment_len = struct.unpack_from("<H", data, p + 32)[0]
        lho = struct.unpack_from("<I", data, p + 42)[0]
        name = data[p + 46 : p + 46 + name_len].decode()
        if method != 0:  # not STORED → fall back to zipfile wholesale
            return None
        # Local header: name/extra lengths may differ from central dir.
        ln = struct.unpack_from("<H", data, lho + 26)[0]
        le = struct.unpack_from("<H", data, lho + 28)[0]
        index[name] = (lho + 30 + ln + le, csize)
        p += 46 + name_len + extra_len + comment_len
    return index


class ZarrZipGroup:
    """Read-only view over a zarr v2 group stored in a zip archive."""

    def __init__(self, data: bytes):
        self._data = data
        self._index = _stored_entry_index(data)
        if self._index is not None:
            self._names = set(self._index)
            self._zf = None
        else:
            self._zf = zipfile.ZipFile(io.BytesIO(data))
            self._names = set(self._zf.namelist())
        self._meta: dict[str, dict] = {}
        if ".zmetadata" in self._names:
            consolidated = json.loads(self._read(".zmetadata"))
            for key, val in consolidated.get("metadata", {}).items():
                if key.endswith(".zarray"):
                    self._meta[key[: -len("/.zarray")]] = val
        else:
            for name in self._names:
                if name.endswith(".zarray"):
                    self._meta[name[: -len("/.zarray")]] = json.loads(
                        self._read(name)
                    )

    def _read(self, name: str) -> bytes:
        if self._index is not None:
            off, size = self._index[name]
            return self._data[off : off + size]
        return self._zf.read(name)

    def keys(self):
        return self._meta.keys()

    def __contains__(self, name: str) -> bool:
        return name in self._meta

    def __getitem__(self, name: str) -> np.ndarray:
        meta = self._meta[name]
        if meta.get("filters"):
            raise NotImplementedError("zarr filters are not supported")
        dtype = np.dtype(meta["dtype"])
        shape = tuple(meta["shape"])
        chunks = tuple(meta["chunks"])
        order = meta.get("order", "C")
        sep = meta.get("dimension_separator", ".")
        compressor = meta.get("compressor")
        fill = meta.get("fill_value", 0)

        if not shape:  # 0-d array
            key = f"{name}/0"
            raw = _decompress(self._read(key), compressor, dtype.itemsize)
            return np.frombuffer(raw, dtype)[0]

        grid = [-(-s // c) for s, c in zip(shape, chunks)]
        # Fast path: single whole-array chunk (the TerraMesh layout) —
        # decode straight into the output, no fill + copy.
        if all(g == 1 for g in grid) and tuple(chunks) == shape:
            key = f"{name}/{sep.join('0' for _ in shape)}"
            if key in self._names:
                nbytes = int(np.prod(shape)) * dtype.itemsize
                raw = _decompress(self._read(key), compressor, nbytes)
                arr = np.frombuffer(raw, dtype=dtype)
                return arr.reshape(shape, order="F" if order == "F" else "C")

        out = np.full(shape, fill if fill is not None else 0, dtype=dtype)
        for idx in np.ndindex(*grid):
            key = f"{name}/{sep.join(str(i) for i in idx)}"
            if key not in self._names:
                continue  # missing chunk → fill value
            nbytes = int(np.prod(chunks)) * dtype.itemsize
            raw = _decompress(self._read(key), compressor, nbytes)
            block = np.frombuffer(raw, dtype=dtype)
            block = block.reshape(chunks, order="F" if order == "F" else "C")
            slices = tuple(
                slice(i * c, min((i + 1) * c, s))
                for i, c, s in zip(idx, chunks, shape)
            )
            trims = tuple(slice(0, sl.stop - sl.start) for sl in slices)
            out[slices] = block[trims]
        return out

    def get(self, name: str, default: Any = None):
        return self[name] if name in self else default


def decode_zarr_zip_bands(
    data: bytes,
    *,
    harmonize_s2l2a: bool = False,
    cutoff_ns: int | None = None,
    dtype: np.dtype | None = np.float32,
) -> np.ndarray:
    """bytes → bands with optional S2L2A +1000 harmonization
    (the reference's terramesh.py).

    ``dtype=None`` preserves the stored dtype (int16 for S2 bands): the
    device_prep data path copies raw integers to the device at half the
    bytes and skips one full-array numpy cast pass per sample on the host
    (eovax_torch/data/device_prep.py casts on the device). A sample whose
    harmonization offset fires is promoted to fp32 (reference semantics
    add 1000.0 in float; integer overflow is not our problem to own)."""
    group = ZarrZipGroup(data)
    bands = (
        np.asarray(group["bands"])
        if dtype is None
        else np.asarray(group["bands"], dtype)
    )
    if harmonize_s2l2a and "time" in group:
        timestamp = np.asarray(group["time"]).reshape(-1)[0]
        if cutoff_ns is None:
            from eovax_torch.data.terramesh import S2L2A_BASELINE_CUTOFF_NS as cutoff_ns
        if int(timestamp) >= int(cutoff_ns):
            bands = np.asarray(bands, np.float32) + 1000.0
    return bands
