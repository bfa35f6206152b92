"""Minimal dependency-free Zarr v2 directory-store writer.

Port of ``nuts_rs_tpu/storage/zarr_format.py`` (numpy, zlib and the
optional ``zstandard`` and ``fsspec``; the same format byte for byte, so
either package reads what the other writes).

The reference writes ArviZ-compatible Zarr hierarchies through the ``zarrs``
crate (nuts-rs ``src/storage/zarr/``); this environment has no ``zarr``
Python package, so we emit the (simple, stable) Zarr v2 on-disk format
directly: per-group ``.zgroup``/``.zattrs`` JSON, per-array ``.zarray``
metadata, and C-order chunk files named ``i.j.k``, zlib-compressed
(readable by zarr-python with the standard ``zlib`` codec).

Paths containing ``://`` route through ``fsspec`` (``memory://``,
``s3://`` with s3fs installed, ...) — the object-store counterpart of the
reference's async zarr backend (``src/storage/zarr/async_impl.rs:33``,
which targets ``object_store``).  Remote stores use synchronous fsspec
writes; the native C++ async writer covers local filesystems.
"""

from __future__ import annotations

import json
import os
import zlib


def have_zstd() -> bool:
    """True when the optional ``zstandard`` package is importable."""
    try:
        import zstandard  # noqa: F401
    except ImportError:
        return False
    return True


def default_codec() -> str:
    """Zstd when available (the reference's Blosc-Zstd counterpart,
    src/storage/zarr/common.rs:310-331), else the stdlib zlib codec —
    ``zstandard`` is an optional dependency (`pip install zstandard`)
    and a default must never make writes crash on a minimal install."""
    return "zstd" if have_zstd() else "zlib"


def _zstd_or_raise():
    try:
        import zstandard
    except ImportError as e:
        raise ImportError(
            "the 'zstd' Zarr codec needs the optional 'zstandard' package "
            "(pip install zstandard); write-side, codec='zlib' is the "
            "dependency-free alternative") from e
    return zstandard


def _compress(raw: bytes, codec: str) -> bytes:
    if codec == "zstd":
        return _zstd_or_raise().ZstdCompressor(level=1).compress(raw)
    return zlib.compress(raw, 1)


def _decompress(raw: bytes, codec: str) -> bytes:
    if codec == "zstd":
        return _zstd_or_raise().ZstdDecompressor().decompress(raw)
    return zlib.decompress(raw)


def _byte_shuffle(raw: bytes, itemsize: int) -> bytes:
    """numcodecs-``shuffle``-compatible byte transpose: output block j holds
    byte j of every element.  The reference's Blosc-Zstd applies the same
    shuffle pass before Zstd (src/storage/zarr/common.rs:310-331) — it groups
    the slowly-varying exponent/sign bytes of float draws together, which
    improves the compression ratio markedly on smooth chains."""
    a = np.frombuffer(raw, np.uint8).reshape(-1, itemsize)
    return np.ascontiguousarray(a.T).tobytes()


def _byte_unshuffle(raw: bytes, itemsize: int) -> bytes:
    a = np.frombuffer(raw, np.uint8).reshape(itemsize, -1)
    return np.ascontiguousarray(a.T).tobytes()
from typing import Any, Mapping, Optional, Sequence

import numpy as np


def is_url_path(path: str) -> bool:
    return "://" in path


def _join(base: str, *parts: str) -> str:
    if is_url_path(base):
        return "/".join([base.rstrip("/")] + [p.strip("/") for p in parts])
    return os.path.join(base, *parts)


def _fsspec():
    try:
        import fsspec
    except ImportError as e:
        raise ImportError(
            "a Zarr path with '://' is an fsspec URL, and the 'fsspec' "
            "package is not installed; write to a local directory path, or "
            "install fsspec (and the protocol's driver, e.g. s3fs)") from e
    return fsspec


def _fs(path: str):
    fsspec = _fsspec()

    fs, root = fsspec.core.url_to_fs(path)
    return fs, root


def _makedirs(path: str) -> None:
    if is_url_path(path):
        fs, root = _fs(path)
        fs.makedirs(root, exist_ok=True)
    else:
        os.makedirs(path, exist_ok=True)


def _open(path: str, mode: str = "r"):
    if is_url_path(path):
        return _fsspec().open(path, mode).open()
    return open(path, mode)


def _exists(path: str) -> bool:
    if is_url_path(path):
        fs, root = _fs(path)
        return fs.exists(root)
    return os.path.exists(path)

_DTYPE_MAP = {
    np.dtype("float64"): "<f8",
    np.dtype("float32"): "<f4",
    np.dtype("float16"): "<f2",
    np.dtype("int64"): "<i8",
    np.dtype("int32"): "<i4",
    np.dtype("int16"): "<i2",
    np.dtype("int8"): "|i1",
    np.dtype("uint64"): "<u8",
    np.dtype("uint32"): "<u4",
    np.dtype("bool"): "|b1",
}


def _dtype_str(dtype: np.dtype) -> str:
    if dtype in _DTYPE_MAP:
        return _DTYPE_MAP[dtype]
    if dtype.kind == "U":  # fixed-length unicode (string coords,
        # nuts-rs src/storage/zarr/common.rs:26-58 stores string coordinate
        # arrays; zarr-python reads "<U{n}" natively)
        return f"<U{dtype.itemsize // 4}"
    if dtype.kind in "Mm":
        # datetime64 / timedelta64 expanded values (nuts-storable
        # Value::DateTime64/TimeDelta64, nuts-storable/src/lib.rs:5-92);
        # numpy's dtype.str is already the zarr v2 form, e.g. "<M8[ns]".
        return dtype.str
    raise TypeError(f"unsupported dtype {dtype}")


def _fill_value(dtype: np.dtype):
    if dtype.kind == "f":
        return "NaN"
    if dtype.kind == "b":
        return False
    if dtype.kind == "U":
        return ""
    return 0


class ZarrGroup:
    def __init__(self, path: str, attrs: Optional[Mapping[str, Any]] = None):
        self.path = path
        _makedirs(path)
        with _open(_join(path, ".zgroup"), "w") as f:
            json.dump({"zarr_format": 2}, f)
        if attrs:
            self.write_attrs(attrs)

    def write_attrs(self, attrs: Mapping[str, Any]):
        with _open(_join(self.path, ".zattrs"), "w") as f:
            json.dump(dict(attrs), f, default=str)

    def group(self, name: str, attrs=None) -> "ZarrGroup":
        return ZarrGroup(_join(self.path, name), attrs)

    def array(self, name: str, shape, chunks, dtype,
              dims: Optional[Sequence[str]] = None,
              attrs: Optional[Mapping[str, Any]] = None,
              compress: bool = True, writer=None,
              codec: str = "zlib", shuffle: bool = False) -> "ZarrArray":
        return ZarrArray(_join(self.path, name), shape, chunks, dtype,
                         dims=dims, attrs=attrs, compress=compress,
                         writer=writer, codec=codec, shuffle=shuffle)

    def write_full_array(self, name: str, data: np.ndarray,
                         dims: Optional[Sequence[str]] = None):
        data = np.ascontiguousarray(data)
        arr = self.array(name, data.shape, data.shape or (1,), data.dtype,
                         dims=dims)
        if data.ndim == 0:
            data = data[None]
        arr.write_chunk((0,) * data.ndim, data)
        return arr


class ZarrArray:
    def __init__(self, path, shape, chunks, dtype, dims=None, attrs=None,
                 compress=True, writer=None, codec="zlib", shuffle=False):
        self.path = path
        self.writer = writer  # optional native AsyncTraceWriter
        self.shape = tuple(int(s) for s in shape)
        self.chunks = tuple(int(c) for c in chunks)
        self.dtype = np.dtype(dtype)
        self.compress = compress
        # "zlib" | "zstd" (the reference ships Blosc-Zstd,
        # src/storage/zarr/common.rs:310-331; plain numcodecs-"zstd" here —
        # both ArviZ/zarr-python readable).  zstd compresses trace floats
        # ~2x faster at similar ratio (level 1).
        self.codec = codec
        # Blosc-style byte shuffle before compression, declared as the
        # standard numcodecs "shuffle" filter (zarr-python readable).
        # Meaningless for 1-byte dtypes and uncompressed arrays.
        self.shuffle = bool(shuffle) and compress and self.dtype.itemsize > 1
        _makedirs(path)
        self._write_meta()
        zattrs = dict(attrs or {})
        if dims is not None:
            # xarray convention used by ArviZ readers.
            zattrs["_ARRAY_DIMENSIONS"] = list(dims)
        if zattrs:
            with _open(_join(path, ".zattrs"), "w") as f:
                json.dump(zattrs, f, default=str)

    def _write_meta(self):
        meta = {
            "zarr_format": 2,
            "shape": list(self.shape),
            "chunks": list(self.chunks),
            "dtype": _dtype_str(self.dtype),
            "compressor": ({"id": self.codec, "level": 1}
                           if self.compress else None),
            "fill_value": _fill_value(self.dtype),
            "order": "C",
            "filters": ([{"id": "shuffle",
                          "elementsize": self.dtype.itemsize}]
                        if self.shuffle else None),
        }
        with _open(_join(self.path, ".zarray"), "w") as f:
            json.dump(meta, f)

    def resize(self, new_shape):
        self.shape = tuple(int(s) for s in new_shape)
        self._write_meta()

    def write_chunk(self, chunk_index: Sequence[int], data: np.ndarray):
        """Write one chunk; ``data`` may be smaller than the chunk shape at
        the trailing edge and is zero/NaN-padded to the full chunk."""
        data = np.ascontiguousarray(data, dtype=self.dtype)
        if data.shape != self.chunks:
            pad = np.full(self.chunks,
                          np.nan if self.dtype.kind == "f" else 0,
                          dtype=self.dtype)
            pad[tuple(slice(0, s) for s in data.shape)] = data
            data = pad
        raw = data.tobytes(order="C")
        if self.shuffle:
            raw = _byte_shuffle(raw, self.dtype.itemsize)
        name = ".".join(str(int(i)) for i in chunk_index)
        target = _join(self.path, name)
        if self.writer is not None:
            if (self.compress and self.codec == "zstd"
                    and not getattr(self.writer, "supports_zstd", True)):
                # NO_ZSTD fallback build of the native writer: compress
                # Python-side, keep the async I/O path.
                self.writer.write_raw(target, _compress(raw, self.codec))
                return
            # Compression + I/O happen on the native worker threads.
            self.writer.write(target, raw, 1 if self.compress else -1,
                              codec=self.codec)
            return
        if self.compress:
            raw = _compress(raw, self.codec)
        with _open(target, "wb") as f:
            f.write(raw)


def read_array(path: str) -> np.ndarray:
    """Read back a full Zarr v2 array (for tests / inspect)."""
    with _open(_join(path, ".zarray")) as f:
        meta = json.load(f)
    shape = tuple(meta["shape"])
    chunks = tuple(meta["chunks"])
    dtype = np.dtype(meta["dtype"])
    fill = meta["fill_value"]
    if fill == "NaN":
        fill = np.nan
    out = np.full(shape, fill, dtype=dtype)
    if out.size == 0:
        return out
    grid = [max(1, -(-s // c)) for s, c in zip(shape, chunks)]

    def rec(idx):
        if len(idx) == len(grid):
            name = ".".join(map(str, idx))
            fp = _join(path, name)
            if not _exists(fp):
                return
            with _open(fp, "rb") as _f:
                raw = _f.read()
            if meta["compressor"] is not None:
                raw = _decompress(raw, meta["compressor"]["id"])
            for filt in reversed(meta.get("filters") or []):
                if filt.get("id") == "shuffle":
                    raw = _byte_unshuffle(raw, filt["elementsize"])
            block = np.frombuffer(raw, dtype=dtype).reshape(chunks)
            sel = tuple(slice(i * c, min((i + 1) * c, s))
                        for i, c, s in zip(idx, chunks, shape))
            out[sel] = block[tuple(slice(0, sl.stop - sl.start) for sl in sel)]
            return
        for i in range(grid[len(idx)]):
            rec(idx + (i,))

    rec(())
    return out


def read_attrs(path: str) -> dict:
    fp = _join(path, ".zattrs")
    if not _exists(fp):
        return {}
    with _open(fp) as f:
        return json.load(f)
