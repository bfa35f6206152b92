"""ctypes bindings and the on-demand build of the native async trace writer.

Port of ``nuts_rs_tpu/native/writer.py``.  ``trace_writer.cpp`` (a copy of
the JAX package's) is built with ``g++`` at first use into
``nuts_rs_tpu_torch/_build/`` (git-ignored, beside the CUDA libraries),
never into the package directory: linked with libzstd where the host has
it, else with ``-DNO_ZSTD`` (zlib only; zstd chunks are then compressed in
Python and handed over raw).  A build that fails raises
:class:`WriterBuildError` with the compiler's stderr: the port never falls
back to synchronous writes without a word (``ZarrConfig(async_writes=
False)`` is the explicit way to write synchronously).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "trace_writer.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
_LIB = os.path.join(BUILD_DIR, "trace_writer.so")

_lock = threading.Lock()
_lib = None


class WriterBuildError(RuntimeError):
    """``g++`` could not build the native trace writer; the message holds
    the compiler's stderr."""


def _build(src: str, lib: str) -> bool:
    """Build ``src`` into ``lib``; True where libzstd was linked."""
    os.makedirs(os.path.dirname(lib), exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    base = ["g++", "-O2", "-shared", "-fPIC", "-std=c++17", "-pthread", src,
            "-o", tmp, "-lz"]
    errors = []
    for extra, has_zstd in ((["-lzstd"], True), (["-DNO_ZSTD"], False)):
        try:
            proc = subprocess.run(base + extra, capture_output=True,
                                  text=True)
        except OSError as e:  # no g++ at all
            raise WriterBuildError(
                f"native trace writer: cannot run g++ ({e})") from e
        if proc.returncode == 0:
            os.replace(tmp, lib)
            return has_zstd
        errors.append(f"$ {' '.join(base + extra)}\n{proc.stderr.strip()}")
    raise WriterBuildError(
        "native trace writer: the g++ build failed (pass "
        "ZarrConfig(async_writes=False) to write synchronously):\n"
        + "\n".join(errors))


def load(src: str = _SRC, lib: str = _LIB):
    """The loaded library (``has_zstd``: linked with libzstd), built first
    where it is missing or older than its source; the package's own is
    loaded once."""
    global _lib
    with _lock:
        if _lib is not None and src == _SRC and lib == _LIB:
            return _lib
        # present beside a -DNO_ZSTD build
        mark = lib + ".nozstd"
        if (not os.path.exists(lib)
                or os.path.getmtime(lib) < os.path.getmtime(src)):
            has_zstd = _build(src, lib)
            if has_zstd and os.path.exists(mark):
                os.remove(mark)
            elif not has_zstd:
                open(mark, "w").close()
        else:
            has_zstd = not os.path.exists(mark)
        handle = ctypes.CDLL(lib)
        handle.tw_create.restype = ctypes.c_void_p
        handle.tw_create.argtypes = [ctypes.c_size_t, ctypes.c_int]
        handle.tw_write.restype = None
        handle.tw_write.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                    ctypes.c_void_p, ctypes.c_size_t,
                                    ctypes.c_int]
        handle.tw_write2.restype = None
        handle.tw_write2.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                     ctypes.c_void_p, ctypes.c_size_t,
                                     ctypes.c_int, ctypes.c_int]
        handle.tw_flush.restype = None
        handle.tw_flush.argtypes = [ctypes.c_void_p]
        handle.tw_error.restype = ctypes.c_char_p
        handle.tw_error.argtypes = [ctypes.c_void_p]
        handle.tw_destroy.restype = None
        handle.tw_destroy.argtypes = [ctypes.c_void_p]
        handle.has_zstd = has_zstd
        if src == _SRC and lib == _LIB:
            _lib = handle
        return handle


class AsyncTraceWriter:
    """Bounded-queue async file writer backed by the C++ worker pool.

    ``write(path, data, compress_level)`` enqueues and returns at once; it
    blocks only when ``max_queue`` chunks are already in flight
    (backpressure, as nuts-rs ``async_impl.rs:365-400``).  Raises
    :class:`WriterBuildError` where the library cannot be built.
    """

    def __init__(self, max_queue: int = 64, n_threads: int = 2):
        lib = load()
        self._lib = lib
        self._handle = lib.tw_create(max_queue, n_threads)
        # False on the NO_ZSTD build: callers compress zstd payloads in
        # Python and use write_raw (see storage/zarr_format.py)
        self.supports_zstd = lib.has_zstd

    def _live_handle(self):
        # a NULL handle would be dereferenced by the C side (a segfault,
        # not an exception): guard every entry point after close()
        h = self._handle
        if h is None:
            raise RuntimeError("AsyncTraceWriter used after close()")
        return h

    def write(self, path: str, data: bytes, compress_level: int = 1,
              codec: str = "zlib") -> None:
        self._lib.tw_write2(self._live_handle(), path.encode(), data,
                            len(data), compress_level,
                            1 if codec == "zstd" else 0)

    def write_raw(self, path: str, data: bytes) -> None:
        self._lib.tw_write(self._live_handle(), path.encode(), data,
                           len(data), -1)

    def flush(self) -> None:
        h = self._live_handle()
        self._lib.tw_flush(h)
        err = self._lib.tw_error(h)
        if err:
            raise IOError(err.decode())

    def close(self) -> None:
        if self._handle is not None:
            try:
                self.flush()
            finally:
                # destroy even when flush raises: a latched writer error
                # must not leave a handle that invites reuse
                self._lib.tw_destroy(self._handle)
                self._handle = None

    def __del__(self):
        try:
            if getattr(self, "_handle", None) is not None:
                self._lib.tw_destroy(self._handle)
                self._handle = None
        except Exception:
            pass
