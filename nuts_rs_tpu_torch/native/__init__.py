"""Native (C++) host runtime of the port, loaded with ctypes: the async
Zarr chunk writer (``trace_writer.cpp``, a copy of the JAX package's; the
nuts-rs ``src/storage/zarr/async_impl.rs`` analog), built with g++ at first
use into ``nuts_rs_tpu_torch/_build/``."""

from .writer import AsyncTraceWriter, WriterBuildError

__all__ = ["AsyncTraceWriter", "WriterBuildError"]
