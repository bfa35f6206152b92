"""Trace storage backends: in memory, CmdStan CSV and Apache Arrow (the
JAX package's ``storage`` without its Zarr backend, ROADMAP.md queue 1
item 9)."""
from .arrow import ArrowConfig
from .core import StorageConfig, TraceStorage
from .csv import CsvConfig
from .memory import MemoryConfig, MemoryStorage, Trace
