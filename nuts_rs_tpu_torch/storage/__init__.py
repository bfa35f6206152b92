"""Trace storage backends: in memory, CmdStan CSV, Apache Arrow and Zarr
(the JAX package's ``storage``)."""
from .arrow import ArrowConfig
from .core import StorageConfig, TraceStorage
from .csv import CsvConfig
from .memory import MemoryConfig, MemoryStorage, Trace
from .zarr import ZarrConfig, ZarrStorage
