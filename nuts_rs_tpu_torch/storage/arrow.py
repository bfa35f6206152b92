"""Apache Arrow trace storage.

Port of ``nuts_rs_tpu/storage/arrow.py`` (numpy and pyarrow, a copy;
importing the JAX package's would import JAX).  pyarrow is imported under
a guard: without it ``ArrowConfig`` raises ``ImportError`` when a trace is
made.

Mirrors nuts-rs ``src/storage/arrow.rs``: one RecordBatch per chain with
scalar stats as primitive columns and tensor parameters as ``LargeList``
columns carrying their fixed shape in the field metadata
(``arrow.rs:23-291``).  Finalized result: a ``pyarrow.Table`` per group
(warmup / posterior) concatenated over chains, with ``chain`` and ``draw``
index columns.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np

try:
    import pyarrow as pa
except ImportError:  # pragma: no cover
    pa = None

from .core import StorageConfig, TraceStorage


class ArrowStorage(TraceStorage):
    def __init__(self, settings, model, num_chains: int):
        if pa is None:
            raise ImportError("pyarrow is required for ArrowConfig")
        self.num_chains = num_chains
        self._chunks: List[dict] = []
        self._tunings: List[np.ndarray] = []
        self._starts: List[int] = []

    def record_chunk(self, start_draw, stats, expanded, tuning):
        self._chunks.append({**{k: np.asarray(v) for k, v in stats.items()},
                             **{k: np.asarray(v) for k, v in expanded.items()}})
        self._tunings.append(np.asarray(tuning))
        self._starts.append(start_draw)

    def _table(self, warm: bool):
        names = list(self._chunks[0].keys())
        cols: Dict[str, list] = {"chain": [], "draw": []}
        for name in names:
            cols[name] = []
        for chunk, tuning, start in zip(self._chunks, self._tunings,
                                        self._starts):
            sel = tuning if warm else ~tuning
            idx = np.nonzero(sel)[0]
            if len(idx) == 0:
                continue
            k = len(idx)
            for c in range(self.num_chains):
                cols["chain"].append(np.full(k, c, np.int64))
                cols["draw"].append(start + idx)
                for name in names:
                    cols[name].append(chunk[name][c, idx])

        arrays = {}
        fields = []
        for name, parts in cols.items():
            if not parts:
                return None
            data = np.concatenate(parts, axis=0)
            if data.ndim == 1:
                arr = pa.array(data)
                field = pa.field(name, arr.type)
            else:
                shape = data.shape[1:]
                flat = data.reshape(data.shape[0], -1)
                arr = pa.FixedSizeListArray.from_arrays(
                    pa.array(flat.ravel()), flat.shape[1])
                field = pa.field(name, arr.type,
                                 metadata={b"shape": str(list(shape)).encode()})
            arrays[name] = arr
            fields.append(field)
        return pa.Table.from_arrays(list(arrays.values()),
                                    schema=pa.schema(fields))

    def finalize(self):
        return {
            "posterior": self._table(warm=False),
            "warmup": self._table(warm=True),
        }

    def inspect(self):
        return self.finalize()


@dataclasses.dataclass
class ArrowConfig(StorageConfig):
    def new_trace(self, settings, model, num_chains):
        return ArrowStorage(settings, model, num_chains)
