"""CmdStan-compatible CSV trace storage.

Port of ``nuts_rs_tpu/storage/csv.py`` (numpy only, a copy; importing the
JAX package's would import JAX).

Mirrors nuts-rs ``src/storage/csv.rs``: one ``chain_{id}.csv`` per chain,
cartesian-product column naming for tensor parameters
(``csv.rs:434-577``, CmdStan style ``name.1.2`` with 1-based indices), and
warmup rows marked by negative ``sample_id`` (``csv.rs:19-24``).
"""

from __future__ import annotations

import dataclasses
import itertools
import os
from typing import Dict, List, TextIO

import numpy as np

from .core import StorageConfig, TraceStorage

_SCALAR_STATS = [
    "diverging", "depth", "maxdepth_reached", "n_steps", "step_size",
    "step_size_bar", "mean_tree_accept", "mean_tree_accept_sym",
    "max_energy_error", "logp", "energy", "energy_error",
    "index_in_trajectory", "fisher_distance", "transformation_index",
    "num_steps", "energy_change", "log_weight", "average_step_size",
]


def _tensor_columns(name: str, shape) -> List[str]:
    if not shape:
        return [name]
    return [
        name + "." + ".".join(str(i + 1) for i in idx)
        for idx in itertools.product(*(range(s) for s in shape))
    ]


class CsvStorage(TraceStorage):
    def __init__(self, directory: str, settings, model, num_chains: int):
        self.dir = directory
        os.makedirs(directory, exist_ok=True)
        self.num_chains = num_chains
        self.num_tune = getattr(settings, "num_tune", 0)
        self._files: List[TextIO] = []
        self._header: List[str] | None = None
        self._draw_counts = [0] * num_chains
        for c in range(num_chains):
            self._files.append(
                open(os.path.join(directory, f"chain_{c}.csv"), "w"))

    def _build_header(self, stats, expanded):
        cols = ["sample_id"]
        self._layout = []
        for name in _SCALAR_STATS:
            if name in stats and np.asarray(stats[name]).ndim == 2:
                cols.append(name)
                self._layout.append(("stats", name, ()))
        for source, d in (("stats", {"position": stats.get("position")}),
                          ("expanded", expanded)):
            for name, arr in d.items():
                if arr is None:
                    continue
                arr = np.asarray(arr)
                shape = arr.shape[2:]
                cols.extend(_tensor_columns(name, shape))
                self._layout.append((source, name, shape))
        self._header = cols
        for f in self._files:
            f.write(",".join(cols) + "\n")

    def record_chunk(self, start_draw, stats, expanded, tuning):
        if self._header is None:
            self._build_header(stats, expanded)
        tuning = np.asarray(tuning)
        k = len(tuning)
        for c in range(self.num_chains):
            f = self._files[c]
            for j in range(k):
                draw = start_draw + j
                # Warmup rows get negative ids, posterior rows count from 0
                # (csv.rs:19-24) — one expression covers both.
                sid = draw - self.num_tune
                row = [str(sid)]
                for source, name, shape in self._layout:
                    arr = stats.get(name) if source == "stats" else expanded.get(name)
                    v = np.asarray(arr)[c, j]
                    if shape:
                        row.extend(f"{x:.17g}" for x in np.ravel(v))
                    else:
                        if v.dtype.kind == "b":
                            row.append(str(int(v)))
                        elif v.dtype.kind in "iu":
                            row.append(str(int(v)))
                        else:
                            row.append(f"{float(v):.17g}")
                f.write(",".join(row) + "\n")
            self._draw_counts[c] += k

    def finalize(self):
        for f in self._files:
            f.close()
        return self.dir

    def flush(self):
        for f in self._files:
            f.flush()

    def inspect(self):
        # Reference behavior: CSV inspection flushes but produces no
        # finalized snapshot (csv.rs:350-354 returns Ok(None)).
        self.flush()
        return None


@dataclasses.dataclass
class CsvConfig(StorageConfig):
    directory: str

    def new_trace(self, settings, model, num_chains):
        return CsvStorage(self.directory, settings, model, num_chains)
