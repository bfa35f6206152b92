"""Backend-agnostic trace storage interfaces.

Port of ``nuts_rs_tpu/storage/core.py`` (numpy only, the same in
substance; importing the JAX package's copy would import JAX).

Mirrors nuts-rs ``src/storage/core.rs``: a ``StorageConfig`` creates a
``TraceStorage`` which accepts progressive writes and is finalized into a
backend-specific result.  The TPU sampler produces draws in *chunks* (one
device->host transfer per scan chunk, all chains at once) rather than one draw
at a time, so the write granularity here is a chunk: ``record_chunk`` receives
``{name: array[chains, draws_in_chunk, ...]}``.

Sparse event streams (divergence details, transformation updates; see
nuts-storable ``src/lib.rs:101-118``) are compacted host-side by the backends
from the dense per-draw arrays.
"""

from __future__ import annotations

import abc
from typing import Any, Mapping

import numpy as np


def dims_for_tail(model, name, tail_shape):
    """xarray dimension names for a stat's trailing axes (after
    [chain, draw]): the model's declared dims win, a tail matching the
    parameter count is ``unconstrained_parameter`` (reference StatsDims,
    src/sampler_stats.rs:10-42), anything else gets positional names."""
    model_dims = dict(getattr(model, "dims", None) or {})
    if name in model_dims:
        return list(model_dims[name])
    tail_shape = tuple(tail_shape)
    if not tail_shape:
        return []
    if tail_shape == (getattr(model, "dim", -1),):
        return ["unconstrained_parameter"]
    return [f"{name}_dim_{i}" for i in range(len(tail_shape))]


class TraceStorage(abc.ABC):
    """Progressive multi-chain trace writer."""

    # Backends that create their full array hierarchy upfront from the
    # reflected schema (reference: Settings reflects every stat
    # name/type/dims BEFORE sampling, src/sampler.rs:73-162) set this True;
    # the sampler then calls declare_schema before the first chunk.
    wants_schema = False

    def declare_schema(self, schema) -> None:
        """Create storage for every name in ``schema`` upfront (see
        ``Sampler.schema`` for the layout).  Default: no-op."""

    @abc.abstractmethod
    def record_chunk(
        self,
        start_draw: int,
        stats: Mapping[str, np.ndarray],
        expanded: Mapping[str, np.ndarray],
        tuning: np.ndarray,
    ) -> None:
        """Append a chunk of draws.

        ``stats[name]`` and ``expanded[name]`` (the model's expansions,
        stored beside the positions) have shape ``[chains, k, ...]``;
        ``tuning`` is a bool array of length ``k`` marking warmup draws.
        """

    @abc.abstractmethod
    def finalize(self) -> Any:
        """Close the trace and return the backend-specific result."""

    def flush(self) -> None:
        """Force buffered data out (nuts-rs ``ChainStorage::flush``)."""

    def inspect(self) -> Any:
        """Readable snapshot of the live trace (nuts-rs ``inspect``)."""
        return None


class StorageConfig(abc.ABC):
    @abc.abstractmethod
    def new_trace(self, settings, model, num_chains: int) -> TraceStorage:
        ...
