"""In-memory trace storage (nuts-rs HashMap + ndarray backends,
``src/storage/hashmap.rs``, ``src/storage/ndarray.rs``).

Port of ``nuts_rs_tpu/storage/memory.py`` (numpy only, the same in
substance; importing the JAX package's copy would import JAX).

Accumulates chunks and finalizes into a :class:`Trace` with xarray-free
ArviZ-style groups: ``posterior``, ``sample_stats``, ``warmup_posterior``,
``warmup_sample_stats`` — each a dict of arrays shaped ``[chain, draw, ...]``
(a phase that stored no draw, as with ``store_warmup=False``, holds arrays
of no draws, as the JAX package's) — plus compacted sparse event streams
(divergences, transformation updates, with the transform at each update
where ``store_mass_matrix`` stored it).  The model's expansions are stored
beside the positions, in the two posterior groups
(``nuts_rs_tpu/storage/memory.py:46-133``); :meth:`MemoryStorage.inspect`
assembles what was recorded so far without finalizing.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Mapping, Optional

import numpy as np

from .core import StorageConfig, TraceStorage

# Stats that describe the drawn sample itself and go to ``posterior``-adjacent
# groups; everything else is a sampler statistic.
_POSTERIOR_KEYS = ("position",)


@dataclasses.dataclass
class Trace:
    """Finalized in-memory trace."""

    posterior: Dict[str, np.ndarray]
    sample_stats: Dict[str, np.ndarray]
    warmup_posterior: Dict[str, np.ndarray]
    warmup_sample_stats: Dict[str, np.ndarray]
    transformation_updates: List[Dict[str, np.ndarray]]
    settings: Any = None
    coords: Optional[Mapping[str, Any]] = None
    dims: Optional[Mapping[str, Any]] = None

    @property
    def divergent_draws(self) -> List[np.ndarray]:
        div = np.concatenate(
            [self.warmup_sample_stats["diverging"], self.sample_stats["diverging"]],
            axis=1)
        return [np.nonzero(div[c])[0] for c in range(div.shape[0])]


class MemoryStorage(TraceStorage):
    def __init__(self, settings=None, model=None, num_chains: int = 0):
        self._chunks: List[Mapping[str, np.ndarray]] = []
        self._expanded_chunks: List[Mapping[str, np.ndarray]] = []
        self._tuning: List[np.ndarray] = []
        self._settings = settings
        self._model = model

    def record_chunk(self, start_draw, stats, expanded, tuning):
        self._chunks.append({k: np.asarray(v) for k, v in stats.items()})
        self._expanded_chunks.append(
            {k: np.asarray(v) for k, v in expanded.items()})
        self._tuning.append(np.asarray(tuning))

    def finalize(self) -> Trace:
        if not self._chunks:
            # num_tune = num_draws = 0, or a failing run that stored nothing
            # (store_warmup=False and every chain failed in the warmup): an
            # empty trace, not a storage exception in the ChainFailedError's
            # way
            return Trace(
                posterior={}, sample_stats={}, warmup_posterior={},
                warmup_sample_stats={}, transformation_updates=[],
                settings=self._settings,
                coords=getattr(self._model, "coords", None),
                dims=getattr(self._model, "dims", None))
        tuning = self._tuning
        names = list(self._chunks[0])

        def part(chunks, name, want_tuning):
            """One group's array: the chunks' draws of that phase, joined
            once.  A chunk that lies wholly in the phase (every chunk does
            when chunks end at the phase boundary) is joined as it is, so
            the trace is the only copy made of a large posterior."""
            pieces = []
            for chunk, t in zip(chunks, tuning):
                keep = t if want_tuning else ~t
                if keep.all():
                    pieces.append(chunk[name])
                elif keep.any():
                    pieces.append(chunk[name][:, keep])
            if not pieces:
                first = chunks[0][name]
                return first[:, :0]
            return np.concatenate(pieces, axis=1)

        ids = (np.concatenate([c["transformation_index"]
                               for c in self._chunks], axis=1)
               if "transformation_index" in names else None)
        stat_names = [k for k in names if k not in _POSTERIOR_KEYS]
        exp_names = list(self._expanded_chunks[0])

        def posterior(want_tuning):
            out = {"position": part(self._chunks, "position", want_tuning)}
            out.update({k: part(self._expanded_chunks, k, want_tuning)
                        for k in exp_names})
            return out

        warm_post, post_post = posterior(True), posterior(False)
        warm_stats = {k: part(self._chunks, k, True) for k in stat_names}
        post_stats = {k: part(self._chunks, k, False) for k in stat_names}

        # Compact transformation-update events from the id stream.
        updates: List[Dict[str, np.ndarray]] = []
        if ids is not None:
            n_chains = ids.shape[0]
            for c in range(n_chains):
                prev = np.concatenate([[np.int64(-(10 ** 9))], ids[c][:-1]])
                ev = np.nonzero(ids[c] != prev)[0]
                rec = {"draw": ev, "transformation_update_id": ids[c][ev]}
                # the transform at each update (store_mass_matrix)
                for name in ("mass_matrix_inv", "transformation_mu"):
                    if name in names:
                        rec[name] = np.concatenate(
                            [ch[name][c] for ch in self._chunks])[ev]
                updates.append(rec)

        model = self._model
        return Trace(
            posterior=post_post,
            sample_stats=post_stats,
            warmup_posterior=warm_post,
            warmup_sample_stats=warm_stats,
            transformation_updates=updates,
            settings=self._settings,
            coords=getattr(model, "coords", None),
            dims=getattr(model, "dims", None),
        )

    def inspect(self) -> Trace:
        return self.finalize()


class MemoryConfig(StorageConfig):
    def new_trace(self, settings, model, num_chains):
        return MemoryStorage(settings, model, num_chains)
