"""MCLMC draw options.

Port of ``nuts_rs_tpu/kernels/mclmc.py``: ``MAX_HALVINGS`` (``:39``) and
``MclmcOptions`` (``:42-51``), with the per-draw stat names of the fused
kernels (``kernels/mclmc_pallas.py:50-53``).  The draw-synchronous engine of
that module (``mclmc_draw``, ``:84``) goes with the sync engines, queue-1
item 8 of ROADMAP.md, and is not ported yet.
"""

from __future__ import annotations

import dataclasses

from ..dynamics.hamiltonian import KineticKind

MAX_HALVINGS = 10

# per-draw stat rows of the fused MCLMC kernels, in the Pallas order
STAT_NAMES = [
    "diverging", "n_steps", "energy_change", "average_step_size",
    "step_size", "logp", "energy", "fisher_distance",
]


@dataclasses.dataclass(frozen=True)
class MclmcOptions:
    """Static per-run options (nuts-rs ``MclmcSettings``, sampler.rs:268-318)."""

    momentum_decoherence_length: float = 3.0
    subsample_frequency: float = 1.0
    dynamic_step_size: bool = True
    max_energy_error: float = 1000.0
    kind: KineticKind = KineticKind.MICROCANONICAL
    store_divergences: bool = False
