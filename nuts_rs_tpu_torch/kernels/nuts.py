"""NUTS draw options.

Port of ``nuts_rs_tpu/kernels/nuts.py::NutsOptions`` (``:62-78``).  The
draw-synchronous engine of that module (``nuts_draw``, ``:521``) is
queue-1 item 3 of ROADMAP.md and not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from ..dynamics.hamiltonian import KineticKind


@dataclasses.dataclass(frozen=True)
class NutsOptions:
    """Static draw options (nuts-rs ``src/nuts.rs:257-279``)."""

    maxdepth: int = 10
    mindepth: int = 0
    check_turning: bool = True
    max_energy_error: float = 1000.0
    extra_doublings: int = 0
    target_integration_time: Optional[float] = None
    kind: KineticKind = KineticKind.EUCLIDEAN
    store_divergences: bool = False
