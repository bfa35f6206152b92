"""nuts_rs_tpu_torch — the PyTorch/CUDA port of nuts_rs_tpu.

A second package beside the JAX one (``nuts_rs_tpu``, the reference), for one
NVIDIA H100.  It runs ``DiagNutsSettings`` and ``DiagMclmcSettings`` with
``posterior_kernel="pallas"`` on a model with a kernel hook: warmup and
posterior of each run on hand-written CUDA kernels (``csrc/``: NUTS at
small, mid and large d, with a model's data read inside the kernel or
streamed, MCLMC, and NUTS through a frozen coupling flow) for CUDA tensors,
and on their plain PyTorch versions for CPU tensors; ``FlowNutsSettings``
warms up on the per-draw sync engine with the flow's refits.  The per-draw
sync engines (``posterior_kernel="sync"``: NUTS with any tree option and
kinetic energy, MCLMC) run any model, and take the extra stores, the
low-rank presets (``LowRankNutsSettings``, ``LowRankMclmcSettings``),
cross-chain adaptation and what else the fused kernels lack, as the JAX
package plans it.  The package
imports torch, numpy and scipy and never JAX.  The ``Sampler``'s control
surface is the JAX package's: pause / resume, ``wait_timeout``, ``abort``,
progress callbacks, checkpoints, the stuck-chain detector
(``ChainFailedError``), ``ConvergenceStop`` over the copied diagnostics,
``sample_sequentially``, the model's expansions, ``dtype``,
``max_chains_per_launch``, ``profile_dir``, ``auto_recover`` and the
memory, CSV, Arrow and Zarr storage backends, with ``run()`` pipelined.  What is not ported yet raises
``NotImplementedError`` naming its ROADMAP.md item.
"""

from .adapt.flow import FlowAdaptSettings
from .adapt.low_rank import LowRankSettings
from .adapt.schedule import AdaptScheduleOptions
from .adapt.step_size import (
    AdamOptions,
    DualAverageOptions,
    StepSizeMethod,
    StepSizeSettings,
)
from .convert import state_from_numpy, state_to_numpy
from .diagnostics import ess_bulk, ess_tail, split_rhat, summary
from .dynamics.hamiltonian import KineticKind
from .flows.coupling import CouplingFlowConfig, coupling_flow, diag_affine_flow
from .kernels.nuts import NutsOptions
from .models.model import Model
from .kernels.mclmc import MclmcOptions
from .sampler import (
    ChainFailedError,
    ChainProgress,
    ConvergenceStop,
    DeviceLostError,
    DiagMclmcSettings,
    DiagNutsSettings,
    FlowMclmcSettings,
    FlowNutsSettings,
    LowRankMclmcSettings,
    LowRankNutsSettings,
    MclmcSettings,
    MclmcTrajectoryKind,
    NutsSettings,
    Sampler,
    sample,
    sample_sequentially,
    schema,
)
from .storage.arrow import ArrowConfig
from .storage.csv import CsvConfig
from .storage.memory import MemoryConfig, Trace
from .storage.zarr import ZarrConfig
from .kernels.nuts import DivergenceInfo

# Reference-name aliases, as the JAX package has them
# (``nuts_rs_tpu/__init__.py:48-62``): each maps to the closest concept
# here, and the aliased class is the implementation, not a shim.
# src/lib.rs:115-153 of nuts-rs is the reference export list.
KineticEnergyKind = KineticKind            # sampler.rs KineticEnergyKind
StepSizeAdaptMethod = StepSizeMethod       # stepsize/ StepSizeAdaptMethod
FlowSettings = FlowAdaptSettings           # external_adapt_strategy.rs
# its nested fields are not taken: see AdaptScheduleOptions' docstring
EuclideanAdaptOptions = AdaptScheduleOptions
# the reference's HashMap and Ndarray backends both keep everything in host
# memory; MemoryConfig is that backend here
HashMapConfig = MemoryConfig
NdarrayConfig = MemoryConfig

__version__ = "0.1.0"

__all__ = [
    "AdamOptions",
    "AdaptScheduleOptions",
    "ArrowConfig",
    "ChainFailedError",
    "ChainProgress",
    "ConvergenceStop",
    "CouplingFlowConfig",
    "CsvConfig",
    "DeviceLostError",
    "DiagMclmcSettings",
    "DiagNutsSettings",
    "DualAverageOptions",
    "FlowAdaptSettings",
    "FlowMclmcSettings",
    "FlowNutsSettings",
    "KineticKind",
    "LowRankMclmcSettings",
    "LowRankNutsSettings",
    "LowRankSettings",
    "MclmcOptions",
    "MclmcSettings",
    "MclmcTrajectoryKind",
    "MemoryConfig",
    "Model",
    "NutsOptions",
    "NutsSettings",
    "Sampler",
    "StepSizeMethod",
    "StepSizeSettings",
    "Trace",
    "coupling_flow",
    "diag_affine_flow",
    "ess_bulk",
    "ess_tail",
    "sample",
    "sample_sequentially",
    "schema",
    "split_rhat",
    "state_from_numpy",
    "state_to_numpy",
    "summary",
    "ZarrConfig",
    # reference-name aliases (see the alias block above)
    "DivergenceInfo",
    "KineticEnergyKind",
    "StepSizeAdaptMethod",
    "FlowSettings",
    "EuclideanAdaptOptions",
    "HashMapConfig",
    "NdarrayConfig",
]
