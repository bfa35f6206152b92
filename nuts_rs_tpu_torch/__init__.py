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
kinetic energy, MCLMC) run any model, and take the extra stores and what
the fused kernels lack, as the JAX package plans it.  The package
imports torch, numpy and scipy and never JAX.  The ``Sampler``'s control
surface is the JAX package's: pause / resume, ``wait_timeout``, ``abort``,
progress callbacks, checkpoints, the stuck-chain detector
(``ChainFailedError``), ``ConvergenceStop`` over the copied diagnostics,
``sample_sequentially``, the model's expansions and the memory, CSV and
Arrow storage backends.  What is not ported yet raises
``NotImplementedError`` naming its ROADMAP.md item.
"""

from .adapt.flow import FlowAdaptSettings
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
    DiagMclmcSettings,
    DiagNutsSettings,
    FlowMclmcSettings,
    FlowNutsSettings,
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
    "DiagMclmcSettings",
    "DiagNutsSettings",
    "DualAverageOptions",
    "FlowAdaptSettings",
    "FlowMclmcSettings",
    "FlowNutsSettings",
    "KineticKind",
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
]
