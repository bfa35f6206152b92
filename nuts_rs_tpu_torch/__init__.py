"""nuts_rs_tpu_torch — the PyTorch/CUDA port of nuts_rs_tpu.

A second package beside the JAX one (``nuts_rs_tpu``, the reference), for one
NVIDIA H100.  It runs ``DiagNutsSettings`` and ``DiagMclmcSettings`` with
``posterior_kernel="pallas"`` on a model with a kernel hook: warmup and
posterior of each run on hand-written CUDA kernels (``csrc/``, eight in all:
NUTS at small, mid and large d, with a model's data read inside the kernel,
and MCLMC) for CUDA tensors, and on their plain PyTorch versions for CPU
tensors.  The package
imports torch and numpy and never JAX.  What is not ported yet raises
``NotImplementedError`` naming its ROADMAP.md item.
"""

from .adapt.schedule import AdaptScheduleOptions
from .adapt.step_size import (
    AdamOptions,
    DualAverageOptions,
    StepSizeMethod,
    StepSizeSettings,
)
from .convert import state_from_numpy, state_to_numpy
from .dynamics.hamiltonian import KineticKind
from .kernels.nuts import NutsOptions
from .models.model import Model
from .kernels.mclmc import MclmcOptions
from .sampler import (
    DiagMclmcSettings,
    DiagNutsSettings,
    MclmcSettings,
    MclmcTrajectoryKind,
    NutsSettings,
    Sampler,
    sample,
    schema,
)
from .storage.memory import MemoryConfig, Trace

__version__ = "0.1.0"

__all__ = [
    "AdamOptions",
    "AdaptScheduleOptions",
    "DiagMclmcSettings",
    "DiagNutsSettings",
    "DualAverageOptions",
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
    "sample",
    "schema",
    "state_from_numpy",
    "state_to_numpy",
]
