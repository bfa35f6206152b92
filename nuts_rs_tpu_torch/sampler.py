"""Settings presets, the phase plan and the chunked sampler.

Port of ``nuts_rs_tpu/sampler.py``: ``NutsSettings`` and
``DiagNutsSettings`` (``:45-281,538-541``), ``FlowNutsSettings``
(``:552-559``), ``MclmcTrajectoryKind``, ``MclmcSettings``,
``DiagMclmcSettings`` and ``FlowMclmcSettings`` (``:287-535``),
``_strategy_for`` and ``_schedule_for`` (``:663-681``), the phase plans
``build_phases``, ``ConvergenceStop``, ``ChainProgress`` and
``ChainFailedError`` (``:563-657``), the ``Sampler`` (``:758-2214``; not
its ``dtype``, ``mesh``, ``profile_dir``, ``max_chains_per_launch`` and
``auto_recover`` options, nor ``run()``'s launch/finish pipelining) and
the free functions ``schema`` (``:2216``), ``sample`` (``:2248``) and
``sample_sequentially`` (``:2287``).

NUTS runs on two engines, chosen as the JAX package chooses
(``nuts_rs_tpu/sampler.py:167-281``).  ``posterior_kernel="sync"`` is the
per-draw sync engine throughout (``kernels/nuts.py`` under
``chain.make_draw_step``; any model, every tree option, every step-size
method).  ``posterior_kernel="pallas"`` is the fused engine: warmup on the
fused warmup kernel, split at the step-size re-init draw, and the posterior
on the fused posterior kernel, in the chains-on-lanes layout up to
``cl_max_dim(maxdepth)`` dimensions (less for a model with data, whose
bytes the rule counts) and in the dim-on-lanes layout above
(as the JAX runners choose, ``nuts_rs_tpu/chain.py:757-784``); a model
whose data only stream (``chain.fused_layout``), the good-draw window mode
and the step-size methods other than dual averaging take the per-draw sync
warmup before the fused posterior; a tree option the fused kernels lack
demotes the run to the sync engine with the JAX package's ``UserWarning``,
and so does a model that no fused posterior tier takes (the JAX posterior
runner is None: ``chain.fused_layout``).
A learned flow (``mass_matrix="flow"``, ``FlowNutsSettings``) warms up on the
sync engine with its refits (``adapt/flow.py``) and, with ``"pallas"``,
draws the posterior on kernel K1-flow with the frozen pooled flow; a flow
without kernel hooks, an unpooled one or one beyond the JAX runner's size
rule stays on the sync engine, with that package's ``UserWarning``.
MCLMC runs on two engines too: ``"sync"`` (the default) is the per-draw
sync MCLMC engine (``kernels/mclmc.py`` under
``chain.make_mclmc_draw_step``), split at the Euclidean -> microcanonical
switch; ``"pallas"`` is the fused warmup, split there, and the fused
posterior, with or without model data, up to the JAX MCLMC runners' own
limits (``chain.mclmc_max_dim``): the sync warmup before the fused posterior
between the warmup's and the posterior's limit, the sync engine throughout
above it or with an extra store (with the JAX package's ``UserWarning``).
A model without a kernel hook runs on the sync engine of either sampler
with a ``UserWarning``.  Every demotion is decided in ``build_phases``,
before any launch.  ``posterior_kernel="pallas"`` keeps its name, so one
user script runs on both packages; in this package it selects the
hand-written CUDA kernels (and their plain PyTorch versions for CPU
tensors).  A setting the slice does not take raises
``NotImplementedError`` naming the ROADMAP.md item that ports it; nothing
runs quietly on another path.  The extra stores run on the sync engines;
the transfer knobs (``keep_stats``, ``draw_dtype``, ``stats_dtype``,
``store_warmup``) act on the device before a chunk's copy.  The control
surface (pause / resume, ``wait_timeout``, ``abort``, progress with
in-chunk ticks on the sync engines, checkpoints, the stuck-chain detector,
the convergence stop, the expansions) works on every engine.
"""

from __future__ import annotations

import dataclasses
import enum
import inspect
import time
import warnings
from typing import Any, Optional

import numpy as np
import torch

from .adapt.flow import FlowAdaptSettings, FlowStrategy, build_flow_schedule
from .adapt.schedule import (
    AdaptScheduleOptions,
    build_schedule,
    build_window_params,
)
from .adapt.step_size import StepSizeMethod, StepSizeSettings
from .chain import (
    PURPOSE_EXPAND,
    ChainConfig,
    DiagStrategy,
    cl_max_dim,
    fused_layout,
    init_chain_state,
    mclmc_fused_fits,
    make_fused_mclmc_posterior_runner,
    make_fused_mclmc_warmup_runner,
    make_flow_posterior_runner,
    make_fused_posterior_runner,
    make_fused_warmup_runner,
    make_sync_mclmc_runner,
    make_sync_runner,
    stream_block,
)
from .checkpoint import load_state, save_state
from .dynamics.hamiltonian import KineticKind
from .kernels import _build, nuts_fused
from .kernels.mclmc import MclmcOptions
from .kernels.rng import derive_seed
from .kernels.nuts import NutsOptions
from .models.model import Model
from .storage.core import StorageConfig, dims_for_tail
from .storage.memory import MemoryConfig, Trace


@dataclasses.dataclass(frozen=True)
class NutsSettings:
    """Generic NUTS settings (nuts-rs ``NutsSettings``, src/sampler.rs:199-239),
    with the JAX package's names and defaults."""

    num_tune: int = 400
    num_draws: int = 1000
    maxdepth: int = 10
    mindepth: int = 0
    num_chains: int = 6
    seed: int = 0
    max_energy_error: float = 1000.0
    check_turning: bool = True
    target_integration_time: Optional[float] = None
    extra_doublings: int = 0
    store_gradient: bool = False
    store_unconstrained: bool = False
    store_transformed: bool = False
    store_divergences: bool = False
    store_mass_matrix: bool = False
    kinetic_energy: KineticKind = KineticKind.EUCLIDEAN
    async_posterior: bool = False
    # "sync" | "async" | "pallas".  "pallas" selects the fused engine: the
    # hand-written CUDA kernels in this package.
    posterior_kernel: str = "sync"
    cross_chain_adaptation: bool = False
    mesh_axis_name: Optional[str] = None
    adapt: AdaptScheduleOptions = AdaptScheduleOptions()
    step_size: StepSizeSettings = StepSizeSettings()
    use_grad_based_estimate: bool = True
    flow: FlowAdaptSettings = FlowAdaptSettings()
    flow_spec: Any = None  # FlowSpec; None: the built-in coupling flow
    mass_matrix: str = "diag"  # "diag" | "low_rank" | "flow"

    def nuts_options(self) -> NutsOptions:
        return NutsOptions(
            maxdepth=self.maxdepth, mindepth=self.mindepth,
            check_turning=self.check_turning,
            max_energy_error=self.max_energy_error,
            extra_doublings=self.extra_doublings,
            target_integration_time=self.target_integration_time,
            kind=self.kinetic_energy,
            store_divergences=self.store_divergences,
            collect_orbit=(self.mass_matrix == "flow"
                           and self.flow.use_orbit_for_training))

    def chain_config(self) -> ChainConfig:
        window_params = None
        if self.adapt.window_by_good_draws:
            # reference-semantics warmup (adapt_strategy.rs:121-216): the
            # per-chain window counters ride the diag strategy's estimator
            # counts
            if self.mass_matrix != "diag":
                raise ValueError(
                    "adapt.window_by_good_draws=True requires "
                    f"mass_matrix='diag' (got {self.mass_matrix!r})")
            if self.cross_chain_adaptation:
                raise ValueError(
                    "adapt.window_by_good_draws=True is incompatible with "
                    "cross_chain_adaptation=True")
            window_params = build_window_params(self.num_tune, self.adapt)
        if self.store_mass_matrix and self.mass_matrix == "flow":
            raise ValueError(
                "store_mass_matrix stores a diagonal transform's stds and "
                "mean; a flow has neither")
        return ChainConfig(nuts=self.nuts_options(),
                           step_size=self.step_size,
                           use_grad_based_estimate=self.use_grad_based_estimate,
                           window_params=window_params,
                           **_store_fields(self))

    @property
    def _posterior_kernel(self) -> str:
        if self.async_posterior and self.posterior_kernel == "sync":
            return "async"
        return self.posterior_kernel

    def _pallas_disqualifiers(self) -> list:
        """Settings that keep a ``posterior_kernel="pallas"`` request off
        the fused engine, named so that the demotion warning can say why
        (``nuts_rs_tpu/sampler.py:167-197``; the entries whose setting this
        package refuses altogether are in :meth:`unsupported`)."""
        reasons = []
        if self.kinetic_energy is not KineticKind.EUCLIDEAN:
            reasons.append(f"kinetic_energy={self.kinetic_energy.name}")
        if self.mindepth != 0:
            reasons.append(f"mindepth={self.mindepth}")
        if self.extra_doublings != 0:
            reasons.append(f"extra_doublings={self.extra_doublings}")
        if self.target_integration_time is not None:
            reasons.append("target_integration_time")
        if not self.check_turning:
            reasons.append("check_turning=False")
        if any(_store_fields(self).values()):
            reasons.append("store_gradient/store_unconstrained/"
                           "store_transformed/store_divergences/"
                           "store_mass_matrix")
        return reasons

    def _fused(self) -> bool:
        """Whether the run reaches the fused engine at all."""
        return (self._posterior_kernel == "pallas"
                and not self._pallas_disqualifiers())

    def _fused_warmup(self) -> bool:
        """Whether the settings allow the fused warmup
        (``nuts_rs_tpu/sampler.py:252-255``)."""
        return (self._fused() and self.mass_matrix == "diag"
                and not self.adapt.window_by_good_draws
                and self.step_size.method is StepSizeMethod.DUAL_AVERAGE)

    def unsupported(self, model: Model, device=None) -> list:
        """What this package does not take on ``device``, each with the
        ROADMAP.md item that ports it (queue 1 unless named otherwise)."""
        kind = self._posterior_kernel
        reasons = []
        if kind == "async":
            reasons.append("posterior_kernel='async' (item 16)")
        elif kind not in ("sync", "pallas"):
            raise ValueError(f"unknown posterior_kernel {kind!r}")
        if self.mass_matrix == "low_rank":
            reasons.append("mass_matrix='low_rank' (item 14)")
        elif self.mass_matrix not in ("diag", "flow"):
            raise ValueError(f"unknown mass_matrix {self.mass_matrix!r}")
        if self.cross_chain_adaptation or self.mesh_axis_name is not None:
            reasons.append("cross-chain adaptation / meshes (item 17)")
        if reasons or not self._fused() or model.kernel_hook is None:
            return reasons
        if self.mass_matrix == "flow":
            return _flow_model_reasons(model, self.maxdepth, device)
        return _model_reasons(model, self.maxdepth, device, ld=True,
                              warmup=self._fused_warmup())

    def build_phases(self, model: Model, config: ChainConfig, device=None,
                     strategy=None):
        """``[(start, end, runner)]``, as the JAX package plans them
        (``nuts_rs_tpu/sampler.py:202-281``): the sync engine throughout for
        ``posterior_kernel="sync"`` and for a ``"pallas"`` request with a
        setting the fused kernels lack (announced by a ``UserWarning``);
        else the fused posterior after the fused warmup, split after each
        step-size re-init draw so that the init search runs at a launch
        boundary (adapt_strategy.rs:207-212), or after the per-draw sync
        warmup where the settings or the model's data rule the fused warmup
        out; the sync engine throughout, with the JAX package's
        ``UserWarning``, where no fused posterior tier takes the model
        (``:240-251``), and with a warning of its own for a model without a
        kernel hook (the kernels compile device functors only; the JAX
        package traces such a model's closure into its kernels).  A flow
        run is the sync warmup with its refits, then the K1-flow posterior
        (``nuts_rs_tpu/sampler.py:252-281``), or the sync engine throughout
        where the runner declines the flow.  Raises ``NotImplementedError``
        for what :meth:`unsupported` lists."""
        _refuse(self.unsupported(model, device))
        total = self.num_tune + self.num_draws
        strategy = strategy or _strategy_for(self, config)
        sync = make_sync_runner(model, strategy, config, self.seed)
        if not self._fused():
            if self._posterior_kernel == "pallas":
                warnings.warn(
                    "posterior_kernel='pallas' requested but the fused "
                    "engine does not support: "
                    + "; ".join(self._pallas_disqualifiers())
                    + " — using the sync engine", UserWarning)
            return [(0, total, sync)]
        if model.kernel_hook is None:
            _warn_no_hook(model)
            return [(0, total, sync)]
        if self.mass_matrix == "flow":
            post = make_flow_posterior_runner(model, strategy, config,
                                              self.num_tune, self.seed)
        else:
            post = make_fused_posterior_runner(model, config, self.num_tune,
                                               self.seed, device)
        if post is None:
            warnings.warn(
                "posterior_kernel='pallas' requested but no fused-engine "
                "tier fits this model (VMEM budget or missing pallas hooks) "
                "— using the sync engine", UserWarning)
            return [(0, total, sync)]
        if self.mass_matrix == "flow":
            return [(0, self.num_tune, sync), (self.num_tune, total, post)]
        if (device is not None and torch.device(device).type == "cuda"
                and fused_layout(model, config, False, device) == "stream"):
            # K1-stream's logical block must be resident at once: checked
            # here, before the warmup, not at the first posterior launch
            _build.check_stream_resident(
                model.dim, stream_block(model, self.maxdepth,
                                        self.num_chains), self.maxdepth)
        warm = (make_fused_warmup_runner(model, config, self.seed, device)
                if self._fused_warmup() else None)
        if warm is None:
            # the warmup stays draw-synchronous
            return [(0, self.num_tune, sync), (self.num_tune, total, post)]
        sched = build_schedule(self.num_tune, self.num_draws, self.adapt)
        phases, start = [], 0
        for r in np.nonzero(sched.reinit_step_size)[0].tolist():
            phases.append((start, r + 1, warm))
            start = r + 1
        if start < self.num_tune:
            phases.append((start, self.num_tune, warm))
        phases.append((self.num_tune, total, post))
        return phases

    def extra_flags(self, flags, lo, hi):
        return flags

    @property
    def sampler_name(self) -> str:
        return "nuts"


def DiagNutsSettings(**kw) -> NutsSettings:
    """Defaults of nuts-rs ``DiagNutsSettings`` (src/sampler.rs:630-633)."""
    return NutsSettings(**kw)


def FlowNutsSettings(**kw) -> NutsSettings:
    """Defaults of nuts-rs ``FlowNutsSettings`` (src/sampler.rs:643-646):
    1500 tuning draws, 1 chain, max_energy_error 20, a learned flow."""
    kw.setdefault("num_tune", 1500)
    kw.setdefault("num_chains", 1)
    kw.setdefault("max_energy_error", 20.0)
    kw.setdefault("mass_matrix", "flow")
    return NutsSettings(**kw)


def _strategy_for(settings, config: ChainConfig):
    """The adaptation strategy of ``settings`` (``sampler.py:663-676``): the
    diagonal one, or a flow's (the built-in coupling flow unless
    ``flow_spec`` names another)."""
    if getattr(settings, "mass_matrix", "diag") == "flow":
        from .flows.coupling import coupling_flow

        return FlowStrategy(config, settings,
                            settings.flow_spec or coupling_flow())
    return DiagStrategy(config)


def _schedule_for(settings):
    """The adaptation schedule of ``settings`` (``sampler.py:678-681``)."""
    if getattr(settings, "mass_matrix", "diag") == "flow":
        return build_flow_schedule(settings.num_tune, settings.num_draws,
                                   settings.flow)
    return build_schedule(settings.num_tune, settings.num_draws,
                          settings.adapt)


def _flow_model_reasons(model: Model, maxdepth: int, device) -> list:
    """What kernel K1-flow does not take of ``model`` on ``device``: on
    CUDA a maxdepth beyond the kernels that take it at launch.  A model
    without a device functor, or a model or flow the JAX runner's size rule
    rejects, is no refusal: the run stays on the sync engine
    (``build_phases``)."""
    on_cuda = device is not None and torch.device(device).type == "cuda"
    if on_cuda and maxdepth > _build.LD_MAX_MAXDEPTH:
        return [f"maxdepth {maxdepth} on CUDA: kernel K1-flow takes at most "
                f"{_build.LD_MAX_MAXDEPTH} (item 12)"]
    return []


def _store_fields(settings) -> dict:
    return {name: getattr(settings, name) for name in (
        "store_gradient", "store_unconstrained", "store_transformed",
        "store_divergences", "store_mass_matrix")}


def _warn_no_hook(model: Model):
    """The demotion of a model without a kernel hook, decided before any
    launch (the JAX package traces such a model's logp into its kernels;
    the port's kernels compile device functors only)."""
    warnings.warn(
        f"posterior_kernel='pallas' requested but model {model.name!r} has "
        "no kernel_hook (the fused kernels compile device functors only) — "
        "using the sync engine", UserWarning)


def _refuse(reasons):
    if reasons:
        raise NotImplementedError(
            "not ported yet (see ROADMAP.md): " + "; ".join(reasons))


def _model_reasons(model: Model, maxdepth: int, device, ld: bool,
                   warmup: bool = True) -> list:
    """What the fused kernels do not take of ``model`` on ``device``, for a
    model with a kernel hook (one without runs on the sync engine).
    ``ld``: the sampler is NUTS, which has a dim-on-lanes layout for models
    above ``cl_max_dim`` and a streamed posterior kernel for data beyond the
    resident rule (``warmup``: the settings ask for the fused warmup too);
    the MCLMC kernels are chains-on-lanes only, as in the JAX package
    (``mclmc_pallas.py:62``), with limits of their own
    (``chain.mclmc_fused_fits``), beyond which the run or its warmup is on
    the sync MCLMC engine, as in the JAX package."""
    reasons = []
    on_cuda = device is not None and torch.device(device).type == "cuda"
    if not ld:
        if not mclmc_fused_fits(model, warmup=False):
            return reasons
        if not on_cuda or nuts_fused.cl_kernel(model, model.dim) == "thread":
            return reasons
        need = _build.mclmc_mid_smem_bytes(model.dim, model)
        micro = MclmcOptions(kind=KineticKind.MICROCANONICAL)
        if (need <= _build.SMEM_OPT_IN_BYTES
                and _build.mclmc_mid_form(model, micro) == "group"
                and _build.mclmc_mid_group(model.dim, model) < 1):
            need = _build.mclmc_mid_group_bytes(model.dim, model, 1)
        if need > _build.SMEM_OPT_IN_BYTES:
            reasons.append(
                f"model {model.name!r} on CUDA: the mid-d MCLMC kernels "
                f"keep {need} bytes per chain in one block's shared "
                f"memory of {_build.SMEM_OPT_IN_BYTES}; the JAX MCLMC "
                "runners take it in their fused kernels (item 12: data "
                "beyond a block's shared memory)")
        return reasons
    config = ChainConfig(nuts=NutsOptions(maxdepth=maxdepth),
                         step_size=StepSizeSettings())
    layouts = []
    for w in ((True, False) if warmup else (False,)):
        try:
            layouts.append(fused_layout(model, config, w, device))
        except NotImplementedError as e:
            return [str(e).removeprefix("not ported yet (see ROADMAP.md): ")]
    if not on_cuda:
        return reasons
    if maxdepth > _build.LD_MAX_MAXDEPTH:
        reasons.append(f"maxdepth {maxdepth} on CUDA: the kernels that take "
                       "maxdepth at launch take at most "
                       f"{_build.LD_MAX_MAXDEPTH} (item 12)")
    elif "ld" in layouts and not _build.ld_fits(model, maxdepth):
        reasons.append(
            f"model {model.name!r} at (dim, maxdepth) = "
            f"{(model.dim, maxdepth)} on CUDA: the dim-on-lanes kernels keep "
            "a chain's state and the model functor's scratch in one block's "
            f"shared memory, dim <= {_build.ld_max_dim(maxdepth)} without "
            f"scratch (maxdepth <= {_build.LD_MAX_MAXDEPTH}) (item 12, "
            "larger d)")
    return reasons


class MclmcTrajectoryKind(str, enum.Enum):
    """nuts-rs ``MclmcTrajectoryKind`` (src/mclmc.rs:44-70)."""

    MICROCANONICAL = "microcanonical"
    EUCLIDEAN = "euclidean"
    EUCLIDEAN_EARLY_THEN_MICROCANONICAL = "euclidean_early_then_microcanonical"


@dataclasses.dataclass(frozen=True)
class MclmcSettings:
    """Unadjusted MCLMC settings (nuts-rs ``MclmcSettings``,
    src/sampler.rs:268-318), with the JAX package's names and defaults.

    Step size and decoherence length L are constants; the geometry adapts
    during warmup with the shared window schedule."""

    step_size: float = 0.5
    momentum_decoherence_length: float = 3.0
    num_tune: int = 400
    num_draws: int = 1000
    num_chains: int = 6
    seed: int = 0
    max_energy_error: float = 1000.0
    store_gradient: bool = False
    store_unconstrained: bool = False
    store_transformed: bool = False
    store_divergences: bool = False
    store_mass_matrix: bool = False
    subsample_frequency: float = 1.0
    dynamic_step_size: bool = True
    trajectory_kind: MclmcTrajectoryKind = (
        MclmcTrajectoryKind.EUCLIDEAN_EARLY_THEN_MICROCANONICAL)
    trajectory_switch_fraction: float = 0.3
    adapt: AdaptScheduleOptions = AdaptScheduleOptions()
    use_grad_based_estimate: bool = True
    mass_matrix: str = "diag"  # "diag" | "low_rank" | "flow"
    cross_chain_adaptation: bool = False
    mesh_axis_name: Optional[str] = None
    # "sync" | "pallas".  "pallas" selects the fused engine: the
    # hand-written CUDA kernels in this package.
    posterior_kernel: str = "sync"

    @property
    def step_size_settings(self) -> StepSizeSettings:
        # Reference MCLMC presets: Fixed step size with the default 10% jitter.
        return StepSizeSettings(method=StepSizeMethod.FIXED,
                                fixed_value=self.step_size,
                                initial_step=self.step_size)

    def chain_config(self) -> ChainConfig:
        if self.adapt.window_by_good_draws:
            raise ValueError(
                "adapt.window_by_good_draws is a NUTS warmup option; the "
                "MCLMC driver runs the draw-index schedule")
        return ChainConfig(
            nuts=NutsOptions(max_energy_error=self.max_energy_error),
            step_size=self.step_size_settings,
            use_grad_based_estimate=self.use_grad_based_estimate,
            **_store_fields(self))

    @property
    def switch_draw(self) -> Optional[int]:
        if (self.trajectory_kind
                is not MclmcTrajectoryKind.EUCLIDEAN_EARLY_THEN_MICROCANONICAL):
            return None
        return int(self.trajectory_switch_fraction * self.num_tune)

    def _mclmc_options(self, kind) -> MclmcOptions:
        return MclmcOptions(
            momentum_decoherence_length=self.momentum_decoherence_length,
            subsample_frequency=self.subsample_frequency,
            dynamic_step_size=self.dynamic_step_size,
            max_energy_error=self.max_energy_error,
            kind=(KineticKind.MICROCANONICAL
                  if kind is MclmcTrajectoryKind.MICROCANONICAL
                  else KineticKind.EUCLIDEAN),
            store_divergences=self.store_divergences)

    def _pallas_disqualifiers(self) -> list:
        """Settings that keep a ``posterior_kernel="pallas"`` request off
        the fused MCLMC engine (``nuts_rs_tpu/sampler.py:376-388``; the
        other mass matrices, meshes and pooling are refused altogether in
        :meth:`unsupported`)."""
        return [f"{name}=True" for name, on in _store_fields(self).items()
                if on]

    def _fused_posterior(self, model: Model) -> bool:
        """Whether the posterior runs on the fused MCLMC kernel: a
        ``"pallas"`` request without disqualifiers, for a model with a
        kernel hook that the JAX posterior runner takes."""
        return (self.posterior_kernel == "pallas"
                and not self._pallas_disqualifiers()
                and model.kernel_hook is not None
                and mclmc_fused_fits(model, warmup=False))

    def unsupported(self, model: Model, device=None) -> list:
        """What this package does not take on ``device``, each with the
        ROADMAP.md item that ports it (queue 1)."""
        reasons = []
        if self.posterior_kernel not in ("sync", "pallas"):
            raise ValueError(
                f"unknown posterior_kernel {self.posterior_kernel!r}")
        if self.mass_matrix == "low_rank":
            reasons.append("mass_matrix='low_rank' (item 14)")
        elif self.mass_matrix == "flow":
            reasons.append("mass_matrix='flow' (item 15: the JAX package "
                           "refits MCLMC's flow on its sync MCLMC engine; "
                           "the refit's gates need a reference of their "
                           "own)")
        elif self.mass_matrix != "diag":
            raise ValueError(f"unknown mass_matrix {self.mass_matrix!r}")
        if self.cross_chain_adaptation or self.mesh_axis_name is not None:
            reasons.append("cross-chain adaptation / meshes (item 17)")
        if reasons or not self._fused_posterior(model):
            return reasons
        return _model_reasons(model, 10, device, ld=False)

    def build_phases(self, model: Model, config: ChainConfig, device=None,
                     strategy=None):
        """``[(start, end, runner)]`` as the JAX package plans them
        (``nuts_rs_tpu/sampler.py:390-492``).  ``"sync"``: the sync MCLMC
        engine throughout, split at the Euclidean -> microcanonical switch.
        ``"pallas"``: the fused warmup split at the switch, then the fused
        posterior (the diagonal adaptation runs in the kernels); the sync
        warmup before the fused posterior where the JAX warmup runner is
        None (d = 362..484 without data); the sync engine throughout where
        the fused posterior cannot run: an extra store (the JAX package's
        ``UserWarning``, ``:415-423``), a model above the JAX posterior
        runner's limit or whose data only stream (its other warning,
        ``:430-438``) or a model without a kernel hook (a warning of the
        port's own).  Every demotion is decided here, before any launch.
        Raises ``NotImplementedError`` for what :meth:`unsupported`
        lists."""
        _refuse(self.unsupported(model, device))
        if model.dim < 2 and self.trajectory_kind is not (
                MclmcTrajectoryKind.EUCLIDEAN):
            raise ValueError("the microcanonical dynamics need dim >= 2 "
                             "(the ESH step divides by dim - 1)")
        if self.posterior_kernel == "pallas":
            reasons = self._pallas_disqualifiers()
            if reasons:
                warnings.warn(
                    "posterior_kernel='pallas' requested but the fused "
                    "MCLMC engine does not support: " + "; ".join(reasons)
                    + " — using the sync engine", UserWarning)
            elif model.kernel_hook is None:
                _warn_no_hook(model)
            elif not mclmc_fused_fits(model, warmup=False):
                warnings.warn(
                    "posterior_kernel='pallas' requested but no fused-"
                    "engine tier fits this model (VMEM budget or "
                    "streaming-only likelihood) — using the sync engine",
                    UserWarning)
        total = self.num_tune + self.num_draws
        sw = self.switch_draw
        strategy = strategy or DiagStrategy(config)

        def kind_of(hi):
            if sw is None:
                return self.trajectory_kind
            return (MclmcTrajectoryKind.EUCLIDEAN if hi <= sw
                    else MclmcTrajectoryKind.MICROCANONICAL)

        warm = [(0, total)] if sw is None else [(0, sw), (sw, total)]
        if not self._fused_posterior(model):
            return [(lo, hi, make_sync_mclmc_runner(
                model, strategy, config, self._mclmc_options(kind_of(hi)),
                self.seed)) for lo, hi in warm]
        # the fused engine takes over at num_tune
        warm = [(lo, min(hi, self.num_tune)) for lo, hi in warm
                if lo < self.num_tune]
        fused_warm = mclmc_fused_fits(model, warmup=True)
        phases = []
        for lo, hi in warm:
            mopts = self._mclmc_options(kind_of(hi))
            phases.append((lo, hi, (
                make_fused_mclmc_warmup_runner(model, config, mopts,
                                               self.seed) if fused_warm
                else make_sync_mclmc_runner(model, strategy, config, mopts,
                                            self.seed))))
        post_kind = (MclmcTrajectoryKind.EUCLIDEAN
                     if self.trajectory_kind is MclmcTrajectoryKind.EUCLIDEAN
                     else MclmcTrajectoryKind.MICROCANONICAL)
        phases.append((self.num_tune, total, make_fused_mclmc_posterior_runner(
            model, config, self._mclmc_options(post_kind), self.num_tune,
            self.seed)))
        return phases

    def extra_flags(self, flags, lo, hi):
        """Full momentum resample on the first draw and at the trajectory
        switch (mclmc.rs:488-503)."""
        special = {0, self.switch_draw}
        flags = dict(flags)
        flags["resample_velocity"] = np.array(
            [d in special for d in range(lo, hi)], dtype=bool)
        return flags

    @property
    def sampler_name(self) -> str:
        return "mclmc"


def DiagMclmcSettings(**kw) -> MclmcSettings:
    """Defaults of nuts-rs ``DiagMclmcSettings`` (src/sampler.rs:381-387)."""
    return MclmcSettings(**kw)


def FlowMclmcSettings(**kw) -> MclmcSettings:
    """Defaults of nuts-rs ``FlowMclmcSettings`` (src/sampler.rs:334,
    390-392): 1500 tuning draws, 1 chain, max_energy_error 20, a learned
    flow.  Refused for now (item 15)."""
    kw.setdefault("num_tune", 1500)
    kw.setdefault("num_chains", 1)
    kw.setdefault("max_energy_error", 20.0)
    kw.setdefault("mass_matrix", "flow")
    return MclmcSettings(**kw)


def _schedule_chunk(sched, lo: int, hi: int):
    return {name: getattr(sched, name)[lo:hi] for name in (
        "is_tuning", "update_estimators", "do_switch", "do_update",
        "use_late_estimator", "reinit_step_size", "use_best_guess",
        "advance_da")}


# Stored stats (name -> dtype; "position" has the model dim as trailing
# shape) of each sampler, as the JAX fused runners emit them.
_STAT_DTYPES = {
    "nuts": {
        "position": np.float32, "depth": np.int32,
        "maxdepth_reached": np.bool_, "diverging": np.bool_,
        "n_steps": np.int32, "step_size": np.float32,
        "step_size_bar": np.float32, "mean_tree_accept": np.float32,
        "mean_tree_accept_sym": np.float32, "max_energy_error": np.float32,
        "logp": np.float32, "energy": np.float32, "energy_error": np.float32,
        "index_in_trajectory": np.int32, "fisher_distance": np.float32,
        "transformation_index": np.int32, "tuning": np.bool_,
    },
    "mclmc": {
        "position": np.float32, "diverging": np.bool_, "n_steps": np.int32,
        "energy_change": np.float32, "log_weight": np.float32,
        "average_step_size": np.float32, "step_size": np.float32,
        "logp": np.float32, "energy": np.float32,
        "fisher_distance": np.float32, "transformation_index": np.int32,
        "tuning": np.bool_,
    },
}
_POSTERIOR_STAT_KEYS = ("position",)
# stats the sampler itself reads, kept whatever ``keep_stats`` lists
# (``nuts_rs_tpu/sampler.py:1084-1088``), and the accounting planes that
# an all-tuning chunk copies with ``store_warmup=False`` (``:1649-1685``)
_ALWAYS_KEPT = ("position", "diverging", "n_steps", "step_size")
_ACCOUNTING = ("diverging", "n_steps", "step_size")
# the sparse events' extra fields, named by the stats they come from
# (``nuts_rs_tpu/sampler.py:2027-2033``)
_DIV_EVENT_KEYS = ("divergence_start", "divergence_end",
                   "divergence_start_gradient", "divergence_start_momentum",
                   "divergence_momentum", "divergence_energy_error",
                   "divergence_reason")
_TRANSFORM_EVENT_KEYS = ("mass_matrix_inv", "transformation_mu")


def _extra_stat_dtypes(settings) -> dict:
    """The extra stores' stats (name -> (dtype, has a [d] tail)), as the
    sync draw steps emit them (``chain.extra_stats``); MCLMC stores no
    transformed point (``nuts_rs_tpu/chain.py:575-592``)."""
    out = {}
    if settings.store_gradient:
        out["gradient"] = (np.float32, True)
    if settings.store_unconstrained:
        out["unconstrained_draw"] = (np.float32, True)
    if settings.store_transformed and settings.sampler_name == "nuts":
        out["transformed_position"] = (np.float32, True)
        out["transformed_gradient"] = (np.float32, True)
    if settings.store_divergences:
        for name in ("divergence_start", "divergence_start_gradient",
                     "divergence_start_momentum", "divergence_end",
                     "divergence_momentum"):
            out[name] = (np.float32, True)
        out["divergence_energy_error"] = (np.float32, False)
        out["divergence_reason"] = (np.int32, False)
    if settings.store_mass_matrix:
        out["mass_matrix_inv"] = (np.float32, True)
        out["transformation_mu"] = (np.float32, True)
    return out


def _torch_dtype(dtype):
    """A torch dtype from a numpy dtype (``np.float16``) or a torch one."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.zeros(0, np.dtype(dtype))).dtype


class _Transfer:
    """The transfer knobs (``nuts_rs_tpu/sampler.py:1080-1107``):
    ``keep_stats`` (the stats to keep beside ``_ALWAYS_KEPT``; None keeps
    all), ``draw_dtype`` (the positions' dtype in storage), ``stats_dtype``
    (the float stats' dtype in storage; int and bool stats keep theirs) and
    ``store_warmup`` (False stores no warmup draw).  Each acts on the
    device, before the copy to the host."""

    def __init__(self, keep_stats=None, draw_dtype=None, stats_dtype=None,
                 store_warmup=True):
        self.keep = (None if keep_stats is None
                     else set(keep_stats) | set(_ALWAYS_KEPT))
        self.draw_dtype = draw_dtype
        self.stats_dtype = stats_dtype
        self.store_warmup = store_warmup

    def on_device(self, stats: dict, all_tuning: bool) -> dict:
        """The chunk's stats as they cross to the host; an all-tuning chunk
        with ``store_warmup=False`` keeps the accounting planes alone."""
        if self.keep is not None:
            stats = {k: v for k, v in stats.items() if k in self.keep}
        if all_tuning and not self.store_warmup:
            stats = {k: v for k, v in stats.items() if k in _ACCOUNTING}
        elif self.draw_dtype is not None and "position" in stats:
            stats = dict(stats, position=stats["position"].to(
                _torch_dtype(self.draw_dtype)))
        if self.stats_dtype is not None:
            sd = _torch_dtype(self.stats_dtype)
            stats = {k: (v.to(sd) if k != "position"
                         and v.is_floating_point() else v)
                     for k, v in stats.items()}
        return stats

    def entries(self, entries: dict) -> dict:
        """A schema group's ``{name: {"dtype", "shape"}}`` as stored."""
        if self.keep is not None:
            entries = {k: v for k, v in entries.items() if k in self.keep}
        out = {}
        for name, e in entries.items():
            if name == "position" and self.draw_dtype is not None:
                e = dict(e, dtype=np.dtype(self.draw_dtype))
            elif (name != "position" and self.stats_dtype is not None
                  and np.issubdtype(e["dtype"], np.floating)):
                e = dict(e, dtype=np.dtype(self.stats_dtype))
            out[name] = e
        return out


@dataclasses.dataclass(frozen=True)
class ConvergenceStop:
    """Early-stopping criteria: sample until converged, then stop
    (``nuts_rs_tpu/sampler.py:563-606``).

    After every chunk holding posterior draws the sampler computes
    rank-normalized split-R-hat and bulk ESS (``diagnostics.py``) over the
    posterior draws of ``var`` buffered so far; once every dimension
    satisfies BOTH targets it stops and finalizes the shorter trace.
    ``settings.num_draws`` stays the upper bound.  Dimensions whose
    diagnostics are NaN (a constant) never satisfy the check.  Beyond
    ``max_buffer_draws`` draws a chain the buffer is thinned by 2 (every
    stride-th draw on the global posterior index), which only lowers the
    ESS: the stop stays conservative.
    """

    rhat_max: float = 1.01
    min_ess_bulk: float = 400.0
    # posterior draws required before the first (and any) check
    min_draws: int = 100
    # check only the first N dims of ``var`` (None = all)
    check_dims: Optional[int] = None
    var: str = "position"
    max_buffer_draws: int = 4096

    def satisfied(self, x) -> bool:
        from .diagnostics import ess_bulk, split_rhat

        if x.shape[1] < max(self.min_draws, 4):
            return False
        if self.check_dims is not None and x.ndim == 3:
            x = x[..., : self.check_dims]
        rhat = np.asarray(split_rhat(x))
        if not np.all(rhat <= self.rhat_max):  # NaN -> False -> keep going
            return False
        ess = np.asarray(ess_bulk(x))
        return bool(np.all(ess >= self.min_ess_bulk))


@dataclasses.dataclass
class ChainProgress:
    """Mirror of nuts-rs ``ChainProgress`` (src/sampler.rs:1009-1051), with
    the JAX package's fields (``nuts_rs_tpu/sampler.py:609-626``)."""

    finished_draws: int = 0
    total_draws: int = 0
    divergences: int = 0
    tuning: bool = True
    started: bool = False
    latest_num_steps: int = 0
    total_num_steps: int = 0
    step_size: float = 0.0
    runtime: float = 0.0
    divergent_draws: list = dataclasses.field(default_factory=list)
    # set by the sampler's between-chunk stuck-chain detector (reference:
    # LogpError::is_recoverable, src/math/math.rs:9-13)
    failed: bool = False
    error: Optional[str] = None


class ChainFailedError(RuntimeError):
    """A chain's logp function failed unrecoverably: every draw diverges
    and the chain never moves (``nuts_rs_tpu/sampler.py:640-657``).

    Sampling stops and the trace is finalized first (src/sampler.rs:
    1452-1457); the partial results ride on the exception.

    Attributes:
        trace: the finalized partial trace (all chains, draws so far).
        chains: indices of the failed chains.
    """

    def __init__(self, msg: str, trace=None, chains=()):
        super().__init__(msg)
        self.trace = trace
        self.chains = list(chains)


def _second_arg_required(fn) -> bool:
    """Whether ``fn``'s second positional parameter is explicitly required
    (``nuts_rs_tpu/sampler.py:966-990``): a ``*args`` wrapper or a
    defaulted second parameter keeps the one-argument call."""
    try:
        params = inspect.signature(fn).parameters.values()
    except (TypeError, ValueError):
        return False  # builtins / C callables: the one-argument form
    pos = [p for p in params
           if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)]
    return len(pos) >= 2 and pos[1].default is pos[1].empty


def _numpy_dtype(dtype: torch.dtype) -> np.dtype:
    return torch.zeros(0, dtype=dtype).numpy().dtype


def _expand_device(model: Model, q, seed: int, lo: int) -> dict:
    """``model.expand_fn`` on a chunk's positions ``q`` [C, k, d], on
    their device: a one-argument fn over each position by
    ``torch.func.vmap``, a two-argument fn over the chunk with a generator
    seeded from the counter hash of (``seed`` + 1, ``lo``)."""
    fn = model.expand_fn
    if _second_arg_required(fn):
        gen = torch.Generator(device=q.device)
        gen.manual_seed(derive_seed(seed + 1, lo, PURPOSE_EXPAND))
        out = fn(q, gen)
    else:
        out = torch.func.vmap(torch.func.vmap(fn))(q)
    return {name: torch.as_tensor(v) for name, v in out.items()}


def _expand_host(model: Model, pos, lo: int) -> dict:
    """``model.expand_host_fn`` on a chunk's positions [C, k, d] (numpy),
    with the chunk's first draw where its second parameter is required."""
    fn = model.expand_host_fn
    out = fn(pos, lo) if _second_arg_required(fn) else fn(pos)
    return {name: np.asarray(v) for name, v in out.items()}


class Sampler:
    """Chunked multi-chain sampler (parallel controller of src/sampler.rs:1254).

    All chains run as one batched computation on ``device`` (``"cuda"``,
    the default, launches the CUDA kernels and raises where no card is
    present; on ``"cpu"`` the plain PyTorch versions run, meant for tests at
    small sizes); the host loop
    launches one chunk at a time and streams it to storage.  State is
    float32, the fused kernels' type.  ``chunk_seconds`` records
    ``(first_draw, last_draw + 1, seconds)`` per chunk, from launch to the
    chunk's stats on the host.

    The transfer knobs act on the device, before a chunk's copy to the host
    (``nuts_rs_tpu/sampler.py:1080-1107,1645-1750``): ``keep_stats`` keeps
    the listed stats beside ``position``, ``diverging``, ``n_steps`` and
    ``step_size`` (and ``stop_when.var``); ``draw_dtype`` (a numpy or torch
    dtype) casts the positions and ``stats_dtype`` the float stats (int and
    bool stats keep theirs); ``store_warmup=False`` stores no warmup draw,
    and an all-tuning chunk copies the accounting planes alone.  The
    kernels compute in float32 whatever the knobs say, and the stuck-chain
    detector and both expansions read the float32 positions.

    The control surface is the JAX package's
    (``nuts_rs_tpu/sampler.py:758-2214``), at chunk granularity:
    ``pause`` / ``resume`` (``run`` stops at a chunk boundary when paused),
    ``wait_timeout``, ``abort``, ``inspect`` and ``flush``; per-chain
    :class:`ChainProgress` in ``progress``, handed to ``progress_callback``
    after a chunk at most every ``progress_rate_seconds`` and always at the
    end, and every ``progress_tick`` draws from inside a chunk of the sync
    engines (provisional values, replaced at the chunk's end; a fused chunk
    is one launch and gets no ticks); ``stop_when`` (:class:`ConvergenceStop`);
    the stuck-chain detector: ``fail_after`` consecutive draws that diverged
    and left every coordinate bit-equal to the draw before (NaN equal to
    NaN; the run's first draw counts as moved) mark a chain failed, and
    ``run`` / ``wait_timeout`` then finalize the trace and raise
    :class:`ChainFailedError` (None disables it); ``checkpoint`` /
    ``restore``; and the model's expansions, stored beside the positions.
    """

    def __init__(self, model: Model, settings,
                 storage: Optional[StorageConfig] = None,
                 chunk_size: int = 128, init_positions=None, *,
                 device="cuda", keep_stats=None, draw_dtype=None,
                 stats_dtype=None, store_warmup: bool = True,
                 progress_callback=None, progress_tick: Optional[int] = None,
                 stop_when: Optional[ConvergenceStop] = None,
                 fail_after: Optional[int] = 100):
        if model.dim < 1:
            raise ValueError("model.dim must be >= 1")
        if chunk_size < 1:
            raise ValueError("chunk_size must be >= 1")
        if progress_tick is not None and progress_tick < 1:
            raise ValueError("progress_tick must be >= 1")
        self.device = torch.device(device)
        _refuse(settings.unsupported(model, self.device))
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the sampler runs on the card by default; "
                "pass device='cpu' to run the kernels' plain PyTorch "
                "versions (meant for small sizes)")
        # a model's data go to the sampler's device once
        model = model.to(self.device)
        self.model = model
        self.settings = settings
        self.chunk_size = chunk_size
        if keep_stats is not None and stop_when is not None:
            keep_stats = set(keep_stats) | {stop_when.var}
        self._transfer = _Transfer(keep_stats, draw_dtype, stats_dtype,
                                   store_warmup)
        self.config = settings.chain_config()
        self.strategy = _strategy_for(settings, self.config)
        self._phase_runners = settings.build_phases(
            model, self.config, self.device, strategy=self.strategy)
        self.schedule = _schedule_for(settings)
        C = settings.num_chains
        self.trace = (storage or MemoryConfig()).new_trace(settings, model, C)
        if init_positions is not None:
            init_positions = np.asarray(init_positions)
            if init_positions.shape != (C, model.dim):
                raise ValueError(
                    f"init_positions has shape {init_positions.shape}, "
                    f"expected (num_chains, dim) = {(C, model.dim)}")
        self.state = init_chain_state(
            settings.seed, model, self.strategy, self.config, C,
            torch.float32, self.device, init_positions=init_positions,
            num_tune=settings.num_tune)
        init_logp = self.state.pt.logp.cpu().numpy()
        if not np.isfinite(init_logp).all():
            bad = np.nonzero(~np.isfinite(init_logp))[0]
            raise RuntimeError(
                f"could not find a valid initial position for chains "
                f"{bad.tolist()[:10]} (logp is not finite after retries); "
                "provide init_positions or check the model")
        self._next_draw = 0
        self._total = settings.num_tune + settings.num_draws
        self.chunk_seconds = []
        self.progress = [ChainProgress(total_draws=self._total)
                         for _ in range(C)]
        self.progress_callback = progress_callback
        self.progress_rate_seconds = 0.5
        self._last_callback = 0.0
        self.progress_tick = progress_tick
        self._tick_lo = 0
        self._tick_base = None
        self._live_done = 0
        self._paused = False
        self.stop_when = stop_when
        self.converged = False
        self._post_buffer: list = []
        self._post_thin = 1
        self._post_seen = 0
        self.fail_after = fail_after
        self._div_streak = np.zeros(C, np.int64)
        self._last_pos: Optional[torch.Tensor] = None  # [C, d] float32
        self._failed_chains: list = []
        # backends that create their arrays upfront get the schema first
        if getattr(self.trace, "wants_schema", False):
            try:
                self.trace.declare_schema(self.schema())
            except Exception as e:
                warnings.warn(
                    f"trace schema reflection failed ({e!r}); storage "
                    "arrays will materialize on first write", RuntimeWarning)

    @property
    def finished(self) -> bool:
        return self._next_draw >= self._total

    def run_next_chunk(self):
        """Run one chunk and stream it to storage.  Returns ``(lo, stats,
        tuning)``: the chunk's first global draw index, the host stats dict
        (``stats[name]`` shaped [chains, k, ...], the expansions included)
        and the tuning mask."""
        lo = self._next_draw
        start, end, runner = next(
            (s, e, r) for s, e, r in self._phase_runners if s <= lo < e)
        hi = min(lo + self.chunk_size, self._total, end)
        t0 = time.monotonic()
        flags = self.settings.extra_flags(
            _schedule_chunk(self.schedule, lo, hi), lo, hi)
        if self.progress_tick is not None and getattr(runner, "ticks",
                                                      False):
            # the base of the ticks' provisional values
            self._tick_lo = lo
            self._tick_base = [(p.finished_draws, p.divergences,
                                p.total_num_steps) for p in self.progress]
            self._live_done = 0
            self.state, stats = runner(
                self.state, flags, tick=(self.progress_tick, self._tick_fn))
        else:
            self.state, stats = runner(self.state, flags)
        self._next_draw = hi
        return self._finish_chunk(lo, hi, stats, t0)

    def _finish_chunk(self, lo, hi, stats, t0):
        tuning = self.schedule.is_tuning[lo:hi]
        all_tuning = hi > lo and bool(tuning.all())
        drop_warm = all_tuning and not self._transfer.store_warmup
        # the detector's mask and both expansions read the float32
        # positions on the device, before the knobs cast or drop them
        pos = stats["position"]                           # [k, C, d]
        same = (self._same_as_before(pos) if self.fail_after is not None
                else None)
        expanded = {}
        if self.model.expand_fn is not None and not drop_warm:
            expanded = {k: v.cpu().numpy() for k, v in _expand_device(
                self.model, pos.movedim(0, 1), self.settings.seed,
                lo).items()}
        stats = self._transfer.on_device(stats, all_tuning)
        # device -> host; [k, C, ...] -> [C, k, ...]
        stats = {k: np.moveaxis(v.cpu().numpy(), 0, 1)
                 for k, v in stats.items()}
        if self.model.expand_host_fn is not None and not drop_warm:
            host_pos = stats["position"]
            if host_pos.dtype != np.float32:
                host_pos = np.moveaxis(pos.cpu().numpy(), 0, 1)
            expanded.update(_expand_host(self.model, host_pos, lo))
        elapsed = time.monotonic() - t0
        self.chunk_seconds.append((lo, hi, elapsed))
        if drop_warm:
            pass  # an all-tuning chunk with store_warmup=False: no rows
        elif not self._transfer.store_warmup and tuning.any():
            # a chunk across the end of the warmup: its tuning rows go
            split = int(tuning.sum())
            self.trace.record_chunk(
                lo + split, {k: v[:, split:] for k, v in stats.items()},
                {k: v[:, split:] for k, v in expanded.items()},
                tuning[split:])
        else:
            self.trace.record_chunk(lo, stats, expanded, tuning)
        if self.stop_when is not None and not self.converged and not drop_warm:
            self._buffer_for_stop({**stats, **expanded}[self.stop_when.var],
                                  tuning)
        self._update_progress(lo, stats, tuning, elapsed)
        if same is not None:
            self._detect_failed_chains(stats["diverging"], same)
        if self.progress_callback is not None:
            now = time.monotonic()
            if (now - self._last_callback >= self.progress_rate_seconds
                    or self.finished):
                self._last_callback = now
                self.progress_callback(self.progress)
        return lo, {**stats, **expanded}, tuning

    def _buffer_for_stop(self, x, tuning):
        """Buffer the chunk's posterior draws of ``stop_when.var``, every
        ``_post_thin``-th on the global posterior index, halve the buffer
        beyond ``max_buffer_draws``, and test the criteria
        (``nuts_rs_tpu/sampler.py:1753-1781``)."""
        post = np.asarray(x)[:, ~tuning]
        if not post.shape[1]:
            return
        if self.stop_when.check_dims is not None and post.ndim == 3:
            post = post[..., : self.stop_when.check_dims]
        idx = np.arange(self._post_seen, self._post_seen + post.shape[1])
        self._post_seen += post.shape[1]
        keep = (idx % self._post_thin) == 0
        if keep.any():
            self._post_buffer.append(post[:, keep].copy())
        series = (self._post_buffer[0] if len(self._post_buffer) == 1
                  else np.concatenate(self._post_buffer, axis=1))
        while series.shape[1] > self.stop_when.max_buffer_draws:
            series = series[:, ::2]
            self._post_thin *= 2
            self._post_buffer = [series]
        self.converged = self.stop_when.satisfied(series)

    def _tick_fn(self, done, divs, steps, last, step_size):
        """In-chunk progress (see ``progress_tick``): provisional values,
        replaced by the chunk-end accounting in :meth:`_update_progress`
        (``nuts_rs_tpu/sampler.py:1798-1831``)."""
        done = int(done)
        if done <= self._live_done or self._tick_base is None:
            return
        self._live_done = done
        base, lo = self._tick_base, self._tick_lo
        tuning = bool(self.schedule.is_tuning[min(lo + done - 1,
                                                  self._total - 1)])
        divs, steps = divs.cpu().numpy(), steps.cpu().numpy()
        last, step_size = last.cpu().numpy(), step_size.cpu().numpy()
        for c, prog in enumerate(self.progress):
            b = base[c]
            prog.started = True
            prog.finished_draws = b[0] + done
            prog.divergences = b[1] + int(divs[c])
            prog.total_num_steps = b[2] + int(steps[c])
            prog.latest_num_steps = int(last[c])
            prog.step_size = float(step_size[c])
            prog.tuning = tuning
        cb = self.progress_callback
        if cb is None:
            return
        now = time.monotonic()
        if now - self._last_callback >= self.progress_rate_seconds:
            self._last_callback = now
            cb(self.progress)

    def _update_progress(self, lo, stats, tuning, elapsed):
        """The chunk-end accounting of ``progress``
        (``nuts_rs_tpu/sampler.py:1833-1869``): a chain's runtime is the
        chunk's seconds in proportion to its leapfrogs, the busiest
        chain's being the whole."""
        if self._tick_base is not None:
            # rewind the ticks' provisional values
            for c, prog in enumerate(self.progress):
                (prog.finished_draws, prog.divergences,
                 prog.total_num_steps) = self._tick_base[c]
            self._tick_base = None
        div_mask = stats["diverging"] & ~tuning                 # [C, k]
        C, k = div_mask.shape
        rows, cols = np.nonzero(div_mask)
        div_draws = np.split(lo + cols, np.searchsorted(rows, np.arange(1, C)))
        steps = stats["n_steps"].sum(axis=1, dtype=np.int64)
        runtime = elapsed * steps / max(float(steps.max()), 1.0)
        tuning_now = bool(tuning[-1])
        for prog, n_div, draws, n, last, step, t in zip(
                self.progress, div_mask.sum(1).tolist(), div_draws,
                steps.tolist(), stats["n_steps"][:, -1].tolist(),
                stats["step_size"][:, -1].tolist(), runtime.tolist()):
            prog.started = True
            prog.divergences += n_div
            if n_div:
                prog.divergent_draws.extend(draws.tolist())
            prog.finished_draws += k
            prog.tuning = tuning_now
            prog.latest_num_steps = last
            prog.total_num_steps += n
            prog.step_size = step
            prog.runtime += t

    def _same_as_before(self, pos):
        """[C, k] host mask: each draw's position bit-equal to the draw
        before (NaN equal to NaN), computed on the device on the float32
        positions ``pos`` [k, C, d]; the run's first draw has no
        predecessor and counts as moved
        (``nuts_rs_tpu/sampler.py:1657-1679``)."""
        def equal(a, b):
            return ((a == b) | (torch.isnan(a) & torch.isnan(b))).all(-1)

        same = torch.zeros(pos.shape[:2], dtype=torch.bool,
                           device=pos.device)
        same[1:] = equal(pos[1:], pos[:-1])
        if self._last_pos is not None:
            same[0] = equal(pos[0], self._last_pos)
        self._last_pos = pos[-1].clone()
        return same.T.cpu().numpy()

    def _detect_failed_chains(self, div, same) -> None:
        """Between-chunk unrecoverable-failure detector (see ``fail_after``;
        ``nuts_rs_tpu/sampler.py:1871-1933``): a chain's streak counts the
        draws that diverged AND left the position bit-equal to the draw
        before; any other draw resets it.  ``div`` and ``same`` are [C, k]
        host masks."""
        div = np.asarray(div).astype(bool)
        C, k = div.shape
        if not div.any():
            self._div_streak[:] = 0
            return
        ok = ~(div & same)
        has_ok = ok.any(axis=1)
        last_ok = np.where(has_ok, k - 1 - np.argmax(ok[:, ::-1], axis=1), -1)
        self._div_streak = np.where(
            has_ok, k - 1 - last_ok, self._div_streak + k)
        newly = np.nonzero((self._div_streak >= self.fail_after)
                           & ~np.array([p.failed for p in self.progress]))[0]
        for c in newly.tolist():
            self.progress[c].failed = True
            self.progress[c].error = (
                f"chain {c}: logp function appears permanently failing — "
                f"{int(self._div_streak[c])} consecutive divergent draws "
                "with no accepted move (unrecoverable; see "
                "ChainFailedError)")
            self._failed_chains.append(c)

    def _raise_if_failed(self) -> None:
        if not self._failed_chains:
            return
        self.flush()
        trace = self.trace.finalize()
        chains = list(self._failed_chains)
        msgs = "; ".join(str(self.progress[c].error) for c in chains[:3])
        raise ChainFailedError(
            f"{len(chains)} chain(s) failed unrecoverably: {msgs}"
            + (" ..." if len(chains) > 3 else ""),
            trace=trace, chains=chains)

    def pause(self) -> None:
        """Stop launching further chunks from :meth:`run` (the reference's
        chain pause commands, src/sampler.rs:1469-1490; granularity here is
        the chunk)."""
        self._paused = True

    def resume(self) -> None:
        self._paused = False

    def run(self) -> Trace:
        """Run to the end, to convergence (``stop_when``) or to a pause.
        Raises :class:`ChainFailedError` once the detector marks a chain,
        and ``RuntimeError`` where a pause left the run unfinished."""
        while (not self.finished and not self.converged
               and not self._failed_chains):
            if self._paused:
                break
            self.run_next_chunk()
        self._raise_if_failed()
        if self.converged and not self.finished:
            # early convergence stop: the shorter trace
            self.flush()
            return self.trace.finalize()
        if not self.finished:
            raise RuntimeError(
                "sampler paused before completion; call resume() and run() "
                "again, or inspect() the partial trace")
        return self.trace.finalize()

    def wait_timeout(self, timeout: float) -> Optional[Trace]:
        """Run until finished or ``timeout`` seconds elapse (the reference's
        ``Sampler::wait_timeout``, src/sampler.rs:1526-1542).  Returns the
        finalized trace, or None on timeout with the state kept; the check
        runs between chunks, so the wait can overshoot by one chunk."""
        deadline = time.monotonic() + timeout
        while not self.finished:
            self._raise_if_failed()
            if self.converged:
                self.flush()
                return self.trace.finalize()
            if self._paused or time.monotonic() >= deadline:
                return None
            self.run_next_chunk()
        self._raise_if_failed()
        return self.trace.finalize()

    def abort(self) -> Any:
        """Stop sampling and return the partial results (the reference's
        ``Sampler::abort``, src/sampler.rs:1516-1524): storage is flushed
        and the backend's ``inspect()`` snapshot returned; ``run()`` then
        raises."""
        self._paused = True
        self.trace.flush()
        return self.trace.inspect()

    def checkpoint(self, path: str) -> None:
        """Save the chain state and the draw cursor (``checkpoint.py``); a
        Sampler built with the same settings can ``restore`` and continue
        bit-identically, on this device or another."""
        save_state(path, self.state, self._next_draw)

    def restore(self, path: str) -> None:
        """Load a checkpoint into this sampler.  The convergence buffer and
        the stuck-chain detector start afresh, as in a new sampler."""
        self.state, self._next_draw = load_state(path, self.state)
        self.converged = False
        self._post_buffer = []
        self._post_thin = 1
        self._post_seen = 0
        self._div_streak[:] = 0
        self._last_pos = None

    def inspect(self):
        return self.trace.inspect()

    def flush(self) -> None:
        """Force buffered trace chunks to storage without consuming them
        (nuts-rs ``Sampler`` flush command, src/sampler.rs:1231-1244)."""
        self.trace.flush()

    def schema(self):
        """The trace schema: ``{group: {name: {"dtype", "shape", "dims"}}}``
        for the four draw groups plus ``"coords"`` and ``"events"``, as
        ``nuts_rs_tpu``'s ``Sampler.schema`` reflects it for these settings,
        transfer knobs and expansions (``expand_fn`` probed on the
        sampler's device)."""
        t = self._transfer
        return _schema(self.model, self.settings, t, self.device)


def schema(model: Model, settings=None, *, keep_stats=None, draw_dtype=None,
           stats_dtype=None, store_warmup: bool = True):
    """Settings-level trace schema, without a sampler or a device
    (``nuts_rs_tpu/sampler.py:2035-2180,2216-2245``): what is stored, the
    extra stores, the transfer knobs and the expansions applied.  The
    expansions are probed on the CPU, once, with zero positions [C, 1, d];
    an ``expand_host_fn`` that fails on the probe is left out with a
    ``UserWarning``."""
    settings = settings or NutsSettings()
    transfer = _Transfer(keep_stats, draw_dtype, stats_dtype, store_warmup)
    return _schema(model, settings, transfer, torch.device("cpu"))


def _probe_expansions(model: Model, settings, transfer: _Transfer,
                      device) -> dict:
    """``{name: {"dtype", "shape"}}`` of the expansions, from one call of
    each on zero positions [C, 1, d] (float32 on ``device`` for
    ``expand_fn``; at ``draw_dtype`` on the host for ``expand_host_fn``,
    as the JAX package probes it)."""
    C, d = settings.num_chains, model.dim
    out = {}
    if model.expand_fn is not None:
        zero = torch.zeros(C, 1, d, dtype=torch.float32, device=device)
        for name, v in _expand_device(model, zero, settings.seed, 0).items():
            out[name] = {"dtype": _numpy_dtype(v.dtype),
                         "shape": tuple(v.shape[2:])}
    if model.expand_host_fn is not None:
        try:
            zero = np.zeros((C, 1, d), np.dtype(transfer.draw_dtype
                                                or np.float32))
            for name, v in _expand_host(model, zero, 0).items():
                out.setdefault(name, {"dtype": v.dtype,
                                      "shape": tuple(v.shape[2:])})
        except Exception as e:
            warnings.warn(
                "expand_host_fn failed on the schema probe "
                f"({type(e).__name__}: {str(e)[:200]}); its arrays are not "
                "reflected upfront and will materialize on first write",
                UserWarning)
    return out


def _schema(model: Model, settings, transfer: _Transfer, probe_device):
    dtypes = {n: (dt, n == "position")
              for n, dt in _STAT_DTYPES[settings.sampler_name].items()}
    dtypes.update(_extra_stat_dtypes(settings))
    if not (settings.num_tune or settings.num_draws):
        dtypes = {}
    every = transfer.entries({
        n: {"dtype": np.dtype(dt), "shape": (model.dim,) if vec else ()}
        for n, (dt, vec) in dtypes.items()})
    expanded = _probe_expansions(model, settings, transfer, probe_device)

    def dims(entries):
        return {n: dict(e, dims=dims_for_tail(model, n, e["shape"]))
                for n, e in entries.items()}

    def group(names, on):
        if not on:
            return {}
        return dims({n: e for n, e in every.items()
                     if (n in _POSTERIOR_STAT_KEYS) == names})

    scalar = {"dtype": np.dtype(np.int64), "shape": (), "dims": []}

    def ev_field(e):
        return {"dtype": (e["dtype"] if e["dtype"].kind == "f"
                          else np.dtype(np.int64)),
                "shape": e["shape"],
                "dims": ["unconstrained_parameter"] if e["shape"] else []}

    events = {}
    if "diverging" in every:
        events["divergence"] = {"draw": dict(scalar), **{
            k: ev_field(every[k]) for k in _DIV_EVENT_KEYS if k in every}}
    if "transformation_index" in every:
        events["transformation_update"] = {
            "draw": dict(scalar), "transformation_update_id": dict(scalar),
            **{k: ev_field(every[k]) for k in _TRANSFORM_EVENT_KEYS
               if k in every}}
    warm = bool(settings.num_tune) and transfer.store_warmup
    # the expansions sit beside the positions in both posterior groups,
    # whichever phases the run has (``nuts_rs_tpu/sampler.py:2136-2150``)
    return {
        "posterior": {**group(True, settings.num_draws), **dims(expanded)},
        "sample_stats": group(False, settings.num_draws),
        "warmup_posterior": ({**group(True, warm), **dims(expanded)}
                             if transfer.store_warmup else {}),
        "warmup_sample_stats": group(False, warm),
        "coords": dict(model.coords or {}),
        "events": events,
    }


def sample(model: Model, settings=None, *,
           seed: Optional[int] = None,
           storage: Optional[StorageConfig] = None, chunk_size: int = 128,
           init_positions=None, device="cuda", keep_stats=None,
           draw_dtype=None, stats_dtype=None,
           store_warmup: bool = True, progress_callback=None,
           progress_tick: Optional[int] = None,
           stop_when: Optional[ConvergenceStop] = None,
           fail_after: Optional[int] = 100) -> Trace:
    """Sample from ``model`` on ``device`` (the card unless the caller asks
    for the CPU); returns an in-memory :class:`Trace` unless another storage
    backend is given.  The transfer knobs, ``progress_callback``,
    ``progress_tick``, ``stop_when`` (:class:`ConvergenceStop`) and
    ``fail_after`` (the stuck-chain detector; :class:`ChainFailedError`)
    are :class:`Sampler`'s."""
    settings = settings or NutsSettings()
    if seed is not None:
        settings = dataclasses.replace(settings, seed=seed)
    return Sampler(model, settings, storage=storage, chunk_size=chunk_size,
                   init_positions=init_positions, device=device,
                   keep_stats=keep_stats, draw_dtype=draw_dtype,
                   stats_dtype=stats_dtype, store_warmup=store_warmup,
                   progress_callback=progress_callback,
                   progress_tick=progress_tick, stop_when=stop_when,
                   fail_after=fail_after).run()


def sample_sequentially(model, settings, start, draws, chain=0, seed=0,
                        chunk_size: int = 16, *, device="cuda"):
    """Single-chain lazy iterator (nuts-rs ``sample_sequentially``,
    src/sampler.rs:994-1005; ``nuts_rs_tpu/sampler.py:2287-2319``), one
    chain on ``device``.

    ``draws`` counts all draws, the first ``num_tune`` of them tuning.
    Yields ``(position, progress_dict)`` per draw, the dict with the
    reference's ``Progress`` fields (chain.rs:178-188) under the JAX
    package's keys.  Lazy at ``chunk_size``: the next chunk runs only when
    the last one's draws are consumed."""
    num_tune = min(getattr(settings, "num_tune", 0), draws)
    settings = dataclasses.replace(settings, num_chains=1, num_tune=num_tune,
                                   num_draws=draws - num_tune, seed=seed)
    sampler = Sampler(model, settings,
                      chunk_size=max(1, min(chunk_size, draws)),
                      init_positions=np.asarray(start)[None, :],
                      device=device)
    while not sampler.finished:
        lo, stats, tuning = sampler.run_next_chunk()
        for j in range(len(tuning)):
            progress = {
                "draw": lo + j,
                "chain": chain,
                "diverging": bool(stats["diverging"][0, j]),
                "tuning": bool(tuning[j]),
                "step_size": float(stats["step_size"][0, j]),
                "num_steps": int(stats["n_steps"][0, j]),
            }
            yield np.asarray(stats["position"][0, j]), progress
