"""Settings presets, the phase plan and the chunked sampler.

Port of ``nuts_rs_tpu/sampler.py``: ``NutsSettings`` and
``DiagNutsSettings`` (``:45-281,538-541``), ``FlowNutsSettings``
(``:552-559``), ``MclmcTrajectoryKind``, ``MclmcSettings``,
``DiagMclmcSettings`` and ``FlowMclmcSettings`` (``:287-535``),
``_strategy_for`` and ``_schedule_for`` (``:663-681``), the phase plans
``build_phases``, a reduced ``Sampler`` (``:758``: ``__init__``, the phase
runners, ``run_next_chunk``, ``_finish_chunk``, ``run`` ``:1957``) and the
free functions ``schema`` (``:2216``) and ``sample`` (``:2248``).

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
MCLMC runs the fused engine only: warmup on the fused MCLMC warmup
kernel, split at the Euclidean -> microcanonical switch, and the posterior
on the fused MCLMC posterior kernel, with or without model data, up to the
JAX MCLMC runners' own limits (``chain.mclmc_max_dim``).  ``posterior_kernel="pallas"`` keeps
its name, so one user script runs on both packages; in this package it selects the hand-written
CUDA kernels (and their plain PyTorch versions for CPU tensors).  A setting
the slice does not take raises ``NotImplementedError`` naming the ROADMAP.md
item that ports it; nothing runs quietly on another path.  The control
surface (pause/resume, checkpoints, progress, convergence stop, transfer
knobs, expansions) is queue-1 item 9.
"""

from __future__ import annotations

import dataclasses
import enum
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
    ChainConfig,
    DiagStrategy,
    cl_max_dim,
    fused_layout,
    init_chain_state,
    mclmc_refusal,
    make_fused_mclmc_posterior_runner,
    make_fused_mclmc_warmup_runner,
    make_flow_posterior_runner,
    make_fused_posterior_runner,
    make_fused_warmup_runner,
    make_sync_runner,
    stream_block,
)
from .dynamics.hamiltonian import KineticKind
from .kernels import _build, nuts_fused
from .kernels.mclmc import MclmcOptions
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
        return ChainConfig(nuts=self.nuts_options(),
                           step_size=self.step_size,
                           use_grad_based_estimate=self.use_grad_based_estimate,
                           window_params=window_params)

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
        if self.kinetic_energy is KineticKind.EXACT_NORMAL:
            reasons.append("kinetic_energy=EXACT_NORMAL (item 8)")
        if (self.store_gradient or self.store_unconstrained
                or self.store_transformed or self.store_divergences
                or self.store_mass_matrix):
            reasons.append("store_* extra stores (item 9)")
        if self.cross_chain_adaptation or self.mesh_axis_name is not None:
            reasons.append("cross-chain adaptation / meshes (item 17)")
        if reasons or not self._fused():
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
        (``:240-251``).  A flow run is the sync warmup with its refits, then
        the K1-flow posterior (``nuts_rs_tpu/sampler.py:252-281``), or the
        sync engine throughout where the runner declines the flow.  Raises
        ``NotImplementedError`` for what :meth:`unsupported` lists."""
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
    """What kernel K1-flow does not take of ``model`` on ``device``: a
    model without a device functor (the JAX package traces such a model's
    closure into its flow kernel, or falls back to its sync engine), and on
    CUDA a maxdepth beyond the kernels that take it at launch.  A model or
    flow the JAX runner's size rule rejects is no refusal: the run stays on
    the sync engine, as in the JAX package (``build_phases``)."""
    if model.kernel_hook is None:
        return [f"model {model.name!r} without a kernel_hook: kernel K1-flow "
                "compiles device functors only (posterior_kernel='sync' "
                "runs it here; item 9, engine fallback with provenance)"]
    on_cuda = device is not None and torch.device(device).type == "cuda"
    if on_cuda and maxdepth > _build.LD_MAX_MAXDEPTH:
        return [f"maxdepth {maxdepth} on CUDA: kernel K1-flow takes at most "
                f"{_build.LD_MAX_MAXDEPTH} (item 12)"]
    return []


def _refuse(reasons):
    if reasons:
        raise NotImplementedError(
            "not ported yet (see ROADMAP.md): " + "; ".join(reasons))


def _model_reasons(model: Model, maxdepth: int, device, ld: bool,
                   warmup: bool = True) -> list:
    """What the fused kernels do not take of ``model`` on ``device``.
    ``ld``: the sampler is NUTS, which has a dim-on-lanes layout for models
    above ``cl_max_dim`` and a streamed posterior kernel for data beyond the
    resident rule (``warmup``: the settings ask for the fused warmup too);
    the MCLMC kernels are chains-on-lanes only, as in the JAX package
    (``mclmc_pallas.py:62``), with limits of their own
    (``chain.mclmc_refusal``), and the JAX MCLMC runners refuse a model
    whose data only stream (``nuts_rs_tpu/chain.py:1228-1230``) for its sync
    engine, item 8."""
    reasons = []
    on_cuda = device is not None and torch.device(device).type == "cuda"
    if model.kernel_hook is None:
        sync = ("its sync NUTS engine (posterior_kernel='sync' runs it here)"
                if ld else "its sync MCLMC engine (item 8 ports it)")
        return [f"model {model.name!r} without a kernel_hook: the fused "
                "kernels compile device functors only, and the JAX package "
                "runs a model its kernels cannot trace on " + sync
                + " (item 9, engine fallback with provenance)"]
    if not ld:
        reason = mclmc_refusal(model)
        if reason is not None:
            return [reason]
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
                f"memory of {_build.SMEM_OPT_IN_BYTES}; data of that "
                "size must stream (item 8: the JAX MCLMC runners stream "
                "no data)")
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
            use_grad_based_estimate=self.use_grad_based_estimate)

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

    def unsupported(self, model: Model, device=None) -> list:
        """What this package does not take on ``device``, each with the
        ROADMAP.md item that ports it (queue 1)."""
        reasons = []
        if self.posterior_kernel == "sync":
            reasons.append("posterior_kernel='sync' (item 8, the sync "
                           "engines: kernels/mclmc.py::mclmc_draw)")
        elif self.posterior_kernel != "pallas":
            raise ValueError(
                f"unknown posterior_kernel {self.posterior_kernel!r}")
        if self.mass_matrix == "low_rank":
            reasons.append("mass_matrix='low_rank' (item 14)")
        elif self.mass_matrix == "flow":
            reasons.append("mass_matrix='flow' (items 8 and 15: the JAX "
                           "package refits MCLMC's flow on its sync MCLMC "
                           "engine, which item 8 ports)")
        elif self.mass_matrix != "diag":
            raise ValueError(f"unknown mass_matrix {self.mass_matrix!r}")
        if (self.store_gradient or self.store_unconstrained
                or self.store_transformed or self.store_divergences
                or self.store_mass_matrix):
            reasons.append("store_* extra stores (item 9)")
        if self.cross_chain_adaptation or self.mesh_axis_name is not None:
            reasons.append("cross-chain adaptation / meshes (item 17)")
        return reasons + _model_reasons(model, 10, device, ld=False)

    def build_phases(self, model: Model, config: ChainConfig, device=None):
        """``[(start, end, runner)]`` as the JAX package plans them
        (``sampler.py:405-492``): fused warmup split at the Euclidean ->
        microcanonical switch, then the fused posterior (the diagonal
        adaptation runs in the kernels).  Raises
        ``NotImplementedError`` for what :meth:`unsupported` lists."""
        _refuse(self.unsupported(model, device))
        if model.dim < 2 and self.trajectory_kind is not (
                MclmcTrajectoryKind.EUCLIDEAN):
            raise ValueError("the microcanonical dynamics need dim >= 2 "
                             "(the ESH step divides by dim - 1)")
        total = self.num_tune + self.num_draws
        sw = self.switch_draw
        if sw is None:
            warm = [(0, total)]
        else:
            warm = [(0, sw), (sw, total)]
        phases = []
        for lo, hi in warm:
            if lo >= self.num_tune:
                continue
            hi = min(hi, self.num_tune)
            if sw is None:
                kind = self.trajectory_kind
            elif hi <= sw:
                kind = MclmcTrajectoryKind.EUCLIDEAN
            else:
                kind = MclmcTrajectoryKind.MICROCANONICAL
            phases.append((lo, hi, make_fused_mclmc_warmup_runner(
                model, config, self._mclmc_options(kind), self.seed)))
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
    flow.  Refused for now (items 8 and 15)."""
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
    """

    def __init__(self, model: Model, settings,
                 storage: Optional[StorageConfig] = None,
                 chunk_size: int = 128, init_positions=None, *,
                 device="cuda"):
        if model.dim < 1:
            raise ValueError("model.dim must be >= 1")
        if chunk_size < 1:
            raise ValueError("chunk_size must be >= 1")
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
        self.config = settings.chain_config()
        self.strategy = _strategy_for(settings, self.config)
        # a NUTS plan runs the strategy's sync warmup where it has one
        extra = ({"strategy": self.strategy}
                 if isinstance(settings, NutsSettings) else {})
        self._phase_runners = settings.build_phases(
            model, self.config, self.device, **extra)
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

    @property
    def finished(self) -> bool:
        return self._next_draw >= self._total

    def run_next_chunk(self):
        """Run one chunk and stream it to storage.  Returns ``(lo, stats,
        tuning)``: the chunk's first global draw index, the host stats dict
        (``stats[name]`` shaped [chains, k, ...]) and the tuning mask."""
        lo = self._next_draw
        start, end, runner = next(
            (s, e, r) for s, e, r in self._phase_runners if s <= lo < e)
        hi = min(lo + self.chunk_size, self._total, end)
        t0 = time.monotonic()
        flags = self.settings.extra_flags(
            _schedule_chunk(self.schedule, lo, hi), lo, hi)
        self.state, stats = runner(self.state, flags)
        self._next_draw = hi
        return self._finish_chunk(lo, hi, stats, t0)

    def _finish_chunk(self, lo, hi, stats, t0):
        # device -> host; [k, C, ...] -> [C, k, ...]
        stats = {k: np.moveaxis(v.cpu().numpy(), 0, 1)
                 for k, v in stats.items()}
        self.chunk_seconds.append((lo, hi, time.monotonic() - t0))
        tuning = self.schedule.is_tuning[lo:hi]
        self.trace.record_chunk(lo, stats, tuning)
        return lo, stats, tuning

    def run(self) -> Trace:
        while not self.finished:
            self.run_next_chunk()
        return self.trace.finalize()

    def schema(self):
        """The trace schema: ``{group: {name: {"dtype", "shape", "dims"}}}``
        for the four draw groups plus ``"coords"`` and ``"events"``, as
        ``nuts_rs_tpu``'s ``Sampler.schema`` reflects it for these
        settings."""
        return schema(self.model, self.settings)


def schema(model: Model, settings=None):
    """Settings-level trace schema, without a sampler or a device."""
    settings = settings or NutsSettings()
    dtypes = _STAT_DTYPES[settings.sampler_name]

    def entry(name):
        shape = (model.dim,) if name == "position" else ()
        return {"dtype": np.dtype(dtypes[name]), "shape": shape,
                "dims": dims_for_tail(model, name, shape)}

    draws = {n: entry(n) for n in dtypes if n in _POSTERIOR_STAT_KEYS}
    stats = {n: entry(n) for n in dtypes if n not in _POSTERIOR_STAT_KEYS}
    scalar = {"dtype": np.dtype(np.int64), "shape": (), "dims": []}
    return {
        "posterior": dict(draws) if settings.num_draws else {},
        "sample_stats": dict(stats) if settings.num_draws else {},
        "warmup_posterior": dict(draws) if settings.num_tune else {},
        "warmup_sample_stats": dict(stats) if settings.num_tune else {},
        "coords": dict(model.coords or {}),
        "events": {"divergence": {"draw": dict(scalar)},
                   "transformation_update": {
                       "draw": dict(scalar),
                       "transformation_update_id": dict(scalar)}},
    }


def sample(model: Model, settings=None, *,
           seed: Optional[int] = None,
           storage: Optional[StorageConfig] = None, chunk_size: int = 128,
           init_positions=None, device="cuda") -> Trace:
    """Sample from ``model`` on ``device`` (the card unless the caller asks
    for the CPU); returns an in-memory :class:`Trace` unless another storage
    backend is given."""
    settings = settings or NutsSettings()
    if seed is not None:
        settings = dataclasses.replace(settings, seed=seed)
    return Sampler(model, settings, storage=storage, chunk_size=chunk_size,
                   init_positions=init_positions, device=device).run()

