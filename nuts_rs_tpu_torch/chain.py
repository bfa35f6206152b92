"""Chain state, initialization, the per-draw sync engine's step and the
fused-engine phase runners.

Port of ``nuts_rs_tpu/chain.py``: ``ChainState`` / ``ChainConfig`` /
``DiagStrategy`` (``:73-200``), ``make_draw_step`` (``:217-423``: one draw
of the sync NUTS engine, ``kernels/nuts.py``, and its adaptation, for the
draw-index schedule), ``init_chain_state`` (``:426-515``), the
fused NUTS runners ``make_pallas_posterior_runner`` (``:663-943``) and
``make_pallas_warmup_runner`` (``:946-1200``), and the fused MCLMC runners
``make_pallas_mclmc_posterior_runner`` (``:1203-1337``) and
``make_pallas_mclmc_warmup_runner`` (``:1340-1525``), for the diagonal mass
matrix; the sync engine's step and the fused NUTS posterior also take a
learned flow (``adapt/flow.py``: the strategy's ``ops``, and the frozen
pooled flow in kernel K1-flow, ``:694-727,812-835``).  The posterior
runner streams a model's data in row
tiles (kernel K1-stream) where they fail the resident kernels' size rule and
the streamed tiles pass it, as the JAX runner does (``:740-765``).  All four
runners pass a model's data to
the kernels (``chain.py:677-678,881``, ``:970-971,1112``, ``:1219-1220,1291``
and ``:1363-1364,1445``; here the data travel in ``Model.kernel_hook``).
Like the JAX runners
(``chain.py:757-784,1005-1028``), the NUTS runners take the chains-on-lanes
layout while a model and its data fit it (``cl_max_dim``) and the
dim-on-lanes layout (``layout="ld"``, with the model's data where it has
them) above that.

The chain axis is the leading axis of every state tensor.  Randomness comes
from the counter hash (kernels/rng.py): each launch's seed is derived from
(base seed, global draw index, purpose), where the JAX runners derive theirs
from threefry keys.  The two packages therefore agree in distribution, not
draw for draw.  Unlike the JAX runners, a chunk is one launch: the VMEM
tiers and the cap of 64 draws per launch (``chain.py:710-745,993-1053``) do
not apply, since device memory holds a whole chunk's outputs, but for the
streamed kernel's chain block (:func:`stream_block`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional

import torch

from .adapt import mass_matrix as mm
from .adapt import step_size as ss
from .adapt.schedule import WindowParams
from .dynamics.hamiltonian import init_point_from_q, sample_momentum
from .dynamics.point import Point, chains_where
from .dynamics.hamiltonian import KineticKind
from .kernels import mclmc_fused as mf
from .kernels import nuts_fused as nf
from .kernels import _build
from .kernels.nuts import SALT_JITTER, NutsOptions, nuts_draw
from .kernels.rng import derive_seed, host_uniform
from .ops import hsum
from .transform.ops import AFFINE_OPS
from .transform.affine import (
    AffineTransform,
    grad_to_transformed,
    identity_transform,
    init_diag_from_grad,
    to_transformed,
)

# Purposes of the derived seeds (see kernels/rng.py::derive_seed).
PURPOSE_INIT_SEARCH = 1
PURPOSE_REINIT_SEARCH = 2
PURPOSE_WARMUP = 3
PURPOSE_POSTERIOR = 4
PURPOSE_LAUNCH_STEP = 5
PURPOSE_MCLMC_WARMUP = 6
PURPOSE_MCLMC_POSTERIOR = 7
PURPOSE_SYNC_DRAW = 8
PURPOSE_SYNC_MCLMC_DRAW = 9
PURPOSE_EXPAND = 11  # a chunk's expand_fn generator, under seed + 1

# The JAX runners' VMEM budgets in bytes (posterior ``chain.py:742-743``,
# warmup ``:1008-1009``), kept so that a configuration takes the same path
# in both packages.
POSTERIOR_BUDGET_BYTES = 12_500_000
WARMUP_BUDGET_BYTES = 12_000_000

# Draws of init positions for chains with a non-finite logp or gradient.
INIT_RETRIES = 500


def cl_max_dim(maxdepth: int, warmup: bool = False,
               args_bytes: int = 0) -> int:
    """Largest d the chains-on-lanes layout takes: the JAX package's VMEM
    rule at its smallest lane block (128 chains) for the posterior runner
    (``chain.py:719-721,740-745``) or, with ``warmup``, for the warmup
    runner, whose launch also holds the estimator planes
    (``chain.py:1001-1011``).  ``args_bytes`` are the bytes of the model's
    data, which the rule adds to the launch's footprint, so the limit falls
    as the data grow (negative: no d fits).  Kept so that one configuration
    takes the same layout in both packages.  Without data the limits at
    maxdepth 10 are 212 and 178: in between, the warmup runs dim-on-lanes
    and the posterior chains-on-lanes, as in the JAX package."""
    stacks = 6 * (maxdepth + 1)
    if warmup:
        return (((WARMUP_BUDGET_BYTES - args_bytes) // (4 * 128) - 16 * 15)
                // (stacks + 48 + 16))
    return (((POSTERIOR_BUDGET_BYTES - args_bytes) // (4 * 128) - 4 - 16 * 13)
            // (stacks + 32 + 16))


def mclmc_max_dim(warmup: bool = False, args_bytes: int = 0) -> int:
    """Largest d the fused MCLMC posterior or, with ``warmup``, warmup kernel
    takes: the JAX MCLMC runners' VMEM rule at their smallest lane block
    (128 chains), ``4 * 128 * (fixed + 16 * (d + rows)) + args_bytes <=
    12_000_000`` with ``fixed = 32 d + 64`` and 8 stat rows for the
    posterior (``chain.py:1242-1250``) and ``fixed = 48 d + 128`` and 9 for
    the warmup, whose launch also holds the estimator planes
    (``:1386-1394``).  No checkpoint stacks enter, so the limits are not the
    NUTS layouts': without data 484 and 361.  ``args_bytes`` are the bytes
    of the model's data (negative result: no d fits).  Above a limit the
    JAX runner is ``None`` and the JAX package runs its sync engine there;
    the limit is kept so that one configuration takes the fused kernels in
    both packages or in neither."""
    words = (12_000_000 - args_bytes) // (4 * 128)
    if warmup:
        return (words - 128 - 16 * 9) // (48 + 16)
    return (words - 64 - 16 * 8) // (32 + 16)


def mclmc_fused_fits(model, warmup: bool) -> bool:
    """Whether the JAX MCLMC posterior or, with ``warmup``, warmup runner
    takes ``model`` (:func:`mclmc_max_dim` with the data's bytes).  Above
    the posterior limit the JAX package runs the whole run on its sync MCLMC
    engine, with a ``UserWarning`` (``nuts_rs_tpu/sampler.py:431-438``);
    between the warmup and the posterior limit it runs the per-draw sync
    warmup and the fused posterior, without one (``:457-491``).  The port
    plans the same (``MclmcSettings.build_phases``)."""
    return model.dim <= mclmc_max_dim(warmup, model.data_bytes)


def stream_bytes(model) -> int:
    """Bytes of the double-buffered tile the JAX stream kernel keeps on chip
    (``chain.py:760-761``): two tiles of ``tile_rows`` rows of the JAX
    model's packed array, whose ``(x, y, w)`` columns are padded to a
    multiple of 128 (``models/gaussian.py:196``).  The port packs nothing;
    the number is the size rule's alone."""
    pcols = -(-(model.dim + 2) // 128) * 128
    return 4 * 2 * model.stream_tile_rows * pcols


# The JAX posterior runner's chains-on-lanes tiers (``chain.py:53-70``).
CL_TIERS = (256, 128)


def stream_block(model, maxdepth: int, num_chains: int) -> int:
    """The logical chain block of kernel K1-stream: the JAX posterior
    runner's for the same model and chains.  The runner takes the largest
    tier in (256, 128) whose footprint ``4 tier (fixed + 16 (d + 13))`` with
    ``fixed = 6 (D + 1) d + 32 d + 4`` and the stream's double tile
    (:func:`stream_bytes`) fits its 12.5 MB (``chain.py:719-721,740-765``),
    and ``nuts_pallas_run`` makes it ``B = min(tier, C)`` and asserts that B
    divides the chains (``nuts_pallas.py:763-764``).  For
    ``logistic_regression(131072, 100)`` at maxdepth 10 the footprint at 256
    is 12,414,976 bytes: one block of all 256 chains.  Raises where the JAX
    runner refuses: no tier fits (it has no fused posterior for the model)
    or B does not divide the chains."""
    d = model.dim
    fixed = 6 * (maxdepth + 1) * d + 32 * d + 4
    for tier in CL_TIERS:
        if (4 * tier * (fixed + 2 * 8 * (d + 13)) + stream_bytes(model)
                <= POSTERIOR_BUDGET_BYTES):
            break
    else:
        raise ValueError(
            f"model {model.name!r} at dim {d} streams in no chain block of "
            f"{CL_TIERS}: the JAX posterior runner has no fused kernel for it")
    B = min(tier, num_chains)
    if num_chains % B:
        raise ValueError(f"num_chains ({num_chains}) must be a multiple of "
                         f"the streamed kernel's chain block ({B}, the JAX "
                         "runner's)")
    return B


def _ld_tier_fits(model, maxdepth: int, warmup: bool) -> bool:
    """Whether the JAX runner would take its dim-on-lanes layout for
    ``model``, with or without data (``chain.py:773-784``, ``:1017-1028``,
    smallest tier 8): where it does not, the runner is None and the JAX
    package runs its sync engine."""
    dim_pad = -(-model.dim // 128) * 128
    D1 = maxdepth + 1
    fixed_ld = (6 * D1 + (48 if warmup else 32)) * dim_pad + D1 ** 2 + 64 * 128
    return (4 * 8 * (fixed_ld + 2 * 8 * (dim_pad + 128)) + model.data_bytes
            <= WARMUP_BUDGET_BYTES)


def fused_layout(model, config: "ChainConfig", warmup: bool, device=None):
    """How the fused NUTS warmup or posterior kernel takes ``model``:
    ``"cl"`` (chains-on-lanes, data resident), ``"ld"`` (dim-on-lanes,
    with the model's data where it has them), ``"stream"`` (posterior only:
    chains-on-lanes with the data streamed in row tiles, kernel K1-stream)
    or None where the JAX runner is None, as the JAX runners choose
    (``chain.py:740-790``, ``:1001-1030``).  Above the chains-on-lanes
    limit the JAX runners take their dim-on-lanes layout while the model
    and its data fit that tier (``:773-801``, ``:1017-1044``); data that
    fail the chains-on-lanes rule stream in the posterior first when two
    tiles pass it.  A None warmup leaves the warmup to the per-draw sync
    engine; a None posterior demotes the whole run to the sync engine
    (``NutsSettings.build_phases``, as ``nuts_rs_tpu/sampler.py:240-251``).
    On a CUDA ``device`` the resident chains-on-lanes kernels also need the
    functor's scratch in a block's shared memory; data beyond that stream,
    and their warmup is the sync one; where they cannot stream either, the
    JAX runner has a fused kernel the port lacks, and this raises
    ``NotImplementedError`` (item 12)."""
    D = config.nuts.maxdepth
    if model.dim > cl_max_dim(D, warmup, model.data_bytes):
        if (model.carries_data and not warmup
                and model.stream_tile_rows is not None
                and model.dim <= cl_max_dim(D, False, stream_bytes(model))):
            return "stream"
        return "ld" if _ld_tier_fits(model, D, warmup) else None
    if not model.carries_data:
        return "cl"
    on_cuda = device is not None and torch.device(device).type == "cuda"
    kind = "warmup" if warmup else "posterior"
    if not on_cuda or _build.mid_group(kind, model.dim, D, model) >= 1:
        return "cl"
    if model.stream_tile_rows is not None:
        return None if warmup else "stream"
    raise NotImplementedError(
        "not ported yet (see ROADMAP.md): model "
        f"{model.name!r} carries {model.data_bytes} bytes of data at dim "
        f"{model.dim}, which fit the chains-on-lanes rule but not a block's "
        "shared memory on the card, and cannot stream (item 12)")


class ChainState(NamedTuple):
    """All per-chain state; every tensor has a leading chains axis."""

    pt: Point
    transform: Any  # AffineTransform, or a FlowTransform (transform/ops.py)
    diag_adapt: mm.DiagAdaptState
    step: ss.StepSizeState
    draw_idx: int  # global draw counter
    window: Any = None  # WindowState when adapt.window_by_good_draws
    extra: Any = None  # the strategy's own state (a flow's FlowWindow)


@dataclasses.dataclass(frozen=True)
class ChainConfig:
    """Static configuration shared by all chains."""

    nuts: NutsOptions
    step_size: ss.StepSizeSettings
    use_grad_based_estimate: bool = True
    # Non-None switches the sync warmup to per-chain good-draw window
    # advancement (adapt_strategy.rs:121-216).
    window_params: Optional[WindowParams] = None
    # The extra stores (chain.py:119-123), which the sync draw steps emit;
    # a request with any of them runs on the sync engines.
    store_gradient: bool = False
    store_unconstrained: bool = False
    store_transformed: bool = False
    store_divergences: bool = False
    store_mass_matrix: bool = False


class WindowState(NamedTuple):
    """Per-chain ``GlobalStrategy`` counters of the good-draw window mode
    (nuts-rs ``src/adapt_strategy.rs:71-98``); the good-draw counts are the
    estimator counts in ``DiagAdaptState``."""

    current_window: torch.Tensor  # [C] float current_window_size
    last_update: torch.Tensor     # [C] int32 draw of the last mass update
    has_initial: torch.Tensor     # [C] bool has_initial_mass_matrix


class DiagStrategy:
    """Diagonal mass-matrix adaptation (nuts-rs ``DiagAdaptStrategy``).  The
    fused warmup kernels run the per-draw updates themselves; the sync
    engine's draw step calls them here."""

    def __init__(self, config: ChainConfig):
        self.config = config

    def make_transform(self, num_chains, dim, dtype, device):
        return identity_transform(num_chains, dim, dtype, device)

    def init_mass_matrix(self, state: ChainState) -> ChainState:
        """Feed the init point into the estimators and set sigma^2 = 1/|g|
        (nuts-rs transform/adapt/diagonal.rs:209-231)."""
        da = mm.update_estimators(state.diag_adapt, state.pt.q, state.pt.g,
                                  True)
        transform = init_diag_from_grad(state.transform, state.pt.q,
                                        state.pt.g)
        return state._replace(diag_adapt=da, transform=transform)

    def init_extra(self, dim, num_tune, dtype, num_chains, device):
        return None

    def update_estimators(self, state: ChainState, draw_q, draw_g, is_good,
                          logp=None, energy_error=None):
        return state._replace(diag_adapt=mm.update_estimators(
            state.diag_adapt, draw_q, draw_g, is_good))

    def switch(self, state: ChainState, mask=None) -> ChainState:
        """Promote the background estimators; with ``mask`` [C] only for
        those chains."""
        da = mm.switch(state.diag_adapt)
        if mask is not None:
            da = chains_where(mask, da, state.diag_adapt)
        return state._replace(diag_adapt=da)

    def adapt_update(self, state: ChainState, mask=None) -> ChainState:
        """The mass-matrix update from the foreground estimators; with
        ``mask`` [C] the other chains keep their transform untouched."""
        transform = mm.adapt_diag(
            state.diag_adapt, state.transform,
            use_grad_based_estimate=self.config.use_grad_based_estimate,
            update_mask=mask)
        return state._replace(transform=transform)


def _init_search(seed, state: ChainState, model, config: ChainConfig,
                 ops=AFFINE_OPS):
    """Step-size init search from the current positions, with momentum from
    the counter hash, then the dual-averaging reset."""
    q = state.pt.q
    v = sample_momentum(seed, 0, 1, 2, q.shape, q.dtype, q.device,
                        config.nuts.kind)
    found = ss.init_search(q, state.transform, v,
                           logp_grad_fn=model.logp_and_grad,
                           settings=config.step_size, kind=config.nuts.kind,
                           ops=ops)
    return state._replace(step=ss.reset_from_found_step(state.step, found))


def _mean0(x, n):
    return x / torch.clamp(n.to(x.dtype), min=1.0)


def make_draw_step(model, strategy: DiagStrategy, config: ChainConfig,
                   base_seed: int):
    """One draw of the sync NUTS engine and its adaptation for all chains:
    ``(state, flags) -> (state, stats)``, where ``flags`` is one row of the
    schedule as Python booleans and ``stats[name]`` is shaped [C, ...] with
    the names and dtypes of the fused runners' ``_stats``
    (``chain.py:217-423``).

    Randomness: the draw's seed is ``derive_seed(base_seed, draw index,
    PURPOSE_SYNC_DRAW)``; ``kernels/nuts.py`` documents the tree's sites
    under it, and the step-size jitter is the scalar site
    ``(seed, it 0, salt 7, chain)``.  The re-init search takes its momentum
    from ``derive_seed(base_seed, draw index + 1, PURPOSE_REINIT_SEARCH)``,
    as the fused warmup runner does after the same draw.  Every number is a
    function of (base seed, draw index, chain), so a checkpoint can hold
    the stream as counters.  The strategy is generic (``chain.py:224-262``):
    its ``ops`` (``transform/ops.py``; affine by default) carry the
    transform through the tree, its estimators get each draw's logp and
    energy error, and with ``use_orbit`` every leapfrog point of the draw."""
    logp_grad = model.logp_and_grad
    sset = config.step_size
    wp = config.window_params
    ops = getattr(strategy, "ops", AFFINE_OPS)

    def draw_step(state: ChainState, flags):
        seed = derive_seed(base_seed, state.draw_idx, PURPOSE_SYNC_DRAW)
        draw_pt, info = nuts_draw(seed, state.pt, state.transform,
                                  state.step.step_size, logp_grad,
                                  config.nuts, ops)
        state = state._replace(pt=draw_pt)
        C = draw_pt.q.shape[0]
        dev = draw_pt.q.device

        # --- step-size statistics from this draw's collector ---
        mean_acc = _mean0(info.sum_accept, info.n_steps)
        sym_acc = _mean0(info.sum_accept_sym, info.n_steps)

        def update(s):
            if getattr(strategy, "use_orbit", False):
                # flow orbit mode (external_adapt_strategy.rs:93-128)
                return strategy.update_estimators_orbit(s, info)
            return strategy.update_estimators(
                s, draw_pt.q, draw_pt.g, info.is_good_for_adapt,
                logp=draw_pt.logp, energy_error=info.energy_error)

        reinit_mask = None
        if wp is None:
            # --- mass-matrix window by the draw-index schedule
            # (adapt_strategy.rs:140-216) ---
            if flags["update_estimators"]:
                state = update(state)
            if flags["do_switch"]:
                state = strategy.switch(state)
            if flags["do_update"]:
                state = strategy.adapt_update(state)
            accept_stat = sym_acc if flags["use_late_estimator"] else mean_acc
        else:
            # --- good-draw window mode: per-chain GlobalStrategy::adapt
            # (adapt_strategy.rs:121-216).  The bg/fg good-draw counts are
            # the estimator counts; the other counters live in
            # state.window.  Without divergences it decides as the
            # schedule does on every draw.
            draw = state.draw_idx
            w = state.window
            in_win = bool(flags["is_tuning"]) and (
                draw < wp.final_step_size_window)
            is_early = draw < wp.early_end
            cw = w.current_window
            if draw == wp.early_end:
                # never shrink below the accumulated background count
                # (adapt_strategy.rs:144-150), read before this draw's update
                cw = torch.maximum(cw, state.diag_adapt.draw_bg.count)
            if in_win:
                state = update(state)
            bg_count = state.diag_adapt.draw_bg.count
            early_freq = torch.full_like(cw, float(wp.early_switch_freq))
            switch_freq = early_freq if is_early else cw
            # round half away from zero, like Rust's f64::round
            next_window = early_freq if is_early else torch.maximum(
                cw + 1.0, torch.floor(cw * wp.growth + 0.5))
            is_late = (next_window + float(draw)) > wp.final_step_size_window
            switch_mask = (bg_count >= switch_freq) & ~is_late
            if not in_win:
                switch_mask = torch.zeros_like(switch_mask)
            if bool(switch_mask.any()):
                state = strategy.switch(state, switch_mask)
            if not is_early:
                cw = torch.where(switch_mask, next_window, cw)
            update_mask = switch_mask | (
                (draw - w.last_update) >= wp.update_freq)
            if not in_win:
                update_mask = torch.zeros_like(update_mask)
            enough = state.diag_adapt.draw.count >= 3.0
            if bool(update_mask.any()):
                state = strategy.adapt_update(state, update_mask)
            did_change = update_mask & enough
            state = state._replace(window=WindowState(
                current_window=cw,
                last_update=torch.where(did_change,
                                        torch.full_like(w.last_update, draw),
                                        w.last_update),
                has_initial=w.has_initial & ~did_change))
            reinit_mask = did_change & w.has_initial
            use_late = is_late | (not in_win)
            accept_stat = torch.where(use_late, sym_acc, mean_acc)

        # --- dual averaging advance (early: plain mean; late: symmetric) ---
        step_state = state.step
        if flags["advance_da"]:
            step_state = ss.advance(step_state, accept_stat, sset)

        # --- step size for the next draw ---
        def with_reinit(stp):
            # first mass-matrix change: the coarse init search from the
            # current position with the new transform
            # (adapt_strategy.rs:207-212)
            return _init_search(
                derive_seed(base_seed, state.draw_idx + 1,
                            PURPOSE_REINIT_SEARCH),
                state._replace(step=stp), model, config, ops).step

        def without_reinit(stp):
            u = host_uniform(seed, 0, SALT_JITTER, (C,), dev)
            return ss.apply_jitter(u, stp, sset, bool(flags["use_best_guess"]))

        if reinit_mask is None:
            step_state = (with_reinit(step_state) if flags["reinit_step_size"]
                          else without_reinit(step_state))
        elif bool(reinit_mask.any()):
            step_state = chains_where(reinit_mask, with_reinit(step_state),
                                        without_reinit(step_state))
        else:
            step_state = without_reinit(step_state)
        state = state._replace(step=step_state, draw_idx=state.draw_idx + 1)

        # --- per-draw stats record ---
        stats = {
            "position": draw_pt.q,
            "depth": info.depth,
            "maxdepth_reached": info.reached_maxdepth,
            "diverging": info.diverging,
            "n_steps": info.n_steps,
            "step_size": state.step.step_size,
            "step_size_bar": ss.step_size_bar(state.step, sset),
            "mean_tree_accept": mean_acc,
            "mean_tree_accept_sym": sym_acc,
            "max_energy_error": info.max_energy_error,
            "logp": draw_pt.logp,
            "energy": info.energy,
            "energy_error": info.energy_error,
            "index_in_trajectory": info.idx_in_trajectory,
            "fisher_distance": torch.sum(
                torch.square(draw_pt.z + draw_pt.zg), -1),
            "transformation_index": state.transform.id,
            "tuning": torch.full((C,), bool(flags["is_tuning"]), device=dev),
        }
        stats.update(extra_stats(config, state, draw_pt, info.divergence,
                                 transformed=True))
        return state, stats

    return draw_step


def extra_stats(config: ChainConfig, state: ChainState, draw_pt,
                divergence, transformed: bool):
    """The extra stores of a sync draw step (``chain.py:391-411`` for NUTS,
    ``:575-592`` for MCLMC, which stores no transformed point): the draw's
    gradient and position, its transformed point, the divergence's
    forensics (the seven ``divergence_*`` fields; a draw that did not
    diverge keeps the empty record: NaN vectors, reason 0) and the
    transform after the draw's adaptation."""
    stats = {}
    if config.store_gradient:
        stats["gradient"] = draw_pt.g
    if config.store_unconstrained:
        stats["unconstrained_draw"] = draw_pt.q
    if config.store_transformed and transformed:
        stats["transformed_position"] = draw_pt.z
        stats["transformed_gradient"] = draw_pt.zg
    if config.store_divergences:
        stats["divergence_start"] = divergence.start_location
        stats["divergence_start_gradient"] = divergence.start_gradient
        stats["divergence_start_momentum"] = divergence.start_momentum
        stats["divergence_end"] = divergence.end_location
        stats["divergence_momentum"] = divergence.end_momentum
        stats["divergence_energy_error"] = divergence.energy_error
        # 0 none, 1 energy, 2 non-finite logp, 3 non-finite gradient
        # (hamiltonian.rs:26-55)
        stats["divergence_reason"] = divergence.reason
    if config.store_mass_matrix:
        stats["mass_matrix_inv"] = state.transform.stds
        stats["transformation_mu"] = state.transform.mean
    return stats


def make_mclmc_draw_step(model, strategy: DiagStrategy, config: ChainConfig,
                         mopts, base_seed: int):
    """One draw of the sync MCLMC engine and its adaptation for all chains
    (``chain.py:517-600``; nuts-rs ``MclmcChain::draw``,
    src/mclmc.rs:487-546): ``(state, flags) -> (state, stats)``, ``flags``
    one row of the schedule as Python booleans with ``resample_velocity``,
    ``stats[name]`` shaped [C, ...] with the names and dtypes of the fused
    MCLMC runners' ``_mclmc_stats``.  The estimators see the trajectory's
    end; the step size is the fixed value, jittered every draw.

    Randomness: the draw's seed is ``derive_seed(base_seed, draw index,
    PURPOSE_SYNC_MCLMC_DRAW)``; ``kernels/mclmc.py`` documents the draw's
    sites under it, and the jitter is its scalar site
    ``(seed, it 0, salt 11, chain)``."""
    from .kernels.mclmc import SALT_JITTER as MCLMC_SALT_JITTER
    from .kernels.mclmc import mclmc_draw

    logp_grad = model.logp_and_grad
    sset = config.step_size
    ops = getattr(strategy, "ops", AFFINE_OPS)

    def draw_step(state: ChainState, flags):
        seed = derive_seed(base_seed, state.draw_idx, PURPOSE_SYNC_MCLMC_DRAW)
        draw_pt, info = mclmc_draw(seed, state.pt, state.transform,
                                   state.step.step_size, logp_grad, mopts,
                                   bool(flags["resample_velocity"]), ops)
        state = state._replace(pt=draw_pt)
        C = draw_pt.q.shape[0]
        dev = draw_pt.q.device
        # --- adaptation: the collector sees the trajectory's end ---
        if flags["update_estimators"]:
            state = strategy.update_estimators(
                state, info.draw_q, info.draw_g, info.is_good_for_adapt,
                logp=info.draw_logp, energy_error=info.energy_change)
        if flags["do_switch"]:
            state = strategy.switch(state)
        if flags["do_update"]:
            state = strategy.adapt_update(state)
        # the fixed step, jittered every draw (StepSizeAdaptMethod::Fixed
        # with the default 10% jitter)
        u = host_uniform(seed, 0, MCLMC_SALT_JITTER, (C,), dev)
        state = state._replace(
            step=ss.apply_jitter(u, state.step, sset,
                                 bool(flags["use_best_guess"])),
            draw_idx=state.draw_idx + 1)
        stats = {
            "position": draw_pt.q,
            "diverging": info.diverging,
            "n_steps": info.num_steps,
            "energy_change": info.energy_change,
            "log_weight": info.log_weight,
            "average_step_size": info.average_step_size,
            "step_size": state.step.step_size,
            "logp": draw_pt.logp,
            "energy": draw_pt.energy,
            "fisher_distance": torch.sum(
                torch.square(draw_pt.z + draw_pt.zg), -1),
            "transformation_index": state.transform.id,
            "tuning": torch.full((C,), bool(flags["is_tuning"]), device=dev),
        }
        stats.update(extra_stats(config, state, draw_pt, info.divergence,
                                 transformed=False))
        return state, stats

    return draw_step


def _run_rows(step, state: ChainState, flags, tick=None):
    """A chunk of a draw step: ``flags`` the chunk's schedule rows, the
    stats stacked to [k, C, ...] (``sampler.py::_scan_chunk``).  ``tick``,
    where given, is ``(every, fn)``: after every ``every``-th draw of the
    chunk, ``fn(done, divergences, steps, last_steps, step_size)`` with the
    chunk's running sums of ``diverging`` and ``n_steps`` per chain, as
    the JAX package's ``_scan_chunk_ticked`` sends them
    (``nuts_rs_tpu/sampler.py:724-755``; a plain call here)."""
    rows = []
    divs = steps = None
    for i in range(len(flags["is_tuning"])):
        state, stats = step(state, {name: bool(v[i])
                                    for name, v in flags.items()})
        rows.append(stats)
        if tick is not None:
            every, fn = tick
            nst = stats["n_steps"].to(torch.int32)
            div = stats["diverging"].to(torch.int32)
            divs = div if divs is None else divs + div
            steps = nst if steps is None else steps + nst
            if (i + 1) % every == 0:
                fn(i + 1, divs, steps, nst, stats["step_size"])
    return state, {name: torch.stack([r[name] for r in rows])
                   for name in rows[0]}


def make_sync_runner(model, strategy: DiagStrategy, config: ChainConfig,
                     base_seed: int):
    """Phase runner of the per-draw sync NUTS engine, with the fused
    runners' signature: ``(state, flags) -> (state, stats)``, ``flags`` the
    chunk's schedule rows and ``stats[name]`` shaped [k, C, ...]
    (``sampler.py::_scan_chunk`` over ``make_draw_step``), with ``tick`` as
    :func:`_run_rows` takes it."""
    step = make_draw_step(model, strategy, config, base_seed)

    def runner(state: ChainState, flags, tick=None):
        return _run_rows(step, state, flags, tick)

    runner.ticks = True  # takes the sampler's progress_tick
    return runner


def make_sync_mclmc_runner(model, strategy: DiagStrategy, config: ChainConfig,
                           mopts, base_seed: int):
    """Phase runner of the per-draw sync MCLMC engine
    (``make_mclmc_draw_step``), with ``make_sync_runner``'s signature; the
    schedule rows carry ``resample_velocity``."""
    step = make_mclmc_draw_step(model, strategy, config, mopts, base_seed)

    def runner(state: ChainState, flags, tick=None):
        return _run_rows(step, state, flags, tick)

    runner.ticks = True
    return runner


def init_chain_state(seed: int, model, strategy: DiagStrategy,
                     config: ChainConfig, num_chains: int, dtype, device,
                     init_positions=None, num_tune: int = 0) -> ChainState:
    """Set up all chains: init positions (with retries for non-finite logp
    or gradient, as nuts-rs src/sampler.rs:1133-1143), the mass-matrix init,
    the re-sync of the point to the new transform and the step-size search,
    through the strategy's ``ops`` (``chain.py:470-512``)."""
    ops = getattr(strategy, "ops", AFFINE_OPS)
    C, d = num_chains, model.dim
    if init_positions is None:
        q0 = model.init_position(seed, 0, C, dtype, device)
        for attempt in range(1, INIT_RETRIES):
            logp, g = model.logp_and_grad(q0)
            ok = torch.isfinite(logp) & torch.isfinite(g).all(-1)
            if bool(ok.all()):
                break
            q_new = model.init_position(seed, attempt, C, dtype, device)
            q0 = torch.where(ok[:, None], q0, q_new)
    else:
        q0 = torch.as_tensor(init_positions, dtype=dtype, device=device)
    transform = strategy.make_transform(C, d, dtype, device)
    state = ChainState(
        pt=init_point_from_q(q0, transform, model.logp_and_grad, ops),
        transform=transform,
        diag_adapt=mm.new_diag_adapt_state(C, d, dtype, device),
        step=ss.new_step_size_state(config.step_size.initial_step, C, dtype,
                                    device),
        draw_idx=0,
        window=(None if config.window_params is None else WindowState(
            current_window=torch.full(
                (C,), float(config.window_params.init_window), dtype=dtype,
                device=device),
            last_update=torch.zeros(C, dtype=torch.int32, device=device),
            has_initial=torch.ones(C, dtype=torch.bool, device=device))),
        extra=strategy.init_extra(d, num_tune, dtype, C, device),
    )
    state = strategy.init_mass_matrix(state)
    state = state._replace(pt=init_point_from_q(
        state.pt.q, state.transform, model.logp_and_grad, ops))
    return _init_search(derive_seed(seed, 0, PURPOSE_INIT_SEARCH), state,
                        model, config, ops)


def _stats(draws, out, bars, tid, tuning):
    """Per-draw stats dict of [k, C, ...] tensors (chain.py:917-940).
    ``draws`` is [C, k, d]: a view of the cl kernels' [k, d, C] output,
    copied here into [k, C, d], or of the ld kernels' [k, C, d] output,
    which ``contiguous`` passes through without a copy."""
    k = draws.shape[1]

    def t(x):
        return x.T.contiguous()

    n = torch.clamp(out["n_steps"], min=1.0)
    return {
        "position": draws.permute(1, 0, 2).contiguous(),
        "depth": t(out["depth"]).to(torch.int32),
        "maxdepth_reached": t(out["maxdepth_reached"]) > 0.5,
        "diverging": t(out["diverging"]) > 0.5,
        "n_steps": t(out["n_steps"]).to(torch.int32),
        "step_size": t(out["step_size"]),
        "step_size_bar": bars,
        "mean_tree_accept": t(out["sum_accept"] / n),
        "mean_tree_accept_sym": t(out["sum_accept_sym"] / n),
        "max_energy_error": t(out["max_energy_error"]),
        "logp": t(out["logp"]),
        "energy": t(out["energy"]),
        "energy_error": t(out["energy_error"]),
        "index_in_trajectory": t(out["index_in_trajectory"]).to(torch.int32),
        "fisher_distance": t(out["fisher_distance"]),
        "transformation_index": tid,
        "tuning": torch.as_tensor(tuning, device=draws.device)[:, None]
        .expand(k, draws.shape[0]).contiguous(),
    }


def _launch_step(base_seed, draw_idx, bars, jitter):
    """The jittered first step of a launch starting at ``draw_idx``: the
    counterpart of the JAX runners' ``launch_step`` (``chain.py:1264-1270``,
    threefry there, the counter hash here)."""
    u = host_uniform(derive_seed(base_seed, draw_idx, PURPOSE_LAUNCH_STEP),
                     0, 1, bars.shape, bars.device)
    return bars * ((1.0 - jitter) + (2.0 * jitter) * u)


def flow_cl_fits(dim: int, maxdepth: int, packed_arrays,
                 args_bytes: int = 0) -> bool:
    """Whether the JAX posterior runner takes a frozen flow at all: its
    chains-on-lanes VMEM rule at the smallest lane block (128 chains) with
    the flow's packed bytes beside the model's data and, for the backward
    pass's live activations, ``2 * n_layers * (hidden + 4 d)`` words more in
    the fixed footprint, where ``hidden`` is the largest leading size of a
    packed array, as that runner reads it (``chain.py:719-727,740-745``).
    Flows are chains-on-lanes only (``nuts_pallas.py:125-126``): where this
    fails, the JAX runner is None and the run stays on the sync engine."""
    flow_bytes = 4 * sum(int(a.numel()) for a in packed_arrays)
    n_layers = max(0, (len(packed_arrays) - 2) // 7)
    hidden = max((int(a.shape[0]) for a in packed_arrays), default=0)
    fixed = (6 * (maxdepth + 1) * dim + 32 * dim + 4
             + 2 * n_layers * (hidden + 4 * dim))
    return (4 * 128 * (fixed + 2 * 8 * (dim + 13)) + args_bytes + flow_bytes
            <= POSTERIOR_BUDGET_BYTES)


def make_flow_posterior_runner(model, strategy, config: ChainConfig,
                               phase_start: int, base_seed: int):
    """Posterior-phase runner on kernel K1-flow: the frozen pooled flow of
    ``strategy`` (``adapt/flow.py``), chain 0's parameters packed for every
    chain (``chain.py:694-727,812-835,886,897-910``).  The kernel's position
    operand carries z, with stds 1, mean 0 and logdet 0; its aux output
    carries the final z, from which the point is rebuilt through
    ``FlowOps.eval_from_z``.  None, as the JAX runner, where the flow has no
    kernel hooks, is not pooled, or fails :func:`flow_cl_fits`."""
    from .flows.coupling import tree_map

    spec = strategy.spec
    if spec.kernel_pack is None or not strategy.flow_settings.pool_chains:
        return None
    proto = strategy.make_transform(1, model.dim, torch.float32, "cpu")
    if not flow_cl_fits(model.dim, config.nuts.maxdepth,
                        spec.kernel_pack(tree_map(lambda v: v[0],
                                                  proto.params)).arrays,
                        model.data_bytes):
        return None
    sset = config.step_size

    def runner(state: ChainState, flags):
        k = len(flags["is_tuning"])
        C = state.pt.q.shape[0]
        t = state.transform
        bars = ss.step_size_bar(state.step, sset)
        step_in = state.step.step_size
        if sset.jitter is not None and state.draw_idx != phase_start:
            step_in = _launch_step(base_seed, state.draw_idx, bars,
                                   sset.jitter)
        seed = derive_seed(base_seed, state.draw_idx, PURPOSE_POSTERIOR)
        z = state.pt.z.contiguous()
        ones, zeros = torch.ones_like(z), torch.zeros_like(z)
        packed = spec.kernel_pack(tree_map(lambda v: v[0], t.params))
        _, z_f, _, draws, out = nf.nuts_fused_run(
            seed, z, state.pt.g.contiguous(), state.pt.logp, ones, zeros,
            torch.zeros_like(state.pt.logp), step_in, bars, k, model,
            config.nuts, sset.jitter, flow=packed)
        q_f, logp_f, g_f, zg_f, ld_f = strategy.ops.eval_from_z(
            t, z_f, model.logp_and_grad)
        pt = state.pt._replace(q=q_f, g=g_f, z=z_f, zg=zg_f, logp=logp_f,
                               logdet=ld_f)
        state = state._replace(
            pt=pt, step=state.step._replace(
                step_size=out["step_size"][:, -1].contiguous()),
            draw_idx=state.draw_idx + k)
        stats = _stats(draws, out, bars[None, :].expand(k, C).contiguous(),
                       t.id[None, :].expand(k, C).contiguous(),
                       flags["is_tuning"])
        return state, stats

    return runner


def make_fused_posterior_runner(model, config: ChainConfig, phase_start: int,
                                base_seed: int, device=None):
    """Posterior-phase runner on the fused engine: ``(state, flags) ->
    (state, stats)`` with ``stats[name]`` shaped [k, C, ...].  One launch
    per chunk, or None where :func:`fused_layout` gives the model no fused
    posterior.  ``device`` is where the sampler runs (:func:`fused_layout`
    needs it to choose between the resident and the streamed kernel)."""
    sset = config.step_size
    layout = fused_layout(model, config, warmup=False, device=device)
    if layout is None:
        return None
    stream = layout == "stream"
    if stream:
        layout = "cl"

    def runner(state: ChainState, flags):
        k = len(flags["is_tuning"])
        C = state.pt.q.shape[0]
        t = state.transform
        bars = ss.step_size_bar(state.step, sset)
        step_in = state.step.step_size
        # The first posterior draw keeps the warmup's step (chain.py:847-871);
        # a continuation launch gets a freshly jittered first step.
        if sset.jitter is not None and state.draw_idx != phase_start:
            step_in = _launch_step(base_seed, state.draw_idx, bars,
                                   sset.jitter)
        seed = derive_seed(base_seed, state.draw_idx, PURPOSE_POSTERIOR)
        q_f, g_f, logp_f, draws, out = nf.nuts_fused_run(
            seed, state.pt.q, state.pt.g, state.pt.logp, t.stds, t.mean,
            t.logdet, step_in, bars, k, model, config.nuts, sset.jitter,
            block=stream_block(model, config.nuts.maxdepth, C) if stream
            else None, layout=layout, stream=stream)
        pt = state.pt._replace(q=q_f, g=g_f, z=to_transformed(t, q_f),
                               zg=grad_to_transformed(t, g_f), logp=logp_f)
        state = state._replace(
            pt=pt, step=state.step._replace(
                step_size=out["step_size"][:, -1].contiguous()),
            draw_idx=state.draw_idx + k)
        stats = _stats(draws, out, bars[None, :].expand(k, C).contiguous(),
                       t.id[None, :].expand(k, C).contiguous(),
                       flags["is_tuning"])
        return state, stats

    return runner


_FLAG_COLUMNS = ((nf.FLAG_UPDATE_EST, "update_estimators"),
                 (nf.FLAG_DO_UPDATE, "do_update"),
                 (nf.FLAG_ADVANCE_DA, "advance_da"),
                 (nf.FLAG_USE_LATE, "use_late_estimator"),
                 (nf.FLAG_USE_BEST, "use_best_guess"),
                 (nf.FLAG_DO_SWITCH, "do_switch"))


def warmup_flags(flags, device, columns=_FLAG_COLUMNS):
    """The schedule flags of a chunk as a warmup kernel's [k, NFLAGS]
    int32 columns (``MCLMC_FLAG_COLUMNS`` for the MCLMC warmup kernel)."""
    k = len(flags["is_tuning"])
    cols = torch.zeros(k, nf.NFLAGS, dtype=torch.int32)
    for col, name in columns:
        cols[:, col] = torch.as_tensor(flags[name], dtype=torch.int32)
    return cols.to(device)


def _estimator_planes(a: mm.DiagAdaptState):
    """The [C, 8, d] fg/bg estimator planes the warmup kernels carry."""
    return torch.stack([a.draw.mean, a.draw.var_sum, a.grad.mean,
                        a.grad.var_sum, a.draw_bg.mean, a.draw_bg.var_sum,
                        a.grad_bg.mean, a.grad_bg.var_sum], 1).contiguous()


def pack_warmup_state(state: ChainState):
    """The estimator planes [C, 8, d] and scalar rows [C, NSCA] the warmup
    kernel carries (chain.py:1069-1089)."""
    a, st, t = state.diag_adapt, state.step, state.transform
    sca = torch.stack([st.step_size, st.log_step, st.log_step_adapted,
                       st.hbar, st.mu, st.count, a.draw.count,
                       a.draw_bg.count, t.id.to(st.step_size.dtype),
                       t.logdet], 1)
    return _estimator_planes(a), sca.contiguous()


def make_fused_warmup_runner(model, config: ChainConfig, base_seed: int,
                             device=None):
    """Warmup-phase runner on the fused engine, with the fg/bg estimators,
    the diagonal rule and dual averaging inside the kernel, or None where
    :func:`fused_layout` gives the model no fused warmup.  The step-size
    re-init search on the first mass-matrix change runs here, after the
    chunk whose last draw carries ``reinit_step_size`` (the sampler splits
    the warmup phase there)."""
    sset = config.step_size
    layout = fused_layout(model, config, warmup=True, device=device)
    if layout is None:
        return None

    def runner(state: ChainState, flags):
        k = len(flags["is_tuning"])
        st, t = state.step, state.transform
        est, sca = pack_warmup_state(state)
        seed = derive_seed(base_seed, state.draw_idx, PURPOSE_WARMUP)
        (q_f, g_f, logp_f, stds_f, mean_f, est_f, sca_f, draws,
         out) = nf.nuts_fused_warmup_run(
            seed, warmup_flags(flags, est.device), state.pt.q, state.pt.g,
            state.pt.logp, t.stds.contiguous(), t.mean.contiguous(), est,
            sca, model, config.nuts, sset, config.use_grad_based_estimate,
            layout=layout)

        def row(i):
            return sca_f[:, i].contiguous()

        def plane(p):
            return est_f[:, p].contiguous()

        transform = AffineTransform(
            mean=mean_f, stds=stds_f, inv_stds=1.0 / stds_f,
            logdet=row(nf.SCA_LOGDET), id=row(nf.SCA_TID).to(torch.int32))

        def rv(p, c):
            return mm.RunningVariance(mean=plane(p), var_sum=plane(p + 1),
                                      count=c)

        cfg, cbg = row(nf.SCA_CNT_FG), row(nf.SCA_CNT_BG)
        diag_adapt = mm.DiagAdaptState(draw=rv(0, cfg), grad=rv(2, cfg),
                                       draw_bg=rv(4, cbg), grad_bg=rv(6, cbg))
        step = st._replace(
            log_step=row(nf.SCA_DA_LS), log_step_adapted=row(nf.SCA_DA_LSA),
            hbar=row(nf.SCA_DA_HBAR), mu=row(nf.SCA_DA_MU),
            count=row(nf.SCA_DA_CNT), step_size=row(nf.SCA_STEP))
        pt = state.pt._replace(q=q_f, g=g_f, z=to_transformed(transform, q_f),
                               zg=grad_to_transformed(transform, g_f),
                               logp=logp_f, logdet=transform.logdet)
        state = state._replace(pt=pt, transform=transform,
                               diag_adapt=diag_adapt, step=step,
                               draw_idx=state.draw_idx + k)
        if flags["reinit_step_size"][-1]:
            # First mass-matrix change (adapt_strategy.rs:207-212).
            state = _init_search(
                derive_seed(base_seed, state.draw_idx, PURPOSE_REINIT_SEARCH),
                state, model, config)
        stats = _stats(draws, out, out["step_size_bar"].T.contiguous(),
                       out["transformation_index"].T.to(torch.int32),
                       flags["is_tuning"])
        return state, stats

    return runner


def _mclmc_stats(draws, out, tid, tuning):
    """MCLMC per-draw stats dict of [k, C, ...] tensors
    (chain.py:1318-1334,1507-1522); ``log_weight`` is the energy change, as
    nuts-rs stores it (mclmc.rs:441-442)."""
    k = draws.shape[1]

    def t(x):
        return x.T.contiguous()

    e_change = t(out["energy_change"])
    return {
        "position": draws.permute(1, 0, 2).contiguous(),
        "diverging": t(out["diverging"]) > 0.5,
        "n_steps": t(out["n_steps"]).to(torch.int32),
        "energy_change": e_change,
        "log_weight": e_change,
        "average_step_size": t(out["average_step_size"]),
        "step_size": t(out["step_size"]),
        "logp": t(out["logp"]),
        "energy": t(out["energy"]),
        "fisher_distance": t(out["fisher_distance"]),
        "transformation_index": tid,
        "tuning": torch.as_tensor(tuning, device=draws.device)[:, None]
        .expand(k, draws.shape[0]).contiguous(),
    }


def _mclmc_point(pt, transform, q, g, logp, v, kind):
    """The chain point after a launch: the transform's z and zg, and the
    kinetic energy of the carried velocity (0 on the unit sphere)."""
    ke = (torch.zeros_like(logp) if kind is KineticKind.MICROCANONICAL
          else 0.5 * hsum(v * v))
    return pt._replace(q=q, g=g, z=to_transformed(transform, q),
                       zg=grad_to_transformed(transform, g), logp=logp, v=v,
                       ke=ke, logdet=transform.logdet)


def make_fused_mclmc_posterior_runner(model, config: ChainConfig, mopts,
                                      phase_start: int, base_seed: int):
    """MCLMC posterior-phase runner on the fused engine: ``(state, flags) ->
    (state, stats)``, one launch per chunk.  The posterior never resamples
    the momentum in full, so the velocity threads from one launch to the
    next through the kernel's final ``v``."""
    sset = config.step_size

    def runner(state: ChainState, flags):
        k = len(flags["is_tuning"])
        t = state.transform
        bars = ss.step_size_bar(state.step, sset)
        # The first posterior draw keeps the warmup's step_next
        # (chain.py:1487-1495); a continuation launch gets a fresh jitter.
        step_in = state.step.step_size
        if sset.jitter is not None and state.draw_idx != phase_start:
            step_in = _launch_step(base_seed, state.draw_idx, bars,
                                   sset.jitter)
        seed = derive_seed(base_seed, state.draw_idx, PURPOSE_MCLMC_POSTERIOR)
        q_f, g_f, logp_f, v_f, draws, out = mf.mclmc_fused_run(
            seed, state.pt.q, state.pt.g, state.pt.logp, state.pt.v, t.stds,
            t.mean, t.logdet, step_in, bars, k, model, mopts, sset.jitter)
        state = state._replace(
            pt=_mclmc_point(state.pt, t, q_f, g_f, logp_f, v_f, mopts.kind),
            step=state.step._replace(
                step_size=out["step_size"][:, -1].contiguous()),
            draw_idx=state.draw_idx + k)
        C = state.pt.q.shape[0]
        stats = _mclmc_stats(draws, out,
                             t.id[None, :].expand(k, C).contiguous(),
                             flags["is_tuning"])
        return state, stats

    return runner


# the MCLMC warmup kernel's flag columns (chain.py:1402-1408)
MCLMC_FLAG_COLUMNS = ((mf.FLAG_UPDATE_EST, "update_estimators"),
                      (mf.FLAG_DO_UPDATE, "do_update"),
                      (mf.FLAG_DO_SWITCH, "do_switch"),
                      (mf.FLAG_RESAMPLE, "resample_velocity"))


def pack_mclmc_warmup_state(state: ChainState):
    """The estimator planes [C, 8, d] and scalar rows [C, NSCA] the MCLMC
    warmup kernel carries (chain.py:1410-1423)."""
    a, t = state.diag_adapt, state.transform
    sca = torch.stack([t.id.to(t.logdet.dtype), t.logdet, a.draw.count,
                       a.draw_bg.count], 1)
    return _estimator_planes(a), sca.contiguous()


def make_fused_mclmc_warmup_runner(model, config: ChainConfig, mopts,
                                   base_seed: int):
    """MCLMC warmup-phase runner on the fused engine, with the fg/bg
    estimators and the diagonal rule inside the kernel.  The step size is
    FIXED with per-draw jitter, so there is no dual averaging and no
    re-init search; the chunk's last state carries ``step_next``, the
    jittered step of the next phase's first draw (chain.py:1484-1495)."""
    sset = config.step_size

    def runner(state: ChainState, flags):
        k = len(flags["is_tuning"])
        t = state.transform
        est, sca = pack_mclmc_warmup_state(state)
        seed = derive_seed(base_seed, state.draw_idx, PURPOSE_MCLMC_WARMUP)
        (q_f, g_f, logp_f, v_f, stds_f, mean_f, est_f, sca_f, draws,
         out) = mf.mclmc_fused_warmup_run(
            seed, warmup_flags(flags, est.device, MCLMC_FLAG_COLUMNS),
            state.pt.q, state.pt.g, state.pt.logp, state.pt.v.contiguous(),
            t.stds.contiguous(), t.mean.contiguous(), est, sca, model, mopts,
            sset, config.use_grad_based_estimate)

        def row(i):
            return sca_f[:, i].contiguous()

        def rv(p, c):
            return mm.RunningVariance(mean=est_f[:, p].contiguous(),
                                      var_sum=est_f[:, p + 1].contiguous(),
                                      count=c)

        transform = AffineTransform(
            mean=mean_f, stds=stds_f, inv_stds=1.0 / stds_f,
            logdet=row(mf.SCA_LOGDET), id=row(mf.SCA_TID).to(torch.int32))
        cfg, cbg = row(mf.SCA_CNT_FG), row(mf.SCA_CNT_BG)
        diag_adapt = mm.DiagAdaptState(draw=rv(0, cfg), grad=rv(2, cfg),
                                       draw_bg=rv(4, cbg), grad_bg=rv(6, cbg))
        step_next = torch.full_like(logp_f, float(sset.fixed_value))
        if sset.jitter is not None:
            step_next = _launch_step(base_seed, state.draw_idx + k, step_next,
                                     sset.jitter)
        state = state._replace(
            pt=_mclmc_point(state.pt, transform, q_f, g_f, logp_f, v_f,
                            mopts.kind),
            transform=transform, diag_adapt=diag_adapt,
            step=state.step._replace(step_size=step_next),
            draw_idx=state.draw_idx + k)
        stats = _mclmc_stats(draws, out,
                             out["transformation_index"].T.to(torch.int32),
                             flags["is_tuning"])
        return state, stats

    return runner
