"""Flow (learned transform) adaptation strategy.

Port of ``nuts_rs_tpu/adapt/flow.py`` (nuts-rs
``src/external_adapt_strategy.rs``, ``ExternalTransformAdaptation``): a
step-size-only warmup with the transformation refit from collected draws,
every 10 draws for the first 100, then every ``transform_update_freq``, and
a final ``step_size_window`` fraction of the warmup that only tunes the step
size.  The reference's ``DrawCollector`` filter (finite position and
gradient, energy error at most ``transform_train_max_energy_error``) gates
the draws that enter the training window.

The flow is a :class:`~nuts_rs_tpu_torch.transform.ops.FlowSpec`
(``flows/coupling.py``).  A pooled refit trains one flow on every chain's
window; the per-chain branch refits chain by chain in a host loop.  The
mesh's ``all_gather`` and ``pmin`` of the JAX strategy (``:231-247,283-284``)
are item 17 of ROADMAP.md.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..flows.coupling import tree_map
from ..kernels.rng import derive_seed
from ..ops import ieee_matmul
from ..transform.ops import FlowOps, FlowSpec, FlowTransform
from .schedule import AdaptSchedule

# Purposes of the flow's derived seeds (kernels/rng.py::derive_seed), after
# chain.py's PURPOSE_*.
PURPOSE_FLOW_INIT = 9
PURPOSE_FLOW_REFIT = 10


@dataclasses.dataclass(frozen=True)
class FlowAdaptSettings:
    """nuts-rs ``FlowSettings`` (external_adapt_strategy.rs:17-40), with the
    JAX package's two additions: ``window_capacity`` (the fixed window's
    rows; default ``num_tune``, or ``min(8 num_tune, 32768)`` with
    ``use_orbit_for_training``, which collects every leapfrog point) and
    ``pool_chains`` (one flow trained on every chain's window)."""

    step_size_window: float = 0.07
    transform_update_freq: int = 128
    transform_train_max_energy_error: float = 20.0
    use_orbit_for_training: bool = False
    window_capacity: Optional[int] = None
    pool_chains: bool = True


class FlowWindow(NamedTuple):
    """Per-chain training window: every good draw so far (the reference's
    DrawCollector accumulates over the whole warmup, chain.rs:79)."""

    draws: torch.Tensor  # [C, cap, d]
    grads: torch.Tensor  # [C, cap, d]
    logps: torch.Tensor  # [C, cap]
    count: torch.Tensor  # [C] int32


def new_flow_window(num_chains, cap, dim, dtype, device) -> FlowWindow:
    return FlowWindow(
        draws=torch.zeros(num_chains, cap, dim, dtype=dtype, device=device),
        grads=torch.zeros(num_chains, cap, dim, dtype=dtype, device=device),
        logps=torch.zeros(num_chains, cap, dtype=dtype, device=device),
        count=torch.zeros(num_chains, dtype=torch.int32, device=device))


def flow_push(w: FlowWindow, q, g, logp, include) -> FlowWindow:
    """Append each chain's (q [C, d], g, logp [C]) where ``include`` [C] and
    its window has room."""
    C, cap = w.draws.shape[:2]
    ok = include & (w.count < cap)
    slot = torch.clamp(w.count, max=cap - 1).long()
    ar = torch.arange(C, device=q.device)
    draws, grads, logps = w.draws.clone(), w.grads.clone(), w.logps.clone()
    draws[ar, slot] = torch.where(ok[:, None], q, draws[ar, slot])
    grads[ar, slot] = torch.where(ok[:, None], g, grads[ar, slot])
    logps[ar, slot] = torch.where(ok, logp, logps[ar, slot])
    return FlowWindow(draws, grads, logps, w.count + ok.to(torch.int32))


def build_flow_schedule(num_tune: int, num_draws: int,
                        opts: FlowAdaptSettings) -> AdaptSchedule:
    """Per-draw flags replicating ``ExternalTransformAdaptation::adapt``
    (external_adapt_strategy.rs:191-237) by draw index."""
    total = num_tune + num_draws
    final_window = int(num_tune * (1.0 - opts.step_size_window))

    def z():
        return np.zeros(total, bool)

    is_tuning, update_est, do_update = z(), z(), z()
    use_late, use_best, advance = z(), z(), z()
    for draw in range(total):
        if draw >= num_tune:
            use_best[draw] = True
            continue
        is_tuning[draw] = True
        advance[draw] = True
        update_est[draw] = True
        if draw < final_window:
            if draw < 100:
                if draw > 0 and draw % 10 == 0:
                    do_update[draw] = True
            elif draw % opts.transform_update_freq == 0:
                do_update[draw] = True
        else:
            use_late[draw] = True
            use_best[draw] = draw == num_tune - 1
    return AdaptSchedule(
        is_tuning=is_tuning, update_estimators=update_est,
        do_switch=np.zeros(total, bool), do_update=do_update,
        use_late_estimator=use_late,
        reinit_step_size=np.zeros(total, bool), use_best_guess=use_best,
        advance_da=advance)


class FlowStrategy:
    """The strategy protocol of ``chain.make_draw_step`` for learned flow
    transforms.  ``seed`` keys the flow's own random draws (the first layer
    weights at init, a refit's training subset)."""

    def __init__(self, config, settings, spec: FlowSpec):
        self.config = config
        self.spec = spec
        self.ops = FlowOps(spec)
        self.flow_settings: FlowAdaptSettings = getattr(
            settings, "flow", FlowAdaptSettings())
        self.seed = int(getattr(settings, "seed", 0))
        self.use_orbit = self.flow_settings.use_orbit_for_training

    def make_transform(self, num_chains, dim, dtype, device):
        """Placeholder parameters (one set, as for q = 0, g = 1, shared by
        the chains), replaced in ``init_mass_matrix`` once the initial
        positions and gradients are known."""
        one = self.spec.init(0, dim, torch.zeros(1, dim, dtype=dtype,
                                                 device=device),
                             torch.ones(1, dim, dtype=dtype, device=device))
        params = tree_map(lambda x: x.expand(num_chains, *x.shape[1:]), one)
        return FlowTransform(params=params, id=torch.full(
            (num_chains,), -1, dtype=torch.int32, device=device))

    def init_extra(self, dim, num_tune, dtype, num_chains, device):
        default_cap = (min(num_tune * 8, 32768) if self.use_orbit
                       else num_tune)
        cap = max(1, self.flow_settings.window_capacity or default_cap)
        return new_flow_window(num_chains, cap, dim, dtype, device)

    def init_mass_matrix(self, state):
        """init_transformation from the first position and gradient
        (transformed_hamiltonian.rs:463-481), per chain."""
        q, g = state.pt.q, state.pt.g
        params = self.spec.init(
            derive_seed(self.seed, 0, PURPOSE_FLOW_INIT), q.shape[-1], q, g)
        return state._replace(transform=FlowTransform(
            params=params, id=torch.zeros(q.shape[0], dtype=torch.int32,
                                          device=q.device)))

    def update_estimators(self, state, q, g, is_good, logp=None,
                          energy_error=None):
        # DrawCollector filter (external_adapt_strategy.rs:129-152)
        max_err = self.flow_settings.transform_train_max_energy_error
        include = (torch.isfinite(energy_error) & (energy_error <= max_err)
                   & torch.isfinite(q).all(-1) & torch.isfinite(g).all(-1))
        return state._replace(extra=flow_push(state.extra, q, g, logp,
                                              include))

    def update_estimators_orbit(self, state, info):
        """Push every valid leapfrog point of this draw into the window, in
        creation order (DrawCollector with use_orbit_for_training,
        external_adapt_strategy.rs:93-128), with the per-draw filter applied
        per point."""
        w = state.extra
        cap, ocap = w.draws.shape[1], info.orbit_q.shape[1]
        max_err = self.flow_settings.transform_train_max_energy_error
        dev = w.count.device
        n_valid = torch.clamp(info.n_steps, max=ocap)
        rows = torch.arange(ocap, device=dev)[None, :]
        err = info.orbit_err
        include = ((rows < n_valid[:, None]) & torch.isfinite(err)
                   & (err <= max_err) & torch.isfinite(info.orbit_q).all(-1)
                   & torch.isfinite(info.orbit_g).all(-1))
        pos = (w.count[:, None].to(torch.int64)
               + torch.cumsum(include.to(torch.int64), 1) - 1)
        ok = include & (pos < cap)
        c, i = ok.nonzero(as_tuple=True)
        draws, grads, logps = w.draws.clone(), w.grads.clone(), w.logps.clone()
        draws[c, pos[c, i]] = info.orbit_q[c, i].to(draws.dtype)
        grads[c, pos[c, i]] = info.orbit_g[c, i].to(grads.dtype)
        logps[c, pos[c, i]] = info.orbit_logp[c, i].to(logps.dtype)
        count = w.count + ok.sum(1).to(torch.int32)
        return state._replace(extra=FlowWindow(draws, grads, logps, count))

    def switch(self, state, mask=None):
        return state

    def adapt_update(self, state, mask=None):
        """Refit the flow from the windows (pooled: one flow from every
        chain's window, given to every chain; else chain by chain), then keep
        a refit only where it is finite at the chain's current point (z, zg
        and logdet), all chains or none under pooling: the fused posterior
        packs chain 0's parameters for all of them."""
        w = state.extra
        C, cap, d = w.draws.shape
        seed = derive_seed(self.seed, state.draw_idx, PURPOSE_FLOW_REFIT)
        old = state.transform.params
        pooled = self.flow_settings.pool_chains and C > 1
        valid = (torch.arange(cap, device=w.count.device)[None, :]
                 < w.count[:, None])
        with ieee_matmul():
            if pooled:
                new0 = self.spec.update(
                    seed, tree_map(lambda v: v[0], old),
                    w.draws.reshape(C * cap, d), w.grads.reshape(C * cap, d),
                    w.logps.reshape(C * cap), valid.reshape(C * cap))
                params = tree_map(lambda v: v.expand(C, *v.shape), new0)
            else:
                news = [self.spec.update(
                    derive_seed(seed, c, PURPOSE_FLOW_REFIT),
                    tree_map(lambda v, c=c: v[c], old), w.draws[c],
                    w.grads[c], w.logps[c], valid[c]) for c in range(C)]
                params = tree_map(lambda *v: torch.stack(v), *news)
        z, zg, logdet = self.ops.eval_from_q(
            FlowTransform(params, state.transform.id), state.pt.q,
            state.pt.g)
        ok = (torch.isfinite(z).all(-1) & torch.isfinite(zg).all(-1)
              & torch.isfinite(logdet))
        if pooled:
            ok = ok.all().expand(C)

        def select(new, ol):
            return torch.where(ok.reshape((C,) + (1,) * (new.dim() - 1)),
                               new, ol)

        return state._replace(transform=FlowTransform(
            params=tree_map(select, params, old),
            id=state.transform.id + 1))
