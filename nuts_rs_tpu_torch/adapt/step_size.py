"""Step-size adaptation: dual averaging, Adam, fixed, and the init search.

Port of ``nuts_rs_tpu/adapt/step_size.py`` (whole), batched over chains:
every state field is a ``[C]`` tensor.  Mirrors nuts-rs ``src/stepsize/``.
Randomness (the jitter uniforms, the init-search momentum) is drawn by the
caller from the counter hash and passed in.
"""

from __future__ import annotations

import dataclasses
import enum
import math
from typing import NamedTuple, Optional

import torch

from ..dynamics.hamiltonian import (
    KineticKind,
    init_point_from_q,
    initialize_trajectory,
    leapfrog,
)
from ..transform.affine import AffineTransform
from ..transform.ops import AFFINE_OPS


class StepSizeMethod(enum.Enum):
    DUAL_AVERAGE = "dual_average"
    ADAM = "adam"
    FIXED = "fixed"


@dataclasses.dataclass(frozen=True)
class DualAverageOptions:
    """nuts-rs ``src/stepsize/dual_avg.rs:12-31``."""

    k: float = 0.75
    t0: float = 10.0
    gamma: float = 0.05
    max_step_size: float = math.pi


@dataclasses.dataclass(frozen=True)
class AdamOptions:
    """nuts-rs ``src/stepsize/adam.rs:13-34``."""

    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8
    learning_rate: float = 0.05


@dataclasses.dataclass(frozen=True)
class StepSizeSettings:
    """nuts-rs ``src/stepsize/adapt.rs:308-329``."""

    target_accept: float = 0.8
    initial_step: float = 0.1
    jitter: Optional[float] = 0.1
    method: StepSizeMethod = StepSizeMethod.DUAL_AVERAGE
    fixed_value: float = 0.5
    dual_average: DualAverageOptions = DualAverageOptions()
    adam: AdamOptions = AdamOptions()


class StepSizeState(NamedTuple):
    """Union of dual-averaging and Adam state; each field is [C]."""

    log_step: torch.Tensor
    log_step_adapted: torch.Tensor
    hbar: torch.Tensor
    mu: torch.Tensor
    count: torch.Tensor
    adam_m: torch.Tensor
    adam_v: torch.Tensor
    adam_t: torch.Tensor   # int32
    step_size: torch.Tensor


def new_step_size_state(initial_step, num_chains, dtype,
                        device) -> StepSizeState:
    step = torch.full((num_chains,), float(initial_step), dtype=dtype,
                      device=device)
    zeros = torch.zeros_like(step)
    return StepSizeState(
        log_step=torch.log(step), log_step_adapted=torch.log(step),
        hbar=zeros, mu=torch.log(10.0 * step), count=torch.ones_like(step),
        adam_m=zeros, adam_v=zeros,
        adam_t=torch.zeros(num_chains, dtype=torch.int32, device=device),
        step_size=step,
    )


def reset_from_found_step(state: StepSizeState, found_step) -> StepSizeState:
    """DualAverage::new / Adam::new with the step from the init search."""
    log_step = torch.log(found_step)
    return state._replace(
        log_step=log_step, log_step_adapted=log_step,
        hbar=torch.zeros_like(state.hbar), mu=torch.log(10.0 * found_step),
        count=torch.ones_like(state.count),
        adam_m=torch.zeros_like(state.adam_m),
        adam_v=torch.zeros_like(state.adam_v),
        adam_t=torch.zeros_like(state.adam_t),
        step_size=found_step,
    )


def advance(state: StepSizeState, accept_stat,
            settings: StepSizeSettings) -> StepSizeState:
    """One adaptation step toward ``target_accept`` (dual_avg.rs:55-63,
    adam.rs:71-97)."""
    target = settings.target_accept
    if settings.method is StepSizeMethod.FIXED:
        return state
    if settings.method is StepSizeMethod.DUAL_AVERAGE:
        o = settings.dual_average
        w = 1.0 / (state.count + o.t0)
        hbar = (1.0 - w) * state.hbar + w * (target - accept_stat)
        log_step = state.mu - hbar * torch.sqrt(state.count) / o.gamma
        log_step = torch.clamp(log_step, max=math.log(o.max_step_size))
        mk = state.count ** (-o.k)
        log_step_adapted = mk * log_step + (1.0 - mk) * state.log_step_adapted
        return state._replace(log_step=log_step,
                              log_step_adapted=log_step_adapted, hbar=hbar,
                              count=state.count + 1.0)
    o = settings.adam
    grad = accept_stat - target
    t = state.adam_t + 1
    m = o.beta1 * state.adam_m + (1.0 - o.beta1) * grad
    v = o.beta2 * state.adam_v + (1.0 - o.beta2) * grad * grad
    tf = t.to(state.log_step.dtype)
    m_hat = m / (1.0 - o.beta1 ** tf)
    v_hat = v / (1.0 - o.beta2 ** tf)
    log_step = state.log_step + o.learning_rate * m_hat / (
        torch.sqrt(v_hat) + o.epsilon)
    return state._replace(log_step=log_step, log_step_adapted=log_step,
                          adam_m=m, adam_v=v, adam_t=t)


def current_step(state: StepSizeState, settings: StepSizeSettings,
                 use_best_guess):
    """``update_stepsize``'s step selection (adapt.rs:235-257)."""
    if settings.method is StepSizeMethod.FIXED:
        return torch.full_like(state.log_step, settings.fixed_value)
    if settings.method is StepSizeMethod.ADAM:
        return torch.exp(state.log_step)
    return torch.exp(torch.where(torch.as_tensor(use_best_guess),
                                 state.log_step_adapted, state.log_step))


def step_size_bar(state: StepSizeState, settings: StepSizeSettings):
    if settings.method is StepSizeMethod.FIXED:
        return torch.full_like(state.log_step, settings.fixed_value)
    if settings.method is StepSizeMethod.ADAM:
        return torch.exp(state.log_step)
    return torch.exp(state.log_step_adapted)


def apply_jitter(u, state: StepSizeState, settings: StepSizeSettings,
                 use_best_guess) -> StepSizeState:
    """Set the working step size with uniform +-jitter (adapt.rs:259-266);
    ``u`` [C] are uniforms in (0, 1)."""
    step = current_step(state, settings, use_best_guess)
    if settings.jitter is not None:
        j = settings.jitter
        step = step * ((1.0 - j) + (2.0 * j) * u.to(step.dtype))
    return state._replace(step_size=step)


def init_search(q, transform: AffineTransform, v, *, logp_grad_fn,
                settings: StepSizeSettings, kind: KineticKind,
                ops=AFFINE_OPS):
    """Coarse doubling/halving search for a good initial step size
    (adapt.rs:91-199), for all chains at once.

    Probes single leapfrogs with ONE momentum ``v`` [C, d] reused across
    probes, doubles while accept > target (or halves while <), stops at the
    crossing or the bounds [1e-10, 1e5], at most 100 iterations; on a probe
    failure the chain falls back to ``initial_step``.  ``ops`` are the
    transform's operations (``transform/ops.py``).  Returns [C]."""
    dtype = q.dtype
    if settings.method is StepSizeMethod.FIXED:
        return torch.full(q.shape[:-1], settings.fixed_value, dtype=dtype,
                          device=q.device)
    pt = init_point_from_q(q, transform, logp_grad_fn, ops)
    pt = initialize_trajectory(pt, transform, kind, v, ops)
    e0 = pt.energy
    target = settings.target_accept
    init_step = torch.full_like(e0, settings.initial_step)

    def probe(step):
        res = leapfrog(pt, 1, step, transform, logp_grad_fn, kind, e0, 1000.0,
                       ops=ops)
        acc = torch.exp(torch.clamp(e0 - res.point.energy, max=0.0))
        return acc, res.diverging

    acc0, fail0 = probe(init_step)
    go_up = acc0 > target
    step, done = init_step, fail0
    for _ in range(100):
        if bool(done.all()):
            break
        acc, fail = probe(step)
        stop_up = go_up & ((acc <= target) | (step > 1e5))
        stop_down = ~go_up & ((acc >= target) | (step < 1e-10))
        stop = stop_up | stop_down
        new_step = torch.where(stop, step,
                               torch.where(go_up, step * 2.0, step * 0.5))
        new_step = torch.where(fail, init_step, new_step)
        step = torch.where(done, step, new_step)
        done = done | stop | fail
    return torch.where(done, step, init_step)
