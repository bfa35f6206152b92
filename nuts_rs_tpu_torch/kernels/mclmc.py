"""Unadjusted MCLMC draws: the draw-synchronous engine.

Port of ``nuts_rs_tpu/kernels/mclmc.py`` (whole): ``MAX_HALVINGS`` (``:39``),
``MclmcOptions`` (``:42-51``), ``MclmcInfo`` (``:54-67``), the carry
(``:70-81``) and ``mclmc_draw`` (``:84-260``; nuts-rs ``mclmc_kernel``,
``src/mclmc.rs:212-409``), with the per-draw stat names of the fused kernels
(``kernels/mclmc_pallas.py:50-53``).  Per draw ``num_steps = round(
subsample_freq * L / eps)`` leapfrogs, each between two partial momentum
refreshes, with the reference's dynamic step-size retry: on a divergence
the step factor halves, the point goes back to before the refresh, and two
successful sub-steps must pass before the factor doubles back, up to
``MAX_HALVINGS`` halvings on a stack of saved ``remaining`` counts
(``src/mclmc.rs:242,274-359``); beyond them the draw gives up, stays at its
initial position and resamples the momentum in full.

Where the JAX package vmaps one chain's ``lax.while_loop``, this module runs
ONE batched loop over ``[C, d]`` tensors, as the sync NUTS engine
(``kernels/nuts.py``) does: every iteration is one attempt (a refresh, a
leapfrog, a refresh) for all chains, a ``[C]`` mask keeps the chains whose
trajectory has ended as they were, and a host loop runs while any chain is
active, with one host sync an iteration.  Each chain holds its own
``remaining``, step factor, halving stack ``[C, MAX_HALVINGS]`` and stack
size; a push writes at the chain's own stack size, and the unwind after a
success (``:158-171``, a bounded loop there) is computed in one pass: the
pops run while the popped count is 1, so a chain pops the run of 1s on top
of its stack and one more entry.  The iteration's one host sync also reads
whether any stack holds an entry (else the unwind is skipped) and whether
a chain gave up in the last attempt (whose divergence record is written
then).  The engine has no kernel to agree with bit
for bit, so it sums with ``torch.sum`` and uses ``esh_momentum_update`` in
its ``log1p`` form, the JAX sync engine's.  It works in the dtype of the
point it is given.

Randomness comes from the counter hash (``kernels/rng.py``), never from a
global generator.  Key layout of one draw, ``hash(seed, it, salt, idx)``:
``seed`` is the caller's per-draw seed (``chain.make_mclmc_draw_step``
derives it from the base seed, the global draw index and
``PURPOSE_SYNC_MCLMC_DRAW``); a vector site has ``idx = c * d + j``, a
scalar site ``idx = c``.  At ``it`` 0: salts 1, 2 the momentum of a full
resample (Box-Muller), 3, 4 the first refresh noise (``noise0``), 5, 6 the
full momentum resample after a give-up, and 11 the draw's step-size jitter
(a scalar site, taken by the draw step).  At the attempt ``it`` = 1, 2, ...
(a chain's n-th attempt is iteration n of the host loop): salts 7, 8 the
noise of the refresh after the leapfrog, 9, 10 the noise that the next
attempt starts with.  A diverged attempt retries with its old noise, as in
the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..dynamics.hamiltonian import (
    KineticKind,
    initialize_trajectory,
    leapfrog,
    refresh_coefficients,
    refresh_momentum,
    sample_momentum,
)
from ..dynamics.point import Point, chains_where, point_where
from ..kernels.rng import (
    box_muller,
    hash_bits,
    host_normals,
    uniform_from_bits,
)
from ..transform.ops import AFFINE_OPS
from .nuts import (
    DIV_REASON_ENERGY,
    DIV_REASON_NAN_GRAD,
    DIV_REASON_NAN_LOGP,
    DivergenceInfo,
    _empty_div_info,
)

MAX_HALVINGS = 10

# per-draw stat rows of the fused MCLMC kernels, in the Pallas order
STAT_NAMES = [
    "diverging", "n_steps", "energy_change", "average_step_size",
    "step_size", "logp", "energy", "fisher_distance",
]

SALT_MOMENTUM = (1, 2)
SALT_NOISE0 = (3, 4)
SALT_FAIL_MOMENTUM = (5, 6)
SALT_NOISE1 = (7, 8)
SALT_NOISE2 = (9, 10)
SALT_JITTER = 11
# values of the attempts' noise that one hash call draws, at most (a draw's
# first call covers most trajectories; the sites are the same whatever the
# grouping)
_NOISE_VALUES = 1 << 22


@dataclasses.dataclass(frozen=True)
class MclmcOptions:
    """Static per-run options (nuts-rs ``MclmcSettings``, sampler.rs:268-318)."""

    momentum_decoherence_length: float = 3.0
    subsample_frequency: float = 1.0
    dynamic_step_size: bool = True
    max_energy_error: float = 1000.0
    kind: KineticKind = KineticKind.MICROCANONICAL
    store_divergences: bool = False


class MclmcInfo(NamedTuple):
    """Per-draw diagnostics, one entry per chain (nuts-rs ``MclmcInfo``,
    mclmc.rs:75-87; ``kernels/mclmc.py:54-67``)."""

    energy_change: torch.Tensor      # [C] trajectory end - initial energy
    diverging: torch.Tensor          # [C] bool: gave up
    num_steps: torch.Tensor          # [C] int32 successful leapfrogs
    average_step_size: torch.Tensor  # [C]
    log_weight: torch.Tensor         # [C] the energy change (mclmc.rs:441)
    divergence: DivergenceInfo
    # fed to the mass-matrix adaptation collector: the trajectory's end
    is_good_for_adapt: torch.Tensor  # [C] bool
    draw_q: torch.Tensor             # [C, d]
    draw_g: torch.Tensor             # [C, d]
    draw_logp: torch.Tensor          # [C]


class _Carry(NamedTuple):
    pt: Point
    noise: torch.Tensor       # [C, d] noise of the next attempt's refresh
    remaining: torch.Tensor   # [C] int32
    factor: torch.Tensor      # [C] step-size multiplier (a power of 2)
    stack: torch.Tensor       # [C, MAX_HALVINGS] int32 saved `remaining`
    stack_size: torch.Tensor  # [C] int32
    steps: torch.Tensor       # [C] int32 leapfrogs taken
    time: torch.Tensor        # [C] integrated time
    diverged: torch.Tensor    # [C] bool
    div_info: DivergenceInfo


def _sum(x):
    return torch.sum(x, -1)


def _div_record(gave, pt, res, div_info, store_mom):
    """The divergence record of the chains in ``gave`` (their give-up
    attempt: ``pt`` after the refresh, ``res`` its leapfrog), the others'
    kept; the reason codes mirror ``kernels/nuts.py``."""
    nan_logp = ~torch.isfinite(res.point.logp)
    nan_grad = ~torch.isfinite(_sum(res.point.zg))
    reason = torch.where(
        nan_logp, DIV_REASON_NAN_LOGP,
        torch.where(nan_grad, DIV_REASON_NAN_GRAD, DIV_REASON_ENERGY)
    ).to(torch.int32)
    return chains_where(gave, DivergenceInfo(
        start_location=pt.q, start_gradient=pt.g,
        start_momentum=pt.v if store_mom else div_info.start_momentum,
        end_location=res.point.q,
        end_momentum=res.point.v if store_mom else div_info.end_momentum,
        energy_error=res.energy_error, start_idx=pt.idx,
        end_idx=res.point.idx, reason=reason), div_info)


def _unwind(rem, factor, stack, size):
    """The JAX body's unwind loop (``kernels/mclmc.py:158-171``) for all
    chains at once: while ``rem == 0`` and the stack is not empty, pop
    (``rem = top - 1``, the factor doubles).  A pop leaves 0 exactly when
    the popped count is 1, so a chain with ``rem == 0`` pops the ``k``
    consecutive 1s on top of its stack and one entry more, ``n = min(k + 1,
    size)`` pops in all."""
    M = stack.shape[1]
    rows = torch.arange(M, device=stack.device)[None, :]
    below = rows < size[:, None]
    ones = (stack == 1) | ~below
    # ones_from_top[i]: every entry from i up to the stack's top is a 1
    ones_from_top = torch.flip(torch.cumprod(torch.flip(
        ones.to(torch.int32), [1]), 1), [1]) > 0
    k = (ones_from_top & below).sum(1).to(torch.int32)
    n = torch.where(rem == 0, torch.minimum(k + 1, size),
                    torch.zeros_like(size))
    last = torch.clamp(size - n, 0, M - 1).long()
    popped = torch.gather(stack, 1, last[:, None])[:, 0] - 1
    pops = n > 0
    rem = torch.where(pops, popped, rem)
    factor = factor * torch.pow(torch.full_like(factor, 2.0), n.to(
        factor.dtype))
    return rem, factor, size - n


def attempt_noise(seed: int, it: int, n: int, shape, device):
    """The refresh noises of the attempts ``it .. it + n - 1``: a tensor
    [n, 2, *shape] of ``host_normals(seed, it, *SALT_NOISE1, shape)`` and
    ``host_normals(seed, it, *SALT_NOISE2, shape)`` (float32), drawn by one
    hash call."""
    its = torch.arange(it, it + n, dtype=torch.int64, device=device)
    salts = torch.tensor([*SALT_NOISE1, *SALT_NOISE2], dtype=torch.int64,
                         device=device)
    size = 1
    for k in shape:
        size *= k
    idx = torch.arange(size, dtype=torch.int64, device=device)
    u = uniform_from_bits(hash_bits(
        torch.tensor(int(seed) & 0xFFFFFFFF, device=device),
        its[:, None, None], salts[None, :, None], idx[None, None, :]))
    z = box_muller(u[:, 0::2], u[:, 1::2])
    return z.reshape(n, 2, *shape)


def mclmc_draw(seed: int, init_pt: Point, transform, step_size,
               logp_grad_fn, opts: MclmcOptions, resample_velocity: bool,
               ops=AFFINE_OPS):
    """One MCLMC draw of every chain from ``init_pt`` (``mclmc_draw``,
    ``kernels/mclmc.py:84-260``).  ``step_size`` is [C];
    ``resample_velocity`` a host bool (the schedule's flag of this draw).
    Returns ``(draw: Point, info: MclmcInfo)``; see the module docstring
    for the random sites ``seed`` keys."""
    C, dim = init_pt.q.shape
    dtype, dev = init_pt.q.dtype, init_pt.q.device
    kind = opts.kind
    ell = opts.momentum_decoherence_length
    step_size = step_size.to(dtype)

    v0 = (sample_momentum(seed, 0, *SALT_MOMENTUM, (C, dim), dtype, dev,
                          kind, csum=_sum)
          if resample_velocity else None)
    pt0 = initialize_trajectory(init_pt, transform, kind, v0, ops,
                                csum=_sum)
    initial_energy = pt0.energy

    num_base_steps = torch.clamp(
        torch.round(opts.subsample_frequency * ell / step_size), 1.0, 1e6
    ).to(torch.int32)
    max_err_base = opts.max_energy_error / num_base_steps.to(dtype)
    max_halvings = MAX_HALVINGS if opts.dynamic_step_size else 0

    zi = torch.zeros(C, dtype=torch.int32, device=dev)
    c = _Carry(
        pt=pt0,
        noise=host_normals(seed, 0, *SALT_NOISE0, (C, dim), dev).to(dtype),
        remaining=num_base_steps, factor=torch.ones(C, dtype=dtype,
                                                    device=dev),
        stack=torch.zeros(C, MAX_HALVINGS, dtype=torch.int32, device=dev),
        stack_size=zi, steps=zi, time=torch.zeros(C, dtype=dtype, device=dev),
        diverged=torch.zeros(C, dtype=torch.bool, device=dev),
        div_info=_empty_div_info(C, dim, dtype, dev, opts.store_divergences))
    rows = torch.arange(MAX_HALVINGS, device=dev)[None, :]
    group = max(1, min(8, _NOISE_VALUES // (4 * C * dim)))
    # the chains that gave up in the last attempt, with its values: their
    # divergence record is written after the next host sync, which reads
    # this, whether any chain is still active and whether any stack holds
    # an entry (else a success unwinds nothing)
    no = torch.zeros(C, dtype=torch.bool, device=dev)
    pending = (no, None, None)

    it = 1
    while True:
        active = (c.remaining > 0) & ~c.diverged
        any_active, any_gave, any_stack = torch.stack(
            [active.any(), pending[0].any(), (c.stack_size > 0).any()]
        ).tolist()
        if any_gave:
            c = c._replace(div_info=_div_record(*pending, c.div_info,
                                                opts.store_divergences))
        if not any_active:
            break
        # an attempt's two refreshes share the coefficients
        coeffs = refresh_coefficients(step_size, c.factor, ell, kind, c.pt.v)
        pt = refresh_momentum(c.pt, c.noise, coeffs, kind, _sum)
        # per-step divergence baseline: the post-refresh energy
        # (mclmc.rs:292-298)
        res = leapfrog(pt, 1, step_size, transform, logp_grad_fn, kind,
                       pt.energy, max_err_base * c.factor,
                       step_size_factor=c.factor, csum=_sum, ops=ops)

        # ---- success branch values ----
        if (it - 1) % group == 0:
            noises = attempt_noise(seed, it, group, (C, dim), dev).to(dtype)
        noise1, noise2 = noises[(it - 1) % group]
        next_pt = refresh_momentum(res.point, noise1, coeffs, kind, _sum)
        if any_stack:
            rem_u, factor_u, size_u = _unwind(c.remaining - 1, c.factor,
                                              c.stack, c.stack_size)
        else:
            rem_u, factor_u, size_u = c.remaining - 1, c.factor, c.stack_size

        # ---- divergence branch values (mclmc.rs:335-354): retry from the
        # pre-refresh point c.pt with the old noise ----
        div = res.diverging & active
        ok = active & ~div
        give_up = c.stack_size >= max_halvings
        push = div & ~give_up
        at = rows == torch.clamp(c.stack_size, max=MAX_HALVINGS - 1)[:, None]
        stack = torch.where(push[:, None] & at, c.remaining[:, None],
                            c.stack)
        gave = div & give_up
        pending = (gave, pt, res)

        two = torch.full_like(c.remaining, 2)
        c = _Carry(
            pt=point_where(ok, next_pt, c.pt),
            noise=torch.where(ok[:, None], noise2, c.noise),
            remaining=torch.where(
                div, torch.where(give_up, torch.zeros_like(two), two),
                torch.where(ok, rem_u, c.remaining)),
            factor=torch.where(push, c.factor * 0.5,
                               torch.where(ok, factor_u, c.factor)),
            stack=stack,
            stack_size=torch.where(push, c.stack_size + 1,
                                   torch.where(ok, size_u, c.stack_size)),
            steps=c.steps + ok.to(torch.int32),
            time=torch.where(ok, c.time + c.factor * step_size, c.time),
            diverged=c.diverged | gave,
            div_info=c.div_info)
        it += 1

    # A draw that gave up stays at its initial position with its momentum
    # resampled in full (mclmc.rs:361-384).
    if bool(c.diverged.any()):
        v_fail = sample_momentum(seed, 0, *SALT_FAIL_MOMENTUM, (C, dim),
                                 dtype, dev, kind, csum=_sum)
        pt_fail = initialize_trajectory(init_pt, transform, kind, v_fail, ops,
                                        csum=_sum)
        out_pt = point_where(c.diverged, pt_fail, c.pt)
    else:
        out_pt = c.pt
    # the trajectory end's energy change, also on a divergence (mclmc.rs:441)
    energy_change = c.pt.energy - initial_energy
    steps_f = torch.clamp(c.steps, min=1).to(dtype)
    info = MclmcInfo(
        energy_change=energy_change, diverging=c.diverged,
        num_steps=c.steps, average_step_size=c.time / steps_f,
        log_weight=energy_change, divergence=c.div_info,
        # DrawGradCollector semantics: the collector sees the trajectory
        # end, even on a divergence (mclmc.rs:382,394)
        is_good_for_adapt=torch.where(c.diverged, torch.abs(c.pt.idx) > 4,
                                      c.pt.idx != 0),
        draw_q=c.pt.q, draw_g=c.pt.g, draw_logp=c.pt.logp)
    return out_pt, info
