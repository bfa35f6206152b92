"""Fused MCLMC engine: posterior (K3) and warmup (K4) kernels.

Port of ``nuts_rs_tpu/kernels/mclmc_pallas.py``: ``mclmc_pallas_run``
(``:372``, body ``make_mclmc_kernel`` ``:59``) becomes ``mclmc_fused_run``
with the CUDA kernel ``csrc/mclmc_fused_posterior.cu``, and
``mclmc_pallas_warmup_run`` (``:887``, body ``make_mclmc_warmup_kernel``
``:504``) becomes ``mclmc_fused_warmup_run`` with
``csrc/mclmc_fused_warmup.cu``.

Two kernel pairs serve them, chosen as the fused NUTS kernels choose
(``nuts_fused.cl_kernel``).  A model without data of at most
``_build.CL_THREAD_MAX_DIM`` dimensions takes the chains-on-lanes kernels
above (instantiated for the d of ``_build.DIMS``): a chain's coordinates on
a group of lanes, one a lane (``_build.mclmc_lanes``), every sum over the
parameter axis gathered and added in coordinate order (``ops.dsum``), chain
blocks of 32.  Every larger size, and every model that
carries data (the
``n_model_args > 0`` variants of the Pallas bodies,
``mclmc_pallas.py:61,82-85,124`` and ``:506,532-536,574``: K3-args and
K4-args), takes the mid-d kernels ``csrc/mclmc_fused_mid_posterior.cu`` and
``csrc/mclmc_fused_mid_warmup.cu``: 256 threads a chain with its vectors in
shared memory, d at launch, sums in ``ops.tsum``'s order, the model
evaluated by the block's threads together from its data in device memory,
logical chain blocks of at most 8 (a thread block cluster), by default 1.
For the regression under the microcanonical dynamics they take their group
form instead, ``csrc/mclmc_fused_group_posterior.cu`` and
``csrc/mclmc_fused_group_warmup.cu``: G <= 8 chains a CUDA block of 256
threads, a warp a chain's trajectory, one read of the data serving the
block's G chains, logical chain blocks that divide G.  The form is the one
``_build.MCLMC_MID_FORMS`` gives the functor and kinetic energy
(``_build.mclmc_mid_form``); both count as K3-args / K4-args launches.

Per draw, ``round(subsample_frequency * L / eps)`` leapfrogs (ESH or
Euclidean) bracketed by partial momentum refreshes, with the dynamic
step-halving stack: on a divergence the step factor halves and two
sub-steps must succeed before it doubles back, at most ``MAX_HALVINGS``
deep; past that the draw gives up and emits its start point with fresh
momentum (nuts-rs ``src/mclmc.rs:212-409``).  The posterior is
draw-asynchronous: each chain starts its next draw at once, and a block
runs until all its chains have K draws.  The warmup runs its draws in lock
step, with the diagonal adaptation of ``diag_adapt.py`` between draws.

Each kernel has a plain PyTorch version here (``*_reference``) with the
same counter-hash random sites and salts, the same chain blocks of B and
the same order of floating-point operations: the sum order and the model's
evaluation are those of the kernel pair that serves the size
(``nuts_fused._evaluators``); divisors are tensors, since PyTorch's CUDA
division by a Python scalar multiplies by its reciprocal.
The wrappers take the plain version for tensors on the CPU; for CUDA
tensors they launch the kernel or raise.  ``LAUNCHES`` counts kernel
launches per kernel.

Random sites (static salts, as the Pallas trace numbers them; ``j`` is 1
with jitter and 0 without):
posterior: noise 1,2 at it=0; per iteration it>=1: post-step refresh noise
3,4, next noise 5,6, give-up momentum 7,8, next draw's jitter 9.
warmup, per draw at the draw's first it: jitter 1, resampled momentum
1+j,2+j, noise 3+j,4+j; per tree iteration: refresh noise 5+j,6+j, next
noise 7+j,8+j; after the draw's last iteration the give-up momentum
9+j,10+j at the block's ``it``.  ``it`` carries across the draws of a
warmup launch.
"""

from __future__ import annotations

import math

import torch

from ..dynamics.hamiltonian import KineticKind
from ._build import (
    check_mclmc_posterior_args,
    check_mclmc_warmup_args,
    count_model,
    launch_mclmc_group_posterior,
    launch_mclmc_group_warmup,
    launch_mclmc_mid_posterior,
    launch_mclmc_mid_warmup,
    launch_mclmc_posterior,
    launch_mclmc_warmup,
    mclmc_mid_form,
)
from .diag_adapt import NEST, adapt_draw
from .mclmc import MAX_HALVINGS, STAT_NAMES
from .nuts_fused import (
    _block_any,
    _check_block,
    _evaluators,
    _jitter_consts,
    _sel,
    cl_kernel,
)
from .rng import BlockRng

NSTATS = len(STAT_NAMES)
WARMUP_STAT_NAMES = STAT_NAMES + ["transformation_index"]
NSTATS_W = len(WARMUP_STAT_NAMES)

# flags columns (int32): the NUTS warmup layout (nuts_fused.FLAG_*) plus the
# full momentum resample in a spare column, as mclmc_pallas.py:487-490
FLAG_UPDATE_EST = 0
FLAG_DO_UPDATE = 1
FLAG_DO_SWITCH = 5
FLAG_RESAMPLE = 6
NFLAGS = 8

# packed per-chain scalar rows, as mclmc_pallas.py:492-497
SCA_TID = 0
SCA_LOGDET = 1
SCA_CNT_FG = 2
SCA_CNT_BG = 3
NSCA = 4

LAUNCHES = {"mclmc_fused_posterior": 0, "mclmc_fused_warmup": 0,
            "mclmc_fused_mid_posterior": 0, "mclmc_fused_mid_warmup": 0}

_F32 = torch.float32
_I32 = torch.int32
_LN2 = math.log(2.0)


class _Consts:
    """The kernels' f32 constants as 0-dim tensors on the device, so every
    division is a tensor division (IEEE, as in the kernels and XLA), with
    the sum over the parameter axis (``csum``) and the model's evaluation
    (``logp_and_grad``) of the kernel pair ``kind`` ("thread" or "mid")."""

    def __init__(self, mopts, model, dim, device, kind):
        self.csum, self.logp_and_grad = _evaluators(model, kind)
        def t(x):
            return torch.tensor(float(x), dtype=_F32, device=device)
        self.micro = mopts.kind is KineticKind.MICROCANONICAL
        self.H = MAX_HALVINGS if mopts.dynamic_step_size else 0
        self.HS = max(self.H, 1)
        self.ell = t(mopts.momentum_decoherence_length)
        self.fsub_ell = t(mopts.subsample_frequency
                          * mopts.momentum_decoherence_length)
        self.max_err = t(mopts.max_energy_error)
        self.dim = t(dim)
        self.dm1 = t(dim - 1)
        self.sqrt_n = math.sqrt(dim)


def _esh(zg, v, step, k):
    """ESH momentum half-step (mclmc_pallas.py:132-148, with the log1p
    argument regrouped as the Pallas body writes it); step is [C]."""
    gn = torch.sqrt(k.csum(zg * zg))
    gh = zg / gn[:, None]
    alpha = k.csum(v * gh)
    delta = step * gn / k.dm1
    zeta = torch.exp(-delta)
    cg = (1.0 - zeta) * (1.0 + zeta + alpha * (1.0 - zeta))
    vr = cg[:, None] * gh + (2.0 * zeta)[:, None] * v
    vn = vr / torch.sqrt(k.csum(vr * vr))[:, None]
    dke = (delta - _LN2
           + torch.log((1.0 + alpha) + (1.0 - alpha) * zeta * zeta)) * k.dm1
    return vn, dke


def _refresh(v, noise, half, k):
    """Partial momentum refresh (mclmc_pallas.py:150-165, exp(x) - 1 for
    expm1 as there); returns (v_new, ke or None for microcanonical)."""
    if k.micro:
        nu = torch.sqrt((torch.exp(2.0 * half / k.ell) - 1.0) / k.dim)
        vr = v + nu[:, None] * noise
        return vr / torch.sqrt(k.csum(vr * vr))[:, None], None
    alpha = torch.exp(-half / k.ell)
    beta = torch.sqrt(1.0 - alpha * alpha)
    vr = alpha[:, None] * v + beta[:, None] * noise
    return vr, 0.5 * k.csum(vr * vr)


def _num_steps(step, k):
    """round(F L / eps), half to even as jnp.round, clipped to [1, 1e6]."""
    return torch.clamp(torch.round(k.fsub_ell / step), 1.0, 1e6).to(_I32)


def _leapfrog_try(s, step, nsd, ld, stds, mean, k, n1, n2, act):
    """One leapfrog attempt of every chain where ``act`` holds, with the
    halving stack (mclmc_pallas.py:202-282, 660-746).

    ``s`` is the trajectory dict (z, v, zg, noise, logp, ke, rem, factor,
    ssize, stack, steps, ttime).  Returns (new dict, gave_up, done): a
    divergence with the stack full gives up; a chain is done when it gave
    up or its remaining step count reached 0."""
    ar = torch.arange(step.shape[0], device=step.device)
    f = s["factor"]
    eps = step * f
    half = eps / 2.0
    vr, ke_r = _refresh(s["v"], s["noise"], half, k)
    if k.micro:
        ke_r = s["ke"]
    base = ke_r - (s["logp"] + ld)
    if k.micro:
        v1, dke1 = _esh(s["zg"], vr, k.sqrt_n * eps / 2.0, k)
        ke1 = ke_r + dke1
        z1 = s["z"] + (eps * k.sqrt_n)[:, None] * v1
    else:
        v1 = vr + half[:, None] * s["zg"]
        ke1 = ke_r
        z1 = s["z"] + eps[:, None] * v1
    logp1, g1 = k.logp_and_grad(z1 * stds + mean)
    zg1 = g1 * stds
    if k.micro:
        v2, dke2 = _esh(zg1, v1, k.sqrt_n * eps / 2.0, k)
        ke2 = ke1 + dke2
    else:
        v2 = v1 + half[:, None] * zg1
        ke2 = 0.5 * k.csum(v2 * v2)
    err = (ke2 - (logp1 + ld)) - base
    max_err_step = (k.max_err / nsd.to(_F32)) * f
    bad = torch.abs(err) >= max_err_step if k.micro else err > max_err_step
    div = act & (bad | ~torch.isfinite(err))
    ok = act & ~div

    vr2, ke3 = _refresh(v2, n1, half, k)
    if k.micro:
        ke3 = ke2
    rem_u, fac_u, size_u = s["rem"] - 1, f, s["ssize"]
    for _ in range(k.HS):
        do = (rem_u == 0) & (size_u > 0)
        top = s["stack"][ar, torch.clamp(size_u - 1, min=0)]
        rem_u = torch.where(do, top - 1, rem_u)
        fac_u = torch.where(do, fac_u * 2.0, fac_u)
        size_u = torch.where(do, size_u - 1, size_u)
    give_up = s["ssize"] >= k.H
    push = div & ~give_up
    stack = s["stack"].clone()
    row = torch.clamp(s["ssize"], max=k.HS - 1)
    stack[ar, row] = torch.where(push, s["rem"], stack[ar, row])

    new = dict(
        z=_sel(ok, z1, s["z"]), v=_sel(ok, vr2, s["v"]),
        zg=_sel(ok, zg1, s["zg"]), noise=_sel(ok, n2, s["noise"]),
        logp=_sel(ok, logp1, s["logp"]), ke=_sel(ok, ke3, s["ke"]),
        rem=torch.where(ok, rem_u, torch.where(
            div, torch.where(give_up, 0, 2), s["rem"])).to(_I32),
        factor=torch.where(ok, fac_u, torch.where(
            div & ~give_up, f * 0.5, f)),
        ssize=torch.where(ok, size_u, torch.where(
            push, s["ssize"] + 1, s["ssize"])).to(_I32),
        stack=stack,
        steps=torch.where(ok, s["steps"] + 1, s["steps"]).to(_I32),
        ttime=torch.where(ok, s["ttime"] + f * step, s["ttime"]),
    )
    gave_up = div & give_up
    done = gave_up | (ok & (new["rem"] == 0))
    return new, gave_up, done


def _trajectory(z, v, zg, noise, logp, ke, nsd, HS):
    zi = torch.zeros_like(nsd)
    return dict(z=z, v=v, zg=zg, noise=noise, logp=logp, ke=ke, rem=nsd,
                factor=torch.ones_like(logp), ssize=zi,
                stack=torch.zeros(nsd.shape[0], HS, dtype=_I32,
                                  device=nsd.device),
                steps=zi, ttime=torch.zeros_like(logp))


def _give_up_momentum(vfail, k):
    """The emitted momentum and kinetic energy of a give-up draw."""
    if k.micro:
        vf = vfail / torch.sqrt(k.csum(vfail * vfail))[:, None]
        return vf, torch.zeros_like(vf[:, 0])
    return vfail, 0.5 * k.csum(vfail * vfail)


# ---------------------------------------------------------------------------
# K3: fused posterior
# ---------------------------------------------------------------------------


def mclmc_fused_run_reference(seed, q, g, logp, v, stds, mean, logdet, step0,
                              step_bar, num_draws, model, mopts, jitter,
                              block=None):
    """Plain PyTorch version of the fused MCLMC posterior kernels.

    Same arguments and results as :func:`mclmc_fused_run`."""
    C, d = q.shape
    K = num_draws
    kind = cl_kernel(model, d)
    B = _check_block(C, block, kind)
    dev = q.device
    k = _Consts(mopts, model, d, dev, kind)
    f = lambda x: x.to(_F32).contiguous()  # noqa: E731
    q, g, v, stds, mean = f(q), f(g), f(v), f(stds), f(mean)
    logp, ld, step, bar = f(logp), f(logdet), f(step0), f(step_bar)
    rng = BlockRng(seed, C, d, B, dev)
    zf = torch.zeros(C, dtype=_F32, device=dev)

    z, zg = (q - mean) / stds, g * stds
    ke = zf if k.micro else 0.5 * k.csum(v * v)
    nsd = _num_steps(step, k)
    s = _trajectory(z, v, zg, rng.normals_vec(0, 1, 2), logp, ke, nsd, k.HS)
    e_init = ke - (logp + ld)
    zi, zgi, lpi = z, zg, logp
    dc = torch.zeros(C, dtype=_I32, device=dev)
    act = torch.ones(C, dtype=torch.bool, device=dev)
    c1, c2 = _jitter_consts(jitter) if jitter is not None else (None, None)

    draws = torch.zeros(C, K, d, dtype=_F32, device=dev)
    stats = torch.zeros(C, K, NSTATS, dtype=_F32, device=dev)
    fin = {name: s[name] for name in ("z", "zg", "logp", "v")}
    iters = torch.zeros(C, dtype=_I32, device=dev)

    it = 1
    live = _block_any(dc < K, B)
    while bool(live.any()):
        n1 = rng.normals_vec(it, 3, 4)
        n2 = rng.normals_vec(it, 5, 6)
        vfail = rng.normals_vec(it, 7, 8)
        if jitter is None:
            u_step = bar
        else:
            u_step = bar * (c1 + c2 * rng.uniform(it, 9))
        t, gave_up, done = _leapfrog_try(s, step, nsd, ld, stds, mean, k, n1,
                                         n2, act)

        # the emitted point: the trajectory end, or on a give-up the draw's
        # start with fresh momentum (mclmc.rs:361-384)
        vf, ke_div = _give_up_momentum(vfail, k)
        em_z = _sel(gave_up, zi, t["z"])
        em_zg = _sel(gave_up, zgi, t["zg"])
        em_logp = _sel(gave_up, lpi, t["logp"])
        em_v = _sel(gave_up, vf, t["v"])
        em_ke = _sel(gave_up, ke_div, t["ke"])
        emit = done & (dc < K)
        if bool(emit.any()):
            # energy_change uses the loop-exit point, as mclmc_draw does
            row = torch.stack([
                gave_up.to(_F32), t["steps"].to(_F32),
                (t["ke"] - (t["logp"] + ld)) - e_init,
                t["ttime"] / torch.clamp(t["steps"], min=1).to(_F32), step,
                em_logp, em_ke - (em_logp + ld),
                k.csum(torch.square(em_z + em_zg))], 1)
            ce = emit.nonzero()[:, 0]
            draws[ce, dc[ce].long()] = (em_z * stds + mean)[ce]
            stats[ce, dc[ce].long()] = row[ce]

        ke_fresh = zf if k.micro else em_ke
        nsd_fresh = _num_steps(u_step, k)

        def nxt(fresh, cont):
            return _sel(done, fresh, cont)

        s = dict(t, z=em_z, v=em_v, zg=em_zg, logp=em_logp,
                 noise=nxt(n2, t["noise"]), ke=nxt(ke_fresh, t["ke"]),
                 rem=nxt(nsd_fresh, t["rem"]),
                 factor=nxt(torch.ones_like(zf), t["factor"]),
                 ssize=nxt(torch.zeros_like(dc), t["ssize"]),
                 stack=_sel(done, torch.zeros_like(t["stack"]), t["stack"]),
                 steps=nxt(torch.zeros_like(dc), t["steps"]),
                 ttime=nxt(zf, t["ttime"]))
        e_init = nxt(ke_fresh - (em_logp + ld), e_init)
        zi, zgi, lpi = nxt(em_z, zi), nxt(em_zg, zgi), nxt(em_logp, lpi)
        step, nsd = nxt(u_step, step), nxt(nsd_fresh, nsd)
        dc = dc + done.to(_I32)

        # a block's results are its chains' values at its last iteration
        fin = {name: _sel(live, s[name], fin[name]) for name in fin}
        iters = torch.where(live, it + 1, iters).to(_I32)
        it += 1
        live = _block_any(dc < K, B)

    stats_out = {name: stats[:, :, i] for i, name in enumerate(STAT_NAMES)}
    stats_out["loop_iterations"] = iters
    return (fin["z"] * stds + mean, fin["zg"] / stds, fin["logp"], fin["v"],
            draws, stats_out)


def mclmc_fused_run(seed, q, g, logp, v, stds, mean, logdet, step0,
                    step_bar, num_draws, model, mopts, jitter, block=None):
    """Run ``num_draws`` draw-asynchronous MCLMC draws per chain.

    q, g, v (transformed-space velocity), stds, mean: [C, d]; logp, logdet,
    step0, step_bar: [C].  Returns (q_f, g_f [C, d], logp_f [C], v_f
    [C, d], draws [C, K, d], stats) with stats a dict of [C, K] float32
    arrays keyed by ``STAT_NAMES`` plus ``loop_iterations`` [C].  The first
    draw of each chain uses ``step0``; later draws use ``step_bar``
    jittered by ``jitter``.  The chains of a logical block of ``block``
    chains (default 32 for K3, 1 for the mid-d kernel) share the
    iteration counter and run until the block's last chain has its draws.

    CPU tensors run the plain PyTorch version; CUDA tensors launch
    ``csrc/mclmc_fused_posterior.cu`` or, for the mid-d kernels (see
    :func:`nuts_fused.cl_kernel`), the form ``_build.mclmc_mid_form``
    gives: ``csrc/mclmc_fused_mid_posterior.cu`` or
    ``csrc/mclmc_fused_group_posterior.cu``."""
    check_mclmc_posterior_args(q, g, logp, v, stds, mean, logdet, step0,
                               step_bar, num_draws, mopts)
    if q.device.type == "cpu":
        return mclmc_fused_run_reference(seed, q, g, logp, v, stds, mean,
                                         logdet, step0, step_bar, num_draws,
                                         model, mopts, jitter, block)
    kind = cl_kernel(model, q.shape[1])
    if kind == "mid":
        launch = (launch_mclmc_group_posterior
                  if mclmc_mid_form(model, mopts) == "group"
                  else launch_mclmc_mid_posterior)
        draws, stats, q_f, g_f, logp_f, v_f, iters = launch(
            seed, q, g, logp, v, stds, mean, logdet, step0, step_bar,
            num_draws, model, mopts, jitter,
            _check_block(q.shape[0], block, kind))
        LAUNCHES["mclmc_fused_mid_posterior"] += 1
        count_model(model)
        stats_out = {name: stats[:, :, i].T
                     for i, name in enumerate(STAT_NAMES)}
        stats_out["loop_iterations"] = iters
        return q_f, g_f, logp_f, v_f, draws.permute(1, 0, 2), stats_out
    draws, stats, q_f, g_f, logp_f, v_f, iters = launch_mclmc_posterior(
        seed, q, g, logp, v, stds, mean, logdet, step0, step_bar, num_draws,
        model, mopts, jitter, _check_block(q.shape[0], block))
    LAUNCHES["mclmc_fused_posterior"] += 1
    count_model(model)
    stats_out = {name: stats[:, i, :].T for i, name in enumerate(STAT_NAMES)}
    stats_out["loop_iterations"] = iters
    return q_f, g_f, logp_f, v_f, draws.permute(2, 0, 1), stats_out


# ---------------------------------------------------------------------------
# K4: fused warmup
# ---------------------------------------------------------------------------


def mclmc_fused_warmup_run_reference(seed, flags, q, g, logp, v, stds, mean,
                                     est, sca, model, mopts, sset,
                                     use_grad_based, block=None):
    """Plain PyTorch version of the fused MCLMC warmup kernels.

    Same arguments and results as :func:`mclmc_fused_warmup_run`."""
    C, d = q.shape
    K = flags.shape[0]
    kind = cl_kernel(model, d)
    B = _check_block(C, block, kind)
    dev = q.device
    k = _Consts(mopts, model, d, dev, kind)
    jitter = sset.jitter
    j = 0 if jitter is None else 1
    f = lambda x: x.to(_F32).contiguous()  # noqa: E731
    q, g, logp, v, stds, mean = f(q), f(g), f(logp), f(v), f(stds), f(mean)
    est = [f(est[:, p]) for p in range(NEST)]
    sca = [f(sca[:, r]) for r in range(NSCA)]
    flags = flags.to("cpu", torch.int32)
    rng = BlockRng(seed, C, d, B, dev)
    zf = torch.zeros(C, dtype=_F32, device=dev)

    draws = torch.zeros(C, K, d, dtype=_F32, device=dev)
    stats = torch.zeros(C, K, NSTATS_W, dtype=_F32, device=dev)
    it = torch.ones(C, dtype=torch.int64, device=dev)

    for i in range(K):
        logdet = sca[SCA_LOGDET]
        step = torch.full((C,), float(sset.fixed_value), dtype=_F32,
                          device=dev)
        if jitter is not None:
            c1, c2 = _jitter_consts(jitter)
            step = step * (c1 + c2 * rng.uniform(it, 1))
        nsd = _num_steps(step, k)

        # fresh trajectory (initialize_trajectory: v carried unless the
        # schedule resamples it)
        z0, zg0, logp0 = (q - mean) / stds, g * stds, logp
        if flags[i, FLAG_RESAMPLE]:
            v = rng.normals_vec(it, 1 + j, 2 + j)
            if k.micro:
                v = v / torch.sqrt(k.csum(v * v))[:, None]
        ke0 = zf if k.micro else 0.5 * k.csum(v * v)
        e_init = ke0 - (logp0 + logdet)
        t = _trajectory(z0, v, zg0, rng.normals_vec(it, 3 + j, 4 + j), logp0,
                        ke0, nsd, k.HS)
        done = torch.zeros(C, dtype=torch.bool, device=dev)
        div = torch.zeros_like(done)

        live = _block_any(~done, B)
        while bool(live.any()):
            n1 = rng.normals_vec(it, 5 + j, 6 + j)
            n2 = rng.normals_vec(it, 7 + j, 8 + j)
            t, gave_up, fin_now = _leapfrog_try(
                t, step, nsd, logdet, stds, mean, k, n1, n2, ~done)
            done = done | fin_now
            div = div | gave_up
            it = it + live.to(torch.int64)
            live = _block_any(~done, B)

        # emitted draw: the trajectory end, or on a give-up the draw's start
        # with fresh momentum; the adaptation sees the trajectory end
        vf, ke_div = _give_up_momentum(rng.normals_vec(it, 9 + j, 10 + j), k)
        em_z, em_zg = _sel(div, z0, t["z"]), _sel(div, zg0, t["zg"])
        em_logp = _sel(div, logp0, t["logp"])
        em_v, em_ke = _sel(div, vf, t["v"]), _sel(div, ke_div, t["ke"])
        is_good = (div & (t["steps"] > 4)) | (~div & (t["steps"] != 0))
        est, cnt_fg, cnt_bg, stds_n, mean_n, logdet_n, tid_n = adapt_draw(
            est, sca[SCA_CNT_FG], sca[SCA_CNT_BG], sca[SCA_TID], stds, mean,
            t["z"] * stds + mean, t["zg"] / stds,
            is_good & bool(flags[i, FLAG_UPDATE_EST]),
            bool(flags[i, FLAG_DO_SWITCH]), bool(flags[i, FLAG_DO_UPDATE]),
            use_grad_based, k.csum)

        em_q = em_z * stds + mean
        draws[:, i] = em_q
        stats[:, i] = torch.stack([
            div.to(_F32), t["steps"].to(_F32),
            (t["ke"] - (t["logp"] + logdet)) - e_init,
            t["ttime"] / torch.clamp(t["steps"], min=1).to(_F32), step,
            em_logp, em_ke - (em_logp + logdet),
            k.csum(torch.square(em_z + em_zg)), tid_n], 1)

        q, g, logp, v = em_q, em_zg / stds, em_logp, em_v
        stds, mean = stds_n, mean_n
        sca = [tid_n, logdet_n, cnt_fg, cnt_bg]

    stats_out = {name: stats[:, :, i]
                 for i, name in enumerate(WARMUP_STAT_NAMES)}
    stats_out["loop_iterations"] = it.to(_I32)
    return (q, g, logp, v, stds, mean, torch.stack(est, 1),
            torch.stack(sca, 1), draws, stats_out)


def mclmc_fused_warmup_run(seed, flags, q, g, logp, v, stds, mean, est, sca,
                           model, mopts, sset, use_grad_based, block=None):
    """Run K = flags.shape[0] lock-step MCLMC warmup draws with in-kernel
    diagonal adaptation and the FIXED jittered step ``sset`` gives.

    flags [K, NFLAGS] int32 (``FLAG_*`` columns); q, g, v, stds, mean
    [C, d]; logp [C]; est [C, 8, d] estimator planes; sca [C, NSCA] scalar
    rows (``SCA_*``).  Returns (q, g, logp, v, stds, mean, est, sca, draws
    [C, K, d], stats) with stats a dict of [C, K] arrays keyed by
    ``WARMUP_STAT_NAMES`` plus ``loop_iterations`` [C].  The chains of a
    logical block (``block`` as in :func:`mclmc_fused_run`) share the
    iteration counter and wait for the block's longest trajectory in every
    draw.

    CPU tensors run the plain PyTorch version; CUDA tensors launch
    ``csrc/mclmc_fused_warmup.cu`` or the mid-d form ``_build.mclmc_mid_form``
    gives: ``csrc/mclmc_fused_mid_warmup.cu`` or
    ``csrc/mclmc_fused_group_warmup.cu``."""
    check_mclmc_warmup_args(flags, q, g, logp, v, stds, mean, est, sca,
                            mopts)
    if q.device.type == "cpu":
        return mclmc_fused_warmup_run_reference(
            seed, flags, q, g, logp, v, stds, mean, est, sca, model, mopts,
            sset, use_grad_based, block)
    kind = cl_kernel(model, q.shape[1])
    if kind == "mid":
        launch = (launch_mclmc_group_warmup
                  if mclmc_mid_form(model, mopts) == "group"
                  else launch_mclmc_mid_warmup)
        (draws, stats, q_f, g_f, logp_f, v_f, stds_f, mean_f, est_f, sca_f,
         iters) = launch(
            seed, flags, q, g, logp, v, stds, mean, est, sca, model, mopts,
            sset, use_grad_based, _check_block(q.shape[0], block, kind))
        LAUNCHES["mclmc_fused_mid_warmup"] += 1
        count_model(model)
        stats_out = {name: stats[:, :, i].T
                     for i, name in enumerate(WARMUP_STAT_NAMES)}
        stats_out["loop_iterations"] = iters
        return (q_f, g_f, logp_f, v_f, stds_f, mean_f, est_f, sca_f,
                draws.permute(1, 0, 2), stats_out)
    (draws, stats, q_f, g_f, logp_f, v_f, stds_f, mean_f, est_f, sca_f,
     iters) = launch_mclmc_warmup(seed, flags, q, g, logp, v, stds, mean, est,
                                  sca, model, mopts, sset, use_grad_based,
                                  _check_block(q.shape[0], block))
    LAUNCHES["mclmc_fused_warmup"] += 1
    count_model(model)
    stats_out = {name: stats[:, i, :].T
                 for i, name in enumerate(WARMUP_STAT_NAMES)}
    stats_out["loop_iterations"] = iters
    return (q_f, g_f, logp_f, v_f, stds_f, mean_f, est_f, sca_f,
            draws.permute(2, 0, 1), stats_out)
