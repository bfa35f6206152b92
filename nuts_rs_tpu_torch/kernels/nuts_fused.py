"""Fused NUTS engine: posterior (K1) and warmup (K2) kernels.

Port of ``nuts_rs_tpu/kernels/nuts_pallas.py``: ``nuts_pallas_run``
(``:718``, body ``make_kernel`` ``:82``) becomes ``nuts_fused_run`` with the
CUDA kernel ``csrc/nuts_fused_posterior.cu``, and ``nuts_pallas_warmup_run``
(``:1532``, body ``make_warmup_kernel`` ``:942``) becomes
``nuts_fused_warmup_run`` with ``csrc/nuts_fused_warmup.cu``.  Both
layouts of those bodies are ported, and the posterior body's ``stream=``
mode (``:115-121,217-254``: kernel K1-stream,
``csrc/nuts_fused_stream_posterior.cu``, chosen with ``stream=True``),
without flow (ROADMAP.md queue 2): ``layout="cl"`` (chains-on-lanes) and ``layout="ld"``
(dim-on-lanes, ``nuts_pallas.py:123-136``: large d), whose kernels are
``csrc/nuts_fused_ld_posterior.cu`` and ``csrc/nuts_fused_ld_warmup.cu``:
one CUDA block of ``ops.TSUM_THREADS`` threads per chain and one thread
block cluster per logical chain block.  A model whose functor lacks the
one-coordinate term / finish form of ``iid_normal`` (every model with data,
and the funnel and ``correlated_normal``) takes the dim-on-lanes kernels
with data instead, ``csrc/nuts_fused_ld_args_posterior.cu`` and
``csrc/nuts_fused_ld_args_warmup.cu`` (kernels K1-ld-args and K2-ld-args:
the ``layout="ld"``, ``n_model_args > 0`` variants of the Pallas bodies,
which the JAX runners use for a model with ``pallas_spec`` above the cl
limit, ``nuts_rs_tpu/chain.py:788-801,1031-1044``): the ld bodies with the
model evaluated as the mid-d kernels evaluate it.  The layouts share the
tree algorithm, salts and stats.  They differ in the index of a vector
random site (``rng.BlockRng``) and in the default chain block.

Two kernel pairs serve ``layout="cl"`` (:func:`cl_kernel`).  At the
instantiated sizes (``_build.SIZES``, d <= ``_build.CL_THREAD_MAX_DIM``) a
model without data whose functor has the one-coordinate form
(``_build.COORD_FUNCTORS``) takes the chains-on-lanes kernels above (a
chain's coordinates on a group of lanes, ``_build.nuts_lanes``; sizes as
template parameters, every sum over the parameter axis in coordinate order,
``ops.dsum``).  At every other size, and for
every model that carries data (the ``n_model_args > 0`` variants of the
Pallas bodies, ``nuts_pallas.py:84,159-166`` and ``:944,975-979``: K1-args
and K2-args), it takes the mid-d kernels ``csrc/nuts_fused_mid_posterior.cu``
and ``csrc/nuts_fused_mid_warmup.cu``: the ld kernels' tree (d and maxdepth
at launch, sums in ``ops.tsum``'s order, logical blocks of at most 8
chains, by default 1) with the cl site index, G <= 8 chains a CUDA block
of 256 threads, one warp a chain (``_build.mid_group``), the regression
evaluated by the block for all its chains at once.  A model's data travel in its
``kernel_hook`` (``models/model.py``), not in an argument of their own.

Each kernel has a plain PyTorch version here (``*_reference``): the same
tree algorithm, the same counter-hash random sites with the same salts,
the same chain-block mapping (B chains per block) and the same order of
floating-point operations, vectorized over all chains.  The wrappers take
the plain version for tensors on the CPU; for CUDA tensors they launch the
kernel or raise.  ``LAUNCHES`` counts kernel launches per kernel.

Random sites (static salts, as the Pallas trace numbers them):
posterior: momentum 1,2 and direction 3 at it=0; per iteration it>=1:
r_sel 4, r_acc 5, new direction 6, fresh momentum 7,8, jitter 9.
warmup, per draw: momentum 1,2 and direction 3 at the draw's first it;
per tree iteration: r_sel 4, r_acc 5, new direction 6; after the tree the
jitter 7 at the tree's final it.  ``it`` carries across the draws of a
warmup launch.
"""

from __future__ import annotations

import math
from functools import partial

import torch

from ..ops import dsum, tsum
from ..ops import logaddexp as _logaddexp
from ._build import (
    COORD_FUNCTORS,
    DIMS,
    MAX_LD_BLOCK,
    SIZES,
    check_flow_args,
    check_posterior_args,
    check_warmup_args,
    count_model,
    launch_flow_posterior,
    launch_ld_posterior,
    launch_ld_warmup,
    launch_mid_posterior,
    launch_mid_warmup,
    launch_posterior,
    launch_stream_posterior,
    launch_warmup,
)
from .diag_adapt import NEST, adapt_draw
from .rng import BlockRng, tz

STAT_NAMES = [
    "depth", "diverging", "n_steps", "sum_accept", "sum_accept_sym",
    "max_energy_error", "logp", "energy", "energy_error",
    "index_in_trajectory", "fisher_distance", "step_size",
    "maxdepth_reached",
]
NSTATS = len(STAT_NAMES)
WARMUP_STAT_NAMES = STAT_NAMES + ["step_size_bar", "transformation_index"]
NSTATS_W = len(WARMUP_STAT_NAMES)

# flags columns (int32), as nuts_pallas.py:915-922
FLAG_UPDATE_EST = 0
FLAG_DO_UPDATE = 1
FLAG_ADVANCE_DA = 2
FLAG_USE_LATE = 3
FLAG_USE_BEST = 4
FLAG_DO_SWITCH = 5
NFLAGS = 8

# packed per-chain scalar state rows, as nuts_pallas.py:924-935
SCA_STEP = 0
SCA_DA_LS = 1
SCA_DA_LSA = 2
SCA_DA_HBAR = 3
SCA_DA_MU = 4
SCA_DA_CNT = 5
SCA_CNT_FG = 6
SCA_CNT_BG = 7
SCA_TID = 8
SCA_LOGDET = 9
NSCA = 10

DEFAULT_BLOCK = 32  # cl, K1 / K2: chains per CUDA block (of 32 * nuts_lanes)
# ld: chains per logical block = CUDA blocks per cluster (the portable
# cluster size, and the JAX package's smallest ld tier)
DEFAULT_LD_BLOCK = MAX_LD_BLOCK
# mid-d cl: a chain alone.  The chains of a logical block share only the
# iteration counter, so a larger block buys nothing and costs the wait for
# the block's slowest chain (posterior) or longest tree (warmup, per draw),
# and clusters of 8 fill the card in coarser waves (PERF.md: 1.4x and 1.9x
# the time per launch at 8 on the data path); blocks up to 8 stay available.
DEFAULT_MID_BLOCK = 1
# ld with data: a chain alone, for the reasons of the mid-d kernels (one
# chain block an SM; 512 chains in 4 waves where clusters of 8 take 5)
DEFAULT_LD_ARGS_BLOCK = 1
_DEFAULT_BLOCKS = {"thread": DEFAULT_BLOCK, "mid": DEFAULT_MID_BLOCK,
                   "ld": DEFAULT_LD_BLOCK, "ld_args": DEFAULT_LD_ARGS_BLOCK,
                   "flow": DEFAULT_MID_BLOCK}

LAUNCHES = {"nuts_fused_posterior": 0, "nuts_fused_warmup": 0,
            "nuts_fused_ld_posterior": 0, "nuts_fused_ld_warmup": 0,
            "nuts_fused_mid_posterior": 0, "nuts_fused_mid_warmup": 0,
            "nuts_fused_stream_posterior": 0,
            "nuts_fused_ld_args_posterior": 0,
            "nuts_fused_ld_args_warmup": 0,
            "nuts_fused_flow_posterior": 0}

_F32 = torch.float32
_NEG_INF = float("-inf")


def _block_any(x, B):
    """Per-chain view of ``any(x)`` over each chain's block of B."""
    C = x.shape[0]
    return x.reshape(C // B, B).any(1).repeat_interleave(B)


def _rand_dir(u):
    return torch.where(u < 0.5, 1.0, -1.0).to(_F32)


def _sel(m, a, b):
    """Per-chain select of [C] or [C, d] values on a [C] mask."""
    if a.dim() > m.dim():
        m = m[:, None]
    return torch.where(m, a, b)


def _uturn(leaf, depth, dirf, z1, v2, d1, lz, lv, bl, mz, mv, bm,
           m_z, m_v, p_z, p_v, D, csum):
    """U-turn checks of one leapfrog (nuts_pallas.py:405-576).

    Returns (turning_int, turning_top).  Stacks are the updated ones; the
    endpoints are the carried (pre-merge) ones.  The ld Pallas body reads
    the same dots from its cross-dot matrix ``czs`` (``:450-474``), which
    holds the same products summed the same way: no separate form here."""
    C = z1.shape[0]
    ar = torch.arange(C, device=z1.device)
    rows = torch.arange(D + 1, device=z1.device)[None, :]
    tzn = tz(leaf + 1, D)
    z1v = csum(z1[:, None, :] * lv)
    zv2 = csum(lz * v2[:, None, :])
    m1 = csum(z1[:, None, :] * mv)
    m2 = csum(mz * v2[:, None, :])
    zero = torch.zeros(C, 1, dtype=_F32, device=z1.device)
    adj_bzav = torch.cat([zero, csum(lz[:, :-1] * lv[:, 1:])], 1)
    adj_azbv = torch.cat([zero, csum(lz[:, 1:] * lv[:, :-1])], 1)
    blm1 = torch.cat([zero, bl[:, :-1]], 1)
    dirb = dirf[:, None]
    d1b = d1[:, None]
    t1 = (dirb * (z1v - bl) < 0) | (dirb * (d1b - zv2) < 0)
    t2 = (dirb * (m1 - bm) < 0) | (dirb * (d1b - m2) < 0)
    t3 = (dirb * (adj_bzav - bl) < 0) | (dirb * (blm1 - adj_azbv) < 0)
    tj = t1 | ((rows >= 2) & (t2 | t3))
    act_lvl = (rows >= 1) & (rows < tzn[:, None])
    turning = (act_lvl & tj).any(1)

    # the boundary level j == tzn, the only one with a dynamic row
    s_a = leaf + 1 - (1 << tzn)
    ra = torch.clamp(tz(s_a, D), max=D)
    rt = tzn
    rb = torch.clamp(tzn - 1, min=0)
    a_b = bl[ar, ra]
    t1d = ((dirf * (z1v[ar, ra] - a_b) < 0)
           | (dirf * (d1 - zv2[ar, ra]) < 0))
    t2d = ((dirf * (m1[ar, rt] - bm[ar, rt]) < 0)
           | (dirf * (d1 - m2[ar, rt]) < 0))
    t3d = ((dirf * (csum(lz[ar, rb] * lv[ar, ra]) - a_b) < 0)
           | (dirf * (bl[ar, rb] - csum(lz[ar, ra] * lv[ar, rb])) < 0))
    turning = turning | ((tzn >= 1) & t1d) | ((tzn >= 2) & (t2d | t3d))

    fwd = dirf > 0
    far_z = _sel(fwd, m_z, p_z)
    far_v = _sel(fwd, m_v, p_v)
    near_z = _sel(fwd, p_z, m_z)
    near_v = _sel(fwd, p_v, m_v)
    far_zv = csum(far_z * far_v)
    t_out = ((dirf * (csum(z1 * far_v) - far_zv) < 0)
             | (dirf * (d1 - csum(far_z * v2)) < 0))
    near_zv = csum(near_z * near_v)
    t_nr = ((dirf * (csum(z1 * near_v) - near_zv) < 0)
            | (dirf * (d1 - csum(near_z * v2)) < 0))
    t_b0 = ((dirf * (csum(lz[:, D] * far_v) - far_zv) < 0)
            | (dirf * (bl[:, D] - csum(far_z * lv[:, D])) < 0))
    turning_top = t_out | ((depth > 0) & (t_nr | t_b0))
    return turning, turning_top


def _check_layout(layout):
    if layout not in ("cl", "ld"):
        raise ValueError(f"unknown layout {layout!r}")
    return layout == "ld"


def cl_kernel(model, dim, maxdepth=None):
    """The kernel pair that serves ``layout="cl"`` for ``model`` at ``dim``:
    ``"thread"`` (a chain's coordinates on a group of lanes,
    ``_build.nuts_lanes`` and ``_build.mclmc_lanes``, at the instantiated
    sizes: ``dim`` in ``_build.DIMS`` and, for NUTS, which passes its
    ``maxdepth``, ``(dim, maxdepth)`` in ``_build.SIZES``, for a functor
    with the one-coordinate form, ``_build.COORD_FUNCTORS``) or ``"mid"``
    (256 threads a chain, any size and functor, the only one that reads a
    model's data; both number the random sites alike).  The plain versions
    take its sum order and default block."""
    hook = model.hook_parts()[0] if model.kernel_hook is not None else None
    if (model.carries_data or dim not in DIMS
            or (hook is not None and hook not in COORD_FUNCTORS)):
        return "mid"
    if maxdepth is not None and (dim, maxdepth) not in SIZES:
        return "mid"
    return "thread"


def _kernel_kind(model, dim, layout, maxdepth=None, stream=False,
                 flow=False):
    """``"ld"``, ``"ld_args"``, ``"stream"``, ``"flow"``, ``"mid"`` or
    ``"thread"``: the kernel of a call.  In the ld layout a functor of the
    term / finish form (``_build.COORD_FUNCTORS``) takes K1-ld / K2-ld, every
    other one K1-ld-args / K2-ld-args.  A frozen flow takes K1-flow, the
    mid-d body, in the chains-on-lanes layout only
    (``nuts_pallas.py:125-126``)."""
    if flow:
        if _check_layout(layout) or stream:
            raise ValueError("the flow kernel is chains-on-lanes only, "
                             "without streamed data")
        return "flow"
    if _check_layout(layout):
        if stream:
            raise ValueError("the streamed kernel is chains-on-lanes only")
        if model.kernel_hook is None or \
                model.hook_parts()[0] in COORD_FUNCTORS:
            return "ld"
        return "ld_args"
    if stream:
        if model.stream_tile_rows is None:
            raise ValueError(f"model {model.name!r} has no streamed form "
                             "(Model.stream_tile_rows)")
        return "stream"
    return cl_kernel(model, dim, maxdepth)


def _check_block(C, block, kind="thread"):
    if block is None:
        block = _DEFAULT_BLOCKS[kind]
    B = min(block, C)
    if C % B:
        raise ValueError(f"num_chains ({C}) must be a multiple of the chain "
                         f"block ({B})")
    return B


def _stream_sizes(model, C, maxdepth, block, ranges):
    """(B, R) of a K1-stream call: the logical chain block, by default the
    JAX posterior runner's (``chain.stream_block``), else ``min(block, C)``,
    which must divide the chains; and the ranges the tiles fall into, by
    default ``gaussian.stream_ranges``, else 1..T.  A block of any size is
    taken here; on the card its chains must also be resident at once."""
    from ..chain import stream_block
    from ..models.gaussian import stream_ranges

    B = stream_block(model, maxdepth, C) if block is None \
        else _check_block(C, block)
    T = -(-model.hook_parts()[2][1].shape[0] // model.stream_tile_rows)
    R = stream_ranges(T) if ranges is None else ranges
    if not isinstance(R, int) or not 1 <= R <= T:
        raise ValueError(f"ranges must be an int in 1..{T} (the tiles), "
                         f"got {R!r}")
    return B, R


def _evaluators(model, kind, ranges=None):
    """(csum, logp_and_grad) of a kernel ("thread", "mid", "stream" or
    "ld"): its sum over the parameter axis, and the model evaluated as the
    kernel evaluates it, through the plain counterpart of its device functor
    with that sum ("stream": the streamed functor, its tiles in ``ranges``
    ranges).  A model without a functor has no kernel to agree with and is
    evaluated as it is."""
    from ..models.gaussian import PLAIN_FUNCTORS

    csum = dsum if kind == "thread" else tsum
    if model.kernel_hook is None:
        return csum, model.logp_and_grad
    name, floats, tensors = model.hook_parts()
    if kind == "stream":
        functor = PLAIN_FUNCTORS[name + "_stream"]
        rows = model.stream_tile_rows
        return csum, lambda q: functor(q, *floats, *tensors, rows, csum,
                                       ranges)
    functor = PLAIN_FUNCTORS[name]
    return csum, lambda q: functor(q, *floats, *tensors, csum)


def _jitter_consts(jitter):
    """(1 - j, 2 j) as the Pallas body forms them in f64 before the f32
    arithmetic; the CUDA kernels take the same two f32 constants."""
    return 1.0 - jitter, 2.0 * jitter


# ---------------------------------------------------------------------------
# K1: fused posterior
# ---------------------------------------------------------------------------


def _flow_evaluator(packed, logp_and_grad, csum):
    """K1-flow's evaluation z -> (logp, zg, logdet, q) through the frozen
    packed flow (``nuts_pallas.py:202-216``), in the kernel's order
    (``flows/coupling.py::packed_forward`` / ``packed_backward``, the model
    through its plain functor, logdet the ``csum`` of each coordinate's s
    over the layers and its log sigma)."""
    from ..flows.coupling import packed_backward, packed_forward

    def eval_z(z):
        q, sacc, acts = packed_forward(packed, z)
        logp, g = logp_and_grad(q)
        return logp, packed_backward(packed, acts, g), csum(sacc), q

    return eval_z


def nuts_fused_run_reference(seed, q, g, logp, stds, mean, logdet, step0,
                             step_bar, num_draws, model, opts, jitter,
                             block=None, layout="cl", stream=False,
                             flow=None, ranges=None):
    """Plain PyTorch version of the fused posterior kernels.

    Same arguments and results as :func:`nuts_fused_run`."""
    C, d = q.shape
    K = num_draws
    kind = _kernel_kind(model, d, layout, opts.maxdepth, stream,
                        flow is not None)
    if kind == "stream":
        B, R = _stream_sizes(model, C, opts.maxdepth, block, ranges)
    else:
        B, R = _check_block(C, block, kind), None
    csum, logp_and_grad = _evaluators(model, kind, R)
    D = opts.maxdepth
    max_err = float(opts.max_energy_error)
    dev = q.device
    f = lambda x: x.to(_F32).contiguous()  # noqa: E731
    q, g, stds, mean = f(q), f(g), f(stds), f(mean)
    logp, logdet, step, bar = f(logp), f(logdet), f(step0), f(step_bar)
    rng = BlockRng(seed, C, d, B, dev, layout)
    ar = torch.arange(C, device=dev)
    zi = torch.zeros(C, dtype=torch.int32, device=dev)
    zf = torch.zeros(C, dtype=_F32, device=dev)

    if flow is not None:
        # the q slot carries z0; one evaluation gives q, logp, the gradient
        # and the position-dependent logdet at the start
        eval_z = _flow_evaluator(flow, logp_and_grad, csum)
        z0 = q
        logp, zg0, ld0, q = eval_z(z0)
    else:
        z0 = (q - mean) / stds
        zg0 = g * stds
        ld0 = logdet
    v0 = rng.normals_vec(0, 1, 2)
    ke0 = 0.5 * csum(v0 * v0)
    e_init = ke0 - (logp + ld0)
    dc = zi
    e_z, e_v, e_zg, e_idx = z0, v0, zg0, zi
    m_z, m_v, m_zg, m_idx = z0, v0, zg0, zi
    p_z, p_v, p_zg, p_idx = z0, v0, zg0, zi
    dm_z, dm_zg, dm_logp, dm_ke, dm_idx, dm_q = z0, zg0, logp, ke0, zi, q
    ds_z, ds_zg, ds_logp, ds_ke, ds_idx, ds_q = z0, zg0, logp, ke0, zi, q
    dm_ld = ds_ld = ld0
    logw_m = zf
    logw_s = torch.full_like(zf, _NEG_INF)
    depth, leaf = zi, zi
    direction = _rand_dir(rng.uniform(0, 3))
    n_steps, s_acc, s_sym, mx_err = zi, zf, zf, zf
    lz = torch.zeros(C, D + 1, d, dtype=_F32, device=dev)
    lv, mz, mv = lz.clone(), lz.clone(), lz.clone()
    bl = torch.zeros(C, D + 1, dtype=_F32, device=dev)
    bm = bl.clone()

    draws = torch.zeros(C, K, d, dtype=_F32, device=dev)
    stats = torch.zeros(C, K, NSTATS, dtype=_F32, device=dev)
    fin_q, fin_zg, fin_logp, fin_z = dm_q, dm_zg, dm_logp, dm_z
    iters = torch.zeros(C, dtype=torch.int32, device=dev)
    c1, c2 = _jitter_consts(jitter) if jitter is not None else (None, None)

    it = 1
    live = _block_any(dc < K, B)
    while bool(live.any()):
        r_sel = rng.uniform(it, 4)
        r_acc = rng.uniform(it, 5)
        dirf = direction
        eps = (dirf * step)[:, None]
        v1 = e_v + (eps / 2.0) * e_zg
        z1 = e_z + eps * v1
        if flow is not None:
            logp1, zg1, ld1, q1 = eval_z(z1)
        else:
            q1 = z1 * stds + mean
            logp1, g1 = logp_and_grad(q1)
            zg1 = g1 * stds
            ld1 = logdet
        v2 = v1 + (eps / 2.0) * zg1
        ke1 = 0.5 * csum(v2 * v2)
        err = (ke1 - (logp1 + ld1)) - e_init
        diverged = (err > max_err) | ~torch.isfinite(err)
        idx1 = e_idx + dirf.to(torch.int32)

        diff = -err
        acc = torch.exp(torch.clamp(diff, max=0.0))
        n_steps = n_steps + 1
        s_acc = s_acc + torch.where(diverged, 0.0, acc)
        s_sym = s_sym + torch.where(diverged, 0.0,
                                    2.0 * acc / (1.0 + torch.exp(diff)))
        mx_err = torch.where(diverged, _NEG_INF,
                             torch.where(torch.abs(diff) > torch.abs(mx_err),
                                         diff, mx_err))

        logw_leaf = -err
        first = leaf == 0
        logw_s = torch.where(first, logw_leaf, _logaddexp(logw_s, logw_leaf))
        take = first | (torch.log(r_sel) < logw_leaf - logw_s)
        ds_z, ds_zg = _sel(take, z1, ds_z), _sel(take, zg1, ds_zg)
        ds_logp, ds_ke = _sel(take, logp1, ds_logp), _sel(take, ke1, ds_ke)
        ds_idx, ds_q = _sel(take, idx1, ds_idx), _sel(take, q1, ds_q)
        ds_ld = _sel(take, ld1, ds_ld)

        d1 = csum(z1 * v2)
        row_l = torch.clamp(tz(leaf, D), max=D)
        row_m = torch.clamp(tz(leaf + 1, D) + 1, max=D)
        lz[ar, row_l] = z1
        lv[ar, row_l] = v2
        bl[ar, row_l] = d1
        mz[ar, row_m] = z1
        mv[ar, row_m] = v2
        bm[ar, row_m] = d1
        turning_int, turning_top = _uturn(
            leaf, depth, dirf, z1, v2, d1, lz, lv, bl, mz, mv, bm,
            m_z, m_v, p_z, p_v, D, csum)

        subtree_done = (leaf + 1) == (1 << depth)
        fwd = dirf > 0
        do_merge = subtree_done & ~diverged & ~turning_int
        take_s = (logw_s >= logw_m) | (torch.log(r_acc) < logw_s - logw_m)
        mt = do_merge & take_s
        dm_z, dm_zg = _sel(mt, ds_z, dm_z), _sel(mt, ds_zg, dm_zg)
        dm_logp, dm_ke = _sel(mt, ds_logp, dm_logp), _sel(mt, ds_ke, dm_ke)
        dm_idx, dm_q = _sel(mt, ds_idx, dm_idx), _sel(mt, ds_q, dm_q)
        dm_ld = _sel(mt, ds_ld, dm_ld)
        logw_m = torch.where(do_merge, _logaddexp(logw_m, logw_s), logw_m)
        mf = do_merge & fwd
        mb = do_merge & ~fwd
        p_z, p_v, p_zg = _sel(mf, z1, p_z), _sel(mf, v2, p_v), _sel(mf, zg1, p_zg)
        p_idx = _sel(mf, idx1, p_idx)
        m_z, m_v, m_zg = _sel(mb, z1, m_z), _sel(mb, v2, m_v), _sel(mb, zg1, m_zg)
        m_idx = _sel(mb, idx1, m_idx)

        depth = depth + do_merge.to(torch.int32)
        turned = turning_int | (do_merge & turning_top)
        fin = diverged | turned | (depth >= D)

        emit = fin & (dc < K)
        if bool(emit.any()):
            energy_m = dm_ke - (dm_logp + dm_ld)
            row = torch.stack([
                depth.to(_F32), diverged.to(_F32), n_steps.to(_F32), s_acc,
                s_sym, mx_err, dm_logp, energy_m, energy_m - e_init,
                dm_idx.to(_F32), csum(torch.square(dm_z + dm_zg)), step,
                ((depth >= D) & ~turned & ~diverged).to(_F32)], 1)
            ce = emit.nonzero()[:, 0]
            draws[ce, dc[ce].long()] = dm_q[ce]
            stats[ce, dc[ce].long()] = row[ce]

        new_dir = _rand_dir(rng.uniform(it, 6))
        new_doub = do_merge & ~fin
        v_new = rng.normals_vec(it, 7, 8)
        ke_new = 0.5 * csum(v_new * v_new)
        if jitter is None:
            step_new = bar
        else:
            step_new = bar * (c1 + c2 * rng.uniform(it, 9))
        jump_p = new_dir > 0
        j_z, j_v = _sel(jump_p, p_z, m_z), _sel(jump_p, p_v, m_v)
        j_zg, j_idx = _sel(jump_p, p_zg, m_zg), _sel(jump_p, p_idx, m_idx)

        def nxt(fresh, doub, cont):
            return _sel(fin, fresh, _sel(new_doub, doub, cont))

        step = _sel(fin, step_new, step)
        e_init = _sel(fin, ke_new - (dm_logp + dm_ld), e_init)
        dc = dc + fin.to(torch.int32)
        e_z, e_v = nxt(dm_z, j_z, z1), nxt(v_new, j_v, v2)
        e_zg, e_idx = nxt(dm_zg, j_zg, zg1), nxt(zi, j_idx, idx1)
        m_z, m_v = _sel(fin, dm_z, m_z), _sel(fin, v_new, m_v)
        m_zg, m_idx = _sel(fin, dm_zg, m_zg), _sel(fin, zi, m_idx)
        p_z, p_v = _sel(fin, dm_z, p_z), _sel(fin, v_new, p_v)
        p_zg, p_idx = _sel(fin, dm_zg, p_zg), _sel(fin, zi, p_idx)
        dm_ke, dm_idx = _sel(fin, ke_new, dm_ke), _sel(fin, zi, dm_idx)
        logw_m = _sel(fin, zf, logw_m)
        depth = _sel(fin, zi, depth)
        reset = fin | new_doub
        leaf = torch.where(reset, 0, leaf + 1).to(torch.int32)
        direction = _sel(reset, new_dir, direction)
        n_steps = _sel(fin, zi, n_steps)
        s_acc, s_sym = _sel(fin, zf, s_acc), _sel(fin, zf, s_sym)
        mx_err = _sel(fin, zf, mx_err)

        # a block's results are its chains' values at its last iteration
        fin_q = _sel(live, dm_q, fin_q)
        fin_zg = _sel(live, dm_zg, fin_zg)
        fin_logp = _sel(live, dm_logp, fin_logp)
        fin_z = _sel(live, dm_z, fin_z)
        iters = torch.where(live, it + 1, iters).to(torch.int32)
        it += 1
        live = _block_any(dc < K, B)

    stats_out = {name: stats[:, :, i] for i, name in enumerate(STAT_NAMES)}
    stats_out["loop_iterations"] = iters
    # under a flow the aux slot carries the final z (nuts_pallas.py:709-710)
    aux = fin_z if flow is not None else fin_zg / stds
    return fin_q, aux, fin_logp, draws, stats_out


def nuts_fused_run(seed, q, g, logp, stds, mean, logdet, step0, step_bar,
                   num_draws, model, opts, jitter, block=None, layout="cl",
                   stream=False, flow=None, ranges=None):
    """Run ``num_draws`` draw-asynchronous NUTS draws per chain.

    q, g, stds, mean: [C, d]; logp, logdet, step0, step_bar: [C].  Returns
    (q_f [C, d], g_f [C, d], logp_f [C], draws [C, K, d], stats) with stats
    a dict of [C, K] float32 arrays keyed by ``STAT_NAMES`` plus
    ``loop_iterations`` [C].  The first draw of each chain uses ``step0``;
    later draws use ``step_bar`` jittered by ``jitter``.  ``block`` is the
    logical chain block (default 32 for the chains-on-lanes cl kernel, 1
    for the mid-d cl kernel, 8 for the ld kernel, 1 for the ld kernel with
    data).  With ``stream`` the
    model's data are evaluated in row tiles of ``model.stream_tile_rows``
    (kernel K1-stream, ``layout="cl"`` only), and the chains of a block
    share each pass over the data: ``block`` defaults to the JAX posterior
    runner's (``chain.stream_block``: 256 chains for
    ``logistic_regression(131072, 100)``), and the tiles fall into
    ``ranges`` ranges (default ``gaussian.stream_ranges``: one a tile, at
    most 256) whose sums are added in order.  With ``flow`` (a
    ``flows/coupling.py::PackedFlow``, one set of parameters for every
    chain) the chains move in the flow's z-space
    (kernel K1-flow, ``layout="cl"`` only, default block 1): ``q`` carries
    z0 (g, logp, stds, mean and logdet are not read) and the returned
    ``g_f`` the final z; draws are in q-space.

    CPU tensors run the plain PyTorch version; CUDA tensors launch
    ``csrc/nuts_fused_posterior.cu`` or ``csrc/nuts_fused_mid_posterior.cu``
    (cl, see :func:`cl_kernel`), ``csrc/nuts_fused_stream_posterior.cu``
    (``stream``), ``csrc/nuts_fused_ld_posterior.cu`` (ld) or
    ``csrc/nuts_fused_ld_args_posterior.cu`` (ld, a functor without the
    term / finish form) or ``csrc/nuts_fused_flow_posterior.cu``
    (``flow``)."""
    check_posterior_args(q, g, logp, stds, mean, logdet, step0, step_bar,
                         num_draws)
    kind = _kernel_kind(model, q.shape[1], layout, opts.maxdepth, stream,
                        flow is not None)
    if flow is not None:
        check_flow_args(flow, q.shape[1], q.device)
    if kind == "stream":
        B, R = _stream_sizes(model, q.shape[0], opts.maxdepth, block, ranges)
    if q.device.type == "cpu":
        return nuts_fused_run_reference(seed, q, g, logp, stds, mean, logdet,
                                        step0, step_bar, num_draws, model,
                                        opts, jitter, block, layout, stream,
                                        flow, ranges)
    if kind == "thread":
        draws, stats, q_f, g_f, logp_f, iters = launch_posterior(
            seed, q, g, logp, stds, mean, logdet, step0, step_bar, num_draws,
            model, opts, jitter, _check_block(q.shape[0], block))
        LAUNCHES["nuts_fused_posterior"] += 1
        count_model(model)
        stats_out = {name: stats[:, i, :].T
                     for i, name in enumerate(STAT_NAMES)}
        stats_out["loop_iterations"] = iters
        return q_f, g_f, logp_f, draws.permute(2, 0, 1), stats_out
    if kind == "stream":
        launch = partial(launch_stream_posterior, R=R)
    else:
        B = _check_block(q.shape[0], block, kind)
        launch = {"ld": launch_ld_posterior, "mid": launch_mid_posterior,
                  "ld_args": partial(launch_mid_posterior, family="ld_args"),
                  "flow": partial(launch_flow_posterior, flow=flow)}[kind]
    draws, stats, q_f, g_f, logp_f, iters = launch(
        seed, q, g, logp, stds, mean, logdet, step0, step_bar, num_draws,
        model, opts, jitter, B)
    LAUNCHES[f"nuts_fused_{kind}_posterior"] += 1
    count_model(model, kind == "stream")
    stats_out = {name: stats[:, :, i].T for i, name in enumerate(STAT_NAMES)}
    stats_out["loop_iterations"] = iters
    return q_f, g_f, logp_f, draws.permute(1, 0, 2), stats_out


# ---------------------------------------------------------------------------
# K2: fused warmup
# ---------------------------------------------------------------------------


def nuts_fused_warmup_run_reference(seed, flags, q, g, logp, stds, mean, est,
                                    sca, model, opts, sset, use_grad_based,
                                    block=None, layout="cl"):
    """Plain PyTorch version of the fused warmup kernels.

    Same arguments and results as :func:`nuts_fused_warmup_run`."""
    C, d = q.shape
    K = flags.shape[0]
    kind = _kernel_kind(model, d, layout, opts.maxdepth)
    csum, logp_and_grad = _evaluators(model, kind)
    B = _check_block(C, block, kind)
    D = opts.maxdepth
    max_err = float(opts.max_energy_error)
    da = sset.dual_average
    jitter = sset.jitter
    dev = q.device
    f = lambda x: x.to(_F32).contiguous()  # noqa: E731
    q, g, logp, stds, mean = f(q), f(g), f(logp), f(stds), f(mean)
    est = [f(est[:, p]) for p in range(NEST)]
    sca = [f(sca[:, r]) for r in range(NSCA)]
    flags = flags.to("cpu", torch.int32)
    rng = BlockRng(seed, C, d, B, dev, layout)
    ar = torch.arange(C, device=dev)
    zi = torch.zeros(C, dtype=torch.int32, device=dev)
    zf = torch.zeros(C, dtype=_F32, device=dev)
    ls_max = math.log(da.max_step_size)
    c1, c2 = _jitter_consts(jitter) if jitter is not None else (None, None)

    draws = torch.zeros(C, K, d, dtype=_F32, device=dev)
    stats = torch.zeros(C, K, NSTATS_W, dtype=_F32, device=dev)
    it = torch.ones(C, dtype=torch.int64, device=dev)

    for i in range(K):
        fl = [bool(flags[i, col]) for col in range(6)]
        (f_upd_est, f_do_upd, f_adv_da, f_use_late, f_use_best,
         f_switch) = fl
        logdet = sca[SCA_LOGDET]
        step = sca[SCA_STEP]

        z0 = (q - mean) / stds
        zg0 = g * stds
        v0 = rng.normals_vec(it, 1, 2)
        ke0 = 0.5 * csum(v0 * v0)
        e_init = ke0 - (logp + logdet)
        done, div, turn = (torch.zeros(C, dtype=torch.bool, device=dev)
                           for _ in range(3))
        e_z, e_v, e_zg, e_idx = z0, v0, zg0, zi
        m_z, m_v, m_zg, m_idx = z0, v0, zg0, zi
        p_z, p_v, p_zg, p_idx = z0, v0, zg0, zi
        dm_z, dm_zg, dm_logp, dm_ke, dm_idx = z0, zg0, logp, ke0, zi
        ds_z, ds_zg, ds_logp, ds_ke, ds_idx = z0, zg0, logp, ke0, zi
        logw_m = zf
        logw_s = torch.full_like(zf, _NEG_INF)
        depth, leaf = zi, zi
        direction = _rand_dir(rng.uniform(it, 3))
        n_steps, s_acc, s_sym, mx_err = zi, zf, zf, zf
        lz = torch.zeros(C, D + 1, d, dtype=_F32, device=dev)
        lv, mz, mv = lz.clone(), lz.clone(), lz.clone()
        bl = torch.zeros(C, D + 1, dtype=_F32, device=dev)
        bm = bl.clone()

        live = _block_any(~done, B)
        while bool(live.any()):
            act = ~done
            r_sel = rng.uniform(it, 4)
            r_acc = rng.uniform(it, 5)
            dirf = direction
            eps = (dirf * step)[:, None]
            v1 = e_v + (eps / 2.0) * e_zg
            z1 = e_z + eps * v1
            logp1, g1 = logp_and_grad(z1 * stds + mean)
            zg1 = g1 * stds
            v2 = v1 + (eps / 2.0) * zg1
            ke1 = 0.5 * csum(v2 * v2)
            err = (ke1 - (logp1 + logdet)) - e_init
            diverged = act & ((err > max_err) | ~torch.isfinite(err))
            idx1 = e_idx + dirf.to(torch.int32)

            diff = -err
            acc = torch.exp(torch.clamp(diff, max=0.0))
            n_steps = n_steps + act.to(torch.int32)
            ok = act & ~diverged
            s_acc = s_acc + torch.where(ok, acc, 0.0)
            s_sym = s_sym + torch.where(
                ok, 2.0 * acc / (1.0 + torch.exp(diff)), 0.0)
            mx_err = torch.where(
                diverged, _NEG_INF,
                torch.where(act & (torch.abs(diff) > torch.abs(mx_err)),
                            diff, mx_err))

            logw_leaf = -err
            first = leaf == 0
            logw_s = torch.where(
                act, torch.where(first, logw_leaf,
                                 _logaddexp(logw_s, logw_leaf)), logw_s)
            take = act & (first | (torch.log(r_sel) < logw_leaf - logw_s))
            ds_z, ds_zg = _sel(take, z1, ds_z), _sel(take, zg1, ds_zg)
            ds_logp, ds_ke = _sel(take, logp1, ds_logp), _sel(take, ke1, ds_ke)
            ds_idx = _sel(take, idx1, ds_idx)

            d1 = csum(z1 * v2)
            row_l = torch.clamp(tz(leaf, D), max=D)
            row_m = torch.clamp(tz(leaf + 1, D) + 1, max=D)
            ca = act.nonzero()[:, 0]
            lz[ca, row_l[ca]] = z1[ca]
            lv[ca, row_l[ca]] = v2[ca]
            bl[ca, row_l[ca]] = d1[ca]
            mz[ca, row_m[ca]] = z1[ca]
            mv[ca, row_m[ca]] = v2[ca]
            bm[ca, row_m[ca]] = d1[ca]
            turning_int, turning_top = _uturn(
                leaf, depth, dirf, z1, v2, d1, lz, lv, bl, mz, mv, bm,
                m_z, m_v, p_z, p_v, D, csum)
            turning_int = turning_int & act

            subtree_done = (leaf + 1) == (1 << depth)
            fwd = dirf > 0
            do_merge = act & subtree_done & ~diverged & ~turning_int
            take_s = (logw_s >= logw_m) | (torch.log(r_acc) < logw_s - logw_m)
            mt = do_merge & take_s
            dm_z, dm_zg = _sel(mt, ds_z, dm_z), _sel(mt, ds_zg, dm_zg)
            dm_logp, dm_ke = _sel(mt, ds_logp, dm_logp), _sel(mt, ds_ke, dm_ke)
            dm_idx = _sel(mt, ds_idx, dm_idx)
            logw_m = torch.where(do_merge, _logaddexp(logw_m, logw_s), logw_m)
            mf = do_merge & fwd
            mb = do_merge & ~fwd
            p_z, p_v = _sel(mf, z1, p_z), _sel(mf, v2, p_v)
            p_zg, p_idx = _sel(mf, zg1, p_zg), _sel(mf, idx1, p_idx)
            m_z, m_v = _sel(mb, z1, m_z), _sel(mb, v2, m_v)
            m_zg, m_idx = _sel(mb, zg1, m_zg), _sel(mb, idx1, m_idx)

            depth = depth + do_merge.to(torch.int32)
            turned = turning_int | (do_merge & turning_top)
            tree_done = act & (diverged | turned | (depth >= D))

            new_dir = _rand_dir(rng.uniform(it, 6))
            new_doub = do_merge & (depth < D) & ~turned
            jump_p = new_dir > 0
            j_z, j_v = _sel(jump_p, p_z, m_z), _sel(jump_p, p_v, m_v)
            j_zg, j_idx = _sel(jump_p, p_zg, m_zg), _sel(jump_p, p_idx, m_idx)

            def cont2(doub, cont, old):
                return _sel(act, _sel(new_doub, doub, cont), old)

            done = done | tree_done
            div = div | diverged
            turn = turn | turned
            e_z, e_v = cont2(j_z, z1, e_z), cont2(j_v, v2, e_v)
            e_zg, e_idx = cont2(j_zg, zg1, e_zg), cont2(j_idx, idx1, e_idx)
            leaf = torch.where(act, torch.where(new_doub, 0, leaf + 1),
                               leaf).to(torch.int32)
            direction = _sel(act & new_doub, new_dir, direction)
            it = it + live.to(torch.int64)
            live = _block_any(~done, B)

        # ---- draw results and in-kernel adaptation ----
        dm_q = dm_z * stds + mean
        dm_g = dm_zg / stds
        is_good = ((div & (torch.abs(dm_idx) > 4))
                   | (~div & (dm_idx != 0)))
        est, cnt_fg, cnt_bg, stds_n, mean_n, logdet_n, tid_n = adapt_draw(
            est, sca[SCA_CNT_FG], sca[SCA_CNT_BG], sca[SCA_TID], stds, mean,
            dm_q, dm_g, is_good & f_upd_est, f_switch, f_do_upd,
            use_grad_based, csum)

        nst = torch.clamp(n_steps.to(_F32), min=1.0)
        accept = s_sym / nst if f_use_late else s_acc / nst
        da_cnt = sca[SCA_DA_CNT]
        w = 1.0 / (da_cnt + da.t0)
        hbar_n = (1.0 - w) * sca[SCA_DA_HBAR] + w * (sset.target_accept
                                                    - accept)
        # a tensor divisor: PyTorch's CUDA division by a Python scalar
        # multiplies by its reciprocal, which rounds differently
        ls_n = sca[SCA_DA_MU] - hbar_n * torch.sqrt(da_cnt) / torch.full_like(
            hbar_n, da.gamma)
        ls_n = torch.clamp(ls_n, max=ls_max)
        mk = torch.exp(-da.k * torch.log(da_cnt))
        lsa_n = mk * ls_n + (1.0 - mk) * sca[SCA_DA_LSA]
        if f_adv_da:
            da_ls, da_lsa, da_hbar = ls_n, lsa_n, hbar_n
            da_cnt = da_cnt + 1.0
        else:
            da_ls, da_lsa, da_hbar = (sca[SCA_DA_LS], sca[SCA_DA_LSA],
                                      sca[SCA_DA_HBAR])
        base = torch.exp(da_lsa if f_use_best else da_ls)
        if jitter is not None:
            base = base * (c1 + c2 * rng.uniform(it, 7))
        bar = torch.exp(da_lsa)

        energy_m = dm_ke - (dm_logp + logdet)
        draws[:, i] = dm_q
        stats[:, i] = torch.stack([
            depth.to(_F32), div.to(_F32), n_steps.to(_F32), s_acc, s_sym,
            mx_err, dm_logp, energy_m, energy_m - e_init, dm_idx.to(_F32),
            csum(torch.square(dm_z + dm_zg)), base,
            ((depth >= D) & ~div & ~turn).to(_F32), bar, tid_n], 1)

        sca = [base, da_ls, da_lsa, da_hbar, sca[SCA_DA_MU], da_cnt, cnt_fg,
               cnt_bg, tid_n, logdet_n]
        q, g, logp, stds, mean = dm_q, dm_g, dm_logp, stds_n, mean_n

    stats_out = {name: stats[:, :, i] for i, name in enumerate(WARMUP_STAT_NAMES)}
    stats_out["loop_iterations"] = it.to(torch.int32)
    return (q, g, logp, stds, mean, torch.stack(est, 1), torch.stack(sca, 1),
            draws, stats_out)


def nuts_fused_warmup_run(seed, flags, q, g, logp, stds, mean, est, sca,
                          model, opts, sset, use_grad_based, block=None,
                          layout="cl"):
    """Run K = flags.shape[0] lock-step warmup draws with in-kernel
    adaptation.

    flags [K, NFLAGS] int32 (``FLAG_*`` columns); q, g, stds, mean [C, d];
    logp [C]; est [C, 8, d] estimator planes; sca [C, NSCA] scalar rows
    (``SCA_*``).  Returns (q, g, logp, stds, mean, est, sca, draws
    [C, K, d], stats) with stats a dict of [C, K] arrays keyed by
    ``WARMUP_STAT_NAMES`` plus ``loop_iterations`` [C].  The chains of a
    logical block of ``block`` chains (default 32 for the chains-on-lanes
    cl kernel, 1 for the mid-d cl kernel, 8 for the ld kernel, 1 for the ld
    kernel with data) share the iteration
    counter and wait for the block's longest tree in every draw.

    CPU tensors run the plain PyTorch version; CUDA tensors launch
    ``csrc/nuts_fused_warmup.cu`` or ``csrc/nuts_fused_mid_warmup.cu`` (cl,
    see :func:`cl_kernel`), ``csrc/nuts_fused_ld_warmup.cu`` (ld) or
    ``csrc/nuts_fused_ld_args_warmup.cu`` (ld, a functor without the term /
    finish form)."""
    check_warmup_args(flags, q, g, logp, stds, mean, est, sca)
    kind = _kernel_kind(model, q.shape[1], layout, opts.maxdepth)
    if q.device.type == "cpu":
        return nuts_fused_warmup_run_reference(
            seed, flags, q, g, logp, stds, mean, est, sca, model, opts, sset,
            use_grad_based, block, layout)
    if kind != "thread":
        launch = {"ld": launch_ld_warmup, "mid": launch_mid_warmup,
                  "ld_args": partial(launch_mid_warmup,
                                     family="ld_args")}[kind]
        (draws, stats, q_f, g_f, logp_f, stds_f, mean_f, est_f, sca_f,
         iters) = launch(seed, flags, q, g, logp, stds, mean, est, sca,
                         model, opts, sset, use_grad_based,
                         _check_block(q.shape[0], block, kind))
        LAUNCHES[f"nuts_fused_{kind}_warmup"] += 1
        count_model(model)
        stats_out = {name: stats[:, :, i].T
                     for i, name in enumerate(WARMUP_STAT_NAMES)}
        stats_out["loop_iterations"] = iters
        return (q_f, g_f, logp_f, stds_f, mean_f, est_f, sca_f,
                draws.permute(1, 0, 2), stats_out)
    (draws, stats, q_f, g_f, logp_f, stds_f, mean_f, est_f, sca_f,
     iters) = launch_warmup(seed, flags, q, g, logp, stds, mean, est, sca,
                            model, opts, sset, use_grad_based,
                            _check_block(q.shape[0], block))
    LAUNCHES["nuts_fused_warmup"] += 1
    count_model(model)
    stats_out = {name: stats[:, i, :].T
                 for i, name in enumerate(WARMUP_STAT_NAMES)}
    stats_out["loop_iterations"] = iters
    return (q_f, g_f, logp_f, stds_f, mean_f, est_f, sca_f,
            draws.permute(2, 0, 1), stats_out)
