"""Iterative No-U-Turn trajectories: the draw-synchronous engine.

Port of ``nuts_rs_tpu/kernels/nuts.py`` (whole): ``NutsOptions``
(``:62-78``, with ``collect_orbit``, the orbit buffers of flow training,
``:75-77,135-140,250-258,324-340``), ``DivergenceInfo`` and
``NutsInfo`` (``:91-140``), the tree carry (``:143-179``), ``_dyn_depths``
(``:198``), ``_init_tree_carry`` (``:215``), ``_tree_body`` (``:265``),
``_extract_info`` (``:493``) and ``nuts_draw`` (``:521``).  The tree algorithm
is that module's (trailing-zero span recovery, the left and mid checkpoint
stacks, the U-turn check set of nuts-rs ``src/nuts.rs:148-161``, progressive
multinomial selection inside a subtree and the biased merge at the top);
its docstring describes it.

Where the JAX package vmaps a per-chain ``lax.while_loop``, this module runs
ONE batched tree over ``[C, d]`` tensors: every iteration takes one leapfrog
for all chains, a ``[C]`` mask keeps the chains whose tree has finished as
they were, and a host loop runs while any chain is active.  The checkpoint
stacks are ``[C, D + 1, d]`` and each chain writes its own row.  The engine
has no kernel to agree with bit for bit, so it sums with ``torch.sum`` and
evaluates the model through ``Model.logp_and_grad`` (the closed form, or
``torch.func`` for a model without one).  It works in the dtype of the point
it is given.

Randomness comes from the counter hash (``kernels/rng.py``), never from a
global generator, so a draw is the same on the CPU and on the card up to
float rounding.  Key layout of one draw, ``hash(seed, it, salt, idx)``:
``seed`` is the caller's per-draw seed (``chain.make_draw_step`` derives it
from the base seed and the global draw index); ``it`` is 0 before the tree
and the tree iteration 1, 2, ... inside it; a scalar site has ``idx`` = the
chain ``c`` and a vector site ``idx = c * d + j``.  Salts: 1, 2 the fresh
momentum (Box-Muller) and 3 the first direction, at ``it`` 0; 4 the leaf
selection inside the subtree, 5 the merge acceptance, 6 the next direction,
at the tree iteration that uses them.  (Salt 7 at ``it`` 0 is the draw's
step-size jitter, taken by ``chain.make_draw_step``.)
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from ..dynamics.hamiltonian import (
    KineticKind,
    initialize_trajectory,
    leapfrog,
    sample_momentum,
)
from ..dynamics.point import Point, chains_where, point_where
from ..ops import logaddexp
from ..transform.ops import AFFINE_OPS
from .rng import hash_bits, host_uniform, tz, uniform_from_bits

SALT_MOMENTUM = (1, 2)
SALT_FIRST_DIRECTION = 3
SALT_SELECT = 4
SALT_ACCEPT = 5
SALT_DIRECTION = 6
SALT_JITTER = 7
# Tree iterations whose uniforms one hash call draws (a draw's first call
# covers most trees; the sites are the same whatever the grouping).
_UNIFORM_ITERATIONS = 32


@dataclasses.dataclass(frozen=True)
class NutsOptions:
    """Static draw options (nuts-rs ``src/nuts.rs:257-279``)."""

    maxdepth: int = 10
    mindepth: int = 0
    check_turning: bool = True
    max_energy_error: float = 1000.0
    extra_doublings: int = 0
    target_integration_time: Optional[float] = None
    kind: KineticKind = KineticKind.EUCLIDEAN
    store_divergences: bool = False
    # Collect every leapfrog point (position, gradient, logp, energy error)
    # into a fixed [2^maxdepth] buffer per chain for flow training (the
    # reference's use_orbit_for_training, external_adapt_strategy.rs:93-128)
    collect_orbit: bool = False


# DivergenceInfo.reason codes (the fixed-shape analog of the reference's
# divergence messages, src/dynamics/hamiltonian.rs:26-55).
DIV_REASON_NONE = 0
DIV_REASON_ENERGY = 1
DIV_REASON_NAN_LOGP = 2
DIV_REASON_NAN_GRAD = 3


class DivergenceInfo(NamedTuple):
    """Divergence forensics per chain (``nuts.py:91-109``).  The momenta are
    kept only with ``NutsOptions.store_divergences`` (shape [C, 0]
    otherwise)."""

    start_location: torch.Tensor  # [C, d]
    start_gradient: torch.Tensor  # [C, d]
    start_momentum: torch.Tensor  # [C, d] ([C, 0] unless store_divergences)
    end_location: torch.Tensor    # [C, d]
    end_momentum: torch.Tensor    # [C, d] ([C, 0] unless store_divergences)
    energy_error: torch.Tensor    # [C]
    start_idx: torch.Tensor       # [C] int32
    end_idx: torch.Tensor         # [C] int32
    reason: torch.Tensor          # [C] int32 (DIV_REASON_*)


class NutsInfo(NamedTuple):
    """Per-draw diagnostics, one entry per chain (``nuts.py:112-140``)."""

    depth: torch.Tensor             # [C] int32
    reached_maxdepth: torch.Tensor  # [C] bool
    diverging: torch.Tensor         # [C] bool
    turning: torch.Tensor           # [C] bool
    n_steps: torch.Tensor           # [C] int32 leapfrogs (incl. divergent)
    sum_accept: torch.Tensor        # [C] sum of per-leapfrog accept probs
    sum_accept_sym: torch.Tensor    # [C] sum of symmetric accept probs
    max_energy_error: torch.Tensor  # [C] signed, -inf after a divergence
    energy: torch.Tensor            # [C] energy of the selected draw
    energy_error: torch.Tensor      # [C] draw energy - initial energy
    initial_energy: torch.Tensor    # [C]
    idx_in_trajectory: torch.Tensor  # [C] int32 of the selected draw
    is_good_for_adapt: torch.Tensor  # [C] bool (DrawGradCollector.is_good)
    divergence: DivergenceInfo
    # orbit buffers (NutsOptions.collect_orbit; one row otherwise): a row
    # per leapfrog in creation order; rows >= min(n_steps, cap) are invalid
    orbit_q: Optional[torch.Tensor] = None     # [C, cap, d]
    orbit_g: Optional[torch.Tensor] = None     # [C, cap, d]
    orbit_logp: Optional[torch.Tensor] = None  # [C, cap]
    orbit_err: Optional[torch.Tensor] = None   # [C, cap] energy - initial


class TreeCarry(NamedTuple):
    """The tree state of all chains between two iterations."""

    step_size: torch.Tensor
    initial_energy: torch.Tensor
    mindepth_dyn: torch.Tensor   # [C] int32
    maxdepth_dyn: torch.Tensor   # [C] int32
    depth: torch.Tensor          # [C] int32 current main-tree depth
    leaf: torch.Tensor           # [C] int32 leaf index within the subtree
    direction: torch.Tensor      # [C] int32 +-1
    check_this: torch.Tensor     # [C] bool: turning checks of this doubling
    p_minus: Point
    p_plus: Point
    p_edge: Point                # moving end of the current subtree
    draw_main: Point
    logw_main: torch.Tensor
    draw_sub: Point
    logw_sub: torch.Tensor
    left_z: torch.Tensor         # [C, D + 1, d]
    left_v: torch.Tensor
    mid_z: torch.Tensor
    mid_v: torch.Tensor
    b_left: torch.Tensor         # [C, D + 1] cached z.v per left-stack row
    b_mid: torch.Tensor          # [C, D + 1] cached z.v per mid-stack row
    done: torch.Tensor
    diverging: torch.Tensor
    turning: torch.Tensor
    extra_mode: torch.Tensor
    extras_left: torch.Tensor
    n_steps: torch.Tensor
    sum_accept: torch.Tensor
    sum_accept_sym: torch.Tensor
    max_energy_error: torch.Tensor
    div_info: DivergenceInfo
    orbit_q: torch.Tensor
    orbit_g: torch.Tensor
    orbit_logp: torch.Tensor
    orbit_err: torch.Tensor


def _orbit_cap(opts: NutsOptions) -> int:
    return (1 << opts.maxdepth) if opts.collect_orbit else 1


def _sum(x):
    return torch.sum(x, -1)


def _empty_div_info(C, dim, dtype, device, store_momentum):
    nan = torch.full((C, dim), float("nan"), dtype=dtype, device=device)
    mom = nan if store_momentum else torch.zeros(C, 0, dtype=dtype,
                                                 device=device)
    zi = torch.zeros(C, dtype=torch.int32, device=device)
    return DivergenceInfo(
        start_location=nan, start_gradient=nan, start_momentum=mom,
        end_location=nan, end_momentum=mom,
        energy_error=torch.full((C,), float("nan"), dtype=dtype,
                                device=device),
        start_idx=zi, end_idx=zi, reason=zi)


def _dyn_depths(opts: NutsOptions, step_size):
    """target_integration_time -> per-chain (mindepth, maxdepth);
    nuts.rs:300-320."""
    D = opts.maxdepth
    lo = torch.full(step_size.shape, opts.mindepth, dtype=torch.int32,
                    device=step_size.device)
    if opts.target_integration_time is None:
        return lo, torch.full_like(lo, D)
    max_steps = torch.ceil(opts.target_integration_time / step_size)
    log2_steps = torch.log2(torch.clamp(max_steps, min=1.0))
    mindepth_dyn = torch.maximum(torch.floor(log2_steps).to(torch.int32), lo)
    maxdepth_dyn = torch.clamp(
        torch.maximum(torch.ceil(log2_steps).to(torch.int32), mindepth_dyn),
        max=D)
    return mindepth_dyn, maxdepth_dyn


def _init_tree_carry(pt0: Point, step_size, opts: NutsOptions,
                     rand_dir) -> TreeCarry:
    """Fresh per-draw tree state from an initialized (momentum-refreshed)
    point; ``rand_dir`` [C] are uniforms."""
    D = opts.maxdepth
    C, dim = pt0.q.shape
    dtype, dev = pt0.q.dtype, pt0.q.device
    mindepth_dyn, maxdepth_dyn = _dyn_depths(opts, step_size)
    zi = torch.zeros(C, dtype=torch.int32, device=dev)
    zf = torch.zeros(C, dtype=dtype, device=dev)
    no = torch.zeros(C, dtype=torch.bool, device=dev)
    one = torch.ones_like(zi)
    return TreeCarry(
        step_size=step_size, initial_energy=pt0.energy,
        mindepth_dyn=mindepth_dyn, maxdepth_dyn=maxdepth_dyn,
        depth=zi, leaf=zi, direction=torch.where(rand_dir < 0.5, one, -one),
        check_this=(mindepth_dyn <= 0) & bool(opts.check_turning),
        p_minus=pt0, p_plus=pt0, p_edge=pt0,
        draw_main=pt0, logw_main=zf,
        draw_sub=pt0, logw_sub=torch.full_like(zf, float("-inf")),
        left_z=torch.zeros(C, D + 1, dim, dtype=dtype, device=dev),
        left_v=torch.zeros(C, D + 1, dim, dtype=dtype, device=dev),
        mid_z=torch.zeros(C, D + 1, dim, dtype=dtype, device=dev),
        mid_v=torch.zeros(C, D + 1, dim, dtype=dtype, device=dev),
        b_left=torch.zeros(C, D + 1, dtype=dtype, device=dev),
        b_mid=torch.zeros(C, D + 1, dtype=dtype, device=dev),
        done=no, diverging=no, turning=no, extra_mode=no,
        extras_left=torch.full_like(zi, opts.extra_doublings),
        n_steps=zi, sum_accept=zf, sum_accept_sym=zf, max_energy_error=zf,
        div_info=_empty_div_info(C, dim, dtype, dev, opts.store_divergences),
        orbit_q=torch.zeros(C, _orbit_cap(opts), dim, dtype=dtype, device=dev),
        orbit_g=torch.zeros(C, _orbit_cap(opts), dim, dtype=dtype, device=dev),
        orbit_logp=torch.zeros(C, _orbit_cap(opts), dtype=dtype, device=dev),
        orbit_err=torch.zeros(C, _orbit_cap(opts), dtype=dtype, device=dev),
    )


def _tree_finished(c: TreeCarry):
    return c.done | (~c.extra_mode & (c.depth >= c.maxdepth_dyn))


def _uturn_checks(leaf, tzn, depth, dirf, z1, v2, d1, lz, lv, bl, mz, mv,
                  bm, p_minus, p_plus, D):
    """(turning_int, turning_top) of the new leaf (``nuts.py:361-429``): the
    spans at levels 1..tz(leaf + 1) that the leaf completes, and the merge
    checks against the trajectory's ends.  Within a doubling every state was
    created along ``direction``, so for states (old, new) in creation order
    the sorted criterion reduces to
    ``(dir (z_new - z_old) . v_old < 0) | (dir (z_new - z_old) . v_new < 0)``.
    A completed span at level j < tz(leaf + 1) has its first leaf in left
    row j; the boundary level reads its row by index."""
    C = z1.shape[0]
    ar = torch.arange(C, device=z1.device)
    rows = torch.arange(D + 1, device=z1.device)[None, :]
    z1v = _sum(z1[:, None, :] * lv)
    zv2 = _sum(lz * v2[:, None, :])
    m1 = _sum(z1[:, None, :] * mv)
    m2 = _sum(mz * v2[:, None, :])
    zero = torch.zeros(C, 1, dtype=z1.dtype, device=z1.device)
    adj_bzav = torch.cat([zero, _sum(lz[:, :-1] * lv[:, 1:])], 1)
    adj_azbv = torch.cat([zero, _sum(lz[:, 1:] * lv[:, :-1])], 1)
    blm1 = torch.cat([zero, bl[:, :-1]], 1)
    dirb, d1b = dirf[:, None], d1[:, None]
    t1 = (dirb * (z1v - bl) < 0) | (dirb * (d1b - zv2) < 0)
    t2 = (dirb * (m1 - bm) < 0) | (dirb * (d1b - m2) < 0)
    t3 = (dirb * (adj_bzav - bl) < 0) | (dirb * (blm1 - adj_azbv) < 0)
    tj = t1 | ((rows >= 2) & (t2 | t3))
    turning = ((rows >= 1) & (rows < tzn[:, None]) & tj).any(1)

    s_a = leaf + 1 - (1 << tzn)
    ra = torch.clamp(tz(s_a, D), max=D).long()
    rt = tzn.long()
    rb = torch.clamp(tzn - 1, min=0).long()
    a_b = bl[ar, ra]
    t1d = ((dirf * (z1v[ar, ra] - a_b) < 0)
           | (dirf * (d1 - zv2[ar, ra]) < 0))
    t2d = ((dirf * (m1[ar, rt] - bm[ar, rt]) < 0)
           | (dirf * (d1 - m2[ar, rt]) < 0))
    t3d = ((dirf * (_sum(lz[ar, rb] * lv[ar, ra]) - a_b) < 0)
           | (dirf * (bl[ar, rb] - _sum(lz[ar, ra] * lv[ar, rb])) < 0))
    turning = turning | ((tzn >= 1) & t1d) | ((tzn >= 2) & (t2d | t3d))

    fwd = (dirf > 0)[:, None]
    far_z = torch.where(fwd, p_minus.z, p_plus.z)
    far_v = torch.where(fwd, p_minus.v, p_plus.v)
    near_z = torch.where(fwd, p_plus.z, p_minus.z)
    near_v = torch.where(fwd, p_plus.v, p_minus.v)
    far_zv = _sum(far_z * far_v)
    t_out = ((dirf * (_sum(z1 * far_v) - far_zv) < 0)
             | (dirf * (d1 - _sum(far_z * v2)) < 0))
    near_zv = _sum(near_z * near_v)
    t_nr = ((dirf * (_sum(z1 * near_v) - near_zv) < 0)
            | (dirf * (d1 - _sum(near_z * v2)) < 0))
    t_b0 = ((dirf * (_sum(lz[:, D] * far_v) - far_zv) < 0)
            | (dirf * (bl[:, D] - _sum(far_z * lv[:, D])) < 0))
    return turning, t_out | ((depth > 0) & (t_nr | t_b0))


def _tree_body(c: TreeCarry, active, rand3, transform, logp_grad_fn,
               opts: NutsOptions, ops=AFFINE_OPS) -> TreeCarry:
    """One leapfrog and all tree bookkeeping for the chains in ``active``
    (``nuts.py:265-490``); the others keep their state, since every mask
    that changes a field carries ``active``.  ``rand3`` are three [C]
    uniforms: leaf selection, merge acceptance, next direction."""
    D = opts.maxdepth
    dtype = c.p_edge.q.dtype
    e0 = c.initial_energy
    r_sel, r_acc, r_dir = (r.to(dtype) for r in rand3)

    res = leapfrog(c.p_edge, c.direction, c.step_size, transform,
                   logp_grad_fn, opts.kind, e0, opts.max_energy_error,
                   csum=_sum, ops=ops)
    new_pt = res.point
    diverged = res.diverging & active
    ok = active & ~diverged

    # --- acceptance statistics (dual_avg.rs:130-158) ---
    diff = e0 - new_pt.energy
    acc = torch.exp(torch.clamp(diff, max=0.0))
    acc_sym = 2.0 * acc / (1.0 + torch.exp(diff))
    zf = torch.zeros_like(acc)
    sum_accept = c.sum_accept + torch.where(ok, acc, zf)
    sum_accept_sym = c.sum_accept_sym + torch.where(ok, acc_sym, zf)
    larger = ok & (torch.abs(diff) > torch.abs(c.max_energy_error))
    max_err = torch.where(diverged, torch.full_like(diff, float("-inf")),
                          torch.where(larger, diff, c.max_energy_error))

    nan_logp = ~torch.isfinite(new_pt.logp)
    nan_grad = ~torch.isfinite(_sum(new_pt.zg))
    reason = torch.where(
        nan_logp, DIV_REASON_NAN_LOGP,
        torch.where(nan_grad, DIV_REASON_NAN_GRAD,
                    DIV_REASON_ENERGY)).to(torch.int32)
    store_mom = opts.store_divergences
    div_info = chains_where(diverged, DivergenceInfo(
        start_location=c.p_edge.q, start_gradient=c.p_edge.g,
        start_momentum=(c.p_edge.v if store_mom
                        else c.div_info.start_momentum),
        end_location=new_pt.q,
        end_momentum=new_pt.v if store_mom else c.div_info.end_momentum,
        energy_error=res.energy_error, start_idx=c.p_edge.idx,
        end_idx=new_pt.idx, reason=reason), c.div_info)

    # --- orbit collection (flow training): each active chain writes its
    # leapfrog's row
    orbit = (c.orbit_q, c.orbit_g, c.orbit_logp, c.orbit_err)
    if opts.collect_orbit:
        ca = active.nonzero()[:, 0]
        row = torch.clamp(c.n_steps[ca], max=_orbit_cap(opts) - 1).long()
        orbit = tuple(x.clone() for x in orbit)
        for buf, val in zip(orbit, (new_pt.q, new_pt.g, new_pt.logp,
                                    res.energy_error)):
            buf[ca, row] = val[ca].to(buf.dtype)

    # --- progressive multinomial within the subtree ---
    logw_leaf = -res.energy_error
    is_first = c.leaf == 0
    logw_sub = torch.where(is_first, logw_leaf,
                           logaddexp(c.logw_sub, logw_leaf))
    take_leaf = active & (is_first
                          | (torch.log(r_sel) < logw_leaf - logw_sub))
    logw_sub = torch.where(active, logw_sub, c.logw_sub)
    draw_sub = point_where(take_leaf, new_pt, c.draw_sub)

    # --- stack writes: each active chain writes its own rows ---
    rows = torch.arange(D + 1, device=active.device)[None, :]
    tz_next = tz(c.leaf + 1, D)
    row_left = torch.clamp(tz(c.leaf, D), max=D)
    row_mid = torch.clamp(tz_next + 1, max=D)
    at_l = active[:, None] & (rows == row_left[:, None])
    at_m = active[:, None] & (rows == row_mid[:, None])
    d1 = _sum(new_pt.z * new_pt.v)
    z_row, v_row = new_pt.z[:, None, :], new_pt.v[:, None, :]
    left_z = torch.where(at_l[:, :, None], z_row, c.left_z)
    left_v = torch.where(at_l[:, :, None], v_row, c.left_v)
    b_left = torch.where(at_l, d1[:, None], c.b_left)
    mid_z = torch.where(at_m[:, :, None], z_row, c.mid_z)
    mid_v = torch.where(at_m[:, :, None], v_row, c.mid_v)
    b_mid = torch.where(at_m, d1[:, None], c.b_mid)

    dir_f = c.direction.to(dtype)
    turning_int, turning_top = _uturn_checks(
        c.leaf, tz_next, c.depth, dir_f, new_pt.z, new_pt.v, d1, left_z,
        left_v, b_left, mid_z, mid_v, b_mid, c.p_minus, c.p_plus, D)
    checked = active & c.check_this
    turning_int = turning_int & checked
    turning_top = turning_top & checked

    subtree_complete = (c.leaf + 1) == (1 << c.depth)

    # --- biased progressive sampling at the top level (nuts.rs:191-202) ---
    take_sub = (logw_sub >= c.logw_main) | (
        torch.log(r_acc) < logw_sub - c.logw_main)
    do_merge = active & subtree_complete & ~diverged & ~turning_int
    draw_main = point_where(do_merge & take_sub, draw_sub, c.draw_main)
    logw_main = torch.where(do_merge, logaddexp(c.logw_main, logw_sub),
                            c.logw_main)
    p_plus = point_where(do_merge & (c.direction > 0), new_pt, c.p_plus)
    p_minus = point_where(do_merge & (c.direction < 0), new_pt, c.p_minus)

    depth = c.depth + do_merge.to(torch.int32)
    # Extra doublings (nuts.rs:350-370): after any top-level turning result
    # keep doubling with checks off for opts.extra_doublings rounds.
    turned_now = turning_int | (do_merge & turning_top)
    enter_extra = turned_now & (opts.extra_doublings > 0)
    extras_left = torch.where(c.extra_mode & do_merge, c.extras_left - 1,
                              c.extras_left)
    extra_mode = c.extra_mode | enter_extra
    done = (c.done | diverged | (turned_now & ~enter_extra)
            | (c.extra_mode & do_merge & (extras_left <= 0)))

    # --- next-iteration bookkeeping ---
    new_doubling = do_merge | turning_int
    leaf = torch.where(new_doubling, torch.zeros_like(c.leaf),
                       c.leaf + active.to(torch.int32))
    one = torch.ones_like(c.direction)
    new_dir = torch.where(r_dir < 0.5, one, -one)
    direction = torch.where(new_doubling, new_dir, c.direction)
    check_next = ((depth >= c.mindepth_dyn) & ~extra_mode
                  & bool(opts.check_turning))
    check_this = torch.where(new_doubling, check_next, c.check_this)
    edge_after_merge = point_where(new_dir > 0, p_plus, p_minus)
    p_edge = point_where(new_doubling, edge_after_merge,
                         point_where(active, new_pt, c.p_edge))

    return c._replace(
        depth=depth, leaf=leaf, direction=direction, check_this=check_this,
        p_minus=p_minus, p_plus=p_plus, p_edge=p_edge,
        draw_main=draw_main, logw_main=logw_main,
        draw_sub=draw_sub, logw_sub=logw_sub,
        left_z=left_z, left_v=left_v, mid_z=mid_z, mid_v=mid_v,
        b_left=b_left, b_mid=b_mid,
        done=done, diverging=c.diverging | diverged,
        turning=c.turning | turned_now,
        extra_mode=extra_mode, extras_left=extras_left,
        n_steps=c.n_steps + active.to(torch.int32), sum_accept=sum_accept,
        sum_accept_sym=sum_accept_sym, max_energy_error=max_err,
        div_info=div_info, orbit_q=orbit[0], orbit_g=orbit[1],
        orbit_logp=orbit[2], orbit_err=orbit[3])


def _extract_info(final: TreeCarry):
    draw = final.draw_main
    info = NutsInfo(
        depth=final.depth,
        reached_maxdepth=~final.done & (final.depth >= final.maxdepth_dyn),
        diverging=final.diverging, turning=final.turning,
        n_steps=final.n_steps, sum_accept=final.sum_accept,
        sum_accept_sym=final.sum_accept_sym,
        max_energy_error=final.max_energy_error,
        energy=draw.energy,
        energy_error=draw.energy - final.initial_energy,
        initial_energy=final.initial_energy,
        idx_in_trajectory=draw.idx,
        # DrawGradCollector.is_good (transform/adapt/diagonal.rs:73-84)
        is_good_for_adapt=torch.where(final.diverging,
                                      torch.abs(draw.idx) > 4, draw.idx != 0),
        divergence=final.div_info, orbit_q=final.orbit_q,
        orbit_g=final.orbit_g, orbit_logp=final.orbit_logp,
        orbit_err=final.orbit_err)
    return draw, info


def tree_uniforms(seed: int, it: int, num_chains: int, device, n: int = 1):
    """The uniforms of the tree iterations ``it .. it + n - 1``: the three
    [C] sites (selection, acceptance, direction) of ``it``, or with ``n``
    > 1 a tensor [n, 3, C], drawn by one hash call."""
    its = torch.arange(it, it + n, dtype=torch.int64, device=device)
    salts = torch.tensor([SALT_SELECT, SALT_ACCEPT, SALT_DIRECTION],
                         dtype=torch.int64, device=device)
    idx = torch.arange(num_chains, dtype=torch.int64, device=device)
    u = uniform_from_bits(hash_bits(
        torch.tensor(int(seed) & 0xFFFFFFFF, device=device),
        its[:, None, None], salts[None, :, None], idx[None, None, :]))
    return tuple(u[0]) if n == 1 else u


def nuts_draw(seed: int, init_pt: Point, transform, step_size, logp_grad_fn,
              opts: NutsOptions, ops=AFFINE_OPS):
    """One NUTS draw of every chain from ``init_pt`` (``nuts::draw``, nuts-rs
    ``src/nuts.rs:281-388``): momentum refresh, repeated doubling until
    maxdepth, a U-turn or a divergence, and the collectors' bookkeeping.
    Returns ``(draw: Point, info: NutsInfo)``; see the module docstring for
    the random sites ``seed`` keys.  ``ops`` are the transform's operations
    (``transform/ops.py``)."""
    C, dim = init_pt.q.shape
    dtype, dev = init_pt.q.dtype, init_pt.q.device
    v0 = sample_momentum(seed, 0, *SALT_MOMENTUM, (C, dim), dtype, dev,
                         opts.kind)
    pt0 = initialize_trajectory(init_pt, transform, opts.kind, v0, ops)
    rand_dir = host_uniform(seed, 0, SALT_FIRST_DIRECTION, (C,), dev)
    carry = _init_tree_carry(pt0, step_size.to(dtype), opts, rand_dir)
    it = 1
    while True:
        active = ~_tree_finished(carry)
        if not bool(active.any()):
            break
        k = (it - 1) % _UNIFORM_ITERATIONS
        if k == 0:
            uniforms = tree_uniforms(seed, it, C, dev, _UNIFORM_ITERATIONS)
        carry = _tree_body(carry, active, uniforms[k], transform,
                           logp_grad_fn, opts, ops)
        it += 1
    return _extract_info(carry)
