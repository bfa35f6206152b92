"""K1 and K2 with a chain's coordinates on a group of T lanes
(``csrc/nuts_tree.cuh``, ``csrc/lanes.cuh``): the rule that chooses T, the
U-turn checks' lane form, and the card tests' inputs, on the CPU.

Coordinate j of a chain lies on lane j mod T of its group, in slot j / T;
every sum over d is an ordered gather (``tests/test_torch_mclmc_lanes.py``
holds its bits against ``ops.dsum``).  The lane form of the U-turn checks
evaluates every dot of a level and ORs the booleans, where the one-thread
form stopped at the first turn; the numpy emulation here runs both on the
same stacks for every leaf of a tree and must give the same booleans.  The
kernels' own bits are held against the plain versions on the card
(``tests/test_torch_kernels_cuda.py``, whose cases' growing trees,
divergences and maxdepth are checked here on the plain versions first, as
are ``chip_smoke.py``'s K1 and K2 checks').
"""

import numpy as np
import pytest
import torch
from test_torch_kernels_cuda import (
    NUTS_LANE_CASES,
    nuts_lane_inputs,
    require_growing_trees,
    require_nuts_expect,
)
from test_torch_mclmc_lanes import _gather_sum

import chip_smoke
from nuts_rs_tpu_torch import DiagNutsSettings
from nuts_rs_tpu_torch.kernels import _build
from nuts_rs_tpu_torch.kernels import nuts_fused as nf
from nuts_rs_tpu_torch.models.gaussian import normal_logp

torch.set_num_threads(1)

CPU = torch.device("cpu")


@pytest.mark.parametrize("d,B", [(3, 1), (4, 32), (6, 65), (10, 1),
                                 (10, 32), (10, 64), (10, 128)])
def test_lane_rule_gives_its_documented_cases(d, B):
    assert _build.nuts_lanes(d, B) == 4


def test_lane_rule_fits_a_block():
    """Every instantiated d at every block of 1 .. 128 chains: a power of 2
    of lanes within a warp, B * T <= 512 threads (up to 128 registers a
    thread), and the C side instantiates it (nuts_lanes_taken: the rule's
    lanes at B = 1 and at MAX_BLOCK)."""
    for d, _ in _build.SIZES:
        for B in range(1, _build.MAX_BLOCK + 1):
            T = _build.nuts_lanes(d, B)
            assert T in (1, 2, 4, 8, 16, 32) and B * T <= 512
            assert T == _build.nuts_lanes(d, 1) == _build.nuts_lanes(
                d, _build.MAX_BLOCK)


def test_lane_rule_follows_the_ablation_macro(monkeypatch):
    monkeypatch.setattr(_build, "NVCC_DEFINES", ["NRT_NUTS_LANES=16"])
    assert _build.nuts_lanes(10, 32) == 16
    assert _build.mclmc_lanes(10, 32) == 16
    monkeypatch.setattr(_build, "NVCC_DEFINES", ["NRT_NUTS_LANES=1"])
    assert _build.nuts_lanes(10, 32) == 1
    assert _build.mclmc_lanes(10, 128) == 8


def _tz(x, cap):
    """rng.cuh::tz: trailing zeros below cap; cap for 0; 0 past cap."""
    if x == 0:
        return cap
    b = (x & -x).bit_length() - 1
    return b if b < cap else 0


def _turn2(dirf, a, b, c, d):
    return bool((dirf * (a - b) < 0) or (dirf * (c - d) < 0))


def _one_thread_internal(leaf, D, dirf, z1, v2, d1, lz, lv, bl, mz, mv, bm,
                         dot):
    """The one-thread form of the internal checks (short-circuit ORs)."""
    tzn = _tz(leaf + 1, D)
    turning = False
    for j in range(1, tzn):
        t = _turn2(dirf, dot(z1, lv[j]), bl[j], d1, dot(lz[j], v2))
        if j >= 2:
            t = t or _turn2(dirf, dot(z1, mv[j]), bm[j], d1,
                            dot(mz[j], v2))
            t = t or _turn2(dirf, dot(lz[j - 1], lv[j]), bl[j], bl[j - 1],
                            dot(lz[j], lv[j - 1]))
        turning = turning or t
    if tzn >= 1:
        ra = min(_tz(leaf + 1 - (1 << tzn), D), D)
        a_b = bl[ra]
        turning = turning or _turn2(dirf, dot(z1, lv[ra]), a_b, d1,
                                    dot(lz[ra], v2))
        if tzn >= 2:
            rb = tzn - 1
            turning = (turning
                       or _turn2(dirf, dot(z1, mv[tzn]), bm[tzn], d1,
                                 dot(mz[tzn], v2))
                       or _turn2(dirf, dot(lz[rb], lv[ra]), a_b, bl[rb],
                                 dot(lz[ra], lv[rb])))
    return turning


def _lane_internal(leaf, D, dirf, z1, v2, d1, lz, lv, bl, mz, mv, bm, dot):
    """nuts_tree.cuh::uturn_internal_lanes: levels k = 1 .. tzn, the last
    at the boundary row, every dot of a level evaluated, booleans ORed."""
    tzn = _tz(leaf + 1, D)
    r_bound = min(_tz(leaf + 1 - (1 << tzn), D), D)
    turning = False
    for k in range(1, tzn + 1):
        ra = r_bound if k == tzn else k
        rb = k - 1
        s1, s2 = dot(z1, lv[ra]), dot(lz[ra], v2)
        t = _turn2(dirf, s1, bl[ra], d1, s2)
        if k >= 2:
            s3, s4 = dot(z1, mv[k]), dot(mz[k], v2)
            s5, s6 = dot(lz[rb], lv[ra]), dot(lz[ra], lv[rb])
            t = (t | _turn2(dirf, s3, bm[k], d1, s4)
                 | _turn2(dirf, s5, bl[ra], bl[rb], s6))
        turning = turning | t
    return turning


def _one_thread_top(depth, dirf, z1, v2, d1, far_z, far_v, near_z, near_v,
                    b0_z, b0_v, b0_d, dot):
    far_zv = dot(far_z, far_v)
    if _turn2(dirf, dot(z1, far_v), far_zv, d1, dot(far_z, v2)):
        return True
    if depth <= 0:
        return False
    near_zv = dot(near_z, near_v)
    return (_turn2(dirf, dot(z1, near_v), near_zv, d1, dot(near_z, v2))
            or _turn2(dirf, dot(b0_z, far_v), far_zv, b0_d,
                      dot(far_z, b0_v)))


def _lane_top(depth, dirf, z1, v2, d1, far_z, far_v, near_z, near_v, b0_z,
              b0_v, b0_d, dot):
    """nuts_tree.cuh::uturn_top_lanes: 3 dots at depth 0, 8 above."""
    far_zv, s1, s2 = dot(far_z, far_v), dot(z1, far_v), dot(far_z, v2)
    if depth <= 0:
        return _turn2(dirf, s1, far_zv, d1, s2)
    near_zv, s3, s4 = dot(near_z, near_v), dot(z1, near_v), dot(near_z, v2)
    s5, s6 = dot(b0_z, far_v), dot(far_z, b0_v)
    return (_turn2(dirf, s1, far_zv, d1, s2)
            | _turn2(dirf, s3, near_zv, d1, s4)
            | _turn2(dirf, s5, far_zv, b0_d, s6))


def _one_thread_dot(a, b):
    s = np.float32(a[0] * b[0])
    for j in range(1, a.shape[0]):
        s = np.float32(s + np.float32(a[j] * b[j]))
    return s


@pytest.mark.parametrize("d,T", [(3, 4), (10, 16), (10, 8), (10, 4)])
def test_lane_uturn_checks_give_the_short_circuit_booleans(d, T):
    """For every leaf of a depth-10 tree, both directions and 20 random
    stacks (entries of both signs, so that some levels turn and some do
    not), the lane form with its dots by the lanes' ordered gather gives
    the one-thread form's booleans, internal and top, at every depth."""
    D = 10
    rng = np.random.default_rng(d * 100 + T)

    def lane_dot(a, b):
        sums = _gather_sum((a * b)[None, :], T)
        assert all(np.array_equal(s, sums[0]) for s in sums)
        return np.float32(sums[0][0])

    seen = set()
    for trial in range(20):
        f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
        lz, lv, mz, mv = f(D + 1, d), f(D + 1, d), f(D + 1, d), f(D + 1, d)
        bl, bm = f(D + 1), f(D + 1)
        z1, v2 = f(d), f(d)
        d1 = _one_thread_dot(z1, v2)
        ends = [f(d) for _ in range(4)]
        for dirf in (np.float32(1.0), np.float32(-1.0)):
            for leaf in range(0, 1 << D, 1 if trial < 2 else 37):
                want = _one_thread_internal(leaf, D, dirf, z1, v2, d1, lz, lv,
                                            bl, mz, mv, bm, _one_thread_dot)
                got = _lane_internal(leaf, D, dirf, z1, v2, d1, lz, lv, bl,
                                     mz, mv, bm, lane_dot)
                assert got == want, (leaf, dirf)
                seen.add(("int", want))
            for depth in range(D):
                args = (depth, dirf, z1, v2, d1, *ends, lz[D], lv[D], bl[D])
                want = _one_thread_top(*args, _one_thread_dot)
                assert _lane_top(*args, lane_dot) == want, (depth, dirf)
                seen.add(("top", want))
    assert seen == {("int", True), ("int", False), ("top", True),
                    ("top", False)}


@pytest.mark.parametrize(
    "dim,B,C,jitter,use_grad_based,max_err,step,draws,expect",
    NUTS_LANE_CASES)
def test_card_cases_grow_trees_on_the_plain_versions(
        dim, B, C, jitter, use_grad_based, max_err, step, draws, expect):
    """The inputs of the card test of K1 / K2 show, on the plain versions
    here, the growing trees, divergences or maxdepth that test asserts
    before it compares."""
    model, opts, post, warm = nuts_lane_inputs(dim, C, jitter, max_err, step,
                                               draws, CPU)
    out = nf.nuts_fused_run(3, *post, draws, model, opts, jitter, block=B)
    require_nuts_expect(out[4], expect, "K1")
    out = nf.nuts_fused_warmup_run(5, *warm, use_grad_based, block=B)
    require_nuts_expect(out[8], expect, "K2")


def test_chip_smoke_k1_k2_checks_grow_trees():
    """chip_smoke.py's K1 check (posterior_inputs, steps U(0.8, 1.0)) and
    K2 check (schedule rows 2..9 from the initial state) on their first 64
    chains, two logical blocks of the path's 32: some tree grows past depth
    0 and not every draw diverges, as the script asserts on the card."""
    model = normal_logp(chip_smoke.DIM, chip_smoke.MU)
    settings = DiagNutsSettings(num_chains=64, num_tune=chip_smoke.TUNE,
                                num_draws=chip_smoke.DRAWS,
                                seed=chip_smoke.SEED,
                                posterior_kernel="pallas")
    args = chip_smoke.posterior_inputs(model, CPU, chains=64)
    out = nf.nuts_fused_run(7, *args, chip_smoke.CHECK_K1_DRAWS, model,
                            settings.nuts_options(), 0.1)
    require_growing_trees(out[4], "K1 check")
    wargs = chip_smoke.warmup_setup(model, settings, CPU,
                                    *chip_smoke.CHECK_K2_SHORT_ROWS, 64)
    out = nf.nuts_fused_warmup_run(*wargs)
    require_growing_trees(out[8], "K2 check")
