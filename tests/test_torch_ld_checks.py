"""The merged leapfrog of the dim-on-lanes kernels K1-ld and K2-ld
(``csrc/nuts_tree_ld.cuh::ld_leap_merged``), on the CPU: which stack rows its
one pass reads for the U-turn checks, the order of its wide reduction
(``csrc/block_sum.cuh::WideReducer``) and the rule that picks its form.

Today's leapfrog (``ld_leapfrog`` without MERGED) runs its pass, a
reduction, then one pass and one reduction a U-turn level, reading the
checkpoint stacks after the pass wrote its rows.  The merged pass loads the
rows of the checks before its own stores.  The models below repeat both
index computations of the CUDA source line by line; for every leaf < 2^D
and D <= 10 the merged pass must form the same dots of the same rows,
grouped into the same tests in the same order, and load early no row that
the pass writes (row D at leaf 0, its one such row, takes the pass's own z1
and v2).  A thread reads and writes only its own coordinates, so the models
carry one coordinate.  The kernels' bits against their plain versions are
held on the card (``tests/test_torch_kernels_cuda.py``).
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from nuts_rs_tpu_torch.kernels import _build
from nuts_rs_tpu_torch.ops import tsum

torch.set_num_threads(1)

CSRC = Path(_build.__file__).resolve().parents[1] / "csrc"
LIMIT = 232448  # a block's opt-in shared memory on sm_90


def tz(x, cap):
    """rng.cuh::tz: trailing zeros below cap; cap for 0, 0 without a bit."""
    if x == 0:
        return cap
    b = (x & -x).bit_length() - 1
    return b if b < cap else 0


def _written(leaf, D):
    """The stack rows the leapfrog's pass writes: lz / lv row row_l, mz / mv
    row row_m, with the new point's z1 and v2."""
    tzn = tz(leaf + 1, D)
    row_l, row_m = min(tz(leaf, D), D), min(tzn + 1, D)
    return {("lz", row_l): "z1", ("lv", row_l): "v2",
            ("mz", row_m): "z1", ("mv", row_m): "v2"}


def _after(written):
    """A row read after the pass's stores: the new value where it wrote."""
    return lambda stack, row: written.get((stack, row), ("old", stack, row))


def _level_dots(val, lev):
    dots = [("z1", val("lv", lev)), (val("lz", lev), "v2")]
    if lev >= 2:
        dots += [("z1", val("mv", lev)), (val("mz", lev), "v2"),
                 (val("lz", lev - 1), val("lv", lev)),
                 (val("lz", lev), val("lv", lev - 1))]
    return dots


def todays_checks(leaf, D, depth):
    """ld_leapfrog today: the dots of every test that reads a stack row, in
    the order the tests run (the top level's b0 test, the static levels
    1 <= lev < tzn, the boundary level), every row read after the pass."""
    tzn = tz(leaf + 1, D)
    val = _after(_written(leaf, D))
    tests = []
    if depth > 0:
        tests.append(("top b0", [(val("lz", D), "far_v"),
                                 ("far_z", val("lv", D))]))
    for lev in range(1, tzn):
        tests.append((f"level {lev}", _level_dots(val, lev)))
    if tzn >= 1:
        ra = min(tz(leaf + 1 - (1 << tzn), D), D)
        dots = [("z1", val("lv", ra)), (val("lz", ra), "v2")]
        if tzn >= 2:
            rb = tzn - 1
            dots += [("z1", val("mv", tzn)), (val("mz", tzn), "v2"),
                     (val("lz", rb), val("lv", ra)),
                     (val("lz", ra), val("lv", rb))]
        tests.append(("boundary", dots))
    return tests


def merged_checks(leaf, D, depth):
    """ld_leap_merged: (the tests' dots in the order they run, the rows
    loaded before the pass's stores, the number of sums of its reduction).
    Its rows[] hold row D (b0), ra, 1, mz / mv tzn and rb; the levels
    2 .. tzn - 1 (ld_deep_levels) read after the pass."""
    tzn = tz(leaf + 1, D)
    NL = min(tzn, 3)
    written = _written(leaf, D)
    read_b0 = depth > 0 and leaf != 0
    ra = min(tz(leaf + 1 - (1 << tzn), D), D) if NL >= 1 else 0
    rb = tzn - 1 if NL == 3 else 1
    rows = [("lz", D), ("lv", D)]
    if NL >= 1:
        rows += [("lz", ra), ("lv", ra)]
    if NL >= 2:
        rows += [("lz", 1), ("lv", 1), ("mz", tzn), ("mv", tzn)]
    if NL == 3:
        rows += [("lz", rb), ("lv", rb)]
    early = rows[2:] + (rows[:2] if read_b0 else [])
    g = [("old", *r) for r in rows]  # loaded before the pass's stores
    tests = []
    if depth > 0:
        bz = g[0] if read_b0 else "z1"
        bv = g[1] if read_b0 else "v2"
        tests.append(("top b0", [(bz, "far_v"), ("far_z", bv)]))
    if NL >= 2:
        tests.append(("level 1", [("z1", g[5]), (g[4], "v2")]))
    if NL == 3:
        val = _after(written)
        for lev in range(2, tzn):
            tests.append((f"level {lev}", _level_dots(val, lev)))
    if NL == 1:
        tests.append(("boundary", [("z1", g[3]), (g[2], "v2")]))
    if NL >= 2:
        lzb, lvb = (g[-2], g[-1]) if NL == 3 else (g[4], g[5])
        tests.append(("boundary", [("z1", g[3]), (g[2], "v2"),
                                   ("z1", g[7]), (g[6], "v2"),
                                   (lzb, g[3]), (g[2], lvb)]))
    n_sums = 11 + (2 if NL == 1 else 8 if NL >= 2 else 0)
    return tests, early, n_sums


@pytest.mark.parametrize("D", range(1, 11))
def test_merged_pass_reads_todays_rows(D):
    """Every leaf < 2^D, at depth 0 and above: the merged pass forms
    today's dots of today's row values, and loads early no row it writes."""
    for leaf in range(2 ** D):
        for depth in (0, 1, D - 1):
            want = todays_checks(leaf, D, depth)
            got, early, n_sums = merged_checks(leaf, D, depth)
            assert got == want, (leaf, depth)
            assert not set(early) & set(_written(leaf, D)), (leaf, depth)
            assert n_sums <= 32


def test_one_reduction_for_seven_leaves_in_eight():
    """tzn <= 2, the leaves whose checks all go into the leapfrog's one
    reduction, are 7 in 8 of the leaves; the path's depth-4 trees (15
    leapfrogs a draw: subtrees of 1, 2, 4 and 8 leaves) take 16 reductions
    a draw for today's 26."""
    D = 10
    leaves = range(2 ** (D - 1))
    share = np.mean([tz(leaf + 1, D) <= 2 for leaf in leaves])
    assert share == 7 / 8
    today = merged = 0
    for depth in range(4):
        for leaf in range(2 ** depth):
            tzn = tz(leaf + 1, D)
            today += 1 + tzn
            merged += 1 + (tzn >= 3)
    assert (today, merged) == (26, 16)


def _warp_sums(v):
    """block_sum.cuh::warp_sums on [32 lanes, M] values: the first log2(M)
    halvings keep the half a lane's side owns and add the partner's other
    half, the rest are plain; (each lane's value, its index)."""
    lane = np.arange(32)
    M = v.shape[1]
    S = M.bit_length() - 1
    v = v.copy()
    o, h = 16, M // 2
    for _ in range(S):
        upper = (lane & o) != 0
        new = v.copy()
        for i in range(h):
            send = np.where(upper, v[:, i], v[:, i + h])
            keep = np.where(upper, v[:, i + h], v[:, i])
            new[:, i] = keep + send[lane ^ o]
        v = new
        o, h = o // 2, h // 2
    x = v[:, 0]
    for s in range(S, 5):
        x = x + x[lane ^ (16 >> s)]
    return x, lane >> (5 - S)


def _wide_sum(x):
    """WideReducer::sum on [N, d] terms over 256 threads: thread t adds
    coordinates t + 256 i in ascending i (0.0 past d), warp_sums<M> with the
    values past N at 0.0, the lane of each value writes its warp sum to
    [warp][value], lane k halves value k's 8 warp sums as halve_warps does;
    the N sums."""
    N, d = x.shape
    M = 1 << (N - 1).bit_length()
    n = -(-d // 256)
    pad = np.zeros((M, n * 256), dtype=np.float32)
    pad[:N, :d] = x
    t = pad.reshape(M, n, 256)
    p = t[:, 0]
    for i in range(1, n):
        p = p + t[:, i]
    buf = np.full((8, 32), np.nan, dtype=np.float32)
    shift = 5 - (M.bit_length() - 1)
    for w in range(8):
        val, index = _warp_sums(p[:, 32 * w:32 * (w + 1)].T)
        for lane in range(32):
            if lane % (1 << shift) == 0 and index[lane] < N:
                buf[w, index[lane]] = val[lane]
    out = np.empty(N, dtype=np.float32)
    for k in range(N):
        q = buf[:, k].copy()
        for h in (4, 2, 1):
            q[:h] = q[:h] + q[h:2 * h]
        out[k] = q[0]
    return out


@pytest.mark.parametrize("n_sums,d", [(11, 1000), (13, 1000), (19, 1000),
                                      (19, 257), (30, 2757), (13, 3)])
def test_wide_reduction_is_tsums_bits(n_sums, d):
    """The wide reduction's N sums equal ``ops.tsum`` of each value bit for
    bit (the plain versions' order), on terms of mixed magnitudes and
    signs: the same pairs in the same tree as Reducer::sum."""
    rng = np.random.default_rng(n_sums * d)
    x = (rng.normal(size=(n_sums, d))
         * np.exp(rng.uniform(-8, 8, size=(n_sums, d)))).astype(np.float32)
    want = tsum(torch.from_numpy(x)).numpy()
    assert np.array_equal(_wide_sum(x), want)


@pytest.mark.parametrize("kind", ["posterior", "warmup"])
def test_form_rule_fits_every_served_dim(kind):
    """Every d the ld kernels served before (1 .. ld_max_dim(D)) gets a form
    whose shared memory fits a block; ld_max_dim(10) stays 2757."""
    assert _build.ld_max_dim(10) == 2757
    for D in range(1, 11):
        for d in range(1, _build.ld_max_dim(D) + 1):
            assert _build.ld_smem_bytes(kind, d, D) <= LIMIT, (d, D)


def test_form_rule_at_its_boundary():
    """The merged form takes the path's d = 1000 in both kernels and every d
    of the warmup; today's form serves the posterior's d = 2733..2757 at
    maxdepth 10, where the wide scratch (2048 bytes) does not fit."""
    wide = 4 * _build.LD_WIDE_FLOATS
    assert wide == 2048
    for kind in ("posterior", "warmup"):
        assert _build.ld_form(kind, 1000, 10) == "merged"
        assert (_build.ld_smem_bytes(kind, 1000, 10)
                == _build._ld_layout_bytes(kind, 1000, 10, False) + wide)
    assert _build.ld_form("posterior", 2732, 10) == "merged"
    for d in (2733, 2757):
        assert _build.ld_form("posterior", d, 10) == "today"
        assert _build.ld_form("warmup", d, 10) == "merged"
    assert (_build.ld_smem_bytes("posterior", 2757, 10)
            == 4 * (21 * 2757 + 22 + 176 + 16))


def test_constants_match_the_sources():
    """The wide scratch and the opt-in limit the C rule uses are
    _build's."""
    block_sum = (CSRC / "block_sum.cuh").read_text()
    tree = (CSRC / "nuts_tree_ld.cuh").read_text()
    wide = int(re.search(r"constexpr int LD_WIDE = (\d+);", block_sum)[1])
    assert _build.LD_WIDE_FLOATS == 2 * _build.LD_WARPS * wide
    limit = int(re.search(r"LD_SMEM_OPT_IN = (\d+);", tree)[1])
    assert limit == _build.SMEM_OPT_IN_BYTES == LIMIT
