"""The mid-d kernels K1-args and K2-args serve G <= 8 chains a CUDA block,
one warp a chain (``csrc/nuts_tree_group.cuh``): the rule that chooses G,
and the order of their sums, on the CPU.

A chain's warp stands for ``ops.tsum``'s 256 virtual threads: lane l holds
the 8 slots l + 32 w, each slot adds its coordinates l + 32 w + 256 i in
ascending i, and the slots' partials are butterflied 8 (``slot_sum``) or 4
(``gr_sums``, even then odd virtual warps) at a time by ``warp_sums``, then
halved across lanes by shuffles.  The numpy emulations here repeat those
shuffles lane by lane and must give ``ops.tsum``'s bits, which the plain
versions take; the kernels' own bits are held against the plain versions
on the card (``tests/test_torch_kernels_cuda.py``).
"""

import numpy as np
import pytest
import torch

from nuts_rs_tpu_torch.chain import cl_max_dim
from nuts_rs_tpu_torch.kernels import _build
from nuts_rs_tpu_torch.kernels import nuts_fused as nf
from nuts_rs_tpu_torch.models import gaussian as tg
from nuts_rs_tpu_torch.models.hierarchical import radon
from nuts_rs_tpu_torch.ops import tsum

torch.set_num_threads(1)

LIMIT = 232448  # a block's opt-in shared memory on sm_90
_MODELS = {}


def _model(kind, d):
    key = (kind, d)
    if key not in _MODELS:
        _MODELS[key] = (tg.normal_logp(d) if kind == "none"
                        else tg.logistic_regression(1000, d, 0))
    return _MODELS[key]


def _check_rule(kind, d, D, model):
    G = _build.mid_group(kind, d, D, model)
    assert G in (1, 2, 4, 8), (kind, d, D, G)
    assert _build.mid_group_bytes(kind, d, D, model, G) <= LIMIT
    if G < 8:  # a smaller G only where the next larger does not fit
        assert _build.mid_group_bytes(kind, d, D, model, 2 * G) > LIMIT
    for B in (1, 2, 4, 8):
        if B <= G:
            assert _build.mid_group_for(kind, d, D, model, B) == G
            assert G % B == 0
        else:
            with pytest.raises(ValueError, match="multiple of the chain"):
                _build.mid_group_for(kind, d, D, model, B)
    return G


@pytest.mark.parametrize("maxdepth", range(1, 11))
def test_group_rule_at_every_mid_size(maxdepth):
    """For every d the mid kernels serve at this maxdepth, without data and
    for the regression with 1000 rows, and for radon: G chains fit a block's
    232,448 bytes, G is a multiple of every logical block B the wrapper
    accepts (it refuses a B above G), and G falls below 8, down to 1, only
    where twice as many chains do not fit."""
    seen = set()
    for kind in ("posterior", "warmup"):
        warm = kind == "warmup"
        for d in range(1, cl_max_dim(maxdepth, warm) + 1):
            model = _model("none", d)
            if nf.cl_kernel(model, d, maxdepth) == "mid":
                seen.add(_check_rule(kind, d, maxdepth, model))
        d = 1
        while True:
            model = _model("glm", d)
            if d > cl_max_dim(maxdepth, warm, model.data_bytes):
                break
            assert nf.cl_kernel(model, d, maxdepth) == "mid"
            seen.add(_check_rule(kind, d, maxdepth, model))
            d += 1
        r = radon()
        assert _check_rule(kind, r.dim, maxdepth, r) == 8
    assert 8 in seen
    if maxdepth <= 4:  # d up to 403: the posterior's largest take G = 4
        assert 4 in seen


@pytest.mark.parametrize("name,C,B,want", [
    ("glm", 256, 1, 8), ("glm", 64, 1, 8), ("radon", 1024, 1, 8),
    ("radon", 256, 1, 2), ("rank1", 256, 1, 2), ("rank1", 64, 1, 1),
    ("rank1", 64, 8, 8), ("rank1", 1056, 1, 8), ("rank1", 1057, 1, 8)])
def test_launch_group_packs_chains_only_for_one_wave(name, C, B, want):
    """A launch takes the rule's G for the regression's group form (one
    read of x serves every chain) and, for a functor without it, the fewest
    chains a block, a multiple of B, whose blocks fit 132 SMs in one wave,
    up to the rule's G."""
    model = {"glm": lambda: tg.logistic_regression(1000, 100, 0),
             "radon": radon,
             "rank1": lambda: tg.correlated_normal_rank1(100)}[name]()
    d = model.dim
    for kind in ("posterior", "warmup"):
        assert _build.mid_launch_group(kind, d, 10, model, C, B, 132) == want


def test_group_layout_bytes():
    """The block's bytes as csrc/nuts_tree_group.cuh lays them out: the
    regression's group scratch (qg [d][8], part [G][d][8], llp [G][8], a
    warp's [32][36] for the second product's butterflies, and rs [G][N]
    past 1024 rows), 16 floats of flags, 8 x 64 of the chains' scalars
    while it runs, G chain parts of 21
    (posterior) or 19 (warmup) vectors and the two cached-dot rows (and a
    team functor's scratch), each rounded up to 4 floats."""
    glm = tg.logistic_regression(1000, 100, 0)
    assert _build.mid_group_bytes("posterior", 100, 10, glm, 8) == 4 * (
        800 + 8 * 8 * 101 + 9216 + 16 + 512 + 8 * 2124)
    assert _build.mid_group_bytes("warmup", 100, 10, glm, 8) == 4 * (
        800 + 8 * 8 * 101 + 9216 + 16 + 512 + 8 * 1924)
    assert _build.mid_group("posterior", 100, 10, glm) == 8
    rows = tg.logistic_regression(1500, 37, 0)
    assert _build.mid_group_bytes("posterior", 37, 6, rows, 2) == 4 * (
        296 + 2 * 8 * 38 + 9216 + 2 * 1500 + 16 + 512 + 2 * 792)
    big = tg.normal_logp(366)  # the largest posterior d at maxdepth 2
    assert _build.mid_group_bytes("posterior", 366, 2, big, 4) == 4 * (
        16 + 4 * 7692)
    assert _build.mid_group("posterior", 366, 2, big) == 4
    r = radon()
    assert _build.mid_group_bytes("posterior", 89, 10, r, 8) == 4 * (
        16 + 8 * 1892)


def _warp_sums(v):
    """csrc/block_sum.cuh::warp_sums on [rows, 32 lanes, M] values: the
    first log2(M) halvings keep the half a lane's side owns and add the
    partner's other half, the rest are plain; returns (values held,
    index of the value each lane holds)."""
    v = v.copy()
    rows, lanes, M = v.shape
    lane = np.arange(32)
    index = np.zeros(32, dtype=int)
    o, h = 16, M // 2
    while h:
        upper = (lane & o) != 0
        partner = lane ^ o
        new = v.copy()
        for i in range(h):
            send = np.where(upper, v[:, :, i], v[:, :, i + h])
            keep = np.where(upper, v[:, :, i + h], v[:, :, i])
            new[:, :, i] = keep + send[:, partner]
        v = new
        index += np.where(upper, h, 0)
        h //= 2
        o //= 2
    x = v[:, :, 0]
    while o:
        x = x + x[:, lane ^ o]
        o //= 2
    return x, index


def _butterfly(x):
    """warp_sum on [rows, 32]: the plain butterfly (16, 8, 4, 2, 1)."""
    lane = np.arange(32)
    for o in (16, 8, 4, 2, 1):
        x = x + x[:, lane ^ o]
    return x


def _slot_partials(x):
    """[rows, 32 lanes, 8 slots]: slot w of lane l adds coordinates
    l + 32 w + 256 i in ascending i (0.0 where there is none)."""
    rows, d = x.shape
    n = -(-d // 256)
    pad = np.zeros((rows, n * 256), dtype=np.float32)
    pad[:, :d] = x
    t = pad.reshape(rows, n, 8, 32)  # [round, slot w, lane]
    s = t[:, 0]
    for i in range(1, n):
        s = s + t[:, i]
    return np.transpose(s, (0, 2, 1))


def _slot_sum(x):
    """slot_sum: warp_sums over the 8 slots, then the lanes halve the 8
    virtual warps' sums by shuffles 16, 8, 4."""
    v, index = _warp_sums(_slot_partials(x))
    assert np.array_equal(index, (np.arange(32) >> 2) & 7)
    lane = np.arange(32)
    for o in (16, 8, 4):
        v = v + v[:, lane ^ o]
    return v


def _gr_sums(x):
    """gr_sums: the even virtual warps' slots, then the odd ones, 4 at a
    time by warp_sums, each half halved by shuffles 16, 8, then added."""
    p = _slot_partials(x)
    lane = np.arange(32)
    out = None
    for h in (0, 1):
        v, _ = _warp_sums(p[:, :, [h, 2 + h, 4 + h, 6 + h]])
        for o in (16, 8):
            v = v + v[:, lane ^ o]
        out = v if out is None else out + v
    return out


@pytest.mark.parametrize("d", [11, 100, 212, 257, 403])
def test_lane_slot_sums_are_tsums_bits(d):
    """The lane-slot reductions of the group kernels equal ``ops.tsum``
    bit for bit in every lane, on terms of mixed magnitudes and signs; a
    sum in coordinate order differs, so the order is what is tested."""
    rng = np.random.default_rng(d)
    rows = 400
    x = (rng.normal(size=(rows, d))
         * np.exp(rng.uniform(-8, 8, size=(rows, d)))).astype(np.float32)
    want = tsum(torch.from_numpy(x)).numpy()
    for emulate in (_slot_sum, _gr_sums):
        got = emulate(x)
        assert np.array_equal(got, np.repeat(want[:, None], 32, 1))
    seq = x[:, 0].copy()
    for j in range(1, d):
        seq = seq + x[:, j]
    assert not np.array_equal(seq, want)


@pytest.mark.parametrize("M", [4, 8, 16])
def test_warp_sums_add_warp_sums_pairs(M):
    """warp_sums on M values a lane gives the lane the plain butterfly's
    sum (warp_sum) of value index(lane), the bits of M warp_sum calls: the
    regression's 8 chains' log-likelihoods and 2 columns x 8 chains of
    gradient partials take it."""
    rng = np.random.default_rng(M)
    v = (rng.normal(size=(50, 32, M))
         * np.exp(rng.uniform(-6, 6, size=(50, 32, M)))).astype(np.float32)
    got, index = _warp_sums(v)
    for lane in range(32):
        want = _butterfly(v[:, :, index[lane]])[:, lane]
        assert np.array_equal(got[:, lane], want)
