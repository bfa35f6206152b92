"""K3 and K4 with a chain's coordinates on a group of T lanes
(``csrc/mclmc_step.cuh``): the rule that chooses T, the order of the
lanes' sums, and the card tests' inputs, on the CPU.

Coordinate j of a chain lies on lane j mod T of its group, in slot j / T.
A sum over d gathers the d terms by shuffles within the group and every
lane adds them in coordinate order, one after another.  The numpy
emulation here repeats that gather lane by lane and must give the bits of
the one-thread sum (``lanes.cuh::ordered_sum``) and of ``ops.dsum``, which the
plain versions take; the kernels' own bits are held against the plain
versions on the card (``tests/test_torch_kernels_cuda.py``, whose cases'
halvings and give-ups are checked here on the plain versions first).
"""

import numpy as np
import pytest
import torch
from test_torch_kernels_cuda import (
    MCLMC_LANE_CASES,
    mclmc_lane_inputs,
    require_mclmc_expect,
)

from nuts_rs_tpu_torch.kernels import _build
from nuts_rs_tpu_torch.kernels import mclmc_fused as mf
from nuts_rs_tpu_torch.ops import dsum

torch.set_num_threads(1)


@pytest.mark.parametrize("d,B,T", [
    (3, 1, 4), (3, 128, 4), (4, 32, 4), (4, 128, 4), (6, 1, 8), (6, 32, 8),
    (6, 128, 8), (10, 1, 16), (10, 32, 16), (10, 64, 16), (10, 65, 8),
    (10, 128, 8)])
def test_lane_rule_gives_its_documented_cases(d, B, T):
    assert _build.mclmc_lanes(d, B) == T


def test_lane_rule_fits_a_block_with_one_coordinate_a_lane():
    """Every d of the instantiated sizes at every block of 1 .. 128 chains:
    4, 8 or 16 lanes, B * T <= 1024 threads, one coordinate a lane while
    the block has the threads (B <= 64), and no more lanes than the
    coordinates need."""
    for d in _build.DIMS:
        for B in range(1, _build.MAX_BLOCK + 1):
            T = _build.mclmc_lanes(d, B)
            assert T in (4, 8, 16) and B * T <= _build.MAX_THREADS
            assert T >= d or (B > 64 and T == 8)
            assert T == 4 or T // 2 < d


def test_lane_rule_follows_the_ablation_macro(monkeypatch):
    monkeypatch.setattr(_build, "NVCC_DEFINES", ["NRT_MCLMC_LANES=4"])
    assert _build.mclmc_lanes(10, 32) == 4


def _gather_sum(terms, T):
    """The kernel's ordered_sum, lane by lane: lane l holds the terms of
    coordinates l + T i in slot i; for j = 0 .. d-1 every lane reads slot
    j // T of lane j % T (a shuffle of width T) and adds it to its running
    sum.  Returns each lane's sum."""
    d = terms.shape[-1]
    nc = -(-d // T)
    slots = np.zeros((T, nc) + terms.shape[:-1], dtype=np.float32)
    for j in range(d):
        slots[j % T, j // T] = terms[..., j]
    sums = []
    for _lane in range(T):
        s = None
        for j in range(d):
            t = slots[j % T, j // T]
            s = t if j == 0 else np.float32(s + t)
        sums.append(s)
    return sums


@pytest.mark.parametrize("d", _build.DIMS)
def test_lane_gather_gives_the_one_thread_sum_bit_for_bit(d):
    """Products on their owner lanes, then the ordered gather: on every
    lane, for every T the rule takes at d (and 1, 2, 32), the bits of the
    one-thread dot and of ops.dsum of the products."""
    rng = np.random.default_rng(d)
    a = rng.normal(size=(4096, d)).astype(np.float32) * np.float32(
        10.0) ** rng.integers(-3, 4, size=(4096, d)).astype(np.float32)
    b = rng.normal(size=(4096, d)).astype(np.float32)
    prod = a * b
    one = prod[:, 0].copy()
    for j in range(1, d):
        one = one + prod[:, j]
    want = dsum(torch.from_numpy(a) * torch.from_numpy(b)).numpy()
    assert np.array_equal(one.view(np.uint32), want.view(np.uint32))
    lanes = {_build.mclmc_lanes(d, B) for B in (1, 64, 65, 128)}
    for T in sorted(lanes | {1, 2, 32}):
        for lane_sum in _gather_sum(prod, T):
            assert np.array_equal(lane_sum.view(np.uint32),
                                  want.view(np.uint32)), T


@pytest.mark.parametrize("dim,micro,dynamic,C,B,max_err,expect",
                         MCLMC_LANE_CASES)
def test_card_cases_halve_and_give_up_on_the_plain_versions(
        dim, micro, dynamic, C, B, max_err, expect):
    """The inputs of the card test of K3 / K4 show, on the plain versions
    here, the halvings or give-ups that test asserts before it compares."""
    dev = torch.device("cpu")
    model, mopts, post, warm = mclmc_lane_inputs(dim, micro, dynamic, C,
                                                 max_err, dev)
    out = mf.mclmc_fused_run(3, *post, 8, model, mopts, 0.1, B)
    require_mclmc_expect(out[5], expect, "K3")
    out = mf.mclmc_fused_warmup_run(5, *warm, B)
    require_mclmc_expect(out[9], expect, "K4")
