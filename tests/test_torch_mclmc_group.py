"""The group form of the mid-d MCLMC kernels K3-args and K4-args serves the
regression's microcanonical draws, G <= 8 chains a CUDA block, one warp a
chain's trajectory (``csrc/mclmc_step_group.cuh``): the rule that chooses G,
the form table (``_build.MCLMC_MID_FORMS``), the wrapper on the CPU, and
the order of the warp's sums, on the CPU.

A chain's warp stands for ``ops.tsum``'s 256 virtual threads: lane l holds
the 8 slots l + 32 w, each slot adds its coordinates l + 32 w + 256 i in
ascending i, the 8 slots are butterflied at once (``warp_sums``) and the
slot sums halved across lanes by shuffles 16, 8 and 4 (``lane_sums``).  The
numpy emulation here repeats those shuffles lane by lane and must give
``ops.tsum``'s bits, which the plain versions take; the kernels' own bits
are held against the plain versions on the card
(``tests/test_torch_kernels_cuda.py``).
"""

import numpy as np
import pytest
import torch

from nuts_rs_tpu_torch.chain import mclmc_max_dim
from nuts_rs_tpu_torch.dynamics.hamiltonian import KineticKind
from nuts_rs_tpu_torch.kernels import _build
from nuts_rs_tpu_torch.kernels import mclmc_fused as mf
from nuts_rs_tpu_torch.kernels import nuts_fused as nf
from nuts_rs_tpu_torch.kernels.mclmc import MclmcOptions
from nuts_rs_tpu_torch.models import gaussian as tg
from nuts_rs_tpu_torch.models.hierarchical import radon
from nuts_rs_tpu_torch.models.stochastic_volatility import (
    stochastic_volatility,
)
from nuts_rs_tpu_torch.ops import tsum

torch.set_num_threads(1)

LIMIT = 232448  # a block's opt-in shared memory on sm_90
ROWS = 1000     # the regression's rows in the rule's sweep


def _round4(n):
    return -(-n // 4) * 4


def _layout_bytes(d, rows, G):
    """The block's bytes as csrc/mclmc_step_group.cuh lays them out: the
    regression's group scratch (qg [d][8], part [G][d][8], llp [G][8], a
    warp's [32][36] for the second product's butterflies, rs [G][N] past
    1024 rows) and 8 x 64 floats of parked scalars, then 16 floats of flags
    and G chain parts of 15 vectors, each rounded up to 4 floats."""
    group = _round4(8 * d + G * 8 * (d + 1) + 8 * 32 * 36
                    + (G * rows if rows > 1024 else 0)) + 8 * 64
    return 4 * (group + 16 + G * _round4(15 * d))


_MODELS = {}


def _glm(d, rows=ROWS):
    key = (d, rows)
    if key not in _MODELS:
        _MODELS[key] = tg.logistic_regression(rows, d, 0)
    return _MODELS[key]


def _check_rule(d, model, rows):
    G = _build.mclmc_mid_group(d, model)
    assert G in (1, 2, 4, 8), (d, G)
    for g in (1, 2, 4, 8):
        assert _build.mclmc_mid_group_bytes(d, model, g) == _layout_bytes(
            d, rows, g), (d, g)
    assert _build.mclmc_mid_group_bytes(d, model, G) <= LIMIT
    if G < 8:  # a smaller G only where the next larger does not fit
        assert _build.mclmc_mid_group_bytes(d, model, 2 * G) > LIMIT
    for B in (1, 2, 4, 8):
        if B <= G:
            assert _build.mclmc_mid_group_for(d, model, B) == G
        else:
            with pytest.raises(ValueError, match="multiple of the chain"):
                _build.mclmc_mid_group_for(d, model, B)
    return G


@pytest.mark.parametrize("kind", ["posterior", "warmup"])
def test_group_rule_at_every_mid_mclmc_size(kind):
    """For every d the mid MCLMC kernels serve with the regression's 1000
    rows (posterior up to 484, warmup up to 361 without data:
    ``chain.mclmc_max_dim``, less by the data's bytes): G is the byte
    formula's, G chains fit a block's 232,448 bytes, G is below 8 only where
    twice as many do not fit, and G is a multiple of every logical block B
    the launch accepts (a larger B raises).  Without data, at every d up to
    the limit, the table sends the functor to the 256-threads-a-chain form,
    whose one chain a block fits."""
    warm = kind == "warmup"
    top = mclmc_max_dim(warm)
    assert top == (361 if warm else 484)
    micro = MclmcOptions(kind=KineticKind.MICROCANONICAL)
    for d in range(2, top + 1):
        model = tg.normal_logp(d)
        if nf.cl_kernel(model, d) == "mid":
            assert _build.mclmc_mid_form(model, micro) == "block"
            assert _build.mclmc_mid_smem_bytes(d, model) <= LIMIT
    d, glm = 1, {}
    while True:
        model = _glm(d)
        if d > mclmc_max_dim(warm, model.data_bytes):
            break
        assert nf.cl_kernel(model, d) == "mid"
        assert _build.mclmc_mid_form(model, micro) == "group"
        glm[d] = _check_rule(d, model, ROWS)
        d += 1
    assert len(glm) > 300
    assert glm[100] == 8  # the data path's
    assert set(glm.values()) == {8, 4}  # 4 from d = 252 on


def test_group_rule_where_the_data_fill_the_block():
    """The regression's residuals go through shared memory past 1024 rows:
    at d = 37, 15000 rows leave room for 2 chains, 30000 for 1, and the
    largest data one chain's block holds is refused four rows later; a
    logical block that does not divide G raises a ValueError."""
    for rows, want in ((1500, 8), (15000, 2), (30000, 1)):
        model = tg.logistic_regression(rows, 37, 1)
        assert _check_rule(37, model, rows) == want
    with pytest.raises(ValueError, match="multiple of the chain block 2"):
        _build.mclmc_mid_group_for(
            37, tg.logistic_regression(30000, 37, 1), 2)
    # the most rows one chain's block holds at d = 37, then four more
    rows = (LIMIT // 4 - 16 - _round4(15 * 37) - 8 * 64
            - _round4(8 * 37 + 8 * 38 + 8 * 32 * 36))
    fits = tg.logistic_regression(rows, 37, 1)
    assert _build.mclmc_mid_group(37, fits) == 1
    over = tg.logistic_regression(rows + 4, 37, 1)
    assert _build.mclmc_mid_group(37, over) == 0
    with pytest.raises(NotImplementedError, match="must stream"):
        _build.mclmc_mid_group_for(37, over, 1)
    with pytest.raises(ValueError, match="no group form"):
        _build.mclmc_mid_group_bytes(100, tg.normal_logp(100), 8)


def test_form_table_covers_every_mid_mclmc_functor():
    """The table in ``_build`` names a form and the measured reason for every
    functor the mid MCLMC kernels take (every kernel hook but the streamed
    regression, which no MCLMC kernel serves) under both kinetic energies:
    the group form for the regression's microcanonical draws alone."""
    functors = set(_build.MODEL_IDS) - {"logistic_regression_stream"}
    assert set(_build.MCLMC_MID_FORMS) == {
        (f, k) for f in functors for k in ("microcanonical", "euclidean")}
    for key, (form, reason) in _build.MCLMC_MID_FORMS.items():
        want = ("group" if key == ("logistic_regression", "microcanonical")
                else "block")
        assert form == want, key
        assert isinstance(reason, str) and len(reason) > 20, key


def _zoo():
    return {"iid_normal": tg.normal_logp(12, 0.5),
            "logistic_regression": tg.logistic_regression(40, 5, 0),
            "correlated_normal_rank1": tg.correlated_normal_rank1(12),
            "radon": radon(),
            "stochastic_volatility": stochastic_volatility(T=10, seed=0),
            "funnel": tg.funnel(5),
            "correlated_normal": tg.correlated_normal(12)}


@pytest.mark.parametrize("kinetic", ["microcanonical", "euclidean"])
@pytest.mark.parametrize("name", sorted(set(_build.MODEL_IDS)
                                        - {"logistic_regression_stream"}))
def test_wrapper_takes_the_plain_version_on_the_cpu(name, kinetic):
    """Whatever form the table gives a functor and kinetic energy, CPU
    tensors run the plain version: no kernel launch is counted, and its
    results are the plain version's."""
    model = _zoo()[name]
    assert model.hook_parts()[0] == name
    mopts = MclmcOptions(kind=KineticKind[kinetic.upper()])
    assert _build.mclmc_mid_form(model, mopts) == \
        _build.MCLMC_MID_FORMS[(name, kinetic)][0]
    d = model.dim
    assert nf.cl_kernel(model, d) == "mid"
    C, K = 4, 2
    rng = np.random.default_rng(len(name))
    q = torch.tensor(0.1 * rng.normal(size=(C, d)), dtype=torch.float32)
    logp, g = model.logp_and_grad(q)
    v = rng.normal(size=(C, d))
    v = torch.tensor(v / np.linalg.norm(v, axis=1, keepdims=True),
                     dtype=torch.float32)
    stds = torch.full((C, d), 0.5)
    mean = torch.zeros(C, d)
    logdet = -torch.log(stds).sum(1)
    step = torch.full((C,), 0.3)
    args = (q, g, logp, v, stds, mean, logdet, step, step.clone())
    before = dict(mf.LAUNCHES)
    got = mf.mclmc_fused_run(3, *args, K, model, mopts, 0.1, block=2)
    want = mf.mclmc_fused_run_reference(3, *args, K, model, mopts, 0.1,
                                        block=2)
    assert mf.LAUNCHES == before
    for a, b in zip(got[:5], want[:5]):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def _warp_sums8(v):
    """csrc/block_sum.cuh::warp_sums on [rows, 32 lanes, 8] values: the
    first three halvings keep the half a lane's side owns and add the
    partner's other half, the last two are plain; returns the value each
    lane holds."""
    lane = np.arange(32)
    v = v.copy()
    o, h = 16, 4
    while h:
        upper = (lane & o) != 0
        new = v.copy()
        for i in range(h):
            send = np.where(upper, v[:, :, i], v[:, :, i + h])
            keep = np.where(upper, v[:, :, i + h], v[:, :, i])
            new[:, :, i] = keep + send[:, lane ^ o]
        v = new
        h //= 2
        o //= 2
    x = v[:, :, 0]
    for o in (2, 1):
        x = x + x[:, lane ^ o]
    return x


def _lane_sums(x):
    """lane_sums on [rows, d] terms: slot w of lane l adds coordinates
    l + 32 w + 256 i in ascending i (0.0 past d), warp_sums over the 8
    slots, then the shuffles 16, 8 and 4."""
    rows, d = x.shape
    n = -(-d // 256)
    pad = np.zeros((rows, n * 256), dtype=np.float32)
    pad[:, :d] = x
    t = pad.reshape(rows, n, 8, 32)  # [round, slot, lane]
    p = t[:, 0]
    for i in range(1, n):
        p = p + t[:, i]
    v = _warp_sums8(np.transpose(p, (0, 2, 1)))
    lane = np.arange(32)
    for o in (16, 8, 4):
        v = v + v[:, lane ^ o]
    return v


@pytest.mark.parametrize("d", [2, 5, 31, 100, 257, 361, 484])
def test_lane_sums_are_tsums_bits(d):
    """The warp's sums of the mid MCLMC kernels equal ``ops.tsum`` bit for
    bit in every lane, on terms of mixed magnitudes and signs, at one and
    two rounds of 256 coordinates; a sum in coordinate order differs (from
    d = 31 on), so the order is what is tested."""
    rng = np.random.default_rng(d)
    rows = 400
    x = (rng.normal(size=(rows, d))
         * np.exp(rng.uniform(-8, 8, size=(rows, d)))).astype(np.float32)
    want = tsum(torch.from_numpy(x)).numpy()
    got = _lane_sums(x)
    assert np.array_equal(got, np.repeat(want[:, None], 32, 1))
    if d >= 31:
        seq = x[:, 0].copy()
        for j in range(1, d):
            seq = seq + x[:, j]
        assert not np.array_equal(seq, want)


def test_sampler_refuses_data_the_group_form_cannot_hold():
    """On a CUDA device the sampler refuses, before any launch, a regression
    whose one chain fits the 256-threads-a-chain form but not the group form
    that its microcanonical draws take (50000 rows at d = 10: the residuals
    fill the block), and takes one that fits both."""
    from nuts_rs_tpu_torch.sampler import _model_reasons

    big = tg.logistic_regression(50000, 10, 0)
    assert _build.mclmc_mid_smem_bytes(10, big) <= LIMIT
    assert _build.mclmc_mid_group(10, big) == 0
    (reason,) = _model_reasons(big, 10, "cuda", False)
    assert "item 12" in reason
    assert str(_build.mclmc_mid_group_bytes(10, big, 1)) in reason
    assert _model_reasons(tg.logistic_regression(1000, 10, 0), 10, "cuda",
                          False) == []
