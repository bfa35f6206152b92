"""The block form of the mid-d MCLMC kernels K3-args and K4-args
(``csrc/mclmc_fused_mid_*.cu`` over ``csrc/mclmc_step_block.cuh``): the
orders of its new forms' sums, emulated on the CPU, and the rule that picks
a form (``_build.mclmc_block_form``).

A chain runs on T = 128 or 256 threads; thread t holds the slots
t + T s of ``ops.tsum``'s 256 (``block_sum.cuh::TeamReducer``): each slot
adds its coordinates t + T s + 256 i in ascending i, each slot's 32 lanes
are butterflied, a thread adds its slots' warp sums as tsum's halving pairs
them, and the warps' results are halved in turn.  In the pair form two CUDA
blocks of 128 threads share one chain and the regression's rows: block r
holds the slot warps r, r + 2, r + 4, r + 6, adds its four warp sums as
((w, w + 4), (w, w + 2)) pairs them and the two halves are added last
(``models.cuh::LogisticRegression::eval_pair``).  The numpy emulations here
repeat those steps lane by lane and must give the bits of ``ops.tsum`` and
of the plain regression functor that the plain versions take; the kernels'
own bits are held against the plain versions on the card
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
from nuts_rs_tpu_torch.ops import logaddexp, tsum

torch.set_num_threads(1)

LIMIT = 232448  # a block's opt-in shared memory on sm_90
EUCLID = MclmcOptions(kind=KineticKind.EUCLIDEAN)
MICRO = MclmcOptions(kind=KineticKind.MICROCANONICAL)
LANE = np.arange(32)


def _butterfly(x):
    """A warp's __shfl_xor_sync butterfly (16, 8, 4, 2, 1) on [..., 32]
    lane values; every lane ends with the warp's sum."""
    for o in (16, 8, 4, 2, 1):
        x = x + x[..., LANE ^ o]
    return x


def _slot_partials(x):
    """[rows, 256] per-slot partials of terms x [rows, d]: slot s adds
    coordinates s + 256 i in ascending i, 0.0 past d."""
    rows, d = x.shape
    n = -(-d // 256)
    pad = np.zeros((rows, n * 256), dtype=np.float32)
    pad[:, :d] = x
    t = pad.reshape(rows, n, 256)
    p = t[:, 0]
    for i in range(1, n):
        p = p + t[:, i]
    return p


def _team_sum(x, T):
    """TeamReducer<T>::sum on terms x [rows, d]: returns [rows, T] (the sum
    every thread gets)."""
    S, W = 256 // T, T // 32
    p = _slot_partials(x)  # slot t + T s = column
    # warp sums: slot warp w's 32 lanes
    ws = _butterfly(p.reshape(-1, 8, 32))[:, :, 0]  # [rows, 8 slot warps]
    out = np.empty((x.shape[0], W), dtype=np.float32)
    for u in range(W):
        v = [ws[:, u + W * s] for s in range(S)]  # thread's slots' warps
        h = S // 2
        while h:
            v = [v[s] + v[s + h] for s in range(h)]
            h //= 2
        out[:, u] = v[0]
    h = W // 2
    while h:
        out = out[:, :h] + out[:, h:2 * h]
        h //= 2
    return np.repeat(out[:, :1], T, 1)


def _pair_halves(warp_sums):
    """The pair form's sum from the 8 slot warps' sums [rows, 8]: block r's
    warps u hold slot warps r + 2 u; each block adds (u0 + u2) + (u1 + u3);
    block 0 adds A + B, block 1 B + A."""
    halves = []
    for r in (0, 1):
        pu = [warp_sums[:, r + 2 * u] for u in range(4)]
        halves.append((pu[0] + pu[2]) + (pu[1] + pu[3]))
    a, b = halves
    return a + b, b + a


def _terms(rows, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(rows, d))
            * np.exp(rng.uniform(-8, 8, size=(rows, d)))).astype(np.float32)


@pytest.mark.parametrize("T", [128, 256])
@pytest.mark.parametrize("d", [11, 100, 255, 256, 361, 400, 484])
def test_team_sums_are_tsums_bits(T, d):
    """TeamReducer's slots at T = 128 and 256 threads a chain give
    ``ops.tsum`` bit for bit in every thread, on terms of mixed magnitudes
    and signs, at one and two rounds of 256 coordinates; a sum in coordinate
    order differs (from d = 100 on), so the order is what is tested."""
    x = _terms(300, d, d + T)
    want = tsum(torch.from_numpy(x)).numpy()
    got = _team_sum(x, T)
    assert np.array_equal(got, np.repeat(want[:, None], T, 1))
    if d >= 100:
        seq = x[:, 0].copy()
        for j in range(1, d):
            seq = seq + x[:, j]
        assert not np.array_equal(seq, want)


@pytest.mark.parametrize("d", [11, 100, 255, 256, 361, 400, 484])
def test_pair_split_is_tsums_bits(d):
    """The pair form's split of the 8 slot warps, {0, 2, 4, 6} in one block
    and {1, 3, 5, 7} in the other, each block's halves in tsum's tree and
    the two halves added last, gives ``ops.tsum`` bit for bit in both
    blocks."""
    x = _terms(300, d, 7 * d)
    want = tsum(torch.from_numpy(x)).numpy()
    ws = _butterfly(_slot_partials(x).reshape(-1, 8, 32))[:, :, 0]
    a, b = _pair_halves(ws)
    assert np.array_equal(a, want) and np.array_equal(b, want)


def _pair_row(m, rank):
    """LogisticRegression::pair_row: the global row of block rank's local
    row m."""
    return 64 * (m >> 5) + 32 * rank + (m & 31)


def _pair_regression(q, xt, y):
    """eval_pair lane by lane on chains q [C, d] with data xt [d, N], y [N]:
    each block stages its rows (local row m holds row pair_row(m)), its
    thread (u, l) owns local rows 32 u + l + 128 i; logits in ascending j;
    the thread's row terms in ascending i; a warp's butterfly; the block's
    halves; the two blocks' halves added.  Returns (logp, grad) of both
    blocks."""
    d, N = xt.shape
    C = q.shape[0]
    R = -(-N // 256)
    rows = 128 * R
    m = np.arange(rows)
    out = []
    parts, lls = {}, {}
    for rank in (0, 1):
        n = _pair_row(m, rank)
        present = n < N
        xs = np.where(present[None, :], xt[:, np.minimum(n, N - 1)], 0.0)
        xs = xs.astype(np.float32)
        ys = np.where(present, y[np.minimum(n, N - 1)], 0.0).astype(
            np.float32)
        logit = xs[0][None, :] * q[:, 0:1]
        for j in range(1, d):
            logit = logit + xs[j][None, :] * q[:, j:j + 1]
        lt = torch.from_numpy(logit)
        yt = torch.from_numpy(ys)
        term = (yt * lt - logaddexp(torch.zeros_like(lt), lt)).numpy()
        p = (torch.ones_like(lt) / (1.0 + torch.exp(-lt))).numpy()
        term = np.where(present, term, np.float32(0.0))
        res = np.where(present, ys - p, np.float32(0.0))
        # [C, R, 4 warps, 32 lanes]: thread (u, l)'s row i is local row
        # 32 u + l + 128 i
        tr = term.reshape(C, R, 4, 32)
        ll = tr[:, 0]
        for i in range(1, R):
            ll = ll + tr[:, i]
        lls[rank] = _butterfly(ll)[..., 0]  # [C, 4]
        cols = (xs[None] * res[:, None, :]).reshape(C, d, R, 4, 32)
        c = cols[:, :, 0]
        for i in range(1, R):
            c = c + cols[:, :, i]
        parts[rank] = _butterfly(c)[..., 0]  # [C, d, 4]
    prior = tsum(torch.from_numpy(q * q)).numpy()
    for rank in (0, 1):
        halves = [(h[..., 0] + h[..., 2]) + (h[..., 1] + h[..., 3])
                  for h in (parts[rank], parts[1 - rank])]
        ll_halves = [(h[..., 0] + h[..., 2]) + (h[..., 1] + h[..., 3])
                     for h in (lls[rank], lls[1 - rank])]
        grad = (halves[0] + halves[1]) - q
        logp = (ll_halves[0] + ll_halves[1]) - np.float32(0.5) * prior
        out.append((logp, grad))
    return out


@pytest.mark.parametrize("rows,dim", [(1000, 100), (300, 37), (40, 5)])
def test_pair_regression_is_the_plain_functors_bits(rows, dim):
    """The pair form's log-likelihood and gradient columns (each block with
    half of tsum's slot warps and its rows staged in shared memory) equal
    the plain regression functor's (``PLAIN_FUNCTORS``, with ``tsum``) bit
    for bit in both blocks, on chains near and far from the posterior; the
    data path's N = 1000, d = 100 first (four rows a thread, 512 and 488
    rows a block)."""
    model = tg.logistic_regression(rows, dim, 1)
    _, _, tensors = model.hook_parts()
    xt, y = (t.numpy() for t in tensors[:2])
    rng = np.random.default_rng(rows)
    q = np.concatenate([0.1 * rng.normal(size=(6, dim)),
                        rng.uniform(-2, 2, size=(6, dim))]).astype(np.float32)
    want_lp, want_g = tg.PLAIN_FUNCTORS["logistic_regression"](
        torch.from_numpy(q), *tensors[:2], tsum)
    for logp, grad in _pair_regression(q, xt, y):
        assert np.array_equal(logp, want_lp.numpy())
        assert np.array_equal(grad, want_g.numpy())


def _pair_bytes(d, n):
    """mclmc_pair_bytes by its layout: the chain's 15 vectors, the
    reduction scratch (2 x 11 x 8) and the cluster slots (2 x 8), then x's
    and y's rows (128 a round of 256), the residuals, 4 x d column
    partials, 3 x (d + 1) exchange floats and 4 warp sums."""
    r = 128 * -(-n // 256)
    return 4 * (15 * d + 176 + 16 + d * r + 2 * r + 4 * d + 3 * (d + 1) + 4)


def test_block_form_rule_at_its_boundaries():
    """``_build.mclmc_block_form``: the pair form (128 threads, two blocks)
    for the regression under the Euclidean dynamics at B = 1 exactly where
    its layout fits a block's 232,448 bytes (d = 106 at N = 1000 fits, 107
    does not; 1024 rows and 1025 rows a round apart), today's (256, 1) at
    B = 2, 4, 8, under the microcanonical dynamics and where it does not
    fit; 256 threads for the iid normal at every d (128 and 64 lost at
    d = 400) and for every other functor."""
    for rows, d in ((1000, 100), (1000, 106), (1000, 107), (1024, 100),
                    (1025, 100), (256, 400), (256, 447), (40, 5)):
        model = tg.logistic_regression(rows, d, 0)
        assert _build.mclmc_pair_bytes(d, model) == _pair_bytes(d, rows)
        fits = _pair_bytes(d, rows) <= LIMIT
        assert _build.mclmc_block_form(d, model, 1, EUCLID) == (
            (128, 2) if fits else (256, 1)), (rows, d)
        for B in (2, 4, 8):
            assert _build.mclmc_block_form(d, model, B, EUCLID) == (256, 1)
        assert _build.mclmc_block_form(d, model, 1, MICRO) == (256, 1)
    assert _pair_bytes(106, 1000) <= LIMIT < _pair_bytes(107, 1000)
    assert _pair_bytes(100, 1024) < _pair_bytes(100, 1025)
    for d, T in ((11, 256), (100, 256), (256, 256), (257, 256), (400, 256),
                 (484, 256)):
        for B in (1, 2, 8):
            for mopts in (EUCLID, MICRO):
                assert _build.mclmc_block_form(
                    d, tg.normal_logp(d), B, mopts) == (T, 1)
    others = (tg.correlated_normal_rank1(300), tg.correlated_normal(300),
              tg.funnel(300), radon(), stochastic_volatility(T=300, seed=0))
    for model in others:
        for mopts in (EUCLID, MICRO):
            assert _build.mclmc_block_form(model.dim, model, 1, mopts) == \
                (256, 1), model.name
    with pytest.raises(ValueError, match="no pair form"):
        _build.mclmc_pair_bytes(100, tg.normal_logp(100))


def test_every_block_form_case_has_a_form():
    """``MCLMC_MID_FORMS`` still names a form for every mid-d functor and
    both kinetic energies, and every case it sends to the block form gets a
    form of ``mclmc_block_form`` that its functor has (the pair only for the
    regression's Euclidean draws, else 256 threads) at every logical block
    the launch takes, with one chain's part in a block's shared memory; the
    form names match the launch counts' keys."""
    functors = set(_build.MODEL_IDS) - {"logistic_regression_stream"}
    assert set(_build.MCLMC_MID_FORMS) == {
        (f, k) for f in functors for k in ("microcanonical", "euclidean")}
    zoo = {"iid_normal": tg.normal_logp(400),
           "logistic_regression": tg.logistic_regression(1000, 100, 0),
           "correlated_normal_rank1": tg.correlated_normal_rank1(100),
           "radon": radon(),
           "stochastic_volatility": stochastic_volatility(T=300, seed=0),
           "funnel": tg.funnel(10),
           "correlated_normal": tg.correlated_normal(100)}
    seen = set()
    for (name, kind), (form, _) in _build.MCLMC_MID_FORMS.items():
        model = zoo[name]
        mopts = MclmcOptions(kind=KineticKind[kind.upper()])
        assert _build.mclmc_mid_form(model, mopts) == form
        if form != "block":
            continue
        for B in (1, 2, 4, 8):
            T, X = _build.mclmc_block_form(model.dim, model, B, mopts)
            if X == 2:
                assert name == "logistic_regression" and kind == "euclidean"
                assert _build.mclmc_pair_bytes(model.dim, model) <= LIMIT
            else:
                assert T == 256
            assert _build.mclmc_mid_smem_bytes(model.dim, model) <= LIMIT
            seen.add(_build.block_form_name((T, X)))
    assert seen == {"pair", "T256"}
    assert set(_build.MCLMC_BLOCK_FORM_LAUNCHES) == {
        f"{k} {f}" for k in ("posterior", "warmup")
        for f in ("pair", "T256")}


def test_threads_a_chain_without_data():
    """At every d the block form takes without data (to the posterior limit
    of 484) the iid normal runs on 256 threads a chain, and the regression
    keeps its forms."""
    top = mclmc_max_dim(False)
    assert top == 484
    for d in range(2, top + 1):
        model = tg.normal_logp(d)
        if nf.cl_kernel(model, d) != "mid":
            continue
        assert _build.mclmc_mid_form(model, MICRO) == "block"
        assert _build.mclmc_block_form(d, model, 1, MICRO) == (256, 1)
    glm = tg.logistic_regression(1000, 100, 0)
    assert _build.mclmc_block_form(100, glm, 1, EUCLID) == (128, 2)
    assert _build.mclmc_block_form(100, glm, 2, EUCLID) == (256, 1)


@pytest.mark.parametrize("name", ["normal400", "glm"])
def test_block_forms_take_the_plain_version_on_the_cpu(name):
    """On CPU tensors the wrappers run the plain versions whatever form the
    rule gives (256 threads at d = 400, the pair for the regression's
    Euclidean draws): no launch or form launch is counted."""
    if name == "glm":
        model, mopts = tg.logistic_regression(40, 5, 0), EUCLID
    else:
        model, mopts = tg.normal_logp(400, 0.5), MICRO
    d = model.dim
    C, K = 2, 2
    rng = np.random.default_rng(d)
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
    before = dict(mf.LAUNCHES), dict(_build.MCLMC_BLOCK_FORM_LAUNCHES)
    got = mf.mclmc_fused_run(3, *args, K, model, mopts, 0.1, block=1)
    want = mf.mclmc_fused_run_reference(3, *args, K, model, mopts, 0.1,
                                        block=1)
    assert (dict(mf.LAUNCHES), dict(_build.MCLMC_BLOCK_FORM_LAUNCHES)) == \
        before
    for a, b in zip(got[:5], want[:5]):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
