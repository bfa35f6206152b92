"""The fused CUDA kernels (NUTS K1/K2, their dim-on-lanes forms K1-ld /
K2-ld and, with model data, K1-ld-args / K2-ld-args, their mid-d forms with
model data K1-args / K2-args and the streamed posterior K1-stream, MCLMC
K3/K4 and their mid-d forms with model data K3-args / K4-args (also in
their group form, the regression's microcanonical draws), the
model zoo's functors on them, and K1-flow through a frozen coupling flow)
against their plain PyTorch versions, on the card; the sync NUTS engine on
the card against the CPU.

Needs a CUDA card and the CUDA toolkit; skips without a card.  The file
imports no JAX, so it runs where JAX is not installed:

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py -q

(``--noconftest`` skips tests/conftest.py, which sets JAX up for the rest
of the suite).  With sums in coordinate order and the kernels built with
``-fmad=false``, kernel and plain version agree draw for draw: integer
stats equal, floats to 1e-5 relative.  The dim-on-lanes kernels sum in
``ops.tsum``'s order, which their plain versions share; so do the mid-d
kernels, whose logistic-regression functor also sums a logit's terms in
ascending j.  K1-stream and its plain version share their sum order too
(ranges of tiles, quads of rows: models.cuh::LogisticRegressionStream) and
agree bit for bit.
"""

import numpy as np
import pytest
import torch

from nuts_rs_tpu_torch.adapt.step_size import StepSizeSettings
from nuts_rs_tpu_torch.kernels import nuts_fused as nf
from nuts_rs_tpu_torch.kernels.nuts import NutsOptions
from nuts_rs_tpu_torch.models import gaussian as tg

INT_STATS = ("depth", "diverging", "n_steps", "index_in_trajectory",
             "maxdepth_reached", "loop_iterations")


def _close(got, want, what, rtol, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=what)


@pytest.mark.cuda
def test_kernels_match_plain_versions_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU build")
    dev = torch.device("cuda", 0)
    model, opts = tg.normal_logp(4, 0.5), NutsOptions(maxdepth=10)
    C, dim = 64, 4
    rng = np.random.default_rng(0)
    q = torch.tensor(rng.normal(size=(C, dim)), dtype=torch.float32,
                     device=dev)
    logp, g = model.logp_and_grad(q)
    stds = torch.tensor(rng.uniform(0.7, 1.3, size=(C, dim)),
                        dtype=torch.float32, device=dev)
    mean = torch.zeros_like(q)
    logdet = -torch.log(stds).sum(1)
    step = torch.full((C,), 0.6, device=dev)
    args = (q, g, logp, stds, mean, logdet, step, step.clone())
    got = nf.nuts_fused_run(3, *args, 8, model, opts, 0.1)
    want = nf.nuts_fused_run_reference(3, *args, 8, model, opts, 0.1)
    for name in INT_STATS:
        np.testing.assert_array_equal(got[4][name].cpu().numpy(),
                                      want[4][name].cpu().numpy())
    _close(got[3].cpu(), want[3].cpu(), "draws", 1e-5, 1e-6)

    flags = torch.ones(6, nf.NFLAGS, dtype=torch.int32, device=dev)
    est = torch.zeros(C, 8, dim, device=dev)
    sca = torch.zeros(C, nf.NSCA, device=dev)
    sca[:, nf.SCA_STEP] = 0.5
    sca[:, nf.SCA_DA_CNT] = 1.0
    sca[:, nf.SCA_DA_MU] = float(np.log(5.0))
    wargs = (flags, q, g, logp, stds, mean, est, sca, model, opts,
             StepSizeSettings(), True)
    got = nf.nuts_fused_warmup_run(5, *wargs)
    want = nf.nuts_fused_warmup_run_reference(5, *wargs)
    for name in INT_STATS:
        np.testing.assert_array_equal(got[8][name].cpu().numpy(),
                                      want[8][name].cpu().numpy())
    for i in range(8):
        _close(got[i].cpu(), want[i].cpu(), str(i), 1e-5, 1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("dim,block,maxdepth,step", [
    (300, 8, 10, 0.25), (257, 4, 6, 0.25),
    # the large-d path's d at its block and at B = 1, with trees deep enough
    # for leaves of tzn >= 3 (the merged pass's extra reduction)
    (1000, 8, 10, 0.1), (1000, 1, 10, 0.1),
    # the largest d of each form at maxdepth 10 (_build.ld_form): the
    # posterior's merged form, then today's form (the warmup's merged)
    (2732, 8, 10, 0.1), (2757, 8, 10, 0.1)])
def test_ld_kernels_match_plain_versions_on_the_card(dim, block, maxdepth,
                                                     step):
    """K1-ld and K2-ld, C = 16 chains in logical blocks of ``block``
    (clusters of that many CUDA blocks), d and maxdepth given at launch, bit
    for bit against their plain versions: every output and stat equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU build")
    from nuts_rs_tpu_torch.kernels import _build

    dev = torch.device("cuda", 0)
    C, mu = 16, 3.0
    same = np.testing.assert_array_equal
    model, opts = tg.normal_logp(dim, mu), NutsOptions(maxdepth=maxdepth)
    rng = np.random.default_rng(dim)
    f = lambda x: torch.tensor(x, dtype=torch.float32, device=dev)  # noqa: E731
    q = f(mu + rng.normal(size=(C, dim)))
    logp, g = model.logp_and_grad(q)
    stds = f(rng.uniform(0.7, 1.3, size=(C, dim)))
    mean = f(mu + 0.1 * rng.normal(size=(C, dim)))
    logdet = -torch.log(stds).sum(1)
    steps = torch.full((C,), step, device=dev)
    args = (q, g, logp, stds, mean, logdet, steps, steps.clone())
    before = dict(nf.LAUNCHES)
    got = nf.nuts_fused_run(3, *args, 8, model, opts, 0.1, block=block,
                            layout="ld")
    torch.cuda.synchronize()
    want = nf.nuts_fused_run_reference(3, *args, 8, model, opts, 0.1,
                                       block=block, layout="ld")
    for name in INT_STATS:
        same(got[4][name].cpu().numpy(), want[4][name].cpu().numpy(), name)
    assert got[3].shape == (C, 8, dim)
    for i in range(4):
        same(got[i].cpu().numpy(), want[i].cpu().numpy(), str(i))
    for name in nf.STAT_NAMES:
        same(got[4][name].cpu().numpy(), want[4][name].cpu().numpy(), name)
    if step < 0.25:
        # a tree of depth 4 or more ran the leaf of tzn = 3 of its third
        # subtree
        assert int(got[4]["depth"].max()) >= 4
    print(f"K1-ld d={dim} form {_build.ld_form('posterior', dim, maxdepth)}"
          f", K2-ld form {_build.ld_form('warmup', dim, maxdepth)}; "
          f"depth max {int(got[4]['depth'].max())}")

    flags = torch.ones(6, nf.NFLAGS, dtype=torch.int32, device=dev)
    flags[:, nf.FLAG_DO_SWITCH] = 0
    flags[3, nf.FLAG_DO_SWITCH] = 1
    est = torch.zeros(C, 8, dim, device=dev)
    sca = torch.zeros(C, nf.NSCA, device=dev)
    sca[:, nf.SCA_STEP] = 0.2
    sca[:, nf.SCA_DA_CNT] = 1.0
    sca[:, nf.SCA_DA_MU] = float(np.log(2.0))
    sca[:, nf.SCA_LOGDET] = logdet
    wargs = (flags, q, g, logp, stds, mean, est, sca, model, opts,
             StepSizeSettings(), True)
    got = nf.nuts_fused_warmup_run(5, *wargs, block=block, layout="ld")
    torch.cuda.synchronize()
    want = nf.nuts_fused_warmup_run_reference(5, *wargs, block=block,
                                              layout="ld")
    for name in INT_STATS + ("transformation_index",):
        same(got[8][name].cpu().numpy(), want[8][name].cpu().numpy(), name)
    for i in range(8):
        same(got[i].cpu().numpy(), want[i].cpu().numpy(), str(i))
    for name in nf.WARMUP_STAT_NAMES:
        same(got[8][name].cpu().numpy(), want[8][name].cpu().numpy(), name)
    assert nf.LAUNCHES["nuts_fused_ld_posterior"] == \
        before["nuts_fused_ld_posterior"] + 1
    assert nf.LAUNCHES["nuts_fused_ld_warmup"] == \
        before["nuts_fused_ld_warmup"] + 1
    # a chain block above the cluster size is refused, not run another way
    with pytest.raises(ValueError, match="chain block"):
        nf.nuts_fused_run(3, *args, 8, model, opts, 0.1, block=16,
                          layout="ld")


@pytest.mark.cuda
@pytest.mark.parametrize("dim,rows,block,maxdepth", [(37, 300, 8, 6),
                                                     (5, 70, 4, 10),
                                                     (150, 1001, 8, 8)])
def test_mid_kernels_with_data_match_plain_versions_on_the_card(
        dim, rows, block, maxdepth):
    """K1-args and K2-args on logistic regression at other sizes than the
    main path's: rows no multiple of the 256 threads, maxdepth at launch,
    C = 16 chains in logical blocks of ``block``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU build")
    dev = torch.device("cuda", 0)
    C = 16
    model = tg.logistic_regression(rows, dim, 3).to(dev)
    assert model.hook_parts()[2][0].device.type == "cuda"
    assert nf.cl_kernel(model, dim) == "mid"
    opts = NutsOptions(maxdepth=maxdepth)
    rng = np.random.default_rng(dim)
    f = lambda x: torch.tensor(x, dtype=torch.float32, device=dev)  # noqa: E731
    q = f(0.2 * rng.normal(size=(C, dim)))
    logp, g = model.logp_and_grad(q)
    stds = f(rng.uniform(0.05, 0.15, size=(C, dim)))
    mean = f(0.02 * rng.normal(size=(C, dim)))
    logdet = -torch.log(stds).sum(1)
    step = torch.full((C,), 0.4, device=dev)
    args = (q, g, logp, stds, mean, logdet, step, step.clone())
    before = dict(nf.LAUNCHES)
    got = nf.nuts_fused_run(3, *args, 8, model, opts, 0.1, block=block)
    torch.cuda.synchronize()
    want = nf.nuts_fused_run_reference(3, *args, 8, model, opts, 0.1,
                                       block=block)
    for name in INT_STATS:
        np.testing.assert_array_equal(got[4][name].cpu().numpy(),
                                      want[4][name].cpu().numpy(), name)
    assert got[3].shape == (C, 8, dim)
    for i in range(4):
        _close(got[i].cpu(), want[i].cpu(), str(i), 1e-5, 1e-6)
    for name in nf.STAT_NAMES:
        _close(got[4][name].cpu(), want[4][name].cpu(), name, 1e-5, 1e-5)

    flags = torch.ones(6, nf.NFLAGS, dtype=torch.int32, device=dev)
    flags[:, nf.FLAG_DO_SWITCH] = 0
    flags[3, nf.FLAG_DO_SWITCH] = 1
    est = torch.zeros(C, 8, dim, device=dev)
    sca = torch.zeros(C, nf.NSCA, device=dev)
    sca[:, nf.SCA_STEP] = 0.3
    sca[:, nf.SCA_DA_CNT] = 1.0
    sca[:, nf.SCA_DA_MU] = float(np.log(3.0))
    sca[:, nf.SCA_LOGDET] = logdet
    wargs = (flags, q, g, logp, stds, mean, est, sca, model, opts,
             StepSizeSettings(), True)
    got = nf.nuts_fused_warmup_run(5, *wargs, block=block)
    torch.cuda.synchronize()
    want = nf.nuts_fused_warmup_run_reference(5, *wargs, block=block)
    for name in INT_STATS + ("transformation_index",):
        np.testing.assert_array_equal(got[8][name].cpu().numpy(),
                                      want[8][name].cpu().numpy(), name)
    for i in range(8):
        _close(got[i].cpu(), want[i].cpu(), str(i), 1e-5, 1e-6)
    for name in nf.WARMUP_STAT_NAMES:
        _close(got[8][name].cpu(), want[8][name].cpu(), name, 1e-5, 1e-5)
    assert nf.LAUNCHES["nuts_fused_mid_posterior"] == \
        before["nuts_fused_mid_posterior"] + 1
    assert nf.LAUNCHES["nuts_fused_mid_warmup"] == \
        before["nuts_fused_mid_warmup"] + 1
    # data on another device than the state is refused, not copied
    with pytest.raises(ValueError, match="must lie on"):
        nf.nuts_fused_run(3, *args, 8, model.to("cpu"), opts, 0.1,
                          block=block)


def _same_bits(got, want, what):
    a, b = np.asarray(got.cpu()), np.asarray(want.cpu())
    assert a.shape == b.shape, what
    if not np.array_equal(a, b, equal_nan=True):
        with np.errstate(invalid="ignore"):
            diff = np.nanmax(np.abs(a - b))
        raise AssertionError(f"{what}: not bit for bit (max abs diff {diff})")


def _group_case(name, dev, C):
    """(model, maxdepth, posterior inputs near the model's posterior) of a
    mid-d group-kernel case."""
    import json
    from pathlib import Path

    from nuts_rs_tpu_torch.chain import cl_max_dim
    from nuts_rs_tpu_torch.models import hierarchical as th

    rng = np.random.default_rng(len(name) + C)
    D = 10
    if name == "glm":
        model = tg.logistic_regression(1000, 100, 0)
        ref = json.loads((Path(__file__).parent / "data" /
                          "logreg_d100_reference.json").read_text())
        center, sd, steps = np.array(ref["mean"]), np.array(ref["std"]), \
            (0.4, 0.55)
    elif name == "glm300":  # the regression's largest MCLMC G of 4
        model = tg.logistic_regression(1000, 300, 2)
        center, sd, steps = np.zeros(300), np.full(300, 0.05), (0.3, 0.4)
    elif name.startswith("glm_"):  # residuals through shared memory
        # 1500 rows: G = 8; 15000: G = 2 (their shared memory); 30000: G = 1
        rows = {"glm_rows": 1500, "glm_g2": 15000, "glm_g1": 30000}[name]
        model = tg.logistic_regression(rows, 37, 1)
        center, sd, steps = np.zeros(37), np.full(37, 0.05), (0.3, 0.4)
        D = 6
    elif name == "radon":
        model = th.radon(seed=0)
        center = np.r_[1.5, -0.7, np.log(0.8), np.log(0.3), np.zeros(85)]
        sd = np.r_[0.1, 0.1, 0.05, 0.3, np.full(85, 0.8)]
        steps = (0.4, 0.55)
    elif name == "rank1":
        model = tg.correlated_normal_rank1(100)
        center, sd, steps = np.zeros(100), np.full(100, 1.2), (0.1, 0.2)
    elif name == "funnel":
        model = tg.funnel(10)
        center, sd, steps = np.zeros(10), np.full(10, 0.8), (0.2, 0.3)
    elif name == "correlated_normal":
        model = tg.correlated_normal(100)
        center, sd, steps = np.zeros(100), np.full(100, 1.2), (0.4, 0.6)
    else:  # normal<d>, or normal_max: the largest mid d at maxdepth 2
        D = 2 if name == "normal_max" else 10
        d = cl_max_dim(2) if name == "normal_max" else int(name[6:])
        model = tg.normal_logp(d, 0.5)
        center, sd, steps = np.full(d, 0.5), np.ones(d), (0.3, 0.5)
    model = model.to(dev)
    f = lambda x: torch.tensor(x, dtype=torch.float32, device=dev)  # noqa: E731
    d = model.dim
    q = f(center + sd * rng.normal(size=(C, d)))
    logp, g = model.logp_and_grad(q)
    stds = f(sd * rng.uniform(0.8, 1.2, size=(C, d)))
    mean = f(center + 0.1 * sd * rng.normal(size=(C, d)))
    logdet = -torch.log(stds).sum(1)
    step = f(rng.uniform(*steps, size=C))
    return model, D, (q, g, logp, stds, mean, logdet, step, step.clone())


@pytest.mark.cuda
@pytest.mark.parametrize("name,C,B", [
    ("glm", 1024, 1), ("glm", 100, 2), ("glm", 64, 8), ("glm_rows", 100, 1),
    ("glm_g2", 64, 2), ("glm_g1", 64, 1), ("radon", 1024, 1),
    ("radon", 100, 4), ("radon", 64, 8), ("rank1", 100, 1), ("funnel", 64, 8),
    ("correlated_normal", 1024, 2), ("normal11", 100, 1),
    ("normal212", 64, 8), ("normal_max", 100, 2), ("normal_max", 64, 1)])
def test_mid_group_kernels_match_plain_versions_bit_for_bit(name, C, B):
    """K1-args and K2-args, G chains a CUDA block (the regression's the
    rule's: 8; 2 and 1 where its residuals fill the shared memory; a
    functor without the group form the fewest for one wave, up to the
    rule's: 4 at the largest mid d at maxdepth 2), against their plain
    versions: every integer
    stat equal and every float bit for bit, at 64, 100 (the last CUDA block
    partly empty) and 1024 chains in logical blocks of B, on the regression
    (1000 x 100; 1500, 15000 and 30000 rows at d = 37: residuals in shared
    memory), radon, the three other functors and the iid normal at d = 11,
    212 and the largest mid d at maxdepth 2."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU build")
    from nuts_rs_tpu_torch.kernels import _build

    dev = torch.device("cuda", 0)
    model, D, args = _group_case(name, dev, C)
    opts = NutsOptions(maxdepth=D)
    d = model.dim
    assert nf.cl_kernel(model, d) == "mid"
    for kind in ("posterior", "warmup"):
        G = _build.mid_launch_group(kind, d, D, model, C, B,
                                    _build.sm_count(dev))
        print(f"{name} {kind}: d={d} C={C} B={B} G={G}, "
              f"{_build.mid_blocks_per_sm(kind, model, D, G)} blocks an SM")
    before = dict(nf.LAUNCHES)
    got = nf.nuts_fused_run(3, *args, 8, model, opts, 0.1, block=B)
    torch.cuda.synchronize()
    want = nf.nuts_fused_run_reference(3, *args, 8, model, opts, 0.1,
                                       block=B)
    for i, what in enumerate(("q_f", "g_f", "logp_f", "draws")):
        _same_bits(got[i], want[i], what)
    for stat in list(nf.STAT_NAMES) + ["loop_iterations"]:
        _same_bits(got[4][stat], want[4][stat], stat)

    q, g, logp, stds, mean, logdet, step, _ = args
    flags = torch.ones(4, nf.NFLAGS, dtype=torch.int32, device=dev)
    flags[:, nf.FLAG_DO_SWITCH] = 0
    flags[2, nf.FLAG_DO_SWITCH] = 1
    est = torch.zeros(C, 8, d, device=dev)
    est[:, 0], est[:, 2], est[:, 4], est[:, 6] = q, g, q, g
    sca = torch.zeros(C, nf.NSCA, device=dev)
    sca[:, nf.SCA_STEP] = step
    sca[:, nf.SCA_DA_LS] = sca[:, nf.SCA_DA_LSA] = torch.log(step)
    sca[:, nf.SCA_DA_MU] = torch.log(10.0 * step)
    sca[:, nf.SCA_DA_CNT] = 1.0
    sca[:, nf.SCA_CNT_FG] = sca[:, nf.SCA_CNT_BG] = 1.0
    sca[:, nf.SCA_LOGDET] = logdet
    wargs = (flags, q, g, logp, stds, mean, est, sca, model, opts,
             StepSizeSettings(), True)
    got = nf.nuts_fused_warmup_run(5, *wargs, block=B)
    torch.cuda.synchronize()
    want = nf.nuts_fused_warmup_run_reference(5, *wargs, block=B)
    for i, what in enumerate(("q", "g", "logp", "stds", "mean", "est", "sca",
                              "draws")):
        _same_bits(got[i], want[i], what)
    for stat in list(nf.WARMUP_STAT_NAMES) + ["loop_iterations"]:
        _same_bits(got[8][stat], want[8][stat], stat)
    for which in ("posterior", "warmup"):
        key = f"nuts_fused_mid_{which}"
        assert nf.LAUNCHES[key] == before[key] + 1, key


@pytest.mark.cuda
@pytest.mark.parametrize("name,B", [("normal_max", 8), ("glm_g1", 2)])
def test_mid_group_kernels_refuse_a_block_g_does_not_hold(name, B):
    """A logical block that does not divide the CUDA block's G chains is
    refused (G = 4 at the largest mid d at maxdepth 2, 1 where one chain's
    residuals fill the shared memory); no CUDA tensor reaches a plain
    version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU build")
    dev = torch.device("cuda", 0)
    model, D, args = _group_case(name, dev, 64)
    opts = NutsOptions(maxdepth=D)
    with pytest.raises(ValueError, match=f"multiple of the chain block {B}"):
        nf.nuts_fused_run(3, *args, 8, model, opts, 0.1, block=B)


@pytest.mark.cuda
def test_normal_100_runs_end_to_end_on_the_card():
    """A size between the thread-per-chain instances and the dim-on-lanes
    layout (d = 11..212 used to raise at construction on the card) runs
    warmup and posterior on the mid-d kernels."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU build")
    import nuts_rs_tpu_torch as tnt

    before = dict(nf.LAUNCHES)
    trace = tnt.sample(tg.normal_logp(100, 3.0), tnt.DiagNutsSettings(
        num_chains=64, num_tune=150, num_draws=100, seed=0,
        posterior_kernel="pallas"), device="cuda")
    pos = trace.posterior["position"].astype(np.float64)
    assert pos.shape == (64, 100, 100)
    assert abs(pos.mean() - 3.0) < 0.03
    assert abs(pos.std() - 1.0) < 0.05
    assert not trace.sample_stats["diverging"].any()
    assert 0.7 < trace.sample_stats["mean_tree_accept"].mean() < 0.95
    assert nf.LAUNCHES["nuts_fused_mid_posterior"] > \
        before["nuts_fused_mid_posterior"]
    assert nf.LAUNCHES["nuts_fused_mid_warmup"] > \
        before["nuts_fused_mid_warmup"]
    assert nf.LAUNCHES["nuts_fused_posterior"] == \
        before["nuts_fused_posterior"]


MCLMC_INT_STATS = ("diverging", "n_steps", "loop_iterations")


def _mclmc_state(dev, C, dim, seed):
    rng = np.random.default_rng(seed)
    f = lambda x: torch.tensor(x, dtype=torch.float32, device=dev)  # noqa: E731
    model = tg.normal_logp(dim, 0.5)
    q = f(0.5 + rng.normal(size=(C, dim)))
    logp, g = model.logp_and_grad(q)
    v = rng.normal(size=(C, dim))
    v = f(v / np.linalg.norm(v, axis=1, keepdims=True))
    stds = f(rng.uniform(0.7, 1.3, size=(C, dim)))
    return model, q, g, logp, v, stds, torch.zeros_like(q)


@pytest.mark.cuda
@pytest.mark.parametrize("micro,max_err,dynamic", [
    (True, 1000.0, True), (True, 0.05, True), (False, 0.02, False)])
def test_mclmc_kernels_match_plain_versions_on_the_card(micro, max_err,
                                                        dynamic):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU build")
    from nuts_rs_tpu_torch.adapt.step_size import StepSizeMethod
    from nuts_rs_tpu_torch.dynamics.hamiltonian import KineticKind
    from nuts_rs_tpu_torch.kernels import mclmc_fused as mf
    from nuts_rs_tpu_torch.kernels.mclmc import MclmcOptions

    dev = torch.device("cuda", 0)
    C, dim = 64, 4
    kind = KineticKind.MICROCANONICAL if micro else KineticKind.EUCLIDEAN
    mopts = MclmcOptions(kind=kind, max_energy_error=max_err,
                         dynamic_step_size=dynamic)
    model, q, g, logp, v, stds, mean = _mclmc_state(dev, C, dim, 1)
    logdet = -torch.log(stds).sum(1)
    step = torch.full((C,), 1.2, device=dev)
    args = (q, g, logp, v, stds, mean, logdet, step, step.clone())
    got = mf.mclmc_fused_run(3, *args, 8, model, mopts, 0.1)
    want = mf.mclmc_fused_run_reference(3, *args, 8, model, mopts, 0.1)
    for name in MCLMC_INT_STATS:
        np.testing.assert_array_equal(got[5][name].cpu().numpy(),
                                      want[5][name].cpu().numpy())
    for i in range(5):
        _close(got[i].cpu(), want[i].cpu(), str(i), 1e-5, 1e-6)

    flags = torch.zeros(6, mf.NFLAGS, dtype=torch.int32, device=dev)
    flags[:, mf.FLAG_UPDATE_EST] = 1
    flags[0, mf.FLAG_RESAMPLE] = flags[4, mf.FLAG_RESAMPLE] = 1
    flags[2:, mf.FLAG_DO_UPDATE] = 1
    flags[3, mf.FLAG_DO_SWITCH] = 1
    est = torch.zeros(C, 8, dim, device=dev)
    sca = torch.zeros(C, mf.NSCA, device=dev)
    sca[:, mf.SCA_LOGDET] = logdet
    sset = StepSizeSettings(method=StepSizeMethod.FIXED, fixed_value=0.9)
    wargs = (flags, q, g, logp, v, stds, mean, est, sca, model, mopts, sset,
             True)
    got = mf.mclmc_fused_warmup_run(5, *wargs)
    want = mf.mclmc_fused_warmup_run_reference(5, *wargs)
    for name in MCLMC_INT_STATS + ("transformation_index",):
        np.testing.assert_array_equal(got[9][name].cpu().numpy(),
                                      want[9][name].cpu().numpy())
    for i in range(9):
        _close(got[i].cpu(), want[i].cpu(), str(i), 1e-5, 1e-6)


# K3 / K4 with a chain's coordinates on a group of lanes (_build.mclmc_lanes):
# every d of _build.DIMS under both kinetic energies with and without the
# halving stack, logical blocks of 1, 32 and 128 chains (16 lanes a chain
# at d = 10 and B <= 64, 8 above: the rule's every choice, and its edge at
# B = 64 / 65).  With halvings (max_energy_error small) some draws halve
# their step; without, some draws give up and some do not; the 0.0005 case
# does both.  (dim, micro, dynamic, C, B, max_err, expect)
MCLMC_LANE_CASES = [
    (d, micro, dynamic, 128 if B == 128 else 64, B,
     (0.05 if micro else 0.02) if dynamic else (2.0 if micro else 1.0),
     ("halve",) if dynamic else ("give_up",))
    for i, (d, micro, dynamic) in enumerate(
        (d, m, y) for d in (3, 4, 6, 10) for m in (True, False)
        for y in (True, False))
    for B in [(1, 32, 128)[i % 3]]] + [
    (10, True, True, 32, 32, 0.0005, ("halve", "give_up")),
    (10, False, True, 130, 65, 0.02, ("halve",)),
    (10, True, False, 128, 64, 2.0, ("give_up",))]


def mclmc_lane_inputs(dim, micro, dynamic, C, max_err, dev):
    """(model, options, K3's nine inputs, K4's flags and inputs) of a
    ``MCLMC_LANE_CASES`` case: a state near N(0.5, 1) with unit-sphere
    velocities, steps of 1.2 for K3, six warmup rows with two momentum
    resamples, a window switch and mass-matrix updates for K4."""
    from nuts_rs_tpu_torch.adapt.step_size import StepSizeMethod
    from nuts_rs_tpu_torch.dynamics.hamiltonian import KineticKind
    from nuts_rs_tpu_torch.kernels import mclmc_fused as mf
    from nuts_rs_tpu_torch.kernels.mclmc import MclmcOptions

    kind = KineticKind.MICROCANONICAL if micro else KineticKind.EUCLIDEAN
    mopts = MclmcOptions(kind=kind, max_energy_error=max_err,
                         dynamic_step_size=dynamic)
    model, q, g, logp, v, stds, mean = _mclmc_state(dev, C, dim, 1)
    logdet = -torch.log(stds).sum(1)
    step = torch.full((C,), 1.2, device=dev)
    post = (q, g, logp, v, stds, mean, logdet, step, step.clone())
    flags = torch.zeros(6, mf.NFLAGS, dtype=torch.int32, device=dev)
    flags[:, mf.FLAG_UPDATE_EST] = 1
    flags[0, mf.FLAG_RESAMPLE] = flags[4, mf.FLAG_RESAMPLE] = 1
    flags[2:, mf.FLAG_DO_UPDATE] = 1
    flags[3, mf.FLAG_DO_SWITCH] = 1
    est = torch.zeros(C, 8, dim, device=dev)
    sca = torch.zeros(C, mf.NSCA, device=dev)
    sca[:, mf.SCA_LOGDET] = logdet
    sset = StepSizeSettings(method=StepSizeMethod.FIXED, fixed_value=0.9)
    warm = (flags, q, g, logp, v, stds, mean, est, sca, model, mopts, sset,
            True)
    return model, mopts, post, warm


def require_mclmc_expect(stats, expect, what):
    """Raise unless the draws show ``expect``: "halve", some draw that did
    not give up integrated at a smaller average step than its own (a halving
    changes it by 1 / (n_steps + 1) at least, rounding by an ulp);
    "give_up", some draws gave up and some did not."""
    div = stats["diverging"].cpu().numpy() != 0
    avg = stats["average_step_size"].cpu().numpy()
    step = stats["step_size"].cpu().numpy()
    if "halve" in expect:
        assert ((avg < 0.999 * step) & ~div).any(), f"{what}: no draw halved"
    if "give_up" in expect:
        assert div.any() and not div.all(), \
            f"{what}: {div.mean():.0%} of draws gave up"


@pytest.mark.cuda
@pytest.mark.parametrize("dim,micro,dynamic,C,B,max_err,expect",
                         MCLMC_LANE_CASES)
def test_mclmc_lane_kernels_match_plain_versions_bit_for_bit(
        dim, micro, dynamic, C, B, max_err, expect):
    """K3 and K4 (a chain's coordinates on the lanes _build.mclmc_lanes
    gives) against their plain versions: every integer stat equal and
    every float bit for bit, after the plain versions' draws showed the
    case's halvings or give-ups."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU build")
    from nuts_rs_tpu_torch.kernels import _build
    from nuts_rs_tpu_torch.kernels import mclmc_fused as mf

    dev = torch.device("cuda", 0)
    model, mopts, post, warm = mclmc_lane_inputs(dim, micro, dynamic, C,
                                                 max_err, dev)
    T = _build.mclmc_lanes(dim, B)
    assert B * T <= 1024 and (T >= dim or (B > 64 and T == 8))
    what = f"d={dim} micro={micro} dynamic={dynamic} B={B} T={T}"
    want = mf.mclmc_fused_run_reference(3, *post, 8, model, mopts, 0.1, B)
    require_mclmc_expect(want[5], expect, f"K3 {what}")
    before = dict(mf.LAUNCHES)
    got = mf.mclmc_fused_run(3, *post, 8, model, mopts, 0.1, B)
    for name in MCLMC_INT_STATS:
        np.testing.assert_array_equal(got[5][name].cpu().numpy(),
                                      want[5][name].cpu().numpy(),
                                      err_msg=f"K3 {what} {name}")
    for i in range(5):
        _same_bits(got[i], want[i], f"K3 {what} output {i}")
    for name in mf.STAT_NAMES:
        _same_bits(got[5][name], want[5][name], f"K3 {what} {name}")

    want = mf.mclmc_fused_warmup_run_reference(5, *warm, B)
    require_mclmc_expect(want[9], expect, f"K4 {what}")
    got = mf.mclmc_fused_warmup_run(5, *warm, B)
    for name in MCLMC_INT_STATS + ("transformation_index",):
        np.testing.assert_array_equal(got[9][name].cpu().numpy(),
                                      want[9][name].cpu().numpy(),
                                      err_msg=f"K4 {what} {name}")
    for i in range(9):
        _same_bits(got[i], want[i], f"K4 {what} output {i}")
    for name in mf.WARMUP_STAT_NAMES:
        _same_bits(got[9][name], want[9][name], f"K4 {what} {name}")
    for key in ("mclmc_fused_posterior", "mclmc_fused_warmup"):
        assert mf.LAUNCHES[key] == before[key] + 1, key


@pytest.mark.cuda
@pytest.mark.parametrize("dim", [3, 4, 6, 10])
def test_mclmc_lane_rule_is_the_same_in_c(dim):
    """csrc/mclmc_step.cuh::mclmc_lanes gives the lanes _build.mclmc_lanes
    gives at every block of 1 .. 128 chains."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU build")
    from nuts_rs_tpu_torch.kernels import _build

    lib = _build.library("mclmc_fused_posterior")
    for B in range(1, _build.MAX_BLOCK + 1):
        assert lib.nrt_mclmc_lanes(dim, B) == _build.mclmc_lanes(dim, B), B


# K1 and K2 with a chain's coordinates on a group of T lanes
# (csrc/nuts_tree.cuh, _build.nuts_lanes: 4) over every instantiated d (one
# to three coordinates a lane, a padding slot on one or two lanes at d = 3,
# 6 and 10), blocks of 1, 32, 64, 65 and 128 (512 threads), jitter on and
# off and K2 with both estimates of the mass matrix; every case's trees
# grow, one case diverges in some draws and not in all (a small
# max_energy_error) and one reaches maxdepth (steps of 0.002-0.003; one
# draw and one warmup row, each tree 1023 leapfrogs).  The plain version's
# draws are held to the case's expectation before the comparison
# (tests/test_torch_nuts_lanes.py does the same on the CPU).
# (dim, B, C, jitter, use_grad_based, max_err, step, draws, expect)
NUTS_LANE_CASES = [
    (3, 1, 64, 0.1, True, 1000.0, (0.8, 1.0), 8, "grow"),
    (3, 128, 128, None, False, 1000.0, (0.8, 1.0), 8, "grow"),
    (4, 32, 64, None, True, 1000.0, (0.8, 1.0), 8, "grow"),
    (4, 65, 130, 0.1, False, 1000.0, (0.8, 1.0), 8, "grow"),
    (6, 64, 128, 0.1, True, 1000.0, (0.8, 1.0), 8, "grow"),
    (6, 1, 64, None, False, 1000.0, (0.8, 1.0), 8, "grow"),
    (10, 1, 64, 0.1, False, 1000.0, (0.8, 1.0), 8, "grow"),
    (10, 32, 64, 0.1, True, 1000.0, (0.8, 1.0), 8, "grow"),
    (10, 64, 128, None, True, 1000.0, (0.8, 1.0), 8, "grow"),
    (10, 65, 130, 0.1, True, 1000.0, (0.8, 1.0), 8, "grow"),
    (10, 128, 128, None, False, 1000.0, (0.8, 1.0), 8, "grow"),
    (10, 32, 64, 0.1, True, 1.0, (0.8, 1.0), 8, "diverge"),
    (10, 32, 32, 0.1, True, 1000.0, (0.002, 0.003), 1, "maxdepth")]


def nuts_lane_inputs(dim, C, jitter, max_err, step, draws, dev):
    """(model, options, K1's eight inputs, K2's flags and inputs) of a
    ``NUTS_LANE_CASES`` case: a state near N(3, 1) with a diagonal mass
    matrix off the identity and steps U(step) for K1; ``draws`` warmup rows
    (at most 6) with estimator and mass-matrix updates and, from 4 rows on,
    a window switch, dual averaging from each chain's step for K2."""
    from nuts_rs_tpu_torch.adapt.step_size import StepSizeSettings
    from nuts_rs_tpu_torch.kernels.nuts import NutsOptions

    mu = 3.0
    model = tg.normal_logp(dim, mu)
    opts = NutsOptions(maxdepth=10, max_energy_error=max_err)
    rng = np.random.default_rng(dim)
    f = lambda x: torch.tensor(x, dtype=torch.float32, device=dev)  # noqa: E731
    q = f(mu + rng.normal(size=(C, dim)))
    logp, g = model.logp_and_grad(q)
    stds = f(rng.uniform(0.8, 1.2, size=(C, dim)))
    mean = f(mu + 0.1 * rng.normal(size=(C, dim)))
    logdet = -torch.log(stds).sum(1)
    steps = f(rng.uniform(*step, size=C))
    post = (q, g, logp, stds, mean, logdet, steps, steps.clone())
    rows = min(draws, 6)
    flags = torch.ones(rows, nf.NFLAGS, dtype=torch.int32, device=dev)
    flags[:, nf.FLAG_DO_SWITCH] = 0
    if rows > 3:
        flags[3, nf.FLAG_DO_SWITCH] = 1
    est = torch.zeros(C, 8, dim, device=dev)
    sca = torch.zeros(C, nf.NSCA, device=dev)
    sca[:, nf.SCA_STEP] = steps
    sca[:, nf.SCA_DA_LS] = sca[:, nf.SCA_DA_LSA] = torch.log(steps)
    sca[:, nf.SCA_DA_MU] = torch.log(10.0 * steps)
    sca[:, nf.SCA_DA_CNT] = 1.0
    sca[:, nf.SCA_LOGDET] = logdet
    warm = (flags, q, g, logp, stds, mean, est, sca, model, opts,
            StepSizeSettings(jitter=jitter))
    return model, opts, post, warm


def require_nuts_expect(stats, expect, what):
    """Raise unless the draws' trees grow (``require_growing_trees``) and,
    for "diverge", some draws diverged and some did not, for "maxdepth",
    some tree reached maxdepth."""
    require_growing_trees(stats, what)
    div = stats["diverging"].cpu().numpy() != 0
    if expect == "diverge":
        assert div.any() and not div.all(), \
            f"{what}: {div.mean():.0%} of draws diverged"
    if expect == "maxdepth":
        assert (stats["maxdepth_reached"].cpu().numpy() != 0).any(), \
            f"{what}: no tree reached maxdepth"


@pytest.mark.cuda
@pytest.mark.parametrize(
    "dim,B,C,jitter,use_grad_based,max_err,step,draws,expect",
    NUTS_LANE_CASES)
def test_nuts_lane_kernels_match_plain_versions_bit_for_bit(
        dim, B, C, jitter, use_grad_based, max_err, step, draws, expect):
    """K1 and K2 (a chain's coordinates on the lanes _build.nuts_lanes
    gives) against their plain versions: every integer stat equal and every
    float bit for bit, after the plain versions' draws showed the case's
    growing trees, divergences or maxdepth."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU build")
    from nuts_rs_tpu_torch.kernels import _build

    dev = torch.device("cuda", 0)
    model, opts, post, warm = nuts_lane_inputs(dim, C, jitter, max_err, step,
                                               draws, dev)
    T = _build.nuts_lanes(dim, B)
    assert T == 4 and B * T <= 512
    what = f"d={dim} B={B} T={T} jitter={jitter} max_err={max_err}"
    want = nf.nuts_fused_run_reference(3, *post, draws, model, opts, jitter,
                                       block=B)
    require_nuts_expect(want[4], expect, f"K1 {what}")
    before = dict(nf.LAUNCHES)
    got = nf.nuts_fused_run(3, *post, draws, model, opts, jitter, block=B)
    for name in INT_STATS:
        np.testing.assert_array_equal(got[4][name].cpu().numpy(),
                                      want[4][name].cpu().numpy(),
                                      err_msg=f"K1 {what} {name}")
    for i in range(4):
        _same_bits(got[i], want[i], f"K1 {what} output {i}")
    for name in nf.STAT_NAMES:
        _same_bits(got[4][name], want[4][name], f"K1 {what} {name}")

    wargs = (*warm, use_grad_based)
    want = nf.nuts_fused_warmup_run_reference(5, *wargs, block=B)
    require_nuts_expect(want[8], expect, f"K2 {what}")
    got = nf.nuts_fused_warmup_run(5, *wargs, block=B)
    for name in INT_STATS + ("transformation_index",):
        np.testing.assert_array_equal(got[8][name].cpu().numpy(),
                                      want[8][name].cpu().numpy(),
                                      err_msg=f"K2 {what} {name}")
    for i in range(8):
        _same_bits(got[i], want[i], f"K2 {what} output {i}")
    for name in nf.WARMUP_STAT_NAMES:
        _same_bits(got[8][name], want[8][name], f"K2 {what} {name}")
    for key in ("nuts_fused_posterior", "nuts_fused_warmup"):
        assert nf.LAUNCHES[key] == before[key] + 1, key


@pytest.mark.cuda
@pytest.mark.parametrize("dim", [3, 4, 6, 10])
def test_nuts_lane_rule_is_the_same_in_c(dim):
    """csrc/nuts_tree.cuh::nuts_lanes gives the lanes _build.nuts_lanes
    gives at every block of 1 .. 128 chains, in both libraries."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU build")
    from nuts_rs_tpu_torch.kernels import _build

    for stem in ("nuts_fused_posterior", "nuts_fused_warmup"):
        lib = _build.library(stem)
        for B in range(1, _build.MAX_BLOCK + 1):
            assert lib.nrt_nuts_lanes(dim, B) == _build.nuts_lanes(dim, B), \
                (stem, B)


@pytest.mark.cuda
@pytest.mark.parametrize("dim,rows,block,micro,max_err,dynamic", [
    (37, 300, 8, True, 1000.0, True),
    (37, 300, 1, False, 1000.0, True),
    (5, 70, 4, True, 0.5, True),
    (5, 70, 4, False, 0.05, False),
    (150, 1001, 8, True, 2.0, True),
    (150, 1001, 2, False, 1000.0, False),
    (100, 0, 8, True, 1000.0, True),
    (12, 0, 4, False, 0.02, True),
])
def test_mclmc_mid_kernels_match_plain_versions_on_the_card(
        dim, rows, block, micro, max_err, dynamic):
    """K3-args and K4-args on logistic regression (``rows`` > 0) or, without
    data, on the iid normal at a d above the thread-per-chain sizes: both
    kinetic energies, halvings and give-ups under a small
    ``max_energy_error``, C = 16 chains in logical blocks of ``block``
    (clusters).  Same sum orders, so floats agree to rounding of the
    library functions (exp, log, cos) alone."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU build")
    from nuts_rs_tpu_torch.adapt.step_size import StepSizeMethod
    from nuts_rs_tpu_torch.dynamics.hamiltonian import KineticKind
    from nuts_rs_tpu_torch.kernels import mclmc_fused as mf
    from nuts_rs_tpu_torch.kernels.mclmc import MclmcOptions

    dev = torch.device("cuda", 0)
    C = 16
    rng = np.random.default_rng(dim + rows)
    f = lambda x: torch.tensor(x, dtype=torch.float32, device=dev)  # noqa: E731
    if rows:
        model = tg.logistic_regression(rows, dim, 3).to(dev)
        q = f(0.2 * rng.normal(size=(C, dim)))
        stds = f(rng.uniform(0.05, 0.15, size=(C, dim)))
        mean = f(0.02 * rng.normal(size=(C, dim)))
    else:
        model = tg.normal_logp(dim, 0.5)
        q = f(0.5 + rng.normal(size=(C, dim)))
        stds = f(rng.uniform(0.7, 1.3, size=(C, dim)))
        mean = torch.zeros_like(q)
    assert nf.cl_kernel(model, dim) == "mid"
    logp, g = model.logp_and_grad(q)
    v = rng.normal(size=(C, dim))
    v = f(v / np.linalg.norm(v, axis=1, keepdims=True))
    logdet = -torch.log(stds).sum(1)
    kind = KineticKind.MICROCANONICAL if micro else KineticKind.EUCLIDEAN
    mopts = MclmcOptions(kind=kind, max_energy_error=max_err,
                         dynamic_step_size=dynamic)
    step = torch.full((C,), 0.9, device=dev)
    args = (q, g, logp, v, stds, mean, logdet, step, step.clone())
    before = dict(mf.LAUNCHES)
    got = mf.mclmc_fused_run(3, *args, 8, model, mopts, 0.1, block=block)
    torch.cuda.synchronize()
    want = mf.mclmc_fused_run_reference(3, *args, 8, model, mopts, 0.1,
                                        block=block)
    for name in MCLMC_INT_STATS:
        np.testing.assert_array_equal(got[5][name].cpu().numpy(),
                                      want[5][name].cpu().numpy(), name)
    assert got[4].shape == (C, 8, dim)
    for i in range(5):
        _close(got[i].cpu(), want[i].cpu(), str(i), 1e-5, 1e-6)
    for name in mf.STAT_NAMES:
        _close(got[5][name].cpu(), want[5][name].cpu(), name, 1e-5, 1e-5)
    if max_err < 1.0:  # the case exercises halvings or give-ups
        st = want[5]
        assert bool((st["diverging"] > 0).any()) or bool(
            (st["average_step_size"] < st["step_size"] * 0.99).any())

    flags = torch.zeros(6, mf.NFLAGS, dtype=torch.int32, device=dev)
    flags[:, mf.FLAG_UPDATE_EST] = 1
    flags[0, mf.FLAG_RESAMPLE] = flags[4, mf.FLAG_RESAMPLE] = 1
    flags[2:, mf.FLAG_DO_UPDATE] = 1
    flags[3, mf.FLAG_DO_SWITCH] = 1
    est = torch.zeros(C, 8, dim, device=dev)
    sca = torch.zeros(C, mf.NSCA, device=dev)
    sca[:, mf.SCA_LOGDET] = logdet
    sset = StepSizeSettings(method=StepSizeMethod.FIXED, fixed_value=0.7)
    wargs = (flags, q, g, logp, v, stds, mean, est, sca, model, mopts, sset,
             True)
    got = mf.mclmc_fused_warmup_run(5, *wargs, block=block)
    torch.cuda.synchronize()
    want = mf.mclmc_fused_warmup_run_reference(5, *wargs, block=block)
    for name in MCLMC_INT_STATS + ("transformation_index",):
        np.testing.assert_array_equal(got[9][name].cpu().numpy(),
                                      want[9][name].cpu().numpy(), name)
    for i in range(9):
        _close(got[i].cpu(), want[i].cpu(), str(i), 1e-5, 1e-6)
    for name in mf.WARMUP_STAT_NAMES:
        _close(got[9][name].cpu(), want[9][name].cpu(), name, 1e-5, 1e-5)
    assert mf.LAUNCHES["mclmc_fused_mid_posterior"] == \
        before["mclmc_fused_mid_posterior"] + 1
    assert mf.LAUNCHES["mclmc_fused_mid_warmup"] == \
        before["mclmc_fused_mid_warmup"] + 1
    assert mf.LAUNCHES["mclmc_fused_posterior"] == \
        before["mclmc_fused_posterior"]
    # a chain block above the cluster size is refused, not run another way
    with pytest.raises(ValueError, match="chain block"):
        mf.mclmc_fused_run(3, *args, 8, model, mopts, 0.1, block=16)


@pytest.mark.cuda
@pytest.mark.parametrize("name,C,B,micro,max_err,dynamic,jitter", [
    ("glm", 1024, 1, True, 1000.0, True, 0.1),
    ("glm", 20, 2, True, 0.05, True, 0.1),
    ("glm", 64, 8, True, 0.5, False, None),
    ("glm300", 64, 4, True, 0.5, True, 0.1),
    ("glm_g2", 64, 2, True, 1000.0, True, 0.1),
    ("glm_g1", 20, 1, True, 0.5, True, 0.1),
    ("glm", 20, 2, False, 0.05, True, 0.1),
    ("radon", 100, 4, True, 0.5, True, 0.1),
    ("normal100", 256, 2, False, 0.05, True, None),
    ("funnel", 64, 4, True, 0.5, True, 0.1)])
def test_mclmc_mid_group_kernels_match_plain_versions_bit_for_bit(
        name, C, B, micro, max_err, dynamic, jitter):
    """K3-args and K4-args in the form the table gives
    (``_build.MCLMC_MID_FORMS``) against their unchanged plain versions:
    every integer stat equal and every float bit for bit.  The group form
    (the regression's microcanonical draws) at G = 8 (d = 100), 4 (d = 300),
    2 and 1 (residuals filling the shared memory), in logical blocks of
    B = 1, 2, 4, 8, with halvings and give-ups under a small
    ``max_energy_error``, with and without jitter and the dynamic step size,
    at chain counts that leave the last CUDA block partly empty (20); the
    256-threads-a-chain form on the regression's Euclidean draws, radon, the
    iid normal and the funnel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU build")
    from nuts_rs_tpu_torch.adapt.step_size import StepSizeMethod
    from nuts_rs_tpu_torch.dynamics.hamiltonian import KineticKind
    from nuts_rs_tpu_torch.kernels import _build
    from nuts_rs_tpu_torch.kernels import mclmc_fused as mf
    from nuts_rs_tpu_torch.kernels.mclmc import MclmcOptions

    dev = torch.device("cuda", 0)
    model, _, (q, g, logp, stds, mean, logdet, step, _) = _group_case(
        name, dev, C)
    d = model.dim
    assert nf.cl_kernel(model, d) == "mid"
    rng = np.random.default_rng(C + d)
    v = rng.normal(size=(C, d))
    v = torch.tensor(v / np.linalg.norm(v, axis=1, keepdims=True),
                     dtype=torch.float32, device=dev)
    kind = KineticKind.MICROCANONICAL if micro else KineticKind.EUCLIDEAN
    mopts = MclmcOptions(kind=kind, max_energy_error=max_err,
                         dynamic_step_size=dynamic)
    form = _build.mclmc_mid_form(model, mopts)
    assert (form == "group") == (name.startswith("glm") and micro)
    if form == "group":
        G = _build.mclmc_mid_group_for(d, model, B)
        print(f"{name}: d={d} C={C} B={B} G={G}, "
              f"{_build.mclmc_mid_blocks_per_sm('posterior', model, G)} "
              "blocks an SM")
    args = (q, g, logp, v, stds, mean, logdet, step, step.clone())
    before = dict(mf.LAUNCHES)
    got = mf.mclmc_fused_run(3, *args, 8, model, mopts, jitter, block=B)
    torch.cuda.synchronize()
    want = mf.mclmc_fused_run_reference(3, *args, 8, model, mopts, jitter,
                                        block=B)
    for i, what in enumerate(("q_f", "g_f", "logp_f", "v_f", "draws")):
        _same_bits(got[i], want[i], what)
    for stat in list(mf.STAT_NAMES) + ["loop_iterations"]:
        _same_bits(got[5][stat], want[5][stat], stat)
    if max_err < 1.0:  # the case exercises halvings or give-ups
        st = want[5]
        assert bool((st["diverging"] > 0).any()) or bool(
            (st["average_step_size"] < st["step_size"] * 0.99).any())

    flags = torch.zeros(6, mf.NFLAGS, dtype=torch.int32, device=dev)
    flags[:, mf.FLAG_UPDATE_EST] = 1
    flags[0, mf.FLAG_RESAMPLE] = flags[4, mf.FLAG_RESAMPLE] = 1
    flags[2:, mf.FLAG_DO_UPDATE] = 1
    flags[3, mf.FLAG_DO_SWITCH] = 1
    est = torch.zeros(C, 8, d, device=dev)
    sca = torch.zeros(C, mf.NSCA, device=dev)
    sca[:, mf.SCA_LOGDET] = logdet
    sset = StepSizeSettings(method=StepSizeMethod.FIXED,
                            fixed_value=float(step[0]), jitter=jitter)
    wargs = (flags, q, g, logp, v, stds, mean, est, sca, model, mopts, sset,
             True)
    got = mf.mclmc_fused_warmup_run(5, *wargs, block=B)
    torch.cuda.synchronize()
    want = mf.mclmc_fused_warmup_run_reference(5, *wargs, block=B)
    for i, what in enumerate(("q", "g", "logp", "v", "stds", "mean", "est",
                              "sca", "draws")):
        _same_bits(got[i], want[i], what)
    for stat in list(mf.WARMUP_STAT_NAMES) + ["loop_iterations"]:
        _same_bits(got[9][stat], want[9][stat], stat)
    for which in ("posterior", "warmup"):
        key = f"mclmc_fused_mid_{which}"
        assert mf.LAUNCHES[key] == before[key] + 1, key


@pytest.mark.cuda
def test_normal_100_runs_mclmc_end_to_end_on_the_card():
    """MCLMC at a d between the thread-per-chain instances and the fused
    MCLMC limit (d = 11..361 used to raise at construction on the card) runs
    warmup and posterior on the mid-d MCLMC kernels."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU build")
    import nuts_rs_tpu_torch as tnt
    from nuts_rs_tpu_torch.kernels import mclmc_fused as mf

    before = dict(mf.LAUNCHES)
    trace = tnt.sample(tg.normal_logp(100, 3.0), tnt.DiagMclmcSettings(
        num_chains=64, num_tune=200, num_draws=200, seed=0,
        posterior_kernel="pallas"), device="cuda")
    pos = trace.posterior["position"].astype(np.float64)
    assert pos.shape == (64, 200, 100)
    assert abs(pos.mean() - 3.0) < 0.03
    assert abs(pos.std() - 1.0) < 0.05
    assert not trace.sample_stats["diverging"].any()
    assert 5.5 < trace.sample_stats["n_steps"].mean() < 6.7
    assert mf.LAUNCHES["mclmc_fused_mid_posterior"] > \
        before["mclmc_fused_mid_posterior"]
    assert mf.LAUNCHES["mclmc_fused_mid_warmup"] > \
        before["mclmc_fused_mid_warmup"]
    assert mf.LAUNCHES["mclmc_fused_posterior"] == \
        before["mclmc_fused_posterior"]


@pytest.mark.cuda
@pytest.mark.parametrize("rows,dim,tile,C,block,ranges,maxdepth", [
    (36, 4, 8, 16, None, None, 6), (1001, 11, 64, 16, 4, 3, 6),
    (5000, 37, 512, 16, 8, None, 8), (300, 5, 512, 16, None, None, 5),
    (5000, 37, 512, 256, None, 7, 8), (2000, 20, 128, 512, None, None, 6),
    (2000, 130, 512, 256, None, None, 5),
    (2000, 125, 512, 256, None, None, 5)])
def test_stream_kernel_matches_plain_version_on_the_card(rows, dim, tile, C,
                                                         block, ranges,
                                                         maxdepth):
    """K1-stream at other sizes than the main path's, bit for bit: several
    tiles with a ragged last one (1001 rows in tiles of 64, 36 in tiles of
    8), one tile larger than the data, ranges that do not divide the tiles
    (3 of 16, 7 of 10), 16 chains in one logical block (the JAX runner's
    pick) or in blocks of 4 and 8, 256 chains in one block and 512 in two
    (the JAX runner's 256: two CUDA blocks an SM), and 256 chains in one
    block at maxdepth 5 and d = 130 and 125, where the sub-tile is sized for
    two blocks an SM (at d = 125 the rule of one block's opt-in gave 117,316
    bytes a block, and the launch was refused)."""
    import dataclasses

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU build")
    dev = torch.device("cuda", 0)
    # (Model.to rebuilds the model with its own tile, so the tile goes last)
    model = dataclasses.replace(tg.logistic_regression(rows, dim, 3).to(dev),
                                stream_tile_rows=tile)
    opts = NutsOptions(maxdepth=maxdepth)
    rng = np.random.default_rng(rows)
    f = lambda x: torch.tensor(x, dtype=torch.float32, device=dev)  # noqa: E731
    q = f(0.2 * rng.normal(size=(C, dim)))
    logp, g = model.logp_and_grad(q)
    stds = f(rng.uniform(0.05, 0.15, size=(C, dim)))
    mean = f(0.02 * rng.normal(size=(C, dim)))
    logdet = -torch.log(stds).sum(1)
    step = torch.full((C,), 0.4, device=dev)
    args = (q, g, logp, stds, mean, logdet, step, step.clone())
    before = dict(nf.LAUNCHES)
    got = nf.nuts_fused_run(3, *args, 8, model, opts, 0.1, block=block,
                            stream=True, ranges=ranges)
    torch.cuda.synchronize()
    want = nf.nuts_fused_run_reference(3, *args, 8, model, opts, 0.1,
                                       block=block, stream=True,
                                       ranges=ranges)
    assert nf.LAUNCHES["nuts_fused_stream_posterior"] \
        == before["nuts_fused_stream_posterior"] + 1
    for name in INT_STATS:
        np.testing.assert_array_equal(got[4][name].cpu().numpy(),
                                      want[4][name].cpu().numpy(), name)
    assert got[3].shape == (C, 8, dim)
    for i in range(4):
        np.testing.assert_array_equal(got[i].cpu().numpy(),
                                      want[i].cpu().numpy(), str(i))
    for name in nf.STAT_NAMES:
        np.testing.assert_array_equal(got[4][name].cpu().numpy(),
                                      want[4][name].cpu().numpy(), name)
    bad = list(args)
    bad[0] = q.T.contiguous().T
    with pytest.raises(ValueError, match="contiguous"):
        nf.nuts_fused_run(3, *bad, 8, model, opts, 0.1, stream=True)


@pytest.mark.cuda
def test_stream_kernel_refuses_a_block_that_cannot_be_resident():
    """1024 chains forced into one logical block: the card holds two CUDA
    blocks an SM (264 chains), so the launch is refused with CUDA's error
    and nothing runs (no retreat to a smaller block or to the plain
    version)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU build")
    dev = torch.device("cuda", 0)
    C, dim = 1024, 20
    model = tg.logistic_regression(2000, dim, 3).to(dev)
    q = torch.zeros(C, dim, device=dev)
    logp, g = model.logp_and_grad(q)
    ones = torch.ones(C, dim, device=dev)
    step = torch.full((C,), 0.4, device=dev)
    args = (q, g, logp, ones, 0 * ones, torch.zeros(C, device=dev), step,
            step.clone())
    before = dict(nf.LAUNCHES)
    with pytest.raises(RuntimeError, match="cooperative"):
        nf.nuts_fused_run(3, *args, 8, model, NutsOptions(maxdepth=6), 0.1,
                          block=C, stream=True)
    torch.cuda.synchronize()
    assert nf.LAUNCHES == before


@pytest.mark.cuda
def test_stream_residency_is_checked_before_the_warmup(monkeypatch):
    """The card holds a logical block of 256 chains at d = 125, maxdepth 5;
    a block it cannot hold (1024 chains forced as the JAX runner's pick) is
    refused when the Sampler is built, naming the numbers, before any
    warmup draw (NotImplementedError is a RuntimeError)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU build")
    import nuts_rs_tpu_torch as tnt
    from nuts_rs_tpu_torch import sampler as tsampler
    from nuts_rs_tpu_torch.kernels import _build

    assert _build.stream_resident_blocks(125, 256, 5) >= 256
    _build.check_stream_resident(125, 256, 5)
    model = tg.logistic_regression(131072, 125, 3)
    settings = tnt.DiagNutsSettings(posterior_kernel="pallas", maxdepth=5,
                                    num_chains=1024, num_tune=4,
                                    num_draws=4)
    monkeypatch.setattr(tsampler, "stream_block", lambda *a: 1024)
    before = dict(nf.LAUNCHES)
    # (the sub-tile rule refuses it first: eight blocks an SM leave each
    # 28,160 bytes)
    with pytest.raises(RuntimeError, match="logical block of 1024 chains"):
        tnt.Sampler(model, settings, device="cuda")
    assert nf.LAUNCHES == before


@pytest.mark.cuda
def test_sync_engine_on_the_card_matches_the_cpu():
    """The sync NUTS engine draws from the counter hash, so the same seed
    gives the same trees on the card as on the CPU: integer stats equal,
    positions to float32 rounding."""
    from nuts_rs_tpu_torch.dynamics.hamiltonian import init_point_from_q
    from nuts_rs_tpu_torch.kernels.nuts import nuts_draw
    from nuts_rs_tpu_torch.transform.affine import identity_transform

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    model, C, dim = tg.normal_logp(6, 0.5), 16, 6
    opts = NutsOptions(maxdepth=8)
    q0 = torch.tensor(np.random.default_rng(4).normal(size=(C, dim)),
                      dtype=torch.float32)
    results = {}
    for dev in ("cpu", "cuda"):
        t = identity_transform(C, dim, torch.float32, dev)
        pt = init_point_from_q(q0.to(dev), t, model.logp_and_grad)
        step = torch.full((C,), 0.45, device=dev)
        out = []
        for draw in range(4):
            pt, info = nuts_draw(100 + draw, pt, t, step,
                                 model.logp_and_grad, opts)
            out.append((pt.q.cpu().numpy(), info))
        results[dev] = out
    for (q_c, i_c), (q_g, i_g) in zip(results["cpu"], results["cuda"]):
        for name in ("depth", "n_steps", "idx_in_trajectory", "diverging",
                     "turning", "reached_maxdepth"):
            np.testing.assert_array_equal(getattr(i_c, name).numpy(),
                                          getattr(i_g, name).cpu().numpy(),
                                          name)
        _close(q_g, q_c, "position", 1e-4, 1e-5)
        _close(i_g.sum_accept.cpu(), i_c.sum_accept, "sum_accept", 1e-4,
               1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dim", [5, 10])
def test_small_sizes_without_an_instance_run_on_the_card(dim):
    """d = 5, and d = 10 at maxdepth 8, have no thread-per-chain instance and
    used to raise on CUDA; the mid-d kernels serve them, NUTS and MCLMC."""
    import nuts_rs_tpu_torch as nt

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU build")
    model = tg.normal_logp(dim, 3.0)
    kw = dict(num_chains=64, num_tune=150, num_draws=150,
              posterior_kernel="pallas")
    before = dict(nf.LAUNCHES)
    trace = nt.sample(model, nt.DiagNutsSettings(maxdepth=8, **kw),
                      device="cuda")
    assert nf.LAUNCHES["nuts_fused_mid_posterior"] \
        > before["nuts_fused_mid_posterior"]
    assert nf.LAUNCHES["nuts_fused_posterior"] \
        == before["nuts_fused_posterior"]
    pos = trace.posterior["position"]
    assert abs(pos.mean() - 3.0) < 0.05 and abs(pos.std() - 1.0) < 0.08
    assert not trace.sample_stats["diverging"].any()
    if dim == 5:
        trace = nt.sample(model, nt.DiagMclmcSettings(**kw), device="cuda")
        pos = trace.posterior["position"]
        assert abs(pos.mean() - 3.0) < 0.05 and abs(pos.std() - 1.0) < 0.08


def _hook_case(name, dev, C, seed):
    """(model, q, g, logp, stds) of a model of the zoo, at a state near its
    posterior, on ``dev``."""
    from nuts_rs_tpu_torch.models import hierarchical as th
    from nuts_rs_tpu_torch.models import stochastic_volatility as ts

    rng = np.random.default_rng(seed)
    if name == "rank1":
        model = tg.correlated_normal_rank1(20)
        center, sd = np.zeros(20), np.full(20, 1.2)
    elif name == "radon":
        model = th.radon(J=10, n_per=3, seed=seed)
        center = np.r_[1.5, -0.7, np.log(0.8), np.log(0.3), np.zeros(10)]
        sd = np.r_[0.1, 0.1, 0.1, 0.3, np.full(10, 0.8)]
    elif name.startswith("sv"):
        T = 300 if name == "sv_ld" else 30
        model = ts.stochastic_volatility(T=T, seed=seed)
        center = np.r_[np.log(0.1), np.log(8.0), np.zeros(T)]
        sd = np.r_[0.2, 0.4, np.full(T, 0.8)]
    elif name == "funnel":
        model = tg.funnel(12)
        center, sd = np.zeros(12), np.full(12, 0.8)
    else:
        model = tg.correlated_normal(12)
        center, sd = np.zeros(12), np.full(12, 1.0)
    model = model.to(dev)
    f = lambda x: torch.tensor(x, dtype=torch.float32, device=dev)  # noqa: E731
    q = f(center + sd * rng.normal(size=(C, model.dim)))
    logp, g = model.logp_and_grad(q)
    stds = f(sd * rng.uniform(0.7, 1.3, size=(C, model.dim)))
    return model, q, g, logp, stds


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["rank1", "radon", "sv", "funnel",
                                  "correlated_normal", "sv_ld"])
def test_model_functors_match_plain_versions_on_the_card(name):
    """Each functor of the model zoo on the mid-d kernels K1-args and
    K2-args (NUTS) and K3-args and K4-args (MCLMC), and stochastic
    volatility at T = 300 (d = 302, ``sv_ld``) on the dim-on-lanes kernels
    with data K1-ld-args and K2-ld-args, against the plain versions: C = 16
    chains in logical blocks of 4, maxdepth 6."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU build")
    from nuts_rs_tpu_torch.adapt.step_size import StepSizeMethod
    from nuts_rs_tpu_torch.dynamics.hamiltonian import KineticKind
    from nuts_rs_tpu_torch.kernels import mclmc_fused as mf
    from nuts_rs_tpu_torch.kernels.mclmc import MclmcOptions

    dev = torch.device("cuda", 0)
    C, B = 16, 4
    model, q, g, logp, stds = _hook_case(name, dev, C, 2)
    layout = "ld" if name == "sv_ld" else "cl"
    kind = "ld_args" if layout == "ld" else "mid"
    assert nf._kernel_kind(model, model.dim, layout, 6) == kind
    opts = NutsOptions(maxdepth=6)
    mean = q.mean(0, keepdim=True).expand_as(q).contiguous()
    logdet = -torch.log(stds).sum(1)
    step = torch.full((C,), 0.15 if layout == "ld" else 0.3, device=dev)
    args = (q, g, logp, stds, mean, logdet, step, step.clone())
    before = dict(nf.LAUNCHES)
    got = nf.nuts_fused_run(3, *args, 6, model, opts, 0.1, block=B,
                            layout=layout)
    torch.cuda.synchronize()
    want = nf.nuts_fused_run_reference(3, *args, 6, model, opts, 0.1,
                                       block=B, layout=layout)
    for stat in INT_STATS:
        np.testing.assert_array_equal(got[4][stat].cpu().numpy(),
                                      want[4][stat].cpu().numpy(), stat)
    for i in range(4):
        _close(got[i].cpu(), want[i].cpu(), str(i), 1e-5, 1e-5)

    flags = torch.ones(5, nf.NFLAGS, dtype=torch.int32, device=dev)
    flags[:, nf.FLAG_DO_SWITCH] = 0
    flags[3, nf.FLAG_DO_SWITCH] = 1
    est = torch.zeros(C, 8, model.dim, device=dev)
    sca = torch.zeros(C, nf.NSCA, device=dev)
    sca[:, nf.SCA_STEP] = 0.3
    sca[:, nf.SCA_DA_CNT] = 1.0
    sca[:, nf.SCA_DA_MU] = float(np.log(3.0))
    sca[:, nf.SCA_LOGDET] = logdet
    wargs = (flags, q, g, logp, stds, mean, est, sca, model, opts,
             StepSizeSettings(), True)
    got = nf.nuts_fused_warmup_run(5, *wargs, block=B, layout=layout)
    torch.cuda.synchronize()
    want = nf.nuts_fused_warmup_run_reference(5, *wargs, block=B,
                                              layout=layout)
    for stat in INT_STATS + ("transformation_index",):
        np.testing.assert_array_equal(got[8][stat].cpu().numpy(),
                                      want[8][stat].cpu().numpy(), stat)
    for i in range(8):
        _close(got[i].cpu(), want[i].cpu(), str(i), 1e-5, 1e-5)
    for which in ("posterior", "warmup"):
        key = f"nuts_fused_{kind}_{which}"
        assert nf.LAUNCHES[key] == before[key] + 1, key
    if layout == "ld":
        return

    mopts = MclmcOptions(kind=KineticKind.MICROCANONICAL,
                         max_energy_error=1000.0, dynamic_step_size=True)
    rng = np.random.default_rng(5)
    v = rng.normal(size=(C, model.dim))
    v = torch.tensor(v / np.linalg.norm(v, axis=1, keepdims=True),
                     dtype=torch.float32, device=dev)
    margs = (q, g, logp, v, stds, mean, logdet, step, step.clone())
    mbefore = dict(mf.LAUNCHES)
    got = mf.mclmc_fused_run(3, *margs, 6, model, mopts, 0.1, block=B)
    torch.cuda.synchronize()
    want = mf.mclmc_fused_run_reference(3, *margs, 6, model, mopts, 0.1,
                                        block=B)
    for stat in MCLMC_INT_STATS:
        np.testing.assert_array_equal(got[5][stat].cpu().numpy(),
                                      want[5][stat].cpu().numpy(), stat)
    for i in range(5):
        _close(got[i].cpu(), want[i].cpu(), str(i), 1e-5, 1e-5)
    mflags = torch.zeros(5, mf.NFLAGS, dtype=torch.int32, device=dev)
    mflags[:, mf.FLAG_UPDATE_EST] = 1
    mflags[0, mf.FLAG_RESAMPLE] = 1
    mflags[2:, mf.FLAG_DO_UPDATE] = 1
    mest = torch.zeros(C, 8, model.dim, device=dev)
    msca = torch.zeros(C, mf.NSCA, device=dev)
    msca[:, mf.SCA_LOGDET] = logdet
    sset = StepSizeSettings(method=StepSizeMethod.FIXED, fixed_value=0.3)
    wargs = (mflags, q, g, logp, v, stds, mean, mest, msca, model, mopts,
             sset, True)
    got = mf.mclmc_fused_warmup_run(5, *wargs, block=B)
    torch.cuda.synchronize()
    want = mf.mclmc_fused_warmup_run_reference(5, *wargs, block=B)
    for stat in MCLMC_INT_STATS + ("transformation_index",):
        np.testing.assert_array_equal(got[9][stat].cpu().numpy(),
                                      want[9][stat].cpu().numpy(), stat)
    for i in range(9):
        _close(got[i].cpu(), want[i].cpu(), str(i), 1e-5, 1e-5)
    for which in ("posterior", "warmup"):
        key = f"mclmc_fused_mid_{which}"
        assert mf.LAUNCHES[key] == mbefore[key] + 1, key


@pytest.mark.cuda
@pytest.mark.parametrize("C", [300, 264])
def test_sv_ld_args_kernels_match_plain_versions_at_t1000(C):
    """K1-ld-args and K2-ld-args on stochastic volatility at T = 1000
    (d = 1002, the SV path's model, the functor's fused form) with two
    chain blocks an SM resident (264 chains at once), at 300 chains (not a
    multiple of 264: a second, partial round) and at 264, against their
    plain versions: every integer stat equal and every float bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU build")
    from nuts_rs_tpu_torch.kernels import _build
    from nuts_rs_tpu_torch.models import stochastic_volatility as ts

    dev = torch.device("cuda", 0)
    model = ts.stochastic_volatility(T=1000, seed=0).to(dev)
    opts = NutsOptions(maxdepth=10)
    for kind in ("posterior", "warmup"):
        assert _build.ld_args_blocks_per_sm(kind, model, 10) == 2, kind
    rng = np.random.default_rng(C)
    f = lambda x: torch.tensor(x, dtype=torch.float32, device=dev)  # noqa: E731
    centre = np.r_[np.log(0.1), np.log(8.0), np.zeros(1000)]
    sd = np.r_[0.2, 0.4, np.full(1000, 0.8)]
    q = f(centre + sd * rng.normal(size=(C, 1002)))
    logp, g = model.logp_and_grad(q)
    stds = f(sd * rng.uniform(0.7, 1.3, size=(C, 1002)))
    mean = q.mean(0, keepdim=True).expand_as(q).contiguous()
    logdet = -torch.log(stds).sum(1)
    step = f(rng.uniform(0.04, 0.06, size=C))
    args = (q, g, logp, stds, mean, logdet, step, step.clone())
    before = dict(nf.LAUNCHES)
    got = nf.nuts_fused_run(3, *args, 4, model, opts, 0.1, layout="ld")
    torch.cuda.synchronize()
    want = nf.nuts_fused_run_reference(3, *args, 4, model, opts, 0.1,
                                       layout="ld")
    for stat in INT_STATS:
        np.testing.assert_array_equal(got[4][stat].cpu().numpy(),
                                      want[4][stat].cpu().numpy(), stat)
    for i in range(4):
        np.testing.assert_array_equal(got[i].cpu().numpy(),
                                      want[i].cpu().numpy(), str(i))
    for stat in nf.STAT_NAMES:
        np.testing.assert_array_equal(got[4][stat].cpu().numpy(),
                                      want[4][stat].cpu().numpy(), stat)

    flags = torch.ones(3, nf.NFLAGS, dtype=torch.int32, device=dev)
    flags[:, nf.FLAG_DO_SWITCH] = 0
    flags[1, nf.FLAG_DO_SWITCH] = 1
    est = torch.zeros(C, 8, 1002, device=dev)
    sca = torch.zeros(C, nf.NSCA, device=dev)
    sca[:, nf.SCA_STEP] = step
    sca[:, nf.SCA_DA_CNT] = 1.0
    sca[:, nf.SCA_DA_MU] = float(np.log(0.5))
    sca[:, nf.SCA_LOGDET] = logdet
    wargs = (flags, q, g, logp, stds, mean, est, sca, model, opts,
             StepSizeSettings(), True)
    got = nf.nuts_fused_warmup_run(5, *wargs, layout="ld")
    torch.cuda.synchronize()
    want = nf.nuts_fused_warmup_run_reference(5, *wargs, layout="ld")
    for stat in INT_STATS + ("transformation_index",):
        np.testing.assert_array_equal(got[8][stat].cpu().numpy(),
                                      want[8][stat].cpu().numpy(), stat)
    for i in range(8):
        np.testing.assert_array_equal(got[i].cpu().numpy(),
                                      want[i].cpu().numpy(), str(i))
    for which in ("posterior", "warmup"):
        key = f"nuts_fused_ld_args_{which}"
        assert nf.LAUNCHES[key] == before[key] + 1, key


def _perturbed_packed_flow(d, layers, hidden, scale, seed, dev):
    """A coupling flow's packed parameters moved off the identity map: the
    init at a random start, every net weight and bias plus N(0, scale^2)
    (a numpy generator, so that no JAX is needed)."""
    from nuts_rs_tpu_torch.flows.coupling import (
        CouplingFlowConfig,
        coupling_flow,
        tree_map,
    )

    spec = coupling_flow(CouplingFlowConfig(num_layers=layers,
                                            hidden=hidden))
    rng = np.random.default_rng(seed)
    q0 = torch.tensor(rng.normal(size=(1, d)), dtype=torch.float32)
    params = tree_map(lambda v: v[0], spec.init(seed, d, q0, -q0 - 0.5))
    for layer in params["layers"]:
        for k, v in layer["net"].items():
            layer["net"][k] = v + torch.tensor(
                scale * rng.normal(size=tuple(v.shape)), dtype=torch.float32)
    return spec.kernel_pack(tree_map(lambda v: v.to(dev), params))


# Inputs under which K1-flow's trees grow (no draw diverges at its first
# leapfrog, as every draw does under the recipe above at d >= 17): a flow
# moved N(0, 0.05^2) off the identity and steps U(0.05, 0.1).  The plain
# version on the CPU holds each case to depth > 0 somewhere and not every
# draw divergent (tests/test_torch_card_inputs.py), and so does the card
# test before it compares.
FLOW_GROW_SCALE, FLOW_GROW_STEP = 0.05, (0.05, 0.1)
FLOW_GROW_CASES = [  # (dim, layers, hidden, C, K, block, form)
    (33, 4, 33, 8, 2, 1, "today"), (160, 4, 32, 8, 2, 1, "today"),
    (32, 4, 32, 8, 2, 1, "warp"), (17, 2, 32, 8, 4, 2, "warp")]


def flow_case_inputs(dim, layers, hidden, C, grow, dev):
    """(funnel model, packed flow, K1-flow's eight posterior inputs) of a
    card case: a flow off the identity, z = 0.8 N(0, 1), unit mass matrix;
    with ``grow`` the inputs of ``FLOW_GROW_CASES``."""
    model = tg.funnel(dim).to(dev)
    scale, steps = (FLOW_GROW_SCALE, FLOW_GROW_STEP) if grow else \
        (0.2, (0.2, 0.4))
    packed = _perturbed_packed_flow(dim, layers, hidden, scale, 7, dev)
    rng = np.random.default_rng(1)
    z = torch.tensor(0.8 * rng.normal(size=(C, dim)), dtype=torch.float32,
                     device=dev)
    ones, zeros = torch.ones_like(z), torch.zeros_like(z)
    zc = torch.zeros(C, device=dev)
    step = torch.tensor(rng.uniform(*steps, size=C), dtype=torch.float32,
                        device=dev)
    return model, packed, (z, zeros, zc, ones, zeros, zc, step, step.clone())


def require_growing_trees(stats, what):
    """Raise unless some tree grew past depth 0 and not every draw
    diverged: a comparison of draws that all diverge at their first
    leapfrog checks no tree."""
    depth = stats["depth"].cpu().numpy()
    div = stats["diverging"].cpu().numpy()
    assert depth.max() > 0, f"{what}: every tree stopped at depth 0"
    assert not div.all(), f"{what}: every draw diverged"


@pytest.mark.cuda
@pytest.mark.parametrize("dim,layers,hidden,C,K,block,jitter,form,grow", [
    (10, 4, 32, 64, 8, 1, 0.1, "warp", False),
    (10, 4, 32, 64, 8, 4, None, "warp", False),
    (160, 4, 32, 8, 4, 1, 0.1, "today", False),
    # the warp form's edges: d = H = 32, sums over d of 32 at d = 17, one
    # layer, d and H below a chunk of 4, clusters of 8, two chain blocks an
    # SM (264 chains); today's form just past them (parameters in shared
    # memory)
    (32, 4, 32, 32, 8, 1, 0.1, "warp", False),
    (17, 2, 32, 32, 8, 2, 0.1, "warp", False),
    (10, 1, 32, 32, 8, 1, None, "warp", False),
    (7, 3, 5, 32, 8, 1, 0.1, "warp", False),
    (10, 4, 32, 64, 8, 8, 0.1, "warp", False),
    (10, 4, 32, 264, 2, 1, 0.1, "warp", False),
    (33, 4, 33, 16, 4, 1, 0.1, "today", False),
    (33, 2, 32, 16, 4, 1, 0.1, "today", False),
    (10, 2, 33, 16, 4, 1, 0.1, "today", False),
    # trees that grow, in both forms and at the warp form's edges
    *((d, L, H, C, K, B, 0.1, form, True)
      for d, L, H, C, K, B, form in FLOW_GROW_CASES)])
def test_flow_kernel_matches_plain_version_on_the_card(dim, layers, hidden,
                                                        C, K, block, jitter,
                                                        form, grow):
    """K1-flow against its plain version on the funnel: in the warp form
    (d <= 32 and H <= 32, two chain blocks an SM) and in today's, with its
    parameters in shared memory (d = 33 or H = 33) and read through L2
    (d = 160, 255 KB of them), blocks of 1, 2, 4 and 8; max abs err 0 and
    every integer stat equal.  With ``grow`` the trees grow (up to depth
    8), which the plain version's stats must show before the comparison."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU build")
    from nuts_rs_tpu_torch.kernels import _build

    dev = torch.device("cuda", 0)
    model, packed, args = flow_case_inputs(dim, layers, hidden, C, grow, dev)
    assert _build.flow_form(dim, 10, model, layers, hidden) == form
    in_smem = _build.flow_smem_bytes(dim, 10, model, layers, hidden, True) \
        <= _build.SMEM_OPT_IN_BYTES
    assert in_smem == (dim != 160)
    per_sm = _build.flow_blocks_per_sm(model, 10, layers, hidden)
    assert per_sm == (form, 2 if form == "warp" else 1)
    opts = NutsOptions(maxdepth=10, max_energy_error=20.0)
    want = nf.nuts_fused_run_reference(11, *args, K, model, opts, jitter,
                                       block=block, flow=packed)
    if grow:
        require_growing_trees(want[4], f"d={dim} L={layers} H={hidden}")
    before = nf.LAUNCHES["nuts_fused_flow_posterior"]
    got = nf.nuts_fused_run(11, *args, K, model, opts, jitter, block=block,
                            flow=packed)
    assert nf.LAUNCHES["nuts_fused_flow_posterior"] == before + 1
    for name in INT_STATS:
        np.testing.assert_array_equal(got[4][name].cpu().numpy(),
                                      want[4][name].cpu().numpy(),
                                      err_msg=name)
    for i in range(4):
        np.testing.assert_array_equal(got[i].cpu().numpy(),
                                      want[i].cpu().numpy(), err_msg=str(i))
    for name in nf.STAT_NAMES:
        np.testing.assert_array_equal(got[4][name].cpu().numpy(),
                                      want[4][name].cpu().numpy(),
                                      err_msg=name)
