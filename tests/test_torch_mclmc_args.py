"""MCLMC on data-carrying models and at mid d (kernels K3-args, K4-args), on
the CPU, against the JAX package.

The plain versions of K3-args and K4-args (``mclmc_fused_run_reference`` /
``mclmc_fused_warmup_run_reference`` on a model the mid-d kernels serve)
replay ``mclmc_pallas_run`` / ``mclmc_pallas_warmup_run`` with ``model_args``
in interpret mode draw for draw, on two logical blocks: integer stats equal,
floats to rounding.  So do the mid-d plain versions without data at d = 12.
The MCLMC size limits are the JAX MCLMC runners' own, not the NUTS layouts'.

Inputs.  The divergence test compares an energy error with a threshold.  The
plain versions sum a logit's terms in ascending j and everything else in
``ops.tsum``'s order (the CUDA kernels' orders) where XLA's dot sums in its
own, so an energy differs in its last bits, and under a small
``max_energy_error`` a trajectory of some 300 attempts can meet one that
lands within those bits of its threshold: the two sides then halve at
different places and every later number differs (seeds 0 and 3 of the
microcanonical halving case do, after 299 and 341 iterations).  The cases
below use seeds without such a marginal attempt; no integer comparison is
loosened.  Nor are they chaotic: the Euclidean warmup rows at d = 12 with
the variance-based rule (``use_grad_based=False``) send one coordinate of
one chain to 17 standard deviations, where a 5e-5 difference grows to 0.3
within two draws in either sum order, so that pairing of options is left to
tests/test_torch_mclmc_fused.py at d = 3 and the two rules are split over
the two kinetic energies the other way.

Float tolerances, each measured over the cases below against XLA's dot
order.  K3-args: positions and velocities rtol 2e-6 / atol 5e-6 (measured
2.2e-6 on O(2) values); step sizes rtol 2e-6 / atol 1e-6 (2.4e-7); the log
density and the energies rtol 2e-6 / atol 2e-5, as K1-args' (1.3e-5: the
log density is O(30) with an ulp of 2e-6 and sums 37 terms); a gradient
coordinate, a cancelling sum of 37 terms up to 2 in size, atol 3e-5
(1.2e-5); the Fisher distance, a sum of squares of position + gradient,
atol 1e-4 (5e-5 on O(60)).  K4-args keeps K4's rtol 1e-4 / atol 1e-4
(each draw's end point feeds the mass matrix and the next draw starts
there) except for what holds gradients (the final gradient, the estimator
planes, the Fisher distance), which move by the column sums of |x| times a
position difference and take atol 2e-3, as K2-args'.  The mid-d versions at
d = 12 keep K3's and K4's own tolerances (tests/test_torch_mclmc_fused.py).

The kernels themselves run only on a CUDA card:
tests/test_torch_kernels_cuda.py holds them against these plain versions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nuts_rs_tpu as jnt
import nuts_rs_tpu_torch as tnt
from nuts_rs_tpu import chain as jchain
from nuts_rs_tpu.adapt.step_size import StepSizeMethod as JaxMethod
from nuts_rs_tpu.adapt.step_size import StepSizeSettings as JaxStepSettings
from nuts_rs_tpu.dynamics.hamiltonian import KineticKind as JaxKind
from nuts_rs_tpu.kernels.mclmc import MclmcOptions as JaxMclmcOptions
from nuts_rs_tpu.kernels.mclmc_pallas import (
    mclmc_pallas_run,
    mclmc_pallas_warmup_run,
)
from nuts_rs_tpu.models import gaussian as jg
from nuts_rs_tpu.sampler import _strategy_for
from nuts_rs_tpu_torch import chain as tchain
from nuts_rs_tpu_torch.adapt.step_size import StepSizeMethod, StepSizeSettings
from nuts_rs_tpu_torch.dynamics.hamiltonian import KineticKind
from nuts_rs_tpu_torch.kernels import _build
from nuts_rs_tpu_torch.kernels import mclmc_fused as mf
from nuts_rs_tpu_torch.kernels import nuts_fused as nf
from nuts_rs_tpu_torch.kernels.mclmc import MclmcOptions
from nuts_rs_tpu_torch.models import gaussian as tg
from nuts_rs_tpu_torch.ops import dsum, tsum

INT_STATS = ("diverging", "n_steps", "loop_iterations")
ENERGY_STATS = ("energy_change", "logp", "energy")
MICRO, EUCL = "micro", "eucl"
N_DATA, DIM, CHAINS, BLOCK = 37, 5, 4, 2


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, what, rtol, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=what)


def _opts(kind, max_err, dynamic=True):
    jk = JaxKind.MICROCANONICAL if kind == MICRO else JaxKind.EUCLIDEAN
    tk = (KineticKind.MICROCANONICAL if kind == MICRO
          else KineticKind.EUCLIDEAN)
    kw = dict(max_energy_error=max_err, dynamic_step_size=dynamic)
    return JaxMclmcOptions(kind=jk, **kw), MclmcOptions(kind=tk, **kw)


def _models(seed):
    return (jg.logistic_regression(N_DATA, DIM, seed),
            tg.logistic_regression(N_DATA, DIM, seed))


def _glm_inputs(jm, seed, step, C=CHAINS):
    """A chain state of the regression, made with numpy; the start point's
    value and gradient from the JAX model."""
    dim = jm.dim
    rng = np.random.default_rng(seed)
    q = (0.3 * rng.normal(size=(C, dim))).astype(np.float32)
    stds = rng.uniform(0.3, 0.8, size=(C, dim)).astype(np.float32)
    mean = (0.05 * rng.normal(size=(C, dim))).astype(np.float32)
    logdet = np.sum(np.log(1 / stds), 1).astype(np.float32)
    logp, g = jax.vmap(jm.logp_and_grad)(jnp.asarray(q))
    v = rng.normal(size=(C, dim))
    v = (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)
    steps = np.full(C, step, np.float32)
    return (q, np.asarray(g, np.float32), np.asarray(logp, np.float32), v,
            stds, mean, logdet, steps, steps.copy())


def _exercised(stats, max_err, dynamic):
    """The case exercises what it is there for."""
    if max_err < 1.0 and dynamic:
        halved = stats["average_step_size"] < stats["step_size"] * 0.99
        assert bool(halved.any())
    if max_err < 1.0 and not dynamic:
        assert bool((stats["diverging"] > 0).any())


def _check_posterior(got, want, atol, energy_atol, grad_atol, fisher_atol,
                     rtol=2e-6):
    for name in INT_STATS:
        np.testing.assert_array_equal(got[5][name].numpy(),
                                      np.asarray(want[5][name]), err_msg=name)
    iters = got[5]["loop_iterations"].numpy()
    B = len(iters) // 2  # two logical blocks with their own counters
    assert (iters[:B] == iters[0]).all() and (iters[B:] == iters[B]).all()
    atols = {"g": grad_atol, "logp": energy_atol}
    for i, name in enumerate(("q", "g", "logp", "v", "draws")):
        _close(got[i], want[i], name, rtol, atols.get(name, atol))
    for name in ("average_step_size", "step_size"):
        _close(got[5][name], want[5][name], name, 2e-6, 1e-6)
    for name in ENERGY_STATS:
        _close(got[5][name], want[5][name], name, rtol, energy_atol)
    _close(got[5]["fisher_distance"], want[5]["fisher_distance"],
           "fisher_distance", rtol, fisher_atol)


# ---------------------------------------------------------------------------
# (a) plain K3-args against interpret-mode Pallas with model_args
# ---------------------------------------------------------------------------


# max_err < 1 exercises the halving stack (dynamic) or give-ups (without
# halvings every divergence gives up)
@pytest.mark.parametrize("kind,max_err,dynamic,step,jitter,seed", [
    (MICRO, 1000.0, True, 0.6, 0.1, 0),
    (MICRO, 1000.0, True, 0.6, None, 3),
    (MICRO, 0.05, True, 1.4, None, 7),
    (MICRO, 0.02, False, 1.4, 0.1, 0),
    (EUCL, 1000.0, True, 0.6, None, 0),
    (EUCL, 1000.0, True, 0.6, 0.1, 7),
    (EUCL, 0.05, True, 1.2, 0.1, 3),
    (EUCL, 0.02, False, 1.2, None, 7),
])
def test_k3_args_plain_version_matches_pallas(kind, max_err, dynamic, step,
                                              jitter, seed):
    K = 5
    jm, tm = _models(seed)
    fn, pallas_args = jm.pallas_logp_grad
    jopts, topts = _opts(kind, max_err, dynamic)
    args = _glm_inputs(jm, seed, step)
    want = mclmc_pallas_run(seed, *args, K, fn, jopts, jitter, block=BLOCK,
                            interpret=True, model_args=pallas_args)
    got = mf.mclmc_fused_run_reference(seed, *map(_t, args), K, tm, topts,
                                       jitter, block=BLOCK)
    _check_posterior(got, want, 5e-6, 2e-5, 3e-5, 1e-4)
    _exercised(got[5], max_err, dynamic)


# ---------------------------------------------------------------------------
# (b) plain K4-args against interpret-mode Pallas with model_args
# ---------------------------------------------------------------------------


def _warmup_state(q, g, logp, v, stds, K):
    """A warmup launch's inputs from a start point: the momentum resample on
    draw 0, estimator updates on every draw, a mass-matrix update, a window
    switch with an update, and a resample again at a later draw (the
    trajectory switch)."""
    C, dim = q.shape
    mean = np.zeros((C, dim), np.float32)
    est = np.zeros((C, 8, dim), np.float32)
    est[:, 0], est[:, 2], est[:, 4], est[:, 6] = q, g, q, g
    sca = np.zeros((C, mf.NSCA), np.float32)
    sca[:, mf.SCA_CNT_FG] = sca[:, mf.SCA_CNT_BG] = 1
    sca[:, mf.SCA_LOGDET] = -np.sum(np.log(stds), 1)
    sca[:, mf.SCA_TID] = 2
    flags = np.zeros((K, mf.NFLAGS), np.int32)
    flags[:, mf.FLAG_UPDATE_EST] = 1
    flags[0, mf.FLAG_RESAMPLE] = flags[4, mf.FLAG_RESAMPLE] = 1
    flags[2, mf.FLAG_DO_UPDATE] = 1
    flags[3, mf.FLAG_DO_SWITCH] = flags[3, mf.FLAG_DO_UPDATE] = 1
    flags[5, mf.FLAG_DO_UPDATE] = 1
    return flags, q, g, logp, v, stds, mean, est, sca


def _check_warmup(got, want, grad_atol=1e-4):
    for name in INT_STATS + ("transformation_index",):
        np.testing.assert_array_equal(got[9][name].numpy(),
                                      np.asarray(want[9][name]), err_msg=name)
    for i, name in enumerate(("q", "g", "logp", "v", "stds", "mean", "est",
                              "sca", "draws")):
        _close(got[i], want[i], name, 1e-4,
               grad_atol if name in ("g", "est") else 1e-4)
    for name in set(mf.WARMUP_STAT_NAMES) - set(INT_STATS):
        _close(got[9][name], want[9][name], name, 1e-4,
               grad_atol if name == "fisher_distance" else 1e-4)


@pytest.mark.parametrize("kind,max_err,use_grad_based,jitter,seed", [
    (MICRO, 1000.0, True, 0.1, 0),
    (MICRO, 1000.0, False, None, 7),
    (EUCL, 1000.0, True, None, 3),
    (EUCL, 0.1, False, 0.1, 0),
])
def test_k4_args_plain_version_matches_pallas(kind, max_err, use_grad_based,
                                              jitter, seed):
    K = 6
    jm, tm = _models(seed)
    fn, pallas_args = jm.pallas_logp_grad
    jopts, topts = _opts(kind, max_err)
    q, g, logp, v, stds, *_ = _glm_inputs(jm, seed, 0.5)
    args = _warmup_state(q, g, logp, v, stds, K)
    jsset = JaxStepSettings(method=JaxMethod.FIXED, fixed_value=0.6,
                            jitter=jitter)
    tsset = StepSizeSettings(method=StepSizeMethod.FIXED, fixed_value=0.6,
                             jitter=jitter)
    # C > B with model_args: the Pallas wrapper launches one chain group per
    # call with the group as the program-id base, the same streams
    want = mclmc_pallas_warmup_run(seed, *args, fn, jopts, jsset,
                                   use_grad_based, block=BLOCK,
                                   interpret=True, model_args=pallas_args)
    got = mf.mclmc_fused_warmup_run_reference(
        seed, *map(_t, args), tm, topts, tsset, use_grad_based, block=BLOCK)
    _check_warmup(got, want, grad_atol=2e-3)
    # the rows hold a window switch and updates that took
    assert set(np.asarray(want[9]["transformation_index"]).ravel()) \
        >= {3.0, 4.0}
    _exercised(got[9], max_err, True)


# ---------------------------------------------------------------------------
# (c) the mid-d plain versions without data against Pallas cl
# ---------------------------------------------------------------------------

MID_DIM, MID_MU = 12, 0.5


def _jax_batched_normal(q):  # [d, B] -> ([B], [d, B])
    return -0.5 * jnp.sum((q - MID_MU) ** 2, 0), -(q - MID_MU)


def _mid_inputs(seed, C, step):
    rng = np.random.default_rng(seed)
    q = (MID_MU + rng.normal(size=(C, MID_DIM))).astype(np.float32)
    g = (-(q - MID_MU)).astype(np.float32)
    logp = (-0.5 * np.sum((q - MID_MU) ** 2, 1)).astype(np.float32)
    v = rng.normal(size=(C, MID_DIM))
    v = (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)
    stds = rng.uniform(0.6, 1.6, size=(C, MID_DIM)).astype(np.float32)
    mean = (MID_MU + 0.2 * rng.normal(size=(C, MID_DIM))).astype(np.float32)
    logdet = (-np.sum(np.log(stds), 1)).astype(np.float32)
    steps = np.full(C, step, np.float32)
    return q, g, logp, v, stds, mean, logdet, steps, steps.copy()


@pytest.mark.parametrize("kind,max_err,step,jitter", [
    (MICRO, 1000.0, 0.6, 0.1), (MICRO, 0.05, 1.4, 0.1),
    (EUCL, 1000.0, 0.6, None)])
def test_mid_posterior_plain_version_matches_pallas_cl(kind, max_err, step,
                                                       jitter):
    model = tg.normal_logp(MID_DIM, MID_MU)
    assert nf.cl_kernel(model, MID_DIM) == "mid"
    jopts, topts = _opts(kind, max_err)
    args = _mid_inputs(3, 4, step)
    want = mclmc_pallas_run(3, *args, 5, _jax_batched_normal, jopts, jitter,
                            block=2, interpret=True)
    got = mf.mclmc_fused_run_reference(3, *map(_t, args), 5, model, topts,
                                       jitter, block=2)
    _check_posterior(got, want, 1e-5, 1e-5, 1e-5, 1e-5, rtol=1e-5)
    _exercised(got[5], max_err, True)


@pytest.mark.parametrize("kind,use_grad_based,jitter", [
    (MICRO, False, 0.1), (EUCL, True, None)])
def test_mid_warmup_plain_version_matches_pallas_cl(kind, use_grad_based,
                                                    jitter):
    model = tg.normal_logp(MID_DIM, MID_MU)
    jopts, topts = _opts(kind, 1000.0)
    q, g, logp, v, stds, *_ = _mid_inputs(5, 4, 0.5)
    args = _warmup_state(q, g, logp, v, stds, 6)
    jsset = JaxStepSettings(method=JaxMethod.FIXED, fixed_value=0.8,
                            jitter=jitter)
    tsset = StepSizeSettings(method=StepSizeMethod.FIXED, fixed_value=0.8,
                             jitter=jitter)
    want = mclmc_pallas_warmup_run(5, *args, _jax_batched_normal, jopts,
                                   jsset, use_grad_based, block=2,
                                   interpret=True)
    got = mf.mclmc_fused_warmup_run_reference(
        5, *map(_t, args), model, topts, tsset, use_grad_based, block=2)
    _check_warmup(got, want)


# ---------------------------------------------------------------------------
# (d) the MCLMC size limits against both JAX MCLMC runners
# ---------------------------------------------------------------------------

LIMIT_DIM = 100


def _jax_runner(model, warmup):
    """The JAX MCLMC posterior or warmup runner for ``model``, or None where
    its VMEM rule finds no tier; nothing is launched."""
    js = jnt.DiagMclmcSettings(num_chains=8, num_tune=20, num_draws=10,
                               posterior_kernel="pallas")
    jcfg = js.chain_config()
    mopts = js._mclmc_options(jnt.MclmcTrajectoryKind.MICROCANONICAL)
    strategy = _strategy_for(js, jcfg)
    if warmup:
        return jchain.make_pallas_mclmc_warmup_runner(model, strategy, jcfg,
                                                      mopts, base_seed=0)
    return jchain.make_pallas_mclmc_posterior_runner(
        model, strategy, jcfg, mopts, phase_start=20, base_seed=0)


def _largest_n(warmup):
    """Most rows at LIMIT_DIM that the port's rule keeps on the fused MCLMC
    launch (x [n, d] and y [n, 1]: 4 n (d + 1) bytes)."""
    n = 1
    while tchain.mclmc_max_dim(warmup, 4 * 2 * n * (LIMIT_DIM + 1)) \
            >= LIMIT_DIM:
        n *= 2
    lo, hi = n // 2, n * 2
    while lo + 1 < hi:
        mid = (lo + hi) // 2
        if tchain.mclmc_max_dim(warmup, 4 * mid * (LIMIT_DIM + 1)) \
                >= LIMIT_DIM:
            lo = mid
        else:
            hi = mid
    return lo


@pytest.mark.parametrize("warmup,offset", [(False, 0), (False, 1), (True, 0),
                                           (True, 1)])
def test_mclmc_limit_without_data_is_the_jax_runners(warmup, offset):
    """484 (posterior) and 361 (warmup), not the NUTS layouts' 212 and 178:
    one step beyond, the JAX runner is None and the port plans its sync
    MCLMC engine there (it used to raise naming item 8)."""
    assert tchain.mclmc_max_dim() == 484 and tchain.mclmc_max_dim(True) == 361
    dim = tchain.mclmc_max_dim(warmup) + offset
    runner = _jax_runner(jg.normal_logp(dim), warmup)
    settings = tnt.DiagMclmcSettings(posterior_kernel="pallas")
    reasons = settings.unsupported(tg.normal_logp(dim), "cuda")
    if offset == 0:
        assert runner is not None
        # served by the posterior kernel; above the warmup's limit the
        # warmup runs on the sync engine
        assert reasons == []
    else:
        assert runner is None
        assert reasons == []
        assert tchain.mclmc_fused_fits(tg.normal_logp(dim), warmup) is False
        assert tchain.mclmc_fused_fits(tg.normal_logp(dim - 1), warmup)


@pytest.mark.parametrize("warmup,offset", [(False, 0), (False, 1), (True, 0),
                                           (True, 1)])
def test_mclmc_limit_counts_the_data_as_the_jax_runners(warmup, offset):
    """With data the limit falls by the JAX rule's ``args_bytes``: the last
    row count that fits and the first that does not, at d = 100."""
    n = _largest_n(warmup) + offset
    nbytes = 4 * n * (LIMIT_DIM + 1)
    runner = _jax_runner(jg.logistic_regression(n, LIMIT_DIM, 0), warmup)
    model = tg.logistic_regression_from_tensors(torch.zeros(LIMIT_DIM, n),
                                                torch.zeros(n))
    assert model.data_bytes == nbytes
    fits = LIMIT_DIM <= tchain.mclmc_max_dim(warmup, nbytes)
    assert fits == (offset == 0)
    assert (runner is not None) == fits
    settings = tnt.DiagMclmcSettings(posterior_kernel="pallas")
    # beyond a limit that launch runs on the sync MCLMC engine (it used to
    # be refused naming item 8)
    assert settings.unsupported(model, "cpu") == []
    assert tchain.mclmc_fused_fits(model, warmup) == fits


def test_mclmc_serves_data_and_mid_d_on_cuda():
    """What used to raise at construction: a model with data, and every
    d = 11..361; the thread-per-chain sizes keep their instances."""
    settings = tnt.DiagMclmcSettings(posterior_kernel="pallas", num_chains=8,
                                     num_tune=5, num_draws=5)
    for model in (tg.logistic_regression(1000, 100, 0), tg.normal_logp(11),
                  tg.normal_logp(100), tg.normal_logp(213),
                  tg.normal_logp(361), tg.logistic_regression(64, 4, 0),
                  tg.normal_logp(10)):
        assert settings.unsupported(model, "cuda") == [], model.name
        assert settings.unsupported(model, "cpu") == [], model.name
    # d = 5 has no thread-per-chain instance: the mid-d kernels serve it
    assert settings.unsupported(tg.normal_logp(5), "cuda") == []
    # fits the JAX rule, but not one block's shared memory on the card
    wide = tg.logistic_regression_from_tensors(torch.zeros(11, 60000),
                                               torch.zeros(60000))
    assert settings.unsupported(wide, "cpu") == []
    assert any("item 12" in r for r in settings.unsupported(wide, "cuda"))
    # one dimension above the warmup limit: the sync warmup, then K3-args
    # (it used to raise naming item 8)
    phases = settings.build_phases(tg.normal_logp(362),
                                   settings.chain_config(), "cuda")
    assert [r.__qualname__.split(".")[0] for _, _, r in phases] == [
        "make_sync_mclmc_runner", "make_sync_mclmc_runner",
        "make_fused_mclmc_posterior_runner"]


# ---------------------------------------------------------------------------
# (e) the slice as a whole on the CPU
# ---------------------------------------------------------------------------


def test_glm_mclmc_slice_on_the_cpu_matches_the_jax_package():
    """``sample`` under ``DiagMclmcSettings`` on a data-carrying model runs
    warmup and posterior on the plain versions of K4-args and K3-args and
    agrees with the JAX package's sync MCLMC engine in distribution."""
    base = dict(num_tune=150, num_draws=250, num_chains=8)
    before = dict(mf.LAUNCHES)
    trace = tnt.sample(tg.logistic_regression(64, 6, 1),
                       tnt.DiagMclmcSettings(posterior_kernel="pallas",
                                             seed=5, **base), device="cpu")
    assert mf.LAUNCHES == before
    jtrace = jnt.sample(jg.logistic_regression(64, 6, 1),
                        jnt.DiagMclmcSettings(posterior_kernel="sync", seed=6,
                                              **base))
    pos = trace.posterior["position"].astype(np.float64)
    jpos = np.asarray(jtrace.posterior["position"], np.float64)
    assert pos.shape == (8, 250, 6)
    assert not trace.sample_stats["diverging"].any()
    # 2000 draws a coordinate in each package; with MCLMC's autocorrelation
    # the Monte-Carlo error of a mean is about 0.05 posterior std (the
    # spread of the 8 chain means over sqrt(8)), of a std about 5%
    std = jpos.std((0, 1))
    mc = max(np.max(pos.mean(1).std(0) / std), np.max(
        jpos.mean(1).std(0) / std)) / np.sqrt(8)
    assert mc < 0.08, mc
    np.testing.assert_allclose(pos.mean((0, 1)) / std,
                               jpos.mean((0, 1)) / std, atol=0.3)
    np.testing.assert_allclose(pos.std((0, 1)), std, rtol=0.25)
    n_port = trace.sample_stats["n_steps"].mean()
    n_ref = np.asarray(jtrace.sample_stats["n_steps"]).mean()
    assert abs(n_port - n_ref) < 0.3
    # the warmup's transformation schedule is the JAX package's
    np.testing.assert_array_equal(
        trace.warmup_sample_stats["transformation_index"],
        np.asarray(jtrace.warmup_sample_stats["transformation_index"]))


# ---------------------------------------------------------------------------
# (f) kernel choice, sum order, default block; CPU tensors
# ---------------------------------------------------------------------------


def test_kernel_choice_sum_order_and_default_block():
    glm = tg.logistic_regression(N_DATA, 4, 0)
    small, mid = tg.normal_logp(4), tg.normal_logp(11)
    _, opts = _opts(MICRO, 1000.0)
    for model, kind, csum, block in ((small, "thread", dsum, 32),
                                     (mid, "mid", tsum, 1),
                                     (glm, "mid", tsum, 1)):
        assert nf.cl_kernel(model, model.dim) == kind
        k = mf._Consts(opts, model, model.dim, "cpu", kind)
        assert k.csum is csum
        assert nf._check_block(64, None, kind) == block
    assert (nf.DEFAULT_BLOCK, nf.DEFAULT_MID_BLOCK) == (32, 1)
    # the mid-d evaluation is the functor's plain counterpart in tsum's order
    q = torch.from_numpy(np.random.default_rng(0).normal(
        size=(3, 4)).astype(np.float32))
    xt, y = glm.hook_parts()[2]
    k = mf._Consts(opts, glm, 4, "cpu", "mid")
    want = tg.logistic_regression_logp_grad(q, xt, y, tsum)
    for a, b in zip(k.logp_and_grad(q), want):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    # shared memory of one chain's block: 15 vectors, the reduction scratch,
    # the cluster slots, then N + 8 d of the functor
    big = tg.logistic_regression(1000, 100, 0)
    assert _build.mclmc_mid_smem_bytes(100, big) == 4 * (
        15 * 100 + 176 + 16 + 1000 + 800)
    assert _build.mclmc_mid_smem_bytes(361, tg.normal_logp(361)) == 4 * (
        15 * 361 + 192)
    assert set(mf.LAUNCHES) == {
        "mclmc_fused_posterior", "mclmc_fused_warmup",
        "mclmc_fused_mid_posterior", "mclmc_fused_mid_warmup"}


def test_cpu_tensors_take_the_plain_versions():
    before = dict(mf.LAUNCHES)
    jm, tm = _models(1)
    _, opts = _opts(MICRO, 1000.0)
    args = list(map(_t, _glm_inputs(jm, 1, 0.5)))
    got = mf.mclmc_fused_run(1, *args, 3, tm, opts, 0.1, block=BLOCK)
    want = mf.mclmc_fused_run_reference(1, *args, 3, tm, opts, 0.1,
                                        block=BLOCK)
    for a, b in zip(got[:5], want[:5]):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    sset = StepSizeSettings(method=StepSizeMethod.FIXED, fixed_value=0.5)
    wargs = list(map(_t, _warmup_state(*(a.numpy() for a in args[:5]), 6)))
    got = mf.mclmc_fused_warmup_run(1, *wargs, tm, opts, sset, True,
                                    block=BLOCK)
    want = mf.mclmc_fused_warmup_run_reference(1, *wargs, tm, opts, sset,
                                               True, block=BLOCK)
    for a, b in zip(got[:9], want[:9]):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert mf.LAUNCHES == before
    # the default block of a model with data is one chain
    alone = mf.mclmc_fused_run(1, *args, 2, tm, opts, None)
    one = mf.mclmc_fused_run_reference(1, *args, 2, tm, opts, None, block=1)
    np.testing.assert_array_equal(alone[4].numpy(), one[4].numpy())
    # data on another device than the state, or a block above the cluster
    # size, is for the launchers to refuse; the argument checks run first
    bad = list(args)
    bad[3] = args[3][:, :2].contiguous()
    with pytest.raises(ValueError):
        mf.mclmc_fused_run(0, *bad, 2, tm, opts, None)
