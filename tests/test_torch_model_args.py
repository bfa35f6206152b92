"""Data-carrying models on the fused NUTS path (kernels K1-args, K2-args) and
the mid-d chains-on-lanes kernels, on the CPU, against the JAX package.

The port's ``logistic_regression`` holds the JAX model's data and values.
The plain versions of K1-args and K2-args (``nuts_fused_run_reference`` /
``nuts_fused_warmup_run_reference`` on a model with data) replay
``nuts_pallas_run`` / ``nuts_pallas_warmup_run`` with ``model_args`` in
interpret mode draw for draw, on two logical blocks: integer stats equal,
floats to rounding.  So does the mid-d plain version without data at a d
between 11 and 212.  The runners' chains-on-lanes limit counts the data's
bytes as the JAX runners' rule does.

Float tolerances.  The plain versions sum a logit's terms in ascending j and
everything over the rows in ``ops.tsum``'s order (the CUDA kernels' orders);
XLA's dot sums in its own.  With that, every integer stat still agrees on
every (chain, draw).  K1-args keeps K1's rtol 2e-6 everywhere, and atol 2e-6
for positions and step sizes (measured: 3.3e-7).  Three groups needed more
atol than K1's 1e-6 / 1e-5, because the log density is now O(50) with an ulp
of 4e-6 where the normal's was O(5): the log densities and energy-derived
stats take 2e-5 (measured 1.5e-5); the accept sums, up to 15 terms
exp(-energy error) each carrying that error, take 5e-5 (measured 3.3e-5);
a gradient coordinate, a cancelling sum of 64 terms up to 2 in size, takes
1e-5 (measured 3.1e-6).  K2-args keeps K2's rtol 1e-4 / atol 1e-4 (positions
differ by up to 7e-5 after five adapting draws) except for the final
gradient, the estimator planes that hold gradients and the Fisher distance
(a sum of squared gradients), which move by about ten times a position difference (the column
sums of |x|) and take atol 2e-3 (measured 5.8e-4).  The mid-d version at
d = 12 keeps K1's and K2's own tolerances.

The kernels themselves run only on a CUDA card:
tests/test_torch_kernels_cuda.py holds them against these plain versions.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nuts_rs_tpu as jnt
import nuts_rs_tpu_torch as tnt
from nuts_rs_tpu.kernels.nuts import NutsOptions as JaxNutsOptions
from nuts_rs_tpu.kernels.nuts_pallas import (
    nuts_pallas_run,
    nuts_pallas_warmup_run,
)
from nuts_rs_tpu.models import gaussian as jg
from nuts_rs_tpu.sampler import _strategy_for
from nuts_rs_tpu_torch import chain as tchain
from nuts_rs_tpu_torch.adapt.schedule import build_schedule
from nuts_rs_tpu_torch.adapt.step_size import StepSizeSettings
from nuts_rs_tpu_torch.convert import model_from_pallas_args
from nuts_rs_tpu_torch.kernels import _build
from nuts_rs_tpu_torch.kernels import nuts_fused as nf
from nuts_rs_tpu_torch.kernels.nuts import NutsOptions
from nuts_rs_tpu_torch.models import gaussian as tg
from nuts_rs_tpu_torch.ops import dsum, tsum
from nuts_rs_tpu_torch.sampler import _schedule_chunk

INT_STATS = ("depth", "diverging", "n_steps", "index_in_trajectory",
             "maxdepth_reached", "loop_iterations")
ENERGY_STATS = ("max_energy_error", "logp", "energy", "energy_error",
                "fisher_distance")
N_DATA, DIM, CHAINS, BLOCK, MAXDEPTH = 64, 6, 8, 4, 4


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, what, rtol, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=what)


# ---------------------------------------------------------------------------
# (a) the model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_data,dim,seed", [(64, 6, 1), (37, 4, 5)])
def test_logistic_regression_is_the_jax_models(n_data, dim, seed):
    jm = jg.logistic_regression(n_data, dim, seed)
    tm = tg.logistic_regression(n_data, dim, seed)
    fn, (x, y1) = jm.pallas_logp_grad
    name, floats, (xt, y) = tm.hook_parts()
    assert (name, floats) == ("logistic_regression", ())
    np.testing.assert_array_equal(xt.numpy().T, x)
    np.testing.assert_array_equal(y.numpy(), y1[:, 0])
    assert xt.is_contiguous() and xt.dtype == torch.float32
    assert tm.carries_data and tm.data_bytes == 4 * (x.size + y1.size)
    assert tm.dim == jm.dim == dim

    q = np.random.default_rng(seed).normal(size=(5, dim)).astype(np.float32)
    logp_h, grad_h = fn(jnp.asarray(q.T), jnp.asarray(x), jnp.asarray(y1))
    logp_a, grad_a = jax.vmap(jm.logp_and_grad)(jnp.asarray(q))
    for logp, grad in (tm.logp_and_grad(_t(q)),
                       tg.logistic_regression_logp_grad(_t(q), xt, y, tsum),
                       nf._evaluators(tm, "mid")[1](_t(q))):
        _close(logp, logp_h, "logp vs the Pallas hook", 1e-5, 0)
        _close(grad, np.asarray(grad_h).T, "grad vs the hook", 1e-5, 1e-6)
        _close(logp, logp_a, "logp vs autodiff", 1e-5, 0)
        _close(grad, grad_a, "grad vs autodiff", 1e-5, 1e-6)
    # the scalar density, which torch.func differentiates where a model has
    # no closed form
    _close(tm.logp_fn(_t(q[0])), logp_a[0], "logp_fn", 1e-5, 0)


def test_model_from_pallas_args_and_device_move():
    jm = jg.logistic_regression(N_DATA, DIM, 2)
    tm = model_from_pallas_args("logistic_regression",
                                jm.pallas_logp_grad[1], name="glm")
    ref = tg.logistic_regression(N_DATA, DIM, 2)
    assert tm.name == "glm" and tm.dim == DIM
    for a, b in zip(tm.hook_parts()[2], ref.hook_parts()[2]):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    moved = tm.to("cpu")
    assert moved.hook_parts()[2][0].device.type == "cpu"
    assert moved.name == "glm" and moved.carries_data
    plain = tg.normal_logp(3)
    assert plain.to("cpu") is plain and not plain.carries_data
    assert plain.data_bytes == 0
    with pytest.raises(NotImplementedError, match="its own constructor"):
        model_from_pallas_args("radon", ())


# ---------------------------------------------------------------------------
# (b) plain K1-args / K2-args against interpret-mode Pallas with model_args
# ---------------------------------------------------------------------------


def _models(seed):
    return (jg.logistic_regression(N_DATA, DIM, seed),
            tg.logistic_regression(N_DATA, DIM, seed))


def _posterior_inputs(jm, seed, C=CHAINS):
    dim = jm.dim
    rng = np.random.default_rng(seed)
    q0 = (0.3 * rng.normal(size=(C, dim))).astype(np.float32)
    stds = rng.uniform(0.3, 0.8, size=(C, dim)).astype(np.float32)
    mean = (0.05 * rng.normal(size=(C, dim))).astype(np.float32)
    logdet = np.sum(np.log(1 / stds), 1).astype(np.float32)
    logp0, g0 = jax.vmap(jm.logp_and_grad)(jnp.asarray(q0))
    step = np.full(C, 0.5, np.float32)
    bar = np.full(C, 0.45, np.float32)
    return (q0, np.asarray(g0, np.float32), np.asarray(logp0, np.float32),
            stds, mean, logdet, step, bar)


def _check_posterior(got, want, atol, energy_atol, grad_atol=None,
                     accept_atol=None):
    for name in INT_STATS:
        np.testing.assert_array_equal(got[4][name].numpy(),
                                      np.asarray(want[4][name]), err_msg=name)
    iters = got[4]["loop_iterations"].numpy()
    B = len(iters) // 2  # two logical blocks with their own counters
    assert (iters[:B] == iters[0]).all() and (iters[B:] == iters[B]).all()
    atols = {"logp": energy_atol, "g": grad_atol or atol}
    for i, name in enumerate(("q", "g", "logp", "draws")):
        _close(got[i], want[i], name, 2e-6, atols.get(name, atol))
    _close(got[4]["step_size"], want[4]["step_size"], "step_size", 2e-6,
           atol)
    for name in ("sum_accept", "sum_accept_sym"):
        _close(got[4][name], want[4][name], name, 2e-6, accept_atol or atol)
    for name in ENERGY_STATS:
        _close(got[4][name], want[4][name], name, 2e-6, energy_atol)


@pytest.mark.parametrize("jitter", [None, 0.1])
@pytest.mark.parametrize("seed", [0, 7])
def test_k1_args_plain_version_matches_pallas(seed, jitter):
    K = 4
    jm, tm = _models(seed)
    fn, pallas_args = jm.pallas_logp_grad
    args = _posterior_inputs(jm, seed)
    want = nuts_pallas_run(seed, *args, K, fn,
                           JaxNutsOptions(maxdepth=MAXDEPTH), jitter,
                           block=BLOCK, interpret=True,
                           model_args=pallas_args)
    got = nf.nuts_fused_run_reference(
        seed, *map(_t, args), K, tm, NutsOptions(maxdepth=MAXDEPTH), jitter,
        block=BLOCK)
    _check_posterior(got, want, 2e-6, 2e-5, grad_atol=1e-5,
                     accept_atol=5e-5)


def _warmup_state(q0, g0, logp0, stds, K):
    """A warmup launch's inputs from a start point: estimator updates and
    dual averaging on every draw; a mass-matrix update, a window switch
    with an update, and the late estimator with the best-guess step."""
    C, dim = q0.shape
    mean = np.zeros((C, dim), np.float32)
    est = np.zeros((C, 8, dim), np.float32)
    est[:, 0], est[:, 2], est[:, 4], est[:, 6] = q0, g0, q0, g0
    sca = np.zeros((C, nf.NSCA), np.float32)
    sca[:, nf.SCA_STEP] = 0.4
    sca[:, nf.SCA_DA_LS] = sca[:, nf.SCA_DA_LSA] = np.log(0.4)
    sca[:, nf.SCA_DA_MU] = np.log(4.0)
    sca[:, nf.SCA_DA_CNT] = sca[:, nf.SCA_CNT_FG] = sca[:, nf.SCA_CNT_BG] = 1
    sca[:, nf.SCA_LOGDET] = np.sum(np.log(1 / stds), 1)
    flags = np.zeros((K, nf.NFLAGS), np.int32)
    flags[:, nf.FLAG_UPDATE_EST] = flags[:, nf.FLAG_ADVANCE_DA] = 1
    flags[2, nf.FLAG_DO_UPDATE] = 1
    flags[3, nf.FLAG_DO_SWITCH] = flags[3, nf.FLAG_DO_UPDATE] = 1
    flags[4, nf.FLAG_USE_LATE] = flags[4, nf.FLAG_USE_BEST] = 1
    return flags, q0, g0, logp0, stds, mean, est, sca


def _warmup_inputs(jm, seed, K, C=CHAINS):
    q0, g0, logp0, stds, _, _, _, _ = _posterior_inputs(jm, seed, C)
    return _warmup_state(q0, g0, logp0, stds, K)


def _check_warmup(got, want, grad_atol=1e-4):
    for name in INT_STATS + ("transformation_index",):
        np.testing.assert_array_equal(got[8][name].numpy(),
                                      np.asarray(want[8][name]), err_msg=name)
    assert set(np.asarray(want[8]["transformation_index"]).ravel()) \
        >= {0.0, 1.0, 2.0}
    for i, name in enumerate(("q", "g", "logp", "stds", "mean", "est", "sca",
                              "draws")):
        _close(got[i], want[i], name, 1e-4,
               grad_atol if name in ("g", "est") else 1e-4)
    for name in set(nf.WARMUP_STAT_NAMES) - set(INT_STATS):
        _close(got[8][name], want[8][name], name, 1e-4,
               grad_atol if name == "fisher_distance" else 1e-4)


@pytest.mark.parametrize("seed,use_grad_based", [(0, True), (7, False)])
def test_k2_args_plain_version_matches_pallas(seed, use_grad_based):
    K = 5
    jm, tm = _models(seed)
    fn, pallas_args = jm.pallas_logp_grad
    args = _warmup_inputs(jm, seed, K)
    # the multi-program grid, as tests/test_pallas_warmup.py pins it
    want = nuts_pallas_warmup_run(
        seed, *args, fn, JaxNutsOptions(maxdepth=MAXDEPTH),
        jnt.DiagNutsSettings().step_size, use_grad_based, block=BLOCK,
        interpret=True, model_args=pallas_args, _split=False)
    got = nf.nuts_fused_warmup_run_reference(
        seed, *map(_t, args), tm, NutsOptions(maxdepth=MAXDEPTH),
        StepSizeSettings(), use_grad_based, block=BLOCK)
    _check_warmup(got, want, grad_atol=2e-3)


# ---------------------------------------------------------------------------
# (c) the mid-d plain version without data against Pallas cl
# ---------------------------------------------------------------------------

MID_DIM, MID_MU = 12, 0.5


def _mid_inputs(seed, C=4):
    rng = np.random.default_rng(seed)
    q0 = (MID_MU + rng.normal(size=(C, MID_DIM))).astype(np.float32)
    stds = rng.uniform(0.5, 2.0, size=(C, MID_DIM)).astype(np.float32)
    mean = (0.1 * rng.normal(size=(C, MID_DIM))).astype(np.float32)
    logdet = np.sum(np.log(1 / stds), 1).astype(np.float32)
    logp0 = (-0.5 * np.sum((q0 - MID_MU) ** 2, 1)).astype(np.float32)
    g0 = (-(q0 - MID_MU)).astype(np.float32)
    return (q0, g0, logp0, stds, mean, logdet, np.full(C, 0.35, np.float32),
            np.full(C, 0.3, np.float32))


def _jax_batched_normal():
    model = jg.normal_logp(MID_DIM, MID_MU)

    def logp_grad_batched(q):
        return jax.vmap(model.logp_and_grad, in_axes=1, out_axes=(0, 1))(q)
    return logp_grad_batched


def test_mid_posterior_plain_version_matches_pallas_cl():
    model = tg.normal_logp(MID_DIM, MID_MU)
    assert nf.cl_kernel(model, MID_DIM) == "mid"
    assert _build.CL_THREAD_MAX_DIM < MID_DIM <= tchain.cl_max_dim(10)
    args = _mid_inputs(3)
    want = nuts_pallas_run(3, *args, 3, _jax_batched_normal(),
                           JaxNutsOptions(maxdepth=MAXDEPTH), 0.1, block=2,
                           interpret=True)
    got = nf.nuts_fused_run_reference(3, *map(_t, args), 3, model,
                                      NutsOptions(maxdepth=MAXDEPTH), 0.1,
                                      block=2)
    _check_posterior(got, want, 1e-6, 1e-5)


def test_mid_warmup_plain_version_matches_pallas_cl():
    model = tg.normal_logp(MID_DIM, MID_MU)
    q0, g0, logp0, stds, *_ = _mid_inputs(5)
    args = _warmup_state(q0, g0, logp0, stds, 5)
    want = nuts_pallas_warmup_run(
        5, *args, _jax_batched_normal(), JaxNutsOptions(maxdepth=MAXDEPTH),
        jnt.DiagNutsSettings().step_size, True, block=2, interpret=True,
        _split=False)
    got = nf.nuts_fused_warmup_run_reference(
        5, *map(_t, args), model, NutsOptions(maxdepth=MAXDEPTH),
        StepSizeSettings(), True, block=2)
    _check_warmup(got, want)


def test_kernel_choice_sum_order_and_default_block():
    glm = tg.logistic_regression(N_DATA, 4, 0)
    small, mid = tg.normal_logp(4), tg.normal_logp(11)
    assert nf.cl_kernel(small, 4) == "thread"
    assert nf.cl_kernel(mid, 11) == "mid"
    assert nf.cl_kernel(glm, 4) == "mid"       # data: whatever the size
    assert nf._evaluators(small, "thread")[0] is dsum
    assert nf._evaluators(mid, "mid")[0] is tsum
    assert nf._check_block(64, None, "thread") == nf.DEFAULT_BLOCK
    assert nf._check_block(64, None, "mid") == nf.DEFAULT_MID_BLOCK == 1
    assert nf._check_block(64, None, "ld") == _build.MAX_LD_BLOCK
    # shared memory of one chain's block: 21 (19) vectors, the cached dots,
    # the reduction scratch, the cluster slots, then N + 8 d of the functor
    big = tg.logistic_regression(1000, 100, 0)
    assert _build.mid_smem_bytes("posterior", 100, 10, big) == 4 * (
        21 * 100 + 22 + 176 + 16 + 1000 + 800)
    assert _build.mid_smem_bytes("warmup", 100, 10, big) == 4 * (
        19 * 100 + 22 + 176 + 16 + 1000 + 800)
    assert _build.mid_smem_bytes("posterior", 100, 10,
                                 tg.normal_logp(100)) == 4 * (2100 + 214)


def test_model_data_are_checked_per_functor():
    glm = tg.logistic_regression(N_DATA, DIM, 0)
    ints, ptrs = _build.model_data_args(glm, DIM, "cpu")
    assert ints == (N_DATA, DIM) and len(ptrs) == 2
    assert _build.model_data_args(tg.normal_logp(DIM), DIM, "cpu") == ((), [])
    with pytest.raises(ValueError, match="xt must have shape"):
        _build.model_data_args(glm, DIM + 1, "cpu")
    xt, y = glm.hook_parts()[2]
    for bad in ((xt.double(), y), (xt.T, y), (xt, y[:-1]), (xt,)):
        model = dataclasses.replace(glm, kernel_hook=(
            "logistic_regression", (), bad))
        with pytest.raises((ValueError, TypeError)):
            _build.model_data_args(model, DIM, "cpu")


def test_cpu_tensors_take_the_plain_versions():
    before = dict(nf.LAUNCHES)
    jm, tm = _models(1)
    opts = NutsOptions(maxdepth=MAXDEPTH)
    args = list(map(_t, _posterior_inputs(jm, 1)))
    got = nf.nuts_fused_run(1, *args, 3, tm, opts, 0.1, block=BLOCK)
    want = nf.nuts_fused_run_reference(1, *args, 3, tm, opts, 0.1,
                                       block=BLOCK)
    for a, b in zip(got[:4], want[:4]):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    wargs = list(map(_t, _warmup_inputs(jm, 1, 5)))
    got = nf.nuts_fused_warmup_run(1, *wargs, tm, opts, StepSizeSettings(),
                                   True, block=BLOCK)
    want = nf.nuts_fused_warmup_run_reference(
        1, *wargs, tm, opts, StepSizeSettings(), True, block=BLOCK)
    for a, b in zip(got[:8], want[:8]):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert nf.LAUNCHES == before
    assert {"nuts_fused_mid_posterior", "nuts_fused_mid_warmup"} \
        <= set(nf.LAUNCHES)


# ---------------------------------------------------------------------------
# (d) the chains-on-lanes limit with the data's bytes
# ---------------------------------------------------------------------------

LIMIT_DIM = 100


def _largest_n(warmup):
    """Most rows at LIMIT_DIM that the port's rule keeps chains-on-lanes."""
    n = 1
    while tchain.cl_max_dim(10, warmup, 4 * (n + 1) * (LIMIT_DIM + 1)) \
            >= LIMIT_DIM:
        n += max(1, n // 64)
    while tchain.cl_max_dim(10, warmup, 4 * n * (LIMIT_DIM + 1)) < LIMIT_DIM:
        n -= 1
    while tchain.cl_max_dim(10, warmup, 4 * (n + 1) * (LIMIT_DIM + 1)) \
            >= LIMIT_DIM:
        n += 1
    return n


@functools.lru_cache(maxsize=None)
def _jax_state():
    js = jnt.DiagNutsSettings(num_chains=8, num_tune=20, num_draws=10,
                              posterior_kernel="pallas")
    model = jg.logistic_regression(32, LIMIT_DIM, 0)
    return jnt.Sampler(model, js, dtype=jnp.float32).state


def _jax_launch(monkeypatch, n_data, warmup):
    """(layout, streamed) of the launch the JAX warmup or posterior runner
    makes for ``logistic_regression(n_data, LIMIT_DIM)``; nothing runs."""
    import nuts_rs_tpu.chain as jchain
    import nuts_rs_tpu.kernels.nuts_pallas as jpallas

    seen = []

    class _Stop(Exception):
        pass

    def spy(*args, **kw):
        seen.append((kw.get("layout", "cl"), kw.get("stream") is not None,
                     len(kw.get("model_args", ()))))
        raise _Stop

    js = jnt.DiagNutsSettings(num_chains=8, num_tune=20, num_draws=10,
                              posterior_kernel="pallas")
    jcfg = js.chain_config()
    model = jg.logistic_regression(n_data, LIMIT_DIM, 0)
    sched = build_schedule(20, 10, js.adapt)
    if warmup:
        monkeypatch.setattr(jpallas, "nuts_pallas_warmup_run", spy)
        runner = jchain.make_pallas_warmup_runner(
            model, _strategy_for(js, jcfg), jcfg, base_seed=0,
            use_grad_based=True)
        lo, hi = 0, 4
    else:
        monkeypatch.setattr(jpallas, "nuts_pallas_run", spy)
        runner = jchain.make_pallas_posterior_runner(
            model, _strategy_for(js, jcfg), jcfg, phase_start=20,
            base_seed=0)
        lo, hi = 20, 24
    flags = {k: jnp.asarray(v)
             for k, v in _schedule_chunk(sched, lo, hi).items()}
    with pytest.raises(_Stop):
        runner(_jax_state(), flags)
    return seen[0]


@pytest.mark.parametrize("warmup,offset", [(True, 0), (True, 1), (False, 0),
                                           (False, 1)])
def test_cl_limit_counts_the_data_as_the_jax_runners(monkeypatch, warmup,
                                                     offset):
    """With data the chains-on-lanes limit falls as the JAX rule's
    ``args_bytes`` grow.  One row beyond it the JAX posterior runner streams
    the data, and so does the port's; the JAX warmup runner leaves for the
    dim-on-lanes layout with data, and so does the port's (kernel
    K2-ld-args)."""
    n = _largest_n(warmup) + offset
    config = tnt.DiagNutsSettings(posterior_kernel="pallas").chain_config()
    model = tg.logistic_regression(n, LIMIT_DIM, 0)
    assert model.data_bytes == 4 * n * (LIMIT_DIM + 1)
    layout, streamed, n_args = _jax_launch(monkeypatch, n, warmup)
    if offset == 0:
        assert (layout, streamed, n_args) == ("cl", False, 2)
        assert tchain.fused_layout(model, config, warmup) == "cl"
    elif warmup:
        assert (layout, streamed, n_args) == ("ld", False, 2)
        assert tchain.fused_layout(model, config, warmup) == "ld"
    else:
        assert (layout, streamed, n_args) == ("cl", True, 0)
        assert tchain.fused_layout(model, config, warmup) == "stream"
    # without data the limits stay the JAX package's
    assert tchain.cl_max_dim(10) == 212
    assert tchain.cl_max_dim(10, warmup=True) == 178


# ---------------------------------------------------------------------------
# (e) the slice as a whole, (f) the refusals
# ---------------------------------------------------------------------------


def test_glm_slice_on_the_cpu_matches_the_jax_package():
    """``sample`` on a data-carrying model runs warmup and posterior on the
    plain versions of K2-args and K1-args and agrees with the JAX package's
    sync engine in distribution (the check of
    tests/test_sampler.py::test_pallas_glm_model_args)."""
    base = dict(num_tune=150, num_draws=250, num_chains=8)
    before = dict(nf.LAUNCHES)
    trace = tnt.sample(tg.logistic_regression(60, 6, 3),
                       tnt.DiagNutsSettings(posterior_kernel="pallas", seed=5,
                                            **base), device="cpu")
    assert nf.LAUNCHES == before
    jtrace = jnt.sample(jg.logistic_regression(60, 6, 3),
                        jnt.DiagNutsSettings(posterior_kernel="sync", seed=6,
                                             **base), chunk_size=400)
    pos = trace.posterior["position"].astype(np.float64)
    jpos = np.asarray(jtrace.posterior["position"], np.float64)
    assert pos.shape == (8, 250, 6)
    assert not trace.sample_stats["diverging"].any()
    assert 0.6 < trace.sample_stats["mean_tree_accept"].mean() < 0.99
    np.testing.assert_allclose(pos.mean((0, 1)), jpos.mean((0, 1)), atol=0.2)
    np.testing.assert_allclose(pos.std((0, 1)), jpos.std((0, 1)), rtol=0.25)
    step = np.median(trace.sample_stats["step_size_bar"][:, -1])
    jstep = np.median(np.asarray(jtrace.sample_stats["step_size_bar"])[:, -1])
    assert abs(np.log(step / jstep)) < 0.3, (step, jstep)


def test_mid_sizes_are_served_on_cuda():
    """d = 11 .. cl_max_dim no longer raises at construction on the card,
    with or without data; the thread-per-chain sizes keep their instances."""
    settings = tnt.DiagNutsSettings(posterior_kernel="pallas", num_chains=8,
                                    num_tune=5, num_draws=5)
    for model in (tg.normal_logp(100), tg.normal_logp(11),
                  tg.normal_logp(tchain.cl_max_dim(10)),
                  tg.logistic_regression(1000, 100, 0),
                  tg.logistic_regression(64, 4, 0)):
        assert settings.unsupported(model, "cuda") == [], model.name
        assert settings.unsupported(model, "cpu") == [], model.name
    # d = 5 and maxdepth 8 have no thread-per-chain instance: the mid-d
    # kernels serve them
    assert settings.unsupported(tg.normal_logp(5), "cuda") == []
    assert dataclasses.replace(settings, maxdepth=8).unsupported(
        tg.normal_logp(10), "cuda") == []


def test_data_beyond_shared_memory_stream_on_cuda():
    """Data that fit the JAX rule but not one block's shared memory on the
    card used to raise there; the posterior streams them (K1-stream) after
    the sync warmup, and the CPU keeps the resident plain versions."""
    settings = tnt.DiagNutsSettings(posterior_kernel="pallas", num_chains=4,
                                    num_tune=5, num_draws=5)
    config = settings.chain_config()
    model = tg.logistic_regression_from_tensors(
        torch.zeros(11, 60000), torch.zeros(60000))
    assert settings.unsupported(model, "cpu") == []
    assert settings.unsupported(model, "cuda") == []
    for warmup in (True, False):
        assert tchain.fused_layout(model, config, warmup) == "cl"
        assert tchain.fused_layout(model, config, warmup, "cpu") == "cl"
    assert tchain.fused_layout(model, config, False, "cuda") == "stream"
    assert tchain.fused_layout(model, config, True, "cuda") is None
    assert _build.stream_smem_bytes(11, 10, *_build.stream_tiling(11, 4, 10)) \
        < _build.SMEM_OPT_IN_BYTES < _build.mid_smem_bytes(
            "posterior", 11, 10, model)


@pytest.mark.parametrize("case,match", [
    ("mclmc_data", "no fused-engine tier fits"),
    ("mclmc_cuda_dim", None),
])
def test_refusals_name_their_items(case, match):
    """MCLMC with data that fail the JAX MCLMC runners' rule, or at a d
    above their warmup limit (data that fit, and d = 11..361, run on
    K3-args and K4-args: tests/test_torch_mclmc_args.py), used to be refused
    naming item 8.  Now the first runs on the sync MCLMC engine with the
    JAX package's warning, the second its warmup there and the posterior on
    the mid-d kernel, without one (the NUTS refusals for data that would
    stream or lie above the chains-on-lanes limit are cases of
    tests/test_torch_sampler.py::test_unsupported_settings_raise)."""
    import warnings

    kw = dict(posterior_kernel="pallas", num_chains=4, num_tune=5,
              num_draws=5)
    device, settings = "cpu", tnt.DiagNutsSettings(**kw)
    if case == "mclmc_data":
        # the JAX benchmark's logreg_big rows: the data alone fail the rule
        model, settings = (tg.logistic_regression_from_tensors(
            torch.zeros(32, 131072), torch.zeros(131072)),
            tnt.DiagMclmcSettings(**kw))
    else:
        model, settings, device = (tg.normal_logp(362),
                                   tnt.DiagMclmcSettings(**kw), "cuda")
    assert settings.unsupported(model, device) == []
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        phases = settings.build_phases(model, settings.chain_config(), device)
    texts = [str(w.message) for w in seen]
    kinds = [r.__qualname__.split(".")[0] for _, _, r in phases]
    if match is None:
        assert texts == []
        assert kinds[-1] == "make_fused_mclmc_posterior_runner"
        assert set(kinds[:-1]) == {"make_sync_mclmc_runner"}
    else:
        assert len(texts) == 1 and match in texts[0]
        assert set(kinds) == {"make_sync_mclmc_runner"}
