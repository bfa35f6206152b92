"""The model hooks on the fused NUTS path, on the CPU, against the JAX
package: stochastic volatility in the dim-on-lanes layout with its returns as
model data (kernels K1-ld-args and K2-ld-args), radon and the rank-1 normal
in the chains-on-lanes layout with model data (K1-args and K2-args), and the
funnel and ``correlated_normal``, whose closures the JAX runners trace into
the kernel body (``nuts_rs_tpu/chain.py:686-690``).

The plain versions (``nuts_fused_run_reference`` /
``nuts_fused_warmup_run_reference``, evaluating the model through its plain
functor in ``ops.tsum``'s order) replay ``nuts_pallas_run`` /
``nuts_pallas_warmup_run`` in interpret mode with ``layout="ld"`` or
``"cl"`` and the model's ``pallas_spec`` arrays as ``model_args``,
differentiated by ``jax.value_and_grad`` as the JAX runners do (``[B, d]``
orientation in ld, ``chain.py:795-801``; ``[d, B]`` in cl, ``:681-686``):
4 chains in two logical blocks, every integer stat equal draw for draw.
Floats: closed form against autodiff, with the tolerances of ROADMAP.md
queue 3 (K1 rtol 2e-6 with atol 2e-5 for energies, 5e-5 for accept sums;
K2 rtol / atol 1e-4, 2e-3 for gradients and the estimator planes after
adapting draws).  Two models move further apart, with every integer stat
still equal: SV (a gradient coordinate is a reverse sum of up to 14 terms
near 4.5 in size, each a few ulp apart; exp(h / 2) of a cumulative sum) and
the funnel (exp(-v) scales every coordinate's gradient).  Their K1 floats
take K2's rtol / atol 1e-4 (measured: positions 1.6e-5, accept sums 5.4e-5
relative), the energy stats atol 5e-4 (an energy error is a difference of
two energies of tens: 1.2e-4 measured); SV's K2 floats, where the
gradient-based mass matrix of a few draws amplifies the differences, rtol
1e-3 with the atol 2e-3 that ROADMAP.md gives gradients after adapting
draws (measured: positions 9.2e-4, estimator planes 3.5e-4 relative), and
its max energy error rtol 2e-2 (a divergent leapfrog's error of 115, at
a point where exp(h / 2) of a far-off cumulative sum amplifies every ulp:
9.5e-3 measured).

Then radon and stochastic volatility end to end on the CPU: the fused plain
versions against the port's sync engine, in distribution, as
tests/test_hierarchical.py::test_radon_fused_engine_matches_xla holds the
JAX package's engines against each other.

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
from nuts_rs_tpu.kernels.nuts import NutsOptions as JaxNutsOptions
from nuts_rs_tpu.kernels.nuts_pallas import (
    nuts_pallas_run,
    nuts_pallas_warmup_run,
)
from nuts_rs_tpu.models import gaussian as jg
from nuts_rs_tpu.models import hierarchical as jh
from nuts_rs_tpu.models import stochastic_volatility as jsv
from nuts_rs_tpu_torch.adapt.step_size import StepSizeSettings
from nuts_rs_tpu_torch.kernels import nuts_fused as nf
from nuts_rs_tpu_torch.kernels.nuts import NutsOptions
from nuts_rs_tpu_torch.models import gaussian as tg
from nuts_rs_tpu_torch.models import hierarchical as th
from nuts_rs_tpu_torch.models import stochastic_volatility as tsv

INT_STATS = ("depth", "diverging", "n_steps", "index_in_trajectory",
             "maxdepth_reached", "loop_iterations")
ENERGY_STATS = ("max_energy_error", "logp", "energy", "energy_error",
                "fisher_distance")
CHAINS, BLOCK, MAXDEPTH = 4, 2, 5


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, what, rtol, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=what)


# name: (JAX model, port model, layout, centre and spread of the start
# points, step size)
CASES = {
    "sv": (lambda: jsv.stochastic_volatility(T=14, seed=0),
           lambda: tsv.stochastic_volatility(T=14, seed=0), "ld",
           np.r_[np.log(0.1), np.log(8.0), np.zeros(14)],
           np.r_[0.2, 0.4, np.full(14, 0.8)], 0.3),
    "radon": (lambda: jh.radon(J=4, n_per=3, seed=1),
              lambda: th.radon(J=4, n_per=3, seed=1), "cl",
              np.r_[1.5, -0.7, np.log(0.8), np.log(0.3), np.zeros(4)],
              np.r_[0.2, 0.2, 0.1, 0.3, np.full(4, 0.8)], 0.25),
    "rank1": (lambda: jg.correlated_normal_rank1(6),
              lambda: tg.correlated_normal_rank1(6), "cl", np.zeros(6),
              np.full(6, 1.2), 0.5),
    "funnel": (lambda: jg.funnel(5), lambda: tg.funnel(5), "cl",
               np.zeros(5), np.full(5, 0.8), 0.4),
    "correlated_normal": (lambda: jg.correlated_normal(5),
                          lambda: tg.correlated_normal(5), "cl",
                          np.zeros(5), np.full(5, 1.0), 0.5),
}


def _jax_evaluation(jm, layout):
    """(logp_grad_batched, model_args) as the JAX runners build them: the
    ``pallas_spec`` density differentiated by ``jax.value_and_grad``, in
    ``[B, d]`` orientation for ld and ``[d, B]`` for cl, with its arrays as
    float32 model args; a model without ``pallas_spec`` through its
    closure."""
    axis = 0 if layout == "ld" else 1
    if jm.pallas_spec is None:
        def batched(q):
            return jax.vmap(jm.logp_and_grad, in_axes=axis,
                            out_axes=(0, axis))(q)
        return batched, ()
    fn, args = jm.pallas_spec

    def batched(q, *a):
        return jax.vmap(jax.value_and_grad(lambda x: fn(x, *a)),
                        in_axes=axis, out_axes=(0, axis))(q)
    return batched, tuple(np.asarray(x, np.float32) for x in args)


def _posterior_inputs(name, jm, seed):
    _, _, _, centre, spread, step = CASES[name]
    rng = np.random.default_rng(seed)
    q0 = (centre + spread * rng.normal(size=(CHAINS, jm.dim))).astype(
        np.float32)
    stds = (spread * rng.uniform(0.7, 1.3, size=(CHAINS, jm.dim))).astype(
        np.float32)
    mean = (centre + 0.1 * spread * rng.normal(size=(CHAINS, jm.dim))
            ).astype(np.float32)
    logdet = np.sum(np.log(1 / stds), 1).astype(np.float32)
    logp0, g0 = jax.vmap(jm.logp_and_grad)(jnp.asarray(q0))
    return (q0, np.asarray(g0, np.float32), np.asarray(logp0, np.float32),
            stds, mean, logdet, np.full(CHAINS, step, np.float32),
            np.full(CHAINS, 0.9 * step, np.float32))


def _check_posterior(got, want, loose=False):
    """Integer stats equal; floats at K1's tolerances, or with ``loose`` at
    rtol / atol 1e-4."""
    for name in INT_STATS:
        np.testing.assert_array_equal(got[4][name].numpy(),
                                      np.asarray(want[4][name]), err_msg=name)
    iters = got[4]["loop_iterations"].numpy()
    assert (iters[:BLOCK] == iters[0]).all()
    assert (iters[BLOCK:] == iters[BLOCK]).all()
    rtol = 1e-4 if loose else 2e-6

    def atol(a):
        return 1e-4 if loose else a
    for i, name in enumerate(("q", "g", "logp", "draws")):
        _close(got[i], want[i], name, rtol,
               atol({"logp": 2e-5, "g": 1e-5}.get(name, 2e-6)))
    _close(got[4]["step_size"], want[4]["step_size"], "step_size", rtol,
           atol(2e-6))
    for name in ("sum_accept", "sum_accept_sym"):
        _close(got[4][name], want[4][name], name, rtol, atol(5e-5))
    for name in ENERGY_STATS:
        _close(got[4][name], want[4][name], name, rtol,
               5e-4 if loose else 2e-5)


@pytest.mark.parametrize("name,seed,jitter", [
    ("sv", 0, 0.1), ("sv", 3, None), ("radon", 0, 0.1), ("radon", 5, None),
    ("rank1", 0, 0.1), ("funnel", 1, 0.1), ("correlated_normal", 2, None)])
def test_posterior_plain_version_matches_pallas(name, seed, jitter):
    make_j, make_t, layout, *_ = CASES[name]
    jm, tm = make_j(), make_t()
    kind = nf._kernel_kind(tm, tm.dim, layout, MAXDEPTH)
    assert kind == ("ld_args" if layout == "ld" else "mid")
    batched, model_args = _jax_evaluation(jm, layout)
    args = _posterior_inputs(name, jm, seed)
    K = 6
    want = nuts_pallas_run(seed, *args, K, batched,
                           JaxNutsOptions(maxdepth=MAXDEPTH), jitter,
                           block=BLOCK, interpret=True,
                           model_args=model_args, layout=layout)
    got = nf.nuts_fused_run_reference(
        seed, *map(_t, args), K, tm, NutsOptions(maxdepth=MAXDEPTH), jitter,
        block=BLOCK, layout=layout)
    _check_posterior(got, want, loose=name in ("sv", "funnel"))
    # the trees are not trivial: several depths, and some long ones
    depth = got[4]["depth"].numpy()
    assert depth.max() >= 2 and len(np.unique(depth)) >= 2


def _warmup_inputs(name, jm, seed, K):
    """A warmup launch's inputs: estimator updates and dual averaging on
    every draw; a mass-matrix update, a window switch with an update, and
    the late estimator with the best-guess step."""
    q0, g0, logp0, stds, _, _, step, _ = _posterior_inputs(name, jm, seed)
    C, dim = q0.shape
    mean = np.zeros((C, dim), np.float32)
    est = np.zeros((C, 8, dim), np.float32)
    est[:, 0], est[:, 2], est[:, 4], est[:, 6] = q0, g0, q0, g0
    sca = np.zeros((C, nf.NSCA), np.float32)
    sca[:, nf.SCA_STEP] = step
    sca[:, nf.SCA_DA_LS] = sca[:, nf.SCA_DA_LSA] = np.log(step)
    sca[:, nf.SCA_DA_MU] = np.log(10 * step)
    sca[:, nf.SCA_DA_CNT] = sca[:, nf.SCA_CNT_FG] = sca[:, nf.SCA_CNT_BG] = 1
    sca[:, nf.SCA_LOGDET] = np.sum(np.log(1 / stds), 1)
    flags = np.zeros((K, nf.NFLAGS), np.int32)
    flags[:, nf.FLAG_UPDATE_EST] = flags[:, nf.FLAG_ADVANCE_DA] = 1
    flags[2, nf.FLAG_DO_UPDATE] = 1
    flags[3, nf.FLAG_DO_SWITCH] = flags[3, nf.FLAG_DO_UPDATE] = 1
    flags[4, nf.FLAG_USE_LATE] = flags[4, nf.FLAG_USE_BEST] = 1
    return flags, q0, g0, logp0, stds, mean, est, sca


@pytest.mark.parametrize("name,seed,use_grad_based", [
    ("sv", 0, True), ("sv", 4, False), ("radon", 0, True),
    ("rank1", 3, False)])
def test_warmup_plain_version_matches_pallas(name, seed, use_grad_based):
    make_j, make_t, layout, *_ = CASES[name]
    jm, tm = make_j(), make_t()
    batched, model_args = _jax_evaluation(jm, layout)
    K = 5
    args = _warmup_inputs(name, jm, seed, K)
    want = nuts_pallas_warmup_run(
        seed, *args, batched, JaxNutsOptions(maxdepth=MAXDEPTH),
        jnt.DiagNutsSettings().step_size, use_grad_based, block=BLOCK,
        interpret=True, model_args=model_args, layout=layout, _split=False)
    got = nf.nuts_fused_warmup_run_reference(
        seed, *map(_t, args), tm, NutsOptions(maxdepth=MAXDEPTH),
        StepSizeSettings(), use_grad_based, block=BLOCK, layout=layout)
    for stat in INT_STATS + ("transformation_index",):
        np.testing.assert_array_equal(got[8][stat].numpy(),
                                      np.asarray(want[8][stat]),
                                      err_msg=stat)
    assert set(np.asarray(want[8]["transformation_index"]).ravel()) \
        >= {0.0, 1.0, 2.0}
    rtol, atol = (1e-3, 2e-3) if name == "sv" else (1e-4, 1e-4)
    for i, what in enumerate(("q", "g", "logp", "stds", "mean", "est",
                              "sca", "draws")):
        _close(got[i], want[i], what, rtol,
               2e-3 if what in ("g", "est") else atol)
    for stat in set(nf.WARMUP_STAT_NAMES) - set(INT_STATS):
        _close(got[8][stat], want[8][stat], stat,
               2e-2 if stat == "max_energy_error" and name == "sv" else rtol,
               2e-3 if stat == "fisher_distance" else atol)


def test_cpu_tensors_take_the_plain_versions_and_count_no_launch():
    """On CPU tensors the wrappers run the plain versions of K1-ld-args and
    K2-ld-args (the kernel kind of a functor without the term / finish
    form in the ld layout) and launch nothing."""
    jm, tm = CASES["sv"][0](), CASES["sv"][1]()
    before = dict(nf.LAUNCHES)
    opts = NutsOptions(maxdepth=MAXDEPTH)
    args = list(map(_t, _posterior_inputs("sv", jm, 1)))
    got = nf.nuts_fused_run(1, *args, 3, tm, opts, 0.1, block=BLOCK,
                            layout="ld")
    want = nf.nuts_fused_run_reference(1, *args, 3, tm, opts, 0.1,
                                       block=BLOCK, layout="ld")
    for a, b in zip(got[:4], want[:4]):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert nf.LAUNCHES == before
    assert {"nuts_fused_ld_args_posterior", "nuts_fused_ld_args_warmup"} \
        <= set(nf.LAUNCHES)
    # iid_normal keeps K1-ld / K2-ld; funnel and every model with data at
    # any d take the mid-d kernels in cl, the ld_args kernels in ld
    normal = tg.normal_logp(300)
    assert nf._kernel_kind(normal, 300, "ld") == "ld"
    assert nf._kernel_kind(tg.funnel(300), 300, "ld") == "ld_args"
    assert nf.cl_kernel(tg.funnel(10), 10, 10) == "mid"
    assert nf.cl_kernel(tg.correlated_normal(4), 4, 10) == "mid"
    assert nf.cl_kernel(tg.normal_logp(4), 4, 10) == "thread"
    assert nf._check_block(512, None, "ld_args") == 1


def _moments_agree(a, b, what, tol):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert abs(a.mean() - b.mean()) < tol * max(a.std(), b.std(), 0.05), what


@pytest.mark.parametrize("name", ["radon", "sv"])
def test_fused_engine_matches_the_sync_engine_on_the_cpu(name):
    """Radon (J = 12, 8 rows a group) and stochastic volatility (T = 62)
    through ``sample``: the fused plain versions (radon's K2-args / K1-args,
    SV's too at d = 64, below the cl limit) against the sync engine, in
    distribution, as the JAX package's engines are held against each other
    (tests/test_hierarchical.py, tests/test_stochastic_volatility.py)."""
    if name == "radon":
        make = lambda: th.radon(J=12, n_per=8, seed=1)  # noqa: E731
        names = {"mu_a": lambda p: p[..., 0], "beta": lambda p: p[..., 1],
                 "sigma": lambda p: np.exp(p[..., 2])}
        tol, kw = 0.3, dict(num_tune=150, num_draws=100)
    else:
        make = lambda: tsv.stochastic_volatility(T=62, seed=0)  # noqa: E731
        names = {"sigma": lambda p: np.exp(p[..., 0]),
                 "nu": lambda p: np.exp(p[..., 1])}
        tol, kw = 0.35, dict(num_tune=120, num_draws=80)
    before = dict(nf.LAUNCHES)
    traces = {}
    for kernel in ("pallas", "sync"):
        traces[kernel] = tnt.sample(make(), tnt.DiagNutsSettings(
            num_chains=4, seed=0, posterior_kernel=kernel, **kw),
            device="cpu")
    assert nf.LAUNCHES == before
    for kernel, trace in traces.items():
        pos = trace.posterior["position"]
        assert np.isfinite(pos).all()
        assert trace.sample_stats["diverging"].mean() < 0.05, kernel
    for what, fn in names.items():
        _moments_agree(fn(traces["pallas"].posterior["position"]),
                       fn(traces["sync"].posterior["position"]), what, tol)

