"""The fused MCLMC kernels' plain PyTorch versions against the Pallas
kernels.

``mclmc_fused_run_reference`` (K3) and ``mclmc_fused_warmup_run_reference``
(K4) use the Pallas kernels' counter-hash random sites, salts and chain
blocks, so they replay ``mclmc_pallas_run`` / ``mclmc_pallas_warmup_run`` in
interpret mode draw for draw: the integer stats (divergence, n_steps, loop
iterations, transformation index) are equal, floats agree to f32 rounding.

Float tolerances: XLA's exp/log/cos differ from PyTorch's CPU kernels by an
ulp on about a tenth of the inputs (tests/test_torch_rng.py), so values
carry a few ulp of their operands, and one launch amplifies them: a chain
carries its position and momentum through every leapfrog of all its K
draws (up to ~25 leapfrogs a draw with halvings), and each ESH half step
and refresh renormalises the momentum through exp, log and sqrt.  Measured
over the cases below, the posterior's floats differ by at most 3.5e-6 and
its energies by 4.9e-6 on O(1-10) values: they are held to rtol 1e-5 /
atol 1e-5; the step sizes, which no trajectory touches, to rtol 2e-6 /
atol 1e-6.  The warmup launch also feeds each draw's end point into the
mass matrix and the next draw starts there (estimator planes differ by up
to 8e-5): its floats are held to rtol 1e-4 / atol 1e-4, as the NUTS
warmup's are (tests/test_torch_nuts_fused.py).

The kernels themselves run only on a CUDA card:
tests/test_torch_kernels_cuda.py holds them against these plain versions.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nuts_rs_tpu.adapt.step_size import StepSizeMethod as JaxMethod
from nuts_rs_tpu.adapt.step_size import StepSizeSettings as JaxStepSettings
from nuts_rs_tpu.dynamics.hamiltonian import KineticKind as JaxKind
from nuts_rs_tpu.kernels.mclmc import MclmcOptions as JaxMclmcOptions
from nuts_rs_tpu.kernels.mclmc_pallas import (
    mclmc_pallas_run,
    mclmc_pallas_warmup_run,
)
from nuts_rs_tpu_torch.adapt.step_size import StepSizeMethod, StepSizeSettings
from nuts_rs_tpu_torch.dynamics.hamiltonian import KineticKind
from nuts_rs_tpu_torch.kernels import mclmc_fused as mf
from nuts_rs_tpu_torch.kernels.mclmc import MclmcOptions
from nuts_rs_tpu_torch.models import gaussian as tg

MU = 0.5
INT_STATS = ("diverging", "n_steps", "loop_iterations")
ENERGY_STATS = ("energy_change", "logp", "energy", "fisher_distance")
MICRO, EUCL = "micro", "eucl"


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _jax_batched(q):  # [d, B] -> ([B], [d, B]), N(MU, 1) in every coordinate
    return -0.5 * jnp.sum((q - MU) ** 2, 0), -(q - MU)


def _opts(kind, max_err, dynamic=True):
    jk = JaxKind.MICROCANONICAL if kind == MICRO else JaxKind.EUCLIDEAN
    tk = (KineticKind.MICROCANONICAL if kind == MICRO
          else KineticKind.EUCLIDEAN)
    kw = dict(max_energy_error=max_err, dynamic_step_size=dynamic)
    return JaxMclmcOptions(kind=jk, **kw), MclmcOptions(kind=tk, **kw)


def _t(x):
    return torch.from_numpy(np.array(x))


def _posterior_inputs(seed, C, dim, step):
    rng = np.random.default_rng(seed)
    q = (MU + rng.normal(size=(C, dim))).astype(np.float32)
    g = (-(q - MU)).astype(np.float32)
    logp = (-0.5 * np.sum((q - MU) ** 2, 1)).astype(np.float32)
    v = rng.normal(size=(C, dim))
    v = (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)
    stds = rng.uniform(0.6, 1.6, size=(C, dim)).astype(np.float32)
    mean = (MU + 0.2 * rng.normal(size=(C, dim))).astype(np.float32)
    logdet = (-np.sum(np.log(stds), 1)).astype(np.float32)
    steps = np.full(C, step, np.float32)
    return q, g, logp, v, stds, mean, logdet, steps, steps.copy()


def _close(got, want, what, rtol, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=what)


# max_err < 1 exercises the halving stack (dynamic) or give-ups (without
# halvings every divergence gives up)
@pytest.mark.parametrize("kind,max_err,dynamic,step,jitter", [
    (MICRO, 1000.0, True, 0.6, 0.1),
    (MICRO, 0.05, True, 1.4, 0.1),
    (MICRO, 0.02, False, 1.4, 0.1),
    (EUCL, 1000.0, True, 0.6, None),
    (EUCL, 0.02, False, 0.9, 0.1),
])
def test_posterior_plain_version_matches_pallas(kind, max_err, dynamic, step,
                                                jitter):
    dim, C, K, seed = 4, 4, 6, 3
    jopts, topts = _opts(kind, max_err, dynamic)
    args = _posterior_inputs(seed, C, dim, step)
    want = mclmc_pallas_run(seed, *args, K, _jax_batched, jopts, jitter,
                            block=C, interpret=True)
    got = mf.mclmc_fused_run_reference(seed, *map(_t, args), K,
                                       tg.normal_logp(dim, MU), topts,
                                       jitter, block=C)
    for name in INT_STATS:
        np.testing.assert_array_equal(got[5][name].numpy(),
                                      np.asarray(want[5][name]), err_msg=name)
    for i, name in enumerate(("q", "g", "logp", "v", "draws")):
        _close(got[i], want[i], name, 1e-5, 1e-5)
    for name in ("average_step_size", "step_size"):
        _close(got[5][name], want[5][name], name, 2e-6, 1e-6)
    for name in ENERGY_STATS:
        _close(got[5][name], want[5][name], name, 1e-5, 1e-5)
    _exercised(got[5], max_err, dynamic)


def _exercised(stats, max_err, dynamic):
    """The case exercises what it is there for."""
    if max_err < 1.0 and dynamic:
        halved = stats["average_step_size"] < stats["step_size"] * 0.99
        assert bool(halved.any())
    if max_err < 1.0 and not dynamic:
        assert bool((stats["diverging"] > 0).any())


def _warmup_inputs(seed, C, dim, K):
    q, g, logp, v, stds, _, _, _, _ = _posterior_inputs(seed, C, dim, 0.5)
    mean = np.zeros((C, dim), np.float32)
    est = np.zeros((C, 8, dim), np.float32)
    est[:, 0], est[:, 2], est[:, 4], est[:, 6] = q, g, q, g
    sca = np.zeros((C, mf.NSCA), np.float32)
    sca[:, mf.SCA_CNT_FG] = sca[:, mf.SCA_CNT_BG] = 1
    sca[:, mf.SCA_LOGDET] = -np.sum(np.log(stds), 1)
    sca[:, mf.SCA_TID] = 2
    # the momentum resample on draw 0, estimator updates on every draw, a
    # mass-matrix update, a window switch with an update, and a resample
    # again at a later draw (the trajectory switch)
    flags = np.zeros((K, mf.NFLAGS), np.int32)
    flags[:, mf.FLAG_UPDATE_EST] = 1
    flags[0, mf.FLAG_RESAMPLE] = flags[4, mf.FLAG_RESAMPLE] = 1
    flags[2, mf.FLAG_DO_UPDATE] = 1
    flags[3, mf.FLAG_DO_SWITCH] = flags[3, mf.FLAG_DO_UPDATE] = 1
    flags[5, mf.FLAG_DO_UPDATE] = 1
    return flags, q, g, logp, v, stds, mean, est, sca


@pytest.mark.parametrize("kind,max_err,dynamic,use_grad_based,jitter", [
    (MICRO, 1000.0, True, True, 0.1),
    (MICRO, 0.05, False, True, None),
    (EUCL, 0.1, True, False, None),
])
def test_warmup_plain_version_matches_pallas(kind, max_err, dynamic,
                                             use_grad_based, jitter):
    dim, C, K, B, seed = 3, 8, 6, 4, 5
    jopts, topts = _opts(kind, max_err, dynamic)
    args = _warmup_inputs(seed, C, dim, K)
    jsset = JaxStepSettings(method=JaxMethod.FIXED, fixed_value=0.8,
                            jitter=jitter)
    tsset = StepSizeSettings(method=StepSizeMethod.FIXED, fixed_value=0.8,
                             jitter=jitter)
    want = mclmc_pallas_warmup_run(seed, *args, _jax_batched, jopts, jsset,
                                   use_grad_based, block=B, interpret=True)
    got = mf.mclmc_fused_warmup_run_reference(
        seed, *map(_t, args), tg.normal_logp(dim, MU), topts, tsset,
        use_grad_based, block=B)
    for name in INT_STATS + ("transformation_index",):
        np.testing.assert_array_equal(got[9][name].numpy(),
                                      np.asarray(want[9][name]), err_msg=name)
    if dynamic:  # give-ups feed the estimators too rarely to update
        assert set(np.asarray(want[9]["transformation_index"]).ravel()) \
            >= {3.0, 4.0}
    for i, name in enumerate(("q", "g", "logp", "v", "stds", "mean", "est",
                              "sca", "draws")):
        _close(got[i], want[i], name, 1e-4, 1e-4)
    for name in set(mf.WARMUP_STAT_NAMES) - set(INT_STATS):
        _close(got[9][name], want[9][name], name, 1e-4, 1e-4)
    _exercised(got[9], max_err, dynamic)


def test_cpu_tensors_take_the_plain_version():
    before = dict(mf.LAUNCHES)
    model = tg.normal_logp(3, MU)
    _, opts = _opts(MICRO, 1000.0)
    args = list(map(_t, _posterior_inputs(1, 4, 3, 0.5)))
    got = mf.mclmc_fused_run(1, *args, 3, model, opts, 0.1)
    want = mf.mclmc_fused_run_reference(1, *args, 3, model, opts, 0.1)
    for a, b in zip(got[:5], want[:5]):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    sset = StepSizeSettings(method=StepSizeMethod.FIXED, fixed_value=0.5)
    wargs = list(map(_t, _warmup_inputs(1, 4, 3, 6)))
    got = mf.mclmc_fused_warmup_run(1, *wargs, model, opts, sset, True)
    want = mf.mclmc_fused_warmup_run_reference(1, *wargs, model, opts, sset,
                                               True)
    for a, b in zip(got[:9], want[:9]):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert mf.LAUNCHES == before


def test_wrappers_reject_what_the_kernels_do_not_take():
    model = tg.normal_logp(3, MU)
    _, opts = _opts(MICRO, 1000.0)
    args = list(map(_t, _posterior_inputs(2, 4, 3, 0.5)))
    bad_v = list(args)
    bad_v[3] = args[3][:, :2].contiguous()
    bad_layout = list(args)
    bad_layout[4] = args[4].T.contiguous().T
    for bad in (bad_v, bad_layout):
        with pytest.raises(ValueError):
            mf.mclmc_fused_run(0, *bad, 2, model, opts, None)
    # the ESH step divides by dim - 1
    one = [a[:, :1].contiguous() if a.dim() == 2 else a for a in args]
    with pytest.raises(ValueError, match="dim >= 2"):
        mf.mclmc_fused_run(0, *one, 2, tg.normal_logp(1, MU), opts, None)
    sset = StepSizeSettings(method=StepSizeMethod.FIXED)
    wargs = list(map(_t, _warmup_inputs(2, 4, 3, 6)))
    wargs[8] = torch.zeros(4, 10)  # the NUTS warmup's scalar rows
    with pytest.raises(ValueError, match="sca"):
        mf.mclmc_fused_warmup_run(0, *wargs, model, opts, sset, True)
