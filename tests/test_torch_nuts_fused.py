"""The fused kernels' plain PyTorch versions against the Pallas kernels.

``nuts_fused_run_reference`` (K1) and ``nuts_fused_warmup_run_reference``
(K2) use the Pallas kernels' counter-hash random sites, salts and chain
blocks, so they replay ``nuts_pallas_run`` / ``nuts_pallas_warmup_run`` in
interpret mode draw for draw: integer stats (depth, n_steps, divergence,
index in trajectory, maxdepth reached, loop iterations, transformation
index) are equal, floats agree to f32 rounding.

Float tolerances: XLA's exp/log/cos differ from PyTorch's CPU kernels by an
ulp on about a tenth of the inputs (tests/test_torch_rng.py), so values
carry a few ulp of their operands.  Draws and the accept sums are held to
rtol 2e-6 / atol 1e-6, as test_kernel_equivalence.py holds the JAX kernel
to its naive replay; energies are differences of O(1-10) terms, whose ulp
is ~1e-6, so the energy-derived stats take atol 1e-5.  In the warmup
launch the adapted step sizes reach pi early on and long trajectories
amplify those ulp differences over the draws of one launch to ~1e-5 of
the O(1) positions: its floats are held to rtol 1e-4 / atol 1e-4.

The kernels themselves run only on a CUDA card:
tests/test_torch_kernels_cuda.py holds them against these plain versions.
"""

import jax
import numpy as np
import pytest
import torch

import nuts_rs_tpu as nt
from nuts_rs_tpu.kernels.nuts import NutsOptions as JaxNutsOptions
from nuts_rs_tpu.kernels.nuts_pallas import (
    nuts_pallas_run,
    nuts_pallas_warmup_run,
)
from nuts_rs_tpu.models import gaussian as jg
from nuts_rs_tpu_torch.adapt.step_size import StepSizeSettings
from nuts_rs_tpu_torch.kernels import nuts_fused as nf
from nuts_rs_tpu_torch.kernels.nuts import NutsOptions
from nuts_rs_tpu_torch.models import gaussian as tg

MU = 0.5
INT_STATS = ("depth", "diverging", "n_steps", "index_in_trajectory",
             "maxdepth_reached", "loop_iterations")
ENERGY_STATS = ("max_energy_error", "logp", "energy", "energy_error",
                "fisher_distance")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _jax_batched(dim):
    # the JAX runners' evaluation for a model without Pallas hooks
    # (chain.py:689-690)
    model = jg.normal_logp(dim, MU)

    def logp_grad_batched(q):
        return jax.vmap(model.logp_and_grad, in_axes=1, out_axes=(0, 1))(q)
    return logp_grad_batched


def _t(x):
    return torch.from_numpy(np.array(x))


def _posterior_inputs(seed, C=4, dim=3):
    rng = np.random.default_rng(seed)
    q0 = rng.normal(size=(C, dim)).astype(np.float32)
    stds = np.broadcast_to(np.array([1.0, 0.5, 2.0], np.float32),
                           (C, dim)).copy()
    mean = (0.1 * rng.normal(size=(C, dim))).astype(np.float32)
    logdet = np.sum(np.log(1 / stds), 1).astype(np.float32)
    logp0 = (-0.5 * np.sum((q0 - MU) ** 2, 1)).astype(np.float32)
    g0 = (-(q0 - MU)).astype(np.float32)
    step = np.full(C, 0.35, np.float32)
    bar = np.full(C, 0.3, np.float32)
    return q0, g0, logp0, stds, mean, logdet, step, bar


def _close(got, want, what, rtol, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=what)


@pytest.mark.parametrize("jitter", [None, 0.1])
@pytest.mark.parametrize("seed", [0, 7])
def test_posterior_plain_version_matches_pallas(seed, jitter):
    dim, C, K = 3, 4, 4
    args = _posterior_inputs(seed, C, dim)
    want = nuts_pallas_run(seed, *args, K, _jax_batched(dim),
                           JaxNutsOptions(maxdepth=5), jitter, block=C,
                           interpret=True)
    got = nf.nuts_fused_run_reference(
        seed, *map(_t, args), K, tg.normal_logp(dim, MU),
        NutsOptions(maxdepth=5), jitter, block=C)
    for name in INT_STATS:
        np.testing.assert_array_equal(got[4][name].numpy(),
                                      np.asarray(want[4][name]), err_msg=name)
    for i, name in enumerate(("q", "g", "logp", "draws")):
        _close(got[i], want[i], name, 2e-6, 1e-6)
    for name in ("sum_accept", "sum_accept_sym", "step_size"):
        _close(got[4][name], want[4][name], name, 2e-6, 1e-6)
    for name in ENERGY_STATS:
        _close(got[4][name], want[4][name], name, 2e-6, 1e-5)


def _warmup_inputs(seed, C, dim, K):
    q0, g0, logp0, stds, _, _, _, _ = _posterior_inputs(seed, C, dim)
    mean = np.zeros((C, dim), np.float32)
    est = np.zeros((C, 8, dim), np.float32)
    est[:, 0], est[:, 2], est[:, 4], est[:, 6] = q0, g0, q0, g0
    sca = np.zeros((C, nf.NSCA), np.float32)
    sca[:, nf.SCA_STEP] = 0.4
    sca[:, nf.SCA_DA_LS] = sca[:, nf.SCA_DA_LSA] = np.log(0.4)
    sca[:, nf.SCA_DA_MU] = np.log(4.0)
    sca[:, nf.SCA_DA_CNT] = sca[:, nf.SCA_CNT_FG] = sca[:, nf.SCA_CNT_BG] = 1
    sca[:, nf.SCA_LOGDET] = np.sum(np.log(1 / stds), 1)
    # estimator updates and dual averaging on every draw; a mass-matrix
    # update, a window switch with an update, the late estimator, and the
    # best-guess step with an update
    flags = np.zeros((K, nf.NFLAGS), np.int32)
    flags[:, nf.FLAG_UPDATE_EST] = flags[:, nf.FLAG_ADVANCE_DA] = 1
    flags[2, nf.FLAG_DO_UPDATE] = 1
    flags[3, nf.FLAG_DO_SWITCH] = flags[3, nf.FLAG_DO_UPDATE] = 1
    flags[4, nf.FLAG_USE_LATE] = 1
    flags[5, nf.FLAG_USE_BEST] = flags[5, nf.FLAG_DO_UPDATE] = 1
    return flags, q0, g0, logp0, stds, mean, est, sca


@pytest.mark.parametrize("seed,use_grad_based", [(0, True), (7, False)])
def test_warmup_plain_version_matches_pallas(seed, use_grad_based):
    dim, C, K, B = 3, 8, 6, 4
    args = _warmup_inputs(seed, C, dim, K)
    want = nuts_pallas_warmup_run(
        seed, *args, _jax_batched(dim), JaxNutsOptions(maxdepth=5),
        nt.DiagNutsSettings().step_size, use_grad_based, block=B,
        interpret=True, _split=False)
    got = nf.nuts_fused_warmup_run_reference(
        seed, *map(_t, args), tg.normal_logp(dim, MU),
        NutsOptions(maxdepth=5), StepSizeSettings(), use_grad_based, block=B)
    for name in INT_STATS + ("transformation_index",):
        np.testing.assert_array_equal(got[8][name].numpy(),
                                      np.asarray(want[8][name]), err_msg=name)
    assert set(np.asarray(want[8]["transformation_index"]).ravel()) \
        >= {0.0, 1.0, 2.0}
    for i, name in enumerate(("q", "g", "logp", "stds", "mean", "est", "sca",
                              "draws")):
        _close(got[i], want[i], name, 1e-4, 1e-4)
    for name in set(nf.WARMUP_STAT_NAMES) - set(INT_STATS):
        _close(got[8][name], want[8][name], name, 1e-4, 1e-4)


def test_cpu_tensors_take_the_plain_version():
    before = dict(nf.LAUNCHES)
    model, opts = tg.normal_logp(3, MU), NutsOptions(maxdepth=5)
    args = list(map(_t, _posterior_inputs(1)))
    got = nf.nuts_fused_run(1, *args, 3, model, opts, 0.1)
    want = nf.nuts_fused_run_reference(1, *args, 3, model, opts, 0.1)
    for a, b in zip(got[:4], want[:4]):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    wargs = list(map(_t, _warmup_inputs(1, 4, 3, 6)))
    got = nf.nuts_fused_warmup_run(1, *wargs, model, opts, StepSizeSettings(),
                                   True)
    want = nf.nuts_fused_warmup_run_reference(1, *wargs, model, opts,
                                              StepSizeSettings(), True)
    for a, b in zip(got[:8], want[:8]):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert nf.LAUNCHES == before


def test_wrappers_reject_what_the_kernels_do_not_take():
    model, opts = tg.normal_logp(3, MU), NutsOptions(maxdepth=5)
    args = list(map(_t, _posterior_inputs(2)))
    bad_dtype = list(args)
    bad_dtype[0] = args[0].double()
    bad_layout = list(args)
    bad_layout[3] = args[3].T.contiguous().T
    bad_shape = list(args)
    bad_shape[5] = args[5][:2]
    for bad in (bad_dtype, bad_layout, bad_shape):
        with pytest.raises(ValueError):
            nf.nuts_fused_run(0, *bad, 2, model, opts, None)
    wargs = list(map(_t, _warmup_inputs(2, 4, 3, 6)))
    wargs[0] = wargs[0].long()
    with pytest.raises(ValueError, match="flags"):
        nf.nuts_fused_warmup_run(0, *wargs, model, opts, StepSizeSettings(),
                                 True)
