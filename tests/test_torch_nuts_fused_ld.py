"""The dim-on-lanes (``layout="ld"``) plain versions against Pallas.

``nuts_fused_run_reference`` (K1-ld) and ``nuts_fused_warmup_run_reference``
(K2-ld) with ``layout="ld"`` replay ``nuts_pallas_run`` /
``nuts_pallas_warmup_run`` with ``layout="ld"`` in interpret mode draw for
draw, from the same numpy-seeded inputs and the same logical chain block,
on two blocks: the integer stats are equal, floats agree to f32 rounding.
What ld changes against cl is the index of a vector random site
(``b * d + j``) and the order of every sum over the parameter axis
(``ops.tsum``, the CUDA kernels' order); both are held here too.

Float tolerances: as in tests/test_torch_nuts_fused.py (XLA's and PyTorch's
exp/log/cos differ by an ulp on a tenth of inputs).  The tree-ordered
``tsum`` against XLA's sum adds nothing measurable at d = 5: both sum five
terms, in another order, so a sum carries at most two more ulp.  K1 keeps
rtol 2e-6 / atol 1e-6 (energies atol 1e-5), K2 keeps rtol 1e-4 / atol 1e-4.

The kernels themselves run only on a CUDA card:
tests/test_torch_kernels_cuda.py holds them against these plain versions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nuts_rs_tpu as nt
from nuts_rs_tpu.kernels.nuts import NutsOptions as JaxNutsOptions
from nuts_rs_tpu.kernels.nuts_pallas import (
    _hash_bits,
    nuts_pallas_run,
    nuts_pallas_warmup_run,
)
from nuts_rs_tpu.models import gaussian as jg
from nuts_rs_tpu_torch.adapt.step_size import StepSizeSettings
from nuts_rs_tpu_torch.kernels import nuts_fused as nf
from nuts_rs_tpu_torch.kernels.nuts import NutsOptions
from nuts_rs_tpu_torch.kernels.rng import PID_MUL, BlockRng, hash_bits
from nuts_rs_tpu_torch.models import gaussian as tg
from nuts_rs_tpu_torch.ops import TSUM_THREADS, dsum, tsum

MU = 3.0
DIM, CHAINS, BLOCK, MAXDEPTH = 5, 8, 4, 6
INT_STATS = ("depth", "diverging", "n_steps", "index_in_trajectory",
             "maxdepth_reached", "loop_iterations")
ENERGY_STATS = ("max_energy_error", "logp", "energy", "energy_error",
                "fisher_distance")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _jax_batched_ld(dim):
    # the JAX runners' [B, d] evaluation in the ld tier (chain.py:805-807)
    model = jg.normal_logp(dim, MU)

    def logp_grad_batched(q):
        return jax.vmap(model.logp_and_grad, in_axes=0, out_axes=(0, 0))(q)
    return logp_grad_batched


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, what, rtol, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=what)


def _posterior_inputs(seed, C=CHAINS, dim=DIM):
    rng = np.random.default_rng(seed)
    q0 = (MU + rng.normal(size=(C, dim))).astype(np.float32)
    stds = rng.uniform(0.5, 2.0, size=(C, dim)).astype(np.float32)
    mean = (MU + 0.1 * rng.normal(size=(C, dim))).astype(np.float32)
    logdet = np.sum(np.log(1 / stds), 1).astype(np.float32)
    logp0 = (-0.5 * np.sum((q0 - MU) ** 2, 1)).astype(np.float32)
    g0 = (-(q0 - MU)).astype(np.float32)
    step = np.full(C, 0.35, np.float32)
    bar = np.full(C, 0.3, np.float32)
    return q0, g0, logp0, stds, mean, logdet, step, bar


@pytest.mark.parametrize("jitter", [None, 0.1])
@pytest.mark.parametrize("seed", [0, 7])
def test_ld_posterior_plain_version_matches_pallas(seed, jitter):
    K = 4
    args = _posterior_inputs(seed)
    want = nuts_pallas_run(seed, *args, K, _jax_batched_ld(DIM),
                           JaxNutsOptions(maxdepth=MAXDEPTH), jitter,
                           block=BLOCK, interpret=True, layout="ld")
    got = nf.nuts_fused_run_reference(
        seed, *map(_t, args), K, tg.normal_logp(DIM, MU),
        NutsOptions(maxdepth=MAXDEPTH), jitter, block=BLOCK, layout="ld")
    for name in INT_STATS:
        np.testing.assert_array_equal(got[4][name].numpy(),
                                      np.asarray(want[4][name]), err_msg=name)
    # two logical blocks with their own iteration counts
    iters = got[4]["loop_iterations"].numpy()
    assert (iters[:BLOCK] == iters[0]).all()
    assert (iters[BLOCK:] == iters[BLOCK]).all()
    for i, name in enumerate(("q", "g", "logp", "draws")):
        _close(got[i], want[i], name, 2e-6, 1e-6)
    for name in ("sum_accept", "sum_accept_sym", "step_size"):
        _close(got[4][name], want[4][name], name, 2e-6, 1e-6)
    for name in ENERGY_STATS:
        _close(got[4][name], want[4][name], name, 2e-6, 1e-5)


def _warmup_inputs(seed, K, C=CHAINS, dim=DIM):
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
def test_ld_warmup_plain_version_matches_pallas(seed, use_grad_based):
    K = 6
    args = _warmup_inputs(seed, K)
    want = nuts_pallas_warmup_run(
        seed, *args, _jax_batched_ld(DIM), JaxNutsOptions(maxdepth=MAXDEPTH),
        nt.DiagNutsSettings().step_size, use_grad_based, block=BLOCK,
        interpret=True, layout="ld", _split=False)
    got = nf.nuts_fused_warmup_run_reference(
        seed, *map(_t, args), tg.normal_logp(DIM, MU),
        NutsOptions(maxdepth=MAXDEPTH), StepSizeSettings(), use_grad_based,
        block=BLOCK, layout="ld")
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


def test_ld_differs_from_cl_only_in_sites_and_sums():
    """With one chain per block a vector site has the same index in both
    layouts (b = 0, B = 1: ``j`` either way), so only the order of the sums
    differs: the trees agree in the integer stats and the draws agree to
    rounding.  At a block of 4 the vector sites differ, and so do the
    draws."""
    K, C = 3, 4
    args = list(map(_t, _posterior_inputs(3, C)))
    model, opts = tg.normal_logp(DIM, MU), NutsOptions(maxdepth=MAXDEPTH)
    cl = nf.nuts_fused_run_reference(3, *args, K, model, opts, 0.1, block=1)
    ld = nf.nuts_fused_run_reference(3, *args, K, model, opts, 0.1, block=1,
                                     layout="ld")
    for name in INT_STATS:
        np.testing.assert_array_equal(cl[4][name].numpy(),
                                      ld[4][name].numpy(), err_msg=name)
    _close(ld[3], cl[3], "draws", 1e-5, 1e-5)
    cl4 = nf.nuts_fused_run_reference(3, *args, K, model, opts, 0.1, block=4)
    ld4 = nf.nuts_fused_run_reference(3, *args, K, model, opts, 0.1, block=4,
                                      layout="ld")
    assert not np.allclose(cl4[3].numpy(), ld4[3].numpy())


@pytest.mark.parametrize("d", [1, 5, 255, 256, 257, 1000])
def test_tsum_order(d):
    """``tsum`` equals a numpy replay of its documented order bit for bit,
    and ``torch.sum`` / ``dsum`` to rounding."""
    T, W = TSUM_THREADS, TSUM_THREADS // 32
    rng = np.random.default_rng(d)
    x = (rng.normal(size=(3, 2, d)) * 10.0).astype(np.float32)
    got = tsum(_t(x)).numpy()
    assert got.dtype == np.float32 and got.shape == (3, 2)
    n = -(-d // T)
    want = np.zeros((3, 2), np.float32)
    for idx in np.ndindex(3, 2):
        part = np.zeros(T, np.float32)
        for t in range(T):
            s = np.float32(0.0)
            for i in range(n):
                j = t + i * T
                v = x[idx][j] if j < d else np.float32(0.0)
                s = v if i == 0 else np.float32(s + v)
            part[t] = s
        warp = part.reshape(W, 32)
        for h in (16, 8, 4, 2, 1):       # the shuffle butterfly of a warp
            warp = (warp[:, :h] + warp[:, h:2 * h]).astype(np.float32)
        w = warp[:, 0]
        for h in (4, 2, 1):              # the warps' sums
            w = (w[:h] + w[h:2 * h]).astype(np.float32)
        want[idx] = w[0]
    np.testing.assert_array_equal(got, want)
    exact = x.astype(np.float64).sum(-1)
    scale = np.abs(x).astype(np.float64).sum(-1)
    assert np.all(np.abs(got - exact) <= 1e-6 * scale)
    np.testing.assert_allclose(got, torch.sum(_t(x), -1).numpy(),
                               rtol=0, atol=float(1e-6 * scale.max()))
    np.testing.assert_allclose(got, dsum(_t(x)).numpy(),
                               rtol=0, atol=float(2e-6 * scale.max()))


@pytest.mark.parametrize("it", [0, 1, 977])
def test_ld_block_rng_bits_match_hash_bits(it):
    """The ld vector site of chain c = pid * B + b, coordinate j, is element
    ``b * d + j`` of ``_hash_bits((B, d), ...)`` under the block's seed."""
    C, d, B, seed, salt = 8, 5, 4, 1234, 7
    rng = BlockRng(seed, C, d, B, "cpu", layout="ld")
    got = hash_bits(rng.seed[:, None], it, salt, rng.vidx).numpy()
    got_s = hash_bits(rng.seed, it, salt, rng.sidx).numpy()
    for pid in range(C // B):
        seed_u32 = (jnp.uint32(seed)
                    + jnp.uint32(PID_MUL) * jnp.uint32(pid))
        want = np.asarray(_hash_bits((B, d), seed_u32, jnp.uint32(it), salt))
        np.testing.assert_array_equal(got[pid * B:(pid + 1) * B],
                                      want.astype(np.int64))
        want_s = np.asarray(_hash_bits((B, 1), seed_u32, jnp.uint32(it),
                                       salt))[:, 0]
        np.testing.assert_array_equal(got_s[pid * B:(pid + 1) * B],
                                      want_s.astype(np.int64))
    # and it is not the cl numbering
    cl = BlockRng(seed, C, d, B, "cpu")
    assert not np.array_equal(cl.vidx.numpy(), rng.vidx.numpy())


def test_ld_cpu_tensors_take_the_plain_version():
    before = dict(nf.LAUNCHES)
    model, opts = tg.normal_logp(DIM, MU), NutsOptions(maxdepth=MAXDEPTH)
    args = list(map(_t, _posterior_inputs(1)))
    got = nf.nuts_fused_run(1, *args, 3, model, opts, 0.1, layout="ld")
    want = nf.nuts_fused_run_reference(1, *args, 3, model, opts, 0.1,
                                       layout="ld")
    for a, b in zip(got[:4], want[:4]):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    wargs = list(map(_t, _warmup_inputs(1, 6)))
    got = nf.nuts_fused_warmup_run(1, *wargs, model, opts, StepSizeSettings(),
                                   True, layout="ld")
    want = nf.nuts_fused_warmup_run_reference(
        1, *wargs, model, opts, StepSizeSettings(), True, layout="ld")
    for a, b in zip(got[:8], want[:8]):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert nf.LAUNCHES == before
    with pytest.raises(ValueError, match="layout"):
        nf.nuts_fused_run(1, *args, 3, model, opts, 0.1, layout="dl")


def test_ld_plain_version_evaluates_the_model_as_the_kernel_does():
    """A model's closed form takes the position alone.  The plain versions
    evaluate a model with a device functor through the functor's plain
    counterpart and the layout's sum (``tsum`` in ld, whatever the closed
    form sums with); a model without a functor, whose closed form takes one
    argument, runs as it is."""
    import dataclasses

    from nuts_rs_tpu_torch.models.model import Model

    d = 300
    q = _t((MU + np.random.default_rng(5).normal(size=(4, d)))
           .astype(np.float32))
    model = tg.normal_logp(d, MU)
    csum, evaluate = nf._evaluators(model, "ld")
    assert csum is tsum
    logp, g = evaluate(q)
    np.testing.assert_array_equal(logp.numpy(),
                                  (-0.5 * tsum((q - MU) ** 2)).numpy())
    np.testing.assert_array_equal(g.numpy(), (-(q - MU)).numpy())
    csum, evaluate = nf._evaluators(model, "thread")
    assert csum is dsum
    np.testing.assert_array_equal(evaluate(q)[0].numpy(),
                                  (-0.5 * dsum((q - MU) ** 2)).numpy())
    _close(model.logp_and_grad(q)[0], logp, "host closed form", 2e-6, 0)

    def closed_form(x):
        return -0.5 * torch.sum((x - MU) ** 2, -1), -(x - MU)

    plain = Model(logp_fn=model.logp_fn, dim=DIM, logp_grad_fn=closed_form)
    hooked = dataclasses.replace(plain, kernel_hook=model.kernel_hook)
    args = list(map(_t, _posterior_inputs(2)))
    opts = NutsOptions(maxdepth=MAXDEPTH)
    a = nf.nuts_fused_run_reference(2, *args, 3, plain, opts, 0.1,
                                    block=BLOCK, layout="ld")
    b = nf.nuts_fused_run_reference(2, *args, 3, hooked, opts, 0.1,
                                    block=BLOCK, layout="ld")
    for name in INT_STATS:
        np.testing.assert_array_equal(a[4][name].numpy(), b[4][name].numpy(),
                                      err_msg=name)
    _close(a[3], b[3], "draws", 1e-5, 1e-5)
