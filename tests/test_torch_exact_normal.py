"""The exact-normal kinetic energy of the port (``dynamics/hamiltonian.py``)
and the sync NUTS tree under it (``kernels/nuts.py``) on the CPU, against
the JAX package.

The leapfrog, the trajectory's start and the partial refresh match the JAX
ones on the same inputs in float64 within 1e-12.  The sync tree with
``EXACT_NORMAL`` matches the JAX ``_tree_body`` draw for draw, the JAX
body's three uniforms an iteration replaced by the port's
(tests/test_torch_nuts_sync.py): every integer stat equal, floats within
1e-9.  A run's moments match the analytic ones and the JAX sync engine's
acceptance, and ``build_phases`` plans what the JAX package plans, its
warning included.
"""

import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_nuts_sync import _jax_draw, _torch_setup

import nuts_rs_tpu as jnt
import nuts_rs_tpu.kernels.nuts as jnuts
import nuts_rs_tpu_torch as tnt
from nuts_rs_tpu.dynamics import hamiltonian as jh
from nuts_rs_tpu.models import gaussian as jg
from nuts_rs_tpu.sampler import _strategy_for
from nuts_rs_tpu.transform import affine as ja
from nuts_rs_tpu_torch.adapt import step_size as tss
from nuts_rs_tpu_torch.dynamics import hamiltonian as th
from nuts_rs_tpu_torch.kernels import nuts as tnuts
from nuts_rs_tpu_torch.kernels.rng import host_uniform
from nuts_rs_tpu_torch.models import gaussian as tg
from nuts_rs_tpu_torch.transform import affine as ta

F64 = torch.float64
EXACT = th.KineticKind.EXACT_NORMAL
TOL = dict(rtol=1e-12, atol=1e-12)
C, D = 5, 4


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **TOL)


def _transforms(rng):
    stds = rng.uniform(0.5, 2.0, size=(C, D))
    mean = rng.normal(size=(C, D))
    logdet = np.sum(np.log(1.0 / stds), axis=1)
    ids = np.arange(C, dtype=np.int32)
    jt = ja.AffineTransform(mean=jnp.asarray(mean), stds=jnp.asarray(stds),
                            inv_stds=jnp.asarray(1.0 / stds),
                            logdet=jnp.asarray(logdet), id=jnp.asarray(ids))
    tt = ta.AffineTransform(mean=_t(mean), stds=_t(stds),
                            inv_stds=_t(1.0 / stds), logdet=_t(logdet),
                            id=_t(ids))
    return jt, tt


def _points(seed, mu=-0.5):
    rng = np.random.default_rng(seed)
    jt, tt = _transforms(rng)
    q, v = rng.normal(size=(C, D)), rng.normal(size=(C, D))
    jm, tm = jg.normal_logp(D, mu), tg.normal_logp(D, mu)
    jpt = jax.vmap(lambda qq, t: jh.init_point_from_q(
        qq, t, jm.logp_and_grad))(jnp.asarray(q), jt)
    jpt = jpt._replace(v=jnp.asarray(v),
                       ke=0.5 * jnp.sum(jnp.asarray(v) ** 2, axis=1))
    tpt = th.init_point_from_q(_t(q), tt, tm.logp_and_grad)._replace(
        v=_t(v), ke=_t(0.5 * np.sum(v * v, axis=1)))
    return rng, jt, tt, jm, tm, jpt, tpt


@pytest.mark.parametrize("direction", [1, -1])
@pytest.mark.parametrize("scale", [0.3, 1.4, 3.0])
def test_exact_normal_leapfrog_matches_jax(direction, scale):
    """``v + eps/2 (z + zg)``, the rotation by eps, the second half kick on
    ``z1 + zg1``, ``ke = |v|^2 / 2`` and the ``err > max`` rule; the steps
    reach past pi / 2, where the rotation flips signs."""
    rng, jt, tt, jm, tm, jpt, tpt = _points(3)
    step = rng.uniform(0.5, 1.0, size=C) * scale
    base = np.asarray(jpt.energy) - 0.05
    want = jax.vmap(lambda p, s, t, e: jh.leapfrog(
        p, jnp.int32(direction), s, t, jm.logp_and_grad,
        jh.KineticKind.EXACT_NORMAL, e, 0.1))(
        jpt, jnp.asarray(step), jt, jnp.asarray(base))
    got = th.leapfrog(tpt, direction, _t(step), tt, tm.logp_and_grad, EXACT,
                      _t(base), 0.1)
    for name in want.point._fields:
        _close(getattr(got.point, name), getattr(want.point, name))
    _close(got.energy_error, want.energy_error)
    np.testing.assert_array_equal(got.diverging.numpy(),
                                  np.asarray(want.diverging))


def test_exact_normal_is_exact_on_a_standard_normal():
    """On a standard normal in z the integrator conserves the energy to
    rounding at any step: the property that names it."""
    rng = np.random.default_rng(1)
    tm = tg.normal_logp(D, 0.0)
    tt = ta.identity_transform(C, D, F64, "cpu")
    pt = th.init_point_from_q(_t(rng.normal(size=(C, D))), tt,
                              tm.logp_and_grad)
    pt = th.initialize_trajectory(pt, tt, EXACT, _t(rng.normal(size=(C, D))))
    for step in (0.1, 1.0, 2.5):
        res = th.leapfrog(pt, 1, torch.full((C,), step, dtype=F64), tt,
                          tm.logp_and_grad, EXACT, pt.energy, 1000.0)
        np.testing.assert_allclose(res.energy_error.numpy(), 0.0, atol=1e-12)


def test_exact_normal_momentum_trajectory_and_refresh_match_jax():
    """Gaussian momentum (not on the sphere), ``ke = |v|^2 / 2`` at the
    trajectory's start, and the Euclidean OU form of the partial refresh."""
    rng, jt, tt, jm, tm, jpt, tpt = _points(5, mu=1.0)
    v = th.sample_momentum(3, 0, 1, 2, (C, D), F64, "cpu", EXACT)
    eu = th.sample_momentum(3, 0, 1, 2, (C, D), F64, "cpu",
                            th.KineticKind.EUCLIDEAN)
    np.testing.assert_array_equal(v.numpy(), eu.numpy())
    want = jax.vmap(lambda p, t, vv: jh.initialize_trajectory(
        None, p._replace(v=vv), t, jh.KineticKind.EXACT_NORMAL,
        resample_velocity=False))(jpt, jt, jnp.asarray(v.numpy()))
    got = th.initialize_trajectory(tpt, tt, EXACT, v)
    for name in want._fields:
        _close(getattr(got, name), getattr(want, name))
    noise = rng.normal(size=(C, D))
    step = rng.uniform(0.1, 1.0, size=C)
    want = jax.vmap(lambda p, n, s: jh.partial_momentum_refresh(
        p, n, s, 0.5, 3.0, jh.KineticKind.EXACT_NORMAL))(
        jpt, jnp.asarray(noise), jnp.asarray(step))
    got = th.partial_momentum_refresh(tpt, _t(noise), _t(step), 0.5, 3.0,
                                      EXACT)
    for name in ("v", "ke"):
        _close(getattr(got, name), getattr(want, name))


@pytest.mark.parametrize("case", ["default", "divergence", "large_step",
                                  "deep"])
@pytest.mark.parametrize("dim", [3, 7])
def test_exact_normal_tree_matches_the_jax_tree_body(monkeypatch, case, dim):
    kw = dict(maxdepth=5)
    steps = [0.5, 0.25, 0.9]
    if case == "divergence":
        kw["max_energy_error"] = 0.3
        steps = [1.5, 0.75, 2.7]
    elif case == "large_step":
        steps = [2.0, 2.9, 3.3]  # past pi / 2 and pi
    elif case == "deep":
        kw["maxdepth"] = 7
        steps = [0.05, 0.1, 0.07]
    C3 = 3
    logp_grad, transform, pt = _torch_setup(dim, C3, seed=dim + len(case))
    opts = tnuts.NutsOptions(kind=EXACT, store_divergences=True, **kw)
    jopts = jnuts.NutsOptions(kind=jh.KineticKind.EXACT_NORMAL,
                              store_divergences=True, **kw)
    step = torch.tensor(steps, dtype=F64)
    seed = 91 + dim
    new_pt, info = tnuts.nuts_draw(seed, pt, transform, step, logp_grad,
                                   opts)
    v0 = th.sample_momentum(seed, 0, *tnuts.SALT_MOMENTUM, (C3, dim), F64,
                            "cpu", EXACT).numpy()
    dir0 = host_uniform(seed, 0, tnuts.SALT_FIRST_DIRECTION, (C3,), "cpu")
    for c in range(C3):
        one = type(pt)(*(x[c] for x in pt))
        draw, want = _jax_draw(
            monkeypatch, one, v0[c], float(dir0[c]), float(step[c]), jopts,
            lambda it: [float(u[c]) for u in tnuts.tree_uniforms(
                seed, it, C3, "cpu")])
        label = (case, dim, c)
        for name in ("depth", "n_steps", "idx_in_trajectory"):
            assert int(getattr(info, name)[c]) == int(getattr(want, name)), \
                (label, name)
        for name in ("reached_maxdepth", "diverging", "turning",
                     "is_good_for_adapt"):
            assert bool(getattr(info, name)[c]) == bool(
                getattr(want, name)), (label, name)
        assert int(info.divergence.reason[c]) == int(want.divergence.reason)
        for name in ("sum_accept", "sum_accept_sym", "energy",
                     "energy_error", "initial_energy", "max_energy_error"):
            np.testing.assert_allclose(
                float(getattr(info, name)[c]), float(getattr(want, name)),
                rtol=1e-9, atol=1e-10, err_msg=str((label, name)))
        for name in ("q", "g", "z", "zg", "v"):
            np.testing.assert_allclose(
                getattr(new_pt, name)[c].numpy(),
                np.asarray(getattr(draw, name)), rtol=1e-9, atol=1e-11,
                err_msg=str((label, name)))
        # the divergence record, momenta included (store_divergences)
        for name in ("start_location", "start_gradient", "start_momentum",
                     "end_location", "end_momentum"):
            np.testing.assert_allclose(
                getattr(info.divergence, name)[c].numpy(),
                np.asarray(getattr(want.divergence, name)), rtol=1e-9,
                atol=1e-11, equal_nan=True, err_msg=str((label, name)))
    if case == "divergence":
        assert info.diverging.any()
    if case == "deep":
        assert int(info.depth.max()) >= 3


def test_init_search_takes_exact_normal():
    """The step-size init search under the exact-normal dynamics: finite
    steps, larger than the Euclidean ones on a standard normal, where the
    exact integrator accepts every probe."""
    tm = tg.normal_logp(D, 0.0)
    tt = ta.identity_transform(C, D, F64, "cpu")
    q = _t(np.random.default_rng(2).normal(size=(C, D)))
    v = th.sample_momentum(4, 0, 1, 2, (C, D), F64, "cpu", EXACT)
    found = {kind: tss.init_search(q, tt, v, logp_grad_fn=tm.logp_and_grad,
                                   settings=tss.StepSizeSettings(),
                                   kind=kind)
             for kind in (EXACT, th.KineticKind.EUCLIDEAN)}
    assert torch.isfinite(found[EXACT]).all()
    assert (found[EXACT] > found[th.KineticKind.EUCLIDEAN]).all()


def test_exact_normal_run_matches_the_jax_sync_engine():
    """N(3, 1) at d = 6, the port's sync engine against the JAX one at the
    same settings: the analytic moments, no divergences, and the JAX
    engine's near-1 acceptance (the integrator is exact for the adapted
    standard normal, so dual averaging grows the step until the rotation
    wraps), with the adapted steps within 30%."""
    base = dict(num_chains=8, num_tune=100, num_draws=300,
                posterior_kernel="sync")
    trace = tnt.sample(tg.normal_logp(6, 3.0), tnt.DiagNutsSettings(
        seed=1, kinetic_energy=EXACT, **base), device="cpu")
    jtrace = jnt.sample(jg.normal_logp(6, 3.0), jnt.DiagNutsSettings(
        seed=2, kinetic_energy=jh.KineticKind.EXACT_NORMAL, **base),
        chunk_size=400)
    pos = trace.posterior["position"].astype(np.float64)
    assert abs(pos.mean() - 3.0) < 0.1 and abs(pos.std() - 1.0) < 0.1
    st, jst = trace.sample_stats, jtrace.sample_stats
    assert not st["diverging"].any()
    acc = st["mean_tree_accept"].mean()
    jacc = np.asarray(jst["mean_tree_accept"]).mean()
    assert abs(acc - jacc) < 0.02, (acc, jacc)
    step = np.median(st["step_size_bar"][:, -1])
    jstep = np.median(np.asarray(jst["step_size_bar"])[:, -1])
    assert abs(np.log(step / jstep)) < 0.3, (step, jstep)


def _kinds(phases):
    return [(lo, hi, "sync" if isinstance(r, functools.partial)
             or "sync" in r.__qualname__ else "fused")
            for lo, hi, r in phases]


@pytest.mark.parametrize("kernel", ["sync", "pallas"])
def test_exact_normal_plans_what_the_jax_package_plans(kernel):
    """Exact normal is a disqualifier of the fused NUTS engine in both
    packages: a ``"pallas"`` request runs on the sync engine with the JAX
    package's warning, a ``"sync"`` one takes it directly."""
    kw = dict(num_chains=4, num_tune=20, num_draws=10,
              posterior_kernel=kernel)
    ts = tnt.DiagNutsSettings(kinetic_energy=EXACT, **kw)
    js = jnt.DiagNutsSettings(kinetic_energy=jh.KineticKind.EXACT_NORMAL,
                              **kw)
    jcfg = js.chain_config()
    assert ts.unsupported(tg.normal_logp(3), "cuda") == []
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        got = _kinds(ts.build_phases(tg.normal_logp(3), ts.chain_config(),
                                     "cuda"))
        want = _kinds(js.build_phases(jg.normal_logp(3),
                                      _strategy_for(js, jcfg), jcfg))
    assert got == want == [(0, 30, "sync")]
    texts = [str(w.message) for w in seen]
    if kernel == "pallas":
        assert len(texts) == 2
        assert all("does not support: kinetic_energy=EXACT_NORMAL" in t
                   for t in texts)
    else:
        assert texts == []
