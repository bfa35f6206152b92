"""The port's model, diagonal transform and dynamics (Euclidean,
exact-normal and microcanonical) against the JAX package, at float64 on random points
(tolerance 1e-12: the same formulas, sums over d of a few terms in possibly
another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nuts_rs_tpu.dynamics import hamiltonian as jh
from nuts_rs_tpu.models import gaussian as jg
from nuts_rs_tpu.transform import affine as ja
from nuts_rs_tpu_torch.dynamics import hamiltonian as th
from nuts_rs_tpu_torch.models import gaussian as tg
from nuts_rs_tpu_torch.models.model import Model
from nuts_rs_tpu_torch.transform import affine as ta

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


@pytest.mark.parametrize("mu", [0.0, 3.0])
def test_normal_logp_value_and_grad(mu):
    rng = np.random.default_rng(0)
    q = rng.normal(size=(C, D)) * 2.0
    jm, tm = jg.normal_logp(D, mu), tg.normal_logp(D, mu)
    want_lp, want_g = jax.vmap(jm.logp_and_grad)(jnp.asarray(q))
    got_lp, got_g = tm.logp_and_grad(_t(q))
    _close(got_lp, want_lp)
    _close(got_g, want_g)
    # the torch.func path of a model without a closed form
    plain = Model(logp_fn=tm.logp_fn, dim=D)
    lp2, g2 = plain.logp_and_grad(_t(q))
    _close(lp2, want_lp)
    _close(g2, want_g)
    assert tm.kernel_hook == ("iid_normal", (mu,))


def test_diagonal_transform_functions():
    rng = np.random.default_rng(1)
    jt, tt = _transforms(rng)
    q = rng.normal(size=(C, D))
    g = rng.normal(size=(C, D))
    _close(ta.to_transformed(tt, _t(q)),
           jax.vmap(ja.to_transformed)(jt, jnp.asarray(q)))
    _close(ta.to_untransformed(tt, _t(q)),
           jax.vmap(ja.to_untransformed)(jt, jnp.asarray(q)))
    _close(ta.grad_to_transformed(tt, _t(g)),
           jax.vmap(ja.grad_to_transformed)(jt, jnp.asarray(g)))
    _close(ta.diag_logdet(tt.inv_stds),
           jax.vmap(ja.diag_logdet)(jt.inv_stds))

    new_stds = rng.uniform(0.5, 2.0, size=(C, D))
    new_mean = rng.normal(size=(C, D))
    changed = np.array([True, False, True, True, False])
    want = jax.vmap(ja.set_diag)(jt, jnp.asarray(new_stds),
                                 jnp.asarray(new_mean), jnp.asarray(changed))
    got = ta.set_diag(tt, _t(new_stds), _t(new_mean), _t(changed))
    for name in ("mean", "stds", "inv_stds", "logdet", "id"):
        _close(getattr(got, name), getattr(want, name))

    g[0, 1] = 0.0  # 1/|g| clamps at 1e20
    want = jax.vmap(ja.init_diag_from_grad)(jt, jnp.asarray(q),
                                            jnp.asarray(g))
    got = ta.init_diag_from_grad(tt, _t(q), _t(g))
    for name in ("mean", "stds", "inv_stds", "logdet", "id"):
        _close(getattr(got, name), getattr(want, name))


def _jax_point(jm, jt, q, v):
    pt = jax.vmap(lambda qq, t: jh.init_point_from_q(qq, t, jm.logp_and_grad)
                  )(jnp.asarray(q), jt)
    return pt._replace(v=jnp.asarray(v),
                       ke=0.5 * jnp.sum(jnp.asarray(v) ** 2, axis=1))


def test_init_point_and_trajectory():
    rng = np.random.default_rng(2)
    jt, tt = _transforms(rng)
    q = rng.normal(size=(C, D))
    v = rng.normal(size=(C, D))
    jm, tm = jg.normal_logp(D, 1.5), tg.normal_logp(D, 1.5)
    want = jax.vmap(lambda qq, t: jh.init_point_from_q(
        qq, t, jm.logp_and_grad))(jnp.asarray(q), jt)
    got = th.init_point_from_q(_t(q), tt, tm.logp_and_grad)
    for name in want._fields:
        _close(getattr(got, name), getattr(want, name))

    want = jax.vmap(lambda p, t: jh.initialize_trajectory(
        None, p, t, jh.KineticKind.EUCLIDEAN, resample_velocity=False))(
        _jax_point(jm, jt, q, v), jt)
    got = th.initialize_trajectory(got, tt, th.KineticKind.EUCLIDEAN, _t(v))
    for name in want._fields:
        _close(getattr(got, name), getattr(want, name))


@pytest.mark.parametrize("direction", [1, -1])
def test_leapfrog(direction):
    rng = np.random.default_rng(3)
    jt, tt = _transforms(rng)
    q = rng.normal(size=(C, D))
    v = rng.normal(size=(C, D))
    step = rng.uniform(0.1, 1.5, size=C)
    jm, tm = jg.normal_logp(D, -0.5), tg.normal_logp(D, -0.5)
    jpt = _jax_point(jm, jt, q, v)
    tpt = th.init_point_from_q(_t(q), tt, tm.logp_and_grad)._replace(
        v=_t(v), ke=_t(0.5 * np.sum(v * v, axis=1)))
    base = np.asarray(jpt.energy) - 0.3
    want = jax.vmap(lambda p, s, t, e: jh.leapfrog(
        p, jnp.int32(direction), s, t, jm.logp_and_grad,
        jh.KineticKind.EUCLIDEAN, e, 1.0))(jpt, jnp.asarray(step), jt,
                                           jnp.asarray(base))
    got = th.leapfrog(tpt, direction, _t(step), tt, tm.logp_and_grad,
                      th.KineticKind.EUCLIDEAN, _t(base), 1.0)
    for name in want.point._fields:
        _close(getattr(got.point, name), getattr(want.point, name))
    _close(got.energy_error, want.energy_error)
    np.testing.assert_array_equal(got.diverging.numpy(),
                                  np.asarray(want.diverging))


@pytest.mark.parametrize("direction", [1, -1])
def test_microcanonical_leapfrog(direction):
    kind = "MICROCANONICAL"
    rng = np.random.default_rng(3)
    jt, tt = _transforms(rng)
    q = rng.normal(size=(C, D))
    v = rng.normal(size=(C, D))
    v = v / np.linalg.norm(v, axis=1, keepdims=True)
    ke = rng.normal(size=C)  # the running ESH energy, any value
    step = rng.uniform(0.1, 1.5, size=C)
    factor = 0.5
    jm, tm = jg.normal_logp(D, -0.5), tg.normal_logp(D, -0.5)
    jpt = _jax_point(jm, jt, q, v)._replace(ke=jnp.asarray(ke))
    tpt = th.init_point_from_q(_t(q), tt, tm.logp_and_grad)._replace(
        v=_t(v), ke=_t(ke))
    base = np.asarray(jpt.energy) - 0.3
    want = jax.vmap(lambda p, s, t, e: jh.leapfrog(
        p, jnp.int32(direction), s, t, jm.logp_and_grad,
        jh.KineticKind[kind], e, 0.25, step_size_factor=factor))(
        jpt, jnp.asarray(step), jt, jnp.asarray(base))
    got = th.leapfrog(tpt, direction, _t(step), tt, tm.logp_and_grad,
                      th.KineticKind[kind], _t(base), 0.25,
                      step_size_factor=factor)
    for name in want.point._fields:
        _close(getattr(got.point, name), getattr(want.point, name))
    _close(got.energy_error, want.energy_error)
    np.testing.assert_array_equal(got.diverging.numpy(),
                                  np.asarray(want.diverging))
    assert bool(got.diverging.any()) and not bool(got.diverging.all())


def test_every_kinetic_energy_is_ported():
    """The exact-normal kinetic energy used to raise naming item 8; every
    kind of the JAX package now has its leapfrog here, and the exact-normal
    one matches the JAX one (tests/test_torch_exact_normal.py holds it in
    full)."""
    assert {k.name for k in th.KineticKind} == {
        k.name for k in jh.KineticKind}
    assert not hasattr(th, "require_euclidean")
    rng = np.random.default_rng(9)
    jt, tt = _transforms(rng)
    q, v = rng.normal(size=(C, D)), rng.normal(size=(C, D))
    step = rng.uniform(0.1, 1.5, size=C)
    jm, tm = jg.normal_logp(D, 0.5), tg.normal_logp(D, 0.5)
    jpt = _jax_point(jm, jt, q, v)
    tpt = th.init_point_from_q(_t(q), tt, tm.logp_and_grad)._replace(
        v=_t(v), ke=_t(0.5 * np.sum(v * v, axis=1)))
    base = np.asarray(jpt.energy)
    want = jax.vmap(lambda p, s, t, e: jh.leapfrog(
        p, jnp.int32(1), s, t, jm.logp_and_grad,
        jh.KineticKind.EXACT_NORMAL, e, 1000.0))(
        jpt, jnp.asarray(step), jt, jnp.asarray(base))
    got = th.leapfrog(tpt, 1, _t(step), tt, tm.logp_and_grad,
                      th.KineticKind.EXACT_NORMAL, _t(base), 1000.0)
    for name in want.point._fields:
        _close(getattr(got.point, name), getattr(want.point, name))


def test_esh_momentum_update():
    rng = np.random.default_rng(4)
    zg = rng.normal(size=(C, D)) * 2.0
    v = rng.normal(size=(C, D))
    v = v / np.linalg.norm(v, axis=1, keepdims=True)
    step = rng.uniform(0.05, 2.0, size=C)
    want = jax.vmap(jh._esh_momentum_update)(
        jnp.asarray(zg), jnp.asarray(v), jnp.asarray(step))
    got = th.esh_momentum_update(_t(zg), _t(v), _t(step))
    _close(got[0], want[0])
    _close(got[1], want[1])
    np.testing.assert_allclose(np.linalg.norm(got[0].numpy(), axis=1), 1.0,
                               rtol=1e-14)


@pytest.mark.parametrize("kind", ["EUCLIDEAN", "MICROCANONICAL",
                                  "EXACT_NORMAL"])
def test_partial_momentum_refresh(kind):
    rng = np.random.default_rng(5)
    jt, tt = _transforms(rng)
    q = rng.normal(size=(C, D))
    v = rng.normal(size=(C, D))
    if kind == "MICROCANONICAL":
        v = v / np.linalg.norm(v, axis=1, keepdims=True)
    noise = rng.normal(size=(C, D))
    step = rng.uniform(0.1, 1.0, size=C)
    jm, tm = jg.normal_logp(D, 1.0), tg.normal_logp(D, 1.0)
    jpt = _jax_point(jm, jt, q, v)
    tpt = th.init_point_from_q(_t(q), tt, tm.logp_and_grad)._replace(
        v=_t(v), ke=_t(np.asarray(jpt.ke)))
    want = jax.vmap(lambda p, n, s: jh.partial_momentum_refresh(
        p, n, s, 0.5, 3.0, jh.KineticKind[kind]))(
        jpt, jnp.asarray(noise), jnp.asarray(step))
    got = th.partial_momentum_refresh(tpt, _t(noise), _t(step), 0.5, 3.0,
                                      th.KineticKind[kind])
    for name in ("v", "ke"):
        _close(getattr(got, name), getattr(want, name))


def test_microcanonical_momentum_and_trajectory_init():
    rng = np.random.default_rng(6)
    jt, tt = _transforms(rng)
    q = rng.normal(size=(C, D))
    v = rng.normal(size=(C, D))
    v = v / np.linalg.norm(v, axis=1, keepdims=True)
    jm, tm = jg.normal_logp(D, 0.0), tg.normal_logp(D, 0.0)
    micro = th.KineticKind.MICROCANONICAL
    # fresh momentum lies on the unit sphere, as the JAX package's
    vs = th.sample_momentum(3, 0, 1, 2, (C, D), torch.float64, "cpu", micro)
    np.testing.assert_allclose(np.linalg.norm(vs.numpy(), axis=1), 1.0,
                               rtol=1e-14)
    jv = jh.sample_momentum(jax.random.key(0), D, jnp.float64,
                            jh.KineticKind.MICROCANONICAL)
    np.testing.assert_allclose(float(jnp.linalg.norm(jv)), 1.0, rtol=1e-14)
    # without a resample the velocity is carried verbatim and ke is 0
    want = jax.vmap(lambda p, t: jh.initialize_trajectory(
        None, p, t, jh.KineticKind.MICROCANONICAL,
        resample_velocity=False))(_jax_point(jm, jt, q, v), jt)
    pt = th.init_point_from_q(_t(q), tt, tm.logp_and_grad)._replace(v=_t(v))
    got = th.initialize_trajectory(pt, tt, micro)
    for name in want._fields:
        _close(getattr(got, name), getattr(want, name))
