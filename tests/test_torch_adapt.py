"""The port's step-size and mass-matrix adaptation and window schedule
against the JAX package, at float64 on the same inputs."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nuts_rs_tpu.adapt import mass_matrix as jmm
from nuts_rs_tpu.adapt import schedule as jsched
from nuts_rs_tpu.adapt import step_size as jss
from nuts_rs_tpu.dynamics.hamiltonian import KineticKind as JKind
from nuts_rs_tpu.models import gaussian as jg
from nuts_rs_tpu.transform import affine as ja
from nuts_rs_tpu_torch.adapt import mass_matrix as tmm
from nuts_rs_tpu_torch.adapt import schedule as tsched
from nuts_rs_tpu_torch.adapt import step_size as tss
from nuts_rs_tpu_torch.dynamics.hamiltonian import KineticKind
from nuts_rs_tpu_torch.models import gaussian as tg
from nuts_rs_tpu_torch.transform import affine as ta

TOL = dict(rtol=1e-12, atol=1e-13)
C, D = 6, 3


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **TOL)


def _step_states(rng):
    vals = dict(
        log_step=rng.normal(size=C), log_step_adapted=rng.normal(size=C),
        hbar=rng.normal(size=C) * 0.1, mu=rng.normal(size=C),
        count=rng.integers(1, 50, size=C).astype(np.float64),
        adam_m=rng.normal(size=C) * 0.1, adam_v=rng.uniform(0, 0.1, size=C),
        adam_t=rng.integers(0, 20, size=C).astype(np.int32),
        step_size=rng.uniform(0.1, 1.0, size=C))
    return (jss.StepSizeState(**{k: jnp.asarray(v) for k, v in vals.items()}),
            tss.StepSizeState(**{k: _t(v) for k, v in vals.items()}))


@pytest.mark.parametrize("method", ["DUAL_AVERAGE", "ADAM", "FIXED"])
def test_step_size_updates(method):
    rng = np.random.default_rng(0)
    js, ts = _step_states(rng)
    jset = jss.StepSizeSettings(method=jss.StepSizeMethod[method])
    tset = tss.StepSizeSettings(method=tss.StepSizeMethod[method])
    acc = rng.uniform(0, 1, size=C)
    want = jax.vmap(lambda s, a: jss.advance(s, a, jset))(js, jnp.asarray(acc))
    got = tss.advance(ts, _t(acc), tset)
    for name in want._fields:
        _close(getattr(got, name), getattr(want, name))
    for best in (False, True):
        _close(tss.current_step(got, tset, best),
               jax.vmap(lambda s: jss.current_step(s, jset, best))(want))
    _close(tss.step_size_bar(got, tset),
           jax.vmap(lambda s: jss.step_size_bar(s, jset))(want))
    found = rng.uniform(0.1, 1.0, size=C)
    want = jax.vmap(jss.reset_from_found_step)(want, jnp.asarray(found))
    got = tss.reset_from_found_step(got, _t(found))
    for name in want._fields:
        _close(getattr(got, name), getattr(want, name))
    # jitter: the same uniform gives the same factor in [1 - j, 1 + j]
    u = rng.uniform(size=C)
    got = tss.apply_jitter(_t(u), got, tset, True)
    base = np.asarray(jax.vmap(lambda s: jss.current_step(s, jset, True))(
        want))
    if method != "FIXED":
        _close(got.step_size, base * (0.9 + 0.2 * u))


def test_fixed_step_with_jitter():
    """MCLMC's step law: FIXED with uniform jitter (step_size.py:123,155,
    163,207), as the JAX functions give it and as the fused MCLMC warmup
    forms it in f32 (fixed * ((1 - j) + 2 j u))."""
    rng = np.random.default_rng(3)
    js, ts = _step_states(rng)
    fixed, j = 0.37, 0.1
    jset = jss.StepSizeSettings(method=jss.StepSizeMethod.FIXED,
                                fixed_value=fixed, jitter=j)
    tset = tss.StepSizeSettings(method=tss.StepSizeMethod.FIXED,
                                fixed_value=fixed, jitter=j)
    acc = _t(rng.uniform(size=C))
    for name, value in tss.advance(ts, acc, tset)._asdict().items():
        _close(value, getattr(ts, name))
    for best in (False, True):
        _close(tss.current_step(ts, tset, best), np.full(C, fixed))
    _close(tss.step_size_bar(ts, tset),
           jax.vmap(lambda s: jss.step_size_bar(s, jset))(js))
    q = rng.normal(size=(C, D))
    found = tss.init_search(_t(q), None, None, logp_grad_fn=None,
                            settings=tset, kind=KineticKind.EUCLIDEAN)
    _close(found, np.full(C, float(jss.init_search(
        None, jnp.asarray(q[0]), None, logp_grad_fn=None, settings=jset,
        kind=JKind.EUCLIDEAN))))
    # the JAX jitter draws its factor in [1 - j, 1 + j]; the port maps the
    # uniform u to the same factor
    keys = jax.random.split(jax.random.key(0), C)
    want = jax.vmap(lambda k, s: jss.apply_jitter(k, s, jset, True))(keys, js)
    factor = np.asarray(want.step_size) / fixed
    assert ((factor >= 1 - j) & (factor <= 1 + j)).all()
    got = tss.apply_jitter(_t((factor - (1 - j)) / (2 * j)), ts, tset, True)
    np.testing.assert_allclose(got.step_size.numpy(),
                               np.asarray(want.step_size), rtol=1e-12)
    # the f32 form of the fused warmup kernel
    u32 = torch.tensor([0.0, 0.25, 0.5, 0.999], dtype=torch.float32)
    s32 = tss.apply_jitter(u32, tss.new_step_size_state(
        fixed, 4, torch.float32, "cpu"), tset, True).step_size
    k32 = torch.full((4,), fixed) * ((1.0 - j) + (2.0 * j) * u32)
    np.testing.assert_array_equal(s32.numpy(), k32.numpy())


def _estimators(rng):
    def rv():
        m, v = rng.normal(size=(C, D)), rng.uniform(0, 5, size=(C, D))
        c = rng.integers(0, 6, size=C).astype(np.float64)
        return (jmm.RunningVariance(jnp.asarray(m), jnp.asarray(v),
                                    jnp.asarray(c)),
                tmm.RunningVariance(_t(m), _t(v), _t(c)))
    pairs = [rv() for _ in range(4)]
    return (jmm.DiagAdaptState(*(p[0] for p in pairs)),
            tmm.DiagAdaptState(*(p[1] for p in pairs)))


def _close_state(got, want):
    for g_rv, w_rv in zip(got, want):
        for name in ("mean", "var_sum", "count"):
            _close(getattr(g_rv, name), getattr(w_rv, name))


@pytest.mark.parametrize("use_grad_based", [True, False])
def test_mass_matrix_estimators(use_grad_based):
    rng = np.random.default_rng(1)
    js, ts = _estimators(rng)
    x, g = rng.normal(size=(C, D)), rng.normal(size=(C, D))
    good = np.array([True, False, True, True, False, True])
    want = jax.vmap(jmm.update_estimators)(js, jnp.asarray(x), jnp.asarray(g),
                                           jnp.asarray(good))
    got = tmm.update_estimators(ts, _t(x), _t(g), _t(good))
    _close_state(got, want)
    _close(tmm.add_sample(ts.draw, _t(x), True).mean,
           jax.vmap(jmm.add_sample)(js.draw, jnp.asarray(x)).mean)
    want = jax.vmap(jmm.switch)(want)
    got = tmm.switch(got)
    _close_state(got, want)
    # feed a few samples so the fg estimators have >= 3 (and some < 3)
    for k in range(3):
        x, g = rng.normal(size=(C, D)), rng.normal(size=(C, D))
        good = rng.uniform(size=C) < 0.8
        want = jax.vmap(jmm.update_estimators)(
            want, jnp.asarray(x), jnp.asarray(g), jnp.asarray(good))
        got = tmm.update_estimators(got, _t(x), _t(g), _t(good))
    want = jax.vmap(jmm.switch)(want)
    got = tmm.switch(got)
    stds = rng.uniform(0.5, 2.0, size=(C, D))
    jt = ja.AffineTransform(mean=jnp.zeros((C, D)), stds=jnp.asarray(stds),
                            inv_stds=jnp.asarray(1 / stds),
                            logdet=jnp.zeros(C), id=jnp.zeros(C, jnp.int32))
    tt = ta.AffineTransform(mean=torch.zeros(C, D, dtype=torch.float64),
                            stds=_t(stds), inv_stds=_t(1 / stds),
                            logdet=torch.zeros(C, dtype=torch.float64),
                            id=torch.zeros(C, dtype=torch.int32))
    want_t = jax.vmap(lambda s, t: jmm.adapt_diag(
        s, t, use_grad_based_estimate=use_grad_based))(want, jt)
    got_t = tmm.adapt_diag(got, tt, use_grad_based_estimate=use_grad_based)
    for name in ("mean", "stds", "inv_stds", "logdet", "id"):
        _close(getattr(got_t, name), getattr(want_t, name))


@pytest.mark.parametrize("num_tune,num_draws", [(300, 700), (150, 250),
                                                (1000, 10), (25, 5)])
def test_schedule(num_tune, num_draws):
    for opts in (jsched.AdaptScheduleOptions(),
                 jsched.AdaptScheduleOptions(mass_matrix_switch_freq=31,
                                             mass_matrix_update_freq=5)):
        topts = tsched.AdaptScheduleOptions(**dataclasses.asdict(opts))
        want = jsched.build_schedule(num_tune, num_draws, opts)
        got = tsched.build_schedule(num_tune, num_draws, topts)
        for name in want._fields:
            np.testing.assert_array_equal(getattr(got, name),
                                          getattr(want, name), err_msg=name)
        assert (dataclasses.asdict(tsched.build_window_params(num_tune, topts))
                == dataclasses.asdict(jsched.build_window_params(num_tune,
                                                                 opts)))


@pytest.mark.parametrize("initial_step", [0.1, 2.5])
def test_init_search_with_the_same_momentum(initial_step):
    rng = np.random.default_rng(2)
    q = rng.normal(size=(C, D)) * 2.0
    stds = rng.uniform(0.5, 2.0, size=(C, D))
    jm, tm = jg.normal_logp(D, 1.0), tg.normal_logp(D, 1.0)
    jt = ja.AffineTransform(
        mean=jnp.zeros((C, D)), stds=jnp.asarray(stds),
        inv_stds=jnp.asarray(1 / stds),
        logdet=jnp.asarray(np.sum(np.log(1 / stds), 1)),
        id=jnp.zeros(C, jnp.int32))
    tt = ta.AffineTransform(
        mean=torch.zeros(C, D, dtype=torch.float64), stds=_t(stds),
        inv_stds=_t(1 / stds), logdet=_t(np.sum(np.log(1 / stds), 1)),
        id=torch.zeros(C, dtype=torch.int32))
    keys = jax.random.split(jax.random.key(3), C)
    # JAX draws the momentum inside as jax.random.normal(key, (d,))
    # (dynamics/hamiltonian.py:171); the port takes it as an argument.
    v = jax.vmap(lambda k: jax.random.normal(k, (D,), jnp.float64))(keys)
    jset = jss.StepSizeSettings(initial_step=initial_step)
    want = jax.vmap(lambda k, qq, t: jss.init_search(
        k, qq, t, logp_grad_fn=jm.logp_and_grad, settings=jset,
        kind=JKind.EUCLIDEAN))(keys, jnp.asarray(q), jt)
    got = tss.init_search(_t(q), tt, _t(v), logp_grad_fn=tm.logp_and_grad,
                          settings=tss.StepSizeSettings(
                              initial_step=initial_step),
                          kind=KineticKind.EUCLIDEAN)
    _close(got, want)
    assert len(set(np.asarray(want).tolist())) > 1
