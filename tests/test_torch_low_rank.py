"""The port's low-rank estimator (``adapt/low_rank.py``) against the JAX
package's, on the CPU.

Twin of ``tests/test_low_rank.py``: nuts-rs's unit cases (the SPD mean's
diagonal case, whitened data giving the identity, masked slots ignored,
switch semantics), then ``compute_update`` and ``pooled_compute_update``
against the JAX functions from the same windows and transforms (built by
``convert.low_rank_window_from_numpy`` / ``low_rank_transform_from_numpy``
from the JAX package's arrays), comparing what the transform does, its
dense matrix dq/dz, sigma, mean, mu_lr, logdet and id, never ``vecs``,
whose signs and order among equal eigenvalues are the linear algebra
library's: rtol 1e-9 at float64, 2e-4 at float32 (absolute 1e-9 and 2e-4
of the largest entry).  Degenerate windows (fewer than 3 samples, a
non-finite sample) leave the transform as JAX leaves it.  Last, the
reference's strongest oracle at float64: on ``correlated_normal(10, 0.5)``
the adapted transform whitens the target exactly (``fisher_distance <
1e-10`` on every posterior draw; nuts-rs tests/sample_normal.rs:320-356,
the JAX twin ``tests/test_low_rank.py:122-140``), about 15 s on one
thread; and a low-rank state (factors and window) crossing between the
packages through ``convert.py``."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nuts_rs_tpu.adapt import low_rank as jlr
from nuts_rs_tpu.transform import affine as jaff
import nuts_rs_tpu_torch as tnt
from nuts_rs_tpu_torch.adapt import low_rank as tlr
from nuts_rs_tpu_torch.convert import (
    low_rank_transform_from_numpy,
    low_rank_window_from_numpy,
)
from nuts_rs_tpu_torch.models.gaussian import correlated_normal
from nuts_rs_tpu_torch.transform import affine as taff

TOL = {torch.float64: 1e-9, torch.float32: 2e-4}
GAMMA, CUTOFF = 1e-5, 2.0


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def test_spd_mean_diagonal():
    # nuts-rs low_rank.rs:354-381: spd_mean(diag(1, 4, 8), diag(1, 1, .5))
    # is the geometric mean's diagonal (1, 2, 4)
    x = torch.diag(torch.tensor([1.0, 4.0, 8.0], dtype=torch.float64))[None]
    y = torch.diag(torch.tensor([1.0, 1.0, 0.5], dtype=torch.float64))[None]
    torch.testing.assert_close(
        tlr._spd_mean(x, y)[0],
        torch.diag(torch.tensor([1.0, 2.0, 4.0], dtype=torch.float64)),
        rtol=0, atol=1e-10)


def _filled(draws, grads, cap=None):
    """A one-chain window holding ``draws`` / ``grads`` [n, d]."""
    n, d = draws.shape
    w = tlr.new_window(1, cap or n, d, torch.float64, "cpu")
    for i in range(n):
        w = tlr.push(w, torch.as_tensor(draws[i])[None],
                     torch.as_tensor(grads[i])[None], True)
    return w


def test_whitened_data_give_the_identity():
    # grads = -draws (a standard normal): every eigenvalue near 1 is cut
    # and padded to 1 (nuts-rs low_rank.rs:384-407)
    draws = np.random.default_rng(1).normal(size=(20, 3))
    t = taff.identity_transform(1, 3, torch.float64, "cpu", rank=3)
    t2 = tlr.compute_update(_filled(draws, -draws), t, gamma=1e-4,
                            eigval_cutoff=2.0)
    torch.testing.assert_close(t2.vals_sqrt, torch.ones_like(t2.vals_sqrt),
                               rtol=0, atol=1e-4)
    assert t2.id.tolist() == [t.id.item() + 1]


def test_masked_slots_are_ignored():
    rng = np.random.default_rng(3)
    xs = rng.normal(size=(15, 4))
    clean = _filled(xs, -xs)
    big = _filled(xs, -xs, cap=25)
    for _ in range(5):  # excluded pushes, garbage and NaN
        big = tlr.push(big, torch.full((1, 4), 1e6, dtype=torch.float64),
                       torch.full((1, 4), float("nan"), dtype=torch.float64),
                       False)
    assert big.write_pos.tolist() == [15]
    assert torch.isfinite(big.grads).all()  # a select, not sel * nan
    t0 = taff.identity_transform(1, 4, torch.float64, "cpu", rank=4)
    a = tlr.compute_update(clean, t0, gamma=1e-4, eigval_cutoff=2.0)
    b = tlr.compute_update(big, t0, gamma=1e-4, eigval_cutoff=2.0)
    torch.testing.assert_close(b.stds, a.stds, rtol=0, atol=1e-10)
    torch.testing.assert_close(b.logdet, a.logdet, rtol=0, atol=1e-10)


def test_push_equals_the_jax_push_on_finite_draws():
    rng = np.random.default_rng(4)
    C, cap, d = 3, 4, 2
    w = tlr.new_window(C, cap, d, torch.float64, "cpu")
    jw = jax.vmap(lambda _: jlr.new_window(cap, d, jnp.float64))(
        jnp.arange(C))
    for i in range(6):  # past capacity too
        x, g = rng.normal(size=(C, d)), rng.normal(size=(C, d))
        inc = rng.random(C) < 0.7
        w = tlr.push(w, torch.as_tensor(x), torch.as_tensor(g),
                     torch.as_tensor(inc))
        jw = jax.vmap(jlr.push)(jw, jnp.asarray(x), jnp.asarray(g),
                                jnp.asarray(inc))
    for name in tlr.LowRankWindow._fields:
        np.testing.assert_array_equal(getattr(w, name).numpy(),
                                      np.asarray(getattr(jw, name)), name)


def test_switch_semantics():
    w = tlr.new_window(1, 10, 2, torch.float64, "cpu")
    zero = torch.zeros(1, 2, dtype=torch.float64)
    for _ in range(4):
        w = tlr.push(w, zero, zero, True)
    assert w.write_pos.tolist() == [4]
    w = tlr.switch(w)
    assert w.start.tolist() == [0] and w.bg_start.tolist() == [4]
    for _ in range(3):
        w = tlr.push(w, zero, zero, True)
    w2 = tlr.switch(w)
    # the foreground is what came since the last switch
    assert w2.start.tolist() == [4] and w2.bg_start.tolist() == [7]
    assert tlr.foreground_count(w2).tolist() == [3]
    assert tlr.background_count(w2).tolist() == [0]


def _jax_windows(seed, C=3, cap=40, d=5, n=(30, 25, 35), start=(0, 4, 2)):
    """Per-chain windows of a correlated normal (one inflated direction and
    distinct scales), with unused slots at the end and foreground starts
    above 0, as JAX arrays; and transforms after the diagonal init."""
    rng = np.random.default_rng(seed)
    u = rng.normal(size=d)
    u /= np.linalg.norm(u)
    scale = np.exp(rng.normal(size=d) * 0.5)
    cov = np.diag(scale) @ (np.eye(d) + 8.0 * np.outer(u, u)) @ np.diag(scale)
    prec = np.linalg.inv(cov)
    draws = np.zeros((C, cap, d))
    grads = np.zeros((C, cap, d))
    for c in range(C):
        x = rng.multivariate_normal(np.full(d, 0.5), cov, size=n[c])
        draws[c, :n[c]] = x
        grads[c, :n[c]] = -(x - 0.5) @ prec
    w = jlr.LowRankWindow(draws=jnp.asarray(draws), grads=jnp.asarray(grads),
                          write_pos=jnp.asarray(n, jnp.int32),
                          start=jnp.asarray(start, jnp.int32),
                          bg_start=jnp.asarray(n, jnp.int32))

    def init(q, g):
        t = jaff.identity_transform(d, jnp.float64, rank=d)
        return jaff.init_diag_from_grad(t, q, g)

    t = jax.vmap(init)(w.draws[:, 0], w.grads[:, 0])
    return w, t


def _cast(tree, jdt):
    return jax.tree.map(lambda v: v.astype(jdt)
                        if jnp.issubdtype(v.dtype, jnp.floating) else v, tree)


def _dense(t):
    """dq/dz [C, d, d] and the offset q(0) of each chain's transform."""
    C, d = t.stds.shape
    z0 = torch.zeros(C, d, dtype=t.stds.dtype)
    q0 = taff.to_untransformed(t, z0)
    eye = torch.eye(d, dtype=t.stds.dtype)
    cols = [taff.to_untransformed(t, z0 + eye[j]) - q0 for j in range(d)]
    return torch.stack(cols, -1), q0


def _same_transform(got, want_jax, dtype):
    want = low_rank_transform_from_numpy(want_jax, dtype=torch.float64)
    got64 = taff.AffineTransform(*(None if v is None else (
        v.to(torch.float64) if v.is_floating_point() else v) for v in got))
    tol = TOL[dtype]
    for name, a, b in (("dense", *(_dense(x)[0] for x in (got64, want))),
                       ("offset", *(_dense(x)[1] for x in (got64, want))),
                       ("stds", got64.stds, want.stds),
                       ("mean", got64.mean, want.mean),
                       ("mu_lr", got64.mu_lr, want.mu_lr),
                       ("logdet", got64.logdet, want.logdet)):
        scale = float(b.abs().max())
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=tol,
                                   atol=tol * max(scale, 1.0),
                                   err_msg=name)
    np.testing.assert_array_equal(got.id.numpy(), want.id.numpy())


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("pooled", [False, True])
def test_refit_equals_the_jax_refit(dtype, pooled):
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    jw, jt = _jax_windows(11)
    jw, jt = _cast(jw, jdt), _cast(jt, jdt)
    w = low_rank_window_from_numpy(jw, dtype=dtype)
    t = low_rank_transform_from_numpy(jt, dtype=dtype)
    if pooled:
        got = tlr.pooled_compute_update(w, t, GAMMA, CUTOFF)
        want = jlr.pooled_compute_update(jw, jt, GAMMA, CUTOFF)
        # one transform for every chain
        assert (got.id == got.id[0]).all()
        torch.testing.assert_close(got.stds, got.stds[:1].expand_as(
            got.stds), rtol=0, atol=0)
    else:
        got = tlr.compute_update(w, t, GAMMA, CUTOFF)
        want = jax.vmap(functools.partial(
            jlr.compute_update, gamma=GAMMA, eigval_cutoff=CUTOFF))(jw, jt)
    assert got.stds.dtype == dtype
    assert (got.id == t.id + 1).all()  # every refit took
    # the inflated direction was found (an eigenvalue above the cutoff)
    assert (torch.square(got.vals_sqrt) > CUTOFF).any(-1).all()
    _same_transform(got, want, dtype)


@pytest.mark.parametrize("case", ["two_samples", "non_finite"])
def test_degenerate_windows_leave_the_transform(case):
    jw, jt = _jax_windows(12)
    if case == "two_samples":
        jw = jw._replace(write_pos=jnp.asarray([2, 30, 25], jnp.int32),
                         start=jnp.zeros(3, jnp.int32))
    else:
        jw = jw._replace(draws=jw.draws.at[0, 3, 1].set(jnp.nan),
                         grads=jw.grads.at[2, 5, 0].set(jnp.inf))
    w = low_rank_window_from_numpy(jw, dtype=torch.float64)
    t = low_rank_transform_from_numpy(jt, dtype=torch.float64)
    got = tlr.compute_update(w, t, GAMMA, CUTOFF)
    want = jax.vmap(functools.partial(
        jlr.compute_update, gamma=GAMMA, eigval_cutoff=CUTOFF))(jw, jt)
    np.testing.assert_array_equal(got.id.numpy(), np.asarray(want.id))
    bad = [0] if case == "two_samples" else [0, 2]
    assert got.id.tolist() == [int(t.id[c]) + (c not in bad)
                               for c in range(3)]
    for c in bad:  # unchanged, as in JAX
        for name in ("stds", "mean", "vecs", "vals_sqrt", "mu_lr", "logdet"):
            torch.testing.assert_close(getattr(got, name)[c],
                                       getattr(t, name)[c], rtol=0, atol=0)
    _same_transform(got, want, torch.float64)
    # pooled: a non-finite sample poisons the one refit, so no chain moves
    if case == "non_finite":
        pooled = tlr.pooled_compute_update(w, t, GAMMA, CUTOFF)
        jpooled = jlr.pooled_compute_update(jw, jt, GAMMA, CUTOFF)
        np.testing.assert_array_equal(pooled.id.numpy(),
                                      np.asarray(jpooled.id))
        _same_transform(pooled, jpooled, torch.float64)


def test_low_rank_exact_gaussian_whitening():
    """The oracle: Sigma = I + 0.5 1 1^T at d = 10, 500 tuning draws and
    ``eigval_cutoff=1.00001``, so that the whole estimated spectrum stays;
    with exactly linear gradients the SPD mean recovers the precision, so
    fisher_distance = |z + zg|^2 < 1e-10 on every posterior draw."""
    settings = tnt.LowRankNutsSettings(
        num_tune=500, num_draws=100, num_chains=1, seed=42,
        low_rank=tnt.LowRankSettings(eigval_cutoff=1.00001))
    trace = tnt.sample(correlated_normal(10, 0.5), settings, device="cpu",
                       dtype=torch.float64, chunk_size=300)
    fisher = trace.sample_stats["fisher_distance"]
    assert fisher.shape == (1, 100) and fisher.dtype == np.float64
    assert (fisher < 1e-10).all(), fisher.max()
    assert not trace.sample_stats["diverging"].any()


def test_a_low_rank_state_crosses_between_the_packages():
    """``convert.state_to_numpy`` reads a low-rank transform's factors and
    its window from either package's state; ``state_from_numpy`` builds
    this package's, equal field for field."""
    import nuts_rs_tpu as jnt
    from nuts_rs_tpu.models import gaussian as jg
    from nuts_rs_tpu_torch.checkpoint import state_leaves
    from nuts_rs_tpu_torch.convert import state_from_numpy, state_to_numpy
    from nuts_rs_tpu_torch.models.gaussian import correlated_normal_rank1

    kw = dict(num_chains=2, num_tune=30, num_draws=5, seed=1)
    js = jnt.Sampler(jg.correlated_normal_rank1(5),
                     jnt.LowRankNutsSettings(**kw), chunk_size=12)
    js.run_next_chunk()
    arrays = state_to_numpy(js.state)
    for name in ("vecs", "vals_sqrt", "mu_lr", "window_draws",
                 "window_write_pos"):
        assert name in arrays
    state = state_from_numpy(arrays, dtype=torch.float64)
    np.testing.assert_array_equal(state.transform.vecs.numpy(),
                                  np.asarray(js.state.transform.vecs))
    np.testing.assert_array_equal(state.extra.draws.numpy(),
                                  np.asarray(js.state.extra.draws))
    assert state.extra.write_pos.tolist() == np.asarray(
        js.state.extra.write_pos).tolist()
    # and back: this package's state through numpy is itself
    s = tnt.Sampler(correlated_normal_rank1(5), tnt.LowRankNutsSettings(**kw),
                    chunk_size=12, device="cpu", dtype=torch.float64)
    s.run_next_chunk()
    again = state_from_numpy(state_to_numpy(s.state), dtype=torch.float64)
    for name in ("vecs", "vals_sqrt", "vals_sqrt_inv", "mu_lr", "stds"):
        assert torch.equal(getattr(again.transform, name),
                           getattr(s.state.transform, name)), name
    for a, b in zip(state_leaves(again.extra), state_leaves(s.state.extra)):
        assert torch.equal(a, b)
