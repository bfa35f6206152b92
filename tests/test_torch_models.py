"""The model zoo of the port against the JAX package's, on the CPU.

Every model of ``nuts_rs_tpu/models`` has a twin under the same name in
``nuts_rs_tpu_torch/models``: its data come from the same numpy generator
calls, its ``logp_fn`` and the ``torch.func`` gradient of it match the JAX
model's ``logp_fn`` and ``jax.grad`` in float64.  The models whose JAX form
reaches the fused Pallas kernels carry a device functor; its plain
counterpart (``gaussian.PLAIN_FUNCTORS``) has a closed-form gradient, held
against ``torch.func`` of the port's ``logp_fn`` in float64 at rtol 1e-10
and against the JAX model in float32 (rtol 2e-5 with an atol of 2e-5 times
the largest magnitude: the functors sum in ``ops.tsum``'s order and spell
lgamma, digamma and log1p out of basic operations, XLA does neither), SV's
also at the sampler's own starts far out in log sigma (T = 1000).  The
special functions and the SV scan order are held on their own.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad, vmap

from nuts_rs_tpu.models import gaussian as jg
from nuts_rs_tpu.models import hierarchical as jh
from nuts_rs_tpu.models import stochastic_volatility as jsv
from nuts_rs_tpu_torch.models import gaussian as tg
from nuts_rs_tpu_torch.models import hierarchical as th
from nuts_rs_tpu_torch.models import stochastic_volatility as tsv
from nuts_rs_tpu_torch.ops import tsum


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


_COV = np.array([[2.0, 0.3, 0.1], [0.3, 1.0, -0.2], [0.1, -0.2, 0.5]])

# name: (JAX model, port model, centre of the test points, their spread)
CASES = {
    "mv_normal": (lambda: jg.mv_normal(_COV), lambda: tg.mv_normal(_COV),
                  0.0, 1.0),
    "rank1": (lambda: jg.correlated_normal_rank1(6),
              lambda: tg.correlated_normal_rank1(6), 0.0, 1.0),
    "correlated_normal": (lambda: jg.correlated_normal(5),
                          lambda: tg.correlated_normal(5), 0.0, 1.0),
    "funnel": (lambda: jg.funnel(7), lambda: tg.funnel(7), 0.0, 0.8),
    "eight_schools": (jg.eight_schools, tg.eight_schools, 0.0, 1.0),
    "radon": (lambda: jh.radon(J=4, n_per=3, seed=1),
              lambda: th.radon(J=4, n_per=3, seed=1), 0.0, 0.5),
    "radon_ragged": (lambda: jh.radon(*_ragged_radon()),
                     lambda: th.radon(*_ragged_radon()), 0.0, 0.5),
    "sv": (lambda: jsv.stochastic_volatility(T=14, seed=0),
           lambda: tsv.stochastic_volatility(T=14, seed=0), 0.0, 0.5),
    "sv_long": (lambda: jsv.stochastic_volatility(T=600, seed=2),
                lambda: tsv.stochastic_volatility(T=600, seed=2), 0.0, 0.3),
    # runs of R = 2 innovations a thread (T = 300, d = 302: the size the
    # card tests run on the dim-on-lanes kernels with data)
    "sv_300": (lambda: jsv.stochastic_volatility(T=300, seed=4),
               lambda: tsv.stochastic_volatility(T=300, seed=4), 0.0, 0.3),
    # the sampler's own starts far out in log sigma at T = 1000 (_points)
    "sv_far": (lambda: jsv.stochastic_volatility(T=1000, seed=0),
               lambda: tsv.stochastic_volatility(T=1000, seed=0), None, None),
}
FUNCTOR_CASES = ("rank1", "correlated_normal", "funnel", "radon",
                 "radon_ragged", "sv", "sv_long", "sv_300", "sv_far")


def _ragged_radon():
    """Groups of uneven sizes (one empty) in an order that is not sorted."""
    rng = np.random.default_rng(3)
    groups = np.array([2, 0, 2, 1, 2, 4, 0, 2, 4, 4, 1])
    x = rng.binomial(1, 0.5, size=groups.size).astype(np.float64)
    y = rng.normal(size=groups.size)
    return y, x, groups


def _points(name, dim, n=5):
    _, make_t, centre, spread = CASES[name]
    if name == "sv_far":
        # the first n of the initial positions that Sampler draws for seed 0
        # (uniform in (-2, 2)) with log sigma above 1 and a finite density
        # and gradient in float32: where every tree starts to diverge
        tm = make_t()
        q = tm.init_position(0, 0, 512, torch.float32, "cpu")
        logp, g = tm.logp_and_grad(q)
        ok = (q[:, 0] > 1.0) & torch.isfinite(logp) \
            & torch.isfinite(g).all(-1)
        assert int(ok.sum()) >= n
        return q[ok][:n].numpy().astype(np.float64)
    return centre + spread * np.random.default_rng(dim).normal(size=(n, dim))


def _f64_hook(name, tm):
    """The functor's data in float64 from the model's own numpy data, for
    the float64 comparisons (the hook tensors are float32)."""
    _, floats, tensors = tm.hook_parts()
    if name.startswith("sv"):
        T, seed = {"sv": (14, 0), "sv_long": (600, 2), "sv_300": (300, 4),
                   "sv_far": (1000, 0)}[name]
        return floats, (torch.as_tensor(tsv.generate_returns(T, seed=seed)),)
    if name == "radon":
        return floats, th.radon_tensors(*th.generate_radon(J=4, n_per=3,
                                                           seed=1),
                                        dtype=np.float64)
    if name == "radon_ragged":
        return floats, th.radon_tensors(*_ragged_radon(), dtype=np.float64)
    if name == "rank1":
        rng = np.random.default_rng(42)
        u = rng.normal(size=6)
        u /= np.linalg.norm(u)
        return floats, (torch.as_tensor(u), torch.full((6,), 1.5,
                                                       dtype=torch.float64))
    return floats, tensors


@pytest.mark.parametrize("name", ["rank1", "radon", "radon_ragged", "sv",
                                  "sv_long"])
def test_model_data_are_the_jax_models(name):
    make_j, make_t, _, _ = CASES[name]
    jm, tm = make_j(), make_t()
    assert tm.dim == jm.dim and tm.carries_data
    _, jargs = jm.pallas_spec
    hook_name, floats, tensors = tm.hook_parts()
    # the size rules count the JAX model's arrays, whatever form the hook's
    assert tm.data_bytes == 4 * sum(int(np.prod(a.shape)) for a in jargs)
    for t in tensors:
        assert t.is_contiguous() and t.device.type == "cpu"
    if name.startswith("sv"):
        assert hook_name == "stochastic_volatility" and floats == (10.0, 0.1)
        np.testing.assert_array_equal(tensors[0].numpy(),
                                      np.asarray(jargs[0], np.float32)[:, 0])
        T, seed = (14, 0) if name == "sv" else (600, 2)
        np.testing.assert_array_equal(tsv.generate_returns(T, seed=seed),
                                      jsv.generate_returns(T, seed=seed))
    elif name.startswith("radon"):
        G, x, y = (np.asarray(a) for a in jargs)
        groups = G.argmax(1)
        order = np.argsort(groups, kind="stable")
        tx, ty, off = (t.numpy() for t in tensors)
        np.testing.assert_array_equal(tx, x[order, 0])
        np.testing.assert_array_equal(ty, y[order, 0])
        np.testing.assert_array_equal(off, np.r_[0, np.cumsum(
            np.bincount(groups, minlength=G.shape[1]))])
        assert off.dtype == np.int32 and tx.dtype == np.float32
        if name == "radon":
            for a, b in zip(th.generate_radon(J=4, n_per=3, seed=1),
                            jh.generate_radon(J=4, n_per=3, seed=1)):
                np.testing.assert_array_equal(a, b)
    else:
        assert hook_name == "correlated_normal_rank1"
        np.testing.assert_allclose(floats, (1.0 / 1000.0 - 1.0,))
        for t, a in zip(tensors, jargs):
            np.testing.assert_array_equal(t.numpy(),
                                          np.asarray(a, np.float32)[:, 0])


@pytest.mark.parametrize("name", list(CASES))
def test_logp_and_autodiff_match_the_jax_model_in_f64(name):
    make_j, make_t, _, _ = CASES[name]
    jm, tm = make_j(), make_t()
    assert tm.dim == jm.dim and tm.name == jm.name
    q = _points(name, jm.dim)
    jlogp, jgrad = jax.vmap(jax.value_and_grad(jm.logp_fn))(jnp.asarray(q))
    qt = torch.as_tensor(q)
    logp = torch.stack([tm.logp_fn(x) for x in qt])
    g = vmap(grad(tm.logp_fn))(qt)
    np.testing.assert_allclose(logp.numpy(), np.asarray(jlogp), rtol=1e-12,
                               atol=1e-12)
    scale = np.abs(np.asarray(jgrad)).max()
    np.testing.assert_allclose(g.numpy(), np.asarray(jgrad), rtol=1e-10,
                               atol=1e-12 * scale)
    lp2, g2 = tm.logp_and_grad(qt)
    np.testing.assert_allclose(lp2.numpy(), logp.numpy(), rtol=1e-13)
    np.testing.assert_allclose(g2.numpy(), g.numpy(), rtol=1e-13)


@pytest.mark.parametrize("name", FUNCTOR_CASES)
def test_plain_functor_gradient_is_the_autodiff_of_logp_fn(name):
    """The closed form against ``torch.func.grad`` of the port's own
    ``logp_fn``, float64 throughout (the functor fed float64 data)."""
    tm = CASES[name][1]()
    hook_name, _, _ = tm.hook_parts()
    floats, tensors = _f64_hook(name, tm)
    q = torch.as_tensor(_points(name, tm.dim))
    logp, g = tg.PLAIN_FUNCTORS[hook_name](q, *floats, *tensors, tsum)
    want_g = vmap(grad(tm.logp_fn))(q)
    want = torch.stack([tm.logp_fn(x) for x in q])
    np.testing.assert_allclose(logp.numpy(), want.numpy(), rtol=1e-12)
    np.testing.assert_allclose(g.numpy(), want_g.numpy(), rtol=1e-10,
                               atol=1e-12 * float(want_g.abs().max()))


@pytest.mark.parametrize("name", FUNCTOR_CASES)
def test_plain_functor_matches_the_jax_model_in_f32(name):
    """The functor as the kernels evaluate it (float32 data and state,
    ``tsum``) against the JAX model in float32: the Pallas hook's density
    and its gradient by autodiff."""
    make_j, make_t, _, _ = CASES[name]
    jm, tm = make_j(), make_t()
    hook_name, floats, tensors = tm.hook_parts()
    q = _points(name, jm.dim).astype(np.float32)
    if jm.pallas_spec is not None:
        fn, args = jm.pallas_spec
        args = tuple(jnp.asarray(a, jnp.float32) for a in args)
        f = lambda x: fn(x, *args)  # noqa: E731
    else:
        f = jm.logp_fn
    jlogp, jgrad = jax.vmap(jax.value_and_grad(f))(jnp.asarray(q))
    logp, g = tg.PLAIN_FUNCTORS[hook_name](torch.as_tensor(q), *floats,
                                           *tensors, tsum)
    assert logp.dtype == torch.float32 and g.dtype == torch.float32
    jlogp, jgrad = np.asarray(jlogp), np.asarray(jgrad)
    np.testing.assert_allclose(logp.numpy(), jlogp, rtol=2e-5,
                               atol=2e-5 * np.abs(jlogp).max())
    np.testing.assert_allclose(g.numpy(), jgrad, rtol=2e-5,
                               atol=2e-5 * np.abs(jgrad).max())


def test_sv_functor_is_accurate_at_every_far_start():
    """The SV functor in float32, as the kernels evaluate it, at every
    initial position that Sampler gives 512 chains at T = 1000 and seed 0
    beyond log sigma 0 (where some chains stay stuck, in this package and
    in the JAX package's sync engine): finite, and within 1e-6 of the
    largest gradient magnitude of float64 autodiff of ``logp_fn``."""
    from nuts_rs_tpu_torch import DiagNutsSettings, Sampler

    tm = tsv.stochastic_volatility(T=1000, seed=0)
    q = Sampler(tm, DiagNutsSettings(num_chains=512, seed=0,
                                     posterior_kernel="pallas"),
                device="cpu").state.pt.q
    q = q[q[:, 0] > 0.0]
    assert len(q) == 178
    hook_name, floats, tensors = tm.hook_parts()
    logp, g = tg.PLAIN_FUNCTORS[hook_name](q, *floats, *tensors, tsum)
    assert torch.isfinite(logp).all() and torch.isfinite(g).all()
    want = vmap(grad(tm.logp_fn))(q.double())
    scale = want.abs().max(1).values
    err = ((g.double() - want).abs().max(1).values / scale).max()
    assert float(err) < 1e-6


@pytest.mark.parametrize("dtype,rtol", [(torch.float64, 1e-12),
                                        (torch.float32, 2e-6)])
def test_digamma_series_matches_torch(dtype, rtol):
    x = torch.linspace(0.05, 200.0, 4001, dtype=dtype)
    want = torch.digamma(x.double())
    np.testing.assert_allclose(tsv.digamma(x).double().numpy(),
                               want.numpy(), rtol=rtol,
                               atol=rtol * float(want.abs().max()))


@pytest.mark.parametrize("dtype,rtol", [(torch.float64, 1e-12),
                                        (torch.float32, 2e-6)])
def test_lgamma_series_and_log1p_match_torch(dtype, rtol):
    x = torch.linspace(0.05, 200.0, 4001, dtype=dtype)
    want = torch.lgamma(x.double())
    np.testing.assert_allclose(tsv.lgamma(x).double().numpy(), want.numpy(),
                               rtol=rtol, atol=rtol * 10)
    w = torch.logspace(-12, 6, 400, dtype=dtype)
    np.testing.assert_allclose(tsv.log1p(w).double().numpy(),
                               torch.log1p(w.double()).numpy(), rtol=rtol)
    assert tsv.log1p(torch.zeros(1, dtype=dtype)).item() == 0.0


@pytest.mark.parametrize("T", [14, 256, 257, 1000])
def test_sv_scan_order_matches_cumsum(T):
    """The functor's cumulative sum (runs of ceil(T / 256), a scan of the
    256 run totals) and reverse cumulative sum agree with ``torch.cumsum``
    to float32 rounding, and are exact on integers."""
    R = tsv._run_length(T)
    rng = np.random.default_rng(T)
    for ints in (False, True):
        x = rng.integers(-8, 8, size=(3, T)) if ints else \
            rng.normal(size=(3, T))
        x = torch.as_tensor(x, dtype=torch.float32)
        E = tsv._runs(x, T, R)
        loc = [E[..., 0]]
        for i in range(1, R):
            loc.append(loc[-1] + E[..., i])
        loc = torch.stack(loc, -1)
        c = (tsv._scan_exclusive(loc[..., R - 1])[..., None]
             + loc).reshape(3, -1)[:, :T]
        want = torch.cumsum(x.double(), 1)
        if ints:
            np.testing.assert_array_equal(c.numpy(), want.numpy())
        else:
            np.testing.assert_allclose(c.numpy(), want.numpy(), rtol=1e-5,
                                       atol=1e-5 * T ** 0.5)
    # the reverse scan is the same on the reversed runs and threads
    x = torch.as_tensor(rng.integers(-8, 8, size=(2, T)), dtype=torch.float32)
    S = tsv._run_sums(x, T, R)
    suffix = tsv._scan_exclusive(S.flip(-1)).flip(-1)
    np.testing.assert_array_equal(
        (suffix + S)[:, 0].numpy(), x.sum(1).numpy())


def test_expansions_dims_and_coords_are_carried():
    tr, ts = th.radon(J=4, n_per=3, seed=1), tsv.stochastic_volatility(T=14)
    jr, js = jh.radon(J=4, n_per=3, seed=1), jsv.stochastic_volatility(T=14)
    q = _points("radon", tr.dim)[0]
    for tm, jm, qq in ((tr, jr, q), (ts, js, _points("sv", ts.dim)[0])):
        assert dict(tm.dims) == {k: tuple(v) for k, v in jm.dims.items()}
        for k, v in jm.coords.items():
            np.testing.assert_array_equal(tm.coords[k], v)
        got = tm.expand_fn(torch.as_tensor(qq))
        want = jm.expand_fn(None, jnp.asarray(qq))
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       rtol=1e-12)
    e8 = tg.eight_schools()
    assert set(e8.expand_fn(torch.zeros(10))) == {"mu", "tau", "theta"}
    assert dict(e8.dims) == {"theta": ["school"]}


def test_models_move_to_a_device_with_their_data():
    for m in (th.radon(J=4, n_per=3), tsv.stochastic_volatility(T=14),
              tg.correlated_normal_rank1(6), tg.mv_normal(_COV),
              tg.eight_schools()):
        moved = m.to("cpu")
        assert moved.dim == m.dim and moved.name == m.name
        q = torch.zeros(m.dim, dtype=torch.float64)
        assert float(moved.logp_fn(q)) == float(m.logp_fn(q))
    for m in (tg.funnel(5), tg.correlated_normal(5)):
        assert m.to("cpu") is m and not m.carries_data
