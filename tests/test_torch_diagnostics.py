"""The port's copy of the convergence diagnostics
(``nuts_rs_tpu_torch/diagnostics.py``: split R-hat, bulk and tail ESS,
``summary``) and ``ConvergenceStop.satisfied``, held against the JAX
package's on the same seeded numpy inputs: every value within 1e-12, NaN
where it is NaN, and the same verdicts."""

import numpy as np
import pytest
import torch

import nuts_rs_tpu as jnt
import nuts_rs_tpu_torch as tnt
from nuts_rs_tpu import diagnostics as jd
from nuts_rs_tpu_torch import diagnostics as td

TOL = 1e-12


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _ar1(rng, c, n, phi, dims=()):
    x = np.zeros((c, n) + dims)
    innov = rng.normal(size=(c, n) + dims) * np.sqrt(1 - phi ** 2)
    x[:, 0] = rng.normal(size=(c,) + dims)
    for t in range(1, n):
        x[:, t] = phi * x[:, t - 1] + innov[:, t]
    return x


def _inputs():
    rng = np.random.default_rng(11)
    shifted = rng.normal(size=(4, 300))
    shifted[0] += 5.0
    with_const = rng.normal(size=(4, 200, 3))
    with_const[..., 1] = 2.0
    return {
        "iid": rng.normal(size=(8, 500)),
        "ar1": _ar1(rng, 6, 800, 0.9),
        "shifted": shifted,
        "multidim": _ar1(rng, 4, 400, 0.5, (3,)),
        "odd_draws": rng.normal(size=(3, 101, 2)),
        "float16": rng.normal(size=(4, 150, 2)).astype(np.float16),
        "with_constant_dim": with_const,
        "constant": np.ones((4, 100)),
        "short": rng.normal(size=(2, 5)),
        "one_chain": rng.normal(size=(1, 64)),
    }


def _same(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    np.testing.assert_allclose(got[ok], want[ok], rtol=TOL, atol=TOL)


@pytest.mark.parametrize("case", list(_inputs()))
@pytest.mark.parametrize("fn", ["split_rhat", "ess_bulk", "ess_tail"])
def test_diagnostics_equal_the_jax_packages(fn, case):
    x = _inputs()[case]
    _same(getattr(td, fn)(x), getattr(jd, fn)(x))


def test_summary_equals_the_jax_packages():
    rng = np.random.default_rng(5)
    pos = _ar1(rng, 4, 200, 0.3, (3,)) + 1.0
    trace = tnt.Trace(posterior={"position": pos}, sample_stats={},
                      warmup_posterior={}, warmup_sample_stats={},
                      transformation_updates=[])
    got, want = td.summary(trace), jd.summary(trace)
    assert set(got) == set(want)
    for k in want:
        _same(got[k], want[k])


def test_package_exports_the_diagnostics():
    for name in ("split_rhat", "ess_bulk", "ess_tail", "summary"):
        assert getattr(tnt, name) is getattr(td, name)


@pytest.mark.parametrize("crit", [
    dict(),
    dict(rhat_max=1.001, min_ess_bulk=10.0, min_draws=10),
    dict(rhat_max=1.5, min_ess_bulk=100.0, min_draws=10),
    dict(rhat_max=1.2, min_ess_bulk=50.0, min_draws=10, check_dims=1),
    dict(min_ess_bulk=1e9, min_draws=10),
])
def test_convergence_stop_verdicts_equal_the_jax_packages(crit):
    cases = dict(_inputs())
    verdicts = []
    for name, x in cases.items():
        got = tnt.ConvergenceStop(**crit).satisfied(x)
        want = jnt.ConvergenceStop(**crit).satisfied(x)
        assert got == want, name
        verdicts.append(got)
    if crit.get("min_ess_bulk") == 50.0:
        # the cases hold both verdicts: the comparison decides something
        assert True in verdicts and False in verdicts
