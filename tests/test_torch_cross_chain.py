"""Cross-chain adaptation on one device (queue 1 item 17a) against the JAX
package, on the CPU.

``parallel/collectives.py::merge_running_variance`` and the pooled
``DiagStrategy.adapt_update`` equal the JAX functions from one estimator
state (float64, rtol 1e-12).  Through the ``Sampler``:
``cross_chain_adaptation=True`` under NUTS shares one mass matrix and one
adapted step size over the chains (``transformation_index``,
``mass_matrix_inv``, ``transformation_mu`` and ``step_size_bar`` equal on
every draw; each chain's ``step_size`` keeps its own jitter, as in the
JAX package, ``tests/test_sampler.py:369-373``), under MCLMC one mass
matrix (its step is fixed); both are held in distribution against the
JAX package's sync engine (its threefry streams cannot be matched):
means within 0.15 and standard deviations within 10% of the JAX run's
and the analytic ones.  With ``max_chains_per_launch`` each launch group
pools its own chains, with the JAX package's ``UserWarning``; a
``"pallas"`` request is demoted with the JAX reason."""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nuts_rs_tpu as jnt
from nuts_rs_tpu import chain as jchain
from nuts_rs_tpu.adapt import mass_matrix as jmm
from nuts_rs_tpu.models import gaussian as jg
from nuts_rs_tpu.parallel.collectives import (
    merge_running_variance as jmerge,
)
from nuts_rs_tpu.transform import affine as jaff
import nuts_rs_tpu_torch as tnt
from nuts_rs_tpu_torch import chain as tchain
from nuts_rs_tpu_torch.adapt import mass_matrix as tmm
from nuts_rs_tpu_torch.models.gaussian import correlated_normal, normal_logp
from nuts_rs_tpu_torch.parallel.collectives import merge_running_variance
from nuts_rs_tpu_torch.transform import affine as taff

C, D = 5, 4
JITTER = 0.1  # StepSizeSettings' default


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _estimators(seed):
    rng = np.random.default_rng(seed)
    return [dict(mean=rng.normal(size=(C, D)),
                 var_sum=rng.random((C, D)) * 5,
                 count=rng.integers(0, 12, C).astype(np.float64))
            for _ in range(4)]


def _rv(e, pkg):
    if pkg == "torch":
        return tmm.RunningVariance(**{k: torch.as_tensor(v)
                                      for k, v in e.items()})
    return jmm.RunningVariance(**{k: jnp.asarray(v) for k, v in e.items()})


def test_merge_running_variance_equals_the_jax_one():
    for e in _estimators(0):
        got = merge_running_variance(_rv(e, "torch"))
        want = jmerge(_rv(e, "jax"))
        for name in ("mean", "var_sum", "count"):
            np.testing.assert_allclose(getattr(got, name).numpy(),
                                       np.asarray(getattr(want, name)),
                                       rtol=1e-12, atol=1e-12, err_msg=name)
    # no samples at all: the JAX guard against dividing by 0
    e = _estimators(1)[0]
    e["count"][:] = 0.0
    got = merge_running_variance(_rv(e, "torch"))
    assert torch.isfinite(got.mean).all() and (got.count == 0).all()


@pytest.mark.parametrize("grad_based", [True, False])
def test_pooled_adapt_update_equals_the_jax_one(grad_based):
    es = _estimators(2)
    rng = np.random.default_rng(3)
    stds, mean = np.exp(rng.normal(size=(C, D))), rng.normal(size=(C, D))
    settings = tnt.DiagNutsSettings(use_grad_based_estimate=grad_based)
    jsettings = jnt.DiagNutsSettings(use_grad_based_estimate=grad_based)
    t = taff.set_diag(taff.identity_transform(C, D, torch.float64, "cpu"),
                      torch.as_tensor(stds), torch.as_tensor(mean))
    jt = jax.vmap(lambda s, m: jaff.set_diag(
        jaff.identity_transform(D, jnp.float64), s, m))(
        jnp.asarray(stds), jnp.asarray(mean))
    state = tchain.ChainState(
        pt=None, transform=t, step=None, draw_idx=0,
        diag_adapt=tmm.DiagAdaptState(*(_rv(e, "torch") for e in es)))
    jstate = jchain.ChainState(
        pt=None, transform=jt, step=None, keys=None, draw_idx=0,
        diag_adapt=jmm.DiagAdaptState(*(_rv(e, "jax") for e in es)))
    got = tchain.DiagStrategy(settings.chain_config(),
                              cross_chain=True).adapt_update(state)
    want = jchain.DiagStrategy(jsettings.chain_config(),
                               cross_chain=True).adapt_update(jstate)
    for name in ("stds", "mean", "inv_stds", "logdet"):
        np.testing.assert_allclose(getattr(got.transform, name).numpy(),
                                   np.asarray(getattr(want.transform, name)),
                                   rtol=1e-12, atol=1e-12, err_msg=name)
    np.testing.assert_array_equal(got.transform.id.numpy(),
                                  np.asarray(want.transform.id))
    # one transform for every chain, the estimators themselves untouched
    assert (got.transform.stds == got.transform.stds[:1]).all()
    assert got.diag_adapt is state.diag_adapt


def _moments(trace):
    pos = np.asarray(trace.posterior["position"], np.float64)
    return pos.reshape(-1, pos.shape[-1]).mean(0), pos.reshape(
        -1, pos.shape[-1]).std(0)


def _shared(stats, name, rtol=0.0, first=0):
    """``stats[name]`` equal over the chains from draw ``first`` on."""
    x = np.asarray(stats[name])[:, first:]
    np.testing.assert_allclose(x, np.broadcast_to(x[:1], x.shape),
                               rtol=rtol, atol=0, err_msg=name)


def _first_update(stats):
    """The first draw after the first pooled update: before it each chain
    has its own transform, from its own initial gradient (nuts-rs
    diagonal.rs:209-231)."""
    tid = np.asarray(stats["transformation_index"])
    return int(np.argmax(tid[0] != tid[0, 0]))


@pytest.mark.parametrize("sampler", ["nuts", "mclmc"])
def test_pooled_runs_share_the_adaptation(sampler):
    kw = dict(num_chains=6, num_tune=200, num_draws=300, seed=5,
              cross_chain_adaptation=True, store_mass_matrix=True)
    make = (tnt.DiagNutsSettings if sampler == "nuts"
            else tnt.DiagMclmcSettings)
    jmake = (jnt.DiagNutsSettings if sampler == "nuts"
             else jnt.DiagMclmcSettings)
    trace = tnt.sample(normal_logp(D, 1.0), make(**kw), device="cpu",
                       dtype=torch.float64)
    jtrace = jnt.sample(jg.normal_logp(D, mu=1.0), jmake(**kw))
    first = _first_update(trace.warmup_sample_stats)
    assert 0 < first < 10
    _shared(trace.warmup_sample_stats, "transformation_index")
    for stats, lo in ((trace.warmup_sample_stats, first),
                      (trace.sample_stats, 0)):
        for name in ("transformation_index", "mass_matrix_inv",
                     "transformation_mu"):
            _shared(stats, name, first=lo)
        if sampler == "nuts":
            _shared(stats, "step_size_bar")
            # each chain's step keeps its own jitter around the shared one
            ss = np.asarray(stats["step_size"])
            assert (ss.max(0) / ss.min(0)
                    <= (1 + JITTER) / (1 - JITTER) + 1e-12).all()
    # the JAX package shares the same things
    jw = jtrace.warmup_sample_stats
    for name in ("transformation_index", "mass_matrix_inv"):
        _shared(jw, name, rtol=1e-12, first=_first_update(jw))
    # the same number of pooled updates at the same draws
    np.testing.assert_array_equal(
        trace.warmup_sample_stats["transformation_index"][0],
        np.asarray(jw["transformation_index"])[0])
    mean, std = _moments(trace)
    jmean, jstd = _moments(jtrace)
    np.testing.assert_allclose(mean, jmean, atol=0.15)
    np.testing.assert_allclose(std, jstd, rtol=0.1)
    np.testing.assert_allclose(mean, 1.0, atol=0.15)
    if sampler == "nuts":  # MCLMC is unadjusted: its std is the JAX run's
        np.testing.assert_allclose(std, 1.0, rtol=0.1)
        assert not trace.sample_stats["diverging"].any()


def test_launch_groups_pool_within_themselves():
    kw = dict(num_chains=6, num_tune=60, num_draws=20, seed=1,
              cross_chain_adaptation=True, store_mass_matrix=True)
    # correlated, so that the pooled estimates are not exactly the iid
    # normal's 1 and mu in every group
    with pytest.warns(UserWarning, match="pools within each 3-chain "
                      "launch group only"):
        s = tnt.Sampler(correlated_normal(D, 0.5),
                        tnt.DiagNutsSettings(**kw), device="cpu",
                        max_chains_per_launch=3)
    tr = s.run()
    mm = tr.sample_stats["mass_matrix_inv"][:, -1]
    bars = tr.sample_stats["step_size_bar"][:, -1]
    for group in (slice(0, 3), slice(3, 6)):
        np.testing.assert_array_equal(mm[group], np.broadcast_to(
            mm[group][:1], mm[group].shape))
        np.testing.assert_array_equal(bars[group], bars[group][0])
    # the two groups pooled apart
    assert not np.array_equal(mm[0], mm[3])
    assert bars[0] != bars[3]
    # the JAX package warns alike
    with pytest.warns(UserWarning, match="pools within each 3-chain"):
        jnt.Sampler(jg.normal_logp(D, mu=1.0), jnt.DiagNutsSettings(**kw),
                    max_chains_per_launch=3)


@pytest.mark.parametrize("sampler", ["nuts", "mclmc"])
def test_a_fused_request_is_demoted_with_the_jax_reason(sampler):
    kw = dict(num_chains=4, num_tune=6, num_draws=4,
              cross_chain_adaptation=True, posterior_kernel="pallas")
    make = (tnt.DiagNutsSettings if sampler == "nuts"
            else tnt.DiagMclmcSettings)
    jmake = (jnt.DiagNutsSettings if sampler == "nuts"
             else jnt.DiagMclmcSettings)
    assert make(**kw)._pallas_disqualifiers() == \
        jmake(**kw)._pallas_disqualifiers() == ["cross_chain_adaptation=True"]
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        s = tnt.Sampler(normal_logp(3, 1.0), make(**kw), device="cpu")
    texts = [str(w.message) for w in seen]
    assert any("does not support: cross_chain_adaptation=True" in t
               for t in texts), texts
    assert all("sync" in r.__qualname__ for _, _, r in s._phase_runners)
    assert s.run().posterior["position"].shape == (4, 4, 3)


def test_good_draw_windows_keep_the_jax_error():
    kw = dict(cross_chain_adaptation=True,
              adapt=tnt.AdaptScheduleOptions(window_by_good_draws=True))
    with pytest.raises(ValueError, match="incompatible with "
                       "cross_chain_adaptation"):
        tnt.DiagNutsSettings(**kw).chain_config()
    with pytest.raises(ValueError, match="incompatible with "
                       "cross_chain_adaptation"):
        jnt.DiagNutsSettings(
            cross_chain_adaptation=True,
            adapt=jnt.AdaptScheduleOptions(
                window_by_good_draws=True)).chain_config()


def test_pooled_low_rank_refits_share_one_transform():
    """``LowRankNutsSettings(cross_chain_adaptation=True)``: every refit is
    the pooled one (``pooled_compute_update``), so every chain carries one
    low-rank transform, and the step is pooled as under the diagonal
    strategy (the JAX twin is ``tests/test_low_rank.py::
    test_cross_chain_pooled_low_rank``)."""
    from nuts_rs_tpu_torch.models.gaussian import correlated_normal_rank1

    settings = tnt.LowRankNutsSettings(
        num_chains=4, num_tune=120, num_draws=60, seed=2,
        cross_chain_adaptation=True,
        adapt=tnt.AdaptScheduleOptions(mass_matrix_update_freq=20),
        low_rank=tnt.LowRankSettings(store_mass_matrix=True))
    s = tnt.Sampler(correlated_normal_rank1(6, eig=20.0), settings,
                    device="cpu", dtype=torch.float64)
    trace = s.run()
    t = s.state.transform
    for name in ("stds", "mean", "vecs", "vals_sqrt", "mu_lr", "logdet"):
        x = getattr(t, name)
        assert torch.equal(x, x[:1].expand_as(x)), name
    ws = trace.warmup_sample_stats
    first = _first_update(ws)
    for name in ("transformation_index", "num_eigenvalues",
                 "mass_matrix_eigvals"):
        _shared(ws, name, first=first)
    _shared(trace.sample_stats, "step_size_bar")
    assert (ws["num_eigenvalues"][:, -1] >= 1).all()
    pos = trace.posterior["position"]
    assert np.isfinite(pos).all() and not trace.sample_stats[
        "diverging"].any()
