"""The extra stores of the port's sync draw steps (``store_gradient``,
``store_unconstrained``, ``store_transformed``, ``store_divergences``,
``store_mass_matrix``; ``chain.extra_stats``) on the CPU, against the JAX
package: what each stores, the trace's and ``schema()``'s names, dtypes and
shapes, the transformation events, and the plans (a fused request with an
extra store runs on the sync engine with the JAX package's warning)."""

import dataclasses
import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_nuts_sync import _fake_nuts_draws

import nuts_rs_tpu as jnt
import nuts_rs_tpu.chain as jchain
from nuts_rs_tpu.models import gaussian as jg
from nuts_rs_tpu.sampler import _strategy_for
from nuts_rs_tpu_torch import chain as tchain
import nuts_rs_tpu_torch as tnt
from nuts_rs_tpu_torch.adapt.schedule import build_schedule
from nuts_rs_tpu_torch.convert import state_from_numpy, state_to_numpy
from nuts_rs_tpu_torch.models import gaussian as tg
from nuts_rs_tpu_torch.sampler import _schedule_chunk

STORES = ("store_gradient", "store_unconstrained", "store_transformed",
          "store_divergences", "store_mass_matrix")
GROUPS = ("posterior", "sample_stats", "warmup_posterior",
          "warmup_sample_stats")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _settings(pkg, sampler, **kw):
    base = dict(num_chains=4, num_tune=20, num_draws=20, seed=1)
    base.update(kw)
    make = {"nuts": pkg.DiagNutsSettings, "mclmc": pkg.DiagMclmcSettings}
    return make[sampler](**base)


def _same_schema(got, want):
    assert set(got) == set(want)
    for group in GROUPS + ("events",):
        assert got[group] == want[group], group


def _trace_has_schema(trace, schema):
    for group in GROUPS:
        arrays = getattr(trace, group)
        assert set(arrays) == set(schema[group]), group
        for name, entry in schema[group].items():
            assert arrays[name].dtype == entry["dtype"], name
            assert arrays[name].shape[2:] == entry["shape"], name


@pytest.mark.parametrize("store", STORES)
@pytest.mark.parametrize("sampler", ["nuts", "mclmc"])
def test_each_store_runs_and_stores_the_jax_schema(sampler, store):
    """Each store under either sampler runs on the CPU (it used to be
    refused naming item 9); its trace holds the names, dtypes and shapes of
    the JAX package's schema for the same settings, and so does the port's
    ``schema()``."""
    model = tg.normal_logp(3, 1.0)
    ts = _settings(tnt, sampler, **{store: True})
    js = _settings(jnt, sampler, **{store: True})
    trace = tnt.sample(model, ts, device="cpu")
    want = jnt.schema(jg.normal_logp(3, 1.0), js, dtype=jnp.float32)
    _same_schema(tnt.schema(model, ts), want)
    _trace_has_schema(trace, want)
    st = trace.sample_stats
    pos = trace.posterior["position"]
    if store == "store_gradient":
        # the draw's gradient of the model, -(q - 1)
        np.testing.assert_allclose(st["gradient"], -(pos - 1.0), atol=1e-6)
    if store == "store_unconstrained":
        np.testing.assert_array_equal(st["unconstrained_draw"], pos)
    if store == "store_transformed" and sampler == "nuts":
        assert np.isfinite(st["transformed_position"]).all()
    if store == "store_divergences":
        # no draw diverged: the empty record, as the JAX step stores it
        assert not st["diverging"].any()
        for name in ("divergence_start", "divergence_end",
                     "divergence_start_gradient",
                     "divergence_start_momentum", "divergence_momentum",
                     "divergence_energy_error"):
            assert np.isnan(st[name]).all(), name
        assert (st["divergence_reason"] == 0).all()
    if store == "store_mass_matrix":
        stds = st["mass_matrix_inv"]
        assert (stds > 0).all() and np.isfinite(st["transformation_mu"]).all()
        # the transformation events carry the transform at each update
        ids = np.concatenate([trace.warmup_sample_stats[
            "transformation_index"], st["transformation_index"]], 1)
        every = np.concatenate([trace.warmup_sample_stats["mass_matrix_inv"],
                                stds], 1)
        for c, ev in enumerate(trace.transformation_updates):
            np.testing.assert_array_equal(ev["transformation_update_id"],
                                          ids[c][ev["draw"]])
            np.testing.assert_array_equal(ev["mass_matrix_inv"],
                                          every[c][ev["draw"]])


def test_transformed_point_is_the_transform_of_the_draw():
    """``transformed_position`` is ``(q - mu) / sigma`` and
    ``transformed_gradient`` ``g sigma`` under the posterior's frozen
    transform, which ``store_mass_matrix`` stores."""
    model = tg.normal_logp(3, 1.0)
    trace = tnt.sample(model, _settings(
        tnt, "nuts", store_transformed=True, store_mass_matrix=True,
        store_gradient=True), device="cpu")
    st = trace.sample_stats
    sigma, mu = st["mass_matrix_inv"], st["transformation_mu"]
    pos = trace.posterior["position"]
    np.testing.assert_allclose(st["transformed_position"],
                               (pos - mu) / sigma, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(st["transformed_gradient"],
                               st["gradient"] * sigma, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("sampler", ["nuts", "mclmc"])
def test_divergences_store_their_record(sampler):
    """A step far too large for the target: the divergent draws store a
    finite record with a reason, the others the empty one."""
    model = tg.normal_logp(3, 0.0)
    if sampler == "nuts":
        ts = _settings(tnt, "nuts", store_divergences=True,
                       max_energy_error=0.5, num_tune=0, num_draws=30,
                       step_size=tnt.StepSizeSettings(
                           method=tnt.StepSizeMethod.FIXED,
                           fixed_value=2.5))
    else:
        ts = _settings(tnt, "mclmc", store_divergences=True,
                       max_energy_error=5.0, dynamic_step_size=False,
                       step_size=1.0, num_tune=0, num_draws=30)
    st = tnt.sample(model, ts, device="cpu").sample_stats
    div = st["diverging"]
    assert div.any() and not div.all()
    assert (st["divergence_reason"][div] == 1).all()
    assert np.isfinite(st["divergence_start"][div]).all()
    assert np.isfinite(st["divergence_momentum"][div]).all()
    assert np.isfinite(st["divergence_energy_error"][div]).all()
    assert np.isnan(st["divergence_end"][~div]).all()
    assert (st["divergence_reason"][~div] == 0).all()


def test_nuts_draw_step_stores_what_the_jax_draw_step_stores(monkeypatch):
    """Every store on, both ``nuts_draw`` replaced by one made-up draw
    (tests/test_torch_nuts_sync.py): the stats record of each draw step,
    the extra stores included, agrees with the JAX ``make_draw_step``'s in
    names, shapes and values (1e-5)."""
    dim, C, tune = 4, 6, 12
    kw = dict(num_chains=C, num_tune=tune, num_draws=4,
              **{s: True for s in STORES})
    js = jnt.DiagNutsSettings(step_size=jnt.StepSizeSettings(jitter=None),
                              **kw)
    ts = tnt.DiagNutsSettings(step_size=tnt.StepSizeSettings(jitter=None),
                              **kw)
    jm, tm = jg.normal_logp(dim, 0.5), tg.normal_logp(dim, 0.5)
    jcfg, tcfg = js.chain_config(), ts.chain_config()
    jstate = jnt.Sampler(jm, js, dtype=jnp.float32).state
    tstate = state_from_numpy(state_to_numpy(jstate))
    j_draw, t_draw = _fake_nuts_draws(dim, C)
    monkeypatch.setattr(jchain, "nuts_draw", j_draw)
    monkeypatch.setattr(tchain, "nuts_draw", t_draw)
    jstep = jax.jit(jchain.make_draw_step(jm, _strategy_for(js, jcfg), jcfg))
    tstep = tchain.make_draw_step(tm, tchain.DiagStrategy(tcfg), tcfg, 0)
    sched = build_schedule(tune, 4, ts.adapt)
    for r in range(tune + 2):
        if sched.reinit_step_size[r]:
            continue
        flags = {k: v[0] for k, v in _schedule_chunk(sched, r, r + 1).items()}
        jstate = jstate._replace(draw_idx=jnp.asarray(r, jnp.int32))
        tstate = tstate._replace(draw_idx=r)
        jstate, jstats = jstep(jstate, {k: jnp.asarray(v)
                                        for k, v in flags.items()})
        tstate, tstats = tstep(tstate, {k: bool(v) for k, v in flags.items()})
        assert set(tstats) == set(jstats)
        for name, value in jstats.items():
            assert tstats[name].shape == np.asarray(value).shape, name
            np.testing.assert_allclose(
                tstats[name].numpy().astype(np.float64),
                np.asarray(value, np.float64), rtol=1e-5, atol=1e-6,
                equal_nan=True, err_msg=f"row {r} stat {name}")


def _kinds(phases):
    return [(lo, hi, "sync" if isinstance(r, functools.partial)
             or "sync" in r.__qualname__ else "fused")
            for lo, hi, r in phases]


@pytest.mark.parametrize("sampler", ["nuts", "mclmc"])
@pytest.mark.parametrize("store", ["store_gradient", "store_mass_matrix"])
def test_a_store_demotes_a_fused_request_as_the_jax_package(sampler, store):
    """An extra store is a disqualifier of the fused engines in both
    packages: the run is on the sync engine, with the JAX package's
    warning (its ``"XLA sync kernel"`` is the port's ``"sync engine"``)."""
    ts = _settings(tnt, sampler, posterior_kernel="pallas", **{store: True})
    js = _settings(jnt, sampler, posterior_kernel="pallas", **{store: True})
    jcfg = js.chain_config()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        got = _kinds(ts.build_phases(tg.normal_logp(3), ts.chain_config(),
                                     "cuda"))
        want = _kinds(js.build_phases(jg.normal_logp(3),
                                      _strategy_for(js, jcfg), jcfg))
    assert got == want
    assert {k for _, _, k in got} == {"sync"}
    texts = [str(w.message) for w in seen]
    assert len(texts) == 2
    assert texts[0].replace("XLA sync kernel", "sync engine") == texts[1] \
        or texts[1].replace("XLA sync kernel", "sync engine") == texts[0]


def test_a_flow_has_no_mass_matrix_to_store():
    with pytest.raises(ValueError, match="stds and mean"):
        tnt.FlowNutsSettings(store_mass_matrix=True).chain_config()
    assert dataclasses.replace(
        tnt.FlowNutsSettings(), store_gradient=True).chain_config() \
        .store_gradient
