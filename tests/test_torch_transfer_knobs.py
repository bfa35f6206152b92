"""The transfer knobs of the port's ``Sampler`` (``keep_stats``,
``draw_dtype``, ``stats_dtype``, ``store_warmup``; ``sampler._Transfer``)
on the CPU, against the JAX package: the trace's groups, names, dtypes and
shapes and ``schema()`` equal the JAX package's for the same knobs; the
positions at ``draw_dtype`` are the full run's cast; an all-tuning chunk
with ``store_warmup=False`` copies the accounting planes alone."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nuts_rs_tpu as jnt
import nuts_rs_tpu_torch as tnt
from nuts_rs_tpu.models import gaussian as jg
from nuts_rs_tpu_torch.models import gaussian as tg

GROUPS = ("posterior", "sample_stats", "warmup_posterior",
          "warmup_sample_stats")
ALWAYS = {"position", "diverging", "n_steps", "step_size"}
KNOBS = {
    "keep": dict(keep_stats=("mean_tree_accept", "energy")),
    "draw_f16": dict(draw_dtype=np.float16),
    "stats_f16": dict(stats_dtype=np.float16),
    "no_warmup": dict(store_warmup=False),
    "all": dict(keep_stats=("energy", "transformation_index", "gradient"),
                draw_dtype=np.float16, stats_dtype=np.float16,
                store_warmup=False),
}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _settings(pkg, sampler, **kw):
    base = dict(num_chains=4, num_tune=12, num_draws=10, seed=2,
                store_gradient=True)
    base.update(kw)
    make = {"nuts": pkg.DiagNutsSettings, "mclmc": pkg.DiagMclmcSettings}
    return make[sampler](**base)


def _summary(trace):
    return {g: {n: (a.dtype, a.shape) for n, a in getattr(trace, g).items()}
            for g in GROUPS}


@pytest.mark.parametrize("knobs", list(KNOBS))
@pytest.mark.parametrize("sampler", ["nuts", "mclmc"])
def test_trace_and_schema_are_the_jax_packages(sampler, knobs):
    kw = KNOBS[knobs]
    ts, js = _settings(tnt, sampler), _settings(jnt, sampler)
    model, jmodel = tg.normal_logp(3, 1.0), jg.normal_logp(3, 1.0)
    want = jnt.schema(jmodel, js, dtype=jnp.float32, **kw)
    got = tnt.schema(model, ts, **kw)
    for group in GROUPS + ("events",):
        assert got[group] == want[group], group
    sampler_ = tnt.Sampler(model, ts, device="cpu", chunk_size=5, **kw)
    assert sampler_.schema() == got
    trace = sampler_.run()
    jtrace = jnt.sample(jmodel, js, dtype=jnp.float32, chunk_size=5, **kw)
    assert _summary(trace) == _summary(jtrace)
    for group in GROUPS:
        arrays = getattr(trace, group)
        assert set(arrays) == set(got[group]) or (
            not got[group] and all(a.shape[1] == 0 for a in arrays.values()))
    if "keep_stats" in kw:
        assert set(trace.sample_stats) | {"position"} == (
            ALWAYS | set(kw["keep_stats"])) & (
            set(tnt.schema(model, ts)["sample_stats"]) | {"position"})
    if kw.get("store_warmup") is False:
        assert all(a.shape[1] == 0 for g in ("warmup_posterior",
                                             "warmup_sample_stats")
                   for a in getattr(trace, g).values())


@pytest.mark.parametrize("kernel", ["sync", "pallas"])
def test_draw_dtype_casts_the_same_positions(kernel):
    """Same seed, same engines: the float16 positions are the float32 run's
    cast, bit for bit, and the int and bool stats keep their dtypes under
    ``stats_dtype``."""
    kw = dict(num_chains=4, num_tune=10, num_draws=8, seed=5,
              posterior_kernel=kernel)
    model = tg.normal_logp(3, 1.0)
    full = tnt.sample(model, tnt.DiagNutsSettings(**kw), device="cpu")
    half = tnt.sample(model, tnt.DiagNutsSettings(**kw), device="cpu",
                      draw_dtype=np.float16, stats_dtype=np.float16)
    pos = half.posterior["position"]
    assert pos.dtype == np.float16
    np.testing.assert_array_equal(
        pos, full.posterior["position"].astype(np.float16))
    np.testing.assert_array_equal(
        half.warmup_posterior["position"],
        full.warmup_posterior["position"].astype(np.float16))
    st = half.sample_stats
    assert st["energy"].dtype == np.float16
    assert st["depth"].dtype == np.int32 and st["diverging"].dtype == bool
    np.testing.assert_array_equal(st["n_steps"], full.sample_stats["n_steps"])


def test_an_all_tuning_chunk_copies_the_accounting_planes_alone():
    """``store_warmup=False``: a chunk of tuning draws crosses with
    ``diverging``, ``n_steps`` and ``step_size`` alone and is not stored;
    a chunk across the end of the warmup keeps its posterior rows."""
    settings = tnt.DiagNutsSettings(num_chains=4, num_tune=8, num_draws=6,
                                    seed=1)
    sampler = tnt.Sampler(tg.normal_logp(3), settings, device="cpu",
                          chunk_size=5, store_warmup=False,
                          stats_dtype=np.float16)
    lo, stats, tuning = sampler.run_next_chunk()
    assert lo == 0 and tuning.all()
    assert set(stats) == {"diverging", "n_steps", "step_size"}
    assert stats["step_size"].dtype == np.float16
    lo, stats, tuning = sampler.run_next_chunk()
    assert lo == 5 and tuning.tolist() == [True, True, True, False, False]
    assert "position" in stats and "energy" in stats
    trace = sampler.run()
    assert trace.posterior["position"].shape == (4, 6, 3)
    assert trace.warmup_posterior["position"].shape == (4, 0, 3)
    assert trace.sample_stats["energy"].dtype == np.float16
