"""The port's reference-name aliases and its ``dtype`` option, on the CPU.

The six aliases of ``nuts_rs_tpu/__init__.py:48-62`` (and
``DivergenceInfo``) name the same things in both packages and sit in
``__all__``; ``EuclideanAdaptOptions`` documents the nested fields it does
not take.  ``Sampler(dtype=torch.float64)`` runs the sync engine in
float64 (state, stats, schema), held in distribution against the JAX
package's float64 run (the tests' JAX is float64); a float64
``posterior_kernel="pallas"`` request is planned on the fused kernels, as
the JAX package plans it, without a warning: each launch takes float32
copies of the state, and the trace holds the dtypes of the JAX run at the
same settings."""

import warnings

import numpy as np
import pytest
import torch

import nuts_rs_tpu as jnt
import nuts_rs_tpu_torch as tnt
from nuts_rs_tpu.models import gaussian as jg
from nuts_rs_tpu_torch.checkpoint import state_leaves
from nuts_rs_tpu_torch.models.gaussian import normal_logp

ALIASES = {"KineticEnergyKind": "KineticKind",
           "StepSizeAdaptMethod": "StepSizeMethod",
           "FlowSettings": "FlowAdaptSettings",
           "EuclideanAdaptOptions": "AdaptScheduleOptions",
           "HashMapConfig": "MemoryConfig",
           "NdarrayConfig": "MemoryConfig"}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.mark.parametrize("alias,target", sorted(ALIASES.items()))
def test_each_alias_names_what_it_names_in_the_jax_package(alias, target):
    assert getattr(tnt, alias) is getattr(tnt, target)
    assert getattr(jnt, alias) is getattr(jnt, target)
    assert alias in tnt.__all__ and target in tnt.__all__
    assert getattr(tnt, alias).__name__ == getattr(jnt, alias).__name__


def test_the_exports_cover_the_jax_packages_but_what_is_not_ported():
    # the mesh is ROADMAP.md item 17b
    left_out = {"make_mesh"}
    assert set(jnt.__all__) - set(tnt.__all__) == left_out
    assert tnt.DivergenceInfo._fields == jnt.DivergenceInfo._fields
    for name in ("ZarrConfig", "DeviceLostError", "DivergenceInfo"):
        assert name in tnt.__all__
    doc = tnt.EuclideanAdaptOptions.__doc__
    assert "dual_average_options" in doc and "mass_matrix_options" in doc
    with pytest.raises(TypeError):
        tnt.EuclideanAdaptOptions(dual_average_options=None)


def test_float64_on_the_sync_engine_against_the_jax_float64_run():
    settings = dict(num_chains=8, num_tune=200, num_draws=300, seed=1)
    s = tnt.Sampler(normal_logp(3, 2.0), tnt.DiagNutsSettings(**settings),
                    device="cpu", dtype=torch.float64)
    floats = [x for x in state_leaves(s.state)
              if torch.is_tensor(x) and x.is_floating_point()]
    assert floats and all(x.dtype == torch.float64 for x in floats)
    assert s.state.step.step_size.dtype == torch.float64
    tr = s.run()
    pos = tr.posterior["position"]
    assert pos.dtype == np.float64
    assert tr.sample_stats["energy"].dtype == np.float64
    assert tr.sample_stats["n_steps"].dtype == np.int32
    sch = s.schema()
    assert sch["posterior"]["position"]["dtype"] == np.float64
    assert sch["sample_stats"]["energy"]["dtype"] == np.float64
    assert tnt.schema(normal_logp(3, 2.0), tnt.DiagNutsSettings(**settings),
                      dtype=torch.float64)["posterior"]["position"][
        "dtype"] == np.float64
    jtr = jnt.sample(jg.normal_logp(3, mu=2.0),
                     jnt.DiagNutsSettings(**settings))
    jpos = np.asarray(jtr.posterior["position"])
    assert jpos.dtype == np.float64
    # the same posterior within Monte-Carlo error (2400 draws a
    # coordinate, effective size well above 300): means within 0.15,
    # standard deviations within 10%
    np.testing.assert_allclose(pos.mean((0, 1)), jpos.mean((0, 1)),
                               atol=0.15)
    np.testing.assert_allclose(pos.std((0, 1)), jpos.std((0, 1)), rtol=0.1)
    np.testing.assert_allclose(pos.mean((0, 1)), 2.0, atol=0.15)
    assert not tr.sample_stats["diverging"].any()


def _trace_dtypes(trace):
    return {group: {k: np.asarray(v).dtype for k, v in getattr(
        trace, group).items()} for group in (
        "posterior", "sample_stats", "warmup_posterior",
        "warmup_sample_stats")}


def _fused_plan(phases):
    # this package's fused runners and the JAX package's are functions;
    # a sync phase is a make_sync_*runner closure or a functools.partial
    return [(lo, hi, "sync" if "sync" in getattr(r, "__qualname__", "sync")
             else "fused") for lo, hi, r in phases]


@pytest.mark.parametrize("sampler", ["nuts", "mclmc"])
def test_a_float64_fused_request_runs_the_fused_plan_as_the_jax_package(
        sampler):
    """Fault D: a float64 ``"pallas"`` request used to be demoted to the
    sync engine with a warning.  The JAX package plans it on its fused
    kernels (no dtype among its disqualifiers) and casts the operands at
    launch; so does the port.  Its trace's dtypes are the JAX run's at the
    same settings: NUTS's warmup hands float64 stats to storage, its
    posterior float32 ones, and the chunks join to float64; MCLMC hands
    float32 throughout."""
    kw = dict(num_chains=4, num_tune=10, num_draws=10, seed=0,
              posterior_kernel="pallas")
    make = (tnt.DiagNutsSettings if sampler == "nuts"
            else tnt.DiagMclmcSettings)
    jmake = (jnt.DiagNutsSettings if sampler == "nuts"
             else jnt.DiagMclmcSettings)
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        s = tnt.Sampler(normal_logp(3, 1.0), make(**kw), device="cpu",
                        dtype=np.float64)
        f32 = tnt.Sampler(normal_logp(3, 1.0), make(**kw), device="cpu")
        js = jnt.Sampler(jg.normal_logp(3, mu=1.0), jmake(**kw))
    assert [w for w in seen if issubclass(w.category, UserWarning)] == []
    assert s.settings.posterior_kernel == "pallas"
    plan = _fused_plan(s._phase_runners)
    assert plan == _fused_plan(f32._phase_runners)
    assert plan[-1] == (10, 20, "fused") and len(plan) > 1
    jcfg = js.settings.chain_config()
    assert plan == _fused_plan(js.settings.build_phases(
        js.model, js.strategy, jcfg))
    assert s.state.pt.q.dtype == torch.float64
    tr, jtr = s.run(), js.run()
    # the state stays float64 through the float32 launches
    floats = [x for x in state_leaves(s.state)
              if torch.is_tensor(x) and x.is_floating_point()]
    assert all(x.dtype == torch.float64 for x in floats)
    got, want = _trace_dtypes(tr), _trace_dtypes(jtr)
    assert got == want
    assert got["posterior"]["position"] == (
        np.float64 if sampler == "nuts" else np.float32)
    # the schema says what the trace holds
    sch = s.schema()
    free = tnt.schema(normal_logp(3, 1.0), make(**kw), dtype=np.float64)
    for group, names in got.items():
        assert {k: sch[group][k]["dtype"] for k in names} == names
        assert {k: free[group][k]["dtype"] for k in names} == names
    pos = tr.posterior["position"]
    assert pos.shape == (4, 10, 3) and np.isfinite(pos).all()
    # float32 keeps its plan and its dtypes, and other dtypes are refused
    assert f32.run().posterior["position"].dtype == np.float32
    with pytest.raises(ValueError, match="float32 or float64"):
        tnt.Sampler(normal_logp(3, 1.0), make(**kw), device="cpu",
                    dtype=torch.float16)
