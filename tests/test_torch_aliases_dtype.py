"""The port's reference-name aliases and its ``dtype`` option, on the CPU.

The six aliases of ``nuts_rs_tpu/__init__.py:48-62`` (and
``DivergenceInfo``) name the same things in both packages and sit in
``__all__``; ``EuclideanAdaptOptions`` documents the nested fields it does
not take.  ``Sampler(dtype=torch.float64)`` runs the sync engine in
float64 (state, stats, schema), held in distribution against the JAX
package's float64 run (the tests' JAX is float64); a float64
``posterior_kernel="pallas"`` request is planned on the sync engine with
the JAX package's demotion warning, never on the float32 kernels."""

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
    # the mesh, low-rank and their presets are ROADMAP.md items 14 and 17
    left_out = {"make_mesh", "LowRankSettings", "LowRankNutsSettings",
                "LowRankMclmcSettings"}
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


def test_a_float64_fused_request_is_planned_on_the_sync_engine():
    settings = tnt.DiagNutsSettings(num_chains=4, num_tune=10, num_draws=10,
                                    seed=0, posterior_kernel="pallas")
    with pytest.warns(UserWarning, match="dtype=torch.float64.*sync engine"):
        s = tnt.Sampler(normal_logp(3, 1.0), settings, device="cpu",
                        dtype=np.float64)
    assert s.settings.posterior_kernel == "sync"
    assert [(lo, hi) for lo, hi, _ in s._phase_runners] == [(0, 20)]
    assert s.state.pt.q.dtype == torch.float64
    assert s.run().posterior["position"].dtype == np.float64
    # float32 keeps the fused plan, and other dtypes are refused
    f32 = tnt.Sampler(normal_logp(3, 1.0), settings, device="cpu")
    assert len(f32._phase_runners) > 1
    with pytest.raises(ValueError, match="float32 or float64"):
        tnt.Sampler(normal_logp(3, 1.0), settings, device="cpu",
                    dtype=torch.float16)
    mclmc = tnt.DiagMclmcSettings(num_chains=4, num_tune=10, num_draws=10,
                                  posterior_kernel="pallas")
    with pytest.warns(UserWarning, match="sync engine"):
        m = tnt.Sampler(normal_logp(3, 1.0), mclmc, device="cpu",
                        dtype=torch.float64)
    assert m.run().posterior["position"].dtype == np.float64
