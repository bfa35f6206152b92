"""``FlowNutsSettings`` through ``Sampler`` on the CPU.

The flow warmup runs on the per-draw sync engine with its refits; with
``posterior_kernel="pallas"`` the coupling flow's posterior runs on kernel
K1-flow's plain version (CPU tensors), a flow without kernel hooks or an
unpooled one stays on the sync engine with the JAX package's
``UserWarning``, and a model without a device functor is demoted there
with a warning of the port's own, as in the port's other fused paths.  The moment checks
are those of the JAX package's own flow tests (tests/test_flow.py:91-193),
at their sizes or smaller; the phase plans are the JAX package's.
"""

import warnings

import numpy as np
import pytest
import torch

import nuts_rs_tpu as jnt
import nuts_rs_tpu_torch as tnt
from nuts_rs_tpu.flows import coupling as jc
from nuts_rs_tpu.models import gaussian as jg
from nuts_rs_tpu_torch.kernels import nuts_fused as nf
from nuts_rs_tpu_torch.models import gaussian as tg


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _small_flow():
    return tnt.coupling_flow(tnt.CouplingFlowConfig(num_layers=2, hidden=16,
                                                    train_steps=100))


def test_flow_settings_defaults_are_the_jax_ones():
    for name in ("FlowNutsSettings", "FlowMclmcSettings"):
        got, want = getattr(tnt, name)(), getattr(jnt, name)()
        for field in ("num_tune", "num_chains", "max_energy_error",
                      "mass_matrix"):
            assert getattr(got, field) == getattr(want, field), (name, field)
    got, want = tnt.FlowAdaptSettings(), jnt.FlowNutsSettings().flow
    for field in ("step_size_window", "transform_update_freq",
                  "transform_train_max_energy_error",
                  "use_orbit_for_training", "window_capacity",
                  "pool_chains"):
        assert getattr(got, field) == getattr(want, field), field
    assert tnt.CouplingFlowConfig().__dict__ == \
        jc.CouplingFlowConfig().__dict__


def test_diag_affine_flow_samples_a_shifted_normal():
    """tests/test_flow.py::test_diag_affine_flow_sampling on the port's sync
    engine; a ``"pallas"`` request takes the same path, announced."""
    model = tg.normal_logp(5, 3.0)
    base = dict(num_tune=200, num_draws=300, num_chains=2, seed=0,
                flow_spec=tnt.diag_affine_flow())
    trace = tnt.sample(model, tnt.FlowNutsSettings(**base), chunk_size=100,
                       device="cpu")
    draws = trace.posterior["position"]
    assert abs(draws.mean() - 3.0) < 0.15
    assert abs(draws.std() - 1.0) < 0.2
    assert not trace.sample_stats["diverging"].any()
    assert trace.warmup_sample_stats["transformation_index"].max() > 0
    with pytest.warns(UserWarning, match="no fused-engine tier fits"):
        smp = tnt.Sampler(model, tnt.FlowNutsSettings(
            posterior_kernel="pallas", **base), device="cpu")
    assert [(a, b) for a, b, _ in smp._phase_runners] == [(0, 500)]


def test_coupling_flow_sync_run_on_the_funnel():
    """tests/test_flow.py::test_coupling_flow_sampling_funnel: runs, stays
    finite, refits happen."""
    trace = tnt.sample(tg.funnel(4), tnt.FlowNutsSettings(
        num_tune=300, num_draws=200, num_chains=1, seed=1,
        flow_spec=_small_flow()), chunk_size=150, device="cpu")
    draws = trace.posterior["position"]
    assert np.isfinite(draws).all()
    assert abs(draws[..., 0].mean()) < 1.5
    assert trace.warmup_sample_stats["transformation_index"].max() > 0


def test_coupling_flow_posterior_on_the_plain_flow_kernel(monkeypatch):
    """tests/test_flow.py::test_coupling_flow_pallas_posterior: the K1-flow
    posterior (its plain version on the CPU, chain 0's pooled parameters
    packed) against the sync engine on the funnel; every posterior launch
    carries the flow, and CPU tensors launch no kernel."""
    flows = []
    run = nf.nuts_fused_run

    def spy(*a, **kw):
        flows.append(kw.get("flow"))
        return run(*a, **kw)

    monkeypatch.setattr(nf, "nuts_fused_run", spy)
    before = dict(nf.LAUNCHES)
    base = dict(num_tune=150, num_draws=150, num_chains=4, seed=2,
                flow_spec=_small_flow())
    traces = {}
    for kernel in ("pallas", "sync"):
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            traces[kernel] = tnt.sample(tg.funnel(4), tnt.FlowNutsSettings(
                posterior_kernel=kernel, **base), chunk_size=100,
                device="cpu")
    assert nf.LAUNCHES == before
    assert len(flows) == 2 and all(f is not None for f in flows)
    assert flows[0].num_layers == 2 and flows[0].hidden == 16
    for name, tr in traces.items():
        d = tr.posterior["position"]
        assert np.isfinite(d).all(), name
        assert abs(d[..., 0].mean()) < 1.5, name
        assert np.isfinite(tr.sample_stats["energy"]).all(), name
        assert tr.sample_stats["diverging"].mean() < 0.25, name
        assert tr.warmup_sample_stats["transformation_index"].max() > 0
    sp = traces["pallas"].posterior["position"][..., 0].std()
    ss = traces["sync"].posterior["position"][..., 0].std()
    assert abs(sp - ss) < 0.8, (sp, ss)


def test_coupling_flow_posterior_on_a_normal():
    """The iid normal through K1-flow's plain version: the flow learns the
    shift and the scale."""
    trace = tnt.sample(tg.normal_logp(4, 3.0), tnt.FlowNutsSettings(
        num_tune=150, num_draws=150, num_chains=4, seed=3,
        posterior_kernel="pallas", flow_spec=_small_flow()),
        chunk_size=150, device="cpu")
    draws = trace.posterior["position"]
    assert abs(draws.mean() - 3.0) < 0.2
    assert abs(draws.std() - 1.0) < 0.2
    assert trace.sample_stats["diverging"].mean() < 0.02


def test_eight_schools_on_the_sync_engine():
    """eight_schools has no device functor: the flow runs on the sync engine
    throughout; its fused request is demoted there with a warning (it used
    to be refused naming item 9)."""
    trace = tnt.sample(tg.eight_schools(), tnt.FlowNutsSettings(
        num_tune=150, num_draws=150, num_chains=2, seed=0,
        posterior_kernel="sync", flow_spec=_small_flow()), chunk_size=150,
        device="cpu")
    mu = trace.posterior["position"][..., 0]
    assert np.isfinite(trace.posterior["position"]).all()
    assert abs(mu.mean() - 4.4) < 2.5
    assert trace.warmup_sample_stats["transformation_index"].max() > 0
    settings = tnt.FlowNutsSettings(num_chains=2, num_tune=10, num_draws=5,
                                    posterior_kernel="pallas",
                                    flow_spec=_small_flow())
    assert settings.unsupported(tg.eight_schools(), "cuda") == []
    with pytest.warns(UserWarning, match="no kernel_hook"):
        smp = tnt.Sampler(tg.eight_schools(), settings, device="cpu")
    assert [(a, b) for a, b, _ in smp._phase_runners] == [(0, 15)]


def test_unpooled_flow_stays_on_the_sync_engine():
    settings = tnt.FlowNutsSettings(
        num_tune=20, num_draws=10, num_chains=2, posterior_kernel="pallas",
        flow=tnt.FlowAdaptSettings(pool_chains=False),
        flow_spec=_small_flow())
    with pytest.warns(UserWarning, match="no fused-engine tier fits"):
        smp = tnt.Sampler(tg.funnel(4), settings, device="cpu")
    trace = smp.run()
    assert np.isfinite(trace.posterior["position"]).all()
    assert [(a, b) for a, b, _ in smp._phase_runners] == [(0, 30)]


@pytest.mark.parametrize("kernel,spec", [("pallas", "coupling"),
                                         ("sync", "coupling"),
                                         ("pallas", "diag")])
def test_flow_phase_plans_match_jax(kernel, spec):
    """The phase boundaries of a flow run are the JAX package's: the sync
    warmup and the fused posterior, or the sync engine throughout."""
    make = {"coupling": (tnt.coupling_flow, jc.coupling_flow),
            "diag": (tnt.diag_affine_flow, jc.diag_affine_flow)}[spec]
    kw = dict(num_tune=40, num_draws=30, num_chains=4,
              posterior_kernel=kernel)
    tset = tnt.FlowNutsSettings(flow_spec=make[0](), **kw)
    jset = jnt.FlowNutsSettings(flow_spec=make[1](), **kw)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        got = tset.build_phases(tg.funnel(4), tset.chain_config(), "cpu")
        from nuts_rs_tpu.sampler import _strategy_for

        jconfig = jset.chain_config()
        want = jset.build_phases(jg.funnel(4), _strategy_for(jset, jconfig),
                                 jconfig)
    assert [(a, b) for a, b, _ in got] == [(a, b) for a, b, _ in want]


def test_flow_mclmc_is_refused_naming_items_8_and_15():
    # item 8, the sync MCLMC engine, is in: the refusal names item 15
    with pytest.raises(NotImplementedError, match="item 15"):
        tnt.Sampler(tg.normal_logp(3), tnt.FlowMclmcSettings(
            posterior_kernel="pallas"), device="cpu")
