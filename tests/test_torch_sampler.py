"""The port's main path end to end on the CPU (the kernels' plain PyTorch
versions), its trace schema and phase plan against the JAX package, the
settings it refuses, and its independence from JAX."""

import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nuts_rs_tpu as jnt
import nuts_rs_tpu_torch as tnt
from nuts_rs_tpu.models import gaussian as jg
from nuts_rs_tpu.sampler import _strategy_for
from nuts_rs_tpu_torch.adapt.schedule import build_schedule
from nuts_rs_tpu_torch.dynamics.hamiltonian import KineticKind
from nuts_rs_tpu_torch.kernels import nuts_fused as nf
from nuts_rs_tpu_torch.models import gaussian as tg
from nuts_rs_tpu_torch.models.model import Model
from nuts_rs_tpu_torch.sampler import _schedule_chunk, cl_max_dim

REPO = Path(__file__).resolve().parents[1]
SLICE = dict(num_chains=8, num_tune=150, num_draws=250, seed=0)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def test_cpu_slice_posterior_and_adapted_step():
    before = dict(nf.LAUNCHES)
    trace = tnt.sample(tg.normal_logp(4, 3.0),
                       tnt.DiagNutsSettings(posterior_kernel="pallas", **SLICE),
                       device="cpu")
    assert nf.LAUNCHES == before  # CPU tensors: the plain versions ran
    pos = trace.posterior["position"].astype(np.float64)
    assert pos.shape == (8, 250, 4)
    assert trace.warmup_posterior["position"].shape == (8, 150, 4)
    assert abs(pos.mean() - 3.0) < 0.1
    assert abs(pos.std() - 1.0) < 0.1
    st = trace.sample_stats
    assert not st["diverging"].any()
    assert 0.7 < st["mean_tree_accept"].mean() < 0.95
    assert not st["tuning"].any() and trace.warmup_sample_stats["tuning"].all()
    step = np.median(st["step_size_bar"][:, -1])

    jax_trace = jnt.sample(jg.normal_logp(4, 3.0),
                           jnt.DiagNutsSettings(posterior_kernel="sync",
                                                **SLICE))
    jax_step = np.median(np.asarray(jax_trace.sample_stats["step_size_bar"])
                         [:, -1])
    assert abs(np.log(step / jax_step)) < 0.3, (step, jax_step)


def test_schema_matches_the_jax_package():
    settings = dict(posterior_kernel="pallas", **SLICE)
    model_t = tg.normal_logp(4, 3.0)
    want = jnt.schema(jg.normal_logp(4, 3.0), jnt.DiagNutsSettings(**settings),
                      dtype=jnp.float32)
    got = tnt.schema(model_t, tnt.DiagNutsSettings(**settings))
    assert set(got) == set(want)
    for group in ("posterior", "sample_stats", "warmup_posterior",
                  "warmup_sample_stats", "events"):
        assert got[group] == want[group], group
    assert got["coords"] == dict(want["coords"])
    # the trace holds exactly the reflected names, dims and dtypes
    sampler = tnt.Sampler(model_t, tnt.DiagNutsSettings(
        posterior_kernel="pallas", num_chains=4, num_tune=3, num_draws=2),
        device="cpu")
    trace = sampler.run()
    assert sampler.schema() == got
    for group in ("posterior", "sample_stats", "warmup_posterior",
                  "warmup_sample_stats"):
        arrays = getattr(trace, group)
        assert set(arrays) == set(got[group]), group
        for name, entry in got[group].items():
            assert arrays[name].dtype == entry["dtype"], name
            assert arrays[name].shape[2:] == entry["shape"], name


def test_phases_split_where_the_jax_package_splits():
    for tune, draws in ((300, 700), (150, 250), (40, 0)):
        kw = dict(num_chains=4, num_tune=tune, num_draws=draws,
                  posterior_kernel="pallas")
        js = jnt.DiagNutsSettings(**kw)
        jcfg = js.chain_config()
        want = [(a, b) for a, b, _ in js.build_phases(
            jg.normal_logp(3), _strategy_for(js, jcfg), jcfg)]
        ts = tnt.DiagNutsSettings(**kw)
        got = [(a, b) for a, b, _ in ts.build_phases(tg.normal_logp(3),
                                                     ts.chain_config())]
        assert got == want


def test_state_round_trips_through_numpy():
    settings = jnt.DiagNutsSettings(num_chains=4, num_tune=10, num_draws=5)
    jstate = jnt.Sampler(jg.normal_logp(3), settings).state
    arrays = tnt.state_to_numpy(jstate)
    state = tnt.state_from_numpy(arrays, dtype=torch.float64)
    again = tnt.state_to_numpy(state)
    assert set(again) == set(arrays)
    for name, value in arrays.items():
        np.testing.assert_array_equal(again[name], value, err_msg=name)
    # the port's runners start from it: one warmup chunk
    model = tg.normal_logp(3)
    ts = tnt.DiagNutsSettings(num_chains=4, num_tune=10, num_draws=5,
                              posterior_kernel="pallas")
    cfg = ts.chain_config()
    state32 = tnt.state_from_numpy(arrays)
    start, end, runner = ts.build_phases(model, cfg)[1]
    sched = build_schedule(10, 5, ts.adapt)
    new, stats = runner(state32._replace(draw_idx=start),
                        _schedule_chunk(sched, start, end))
    assert new.draw_idx == end
    assert stats["position"].shape == (end - start, 4, 3)
    assert torch.isfinite(new.pt.logp).all()


def test_import_leaves_jax_out():
    code = ("import sys, nuts_rs_tpu_torch, nuts_rs_tpu_torch.chain, "
            "nuts_rs_tpu_torch.convert, nuts_rs_tpu_torch.kernels._build; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'nuts_rs_tpu.'))]; "
            "assert not bad, bad; print('ok')")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_chip_smoke_refuses_without_a_card(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO), CUDA_VISIBLE_DEVICES="")
    for cwd, script in ((REPO, REPO / "chip_smoke.py"),
                        (tmp_path, tmp_path / "chip_smoke.py")):
        if cwd == tmp_path:
            script.write_text((REPO / "chip_smoke.py").read_text())
            env = dict(env, PYTHONPATH="")
        out = subprocess.run([sys.executable, str(script)], env=env, cwd=cwd,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout


def _no_hook(dim):
    return Model(logp_fn=lambda q: -0.5 * torch.sum(q * q), dim=dim)


@pytest.mark.parametrize("change,item", [
    (dict(posterior_kernel="sync"), "item 3"),
    (dict(posterior_kernel="async"), "item 16"),
    (dict(posterior_kernel="sync", async_posterior=True), "item 16"),
    (dict(mass_matrix="low_rank"), "item 14"),
    (dict(mass_matrix="flow"), "item 15"),
    (dict(kinetic_energy=KineticKind.MICROCANONICAL), "item 3"),
    (dict(mindepth=1), "item 3"),
    (dict(extra_doublings=1), "item 3"),
    (dict(check_turning=False), "item 3"),
    (dict(store_gradient=True), "item 9"),
    (dict(cross_chain_adaptation=True), "item 17"),
    (dict(step_size=tnt.StepSizeSettings(
        method=tnt.StepSizeMethod.ADAM)), "item 4"),
    (dict(adapt=tnt.AdaptScheduleOptions(window_by_good_draws=True)),
     "item 4"),
    ("no_hook", "item 10"),
    ("large_d", "item 11"),
    ("cuda_dim", "item 11"),
    ("cuda_maxdepth", "item 11"),
])
def test_unsupported_settings_raise(change, item):
    model = tg.normal_logp(3)
    device = "cpu"
    kw = dict(posterior_kernel="pallas", num_chains=4, num_tune=5,
              num_draws=5)
    if change == "no_hook":
        model = _no_hook(3)
    elif change == "large_d":
        model = tg.normal_logp(cl_max_dim(10) + 1)
    elif change == "cuda_dim":
        # no kernel instantiation for d=5: refused before anything launches
        model, device = tg.normal_logp(5), "cuda"
    elif change == "cuda_maxdepth":
        kw.update(maxdepth=8)
        device = "cuda"
    else:
        kw.update(change)
    with pytest.raises(NotImplementedError, match=item):
        tnt.Sampler(model, tnt.DiagNutsSettings(**kw), device=device)


@pytest.mark.parametrize("kind", ["MICROCANONICAL", "EXACT_NORMAL"])
def test_nuts_kinetic_energies_name_the_sync_engine(kind):
    # the JAX package runs NUTS with these only on its sync engine (it
    # demotes a fused request there), so the port points at that item
    settings = tnt.DiagNutsSettings(posterior_kernel="pallas", num_chains=4,
                                    num_tune=5, num_draws=5,
                                    kinetic_energy=KineticKind[kind])
    reasons = settings.unsupported(tg.normal_logp(3), "cpu")
    assert reasons == [f"kinetic_energy={kind} (item 3, the sync engine)"]
    jsettings = jnt.DiagNutsSettings(
        posterior_kernel="pallas",
        kinetic_energy=jnt.KineticKind[kind])
    assert not jsettings._pallas_ok()


def test_sizes_without_a_kernel_run_on_the_cpu():
    # the plain versions take any (d, maxdepth); only CUDA needs an instance
    model = tg.normal_logp(5)
    settings = tnt.DiagNutsSettings(posterior_kernel="pallas", maxdepth=8,
                                    num_chains=4, num_tune=3, num_draws=2)
    assert settings.unsupported(model, "cpu") == []
    assert tnt.sample(model, settings, device="cpu").posterior[
        "position"].shape == (4, 2, 5)


def test_device_is_required():
    settings = tnt.DiagNutsSettings(posterior_kernel="pallas", num_chains=4,
                                    num_tune=3, num_draws=2)
    with pytest.raises(TypeError, match="device"):
        tnt.sample(tg.normal_logp(3), settings)
    with pytest.raises(TypeError, match="device"):
        tnt.Sampler(tg.normal_logp(3), settings)
