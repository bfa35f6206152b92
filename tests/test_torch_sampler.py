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
from nuts_rs_tpu_torch import chain as tchain
from nuts_rs_tpu_torch.adapt.schedule import build_schedule
from nuts_rs_tpu_torch.dynamics.hamiltonian import KineticKind
from nuts_rs_tpu_torch.kernels import _build
from nuts_rs_tpu_torch.kernels import nuts_fused as nf
from nuts_rs_tpu_torch.models import gaussian as tg
from nuts_rs_tpu_torch.models import stochastic_volatility as tsv
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


def test_packaging_ships_the_kernel_sources():
    """An installed port builds its kernels from ``csrc/``, so the package
    data must name every source and header there."""
    import fnmatch
    import tomllib

    meta = tomllib.loads((REPO / "pyproject.toml").read_text())
    patterns = meta["tool"]["setuptools"]["package-data"]["nuts_rs_tpu_torch"]
    sources = sorted(p.name for p in _build.CSRC.iterdir())
    assert len(sources) >= 12
    for name in sources:
        assert any(fnmatch.fnmatch(f"csrc/{name}", pat) for pat in patterns), \
            name


def _no_hook(dim):
    return Model(logp_fn=lambda q: -0.5 * torch.sum(q * q), dim=dim)


@pytest.mark.parametrize("change,item", [
    (dict(posterior_kernel="async"), "item 16"),
    (dict(posterior_kernel="sync", async_posterior=True), "item 16"),
    (dict(mass_matrix="low_rank"), "item 14"),
    (dict(cross_chain_adaptation=True), "item 17"),
    ("cuda_maxdepth", "item 12"),
    ("cuda_ld_dim", "item 12"),
    ("cuda_ld_data_smem", "item 12"),
])
def test_unsupported_settings_raise(change, item):
    model = tg.normal_logp(3)
    device = "cpu"
    kw = dict(posterior_kernel="pallas", num_chains=4, num_tune=5,
              num_draws=5)
    if change == "cuda_ld_dim":
        # a chain's state must fit one block's shared memory
        model, device = tg.normal_logp(_build.ld_max_dim(10) + 1), "cuda"
    elif change == "cuda_maxdepth":
        # the kernels that take maxdepth at launch take at most 30
        kw.update(maxdepth=_build.LD_MAX_MAXDEPTH + 1)
        device = "cuda"
    elif change == "cuda_ld_data_smem":
        # SV at T = 2650 fits the JAX tier, but its chain state and the
        # functor's scratch do not fit one block's shared memory
        model, device = tsv.stochastic_volatility(T=2650), "cuda"
    else:
        kw.update(change)
    with pytest.raises(NotImplementedError, match=item):
        tnt.Sampler(model, tnt.DiagNutsSettings(**kw), device=device)


@pytest.mark.parametrize("case", ["sv_3500", "normal_3100"])
def test_no_fused_tier_demotes_to_the_sync_engine(case):
    """A model that no fused posterior tier of the JAX runners takes (SV at
    T = 3500 beyond the dim-on-lanes tier with its data, N(0, 1) at
    d = 3100 beyond it without data) runs the whole run on the sync engine
    with the JAX package's ``UserWarning``
    (``nuts_rs_tpu/sampler.py:240-251``), on either device; it used to
    raise naming item 12 (the ``data_beyond_ld`` case of
    ``test_unsupported_settings_raise``)."""
    model = (tsv.stochastic_volatility(T=3500) if case == "sv_3500"
             else tg.normal_logp(3100))
    settings = tnt.DiagNutsSettings(posterior_kernel="pallas", num_chains=4,
                                    num_tune=5, num_draws=5)
    config = settings.chain_config()
    assert tchain.fused_layout(model, config, False) is None
    assert tchain.fused_layout(model, config, True) is None
    assert settings.unsupported(model, "cuda") == []
    with pytest.warns(UserWarning, match="no fused-engine tier fits this "
                      "model"):
        sampler = tnt.Sampler(model, settings, device="cpu")
    (lo, hi, runner), = sampler._phase_runners
    assert (lo, hi) == (0, 10)
    assert runner.__qualname__.startswith("make_sync_runner")


@pytest.mark.parametrize("dim,warmup,fits", [
    (2688, True, True), (2689, True, False), (3072, False, True),
    (3073, False, False)])
def test_ld_tier_without_data_is_the_jax_runners(dim, warmup, fits):
    """The dim-on-lanes tier ends where the JAX runners' does for a model
    without data too (``nuts_rs_tpu/chain.py:773-790``, ``:1017-1030``): the
    warmup's above d = 2688 (the sync warmup, then the fused posterior), the
    posterior's above d = 3072 (the sync engine throughout)."""
    import nuts_rs_tpu.chain as jchain

    js = jnt.DiagNutsSettings(num_chains=8, num_tune=20, num_draws=10,
                              posterior_kernel="pallas")
    jcfg = js.chain_config()
    jm = jg.normal_logp(dim, 3.0)
    if warmup:
        jr = jchain.make_pallas_warmup_runner(
            jm, _strategy_for(js, jcfg), jcfg, base_seed=0,
            use_grad_based=True)
    else:
        jr = jchain.make_pallas_posterior_runner(
            jm, _strategy_for(js, jcfg), jcfg, phase_start=20, base_seed=0)
    assert (jr is not None) == fits
    config = tnt.DiagNutsSettings(posterior_kernel="pallas").chain_config()
    got = tchain.fused_layout(tg.normal_logp(dim, 3.0), config, warmup)
    assert got == ("ld" if fits else None)


@pytest.mark.parametrize("change,demoted", [
    (dict(posterior_kernel="sync"), False),
    (dict(kinetic_energy=KineticKind.MICROCANONICAL), True),
    (dict(mindepth=1), True),
    (dict(extra_doublings=1), True),
    (dict(check_turning=False, maxdepth=3), True),
    (dict(target_integration_time=1.0), True),
    (dict(step_size=tnt.StepSizeSettings(
        method=tnt.StepSizeMethod.ADAM)), False),
    (dict(step_size=tnt.StepSizeSettings(
        method=tnt.StepSizeMethod.FIXED, fixed_value=0.3)), False),
    (dict(adapt=tnt.AdaptScheduleOptions(window_by_good_draws=True)), False),
    ("no_hook_sync", False),
    ("cuda_dim", False),
    ("data_stream", False),
    (dict(kinetic_energy=KineticKind.EXACT_NORMAL), True),
    (dict(kinetic_energy=KineticKind.EXACT_NORMAL,
          posterior_kernel="sync"), False),
    (dict(store_gradient=True), True),
    ("no_hook", True),
])
def test_settings_that_used_to_raise_now_run(change, demoted):
    """What the sync engine (kernels/nuts.py), the streamed posterior kernel
    and the mid-d kernels at small sizes took over: each used to be a case
    of ``test_unsupported_settings_raise``.  The exact-normal kinetic
    energy and the extra stores run on the sync engine, a ``"pallas"``
    request demoted with the JAX package's warning; a model without a
    kernel hook is demoted with the port's own warning, decided in
    ``build_phases``."""
    model = tg.normal_logp(3)
    kw = dict(posterior_kernel="pallas", num_chains=4, num_tune=6,
              num_draws=4)
    if change == "cuda_dim":
        # d=5 has no thread-per-chain instance: the mid-d kernels serve it
        model = tg.normal_logp(5)
        settings = tnt.DiagNutsSettings(**kw)
        assert settings.unsupported(model, "cuda") == []
        assert nf.cl_kernel(model, 5, 10) == "mid"
        assert nf.cl_kernel(tg.normal_logp(3), 3, 8) == "mid"
        assert nf.cl_kernel(tg.normal_logp(3), 3, 10) == "thread"
        return
    if change == "data_stream":
        # the JAX benchmark's logreg_big rows (bench.py:365-370): the data
        # alone fail the resident rule, stream in the posterior, and leave
        # the warmup to the sync engine
        model = tg.logistic_regression_from_tensors(
            torch.zeros(32, 131072), torch.zeros(131072))
        settings = tnt.DiagNutsSettings(**kw)
        assert settings.unsupported(model, "cuda") == []
        config = settings.chain_config()
        assert tchain.fused_layout(model, config, False) == "stream"
        assert tchain.fused_layout(model, config, True) is None
        return
    if change == "no_hook_sync":
        model = _no_hook(3)
        kw.update(posterior_kernel="sync")
    elif change == "no_hook":
        model = _no_hook(3)
    else:
        kw.update(change)
    settings = tnt.DiagNutsSettings(**kw)
    assert settings.unsupported(model, "cpu") == []
    assert settings.unsupported(model, "cuda") == []
    if demoted:
        with pytest.warns(UserWarning, match="using the sync engine"):
            trace = tnt.sample(model, settings, device="cpu")
    else:
        trace = tnt.sample(model, settings, device="cpu")
    pos = trace.posterior["position"]
    assert pos.shape == (4, 4, 3) and np.isfinite(pos).all()
    assert trace.warmup_sample_stats["n_steps"].shape == (4, 6)


@pytest.mark.parametrize("kind", ["MICROCANONICAL", "EXACT_NORMAL"])
def test_nuts_kinetic_energies_name_the_sync_engine(kind):
    # the JAX package runs NUTS with these only on its sync engine (it
    # demotes a fused request there); the port's sync engine takes both
    settings = tnt.DiagNutsSettings(posterior_kernel="pallas", num_chains=4,
                                    num_tune=5, num_draws=5,
                                    kinetic_energy=KineticKind[kind])
    assert settings.unsupported(tg.normal_logp(3), "cpu") == []
    assert settings._pallas_disqualifiers() == [f"kinetic_energy={kind}"]
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


def test_device_is_required(monkeypatch):
    """The device defaults to the card: without one, a call that names no
    device raises a clear error and never falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    settings = tnt.DiagNutsSettings(posterior_kernel="pallas", num_chains=4,
                                    num_tune=3, num_draws=2)
    with pytest.raises(RuntimeError, match="no CUDA device.*device='cpu'"):
        tnt.sample(tg.normal_logp(3), settings)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tnt.Sampler(tg.normal_logp(3), settings)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tnt.Sampler(tg.normal_logp(3), settings, device="cuda")


# ---------------------------------------------------------------------------
# the large-d (dim-on-lanes) path
# ---------------------------------------------------------------------------


def _spy_layout(monkeypatch, target, name):
    """Record the ``layout`` a runner passes to ``target.name`` and stop
    the call there."""
    seen = []

    class _Stop(Exception):
        pass

    def spy(*args, **kw):
        seen.append(kw.get("layout", "cl"))
        raise _Stop

    monkeypatch.setattr(target, name, spy)
    return seen, _Stop


def _jax_layouts(monkeypatch, dim, model=None):
    """The layouts the JAX posterior and warmup runners pass to the Pallas
    launchers for ``normal_logp(dim)`` or ``model`` (nothing launches)."""
    import nuts_rs_tpu.chain as jchain
    import nuts_rs_tpu.kernels.nuts_pallas as jpallas

    kw = dict(num_chains=8, num_tune=20, num_draws=10,
              posterior_kernel="pallas")
    js = jnt.DiagNutsSettings(**kw)
    jcfg = js.chain_config()
    model = model or jg.normal_logp(dim, 3.0)
    state = jnt.Sampler(model, js, dtype=jnp.float32).state
    sched = build_schedule(20, 10, js.adapt)
    out = []
    for make, fn_name, lo, hi in (
            (lambda: jchain.make_pallas_warmup_runner(
                model, _strategy_for(js, jcfg), jcfg, base_seed=0,
                use_grad_based=True),
             "nuts_pallas_warmup_run", 0, 4),
            (lambda: jchain.make_pallas_posterior_runner(
                model, _strategy_for(js, jcfg), jcfg, phase_start=20,
                base_seed=0),
             "nuts_pallas_run", 20, 24)):
        # the factories bind the launcher's name when they are called
        seen, stop = _spy_layout(monkeypatch, jpallas, fn_name)
        runner = make()
        assert runner is not None
        flags = {k: jnp.asarray(v)
                 for k, v in _schedule_chunk(sched, lo, hi).items()}
        with pytest.raises(stop):
            runner(state, flags)
        out.append(seen[0])
    return out


def _torch_layouts(monkeypatch, dim, model=None):
    ts = tnt.DiagNutsSettings(num_chains=8, num_tune=20, num_draws=10,
                              posterior_kernel="pallas")
    sampler = tnt.Sampler(model or tg.normal_logp(dim, 3.0), ts,
                          device="cpu")
    out = []
    for fn_name, lo, hi in (("nuts_fused_warmup_run", 0, 4),
                            ("nuts_fused_run", 20, 24)):
        seen, stop = _spy_layout(monkeypatch, nf, fn_name)
        runner = next(r for s, e, r in sampler._phase_runners if s <= lo < e)
        with pytest.raises(stop):
            runner(sampler.state, _schedule_chunk(sampler.schedule, lo, hi))
        out.append(seen[0])
    return out


@pytest.mark.parametrize("warmup,offset,layouts", [
    (True, 0, ["cl", "cl"]), (True, 1, ["ld", "cl"]),
    (False, 0, ["ld", "cl"]), (False, 1, ["ld", "ld"])])
def test_layout_boundary_is_the_jax_runners(monkeypatch, warmup, offset,
                                            layouts):
    """Both packages' warmup and posterior runners change from the
    chains-on-lanes to the dim-on-lanes kernels at the same dimensions: the
    warmup one above ``cl_max_dim(10, warmup=True)``, the posterior one
    above ``cl_max_dim(10)``."""
    dim = cl_max_dim(10, warmup) + offset
    assert _torch_layouts(monkeypatch, dim) == layouts
    assert _jax_layouts(monkeypatch, dim) == layouts


@pytest.mark.parametrize("case,layouts", [
    ("sv_1000", ["ld", "ld"]), ("glm_above_cl", ["ld", "ld"]),
    ("funnel_300", ["ld", "ld"]), ("glm_6mb", ["ld", "cl"])])
def test_data_above_the_cl_limit_take_ld_as_the_jax_runners(monkeypatch,
                                                            case, layouts):
    """A model with data above the chains-on-lanes limit (by its d, or by
    its data's bytes in the warmup launch: 6 MB of data fit the posterior
    launch but not the warmup's) takes the dim-on-lanes layout, with its
    data, as the JAX runners take it on ``pallas_spec``
    (``nuts_rs_tpu/chain.py:788-801,1031-1044``).  It used to raise.  The
    funnel, without data, takes the JAX runners' ld layout on its closure;
    both take the kernels with the eval_block form (K1-ld-args, K2-ld-args)
    on the card."""
    from nuts_rs_tpu.models import stochastic_volatility as jsv

    if case == "sv_1000":
        jm, tm = jsv.stochastic_volatility(T=1000), \
            tsv.stochastic_volatility(T=1000)
    elif case == "glm_above_cl":
        jm = jg.logistic_regression(16, cl_max_dim(10) + 1, 0)
        tm = tg.logistic_regression(16, cl_max_dim(10) + 1, 0)
    elif case == "funnel_300":
        jm, tm = jg.funnel(300), tg.funnel(300)
    else:
        jm = jg.logistic_regression(15000, 100, 0)
        tm = tg.logistic_regression(15000, 100, 0)
    config = tnt.DiagNutsSettings(posterior_kernel="pallas").chain_config()
    got = [tchain.fused_layout(tm, config, w) for w in (True, False)]
    assert got == layouts
    settings = tnt.DiagNutsSettings(posterior_kernel="pallas")
    assert settings.unsupported(tm, "cuda") == []
    assert nf._kernel_kind(tm, tm.dim, "ld") == "ld_args"
    assert _jax_layouts(monkeypatch, 0, jm) == layouts
    assert _torch_layouts(monkeypatch, 0, tm) == layouts


def test_ld_slice_on_the_cpu():
    """A model above the chains-on-lanes limit runs end to end on the
    dim-on-lanes plain versions: finite draws, no divergences, the trace of
    the JAX schema."""
    dim = cl_max_dim(10) + 8
    model = tg.normal_logp(dim, 3.0)
    settings = tnt.DiagNutsSettings(num_chains=8, num_tune=40, num_draws=20,
                                    seed=0, posterior_kernel="pallas")
    assert settings.unsupported(model, "cpu") == []
    assert settings.unsupported(model, "cuda") == []
    before = dict(nf.LAUNCHES)
    trace = tnt.sample(model, settings, device="cpu")
    assert nf.LAUNCHES == before
    pos = trace.posterior["position"]
    assert pos.shape == (8, 20, dim) and pos.dtype == np.float32
    assert trace.warmup_posterior["position"].shape == (8, 40, dim)
    assert np.isfinite(pos).all()
    assert not trace.sample_stats["diverging"].any()
    assert abs(pos.astype(np.float64).mean() - 3.0) < 0.1
    # the emitted logp is the model's at the emitted position
    lp = -0.5 * ((pos.astype(np.float64) - 3.0) ** 2).sum(-1)
    np.testing.assert_allclose(trace.sample_stats["logp"], lp, rtol=1e-4)
    want = jnt.schema(jg.normal_logp(dim, 3.0), jnt.DiagNutsSettings(
        num_chains=8, num_tune=40, num_draws=20, posterior_kernel="pallas"),
        dtype=jnp.float32)
    for group in ("posterior", "sample_stats", "warmup_posterior",
                  "warmup_sample_stats"):
        arrays = getattr(trace, group)
        assert set(arrays) == set(want[group]), group
        for name, entry in want[group].items():
            assert arrays[name].dtype == entry["dtype"], name
            assert arrays[name].shape[2:] == entry["shape"], name


def test_mclmc_refuses_large_d_naming_the_sync_engine():
    """The JAX package's MCLMC kernels are chains-on-lanes only, up to the
    MCLMC runners' own limit (no checkpoint stacks in it), not the NUTS
    layouts': one dimension above cl_max_dim is still served.  One
    dimension above the warmup's limit used to be refused naming the sync
    engine (item 8); now its warmup runs on the sync MCLMC engine, without
    a warning, as in the JAX package."""
    import warnings

    from nuts_rs_tpu_torch.chain import mclmc_max_dim

    settings = tnt.DiagMclmcSettings(posterior_kernel="pallas", num_chains=4,
                                     num_tune=5, num_draws=5)
    assert settings.unsupported(tg.normal_logp(cl_max_dim(10) + 1),
                                "cuda") == []
    model = tg.normal_logp(mclmc_max_dim(warmup=True) + 1)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        phases = settings.build_phases(model, settings.chain_config(), "cpu")
    assert [(lo, hi, r.__qualname__.split(".")[0]) for lo, hi, r in
            phases] == [(0, 1, "make_sync_mclmc_runner"),
                        (1, 5, "make_sync_mclmc_runner"),
                        (5, 10, "make_fused_mclmc_posterior_runner")]


def test_trace_parts_are_joined_per_phase():
    """Chunks that end at the phase boundary go into the trace as they are;
    a chunk across it is split."""
    from nuts_rs_tpu_torch.storage.memory import MemoryStorage

    rng = np.random.default_rng(0)
    store = MemoryStorage()
    chunks = [rng.normal(size=(2, k, 3)).astype(np.float32) for k in (3, 4)]
    tuning = [np.array([True, True, True]),
              np.array([True, False, False, False])]
    for lo, (pos, t) in enumerate(zip(chunks, tuning)):
        store.record_chunk(lo, {"position": pos,
                                "n_steps": pos[..., 0].astype(np.int32)},
                           {}, t)
    trace = store.finalize()
    whole = np.concatenate(chunks, axis=1)
    np.testing.assert_array_equal(trace.warmup_posterior["position"],
                                  whole[:, :4])
    np.testing.assert_array_equal(trace.posterior["position"], whole[:, 4:])
    assert trace.sample_stats["n_steps"].shape == (2, 3)
    assert trace.warmup_sample_stats["n_steps"].dtype == np.int32
