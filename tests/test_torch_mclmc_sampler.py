"""The port's MCLMC path end to end on the CPU (the fused kernels' plain
PyTorch versions) against the JAX package: the phase plan, the warmup's
transformation schedule, the trace schema, the posterior moments, the
state carried between packages, reproducibility, the settings it
refuses, and the plans of the requests it used to refuse (the sync MCLMC
engine's, tests/test_torch_mclmc_sync.py)."""

import functools
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nuts_rs_tpu as jnt
import nuts_rs_tpu_torch as tnt
from nuts_rs_tpu.kernels.mclmc import MclmcOptions as JaxMclmcOptions
from nuts_rs_tpu.kernels.mclmc_pallas import mclmc_pallas_warmup_run
from nuts_rs_tpu.models import gaussian as jg
from nuts_rs_tpu.sampler import _strategy_for
from nuts_rs_tpu_torch.adapt.schedule import build_schedule
from nuts_rs_tpu_torch.chain import (
    MCLMC_FLAG_COLUMNS,
    PURPOSE_MCLMC_WARMUP,
    warmup_flags,
)
from nuts_rs_tpu_torch.kernels import mclmc_fused as mf
from nuts_rs_tpu_torch.kernels.rng import derive_seed
from nuts_rs_tpu_torch.models import gaussian as tg
from nuts_rs_tpu_torch.models.model import Model
from nuts_rs_tpu_torch.sampler import _schedule_chunk

SLICE = dict(num_chains=8, num_tune=150, num_draws=250, seed=0)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def traces():
    """One run of each package at the slice's size: the port's fused path
    on the CPU and the JAX package's XLA path."""
    before = dict(mf.LAUNCHES)
    port = tnt.sample(tg.normal_logp(4, 3.0),
                      tnt.DiagMclmcSettings(posterior_kernel="pallas", **SLICE),
                      device="cpu")
    assert mf.LAUNCHES == before  # CPU tensors: the plain versions ran
    ref = jnt.sample(jg.normal_logp(4, 3.0),
                     jnt.DiagMclmcSettings(posterior_kernel="sync", **SLICE))
    return port, ref


def test_posterior_moments_match_the_jax_package(traces):
    port, ref = traces
    pos = port.posterior["position"].astype(np.float64)
    assert pos.shape == (8, 250, 4)
    assert port.warmup_posterior["position"].shape == (8, 150, 4)
    assert not port.sample_stats["diverging"].any()
    assert not port.sample_stats["tuning"].any()
    assert port.warmup_sample_stats["tuning"].all()
    ref_pos = np.asarray(ref.posterior["position"], np.float64)
    # 8 x 250 draws a coordinate, 8000 in all: Monte-Carlo error of the
    # mean ~0.02 with MCLMC's autocorrelation, of the std ~0.015
    assert abs(pos.mean() - ref_pos.mean()) < 0.1
    assert abs(pos.std() - ref_pos.std()) < 0.08
    # the same step-size law: jittered 0.5, round(3 / eps) leapfrogs
    n_port = port.sample_stats["n_steps"].mean()
    n_ref = np.asarray(ref.sample_stats["n_steps"]).mean()
    assert abs(n_port - n_ref) < 0.3
    np.testing.assert_array_equal(port.sample_stats["log_weight"],
                                  port.sample_stats["energy_change"])


def test_warmup_transformation_index_matches_the_jax_package(traces):
    # RNG-independent without divergences: the window schedule and the
    # "at least 3 good draws" rule alone set it
    port, ref = traces
    np.testing.assert_array_equal(
        port.warmup_sample_stats["transformation_index"],
        np.asarray(ref.warmup_sample_stats["transformation_index"]))
    assert port.warmup_sample_stats["transformation_index"].max() > 10


@pytest.mark.parametrize("tune,draws,kind", [
    (300, 700, "EUCLIDEAN_EARLY_THEN_MICROCANONICAL"),
    (120, 250, "EUCLIDEAN_EARLY_THEN_MICROCANONICAL"),
    (40, 0, "EUCLIDEAN_EARLY_THEN_MICROCANONICAL"),
    (0, 20, "EUCLIDEAN_EARLY_THEN_MICROCANONICAL"),
    (50, 30, "MICROCANONICAL"),
    (50, 30, "EUCLIDEAN"),
])
def test_phases_split_where_the_jax_package_splits(tune, draws, kind):
    kw = dict(num_chains=4, num_tune=tune, num_draws=draws,
              posterior_kernel="pallas")
    js = jnt.DiagMclmcSettings(
        trajectory_kind=jnt.MclmcTrajectoryKind[kind], **kw)
    jcfg = js.chain_config()
    want = [(a, b) for a, b, _ in js.build_phases(
        jg.normal_logp(3), _strategy_for(js, jcfg), jcfg)]
    ts = tnt.DiagMclmcSettings(
        trajectory_kind=tnt.MclmcTrajectoryKind[kind], **kw)
    got = [(a, b) for a, b, _ in ts.build_phases(tg.normal_logp(3),
                                                 ts.chain_config())]
    assert got == want
    for lo, hi in ((0, tune), (max(tune - 3, 0), tune + 2)):
        sched = build_schedule(tune, draws, ts.adapt)
        flags = _schedule_chunk(sched, lo, hi)
        np.testing.assert_array_equal(
            ts.extra_flags(flags, lo, hi)["resample_velocity"],
            np.asarray(js.extra_flags(flags, lo, hi)["resample_velocity"]))


def test_schema_matches_the_jax_package():
    settings = dict(posterior_kernel="pallas", **SLICE)
    model_t = tg.normal_logp(4, 3.0)
    want = jnt.schema(jg.normal_logp(4, 3.0),
                      jnt.DiagMclmcSettings(**settings), dtype=jnp.float32)
    got = tnt.schema(model_t, tnt.DiagMclmcSettings(**settings))
    assert set(got) == set(want)
    for group in ("posterior", "sample_stats", "warmup_posterior",
                  "warmup_sample_stats", "events"):
        assert got[group] == want[group], group
    # the trace holds exactly the reflected names, dims and dtypes
    sampler = tnt.Sampler(model_t, tnt.DiagMclmcSettings(
        posterior_kernel="pallas", num_chains=4, num_tune=4, num_draws=3),
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


def test_runs_reproduce_per_seed_and_chunking():
    model = tg.normal_logp(3, 0.0)

    def run(seed=5, chunk=16):
        s = tnt.DiagMclmcSettings(num_chains=4, num_tune=30, num_draws=20,
                                  seed=seed, posterior_kernel="pallas")
        return tnt.Sampler(model, s, chunk_size=chunk, device="cpu").run()

    t1, t2 = run(), run()
    for group in ("warmup_posterior", "posterior"):
        np.testing.assert_array_equal(getattr(t1, group)["position"],
                                      getattr(t2, group)["position"])
    t3 = run(seed=6)
    assert not np.array_equal(t3.posterior["position"],
                              t1.posterior["position"])


def test_jax_state_carries_into_the_port_runner():
    """A JAX MCLMC chain state, through numpy, starts the port's warmup
    runner, which computes what the JAX kernel computes from that state:
    the velocity is carried (no resample in these rows) and the estimators
    and transform go on from where the JAX state left them."""
    jsettings = jnt.DiagMclmcSettings(num_chains=4, num_tune=10,
                                      num_draws=5, posterior_kernel="pallas")
    arrays = tnt.state_to_numpy(jnt.Sampler(jg.normal_logp(3), jsettings)
                                .state)
    rng = np.random.default_rng(0)
    v = rng.normal(size=arrays["q"].shape)
    arrays["v"] = v / np.linalg.norm(v, axis=1, keepdims=True)
    arrays["draw_idx"] = np.asarray(4)
    state = tnt.state_from_numpy(arrays)
    np.testing.assert_array_equal(tnt.state_to_numpy(state)["v"],
                                  arrays["v"].astype(np.float32))

    model = tg.normal_logp(3)
    ts = tnt.DiagMclmcSettings(num_chains=4, num_tune=10, num_draws=5,
                               posterior_kernel="pallas")
    start, end, runner = ts.build_phases(model, ts.chain_config())[1]
    assert (start, end) == (3, 10)
    lo, hi = 4, 8
    flags = ts.extra_flags(_schedule_chunk(build_schedule(10, 5, ts.adapt),
                                           lo, hi), lo, hi)
    assert not flags["resample_velocity"].any()
    new, stats = runner(state, flags)

    est = np.stack([arrays[f"{e}_{f}"] for e in ("draw", "grad", "draw_bg",
                                                  "grad_bg")
                    for f in ("mean", "var_sum")], 1)
    sca = np.stack([arrays["transform_id"], arrays["logdet"],
                    arrays["draw_count"], arrays["draw_bg_count"]], 1)
    want = mclmc_pallas_warmup_run(
        derive_seed(0, lo, PURPOSE_MCLMC_WARMUP),
        warmup_flags(flags, "cpu", MCLMC_FLAG_COLUMNS).numpy(), arrays["q"], arrays["g"],
        arrays["logp"], arrays["v"], arrays["stds"], arrays["mean"], est,
        sca, lambda q: (-0.5 * jnp.sum((q - 3.0) ** 2, 0), -(q - 3.0)),
        JaxMclmcOptions(), jsettings.step_size_settings, True, block=4,
        interpret=True)
    np.testing.assert_array_equal(stats["n_steps"].T.numpy(),
                                  np.asarray(want[9]["n_steps"]))
    np.testing.assert_array_equal(stats["transformation_index"].T.numpy(),
                                  np.asarray(want[9]["transformation_index"]))
    for got, ref in ((stats["position"].permute(1, 0, 2), want[8]),
                     (new.pt.q, want[0]), (new.pt.v, want[3]),
                     (new.transform.stds, want[4])):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4,
                                   atol=1e-4)


def _no_hook(dim):
    return Model(logp_fn=lambda q: -0.5 * torch.sum(q * q), dim=dim)


@pytest.mark.parametrize("change,item", [
    (dict(mass_matrix="flow"), "item 15"),
    (dict(mesh_axis_name="chains"), "item 17b"),
    ("cuda_smem", "shared.*item 12"),
])
def test_unsupported_settings_raise(change, item):
    model, device = tg.normal_logp(3), "cpu"
    kw = dict(posterior_kernel="pallas", num_chains=4, num_tune=5,
              num_draws=5)
    if change == "cuda_smem":
        # fits the JAX rule, but not one block's shared memory on the card
        model, device = tg.logistic_regression_from_tensors(
            torch.zeros(11, 60000), torch.zeros(60000)), "cuda"
    else:
        kw.update(change)
    with pytest.raises(NotImplementedError, match=item):
        tnt.Sampler(model, tnt.DiagMclmcSettings(**kw), device=device)


def _plan(phases):
    return [(lo, hi, "fused" if "fused" in r.__qualname__ else "sync")
            for lo, hi, r in phases]


def _jax_plan(phases):
    return [(lo, hi, "sync" if isinstance(r, functools.partial)
             else "fused") for lo, hi, r in phases]


@pytest.mark.parametrize("change,warn", [
    (dict(posterior_kernel="sync"), None),
    (dict(store_gradient=True), "does not support: store_gradient=True"),
    (dict(store_divergences=True), "does not support: store_divergences"),
    ("no_hook", "no kernel_hook"),
    ("above_warmup_limit", None),
    ("above_posterior_limit", "no fused-engine tier fits"),
    ("data_fail_the_rule", None),
    ("data_fail_both_rules", "no fused-engine tier fits"),
    (dict(mass_matrix="low_rank"), "does not support: mass_matrix="),
    (dict(cross_chain_adaptation=True),
     "does not support: cross_chain_adaptation=True"),
])
def test_settings_that_used_to_raise_now_plan_as_the_jax_package(change,
                                                                 warn):
    """Each used to be a case of ``test_unsupported_settings_raise`` naming
    item 8, 9, 14 or 17.  The port now plans what the JAX package plans, on
    the sync MCLMC engine where that package's fused runners decline, with
    that package's ``UserWarning`` (a model without a kernel hook: the
    port's own, since the JAX package traces its logp into its kernels)."""
    kw = dict(posterior_kernel="pallas", num_chains=4, num_tune=5,
              num_draws=5)
    jmodel, model = jg.normal_logp(3), tg.normal_logp(3)
    if change == "no_hook":
        model = _no_hook(3)
    elif change == "above_warmup_limit":
        # the sync warmup, then the fused posterior, without a warning
        jmodel, model = jg.normal_logp(362), tg.normal_logp(362)
    elif change == "above_posterior_limit":
        jmodel, model = jg.normal_logp(485), tg.normal_logp(485)
    elif change == "data_fail_the_rule":
        # 8.9 MB of data at d = 100 leave the warmup launch no room: the
        # sync warmup, then the fused posterior
        jmodel = jg.logistic_regression(22000, 100, 0)
        model = tg.logistic_regression_from_tensors(
            torch.zeros(100, 22000), torch.zeros(22000))
    elif change == "data_fail_both_rules":
        # the JAX benchmark's logreg_big data (16.9 MB at d = 32): no
        # fused MCLMC launch holds them, and MCLMC streams none
        jmodel = jg.logistic_regression(131072, 32, 0)
        model = tg.logistic_regression_from_tensors(
            torch.zeros(32, 131072), torch.zeros(131072))
    else:
        kw.update(change)
    ts, js = tnt.DiagMclmcSettings(**kw), jnt.DiagMclmcSettings(**kw)
    assert ts.unsupported(model, "cpu") == []
    assert ts.unsupported(model, "cuda") == []
    jcfg = js.chain_config()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        got = _plan(ts.build_phases(model, ts.chain_config(), "cpu"))
        if change != "no_hook":
            want = _jax_plan(js.build_phases(jmodel, _strategy_for(js, jcfg),
                                             jcfg))
    texts = [str(w.message) for w in seen
             if issubclass(w.category, UserWarning)]
    if warn is None:
        assert texts == []
    else:
        assert all("using the" in t for t in texts)
        assert any(warn in t for t in texts), texts
    if change == "no_hook":
        # the JAX package would run it fused (its kernels trace the logp)
        want = [(0, 1, "sync"), (1, 10, "sync")]
    elif change in ("above_warmup_limit", "data_fail_the_rule"):
        assert want == [(0, 1, "sync"), (1, 5, "sync"), (5, 10, "fused")]
    else:
        assert want == [(0, 1, "sync"), (1, 10, "sync")]
    assert got == want


def test_small_sizes_without_an_instance_take_the_mid_kernels():
    """d = 5 has no thread-per-chain MCLMC instance; it used to raise on
    CUDA and is served by the mid-d kernels now (MCLMC keeps d >= 2)."""
    from nuts_rs_tpu_torch.kernels import nuts_fused as nf

    settings = tnt.DiagMclmcSettings(posterior_kernel="pallas", num_chains=4,
                                     num_tune=5, num_draws=5)
    for dim in (2, 5, 7, 9):
        model = tg.normal_logp(dim)
        assert settings.unsupported(model, "cuda") == []
        assert nf.cl_kernel(model, dim) == "mid"
    for dim in (3, 4, 6, 10):
        assert nf.cl_kernel(tg.normal_logp(dim), dim) == "thread"
    trace = tnt.sample(tg.normal_logp(5), settings, device="cpu")
    assert trace.posterior["position"].shape == (4, 5, 5)


def test_microcanonical_needs_two_dimensions():
    kw = dict(posterior_kernel="pallas", num_chains=4, num_tune=5,
              num_draws=5)
    with pytest.raises(ValueError, match="dim >= 2"):
        tnt.Sampler(tg.normal_logp(1), tnt.DiagMclmcSettings(**kw),
                    device="cpu")
    euclidean = tnt.DiagMclmcSettings(
        trajectory_kind=tnt.MclmcTrajectoryKind.EUCLIDEAN, **kw)
    trace = tnt.sample(tg.normal_logp(1), euclidean, device="cpu")
    assert trace.posterior["position"].shape == (4, 5, 1)
