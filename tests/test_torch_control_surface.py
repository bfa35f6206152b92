"""The port's ``Sampler`` control surface on the CPU, each part on the sync
engine and on the fused engine's plain versions: ``pause`` / ``resume``,
``wait_timeout``, ``abort``, ``inspect`` and ``flush``; ``ChainProgress``
through ``progress_callback`` and the sync engines' in-chunk
``progress_tick``; ``sample_sequentially``; ``ConvergenceStop``.  The
public names, fields and defaults are held against the JAX package's
(``tests/test_control_surface.py`` is the oracle for the semantics)."""

import dataclasses
import inspect

import numpy as np
import pytest
import torch

import nuts_rs_tpu as jnt
import nuts_rs_tpu_torch as tnt
from nuts_rs_tpu.models import gaussian as jg
from nuts_rs_tpu_torch.models.gaussian import normal_logp

GROUPS = ("posterior", "sample_stats", "warmup_posterior",
          "warmup_sample_stats")
ENGINES = ["sync", "pallas"]


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _settings(kernel, sampler="nuts", **kw):
    base = dict(num_chains=3, num_tune=24, num_draws=24, seed=6,
                posterior_kernel=kernel)
    base.update(kw)
    make = {"nuts": tnt.DiagNutsSettings, "mclmc": tnt.DiagMclmcSettings}
    return make[sampler](**base)


def _sampler(kernel, sampler="nuts", chunk_size=8, model=None, **kw):
    settings_kw = {k: kw.pop(k) for k in list(kw) if k.startswith("num_")
                   or k == "seed"}
    return tnt.Sampler(model or normal_logp(3, 1.0),
                       _settings(kernel, sampler, **settings_kw),
                       chunk_size=chunk_size, device="cpu", **kw)


def _equal(a, b):
    for g in GROUPS:
        x, y = getattr(a, g), getattr(b, g)
        assert set(x) == set(y), g
        for name in x:
            np.testing.assert_array_equal(x[name], y[name], err_msg=name)


@pytest.mark.parametrize("kernel", ENGINES)
def test_wait_timeout_returns_none_then_the_trace(kernel):
    s = _sampler(kernel)
    assert s.wait_timeout(0.0) is None
    assert not s.finished and s._next_draw == 0
    trace = s.wait_timeout(600.0)
    assert s.finished
    assert trace.posterior["position"].shape == (3, 24, 3)
    _equal(trace, _sampler(kernel).run())


@pytest.mark.parametrize("kernel", ENGINES)
def test_pause_from_the_callback_then_resume(kernel):
    """A callback that pauses stops ``run()`` at a chunk boundary with
    ``RuntimeError``; ``resume(); run()`` finishes with the trace of an
    uninterrupted run, and the final progress adds up to it."""
    s = _sampler(kernel)

    def cb(progress):
        if not cb.paused:
            cb.paused = True
            s.pause()

    cb.paused = False
    s.progress_callback = cb
    with pytest.raises(RuntimeError, match="paused"):
        s.run()
    first = s._next_draw
    assert 0 < first < 48 and first == s.chunk_seconds[-1][1]
    assert [p.finished_draws for p in s.progress] == [first] * 3
    s.resume()
    trace = s.run()
    _equal(trace, _sampler(kernel).run())
    steps = np.concatenate([trace.warmup_sample_stats["n_steps"],
                            trace.sample_stats["n_steps"]], 1)
    for c, p in enumerate(s.progress):
        assert p.finished_draws == p.total_draws == 48
        assert p.divergences == int(trace.sample_stats["diverging"][c].sum())
        assert p.total_num_steps == int(steps[c].sum())
        assert p.latest_num_steps == int(steps[c, -1])
        assert p.step_size == float(trace.sample_stats["step_size"][c, -1])
        assert p.started and not p.tuning and not p.failed
        assert p.runtime > 0.0


@pytest.mark.parametrize("kernel", ENGINES)
def test_abort_returns_what_was_recorded(kernel):
    s = _sampler(kernel)
    s.run_next_chunk()
    s.run_next_chunk()
    done = s._next_draw
    snap = s.abort()
    assert snap.warmup_posterior["position"].shape == (3, done, 3)
    assert snap.posterior["position"].shape == (3, 0, 3)
    with pytest.raises(RuntimeError):
        s.run()
    assert s._next_draw == done


@pytest.mark.parametrize("kernel", ENGINES)
def test_inspect_and_flush_leave_the_run_going(kernel):
    s = _sampler(kernel)
    while s._next_draw < 30:
        s.run_next_chunk()
    done = s._next_draw
    s.flush()
    snap = s.inspect()
    trace = s.run()
    _equal(snap, tnt.Trace(
        posterior={k: v[:, :done - 24] for k, v in trace.posterior.items()},
        sample_stats={k: v[:, :done - 24]
                      for k, v in trace.sample_stats.items()},
        warmup_posterior=trace.warmup_posterior,
        warmup_sample_stats=trace.warmup_sample_stats,
        transformation_updates=[]))


def test_callback_is_rate_limited_and_fires_at_the_end():
    calls = []
    s = _sampler("sync", chunk_size=4,
                 progress_callback=lambda p: calls.append(
                     p[0].finished_draws))
    s.progress_rate_seconds = 3600.0
    s.run()
    # the first chunk (no call before it) and the end
    assert calls == [4, 48]
    every = []
    s = _sampler("sync", chunk_size=4,
                 progress_callback=lambda p: every.append(
                     p[0].finished_draws))
    s.progress_rate_seconds = 0.0
    s.run()
    assert every == list(range(4, 49, 4))


@pytest.mark.parametrize("sampler", ["nuts", "mclmc"])
def test_progress_tick_fires_inside_a_sync_chunk(sampler):
    """``tests/test_control_surface.py::test_progress_tick_live_in_chunk``:
    provisional values from inside the chunk, replaced by the exact
    chunk-end accounting; the draws equal a tick-free run's."""
    seen = []

    def cb(progress):
        seen.append((s._next_draw, progress[0].finished_draws,
                     progress[0].total_num_steps))

    s = _sampler("sync", sampler, chunk_size=16, progress_callback=cb,
                 progress_tick=3)
    s.progress_rate_seconds = 0.0
    trace = s.run()
    # per chunk: a tick every 3 draws (the sampler's cursor still at the
    # chunk's start), then the chunk end's exact values
    want = []
    for lo, hi, _ in s.chunk_seconds:
        want += [(lo, lo + j) for j in range(3, hi - lo + 1, 3)]
        want.append((hi, hi))
    assert [(lo, d) for lo, d, _ in seen] == want
    assert any(lo < d < lo + 16 for lo, d in want)
    ref = _sampler("sync", sampler, chunk_size=16)
    ref_trace = ref.run()
    _equal(trace, ref_trace)
    assert ([p.total_num_steps for p in s.progress]
            == [p.total_num_steps for p in ref.progress])
    assert ([p.divergences for p in s.progress]
            == [p.divergences for p in ref.progress])
    # the running step counts rise within a chunk and the chunk end's
    # replaces the last tick's
    steps = np.concatenate([trace.warmup_sample_stats["n_steps"],
                            trace.sample_stats["n_steps"]], 1)[0]
    for (lo, d, n) in seen:
        assert n == int(steps[:d].sum())


def test_fused_chunks_get_no_ticks():
    seen = []
    s = _sampler("pallas", chunk_size=16, progress_tick=3,
                 progress_callback=lambda p: seen.append(
                     (s._next_draw, p[0].finished_draws)))
    s.progress_rate_seconds = 0.0
    s.run()
    # the fused warmup's and posterior's chunks report at their ends only
    assert all(lo == d for lo, d in seen)


def test_progress_tick_below_one_raises():
    with pytest.raises(ValueError, match="progress_tick"):
        _sampler("sync", progress_tick=0)


@pytest.mark.parametrize("kernel", ENGINES)
def test_sample_sequentially_equals_the_one_chain_run(kernel):
    settings = _settings(kernel, num_chains=1, num_tune=10, num_draws=14,
                         seed=4)
    start = np.full(3, 0.5)
    rows = list(tnt.sample_sequentially(
        normal_logp(3, 2.0), settings, start=start, draws=24, seed=4,
        chunk_size=5, device="cpu"))
    batched = tnt.sample(normal_logp(3, 2.0), settings,
                         init_positions=start[None, :], chunk_size=5,
                         device="cpu")
    post = np.stack([p for p, pr in rows if not pr["tuning"]])
    np.testing.assert_array_equal(post, batched.posterior["position"][0])
    warm = np.stack([p for p, pr in rows if pr["tuning"]])
    np.testing.assert_array_equal(warm,
                                  batched.warmup_posterior["position"][0])
    assert [pr["draw"] for _, pr in rows] == list(range(24))
    steps = [pr["num_steps"] for _, pr in rows if not pr["tuning"]]
    assert steps == batched.sample_stats["n_steps"][0].tolist()


def test_sample_sequentially_is_lazy_with_the_jax_keys():
    jrows = list(jnt.sample_sequentially(
        jg.normal_logp(3, mu=0.0), jnt.DiagNutsSettings(num_tune=2,
                                                        num_draws=2),
        start=np.zeros(3), draws=4, chunk_size=4))
    it = tnt.sample_sequentially(
        normal_logp(3, 0.0), tnt.DiagNutsSettings(num_tune=50,
                                                  num_draws=50),
        start=np.zeros(3), draws=100, chunk_size=10, device="cpu")
    got = []
    for i, (pos, prog) in enumerate(it):
        got.append(prog)
        if i == 2:
            break
    assert [p["draw"] for p in got] == [0, 1, 2]
    assert set(got[0]) == set(jrows[0][1])
    for key, value in jrows[0][1].items():
        assert type(got[0][key]) is type(value), key
    assert pos.shape == (3,)


@pytest.mark.parametrize("kernel", ENGINES)
def test_convergence_stop_ends_early_at_a_chunk_boundary(kernel):
    from nuts_rs_tpu_torch.diagnostics import ess_bulk, split_rhat

    crit = tnt.ConvergenceStop(rhat_max=1.05, min_ess_bulk=150.0,
                               min_draws=40)
    s = tnt.Sampler(normal_logp(2, 2.0), _settings(
        kernel, num_chains=6, num_tune=60, num_draws=1000, seed=0),
        chunk_size=40, stop_when=crit, device="cpu")
    trace = s.run()
    pos = trace.posterior["position"]
    assert s.converged and not s.finished
    assert 40 <= pos.shape[1] < 1000
    assert s._next_draw == 60 + pos.shape[1] == s.chunk_seconds[-1][1]
    # the stop came at the first chunk end where the criteria held
    before = s.chunk_seconds[-2][1] - 60
    assert not crit.satisfied(pos[:, :before])
    assert np.all(split_rhat(pos) <= 1.05)
    assert np.all(ess_bulk(pos) >= 150.0)
    assert abs(pos.mean() - 2.0) < 0.2


def test_convergence_stop_never_met_runs_to_the_end_with_its_var_kept():
    crit = tnt.ConvergenceStop(min_ess_bulk=1e9, min_draws=10,
                               var="energy", max_buffer_draws=16)
    s = _sampler("sync", chunk_size=10, stop_when=crit,
                 keep_stats=("mean_tree_accept",))
    trace = s.run()
    assert not s.converged and s.finished
    assert "energy" in trace.sample_stats
    series = np.concatenate(s._post_buffer, axis=1)
    assert series.shape == (3, 12) and s._post_thin == 2


def test_a_restore_resets_the_convergence_bookkeeping(tmp_path):
    crit = tnt.ConvergenceStop(min_ess_bulk=1.0, rhat_max=10.0,
                               min_draws=4)
    s = _sampler("sync", stop_when=crit)
    path = str(tmp_path / "ck.npz")
    s.checkpoint(path)
    s.run()
    assert s.converged and s._post_buffer
    s.restore(path)
    assert not s.converged and s._post_buffer == [] and s._post_seen == 0
    assert s._next_draw == 0


def test_public_names_fields_and_defaults_are_the_jax_packages():
    for cls in ("ChainProgress", "ConvergenceStop"):
        got = [(f.name, f.default) for f in dataclasses.fields(
            getattr(tnt, cls))]
        want = [(f.name, f.default) for f in dataclasses.fields(
            getattr(jnt, cls))]
        assert got == want, cls
    err = tnt.ChainFailedError("x", trace="t", chains=(2, 5))
    assert isinstance(err, RuntimeError)
    assert (err.trace, err.chains, str(err)) == ("t", [2, 5], "x")
    names = ("progress_callback", "progress_tick", "stop_when", "fail_after")
    for fn in ("Sampler", "sample"):
        got = inspect.signature(getattr(tnt, fn)).parameters
        want = inspect.signature(getattr(jnt, fn)).parameters
        for name in names:
            if fn == "sample" and name == "progress_tick":
                assert got[name].default is None
                continue
            assert got[name].default == want[name].default, (fn, name)
    for method in ("pause", "resume", "wait_timeout", "abort", "inspect",
                   "flush", "checkpoint", "restore"):
        assert callable(getattr(tnt.Sampler, method))
    got = inspect.signature(tnt.sample_sequentially).parameters
    want = inspect.signature(jnt.sample_sequentially).parameters
    assert list(want) == list(got)[:len(want)]
    assert all(got[k].default == want[k].default for k in want)
