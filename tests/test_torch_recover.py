"""``Sampler(auto_recover=..., recovery_path=...)`` and ``DeviceLostError``
in the port on the CPU, with injected faults, after the JAX package's
``tests/test_failure.py:104-200``: an out-of-memory error replays from the
last stored chunk at half the launch size and the trace holds every draw
once; the budget and the error filter (a user's error, and a fault with
the feature off, raise at once); a device that stays dead spills the
snapshot in checkpoint format and raises ``DeviceLostError``, and a fresh
sampler restores it and finishes bit for bit as an uninterrupted run."""

import os

import numpy as np
import pytest
import torch

import nuts_rs_tpu as jnt
import nuts_rs_tpu_torch as tnt
from nuts_rs_tpu_torch.models.gaussian import normal_logp

GROUPS = ("posterior", "sample_stats", "warmup_posterior",
          "warmup_sample_stats")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _settings(**kw):
    base = dict(num_tune=20, num_draws=20, num_chains=8, seed=3)
    base.update(kw)
    return tnt.DiagNutsSettings(**base)


def _oom(*_):
    raise torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to "
                                      "allocate 1024.00 GiB")


def _assert(*_):
    raise RuntimeError("CUDA error: device-side assert triggered")


def _faulty(s, fault):
    """Every runner of ``s`` raises ``fault`` once, at its next call."""
    left = [1]

    def wrap(runner):
        def run(state, flags, **kw):
            if left[0]:
                left[0] -= 1
                fault()
            return runner(state, flags, **kw)
        return run

    s._phase_runners = [(a, b, wrap(r)) for a, b, r in s._phase_runners]


def _equal(a, b):
    for g in GROUPS:
        x, y = getattr(a, g), getattr(b, g)
        assert set(x) == set(y), g
        for name in x:
            np.testing.assert_array_equal(x[name], y[name],
                                          err_msg=f"{g}/{name}")


def test_an_out_of_memory_error_replays_at_half_the_launch_size():
    s = tnt.Sampler(normal_logp(3, 1.0), _settings(), chunk_size=10,
                    device="cpu", auto_recover=2)
    s.run_next_chunk()  # one clean chunk: the snapshot at draw 10
    _faulty(s, _oom)
    with pytest.warns(RuntimeWarning, match="device fault.*draw 10"):
        trace = s.run()
    assert s.max_chains_per_launch == 4  # halved from the full 8
    assert s._recover_left == 1
    # every draw exactly once: the sync engine's split is bit-transparent,
    # so the trace is the uninterrupted run's
    _equal(trace, tnt.sample(normal_logp(3, 1.0), _settings(),
                             chunk_size=10, device="cpu"))
    assert [p.finished_draws for p in s.progress] == [40] * 8


def test_the_budget_and_the_error_filter():
    model = normal_logp(2, 0.0)
    settings = _settings(num_tune=8, num_draws=8, num_chains=4, seed=0)
    # a user's error is raised at once, the budget untouched
    s = tnt.Sampler(model, settings, chunk_size=8, device="cpu",
                    auto_recover=2)
    s._phase_runners = [
        (a, b, lambda *_: (_ for _ in ()).throw(ValueError("user bug")))
        for a, b, _ in s._phase_runners]
    with pytest.raises(ValueError, match="user bug"):
        s.run_next_chunk()
    assert s._recover_left == 2
    # the feature off: a device fault is raised
    s2 = tnt.Sampler(model, settings, chunk_size=8, device="cpu")
    s2._phase_runners = [(a, b, _oom) for a, b, _ in s2._phase_runners]
    with pytest.raises(torch.cuda.OutOfMemoryError):
        s2.run_next_chunk()
    # the budget spent: the fault is raised after N replays
    s3 = tnt.Sampler(model, settings, chunk_size=8, device="cpu",
                     auto_recover=1)
    s3._phase_runners = [(a, b, _oom) for a, b, _ in s3._phase_runners]
    with pytest.warns(RuntimeWarning, match="device fault"):
        with pytest.raises(torch.cuda.OutOfMemoryError):
            s3.run_next_chunk()
    assert s3._recover_left == 0
    # a sticky error on a device that is alive (the probe passes) replays
    s4 = tnt.Sampler(model, settings, chunk_size=8, device="cpu",
                     auto_recover=True)
    assert s4._recover_left == 3
    _faulty(s4, _assert)
    with pytest.warns(RuntimeWarning, match="device-side assert"):
        s4.run()
    # the JAX package's names and defaults
    import inspect
    got = inspect.signature(tnt.Sampler).parameters
    want = inspect.signature(jnt.Sampler).parameters
    for name in ("auto_recover", "recovery_path", "profile_dir",
                 "max_chains_per_launch", "dtype"):
        assert got[name].default == want[name].default, name
    assert issubclass(tnt.DeviceLostError, RuntimeError)


def test_a_dead_device_spills_the_snapshot_and_a_fresh_sampler_finishes(
        tmp_path, monkeypatch):
    model = normal_logp(3, 1.0)
    settings = _settings(num_chains=4, seed=7)
    path = str(tmp_path / "recover")  # ".npz" is appended
    s = tnt.Sampler(model, settings, chunk_size=10, device="cpu",
                    auto_recover=2, recovery_path=path)
    assert s.recovery_path == path + ".npz"
    s.run_next_chunk()
    s.run_next_chunk()  # the snapshot at draw 20
    _faulty(s, _assert)
    # the context is poisoned: every probe fails
    monkeypatch.setattr(s, "_wait_device_alive", lambda: False)
    with pytest.warns(RuntimeWarning, match="device fault"):
        with pytest.raises(tnt.DeviceLostError, match="restore") as err:
            s.run_next_chunk()
    assert "device-side assert" in str(err.value.__cause__)
    assert os.path.exists(path + ".npz")
    with np.load(path + ".npz") as data:  # checkpoint format
        assert int(data["__next_draw__"]) == 20
    # without a recovery path the fault itself is raised
    s_no = tnt.Sampler(model, settings, chunk_size=10, device="cpu",
                       auto_recover=2)
    _faulty(s_no, _assert)
    monkeypatch.setattr(s_no, "_wait_device_alive", lambda: False)
    with pytest.warns(RuntimeWarning):
        with pytest.raises(RuntimeError, match="device-side assert"):
            s_no.run_next_chunk()

    # a "fresh process": a new sampler with the same settings resumes
    s2 = tnt.Sampler(model, settings, chunk_size=10, device="cpu")
    s2.restore(path + ".npz")
    assert s2._next_draw == 20
    resumed = s2.run()
    clean = tnt.sample(model, settings, chunk_size=10, device="cpu")
    for g in GROUPS:
        start = 0 if g.startswith("warmup") else 20
        for name, arr in getattr(clean, g).items():
            np.testing.assert_array_equal(getattr(resumed, g)[name],
                                          arr[:, max(0, 20 - start):],
                                          err_msg=f"{g}/{name}")
