"""``run()``'s launch/finish pipelining in the port's ``Sampler`` on the
CPU: a pipelined ``run()`` gives the trace of a ``run_next_chunk`` loop bit
for bit on the sync NUTS, sync MCLMC, fused NUTS and fused MCLMC (plain
versions) and flow engines, with the transfer knobs and both expansions
on; pipelining is off where the JAX package turns it off
(``progress_tick``, ``auto_recover``) and with ``profile_dir``, which
writes a Chrome trace a chunk.  The stuck-chain detector's draw against
the JAX ``run()`` is in ``test_torch_failure.py``; the copy stream's
buffers on the card in ``test_torch_kernels_cuda.py``."""

import json
import os

import numpy as np
import pytest
import torch

import nuts_rs_tpu_torch as tnt
from nuts_rs_tpu_torch.models.gaussian import normal_logp

GROUPS = ("posterior", "sample_stats", "warmup_posterior",
          "warmup_sample_stats")
ENGINES = ("nuts_sync", "mclmc_sync", "nuts_fused", "mclmc_fused", "flow")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _settings(engine):
    base = dict(num_chains=3, num_tune=20, num_draws=20, seed=4)
    if engine == "nuts_sync":
        return tnt.DiagNutsSettings(**base)
    if engine == "nuts_fused":
        return tnt.DiagNutsSettings(posterior_kernel="pallas", **base)
    if engine == "mclmc_sync":
        return tnt.DiagMclmcSettings(**base)
    if engine == "mclmc_fused":
        return tnt.DiagMclmcSettings(posterior_kernel="pallas", **base)
    flow = tnt.coupling_flow(tnt.CouplingFlowConfig(num_layers=2, hidden=8,
                                                    train_steps=20))
    return tnt.FlowNutsSettings(posterior_kernel="pallas", flow_spec=flow,
                                **base)


def _draw_index(positions, first_draw):
    C, k = positions.shape[:2]
    return {"draw_index": np.broadcast_to(
        first_draw + np.arange(k, dtype=np.int64), (C, k)).copy()}


def _model():
    import dataclasses

    return dataclasses.replace(
        normal_logp(3, 1.0), expand_fn=lambda q: {"e": torch.exp(q - 1.0)},
        expand_host_fn=_draw_index)


def _sampler(engine, **kw):
    return tnt.Sampler(_model(), _settings(engine), chunk_size=6,
                       device="cpu", draw_dtype=np.float16,
                       keep_stats=("mean_tree_accept", "energy"), **kw)


def _serial(s):
    while not s.finished:
        s.run_next_chunk()
    return s.trace.finalize()


def _equal(a, b):
    for g in GROUPS:
        x, y = getattr(a, g), getattr(b, g)
        assert set(x) == set(y), g
        for name in x:
            np.testing.assert_array_equal(x[name], y[name],
                                          err_msg=f"{g}/{name}")


@pytest.mark.parametrize("engine", ENGINES)
def test_pipelined_run_equals_the_serial_loop(engine, monkeypatch):
    """The pipelined run() launches chunk k+1 before it finishes chunk k
    (spied on), and stores the serial loop's trace bit for bit."""
    s = _sampler(engine)
    assert s.pipelined
    order = []
    launch0, finish0 = s._launch_chunk, s._finish_chunk

    def launch():
        order.append(("launch", s._next_draw))
        return launch0()

    def finish(chunk):
        order.append(("finish", chunk[0]))
        return finish0(chunk)

    monkeypatch.setattr(s, "_launch_chunk", launch)
    monkeypatch.setattr(s, "_finish_chunk", finish)
    got = s.run()
    assert [o[0] for o in order[:3]] == ["launch", "launch", "finish"]
    assert order[0] == ("launch", 0) and order[2] == ("finish", 0)
    assert order[-1][0] == "finish"
    _equal(got, _serial(_sampler(engine)))
    assert got.posterior["position"].dtype == np.float16
    assert set(got.posterior) == {"position", "e", "draw_index"}
    assert [p.finished_draws for p in s.progress] == [40] * 3


@pytest.mark.parametrize("knob", [
    {"progress_tick": 2}, {"auto_recover": 1}, {"profile_dir": "prof"}])
def test_pipelining_is_off_where_the_jax_package_turns_it_off(knob,
                                                              tmp_path):
    if "profile_dir" in knob:
        knob = {"profile_dir": str(tmp_path / knob["profile_dir"])}
    s = tnt.Sampler(normal_logp(3, 1.0), _settings("nuts_sync"),
                    chunk_size=10, device="cpu", **knob)
    assert not s.pipelined
    launched = []
    launch0 = s._launch_chunk

    def launch():
        # the chunk before was finished: its draws are counted
        launched.append((s._next_draw, s.progress[0].finished_draws))
        return launch0()

    s._launch_chunk = launch
    trace = s.run()
    assert launched == [(0, 0), (10, 10), (20, 20), (30, 30)]
    _equal(trace, tnt.Sampler(normal_logp(3, 1.0), _settings("nuts_sync"),
                              chunk_size=10, device="cpu").run())


def test_profile_dir_writes_a_chrome_trace_a_chunk(tmp_path):
    path = tmp_path / "prof"
    s = tnt.Sampler(normal_logp(3, 1.0), _settings("nuts_fused"),
                    chunk_size=10, device="cpu", profile_dir=str(path))
    s.run()
    files = sorted(os.listdir(path))
    assert files == [f"chunk_{lo:07d}_{hi:07d}.json"
                     for lo, hi, _ in s.chunk_seconds]
    events = json.loads((path / files[-1]).read_text())["traceEvents"]
    assert any("aten::" in str(e.get("name", "")) for e in events)


def test_the_first_chunk_calls_back_whatever_the_clock(monkeypatch):
    """A host whose monotonic clock reads less than the callback rate (one
    up for less than an hour, at a rate of 3600 s) still calls back after
    the first chunk."""
    import nuts_rs_tpu_torch.sampler as sm

    monkeypatch.setattr(sm.time, "monotonic", lambda: 5.0)
    calls = []
    s = tnt.Sampler(normal_logp(3, 1.0), _settings("nuts_sync"),
                    chunk_size=10, device="cpu",
                    progress_callback=lambda p: calls.append(
                        p[0].finished_draws))
    s.progress_rate_seconds = 3600.0
    s.run()
    assert calls == [10, 40]
