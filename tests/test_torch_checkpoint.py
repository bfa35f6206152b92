"""Checkpoint and restore of the port's ``Sampler`` (``checkpoint.py``) on
the CPU: a sampler built afresh with the same settings that restores a
checkpoint taken mid-warmup or mid-posterior and runs to the end gives
every stored draw and stat of an uninterrupted run bit for bit, on the
fused NUTS engine's plain versions, the sync NUTS engine, the sync and
fused MCLMC engines and a learned flow (``FlowNutsSettings``: the sync
warmup with the flow's refits, then K1-flow's plain version).  The draw
index is the whole random state: every seed comes from the counter hash of
(base seed, draw index, purpose).  A checkpoint of other settings raises
``ValueError``; the file holds the JAX package's keys."""

import numpy as np
import pytest
import torch

import nuts_rs_tpu_torch as tnt
from nuts_rs_tpu_torch import checkpoint as ck
from nuts_rs_tpu_torch.models.gaussian import normal_logp

GROUPS = ("posterior", "sample_stats", "warmup_posterior",
          "warmup_sample_stats")
CHUNK = 8
TUNE, DRAWS = 30, 20


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _flow():
    return tnt.coupling_flow(tnt.CouplingFlowConfig(num_layers=2, hidden=8,
                                                    train_steps=20))


def _settings(engine, seed=3):
    base = dict(num_chains=3, num_tune=TUNE, num_draws=DRAWS, seed=seed)
    if engine == "nuts_fused":
        return tnt.DiagNutsSettings(posterior_kernel="pallas", **base)
    if engine == "nuts_sync":
        return tnt.DiagNutsSettings(**base)
    if engine == "mclmc_sync":
        return tnt.DiagMclmcSettings(**base)
    if engine == "mclmc_fused":
        return tnt.DiagMclmcSettings(posterior_kernel="pallas", **base)
    if engine == "flow":
        return tnt.FlowNutsSettings(posterior_kernel="pallas",
                                    flow_spec=_flow(), **base)
    raise ValueError(engine)


def _sampler(engine, **kw):
    return tnt.Sampler(normal_logp(3, 1.0), _settings(engine, **kw),
                       chunk_size=CHUNK, device="cpu")


def _tail(trace, start):
    """Every group's arrays from global draw ``start`` on."""
    out = {}
    for g in GROUPS:
        first = 0 if g.startswith("warmup") else TUNE
        cut = max(0, start - first)
        out[g] = {k: v[:, cut:] for k, v in getattr(trace, g).items()}
    return out


@pytest.mark.parametrize("at", ["warmup", "posterior"])
@pytest.mark.parametrize("engine", ["nuts_fused", "nuts_sync", "mclmc_sync",
                                    "mclmc_fused", "flow"])
def test_restored_run_equals_the_uninterrupted_one(engine, at, tmp_path):
    full = _sampler(engine).run()
    stop = 13 if at == "warmup" else TUNE + 5
    a = _sampler(engine)
    while a._next_draw < stop:
        a.run_next_chunk()
    boundary = a._next_draw
    path = str(tmp_path / "state.npz")
    a.checkpoint(path)
    a.abort()
    b = _sampler(engine)
    b.restore(path)
    assert b._next_draw == b.state.draw_idx == boundary
    got = b.run()
    want = _tail(full, boundary)
    for g in GROUPS:
        arrays = getattr(got, g)
        assert set(arrays) == set(want[g]), g
        for name, v in want[g].items():
            assert arrays[name].shape == v.shape, (g, name)
            np.testing.assert_array_equal(arrays[name], v, err_msg=name)
    assert got.posterior["position"].shape[1] == DRAWS - max(
        0, boundary - TUNE)
    if engine == "flow":
        # a refit before the checkpoint and one after it when restored in
        # the warmup (draws 10 and 20)
        ids = full.warmup_sample_stats["transformation_index"]
        assert ids[:, 12].min() == 1 and ids[:, 25].min() == 2


def test_other_settings_raise_value_error(tmp_path):
    a = _sampler("nuts_fused")
    a.run_next_chunk()
    path = str(tmp_path / "state.npz")
    a.checkpoint(path)
    more_chains = tnt.Sampler(
        normal_logp(3, 1.0), tnt.DiagNutsSettings(
            num_chains=4, num_tune=TUNE, num_draws=DRAWS,
            posterior_kernel="pallas"), device="cpu")
    with pytest.raises(ValueError, match="shape"):
        more_chains.restore(path)
    other_dim = tnt.Sampler(normal_logp(4, 1.0), _settings("nuts_fused"),
                            device="cpu")
    with pytest.raises(ValueError, match="shape"):
        other_dim.restore(path)
    flow = _sampler("flow")
    with pytest.raises(ValueError, match="leaves"):
        flow.restore(path)


def test_file_layout_is_the_jax_packages(tmp_path):
    s = _sampler("nuts_sync")
    s.run_next_chunk()
    path = str(tmp_path / "state.npz")
    s.checkpoint(path)
    with np.load(path) as data:
        n = int(data["__num_leaves__"])
        assert set(data.files) == {f"leaf_{i}" for i in range(n)} | {
            "__num_leaves__", "__next_draw__", "__key_leaves__"}
        assert int(data["__next_draw__"]) == CHUNK
        assert data["__key_leaves__"].size == 0
    state, nd = ck.load_state(path, s.state)
    assert nd == CHUNK and state.draw_idx == CHUNK
    flat, like = ck.state_leaves(state), ck.state_leaves(s.state)
    assert len(flat) == n == len(like)
    for x, y in zip(flat, like):
        if isinstance(y, torch.Tensor):
            assert x.dtype == y.dtype and x.device == y.device
            assert torch.equal(x, y)
        else:
            assert x == y
