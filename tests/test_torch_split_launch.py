"""``Sampler(max_chains_per_launch=B)`` in the port on the CPU, against the
JAX package's ``_run_runner`` (``nuts_rs_tpu/sampler.py:1611-1643``): a
chunk runs one launch per group of B chains on slices of the state.

On the sync engines the random sites are keyed by the global chain, as
the JAX package's per-chain keys are, so a split run equals the unsplit
one bit for bit.  On the fused engine each group's launch is the JAX
package's choice: a launch of its own whose program ids restart at 0, its
seed salted by the group (the JAX runners salt it with the group's first
key; here with the group's first chain, and not at all for the group of
chain 0).  Every launch of a split run is held, draw for draw, against
``nuts_pallas_run`` / ``nuts_pallas_warmup_run`` in interpret mode on the
same group's inputs and seed, with the tolerances of
``test_torch_nuts_fused.py``.  The JAX package's validation holds."""

import jax
import numpy as np
import pytest
import torch

import nuts_rs_tpu as jnt
from nuts_rs_tpu.kernels.nuts import NutsOptions as JaxNutsOptions
from nuts_rs_tpu.kernels.nuts_pallas import (
    nuts_pallas_run,
    nuts_pallas_warmup_run,
)
from nuts_rs_tpu.models import gaussian as jg
import nuts_rs_tpu_torch as tnt
from nuts_rs_tpu_torch.kernels import nuts_fused as nf
from nuts_rs_tpu_torch.kernels.rng import chain_offset, group_seed
from nuts_rs_tpu_torch.models.gaussian import normal_logp

GROUPS = ("posterior", "sample_stats", "warmup_posterior",
          "warmup_sample_stats")
# (3, 10) is a size of kernels K1 / K2 (kernels/_build.py SIZES), whose
# plain versions replay the Pallas kernels at a block of 4 chains
MU, DIM, MAXDEPTH = 0.5, 3, 10
INT_STATS = ("depth", "diverging", "n_steps", "index_in_trajectory",
             "maxdepth_reached")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _equal(a, b):
    for g in GROUPS:
        x, y = getattr(a, g), getattr(b, g)
        assert set(x) == set(y), g
        for name in x:
            np.testing.assert_array_equal(x[name], y[name],
                                          err_msg=f"{g}/{name}")


@pytest.mark.parametrize("make", [tnt.DiagNutsSettings,
                                  tnt.DiagMclmcSettings])
def test_a_split_equals_one_launch_on_the_sync_engines(make):
    settings = make(num_chains=8, num_tune=12, num_draws=12, seed=2)
    one = tnt.sample(normal_logp(DIM, MU), settings, chunk_size=6,
                     device="cpu")
    for B in (4, 2):
        split = tnt.sample(normal_logp(DIM, MU), settings, chunk_size=6,
                           device="cpu", max_chains_per_launch=B)
        _equal(split, one)


def _jax_batched():
    model = jg.normal_logp(DIM, MU)

    def logp_grad_batched(q):
        return jax.vmap(model.logp_and_grad, in_axes=1, out_axes=(0, 1))(q)
    return logp_grad_batched


def _np(x):
    return x.numpy() if torch.is_tensor(x) else x


def _spy(monkeypatch, calls):
    run0, warm0 = nf.nuts_fused_run, nf.nuts_fused_warmup_run

    def keep(a):
        if isinstance(a, dict):
            return {k: keep(v) for k, v in a.items()}
        if isinstance(a, tuple):
            return tuple(keep(x) for x in a)
        return a.clone() if torch.is_tensor(a) else a

    def run(*a, **k):
        args = keep(a)
        out = run0(*a, **k)
        calls.append(("post", args, k, keep(out)))
        return out

    def warm(*a, **k):
        args = keep(a)
        out = warm0(*a, **k)
        calls.append(("warm", args, k, keep(out)))
        return out

    monkeypatch.setattr(nf, "nuts_fused_run", run)
    monkeypatch.setattr(nf, "nuts_fused_warmup_run", warm)


def _close(got, want, what, rtol, atol):
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=what)


def test_each_fused_launch_of_a_split_is_the_jax_launch_of_its_group(
        monkeypatch):
    C, B = 8, 4
    settings = tnt.DiagNutsSettings(num_chains=C, num_tune=6, num_draws=4,
                                    seed=3, maxdepth=MAXDEPTH,
                                    posterior_kernel="pallas")
    calls = []
    _spy(monkeypatch, calls)
    s = tnt.Sampler(normal_logp(DIM, MU), settings, chunk_size=4,
                    device="cpu", max_chains_per_launch=B)
    trace = s.run()
    posts = [c for c in calls if c[0] == "post"]
    warms = [c for c in calls if c[0] == "warm"]
    assert len(posts) == 2 and len(warms) % 2 == 0 and warms
    # every launch takes one group: B chains, program ids from 0
    assert all((a[1] if kind == "post" else a[2]).shape[0] == B
               for kind, a, _, _ in calls)
    # the group of chain 0 keeps the seed of a launch of every chain, the
    # other one's is salted
    for pair in (posts, warms[:2]):
        seeds = [a[0] for _, a, _, _ in pair]
        assert seeds[0] != seeds[1]
        with chain_offset(B):
            assert group_seed(seeds[0]) == seeds[1]
    sset = settings.step_size
    jopts = JaxNutsOptions(maxdepth=MAXDEPTH)
    for kind, a, k, out in calls:
        if kind == "post":
            (seed, q, g, logp, stds, mean, logdet, step0, bar, K, _, _,
             jitter) = a[:13]
            want = nuts_pallas_run(
                seed, *map(_np, (q, g, logp, stds, mean, logdet, step0,
                                 bar)), K, _jax_batched(), jopts, jitter,
                block=B, interpret=True)
            for name in INT_STATS:
                np.testing.assert_array_equal(
                    out[4][name].numpy(), np.asarray(want[4][name]),
                    err_msg=name)
            for i, name in enumerate(("q", "g", "logp", "draws")):
                _close(out[i], want[i], name, 2e-6, 1e-6)
            for name in ("sum_accept", "sum_accept_sym", "step_size"):
                _close(out[4][name], want[4][name], name, 2e-6, 1e-6)
        else:
            seed, flags, q, g, logp, stds, mean, est, sca = a[:9]
            want = nuts_pallas_warmup_run(
                seed, *map(_np, (flags, q, g, logp, stds, mean, est, sca)),
                _jax_batched(), jopts, jnt.DiagNutsSettings().step_size,
                True, block=B, interpret=True, _split=False)
            for name in INT_STATS:
                np.testing.assert_array_equal(
                    out[8][name].numpy(), np.asarray(want[8][name]),
                    err_msg=name)
            for i, name in enumerate(("q", "g", "logp", "stds", "mean",
                                      "est", "sca", "draws")):
                _close(out[i], want[i], name, 1e-4, 1e-4)
    assert sset.jitter is not None
    # the stored posterior draws are the two groups' launches, side by side
    got = trace.posterior["position"]
    np.testing.assert_array_equal(
        got, np.concatenate([posts[0][3][3].numpy(),
                             posts[1][3][3].numpy()], 0))


def test_the_split_validation_is_the_jax_packages():
    model = normal_logp(2, 0.0)
    s = tnt.DiagNutsSettings(num_tune=10, num_draws=10, num_chains=6, seed=0)
    with pytest.raises(ValueError, match="multiple"):
        tnt.Sampler(model, s, max_chains_per_launch=4, device="cpu")
    with pytest.raises(ValueError, match="progress_tick"):
        tnt.Sampler(model, s, max_chains_per_launch=3, progress_tick=2,
                    device="cpu")
    with pytest.raises(NotImplementedError, match="auto"):
        tnt.Sampler(model, s, max_chains_per_launch="auto", device="cpu")
    # the JAX package refuses the same
    with pytest.raises(ValueError, match="multiple"):
        jnt.Sampler(jg.normal_logp(2, 0.0), jnt.DiagNutsSettings(
            num_tune=10, num_draws=10, num_chains=6, seed=0),
            max_chains_per_launch=4)
    # pooled adaptation pools within a launch group, with the JAX
    # package's warning (a pooled flow here: cross-chain adaptation is
    # ROADMAP.md item 17)
    flow = tnt.coupling_flow(tnt.CouplingFlowConfig(num_layers=2, hidden=8,
                                                    train_steps=20))
    fs = tnt.FlowNutsSettings(num_chains=4, num_tune=10, num_draws=10,
                              seed=0, flow_spec=flow)
    with pytest.warns(UserWarning, match="launch group"):
        tnt.Sampler(normal_logp(2, 0.0), fs, max_chains_per_launch=2,
                    device="cpu")
