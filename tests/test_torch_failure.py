"""The port's stuck-chain detector (``fail_after``, ``ChainFailedError``;
``Sampler._same_as_before`` and ``_detect_failed_chains``) against the JAX
package's on the CPU: the nan-wall model of ``tests/test_failure.py``, where
every chain freezes, and a mixed run, where some chains freeze and the
others move, name the same chains at the same draw in both packages; a
chain whose real moves a float16 copy would round away is not named;
healthy chains on either engine are never named."""

import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nuts_rs_tpu as jnt
import nuts_rs_tpu_torch as tnt
from nuts_rs_tpu.models.model import Model as JModel
from nuts_rs_tpu_torch.models.gaussian import normal_logp
from nuts_rs_tpu_torch.models.model import Model as TModel

FROZEN_AT = 100.0  # the mixed model's one finite point beyond q[0] >= 5


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _nan_wall(pkg, dim=4):
    """logp finite only at the bit-exact origin (``tests/test_failure.py``
    ``_nan_wall_model``): every proposal diverges and no chain moves."""
    if pkg == "jax":
        def logp(q):
            return jnp.where(jnp.any(q != 0.0), jnp.nan,
                             -0.5 * jnp.sum(jnp.square(q)))

        return JModel(logp_fn=logp, dim=dim, name="nan_wall")

    def logp(q):
        return torch.where((q != 0.0).any(), torch.nan,
                           -0.5 * torch.sum(q * q))

    return TModel(logp_fn=logp, dim=dim, name="nan_wall")


def _mixed(pkg, dim=3):
    """A normal below q[0] = 5; beyond it logp is NaN but at the bit-exact
    point (100, ..., 100): a chain started there never moves, a chain
    started at the origin is healthy."""
    if pkg == "jax":
        def logp(q):
            ok = (q[0] < 5.0) | jnp.all(q == FROZEN_AT)
            return jnp.where(ok, -0.5 * jnp.sum(jnp.square(q)), jnp.nan)

        return JModel(logp_fn=logp, dim=dim, name="mixed")

    def logp(q):
        ok = (q[0] < 5.0) | (q == FROZEN_AT).all()
        return torch.where(ok, -0.5 * torch.sum(q * q), torch.nan)

    return TModel(logp_fn=logp, dim=dim, name="mixed")


def _both(model_fn, init, drive, fail_after, chunk_size, fixed_step=False,
          **kw):
    """The same run in both packages, driven by ``drive`` ("run" or
    "wait_timeout"); returns (sampler, ChainFailedError) per package.
    ``fixed_step``: the step size stays at its fixed value (jittered)."""
    out = {}
    for pkg, mod in (("jax", jnt), ("torch", tnt)):
        if fixed_step:
            kw["step_size"] = mod.StepSizeSettings(
                method=mod.StepSizeMethod.FIXED, fixed_value=0.1)
        settings = mod.DiagNutsSettings(num_chains=len(init), **kw)
        extra = {} if pkg == "jax" else {"device": "cpu"}
        s = mod.Sampler(model_fn(pkg), settings, chunk_size=chunk_size,
                        init_positions=init, fail_after=fail_after, **extra)
        with pytest.raises(mod.ChainFailedError) as err:
            s.run() if drive == "run" else s.wait_timeout(600.0)
        out[pkg] = (s, err.value)
    return out


@pytest.mark.parametrize("drive", ["run", "wait_timeout"])
def test_nan_wall_names_every_chain_at_the_jax_draw(drive):
    """At a fixed step size.  Under dual averaging the nan wall's step size
    shrinks every draw and underflows to 0 in float32 (the port's state,
    and the JAX package's on the chip); a draw at step 0 stays put without
    diverging, so the detector stops counting (the last test below).  The
    JAX test of this model runs in float64, where it does not."""
    init = np.zeros((4, 4))
    out = _both(_nan_wall, init, drive, 48, 32, fixed_step=True,
                num_tune=200, num_draws=200, seed=3)
    (js, jerr), (ts, terr) = out["jax"], out["torch"]
    assert terr.chains == jerr.chains == [0, 1, 2, 3]
    assert [p.failed for p in ts.progress] == [p.failed for p in js.progress]
    assert all("unrecoverable" in p.error for p in ts.progress)
    # two chunks of 32: the streak is 63 >= 48 at draw 64 (the run's first
    # draw counts as moved); run() launches the next chunk before it
    # finishes this one, in both packages, so it stops one chunk later,
    # at the JAX run()'s draw, and wait_timeout() at draw 64
    assert ts._next_draw == js._next_draw == (96 if drive == "run" else 64)
    np.testing.assert_array_equal(ts._div_streak[:4], js._div_streak[:4])
    np.testing.assert_array_equal(ts._div_streak[:4],
                                  95 if drive == "run" else 63)
    pos = terr.trace.warmup_posterior["position"]
    assert pos.shape == (4, ts._next_draw, 4) and not pos.any()
    assert terr.trace.warmup_sample_stats["diverging"].all()


def test_mixed_run_names_the_frozen_chains_only():
    """At a fixed step size too: under dual averaging the frozen chains'
    steps shrink until, in float32, a proposal rounds back onto the start
    (ulp 7.6e-6 at 100) and that draw does not diverge."""
    init = np.full((4, 3), 0.5)
    init[[1, 3]] = FROZEN_AT
    out = _both(_mixed, init, "wait_timeout", 24, 16, fixed_step=True,
                num_tune=60, num_draws=60, seed=5)
    (js, jerr), (ts, terr) = out["jax"], out["torch"]
    assert terr.chains == jerr.chains == [1, 3]
    assert ts._next_draw == js._next_draw == 32
    assert ([p.failed for p in ts.progress]
            == [p.failed for p in js.progress] == [False, True, False, True])
    pos = terr.trace.warmup_posterior["position"]
    assert (pos[[1, 3]] == FROZEN_AT).all()
    # the healthy chains moved
    assert np.ptp(pos[[0, 2]], axis=1).min() > 0


def test_float16_copy_does_not_freeze_a_slow_healthy_chain():
    """The equality mask is taken on the float32 positions before
    ``draw_dtype`` casts them (``test_control_surface.py::
    test_draw_dtype_failure_detector_full_precision``): chain 0 moves by
    0.05 around 2048, where a float16 step is 2, so its stored copy is
    bit-equal draw to draw; chain 1 is frozen."""
    model = normal_logp(2, 0.0)
    settings = tnt.DiagNutsSettings(num_tune=4, num_draws=4, num_chains=2,
                                    seed=0)
    s = tnt.Sampler(model, settings, chunk_size=4, draw_dtype=np.float16,
                    fail_after=3, device="cpu")
    k, C, d = 4, 2, 2
    pos = torch.full((k, C, d), 2048.0)
    for j in range(k):
        pos[j, 0] += j * 0.05
    stats = {"position": pos,
             "diverging": torch.ones(k, C, dtype=torch.bool),
             "n_steps": torch.ones(k, C, dtype=torch.int32),
             "step_size": torch.full((k, C), 0.1)}
    s._next_draw = k  # as if the chunk had been launched
    _, out, _ = s._finish_chunk(s._start_copies(0, k, stats,
                                                time.monotonic()))
    p16 = out["position"][0]
    assert p16.dtype == np.float16 and (p16[1:] == p16[:-1]).all()
    assert not s.progress[0].failed and s._div_streak[0] == 0
    assert s.progress[1].failed and s._failed_chains == [1]
    assert s._last_pos.dtype == torch.float32
    np.testing.assert_array_equal(s._last_pos[0].numpy(), pos[-1, 0].numpy())


def test_streak_runs_across_chunks_and_none_disables():
    model = _nan_wall("torch", dim=2)
    settings = tnt.DiagNutsSettings(
        num_tune=100, num_draws=100, num_chains=2, seed=7,
        step_size=tnt.StepSizeSettings(method=tnt.StepSizeMethod.FIXED,
                                       fixed_value=0.1))
    s = tnt.Sampler(model, settings, chunk_size=16, device="cpu",
                    init_positions=np.zeros((2, 2)), fail_after=24)
    with pytest.raises(tnt.ChainFailedError):
        s.run()
    # 15 + 16 = 31 >= 24 after two chunks; run() stores the third, which
    # it launched before it finished the second, as the JAX run() does
    assert s._next_draw == 48
    assert [p.failed for p in s.progress] == [True, True]
    off = tnt.Sampler(model, settings, chunk_size=50, device="cpu",
                      init_positions=np.zeros((2, 2)), fail_after=None)
    trace = off.run()
    assert not any(p.failed for p in off.progress)
    assert trace.posterior["position"].shape == (2, 100, 2)


@pytest.mark.parametrize("kernel", ["sync", "pallas"])
def test_healthy_chains_never_trip_the_detector(kernel):
    settings = tnt.DiagNutsSettings(num_tune=40, num_draws=40, num_chains=4,
                                    seed=1, posterior_kernel=kernel)
    s = tnt.Sampler(normal_logp(3, 0.0), settings, chunk_size=20,
                    fail_after=5, device="cpu")
    trace = s.run()
    assert not any(p.failed for p in s.progress)
    assert trace.posterior["position"].shape == (4, 40, 3)


def test_float32_dual_averaging_hides_the_nan_wall_in_both_packages():
    """The finding behind the fixed step above: under dual averaging the
    nan wall's step size underflows to 0 in float32 within three chunks of
    32 draws, in the port and in the JAX package run at float32 alike; a
    draw at (or near) step 0 does not diverge, so neither detector names a
    chain by draw 96, where the fixed step's names all four at 64 (maxdepth
    3 keeps the undiverging trees short)."""
    init = np.zeros((4, 4))
    for pkg, mod in (("jax", jnt), ("torch", tnt)):
        extra = ({"dtype": jnp.float32} if pkg == "jax"
                 else {"device": "cpu"})
        s = mod.Sampler(_nan_wall(pkg), mod.DiagNutsSettings(
            num_chains=4, num_tune=200, num_draws=200, seed=3, maxdepth=3),
            chunk_size=32, init_positions=init, fail_after=48, **extra)
        for _ in range(3):
            _, stats, _ = s.run_next_chunk()
        assert (np.asarray(stats["step_size"])[:, -1] == 0).all(), pkg
        # draws that did not diverge in the last chunk broke every streak
        assert not np.asarray(stats["diverging"]).all(axis=1).any(), pkg
        assert (s._div_streak < 48).all(), pkg
        assert not any(p.failed for p in s.progress), pkg
