"""The draw-synchronous MCLMC engine of the port (``kernels/mclmc.py``,
``chain.make_mclmc_draw_step``, ``MclmcSettings.build_phases``) on the CPU,
against the JAX package.

Draw for draw: the batched ``mclmc_draw`` runs against a one-chain oracle
written from the control flow of the JAX ``mclmc_draw``
(``nuts_rs_tpu/kernels/mclmc.py:84-260``: its while loop, its halving stack
and its unwind loop), fed the port's own counter-hash stream, in float64:
every integer stat is equal and the floats agree to 1e-9, for the
microcanonical and the Euclidean dynamics, a case that halves (and unwinds
two levels) and cases that give up.  The adaptation of one draw step equals
the JAX ``make_mclmc_draw_step``'s on the same state and the same draw.  In
distribution: the moments of a run against the JAX sync engine's.  The
plans of ``"sync"`` requests are the JAX package's.
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nuts_rs_tpu as jnt
import nuts_rs_tpu.chain as jchain
import nuts_rs_tpu.kernels.mclmc as jmclmc
import nuts_rs_tpu_torch as tnt
from nuts_rs_tpu.models import gaussian as jg
from nuts_rs_tpu.sampler import _strategy_for
from nuts_rs_tpu_torch import chain as tchain
from nuts_rs_tpu_torch.adapt.schedule import build_schedule
from nuts_rs_tpu_torch.convert import state_from_numpy, state_to_numpy
from nuts_rs_tpu_torch.dynamics.hamiltonian import (
    KineticKind,
    init_point_from_q,
)
from nuts_rs_tpu_torch.kernels import mclmc as tm
from nuts_rs_tpu_torch.kernels.rng import host_normals
from nuts_rs_tpu_torch.models import gaussian as tg
from nuts_rs_tpu_torch.sampler import _schedule_chunk
from nuts_rs_tpu_torch.transform.affine import AffineTransform

F64 = torch.float64


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# (a) draw for draw against a one-chain oracle
# ---------------------------------------------------------------------------


def _target(dim):
    return np.linspace(-1.0, 2.0, dim), np.linspace(0.5, 1.5, dim)


def _setup(dim, C, seed, micro):
    mu, stds = _target(dim)
    mu_t = torch.tensor(mu, dtype=F64)

    def logp_grad(q):
        diff = q - mu_t
        return -0.5 * torch.sum(diff * diff, -1), -diff

    s = torch.tensor(stds, dtype=F64).expand(C, dim).contiguous()
    transform = AffineTransform(
        mean=torch.zeros(C, dim, dtype=F64), stds=s, inv_stds=1.0 / s,
        logdet=torch.log(1.0 / s).sum(-1),
        id=torch.zeros(C, dtype=torch.int32))
    rng = np.random.default_rng(seed)
    q0 = torch.tensor(mu + rng.normal(size=(C, dim)) * stds, dtype=F64)
    pt = init_point_from_q(q0, transform, logp_grad)
    v = rng.normal(size=(C, dim))
    if micro:
        v = v / np.linalg.norm(v, axis=1, keepdims=True)
    return logp_grad, transform, pt._replace(v=torch.tensor(v, dtype=F64))


def _oracle(seed, c, C, pt, transform, step, opts, resample):
    """One chain's MCLMC draw by the JAX ``mclmc_draw``'s control flow, in
    numpy float64, with the port's random sites (``kernels/mclmc.py``)."""
    micro = opts.kind is KineticKind.MICROCANONICAL
    s = transform.stds[c].numpy()
    logdet = float(transform.logdet[c])
    mu, _ = _target(s.shape[0])
    d = s.shape[0]
    ell, H = opts.momentum_decoherence_length, (
        tm.MAX_HALVINGS if opts.dynamic_step_size else 0)

    def normals(it, salts):
        return host_normals(seed, it, *salts, (C, d), "cpu")[c].double() \
            .numpy()

    def evalz(z):
        q = z * s
        lp = -0.5 * np.sum((q - mu) ** 2)
        g = -(q - mu)
        return q, lp, g, g * s

    def esh(zg, v, h):
        gn = math.sqrt(np.sum(zg * zg))
        gh = zg / gn
        alpha = np.sum(v * gh)
        delta = h * gn / (d - 1)
        zeta = math.exp(-delta)
        vr = (1 - zeta) * (1 + zeta + alpha * (1 - zeta)) * gh + 2 * zeta * v
        dke = (delta - math.log(2.0)
               + math.log1p(alpha + (1 - alpha) * zeta * zeta)) * (d - 1)
        return vr / math.sqrt(np.sum(vr * vr)), dke

    def refresh(p, noise, factor):
        half = step * factor / 2.0
        if micro:
            nu = math.sqrt(math.expm1(2.0 * half / ell) / d)
            v = p["v"] + nu * noise
            return dict(p, v=v / math.sqrt(np.sum(v * v)))
        a = math.exp(-half / ell)
        v = a * p["v"] + math.sqrt(1 - a * a) * noise
        return dict(p, v=v, ke=0.5 * np.sum(v * v))

    def energy(p):
        return p["ke"] - (p["lp"] + logdet)

    def leapfrog(p, factor):
        eps = step * factor
        ke = p["ke"]
        if micro:
            v1, dk = esh(p["zg"], p["v"], math.sqrt(d) * eps / 2.0)
            ke += dk
            z1 = p["z"] + eps * math.sqrt(d) * v1
        else:
            v1 = p["v"] + eps / 2.0 * p["zg"]
            z1 = p["z"] + eps * v1
        q1, lp1, g1, zg1 = evalz(z1)
        if micro:
            v2, dk = esh(zg1, v1, math.sqrt(d) * eps / 2.0)
            ke += dk
        else:
            v2 = v1 + eps / 2.0 * zg1
            ke = 0.5 * np.sum(v2 * v2)
        return dict(q=q1, z=z1, g=g1, zg=zg1, v=v2, lp=lp1, ke=ke,
                    idx=p["idx"] + 1)

    q0, g0 = pt.q[c].numpy(), pt.g[c].numpy()
    v0 = pt.v[c].numpy()
    if resample:
        v0 = normals(0, tm.SALT_MOMENTUM)
        if micro:
            v0 = v0 / math.sqrt(np.sum(v0 * v0))
    start = dict(q=q0, z=q0 / s, g=g0, zg=g0 * s, v=v0, lp=float(pt.logp[c]),
                 ke=0.0 if micro else 0.5 * np.sum(v0 * v0), idx=0)
    e0 = energy(start)
    nbase = int(np.clip(np.round(opts.subsample_frequency * ell / step), 1,
                        1e6))
    max_err_base = opts.max_energy_error / nbase
    p, noise = start, normals(0, tm.SALT_NOISE0)
    remaining, factor, stack = nbase, 1.0, []
    steps, time_, diverged, deepest, reason = 0, 0.0, False, 0, 0
    it = 0
    while remaining > 0 and not diverged:
        it += 1
        r = refresh(p, noise, factor)
        new = leapfrog(r, factor)
        err = energy(new) - energy(r)
        bad = (abs(err) >= max_err_base * factor if micro
               else err > max_err_base * factor)
        if bad or not np.isfinite(err):
            if len(stack) >= H:
                diverged, remaining, reason = True, 0, 1
                div = dict(start=r["q"], start_grad=r["g"], start_mom=r["v"],
                           end=new["q"], end_mom=new["v"], err=err)
            else:
                stack.append(remaining)
                deepest = max(deepest, len(stack))
                factor *= 0.5
                remaining = 2
            continue
        p = refresh(new, normals(it, tm.SALT_NOISE1), factor)
        noise = normals(it, tm.SALT_NOISE2)
        remaining -= 1
        steps += 1
        time_ += factor * step
        while remaining == 0 and stack:
            remaining = stack.pop() - 1
            factor *= 2.0
    out = dict(energy_change=energy(p) - e0, diverging=diverged,
               num_steps=steps, average_step_size=time_ / max(steps, 1),
               is_good=(abs(p["idx"]) > 4) if diverged else p["idx"] != 0,
               end=p, deepest=deepest, reason=reason,
               div=div if diverged else None)
    if diverged:
        vf = normals(0, tm.SALT_FAIL_MOMENTUM)
        if micro:
            vf = vf / math.sqrt(np.sum(vf * vf))
        out["point"] = dict(start, v=vf,
                            ke=0.0 if micro else 0.5 * np.sum(vf * vf))
    else:
        out["point"] = p
    return out


MCLMC_CASES = {
    # name: (kind, step, max_energy_error, dynamic_step_size)
    "microcanonical": ("MICROCANONICAL", 0.6, 1000.0, True),
    "euclidean": ("EUCLIDEAN", 0.4, 1000.0, True),
    # a per-step threshold that a step of 1.2 passes now and then: halvings
    # and their unwinds, two levels deep somewhere
    "halving": ("MICROCANONICAL", 1.2, 0.05, True),
    "halving_euclidean": ("EUCLIDEAN", 1.0, 0.02, True),
    # no halving room: the first divergence gives up
    "give_up_fixed_step": ("MICROCANONICAL", 1.2, 0.05, False),
    # ten halvings do not reach the threshold
    "give_up": ("MICROCANONICAL", 2.0, 1e-9, True),
}


@pytest.mark.parametrize("case", list(MCLMC_CASES))
def test_sync_mclmc_matches_the_oracle(case):
    kind, step, max_err, dynamic = MCLMC_CASES[case]
    dim, C, draws = 5, 6, 3
    micro = kind == "MICROCANONICAL"
    logp_grad, transform, pt = _setup(dim, C, len(case), micro)
    opts = tm.MclmcOptions(kind=KineticKind[kind], max_energy_error=max_err,
                           dynamic_step_size=dynamic,
                           store_divergences=True)
    steps = torch.tensor(np.linspace(0.8, 1.2, C) * step, dtype=F64)
    seen = dict(deepest=0, diverging=0, halved=0)
    for dr in range(draws):
        seed = 300 * len(case) + dr
        resample = dr == 0
        new_pt, info = tm.mclmc_draw(seed, pt, transform, steps, logp_grad,
                                     opts, resample)
        for c in range(C):
            want = _oracle(seed, c, C, pt, transform, float(steps[c]), opts,
                           resample)
            label = (case, dr, c)
            assert int(info.num_steps[c]) == want["num_steps"], label
            assert bool(info.diverging[c]) == want["diverging"], label
            assert bool(info.is_good_for_adapt[c]) == bool(want["is_good"])
            assert int(info.divergence.reason[c]) == want["reason"], label
            for got, ref in (
                    (info.energy_change[c], want["energy_change"]),
                    (info.log_weight[c], want["energy_change"]),
                    (info.average_step_size[c], want["average_step_size"]),
                    (info.draw_logp[c], want["end"]["lp"])):
                np.testing.assert_allclose(float(got), ref, rtol=1e-9,
                                           atol=1e-10, err_msg=str(label))
            for name, ref in (("q", "q"), ("z", "z"), ("v", "v"),
                              ("g", "g")):
                np.testing.assert_allclose(
                    getattr(new_pt, name)[c].numpy(), want["point"][ref],
                    rtol=1e-9, atol=1e-10, err_msg=str((label, name)))
            np.testing.assert_allclose(info.draw_q[c].numpy(),
                                       want["end"]["q"], rtol=1e-9,
                                       atol=1e-10)
            np.testing.assert_allclose(float(new_pt.ke[c]),
                                       want["point"]["ke"], rtol=1e-9,
                                       atol=1e-10)
            if want["div"] is not None:
                div = info.divergence
                for got, ref in ((div.start_location, "start"),
                                 (div.start_gradient, "start_grad"),
                                 (div.start_momentum, "start_mom"),
                                 (div.end_location, "end"),
                                 (div.end_momentum, "end_mom")):
                    np.testing.assert_allclose(got[c].numpy(),
                                               want["div"][ref], rtol=1e-9,
                                               atol=1e-10)
                np.testing.assert_allclose(float(div.energy_error[c]),
                                           want["div"]["err"], rtol=1e-9,
                                           atol=1e-12)
            else:
                assert torch.isnan(info.divergence.start_location[c]).all()
            seen["deepest"] = max(seen["deepest"], want["deepest"])
            seen["diverging"] += want["diverging"]
            seen["halved"] += want["deepest"] > 0
        pt = new_pt
    if case.startswith("halving"):
        assert seen["halved"] and not seen["diverging"]
    if case == "halving":
        assert seen["deepest"] >= 2
    if case.startswith("give_up"):
        assert seen["diverging"]
    if case == "give_up":
        assert seen["deepest"] == tm.MAX_HALVINGS


@pytest.mark.parametrize("rem,size,stack,want", [
    (3, 2, [4, 1], (3, 1, 2)),    # nothing to pop
    (0, 0, [], (0, 1, 0)),        # an empty stack leaves rem at 0
    (0, 1, [5], (4, 2, 0)),       # one pop
    (0, 3, [3, 1, 1], (2, 8, 0)),  # the 1s and one more
    (0, 3, [1, 1, 1], (0, 8, 0)),  # every entry
    (0, 3, [2, 4, 1], (3, 4, 1)),  # a 1, then 4 - 1
])
def test_unwind_pops_as_the_jax_loop(rem, size, stack, want):
    """The one-pass unwind against the JAX body's loop of MAX_HALVINGS
    iterations (``kernels/mclmc.py:158-171``) on hand-made stacks."""
    st = torch.zeros(1, tm.MAX_HALVINGS, dtype=torch.int32)
    st[0, :len(stack)] = torch.tensor(stack, dtype=torch.int32)
    r, f, n = tm._unwind(torch.tensor([rem], dtype=torch.int32),
                         torch.tensor([1.0], dtype=F64), st,
                         torch.tensor([size], dtype=torch.int32))
    assert (int(r[0]), float(f[0]), int(n[0])) == want
    # the JAX loop on the same stack
    jr, jf, jst, jn = rem, 1.0, list(stack), size
    for _ in range(tm.MAX_HALVINGS):
        if jr == 0 and jn > 0:
            jr, jf, jn = jst[jn - 1] - 1, jf * 2.0, jn - 1
    assert (jr, jf, jn) == want


# ---------------------------------------------------------------------------
# (b) one draw step's adaptation against the JAX make_mclmc_draw_step
# ---------------------------------------------------------------------------


def _fake_mclmc_draws(dim, C):
    """``mclmc_draw`` of both packages replaced by one made-up draw, whose
    trajectory end differs from the draw, some of whose draws are no good
    for the estimators."""
    def j_draw(key, pt, transform, step_size, logp_grad, opts, resample,
               ops=None):
        q = pt.q + 0.3 * jnp.sin(3.0 * pt.q + step_size)
        logp, g = logp_grad(q)
        end_q = q + 0.1
        end_lp, end_g = logp_grad(end_q)
        z, zg = (q - transform.mean) * transform.inv_stds, g * transform.stds
        draw = pt._replace(q=q, g=g, z=z, zg=zg, logp=logp)
        f = lambda x: jnp.asarray(x, jnp.float32)  # noqa: E731
        info = jmclmc.MclmcInfo(
            energy_change=f(0.05) + 0.01 * q[0], diverging=q[1] > 3.4,
            num_steps=jnp.int32(6), average_step_size=f(0.5),
            log_weight=f(0.05) + 0.01 * q[0],
            divergence=jmclmc._empty_div_info(dim, jnp.float32),
            is_good_for_adapt=q[0] > 0.2, draw_q=end_q, draw_g=end_g,
            draw_logp=end_lp)
        return draw, info

    def t_draw(seed, pt, transform, step_size, logp_grad, opts, resample,
               ops=None):
        q = pt.q + 0.3 * torch.sin(3.0 * pt.q + step_size[:, None])
        logp, g = logp_grad(q)
        end_q = q + 0.1
        end_lp, end_g = logp_grad(end_q)
        z, zg = (q - transform.mean) * transform.inv_stds, g * transform.stds
        draw = pt._replace(q=q, g=g, z=z, zg=zg, logp=logp)
        info = tm.MclmcInfo(
            energy_change=0.05 + 0.01 * q[:, 0], diverging=q[:, 1] > 3.4,
            num_steps=torch.full((C,), 6, dtype=torch.int32),
            average_step_size=torch.full((C,), 0.5),
            log_weight=0.05 + 0.01 * q[:, 0],
            divergence=tm._empty_div_info(C, dim, torch.float32, "cpu",
                                          False),
            is_good_for_adapt=q[:, 0] > 0.2, draw_q=end_q, draw_g=end_g,
            draw_logp=end_lp)
        return draw, info

    return j_draw, t_draw


def test_draw_step_adaptation_matches_the_jax_mclmc_draw_step(monkeypatch):
    """Same state (carried across with ``state_from_numpy``), the same draw
    and ``MclmcInfo`` (both ``mclmc_draw`` replaced by one made-up draw),
    schedule rows with estimator updates, window switches, mass-matrix
    updates and the best-guess step: the transform, the estimators, the
    step state and the stats record agree to 1e-5.  The jitter is off (its
    uniforms come from different generators)."""
    import dataclasses

    dim, C, tune = 4, 6, 40
    kw = dict(num_chains=C, num_tune=tune, num_draws=10)
    js, ts = jnt.DiagMclmcSettings(**kw), tnt.DiagMclmcSettings(**kw)
    jm, tmod = jg.normal_logp(dim, 0.5), tg.normal_logp(dim, 0.5)
    jcfg = js.chain_config()
    jcfg = dataclasses.replace(jcfg, step_size=dataclasses.replace(
        jcfg.step_size, jitter=None))
    tcfg = ts.chain_config()
    tcfg = dataclasses.replace(tcfg, step_size=dataclasses.replace(
        tcfg.step_size, jitter=None))
    jstate = jnt.Sampler(jm, js, dtype=jnp.float32).state
    tstate = state_from_numpy(state_to_numpy(jstate))
    j_draw, t_draw = _fake_mclmc_draws(dim, C)
    monkeypatch.setattr(jmclmc, "mclmc_draw", j_draw)
    monkeypatch.setattr(tm, "mclmc_draw", t_draw)
    micro = js._mclmc_options(jnt.MclmcTrajectoryKind.MICROCANONICAL)
    jstep = jax.jit(jchain.make_mclmc_draw_step(
        jm, _strategy_for(js, jcfg), jcfg, micro))
    tstep = tchain.make_mclmc_draw_step(
        tmod, tchain.DiagStrategy(tcfg), tcfg,
        ts._mclmc_options(tnt.MclmcTrajectoryKind.MICROCANONICAL), 0)
    sched = build_schedule(tune, 10, ts.adapt)
    rows = list(range(tune + 2))
    assert sched.do_switch[rows].any() and sched.do_update[rows].any()
    for r in rows:
        flags = ts.extra_flags(_schedule_chunk(sched, r, r + 1), r, r + 1)
        flags = {k: v[0] for k, v in flags.items()}
        jstate, jstats = jstep(jstate, {k: jnp.asarray(v)
                                        for k, v in flags.items()})
        tstate, tstats = tstep(tstate, {k: bool(v) for k, v in flags.items()})
        got, want = state_to_numpy(tstate), state_to_numpy(jstate)
        for name in want:
            np.testing.assert_allclose(
                np.asarray(got[name], np.float64),
                np.asarray(want[name], np.float64), rtol=1e-5, atol=1e-6,
                err_msg=f"row {r} {name}")
        assert set(tstats) == set(jstats)
        for name, value in jstats.items():
            np.testing.assert_allclose(
                tstats[name].numpy().astype(np.float64),
                np.asarray(value, np.float64), rtol=1e-5, atol=1e-6,
                err_msg=f"row {r} stat {name}")
            assert tstats[name].numpy().dtype == np.asarray(value).dtype, name
    assert int(got["transform_id"].max()) > 2


# ---------------------------------------------------------------------------
# (c) in distribution, and the plans
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["EUCLIDEAN_EARLY_THEN_MICROCANONICAL",
                                  "EUCLIDEAN"])
def test_sync_mclmc_matches_the_jax_sync_engine(kind):
    """Posterior moments of a normal with unequal scales (``mv_normal``,
    which has no kernel hook), the port's sync
    engine against the JAX one at the same settings (different streams):
    every coordinate's mean within 4 Monte-Carlo standard errors of the
    difference (ESS estimated as a tenth of the draws) and its std within
    15%; no divergences in either."""
    sd = np.array([0.5, 1.0, 2.0, 1.5])
    base = dict(num_chains=8, num_tune=150, num_draws=250,
                trajectory_kind=None)
    tkw = dict(base, trajectory_kind=tnt.MclmcTrajectoryKind[kind])
    jkw = dict(base, trajectory_kind=jnt.MclmcTrajectoryKind[kind])
    trace = tnt.sample(tg.mv_normal(np.diag(sd ** 2)),
                       tnt.DiagMclmcSettings(seed=3, **tkw), device="cpu")
    jtrace = jnt.sample(jg.mv_normal(np.diag(sd ** 2)),
                        jnt.DiagMclmcSettings(seed=4, **jkw), chunk_size=400)
    pos = trace.posterior["position"].astype(np.float64)
    jpos = np.asarray(jtrace.posterior["position"], np.float64)
    n_eff = pos.shape[0] * pos.shape[1] / 10.0
    se = np.sqrt(2.0 / n_eff) * sd
    assert np.all(np.abs(pos.mean((0, 1)) - jpos.mean((0, 1))) < 4 * se)
    np.testing.assert_allclose(pos.std((0, 1)), jpos.std((0, 1)), rtol=0.15)
    np.testing.assert_allclose(pos.std((0, 1)), sd, rtol=0.2)
    assert not trace.sample_stats["diverging"].any()
    assert not np.asarray(jtrace.sample_stats["diverging"]).any()
    n = trace.sample_stats["n_steps"].mean()
    jn = np.asarray(jtrace.sample_stats["n_steps"]).mean()
    assert abs(n - jn) < 0.3, (n, jn)


def _kinds(phases):
    return [(lo, hi, "sync" if isinstance(r, functools.partial)
             or "sync" in r.__qualname__ else "fused")
            for lo, hi, r in phases]


@pytest.mark.parametrize("tune,draws,kind", [
    (300, 700, "EUCLIDEAN_EARLY_THEN_MICROCANONICAL"),
    (40, 0, "EUCLIDEAN_EARLY_THEN_MICROCANONICAL"),
    (0, 20, "EUCLIDEAN_EARLY_THEN_MICROCANONICAL"),
    (50, 30, "MICROCANONICAL"),
    (50, 30, "EUCLIDEAN"),
])
def test_sync_plans_are_the_jax_packages(tune, draws, kind):
    """``posterior_kernel="sync"``, the default: the sync engine throughout,
    split at the trajectory switch, in both packages, with no warning; a
    phase's runner takes that phase's dynamics."""
    import warnings

    kw = dict(num_chains=4, num_tune=tune, num_draws=draws)
    js = jnt.DiagMclmcSettings(trajectory_kind=jnt.MclmcTrajectoryKind[kind],
                               **kw)
    ts = tnt.DiagMclmcSettings(trajectory_kind=tnt.MclmcTrajectoryKind[kind],
                               **kw)
    jcfg = js.chain_config()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        want = _kinds(js.build_phases(jg.normal_logp(3),
                                      _strategy_for(js, jcfg), jcfg))
        got = _kinds(ts.build_phases(tg.normal_logp(3), ts.chain_config(),
                                     "cuda"))
    assert got == want
    assert {k for _, _, k in got} == {"sync"}


def test_default_settings_run_on_the_cpu():
    """``sample(model, DiagMclmcSettings(...))`` with the default
    ``posterior_kernel="sync"`` used to raise naming item 8."""
    trace = tnt.sample(tg.normal_logp(10, 3.0), tnt.DiagMclmcSettings(
        num_chains=4, num_tune=20, num_draws=20), device="cpu")
    pos = trace.posterior["position"]
    assert pos.shape == (4, 20, 10) and np.isfinite(pos).all()
    st = trace.sample_stats
    assert st["n_steps"].dtype == np.int32 and (st["n_steps"] >= 5).all()
    assert trace.warmup_sample_stats["tuning"].all()
    assert not st["tuning"].any()
