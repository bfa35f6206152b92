"""The draw-synchronous NUTS engine of the port (``kernels/nuts.py``,
``chain.make_draw_step``, ``NutsSettings.build_phases``) on the CPU, against
the JAX package.

Draw for draw: the batched tree is fed its own counter-hash stream one chain
at a time into the naive recursive tree of tests/test_kernel_equivalence.py
(the oracle of the JAX ``nuts_draw``), and, for the tree options the oracle
lacks, into the JAX ``_tree_body`` itself, whose three uniforms per
iteration are replaced by the port's.  In float64 every integer stat is
equal and the floats agree to 1e-9.  In distribution: moments of a normal
and of a regression against the JAX sync engine.  The adaptation of one draw
step equals the JAX ``make_draw_step``'s on the same state and the same
draw.  ``build_phases`` plans what the JAX package plans.
"""

import functools

import hypothesis
import hypothesis.strategies as st
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_kernel_equivalence import NaivePoint, naive_tree_draw, naive_turning

import nuts_rs_tpu as jnt
import nuts_rs_tpu.chain as jchain
import nuts_rs_tpu.kernels.nuts as jnuts
import nuts_rs_tpu_torch as tnt
from nuts_rs_tpu.dynamics import hamiltonian as jham
from nuts_rs_tpu.dynamics.point import Point as JPoint
from nuts_rs_tpu.models import gaussian as jg
from nuts_rs_tpu.sampler import _strategy_for
from nuts_rs_tpu.transform.affine import identity_transform as j_identity
from nuts_rs_tpu.transform.ops import AFFINE_OPS
from nuts_rs_tpu_torch import chain as tchain
from nuts_rs_tpu_torch.adapt.schedule import build_schedule
from nuts_rs_tpu_torch.convert import state_from_numpy, state_to_numpy
from nuts_rs_tpu_torch.dynamics.hamiltonian import (
    KineticKind,
    init_point_from_q,
    is_turning,
    sample_momentum,
)
from nuts_rs_tpu_torch.kernels import nuts as tnuts
from nuts_rs_tpu_torch.kernels.rng import host_uniform
from nuts_rs_tpu_torch.models import gaussian as tg
from nuts_rs_tpu_torch.models.model import Model
from nuts_rs_tpu_torch.sampler import _schedule_chunk
from nuts_rs_tpu_torch.transform.affine import AffineTransform

F64 = torch.float64


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# (a) draw for draw
# ---------------------------------------------------------------------------


def _target(dim):
    mu = np.linspace(-2.0, 3.0, dim)
    stds = np.linspace(0.5, 2.0, dim)
    return mu, stds


def _torch_setup(dim, C, seed):
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
    q0 = torch.tensor(np.random.default_rng(seed).normal(size=(C, dim)),
                      dtype=F64)
    return logp_grad, transform, init_point_from_q(q0, transform, logp_grad)


class HashUniforms:
    """Chain ``c``'s sites of the port's stream for one draw
    (``kernels/nuts.py``), as the naive recursive tree asks for them."""

    def __init__(self, seed, c, C):
        self.seed, self.c, self.C, self.it = seed, c, C, 0

    def _u(self, it, salt):
        return float(host_uniform(self.seed, it, salt, (self.C,),
                                  "cpu")[self.c])

    def initial_direction(self):
        return 1 if self._u(0, tnuts.SALT_FIRST_DIRECTION) < 0.5 else -1

    def next3(self):
        self.it += 1
        return tuple(self._u(self.it, salt) for salt in (
            tnuts.SALT_SELECT, tnuts.SALT_ACCEPT, tnuts.SALT_DIRECTION))


NAIVE_CASES = {
    # name: (dim, step, maxdepth, max_energy_error)
    "d3_step0.9": (3, 0.9, 6, 1000.0),
    "d3_step0.4": (3, 0.4, 6, 1000.0),
    "d3_step0.15": (3, 0.15, 6, 1000.0),
    "d3_step0.06": (3, 0.06, 6, 1000.0),
    "d7_step0.9": (7, 0.9, 6, 1000.0),
    "d7_step0.3": (7, 0.3, 6, 1000.0),
    "d7_step0.1": (7, 0.1, 6, 1000.0),
    "d7_step0.04": (7, 0.04, 6, 1000.0),
    "divergence": (3, 1.7, 6, 0.4),
    "maxdepth_hit": (7, 0.01, 4, 1000.0),
}


@pytest.mark.parametrize("case", list(NAIVE_CASES))
def test_sync_engine_matches_naive_tree(case):
    dim, step, maxdepth, max_err = NAIVE_CASES[case]
    C, draws = 4, 4
    mu, stds = _target(dim)
    logp_grad, transform, pt = _torch_setup(dim, C, seed=len(case))
    opts = tnuts.NutsOptions(maxdepth=maxdepth, max_energy_error=max_err)
    step_t = torch.full((C,), step, dtype=F64)

    def eval_z(z1):
        q1 = z1 * stds
        return -0.5 * np.sum((q1 - mu) ** 2), -(q1 - mu) * stds

    seen = dict(diverging=False, maxdepth=False)
    for d in range(draws):
        seed = 1000 * len(case) + d
        new_pt, info = tnuts.nuts_draw(seed, pt, transform, step_t,
                                       logp_grad, opts)
        v0 = sample_momentum(seed, 0, *tnuts.SALT_MOMENTUM, (C, dim), F64,
                             "cpu", KineticKind.EUCLIDEAN).numpy()
        for c in range(C):
            z0 = (pt.q[c] / transform.stds[c]).numpy()
            zg0 = (pt.g[c] * transform.stds[c]).numpy()
            pt0 = NaivePoint(z0, v0[c], zg0, float(pt.logp[c]),
                             0.5 * float(np.sum(v0[c] * v0[c])), 0)
            want = naive_tree_draw(pt0, step, opts, HashUniforms(seed, c, C),
                                   eval_z, float(transform.logdet[c]), np,
                                   max_err)
            label = (case, d, c)
            assert int(info.depth[c]) == want["depth"], label
            assert int(info.n_steps[c]) == want["n_steps"], label
            assert bool(info.diverging[c]) == want["diverging"], label
            assert bool(info.turning[c]) == want["turning"], label
            assert int(info.idx_in_trajectory[c]) == want["idx"], label
            assert bool(info.reached_maxdepth[c]) == want[
                "reached_maxdepth"], label
            np.testing.assert_allclose(new_pt.z[c].numpy(), want["z"],
                                       rtol=1e-10, atol=1e-12,
                                       err_msg=str(label))
            np.testing.assert_allclose(float(info.sum_accept[c]),
                                       want["sum_accept"], rtol=1e-9,
                                       atol=1e-10, err_msg=str(label))
            seen["diverging"] |= want["diverging"]
            seen["maxdepth"] |= want["reached_maxdepth"]
        # the energies the draw reports are the selected point's
        np.testing.assert_allclose(
            info.energy.numpy(),
            (new_pt.ke - (new_pt.logp + new_pt.logdet)).numpy(), rtol=1e-12)
        assert (info.n_steps >= 1).all()
        pt = new_pt
    if case == "divergence":
        assert seen["diverging"]
    if case == "maxdepth_hit":
        assert seen["maxdepth"]


def test_the_naive_cases_reach_every_depth():
    """The step sizes of ``NAIVE_CASES`` give trees of depth 1 to 6."""
    seen = set()
    for case, (dim, step, maxdepth, max_err) in NAIVE_CASES.items():
        if max_err != 1000.0 or maxdepth != 6:
            continue
        logp_grad, transform, pt = _torch_setup(dim, 16, seed=len(case))
        _, info = tnuts.nuts_draw(
            1000 * len(case), pt, transform,
            torch.full((16,), step, dtype=F64), logp_grad,
            tnuts.NutsOptions(maxdepth=6))
        seen |= set(info.depth.tolist())
    assert seen >= {1, 2, 3, 4, 5, 6}, seen


def _jax_draw(monkeypatch, pt, v0, rand_dir, step, jopts, uniforms):
    """One chain's draw by the JAX ``_tree_body`` with the given momentum and
    uniforms in place of its threefry stream."""
    dim = pt.q.shape[0]
    mu, stds = _target(dim)
    mu_j, stds_j = jnp.asarray(mu), jnp.asarray(stds)

    def logp_grad(q):
        return -0.5 * jnp.sum((q - mu_j) ** 2), -(q - mu_j)

    t = j_identity(dim, jnp.float64)._replace(stds=stds_j,
                                              inv_stds=1.0 / stds_j)
    t = t._replace(logdet=jnp.sum(jnp.log(t.inv_stds)))
    q = jnp.asarray(pt.q.numpy())
    g = jnp.asarray(pt.g.numpy())
    jpt = JPoint(q=q, g=g, z=q * t.inv_stds, zg=g * t.stds,
                 v=jnp.asarray(v0), logp=jnp.asarray(float(pt.logp)),
                 logdet=t.logdet, ke=jnp.zeros((), jnp.float64),
                 idx=jnp.zeros((), jnp.int32))
    pt0 = jham.initialize_trajectory(jax.random.key(0), jpt, t, jopts.kind,
                                     resample_velocity=False)
    box = [None]
    monkeypatch.setattr(jax.random, "uniform",
                        lambda key, shape=(), dtype=None, **kw: box[0])

    @jax.jit
    def body(carry, r3):
        box[0] = r3
        return jnuts._tree_body(carry, t, logp_grad, jopts, AFFINE_OPS)

    carry = jnuts._init_tree_carry(jax.random.key(1), pt0,
                                   jnp.asarray(step), jopts,
                                   jnp.asarray(rand_dir))
    it = 1
    while not bool(jnuts._tree_finished(carry)):
        carry = body(carry, jnp.asarray(uniforms(it), jnp.float64))
        it += 1
    return jnuts._extract_info(carry)


OPTION_CASES = {
    "default": dict(maxdepth=5),
    "mindepth": dict(maxdepth=5, mindepth=2),
    "extra_doublings": dict(maxdepth=6, extra_doublings=1),
    "no_turning_checks": dict(maxdepth=4, check_turning=False),
    # ceil(2.3 / step) = 5, 10, 3 leapfrogs: no power of two, where XLA's
    # log2 (2.9999999999999996 at 8) and the tensor library's (3) floor apart
    "target_integration_time": dict(maxdepth=6, target_integration_time=2.3),
    "microcanonical": dict(maxdepth=4, kind="MICROCANONICAL"),
    "divergence": dict(maxdepth=5, max_energy_error=0.3),
}


@pytest.mark.parametrize("case", list(OPTION_CASES))
@pytest.mark.parametrize("dim", [3, 7])
def test_sync_engine_matches_the_jax_tree_body(monkeypatch, case, dim):
    kw = dict(OPTION_CASES[case])
    kind = kw.pop("kind", "EUCLIDEAN")
    C = 3
    logp_grad, transform, pt = _torch_setup(dim, C, seed=dim)
    opts = tnuts.NutsOptions(kind=KineticKind[kind], **kw)
    jopts = jnuts.NutsOptions(kind=jham.KineticKind[kind], **kw)
    step = torch.tensor([0.5, 0.25, 0.9], dtype=F64)
    if case == "divergence":
        step = step * 3.0
    seed = 77 + dim
    new_pt, info = tnuts.nuts_draw(seed, pt, transform, step, logp_grad,
                                   opts)
    v0 = sample_momentum(seed, 0, *tnuts.SALT_MOMENTUM, (C, dim), F64, "cpu",
                         opts.kind).numpy()
    dir0 = host_uniform(seed, 0, tnuts.SALT_FIRST_DIRECTION, (C,), "cpu")
    for c in range(C):
        one = type(pt)(*(x[c] for x in pt))
        draw, want = _jax_draw(
            monkeypatch, one, v0[c], float(dir0[c]), float(step[c]), jopts,
            lambda it: [float(u[c]) for u in tnuts.tree_uniforms(
                seed, it, C, "cpu")])
        label = (case, dim, c)
        for name in ("depth", "n_steps", "idx_in_trajectory"):
            assert int(getattr(info, name)[c]) == int(getattr(want, name)), \
                (label, name)
        for name in ("reached_maxdepth", "diverging", "turning",
                     "is_good_for_adapt"):
            assert bool(getattr(info, name)[c]) == bool(
                getattr(want, name)), (label, name)
        assert int(info.divergence.reason[c]) == int(want.divergence.reason)
        for name in ("sum_accept", "sum_accept_sym", "energy",
                     "energy_error", "initial_energy", "max_energy_error"):
            np.testing.assert_allclose(
                float(getattr(info, name)[c]), float(getattr(want, name)),
                rtol=1e-9, atol=1e-10, err_msg=str((label, name)))
        for name in ("q", "g", "z", "zg", "v"):
            np.testing.assert_allclose(
                getattr(new_pt, name)[c].numpy(),
                np.asarray(getattr(draw, name)), rtol=1e-9, atol=1e-11,
                err_msg=str((label, name)))
    if case == "mindepth":
        assert (info.depth >= 2).all()
    if case == "no_turning_checks":
        assert (info.depth == 4).all() and info.reached_maxdepth.all()
    if case == "divergence":
        assert info.diverging.any()
    if case == "target_integration_time":
        # depths between floor and ceil of log2(ceil(2.3 / step))
        assert ((info.depth >= torch.tensor([2, 3, 1]))
                & (info.depth <= torch.tensor([3, 4, 2]))).all()


def test_float32_draws_are_close_to_float64_ones():
    """The engine works in the dtype of its point: in float32 the same seed
    gives the same trees wherever no decision sits on a rounding, and
    positions to float32 rounding."""
    dim, C = 5, 8
    logp_grad, transform, pt = _torch_setup(dim, C, seed=2)
    step = torch.full((C,), 0.4, dtype=F64)
    opts = tnuts.NutsOptions(maxdepth=6)
    a_pt, a = tnuts.nuts_draw(5, pt, transform, step, logp_grad, opts)
    # (a diagonal transform's low-rank fields are None)
    f = lambda x: x.float() if x is not None and x.is_floating_point() \
        else x  # noqa: E731
    pt32 = type(pt)(*(f(x) for x in pt))
    t32 = type(transform)(*(f(x) for x in transform))

    def logp_grad32(q):
        lp, g = logp_grad(q.double())
        return lp.float(), g.float()

    b_pt, b = tnuts.nuts_draw(5, pt32, t32, step.float(), logp_grad32, opts)
    assert b_pt.q.dtype == torch.float32
    same = (a.n_steps == b.n_steps) & (a.idx_in_trajectory
                                       == b.idx_in_trajectory)
    assert same.float().mean() >= 0.75
    np.testing.assert_allclose(b_pt.q[same].numpy(), a_pt.q[same].numpy(),
                               rtol=1e-4, atol=1e-5)


_finite = st.floats(min_value=-1e6, max_value=1e6, allow_nan=False,
                    allow_subnormal=False, width=64)


@hypothesis.settings(max_examples=150, deadline=None)
@hypothesis.given(st.lists(st.tuples(_finite, _finite, _finite, _finite),
                           min_size=1, max_size=6),
                  st.integers(-5, 5), st.integers(-5, 5))
def test_is_turning_matches_the_naive_criterion(rows, i1, i2):
    """Against the sorted-index form of tests/test_kernel_equivalence.py.
    Subnormal coordinates are excluded (their products flush differently
    between numpy and the tensor library); a dot within rounding of zero
    decides nothing and is skipped."""
    z1, v1, z2, v2 = (np.array(col, np.float64) for col in zip(*rows))
    a, b = (NaivePoint(z1, v1, None, 0.0, 0.0, i1),
            NaivePoint(z2, v2, None, 0.0, 0.0, i2))
    lo, hi = (a, b) if a.idx <= b.idx else (b, a)
    dots = np.array([np.sum((hi.z - lo.z) * lo.v),
                     np.sum((hi.z - lo.z) * hi.v)])
    scale = np.sum(np.abs(hi.z - lo.z) * (np.abs(lo.v) + np.abs(hi.v)))
    hypothesis.assume(np.all(np.abs(dots) > 1e-9 * scale) or scale == 0.0)
    t = lambda x: torch.tensor(x)[None]  # noqa: E731
    got = is_turning(t(z1), t(v1), torch.tensor([i1]), t(z2), t(v2),
                     torch.tensor([i2]))
    assert bool(got[0]) == naive_turning(a, b, np)


# ---------------------------------------------------------------------------
# (b) in distribution
# ---------------------------------------------------------------------------


def test_sync_engine_samples_a_normal():
    trace = tnt.sample(tg.normal_logp(10, 3.0), tnt.DiagNutsSettings(
        num_chains=8, num_tune=200, num_draws=300, posterior_kernel="sync"),
        device="cpu")
    pos = trace.posterior["position"].astype(np.float64)
    assert pos.shape == (8, 300, 10)
    assert abs(pos.mean() - 3.0) < 0.1
    assert abs(pos.std() - 1.0) < 0.1
    st_ = trace.sample_stats
    assert not st_["diverging"].any()
    assert 0.7 < st_["mean_tree_accept"].mean() < 0.95
    ws = trace.warmup_sample_stats
    assert ws["tuning"].all() and not st_["tuning"].any()
    tid = ws["transformation_index"]
    assert (np.diff(tid, axis=1) >= 0).all() and (tid[:, -1] > 0).all()
    for name, dtype in (("depth", np.int32), ("n_steps", np.int32),
                        ("diverging", np.bool_), ("step_size", np.float32),
                        ("fisher_distance", np.float32),
                        ("index_in_trajectory", np.int32)):
        assert st_[name].dtype == dtype, name


def test_sync_engine_matches_the_jax_sync_engine_on_a_regression():
    base = dict(num_tune=150, num_draws=250, num_chains=8,
                posterior_kernel="sync")
    trace = tnt.sample(tg.logistic_regression(200, 5, 3),
                       tnt.DiagNutsSettings(seed=5, **base), device="cpu")
    jtrace = jnt.sample(jg.logistic_regression(200, 5, 3),
                        jnt.DiagNutsSettings(seed=6, **base), chunk_size=400)
    pos = trace.posterior["position"].astype(np.float64)
    jpos = np.asarray(jtrace.posterior["position"], np.float64)
    std = jpos.std((0, 1))
    assert np.all(np.abs(pos.mean((0, 1)) - jpos.mean((0, 1))) < 0.25 * std)
    np.testing.assert_allclose(pos.std((0, 1)), std, rtol=0.25)
    assert not trace.sample_stats["diverging"].any()
    step = np.median(trace.sample_stats["step_size_bar"][:, -1])
    jstep = np.median(np.asarray(jtrace.sample_stats["step_size_bar"])[:, -1])
    assert abs(np.log(step / jstep)) < 0.3, (step, jstep)


def test_a_model_without_a_closed_form_runs_on_torch_func():
    model = Model(logp_fn=lambda q: -0.5 * torch.sum((q - 1.0) ** 2), dim=4)
    trace = tnt.sample(model, tnt.DiagNutsSettings(
        num_chains=8, num_tune=100, num_draws=150, posterior_kernel="sync"),
        device="cpu")
    pos = trace.posterior["position"]
    assert abs(pos.mean() - 1.0) < 0.15 and abs(pos.std() - 1.0) < 0.15


def test_fused_warmup_accept_statistic_matches_the_sync_engine():
    """The fused warmup's plain version and the sync engine adapt alike, as
    tests/test_pallas_warmup.py::test_pallas_warmup_adaptation_matches_xla
    holds the JAX engines: acceptance in range, step sizes within 30%."""
    base = dict(num_tune=150, num_draws=60, num_chains=8, seed=9)
    traces = {kind: tnt.sample(tg.normal_logp(6, 1.0), tnt.DiagNutsSettings(
        posterior_kernel=kind, **base), device="cpu")
        for kind in ("pallas", "sync")}
    for trace in traces.values():
        acc = trace.sample_stats["mean_tree_accept"].mean()
        assert 0.7 < acc < 0.95, acc
        late = trace.warmup_sample_stats["mean_tree_accept_sym"][:, -40:]
        assert 0.7 < late.mean() < 0.92
    steps = [t.sample_stats["step_size_bar"][:, -1].mean()
             for t in traces.values()]
    assert abs(np.log(steps[0] / steps[1])) < 0.3, steps


# ---------------------------------------------------------------------------
# (c) one draw step's adaptation against the JAX make_draw_step
# ---------------------------------------------------------------------------


def _fake_draw_jax(pt, step_size, logp_grad):
    """A made-up draw that both packages compute alike from the point."""
    q = pt.q + 0.3 * jnp.sin(3.0 * pt.q + step_size)
    logp, g = logp_grad(q)
    n = jnp.int32(7)
    acc = 0.5 + 0.4 * jnp.cos(q[0])
    idx = jnp.where(q[0] > 0.2, jnp.int32(3), jnp.int32(0))
    return q, logp, g, n, acc, idx


def _fake_draw_torch(pt, step_size, logp_grad):
    q = pt.q + 0.3 * torch.sin(3.0 * pt.q + step_size[:, None])
    logp, g = logp_grad(q)
    n = torch.full(q.shape[:1], 7, dtype=torch.int32)
    acc = 0.5 + 0.4 * torch.cos(q[:, 0])
    idx = torch.where(q[:, 0] > 0.2, 3, 0).to(torch.int32)
    return q, logp, g, n, acc, idx


def _fake_nuts_draws(dim, C, always_good=False):
    """``nuts_draw`` of both packages replaced by one made-up draw and its
    ``NutsInfo``."""
    def j_nuts_draw(key, pt, transform, step_size, logp_grad, opts, ops=None):
        q, logp, g, n, acc, idx = _fake_draw_jax(pt, step_size, logp_grad)
        z, zg = (q - transform.mean) * transform.inv_stds, g * transform.stds
        draw = pt._replace(q=q, g=g, z=z, zg=zg, logp=logp)
        f = lambda x: jnp.asarray(x, jnp.float32)  # noqa: E731
        info = jnuts.NutsInfo(
            depth=jnp.int32(3), reached_maxdepth=jnp.asarray(False),
            diverging=jnp.asarray(False), turning=jnp.asarray(True),
            n_steps=n, sum_accept=f(7 * acc), sum_accept_sym=f(7 * acc * 0.9),
            max_energy_error=f(0.1), energy=f(1.0) - logp,
            energy_error=f(0.05), initial_energy=f(0.0),
            idx_in_trajectory=idx, is_good_for_adapt=idx != 0,
            divergence=jnuts._empty_div_info(dim, jnp.float32),
            orbit_q=jnp.zeros((1, dim)), orbit_g=jnp.zeros((1, dim)),
            orbit_logp=jnp.zeros(1), orbit_err=jnp.zeros(1))
        return draw, info

    def t_nuts_draw(seed, pt, transform, step_size, logp_grad, opts,
                    ops=None, graphs=None):
        q, logp, g, n, acc, idx = _fake_draw_torch(pt, step_size, logp_grad)
        z, zg = (q - transform.mean) * transform.inv_stds, g * transform.stds
        draw = pt._replace(q=q, g=g, z=z, zg=zg, logp=logp)
        full = lambda v: torch.full((C,), v)  # noqa: E731
        no = torch.zeros(C, dtype=torch.bool)
        if always_good:
            idx = torch.full_like(idx, 3)
        info = tnuts.NutsInfo(
            depth=torch.full((C,), 3, dtype=torch.int32),
            reached_maxdepth=no, diverging=no, turning=~no, n_steps=n,
            sum_accept=7 * acc, sum_accept_sym=7 * acc * 0.9,
            max_energy_error=full(0.1), energy=1.0 - logp,
            energy_error=full(0.05), initial_energy=full(0.0),
            idx_in_trajectory=idx, is_good_for_adapt=idx != 0,
            divergence=tnuts._empty_div_info(C, dim, torch.float32, "cpu",
                                             False))
        return draw, info

    return j_nuts_draw, t_nuts_draw


@pytest.mark.parametrize("mode", ["DUAL_AVERAGE", "ADAM", "window"])
def test_draw_step_adaptation_matches_the_jax_draw_step(monkeypatch, mode):
    """Same state (carried across with ``state_from_numpy``), same draw and
    ``NutsInfo`` (both ``nuts_draw`` replaced by one made-up draw, some of
    whose draws are no good for the estimators), schedule rows with
    estimator updates, mass-matrix updates, a window switch, the late
    estimator and the best-guess step: the transform, the estimators, the
    step-size state and the stats record agree to 1e-5.  Jitter is off (its
    uniforms come from different generators), and so are the rows that
    re-run the init search (its momentum does); ``window`` is the good-draw
    window mode on every row, with the FIXED step size, whose init search
    draws nothing."""
    dim, C, tune = 4, 6, 40
    window = mode == "window"
    method = "FIXED" if window else mode
    kw = dict(num_chains=C, num_tune=tune, num_draws=10)
    js = jnt.DiagNutsSettings(
        step_size=jnt.StepSizeSettings(
            jitter=None, method=jnt.StepSizeMethod[method]),
        adapt=jnt.AdaptScheduleOptions(window_by_good_draws=window), **kw)
    ts = tnt.DiagNutsSettings(
        step_size=tnt.StepSizeSettings(
            jitter=None, method=tnt.StepSizeMethod[method]),
        adapt=tnt.AdaptScheduleOptions(window_by_good_draws=window), **kw)
    jm, tm = jg.normal_logp(dim, 0.5), tg.normal_logp(dim, 0.5)
    jcfg, tcfg = js.chain_config(), ts.chain_config()
    jstate = jnt.Sampler(jm, js, dtype=jnp.float32).state
    tstate = state_from_numpy(state_to_numpy(jstate))
    if window:
        w = jstate.window
        tstate = tstate._replace(window=tchain.WindowState(
            current_window=torch.tensor(np.asarray(w.current_window)),
            last_update=torch.tensor(np.asarray(w.last_update)),
            has_initial=torch.tensor(np.asarray(w.has_initial))))
    j_nuts_draw, t_nuts_draw = _fake_nuts_draws(dim, C)
    monkeypatch.setattr(jchain, "nuts_draw", j_nuts_draw)
    monkeypatch.setattr(tchain, "nuts_draw", t_nuts_draw)
    jstep = jax.jit(jchain.make_draw_step(jm, _strategy_for(js, jcfg), jcfg))
    tstep = tchain.make_draw_step(tm, tchain.DiagStrategy(tcfg), tcfg, 0)
    sched = build_schedule(tune, 10, ts.adapt)
    rows = [r for r in range(tune + 2)
            if window or not sched.reinit_step_size[r]]
    assert sched.do_switch[rows].any() and sched.use_best_guess[rows].any()
    for r in rows:
        flags = {k: v[0] for k, v in _schedule_chunk(sched, r, r + 1).items()}
        if not window:
            # a skipped row leaves the draw counters behind: set them
            jstate = jstate._replace(draw_idx=jnp.asarray(r, jnp.int32))
            tstate = tstate._replace(draw_idx=r)
        jstate, jstats = jstep(jstate, {k: jnp.asarray(v)
                                        for k, v in flags.items()})
        tstate, tstats = tstep(tstate, {k: bool(v) for k, v in flags.items()})
        got, want = state_to_numpy(tstate), state_to_numpy(jstate)
        for name in want:
            if name in ("v", "ke"):
                continue
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
        if window:
            for name in tchain.WindowState._fields:
                np.testing.assert_allclose(
                    getattr(tstate.window, name).numpy().astype(np.float64),
                    np.asarray(getattr(jstate.window, name), np.float64),
                    err_msg=f"row {r} window {name}")
    assert int(got["transform_id"].max()) > 2
    assert int(got["transform_id"].min()) < int(got["transform_id"].max()) \
        or not window


def test_good_draw_window_mode_decides_as_the_schedule_when_all_draws_are_good(
        monkeypatch):
    """``adapt.window_by_good_draws``: the per-chain windows of
    ``GlobalStrategy::adapt`` take the draw-index schedule's decisions on
    every draw when every draw is good, the re-init search included."""
    dim, C, tune = 4, 6, 60
    monkeypatch.setattr(tchain, "nuts_draw",
                        _fake_nuts_draws(dim, C, always_good=True)[1])
    tm = tg.normal_logp(dim, 0.5)
    states = []
    for window in (False, True):
        ts = tnt.DiagNutsSettings(
            num_chains=C, num_tune=tune, num_draws=5,
            adapt=tnt.AdaptScheduleOptions(window_by_good_draws=window))
        cfg = ts.chain_config()
        strategy = tchain.DiagStrategy(cfg)
        state = tchain.init_chain_state(3, tm, strategy, cfg, C,
                                        torch.float32, "cpu")
        runner = tchain.make_sync_runner(tm, strategy, cfg, 3)
        sched = build_schedule(tune, 5, ts.adapt)
        state, stats = runner(state, _schedule_chunk(sched, 0, tune + 5))
        states.append((state_to_numpy(state), stats))
    (a, sa), (b, sb) = states
    assert int(a["transform_id"].max()) > 20
    for name in a:
        np.testing.assert_array_equal(a[name], b[name], err_msg=name)
    for name in sa:
        np.testing.assert_array_equal(sa[name].numpy(), sb[name].numpy(),
                                      err_msg=name)


# ---------------------------------------------------------------------------
# (d) demotion and phases
# ---------------------------------------------------------------------------


def _kinds(phases):
    out = []
    for lo, hi, runner in phases:
        if isinstance(runner, functools.partial):
            name = "sync"
        else:
            q = runner.__qualname__
            name = ("sync" if "sync" in q else
                    "warmup" if "warmup" in q else "posterior")
        out.append((lo, hi, name))
    return out


def _both_phases(jmodel, tmodel, change, warn):
    kw = dict(num_chains=8, num_tune=60, num_draws=30)
    jkw = dict(change)
    for name, enum in (("kinetic_energy", jnt.KineticKind),):
        if name in jkw:
            jkw[name] = enum[jkw[name].name]
    if "step_size" in jkw:
        jkw["step_size"] = jnt.StepSizeSettings(
            method=jnt.StepSizeMethod[jkw["step_size"].method.name])
    if "adapt" in jkw:
        jkw["adapt"] = jnt.AdaptScheduleOptions(window_by_good_draws=True)
    js = jnt.DiagNutsSettings(**kw, **jkw)
    ts = tnt.DiagNutsSettings(**kw, **change)
    jcfg, tcfg = js.chain_config(), ts.chain_config()
    if warn:
        with pytest.warns(UserWarning, match="fused engine does not support"):
            jp = js.build_phases(jmodel, _strategy_for(js, jcfg), jcfg)
        with pytest.warns(UserWarning, match="fused engine does not support"):
            tp = ts.build_phases(tmodel, tcfg, "cpu")
    else:
        jp = js.build_phases(jmodel, _strategy_for(js, jcfg), jcfg)
        tp = ts.build_phases(tmodel, tcfg, "cpu")
    return _kinds(jp), _kinds(tp)


@pytest.mark.parametrize("change,warn,expect", [
    (dict(posterior_kernel="sync"), False, ["sync"]),
    (dict(posterior_kernel="pallas"), False,
     ["warmup", "warmup", "posterior"]),
    (dict(posterior_kernel="pallas", mindepth=1), True, ["sync"]),
    (dict(posterior_kernel="pallas", extra_doublings=2), True, ["sync"]),
    (dict(posterior_kernel="pallas", target_integration_time=1.5), True,
     ["sync"]),
    (dict(posterior_kernel="pallas", check_turning=False), True, ["sync"]),
    (dict(posterior_kernel="pallas",
          kinetic_energy=KineticKind.MICROCANONICAL), True, ["sync"]),
    (dict(posterior_kernel="pallas", step_size=tnt.StepSizeSettings(
        method=tnt.StepSizeMethod.ADAM)), False, ["sync", "posterior"]),
    (dict(posterior_kernel="pallas", adapt=tnt.AdaptScheduleOptions(
        window_by_good_draws=True)), False, ["sync", "posterior"]),
    ("streamed", False, ["sync", "posterior"]),
])
def test_build_phases_plans_what_the_jax_package_plans(change, warn, expect):
    if change == "streamed":
        jmodel = jg.logistic_regression(30000, 100, 0)
        tmodel = tg.logistic_regression_from_tensors(
            torch.zeros(100, 30000), torch.zeros(30000))
        change = dict(posterior_kernel="pallas")
    else:
        jmodel, tmodel = jg.normal_logp(5, 0.0), tg.normal_logp(5, 0.0)
    jp, tp = _both_phases(jmodel, tmodel, change, warn)
    assert jp == tp
    assert [name for _, _, name in tp] == expect
    assert tp[0][0] == 0 and tp[-1][1] == 90
    assert all(a[1] == b[0] for a, b in zip(tp, tp[1:]))
