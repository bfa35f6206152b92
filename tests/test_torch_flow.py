"""The flows and their adaptation against the JAX package, on the CPU.

Each test feeds the same inputs, made from a seed with numpy (the JAX
package's own parameter draws carried across by ``convert.py``), to a
function of ``nuts_rs_tpu`` and to its counterpart in ``nuts_rs_tpu_torch``:

* the coupling flow's forward, inverse and logdet at f64, rtol 1e-12, with
  nets perturbed off the identity as in tests/test_flow.py:196-243, with
  one set of parameters for every row and with one set per chain;
* ``FlowOps.eval_from_z`` / ``eval_from_q`` at f64, rtol 1e-9;
* the Fisher loss and its gradient in the parameters (a double backward) at
  f64, rtol 1e-9;
* a refit on a window of at most ``max_train_points`` (Adam steps, the
  plateau stop, monotone acceptance; no random number is drawn there) at
  f64 to 1e-6, and a refused one;
* the training subset above ``max_train_points`` (port only: the JAX draw
  is threefry's): its size, only valid rows, uniform by a chi-square test;
* ``build_flow_schedule`` flag for flag; ``flow_push`` and the orbit window.
"""

import types
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats as sps

from nuts_rs_tpu.adapt import flow as jflow
from nuts_rs_tpu.flows.coupling import CouplingFlowConfig as JaxCfg
from nuts_rs_tpu.flows.coupling import coupling_flow as jax_coupling_flow
from nuts_rs_tpu.flows.coupling import diag_affine_flow as jax_diag_flow
from nuts_rs_tpu.transform.ops import FlowOps as JaxFlowOps
from nuts_rs_tpu.transform.ops import FlowTransform as JaxFlowTransform
from nuts_rs_tpu_torch.adapt import flow as tflow
from nuts_rs_tpu_torch.convert import (
    flow_params_from_numpy,
    flow_params_to_numpy,
    flow_transform_from_numpy,
    flow_window_from_numpy,
)
from nuts_rs_tpu_torch.flows import coupling as tc
from nuts_rs_tpu_torch.transform.ops import FlowOps

F64 = torch.float64


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _jax_params(d, layers, hidden, scale, seed):
    """The JAX coupling flow's init, nets perturbed by N(0, scale^2)."""
    spec = jax_coupling_flow(JaxCfg(num_layers=layers, hidden=hidden))
    q0 = jax.random.normal(jax.random.key(seed), (d,), jnp.float64)
    params = spec.init(jax.random.key(seed + 1), d, q0, -q0)
    key = jax.random.key(seed + 2)
    out = []
    for layer in params["layers"]:
        key, k = jax.random.split(key)
        out.append({"mask": layer["mask"], "net": jax.tree.map(
            lambda x: x + scale * jax.random.normal(k, x.shape, x.dtype),
            layer["net"])})
    return {**params, "layers": out}


def _per_chain(params, C):
    return jax.tree.map(lambda x: np.broadcast_to(np.asarray(x),
                                                  (C,) + x.shape), params)


def _close(a, b, rtol, atol=0.0, what=""):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                               atol=atol, err_msg=what)


def _z(n, d, seed, scale=1.0):
    return scale * np.random.default_rng(seed).normal(size=(n, d))


# ---- (a) forward, inverse, logdet --------------------------------------


@pytest.mark.parametrize("d,layers,hidden,seed", [(6, 3, 8, 0), (5, 2, 16, 1),
                                                  (1, 1, 4, 2)])
def test_coupling_flow_matches_jax(d, layers, hidden, seed):
    jparams = _jax_params(d, layers, hidden, 0.7, seed)
    jspec = jax_coupling_flow(JaxCfg(num_layers=layers, hidden=hidden))
    tspec = tc.coupling_flow(tc.CouplingFlowConfig(num_layers=layers,
                                                   hidden=hidden))
    Z = _z(7, d, seed + 10)
    jq, jld = jax.vmap(lambda z: jspec.forward(jparams, z))(jnp.asarray(Z))
    jz, jldi = jax.vmap(lambda q: jspec.inverse(jparams, q))(jq)
    shared = flow_params_from_numpy(jparams, dtype=F64)
    per_chain = flow_params_from_numpy(_per_chain(jparams, 7), dtype=F64)
    for params in (shared, per_chain):
        q, ld = tspec.forward(params, torch.tensor(Z))
        _close(q, jq, 1e-12, 1e-13, "q")
        _close(ld, jld, 1e-12, 1e-13, "logdet")
        z, ldi = tspec.inverse(params, torch.tensor(np.asarray(jq)))
        _close(z, jz, 1e-12, 1e-13, "z")
        _close(ldi, jldi, 1e-12, 1e-13, "inverse logdet")
    # the packed forward of kernel K1-flow is the same map (its own sum order)
    kq, kld = tc.kernel_forward(tspec.kernel_pack(shared), torch.tensor(Z))
    _close(kq, jq, 1e-12, 1e-12, "packed q")
    _close(kld, jld, 1e-12, 1e-12, "packed logdet")


def test_diag_affine_flow_matches_jax():
    jspec, tspec = jax_diag_flow(), tc.diag_affine_flow()
    rng = np.random.default_rng(3)
    q0, g0 = rng.normal(size=(4, 5)), rng.normal(size=(4, 5))
    jp = jax.vmap(lambda q, g: jspec.init(None, 5, q, g))(q0, g0)
    tp = tspec.init(0, 5, torch.tensor(q0), torch.tensor(g0))
    for k in ("log_sigma", "mu"):
        _close(tp[k], jp[k], 1e-12, 0, k)
    Z = rng.normal(size=(4, 5))
    jq, jld = jax.vmap(jspec.forward)(jp, jnp.asarray(Z))
    q, ld = tspec.forward(tp, torch.tensor(Z))
    _close(q, jq, 1e-12)
    _close(ld, jld, 1e-12)
    draws, grads = rng.normal(size=(30, 5)), rng.normal(size=(30, 5))
    mask = rng.uniform(size=30) < 0.7
    j0 = jax.tree.map(lambda x: x[0], jp)
    want = jspec.update(None, j0, draws, grads, None, mask)
    got = tspec.update(0, {k: v[0] for k, v in tp.items()},
                       torch.tensor(draws), torch.tensor(grads), None,
                       torch.tensor(mask))
    for k in ("log_sigma", "mu"):
        _close(got[k], want[k], 1e-12, 0, k)


# ---- (b) FlowOps --------------------------------------------------------


def _jax_lg(q):
    f = lambda qq: -0.5 * jnp.sum((qq - 1.0) ** 2) - 0.1 * jnp.sum(qq ** 4)
    return f(q), jax.grad(f)(q)


def _torch_lg(q):
    lp = -0.5 * torch.sum((q - 1.0) ** 2, -1) - 0.1 * torch.sum(q ** 4, -1)
    return lp, -(q - 1.0) - 0.4 * q ** 3


@pytest.mark.parametrize("seed", [0, 1])
def test_flow_ops_match_jax(seed):
    d, C = 4, 5
    jparams = _jax_params(d, 2, 8, 0.3, seed)
    jspec = jax_coupling_flow(JaxCfg(num_layers=2, hidden=8))
    jops = JaxFlowOps(jspec)
    jt = JaxFlowTransform(params=jparams, id=jnp.int32(0))
    ops = FlowOps(tc.coupling_flow(tc.CouplingFlowConfig(num_layers=2,
                                                         hidden=8)))
    t = flow_transform_from_numpy(_per_chain(jparams, C),
                                  np.full(C, int(jt.id)), dtype=F64)
    Z = _z(C, d, seed + 5, 0.8)
    want = jax.vmap(lambda z: jops.eval_from_z(jt, z, _jax_lg))(
        jnp.asarray(Z))
    got = ops.eval_from_z(t, torch.tensor(Z), _torch_lg)
    for name, a, b in zip(("q", "logp", "g", "zg", "logdet"), got, want):
        _close(a, b, 1e-9, 1e-12, name)
    q, g = np.asarray(want[0]), np.asarray(want[2])
    want_q = jax.vmap(lambda q_, g_: jops.eval_from_q(jt, q_, g_, _jax_lg))(
        jnp.asarray(q), jnp.asarray(g))
    got_q = ops.eval_from_q(t, torch.tensor(q), torch.tensor(g))
    for name, a, b in zip(("z", "zg", "logdet"), got_q, want_q):
        _close(a, b, 1e-9, 1e-12, name)
    _close(got_q[0], Z, 1e-9, 1e-12, "round trip")


# ---- (c) the Fisher loss and its gradient --------------------------------


def _jax_fisher_loss(spec, params, draws, grads, mask):
    """``coupling.py:180-196``, the closure ``update`` differentiates."""
    def per_sample(q, g):
        z, _ = spec.inverse(params, q)
        (_, _), fvjp = jax.vjp(lambda zz: spec.forward(params, zz), z)
        zg = fvjp((g, jnp.ones((), q.dtype)))[0]
        return jnp.sum(jnp.square(z + zg))

    losses = jax.vmap(per_sample)(draws, grads)
    m = mask.astype(draws.dtype)
    return jnp.sum(losses * m) / jnp.maximum(jnp.sum(m), 1.0)


def _window(n, d, seed, valid=0.8):
    rng = np.random.default_rng(seed)
    A = np.eye(d) + 0.4 * rng.normal(size=(d, d))
    draws = rng.normal(size=(n, d)) @ A.T + 0.5
    prec = np.linalg.inv(A @ A.T)
    grads = -(draws - 0.5) @ prec
    return draws, grads, rng.uniform(size=n) < valid


@pytest.mark.parametrize("seed", [0, 1])
def test_fisher_loss_and_gradient_match_jax(seed):
    d = 4
    jparams = _jax_params(d, 2, 8, 0.2, seed)
    jspec = jax_coupling_flow(JaxCfg(num_layers=2, hidden=8))
    tspec = tc.coupling_flow(tc.CouplingFlowConfig(num_layers=2, hidden=8))
    draws, grads, mask = _window(40, d, seed + 3)
    jloss, jgrad = jax.value_and_grad(
        lambda p: _jax_fisher_loss(jspec, p, draws, grads, mask))(jparams)
    params = flow_params_from_numpy(jparams, dtype=F64)
    leaves = tc._trainable(params)
    for x in leaves:
        x.requires_grad_(True)
    loss = tc.fisher_loss(tspec, params, torch.tensor(draws),
                          torch.tensor(grads), torch.tensor(mask),
                          create_graph=True)
    loss.backward()
    _close(loss.detach(), jloss, 1e-9, 0, "loss")
    want = tc._trainable(flow_params_from_numpy(jgrad, dtype=F64))
    for i, (x, w) in enumerate(zip(leaves, want)):
        _close(x.grad, w, 1e-9, 1e-12, f"gradient of leaf {i}")
    # the mask is structure: no gradient reaches it in JAX either
    for layer in jgrad["layers"]:
        assert not np.any(np.asarray(layer["mask"]))


# ---- (d) the refit ---------------------------------------------------------


@pytest.mark.parametrize("patience,steps,valid", [(10, 80, 0.8), (0, 30, 0.8),
                                                  (40, 200, 0.6)])
def test_refit_matches_jax(patience, steps, valid):
    d = 4
    cfg = dict(num_layers=2, hidden=8, train_steps=steps,
               learning_rate=1e-2, early_stop_patience=patience,
               max_train_points=128)
    jspec = jax_coupling_flow(JaxCfg(**cfg))
    tspec = tc.coupling_flow(tc.CouplingFlowConfig(**cfg))
    jparams = _jax_params(d, 2, 8, 0.05, 4)
    draws, grads, mask = _window(96, d, 5, valid)
    want = jspec.update(jax.random.key(0), jparams, jnp.asarray(draws),
                        jnp.asarray(grads), jnp.zeros(96), jnp.asarray(mask))
    got = tspec.update(0, flow_params_from_numpy(jparams, dtype=F64),
                       torch.tensor(draws), torch.tensor(grads),
                       torch.zeros(96, dtype=F64), torch.tensor(mask))
    for i, (a, b) in enumerate(zip(tc.tree_leaves(got),
                                   tc.tree_leaves(flow_params_to_numpy(
                                       want)))):
        _close(a, b, 1e-6, 1e-6, f"leaf {i}")
    # the refit was taken and moved the nets
    moved = np.abs(np.asarray(want["layers"][0]["net"]["w2"])
                   - np.asarray(jparams["layers"][0]["net"]["w2"])).max()
    assert moved > 1e-3


def test_refit_needs_ten_points():
    d = 4
    tspec = tc.coupling_flow(tc.CouplingFlowConfig(num_layers=2, hidden=8,
                                                   train_steps=20))
    params = flow_params_from_numpy(_jax_params(d, 2, 8, 0.05, 4), dtype=F64)
    draws, grads, _ = _window(40, d, 6)
    mask = torch.zeros(40, dtype=torch.bool)
    mask[:9] = True
    got = tspec.update(0, params, torch.tensor(draws), torch.tensor(grads),
                       None, mask)
    assert got is params


# ---- (e) the training subset ----------------------------------------------


def test_training_subset_is_uniform_over_valid_rows():
    n, keep = 600, 60
    mask = torch.tensor(np.random.default_rng(0).uniform(size=n) < 0.5)
    valid = mask.nonzero()[:, 0].numpy()
    counts = np.zeros(n)
    draws = 400
    for seed in range(draws):
        idx = tc.train_subset(seed, mask, keep).numpy()
        assert len(idx) == keep and len(set(idx.tolist())) == keep
        assert mask[idx].all()
        counts[idx] += 1
    expected = draws * keep / len(valid)
    chi2 = float(np.sum((counts[valid] - expected) ** 2 / expected))
    # the selection counts of the valid rows are uniform: chi-square with
    # len(valid) - 1 degrees of freedom, level 1e-3 (the statistic of a
    # sample without replacement is a little smaller than a multinomial's)
    assert sps.chi2.sf(chi2, len(valid) - 1) > 1e-3
    assert counts[~mask.numpy()].sum() == 0


def test_training_subset_keeps_every_valid_row_when_few():
    mask = torch.zeros(50, dtype=torch.bool)
    mask[[3, 7, 20]] = True
    idx = tc.train_subset(1, mask, 10)
    assert len(idx) == 10 and set([3, 7, 20]) <= set(idx.tolist())
    assert int(mask[idx].sum()) == 3


def test_refit_above_the_budget_trains_on_a_subset():
    d = 3
    tspec = tc.coupling_flow(tc.CouplingFlowConfig(
        num_layers=1, hidden=4, train_steps=5, max_train_points=32))
    params = flow_params_from_numpy(_jax_params(d, 1, 4, 0.05, 2), dtype=F64)
    draws, grads, mask = _window(200, d, 7)
    got = tspec.update(3, params, torch.tensor(draws), torch.tensor(grads),
                       None, torch.tensor(mask))
    assert all(torch.isfinite(x).all() for x in tc.tree_leaves(got))


# ---- (f) the schedule -----------------------------------------------------


@pytest.mark.parametrize("tune,draws,freq,window", [
    (600, 600, 128, 0.07), (1500, 1000, 128, 0.07), (100, 50, 10, 0.07),
    (300, 20, 64, 0.2), (9, 3, 128, 0.07)])
def test_flow_schedule_matches_jax(tune, draws, freq, window):
    want = jflow.build_flow_schedule(tune, draws, jflow.FlowAdaptSettings(
        transform_update_freq=freq, step_size_window=window))
    got = tflow.build_flow_schedule(tune, draws, tflow.FlowAdaptSettings(
        transform_update_freq=freq, step_size_window=window))
    for name in want._fields:
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name), err_msg=name)


# ---- (g) the window -------------------------------------------------------


class _State(NamedTuple):
    extra: object


def test_flow_push_matches_jax():
    C, cap, d = 3, 5, 2
    rng = np.random.default_rng(1)
    jw = jax.tree.map(lambda x: jnp.broadcast_to(x, (C,) + x.shape),
                      jflow.new_flow_window(cap, d, jnp.float64))
    tw = tflow.new_flow_window(C, cap, d, F64, "cpu")
    push = jax.vmap(jflow.flow_push)
    for _ in range(8):
        q, g = rng.normal(size=(C, d)), rng.normal(size=(C, d))
        lp, inc = rng.normal(size=C), rng.uniform(size=C) < 0.7
        jw = push(jw, q, g, lp, inc)
        tw = tflow.flow_push(tw, torch.tensor(q), torch.tensor(g),
                             torch.tensor(lp), torch.tensor(inc))
    for name in jw._fields:
        np.testing.assert_array_equal(getattr(tw, name).numpy(),
                                      np.asarray(getattr(jw, name)),
                                      err_msg=name)
    assert int(tw.count.max()) == cap  # a full window takes no more


def test_orbit_window_matches_jax():
    C, cap, ocap, d = 3, 7, 8, 2
    rng = np.random.default_rng(2)
    settings = types.SimpleNamespace(flow=jflow.FlowAdaptSettings(
        use_orbit_for_training=True))
    jstrat = jflow.FlowStrategy(None, settings, jax_diag_flow())
    tstrat = tflow.FlowStrategy(None, types.SimpleNamespace(
        flow=tflow.FlowAdaptSettings(use_orbit_for_training=True)),
        tc.diag_affine_flow())
    jw = jax.tree.map(lambda x: jnp.broadcast_to(x, (C,) + x.shape),
                      jflow.new_flow_window(cap, d, jnp.float64))
    tw = tflow.new_flow_window(C, cap, d, F64, "cpu")
    for _ in range(3):
        err = rng.normal(scale=15.0, size=(C, ocap))
        err[0, 1] = np.nan
        oq = rng.normal(size=(C, ocap, d))
        info = types.SimpleNamespace(
            orbit_q=oq, orbit_g=rng.normal(size=(C, ocap, d)),
            orbit_logp=rng.normal(size=(C, ocap)), orbit_err=err,
            n_steps=rng.integers(0, ocap + 3, size=C).astype(np.int32))
        jw = jstrat.update_estimators_orbit(_State(jw), info).extra
        tinfo = types.SimpleNamespace(**{
            k: torch.tensor(v) for k, v in vars(info).items()})
        tw = tstrat.update_estimators_orbit(_State(tw), tinfo).extra
        for name in jw._fields:
            np.testing.assert_array_equal(getattr(tw, name).numpy(),
                                          np.asarray(getattr(jw, name)),
                                          err_msg=name)
    assert int(tw.count.max()) == cap
    # the JAX window crosses over whole
    again = flow_window_from_numpy(jw, dtype=F64)
    assert torch.equal(again.count, tw.count)


def test_an_excluded_point_leaves_the_window_finite():
    """A non-finite point fails the filter and changes nothing.  (The JAX
    push writes ``sel * q + (1 - sel) * row`` into the next free row, so
    there an excluded infinite point leaves NaN in that row, and the next
    included point, written as ``1 * q + 0 * NaN``, is stored as NaN: the
    port writes with a select and does not carry that over.)"""
    C, cap, d = 2, 4, 3
    strat = tflow.FlowStrategy(None, types.SimpleNamespace(
        flow=tflow.FlowAdaptSettings()), tc.diag_affine_flow())
    state = _State(tflow.new_flow_window(C, cap, d, F64, "cpu"))
    q = torch.ones(C, d, dtype=F64)
    bad = q.clone()
    bad[0, 1] = float("inf")
    zero = torch.zeros(C, dtype=F64)
    for point in (bad, q, q):
        state = strat.update_estimators(state, point, q, None, zero, zero)
    w = state.extra
    assert w.count.tolist() == [2, 3]
    assert torch.isfinite(w.draws).all()
    assert torch.equal(w.draws[0, :2], q[:1].expand(2, d))
