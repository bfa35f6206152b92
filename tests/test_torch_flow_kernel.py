"""Kernel K1-flow's plain version against interpret-mode Pallas, and the
flow's size rule, on the CPU.

``nuts_fused_run_reference(..., flow=PackedFlow)`` (the frozen coupling flow's
forward pass, the model's plain functor and the hand-written backward pass
in the CUDA kernel's order, ``flows/coupling.py::packed_forward`` /
``packed_backward``) replays ``nuts_pallas_run(..., flow=(pallas_forward,
pallas_pack(params)))`` in interpret mode, where ``jax.value_and_grad``
differentiates ``pallas_forward`` and the model together, on ``funnel(4)``
with a 2 x 8 flow whose nets are perturbed off the identity (the JAX
package's parameters carried across by ``convert.py``), 4 chains, 4 draws,
in one logical block of 4 and in blocks of 1: every integer stat equal draw
for draw.  Floats: the funnel's tolerances
(``tests/test_torch_model_hooks.py``: rtol / atol 1e-4, energies atol 5e-4);
the flow adds a tanh from exp (``ops.tanh``, a few 1e-8 from XLA's) and
sums in another order than XLA's dots, well inside them.

The spy test holds ``chain.flow_cl_fits`` against the JAX runner
``make_pallas_posterior_runner``, which returns None where its flow rule
fails, on both sides of the boundary in d, layers and hidden units, without
and with model data.

The kernel itself runs only on a CUDA card: tests/test_torch_kernels_cuda.py
holds it against this plain version.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nuts_rs_tpu as jnt
from nuts_rs_tpu.adapt.flow import FlowStrategy as JaxFlowStrategy
from nuts_rs_tpu.chain import make_pallas_posterior_runner
from nuts_rs_tpu.flows.coupling import CouplingFlowConfig as JaxCfg
from nuts_rs_tpu.flows.coupling import coupling_flow as jax_coupling_flow
from nuts_rs_tpu.kernels.nuts import NutsOptions as JaxNutsOptions
from nuts_rs_tpu.kernels.nuts_pallas import nuts_pallas_run
from nuts_rs_tpu.models import gaussian as jg
from nuts_rs_tpu_torch import chain as tchain
from nuts_rs_tpu_torch.convert import flow_params_from_numpy
from nuts_rs_tpu_torch.flows.coupling import CouplingFlowConfig
from nuts_rs_tpu_torch.flows.coupling import coupling_flow
from nuts_rs_tpu_torch.kernels import nuts_fused as nf
from nuts_rs_tpu_torch.kernels.nuts import NutsOptions
from nuts_rs_tpu_torch.models import gaussian as tg

INT_STATS = ("depth", "diverging", "n_steps", "index_in_trajectory",
             "maxdepth_reached", "loop_iterations")
ENERGY_STATS = ("max_energy_error", "logp", "energy", "energy_error",
                "fisher_distance")
C, K, MAXDEPTH = 4, 4, 5


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def perturbed_jax_params(d, layers, hidden, scale, seed):
    """The JAX coupling flow's init at a random start, its nets moved off
    the identity by N(0, scale^2) (tests/test_flow.py::_perturb_nets)."""
    spec = jax_coupling_flow(JaxCfg(num_layers=layers, hidden=hidden))
    key = jax.random.key(seed)
    q0 = jax.random.normal(key, (d,), jnp.float64)
    params = spec.init(jax.random.key(seed + 1), d, q0, -q0)
    key = jax.random.key(seed + 2)
    out = []
    for layer in params["layers"]:
        key, k = jax.random.split(key)
        net = jax.tree.map(
            lambda x: x + scale * jax.random.normal(k, x.shape, x.dtype),
            layer["net"])
        out.append({"mask": layer["mask"], "net": net})
    return spec, {**params, "layers": out}


def _inputs(d, seed, step):
    rng = np.random.default_rng(seed)
    z0 = (0.8 * rng.normal(size=(C, d))).astype(np.float32)
    ones = np.ones((C, d), np.float32)
    zeros = np.zeros((C, d), np.float32)
    zc = np.zeros(C, np.float32)
    return (z0, zeros, zc, ones, zeros, zc,
            np.full(C, step, np.float32), np.full(C, 0.9 * step, np.float32))


def _close(got, want, what, rtol, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=what)


@pytest.mark.parametrize("block,seed,jitter", [(C, 0, 0.1), (1, 1, 0.1),
                                               (C, 2, None)])
def test_flow_plain_version_matches_pallas(block, seed, jitter):
    d = 4
    jspec, jparams = perturbed_jax_params(d, 2, 8, 0.3, seed)
    jm, tm = jg.funnel(d), tg.funnel(d)
    args = _inputs(d, seed, 0.35)
    batched = jax.vmap(jm.logp_and_grad, in_axes=1, out_axes=(0, 1))
    want = nuts_pallas_run(
        seed, *args, K, batched, JaxNutsOptions(maxdepth=MAXDEPTH,
                                                max_energy_error=20.0),
        jitter, block=block, interpret=True,
        flow=(jspec.pallas_forward, jspec.pallas_pack(jparams)))
    spec = coupling_flow(CouplingFlowConfig(num_layers=2, hidden=8))
    packed = spec.kernel_pack(flow_params_from_numpy(jparams))
    got = nf.nuts_fused_run_reference(
        seed, *(torch.from_numpy(a) for a in args), K, tm,
        NutsOptions(maxdepth=MAXDEPTH, max_energy_error=20.0), jitter,
        block=block, flow=packed)
    for name in INT_STATS:
        np.testing.assert_array_equal(got[4][name].numpy(),
                                      np.asarray(want[4][name]),
                                      err_msg=name)
    # q, the final z in the aux slot, logp, the draws (q-space)
    for i, name in enumerate(("q", "z", "logp", "draws")):
        _close(got[i], want[i], name, 1e-4, 1e-4)
    for name in ("step_size", "sum_accept", "sum_accept_sym"):
        _close(got[4][name], want[4][name], name, 1e-4, 1e-4)
    for name in ENERGY_STATS:
        _close(got[4][name], want[4][name], name, 1e-4, 5e-4)
    depth = got[4]["depth"].numpy()
    assert depth.max() >= 2 and len(np.unique(depth)) >= 2
    # the flow moved the draws off the identity map of z
    assert not np.allclose(got[3].numpy()[:, 0], args[0], atol=1e-3)


def test_flow_plain_version_keeps_the_kernel_salts():
    """An identity flow (zero output nets, log sigma 0, mu 0) is the plain
    diagonal kernel at stds 1, mean 0: the same random stream (the flow
    draws no number), so the same trees and the same positions."""
    d = 4
    tm = tg.funnel(d)
    spec = coupling_flow(CouplingFlowConfig(num_layers=2, hidden=8))
    q0 = torch.zeros(1, d)
    params = spec.init(0, d, q0, torch.ones(1, d))
    params = {**params, "log_sigma": torch.zeros(1, d),
              "mu": torch.zeros(1, d)}
    packed = spec.kernel_pack({k: (v[0] if k != "layers" else [
        {"mask": lay["mask"][0],
         "net": {n: w[0] for n, w in lay["net"].items()}} for lay in v])
        for k, v in params.items()})
    args = [torch.from_numpy(a) for a in _inputs(d, 3, 0.3)]
    z0 = args[0]
    logp, g = tm.logp_and_grad(z0)
    plain = (z0, g, logp) + tuple(args[3:])
    opts = NutsOptions(maxdepth=MAXDEPTH, max_energy_error=20.0)
    got = nf.nuts_fused_run_reference(3, *args, K, tm, opts, 0.1,
                                      flow=packed)
    want = nf.nuts_fused_run_reference(3, *plain, K, tm, opts, 0.1)
    for name in INT_STATS:
        np.testing.assert_array_equal(got[4][name].numpy(),
                                      want[4][name].numpy(), err_msg=name)
    _close(got[3], want[3], "draws", 1e-5, 1e-5)


def _jax_runner_takes(d, layers, hidden, model):
    settings = jnt.FlowNutsSettings(num_chains=4, num_tune=10, num_draws=10,
                                    flow_spec=jax_coupling_flow(JaxCfg(
                                        num_layers=layers, hidden=hidden)))
    config = settings.chain_config()
    strategy = JaxFlowStrategy(config, settings, settings.flow_spec)
    return make_pallas_posterior_runner(model, strategy, config, 10,
                                        0) is not None


def _port_rule_takes(d, layers, hidden, model):
    spec = coupling_flow(CouplingFlowConfig(num_layers=layers,
                                            hidden=hidden))
    one = spec.init(0, d, torch.zeros(1, d), torch.ones(1, d))
    first = {"layers": [{"mask": lay["mask"][0],
                         "net": {k: v[0] for k, v in lay["net"].items()}}
                        for lay in one["layers"]],
             "log_sigma": one["log_sigma"][0], "mu": one["mu"][0]}
    return tchain.flow_cl_fits(d, 10, spec.kernel_pack(first).arrays,
                               model.data_bytes)


@pytest.mark.parametrize("d,layers,hidden", [
    (154, 4, 32), (155, 4, 32), (150, 4, 64), (140, 8, 32), (100, 2, 256),
    (120, 2, 256), (10, 4, 32)])
def test_flow_size_rule_matches_the_jax_runner(d, layers, hidden):
    takes = _port_rule_takes(d, layers, hidden, tg.funnel(d))
    assert takes == _jax_runner_takes(d, layers, hidden, jg.funnel(d))


@pytest.mark.parametrize("rows,d", [(1000, 100), (2000, 100), (3000, 60)])
def test_flow_size_rule_counts_the_model_data(rows, d):
    jm = jg.logistic_regression(rows, d, seed=0)
    tm = tg.logistic_regression(rows, d, seed=0)
    takes = _port_rule_takes(d, 4, 32, tm)
    assert takes == _jax_runner_takes(d, 4, 32, jm)


def test_size_rule_boundary_is_inside_the_cases():
    """The cases above straddle the rule: d = 154 fits a 4 x 32 flow at
    maxdepth 10, d = 155 does not (the JAX runner's ``hidden`` is the
    largest leading size of a packed array, d itself above 32)."""
    assert _port_rule_takes(154, 4, 32, tg.funnel(154))
    assert not _port_rule_takes(155, 4, 32, tg.funnel(155))
