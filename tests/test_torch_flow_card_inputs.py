"""The inputs of K1-flow's card checks grow trees, on the CPU.

A card check that compares draws which all diverge at their first leapfrog
holds no tree of the kernel against its plain version.  The kernel equals
its plain version bit for bit on the card, so the plain version here shows
what the card's draws do: at the growing-tree cases of
``tests/test_torch_kernels_cuda.py::test_flow_kernel_matches_plain_version_on_the_card``
(today's form at d = H = 33 and d = 160, the warp form's edges d = 32 and
d = 17) and at ``chip_smoke.py``'s check and timed launches of today's form
(funnel(40), the timed launch's first chains), some tree grows past depth 0
and not every draw diverges.
"""

import pytest
import torch
from test_torch_kernels_cuda import (
    FLOW_GROW_CASES,
    flow_case_inputs,
    require_growing_trees,
)

import chip_smoke
from nuts_rs_tpu_torch.flows.coupling import coupling_flow
from nuts_rs_tpu_torch.kernels import _build
from nuts_rs_tpu_torch.kernels import nuts_fused as nf
from nuts_rs_tpu_torch.kernels.nuts import NutsOptions
from nuts_rs_tpu_torch.models.gaussian import funnel

torch.set_num_threads(1)

CPU = torch.device("cpu")


@pytest.mark.parametrize("dim,layers,hidden,C,K,block,form", FLOW_GROW_CASES)
def test_flow_card_cases_grow_trees(dim, layers, hidden, C, K, block, form):
    model, packed, args = flow_case_inputs(dim, layers, hidden, C, True, CPU)
    assert _build.flow_form(dim, 10, model, layers, hidden) == form
    opts = NutsOptions(maxdepth=10, max_energy_error=20.0)
    out = nf.nuts_fused_run(11, *args, K, model, opts, 0.1, block=block,
                            flow=packed)
    require_growing_trees(out[4], f"d={dim} L={layers} H={hidden}")


@pytest.mark.parametrize("chains,seed", [
    (chip_smoke.FLOW_TODAY_CHAINS, 4), (chip_smoke.FLOW_FULL_CHAINS, 5)])
def test_chip_smoke_flow_today_inputs_grow_trees(chains, seed):
    """chip_smoke.flow_today's check launch (8 chains, seed 4) and the
    first 8 chains of its timed launch (256 chains, seed 5), 2 draws."""
    d = chip_smoke.FLOW_TODAY_DIM
    model = funnel(d)
    packed, args = chip_smoke.flow_today_inputs(coupling_flow(), CPU, chains,
                                                seed)
    assert _build.flow_form(d, 10, model, packed.num_layers,
                            packed.hidden) == "today"
    args = tuple(x[:chip_smoke.FLOW_TODAY_CHAINS] for x in args)
    opts = NutsOptions(maxdepth=10, max_energy_error=20.0)
    out = nf.nuts_fused_run(5, *args, chip_smoke.FLOW_TODAY_K, model, opts,
                            0.1, flow=packed)
    chip_smoke.require_growing_trees(out[4], f"funnel({d}), seed {seed}")
