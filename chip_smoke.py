#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (nuts_rs_tpu_torch) on one CUDA card.

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

It builds the fused CUDA kernels from ``nuts_rs_tpu_torch/csrc`` (nvcc,
sm_90a), holds each kernel against its plain PyTorch version on the card,
and drives six paths through ``Sampler(...).run()`` with
``posterior_kernel="pallas"`` (``--only PATH`` drives one of them: ``nuts``,
``mclmc``, ``large_d``, ``data``, ``mclmc_data`` or ``stream``, and builds
only its kernels).  Two run N(3, 1) at d=10 with 1024 chains,
300 tuning and 700 posterior draws: NUTS (``DiagNutsSettings``, kernels K1
and K2) and MCLMC (``DiagMclmcSettings``, kernels K3 and K4).  The third is
the large-d path: NUTS on N(3, 1) at d=1000 with 512 chains, 200 tuning and
300 posterior draws, on the dim-on-lanes kernels K1-ld and K2-ld.  The
fourth is the data-carrying path: NUTS on Bayesian logistic regression with
1000 rows and 100 columns, 1024 chains, 300 tuning and 400 posterior draws,
on the mid-d chains-on-lanes kernels K1-args and K2-args, which evaluate the
model with its data in the kernel body; its posterior is held against the
JAX package's (``tests/data/logreg_d100_reference.json``, moments from that
package's sync engine on a CPU).  The fifth is the same regression under
MCLMC (``DiagMclmcSettings``, the same chains and draws), on the mid-d MCLMC
kernels K3-args and K4-args, held against that package's sync MCLMC engine
(``tests/data/mclmc_logreg_d100_reference.json``).  The sixth is the
streamed-data path: NUTS on the same regression with 131072 rows (52 MB of
data, more than a block's shared memory and the card's L2), 256 chains, 150
tuning and 256 posterior draws (the JAX benchmark's 300 and 400 cut for this
script's time; ``profile_main_path.py --only-stream`` runs them whole): the
per-draw sync engine (plain PyTorch) for the warmup, then the posterior on
kernel K1-stream, which walks the rows in tiles of 512; its posterior is held
against the JAX package's sync engine on the same rows
(``tests/data/logreg_big_reference.json``), and its launch counts must be 2
of K1-stream and none of a fused warmup kernel.  K1-stream
is checked at the path's rows and dimension on 64 chains.  For each path it sets
the launch counts to 0, runs, reads them, and checks that its kernels ran
and that the posterior is right.  Every kernel is held against its plain
version at its path's chains and dimension (8 posterior or up to 16 warmup
draws); the mid-d kernels, NUTS and MCLMC, also on N(3, 1) at d=100 with 64
chains in logical blocks of 8.  Cut to keep the script under five minutes:
K2-args is checked on 4 schedule rows (6..9, with the window switch), not
16, K2-ld and the mid-d K2 without data on 8 (2..9); K4-args' rows start
from a post-warmup-like state, not the initial one; the streamed-data path
runs half its warmup and two of its four posterior launches, and
K1-stream's 128-draw launch is timed once.

Each kernel is timed (CUDA events) beside its plain version on the check's
inputs (``ms``, ``plain_ms``, with the bound ``bound_ms`` of that work), and
alone at its path's 128-draw launch (``chunk_ms``, ``chunk_bound_ms``).  The
bound is the larger of the bytes the call must move (every input read once,
every output written once) over 3.35 TB/s and its FP32 operations over 67
TFLOP/s, the card's published peaks; operations are counted from the
leapfrogs the run's data needed (``n_steps``), ``FLOP_PER_COORD`` per
coordinate, and for the logistic regression 4 N d + 4 (N + d) more per
evaluation, with its data among the bytes.  No single PyTorch call computes
a NUTS or MCLMC launch, so ``library_ms`` is null; the time of one batched
evaluation of the regression by two ``torch.matmul`` calls is printed as a
yardstick for its products.

Output: the card's name and power limit, the nvcc version, the build time,
the checks and timings, a JSON line ``{"kernels": [...]}`` and, last,
``{"ok": true, "device": {...}}``.  Any failure raises and exits non-zero;
without a CUDA card it exits non-zero before printing a result.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

DIM, MU, CHAINS, TUNE, DRAWS, SEED = 10, 3.0, 1024, 300, 700, 0
CHUNK = 128          # the Sampler's chunk: draws per launch on the main path
CHECK_K1_DRAWS = 8   # posterior draws per chain in the kernel check
CHECK_K2_DRAWS = 16  # warmup draws in the kernel check
# K2-args' check: rows 6..9 keep the window switch of row 8 and one draw after
# it; its plain version took 89 s of the script at 16 rows and 48-58 s at 8
# (every tree from the initial state is a deep one), and the script has five
# minutes for six paths
CHECK_K2_ARGS_ROWS = (6, 10)
# K2-ld and the mid-d kernel without data: rows 2..9, with the switch of row 8
CHECK_K2_SHORT_ROWS = (2, 10)
CHECK_K3_DRAWS = 8   # MCLMC posterior draws per chain in the kernel check
CHECK_K4_DRAWS = 16  # MCLMC warmup draws in each kernel check
# the large-d path (the JAX benchmark's normal_d1000 sizes); its kernels are
# checked at the path's own 512 chains (64 logical blocks of 8, several
# waves of clusters, the full stack workspace)
LD_DIM, LD_CHAINS, LD_TUNE, LD_DRAWS = 1000, 512, 200, 300
LD_STEP = (0.2, 0.3)  # adapted step sizes at d=1000, for the made-up states
# the data-carrying path (the JAX benchmark's logreg_d100 sizes) and the
# mid-d kernels' check without data
GLM_ROWS, GLM_DIM, GLM_CHAINS, GLM_TUNE, GLM_DRAWS = 1000, 100, 1024, 300, 400
GLM_REFERENCE = Path(__file__).resolve().parent / "tests" / "data" / \
    "logreg_d100_reference.json"
GLM_MEAN_TOL = 0.1  # of a coordinate's posterior standard deviation
GLM_STD_TOL = 0.1   # relative
# the MCLMC data path: the same model and sizes under DiagMclmcSettings, held
# against the JAX package's sync MCLMC engine (unadjusted, so its own file)
MGLM_REFERENCE = GLM_REFERENCE.with_name("mclmc_logreg_d100_reference.json")
MGLM_NSTEPS = (5.5, 6.7)  # mean leapfrogs a draw: round(3 / 0.5), 10% jitter
MID_DIM, MID_CHAINS = 100, 64
# the streamed-data path (the JAX benchmark's logreg_big sizes): the warmup is
# the per-draw sync engine, the posterior kernel K1-stream
BIG_ROWS, BIG_CHAINS = 131072, 256
BIG_FULL_TUNE, BIG_FULL_DRAWS = 300, 400  # what profile_main_path.py runs
# cut here for the script's five minutes (the sync warmup's 300 draws take
# 49-96 s with the host's speed): half the warmup, two posterior launches
BIG_TUNE, BIG_DRAWS = 150, 256
BIG_CHECK_CHAINS = 64  # of the K1-stream check (its plain version's time)
BIG_REFERENCE = GLM_REFERENCE.with_name("logreg_big_reference.json")
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, published
FP32_FLOP_PER_S = 67e12    # H100 SXM outside the tensor cores, published
# FP32 operations per coordinate and gradient evaluation that every version
# of a step needs.  NUTS: the leapfrog with the diagonal transform (8), the
# model (3), and six sums of products (logp, kinetic energy, z.v and the
# three dots of the far-end U-turn check: 12); the dots of the U-turn
# levels a leaf completes depend on the tree and are left out, so the bound
# is a lower one.  MCLMC: two ESH half steps and the partial refresh with
# their norms and the model.
FLOP_PER_COORD = {"nuts": 23, "mclmc": 40}
INT_STATS = ("depth", "n_steps", "diverging", "index_in_trajectory",
             "maxdepth_reached", "loop_iterations")
MCLMC_INT_STATS = ("n_steps", "diverging", "loop_iterations")
# MCLMC is unadjusted, so its posterior std is not 1: the gate is the std
# the JAX package gives for the same settings on the CPU (PERF.md).
MCLMC_JAX_STD = 1.011754
MCLMC_STD_TOL = 0.05
# Kernels and plain versions round alike (-fmad=false, sums in coordinate
# order, IEEE division), so every integer stat of every (chain, draw) must
# agree and every float is compared, on all chains, within RTOL / ATOL.
RTOL = 1e-4
ATOL = 1e-5


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_events_ms(fn, repeats: int) -> float:
    """Mean milliseconds per call of ``fn`` on the card (CUDA events)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(repeats):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / repeats


def tensor_bytes(*objs) -> int:
    """Bytes of every tensor in ``objs`` (tuples, lists and dicts walked)."""
    n = 0
    for o in objs:
        if isinstance(o, torch.Tensor):
            n += o.numel() * o.element_size()
        elif isinstance(o, dict):
            n += tensor_bytes(*o.values())
        elif isinstance(o, (tuple, list)):
            n += tensor_bytes(*o)
    return n


def model_flop_per_grad(model):
    """FP32 operations of one evaluation beyond FLOP_PER_COORD's: the
    regression's two products and its elementwise pass over rows and
    columns, as the JAX benchmark counts them (bench.py:271-278)."""
    if not model.carries_data:
        return 0
    xt = model.hook_parts()[2][0]
    d, n = xt.shape
    return 4 * n * d + 4 * (n + d)


def bound(kind, model, inputs, out, stats):
    """(bound_ms, bound_by) of one launch from its inputs and results; a
    model's data count among the bytes, read once per launch."""
    grads = float(stats["n_steps"].sum())
    t_ops = grads * (model.dim * FLOP_PER_COORD[kind]
                     + model_flop_per_grad(model)) / FP32_FLOP_PER_S
    t_bytes = (tensor_bytes(inputs, out) + model.data_bytes) / HBM_BYTES_PER_S
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def timed_pair(kernel, plain):
    """Run a kernel and its plain version on the same inputs: (kernel's
    result, plain result, kernel ms per call over 3 calls, plain ms of its
    one call)."""
    out_k = kernel()
    torch.cuda.synchronize()
    ms = cuda_events_ms(kernel, 3)
    box = []
    plain_ms = cuda_events_ms(lambda: box.append(plain()), 1)
    return out_k, box[0], ms, plain_ms


def chunk_time(kind, model, fn, inputs, stats_at, repeats=3):
    """A kernel alone at its path's 128-draw launch: (ms over ``repeats``
    calls after a first one, bound_ms, bound_by)."""
    out = fn()
    torch.cuda.synchronize()
    ms = cuda_events_ms(fn, repeats)
    b_ms, b_by = bound(kind, model, inputs, out, out[stats_at])
    return ms, b_ms, b_by


def require_same_ints(out_k, out_p, what, names=INT_STATS):
    """Raise unless every integer stat agrees; returns the count of
    (chain, draw) entries."""
    for name in names:
        a, b = out_k[name].cpu().numpy(), out_p[name].cpu().numpy()
        bad = int((a != b).sum())
        if bad:
            raise AssertionError(f"{what}: {name} differs on {bad} of "
                                 f"{a.size} (chain, draw) entries")
    return out_k["n_steps"].numel()


def close(a, b, what):
    """Max abs difference of the values that are not equal infinities."""
    a, b = a.cpu().numpy(), b.cpu().numpy()
    with np.errstate(invalid="ignore"):  # inf - inf where both are inf
        diff = np.nanmax(np.abs(a - b))
    if not np.allclose(a, b, rtol=RTOL, atol=ATOL, equal_nan=True):
        raise AssertionError(
            f"{what}: kernel and plain version differ beyond rtol {RTOL}, "
            f"atol {ATOL} (max abs diff {diff})")
    return float(diff)


def posterior_inputs(model, device, seed=1, chains=CHAINS, step=(0.8, 1.0)):
    """A post-warmup-like state of ``model``, made with numpy."""
    rng = np.random.default_rng(seed)
    f = lambda x: torch.as_tensor(x, dtype=torch.float32, device=device)  # noqa: E731
    dim = model.dim
    q = f(MU + rng.normal(size=(chains, dim)))
    stds = f(rng.uniform(0.8, 1.2, size=(chains, dim)))
    mean = f(MU + 0.1 * rng.normal(size=(chains, dim)))
    logp, g = model.logp_and_grad(q)
    logdet = -torch.log(stds).sum(1)
    step = f(rng.uniform(*step, size=chains))
    return q, g, logp, stds, mean, logdet, step, step.clone()


def compare(name, out_k, out_p, state_names, stat_names, int_stats):
    """Raise unless kernel and plain version agree: integer stats on every
    (chain, draw), floats within RTOL / ATOL.  The last two entries of each
    result are the draws and the stats dict.  Returns (entries, max abs
    err)."""
    n = require_same_ints(out_k[-1], out_p[-1], name, int_stats)
    err = close(out_k[-2], out_p[-2], f"{name} draws")
    for i, what in enumerate(state_names):
        err = max(err, close(out_k[i], out_p[i], f"{name} {what}"))
    for what in stat_names:
        err = max(err, close(out_k[-1][what], out_p[-1][what],
                             f"{name} {what}"))
    return n, err


def check_row(kind, model, inputs, out_k, err, ms, plain_ms):
    b_ms, b_by = bound(kind, model, inputs, out_k, out_k[-1])
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by}


def check_posterior(model, opts, device, layout="cl", chains=CHAINS,
                    step=(0.8, 1.0), name=None, args=None, block=None,
                    stream=False):
    """K1 (cl), K1-ld or, with ``name`` and maybe its own inputs ``args``
    and logical chain block, the mid-d cl kernel or (``stream``) the
    streamed one against its plain version."""
    from nuts_rs_tpu_torch.kernels import nuts_fused as nf

    name = name or ("K1-ld" if layout == "ld" else "K1")
    if args is None:
        args = posterior_inputs(model, device, chains=chains, step=step)
    out_k, out_p, ms, plain_ms = timed_pair(
        lambda: nf.nuts_fused_run(7, *args, CHECK_K1_DRAWS, model, opts, 0.1,
                                  block, layout, stream),
        lambda: nf.nuts_fused_run_reference(7, *args, CHECK_K1_DRAWS, model,
                                            opts, 0.1, block, layout, stream))
    n, err = compare(name, out_k, out_p, ("q_f", "g_f", "logp_f"),
                     nf.STAT_NAMES, INT_STATS)
    blocks = len(set(out_k[4]["loop_iterations"].cpu().tolist()))
    chains = args[0].shape[0]
    print(f"{name} check: C={chains} d={model.dim} K={CHECK_K1_DRAWS}: "
          f"integer stats equal on all {n} (chain, draw) entries, max abs "
          f"err {err:.3g} (draws, final state, all stats); {blocks} distinct "
          f"block iteration counts; kernel {ms:.4f} ms, plain {plain_ms:.2f} "
          "ms")
    return check_row("nuts", model, args, out_k, err, ms, plain_ms)


def warmup_setup(model, settings, device, lo, hi, chains=CHAINS):
    from nuts_rs_tpu_torch.adapt.schedule import build_schedule
    from nuts_rs_tpu_torch.chain import (
        DiagStrategy, init_chain_state, pack_warmup_state, warmup_flags)
    from nuts_rs_tpu_torch.sampler import _schedule_chunk

    config = settings.chain_config()
    state = init_chain_state(SEED, model, DiagStrategy(config), config,
                             chains, torch.float32, device)
    sched = build_schedule(settings.num_tune, settings.num_draws,
                           settings.adapt)
    flags = warmup_flags(_schedule_chunk(sched, lo, hi), device)
    est, sca = pack_warmup_state(state)
    t = state.transform
    return (11, flags, state.pt.q, state.pt.g, state.pt.logp,
            t.stds.contiguous(), t.mean.contiguous(), est, sca, model,
            config.nuts, config.step_size, config.use_grad_based_estimate)


def check_warmup(model, settings, device, layout="cl", chains=CHAINS,
                 name=None, block=None, rows=(2, 2 + CHECK_K2_DRAWS)):
    """K2 (cl), K2-ld or, with ``name`` and maybe a logical chain block, the
    mid-d cl kernel against its plain version, on schedule rows
    ``rows[0] .. rows[1] - 1`` from the initial state."""
    from nuts_rs_tpu_torch.kernels import nuts_fused as nf

    name = name or ("K2-ld" if layout == "ld" else "K2")
    # schedule rows 2.. are the second warmup phase's: estimator updates,
    # mass-matrix updates every draw and the first window switch (row 8)
    lo, hi = rows
    draws = hi - lo
    args = warmup_setup(model, settings, device, lo, hi, chains)
    if not args[1][:, nf.FLAG_DO_SWITCH].any():
        raise AssertionError(f"{name} check rows hold no window switch")
    out_k, out_p, ms, plain_ms = timed_pair(
        lambda: nf.nuts_fused_warmup_run(*args, block, layout),
        lambda: nf.nuts_fused_warmup_run_reference(*args, block, layout))
    n, err = compare(name, out_k, out_p,
                     ("q", "g", "logp", "stds", "mean", "est", "sca"),
                     nf.WARMUP_STAT_NAMES, INT_STATS)
    print(f"{name} check: C={chains} d={model.dim} K={draws} "
          f"(schedule rows {lo}..{hi - 1}, a window switch among "
          f"them): integer stats equal on all {n} (chain, draw) entries, "
          f"max abs err {err:.3g} (draws, final state, est, sca, all "
          f"stats); kernel {ms:.4f} ms, plain {plain_ms:.2f} ms")
    return check_row("nuts", model, args[1:9], out_k, err, ms, plain_ms)


def zero_launch_counts():
    from nuts_rs_tpu_torch.kernels import mclmc_fused as mf
    from nuts_rs_tpu_torch.kernels import nuts_fused as nf

    for counts in (nf.LAUNCHES, mf.LAUNCHES):
        for name in counts:
            counts[name] = 0


def read_launch_counts(counts, names):
    """The path's own counts, after it ran; each must be at least 1."""
    launches = {name: counts[name] for name in names}
    for name, n in launches.items():
        if n < 1:
            raise AssertionError(f"the main path never launched {name}")
    return launches


def run_sampler(model, settings, device):
    from nuts_rs_tpu_torch import Sampler

    t0 = time.monotonic()
    sampler = Sampler(model, settings, device=device)
    init_s = time.monotonic() - t0
    trace = sampler.run()
    total_s = time.monotonic() - t0
    tune = settings.num_tune
    warm_s = sum(s for lo, hi, s in sampler.chunk_seconds if lo < tune)
    post_s = sum(s for lo, hi, s in sampler.chunk_seconds if lo >= tune)
    return trace, init_s, warm_s, post_s, total_s


def main_path(model, settings, device, kernels, what="main path"):
    """One NUTS path through Sampler.run with its gates; ``kernels`` names
    the launch counters it must move."""
    from nuts_rs_tpu_torch.kernels import nuts_fused as nf

    zero_launch_counts()
    trace, init_s, warm_s, post_s, total_s = run_sampler(model, settings,
                                                         device)
    launches = read_launch_counts(nf.LAUNCHES, kernels)
    pos = trace.posterior["position"]
    st = trace.sample_stats
    mean = float(pos.mean(dtype=np.float64))
    std = float(pos.std(dtype=np.float64))
    n_div = int(st["diverging"].sum())
    acc = float(st["mean_tree_accept"].mean())
    n_grad = int(st["n_steps"].sum())
    print(f"{what}: d={model.dim} chains={settings.num_chains} "
          f"tune={settings.num_tune} draws={settings.num_draws}: init "
          f"{init_s:.3f} s, warmup {warm_s:.3f} s, posterior {post_s:.3f} s, "
          f"total with trace assembly {total_s:.3f} s, "
          f"{n_grad / post_s:.6g} posterior gradient evaluations/s "
          f"({n_grad} in the posterior), launches {launches}")
    print(f"{what} posterior: mean {mean:.5f} std {std:.5f} divergences "
          f"{n_div} mean accept {acc:.4f} step size "
          f"{float(np.median(st['step_size_bar'][:, -1])):.4f} mean tree "
          f"depth {float(st['depth'].mean()):.3f} mean n_steps "
          f"{float(st['n_steps'].mean()):.2f}")
    if pos.shape != (settings.num_chains, settings.num_draws, model.dim):
        raise AssertionError(f"posterior shape {pos.shape}")
    if not abs(mean - MU) < 0.02:
        raise AssertionError(f"posterior mean {mean} not within 0.02 of {MU}")
    if not abs(std - 1.0) < 0.05:
        raise AssertionError(f"posterior std {std} not within 0.05 of 1")
    if n_div:
        raise AssertionError(f"{n_div} divergences on an iid normal")
    if not 0.7 < acc < 0.95:
        raise AssertionError(f"mean accept {acc} outside (0.7, 0.95)")
    return launches


def time_kernels(model, settings, device, layout="cl", chains=CHAINS,
                 step=(0.8, 1.0), k1=None):
    """Each NUTS kernel alone at its path's launch: ``chains`` chains, one
    128-draw chunk (``k1``: the posterior kernel's own inputs)."""
    from nuts_rs_tpu_torch.kernels import nuts_fused as nf

    opts = settings.nuts_options()
    if k1 is None:
        k1 = posterior_inputs(model, device, seed=2, chains=chains, step=step)
    k2 = warmup_setup(model, settings, device, 2, 2 + CHUNK, chains)
    suffix = "_ld" if layout == "ld" else ""
    if layout == "cl" and nf.cl_kernel(model, model.dim) == "mid":
        suffix = "_mid"
    times = {
        f"nuts_fused{suffix}_posterior": chunk_time(
            "nuts", model,
            lambda: nf.nuts_fused_run(3, *k1, CHUNK, model, opts, 0.1,
                                      layout=layout), k1, 4),
        f"nuts_fused{suffix}_warmup": chunk_time(
            "nuts", model,
            lambda: nf.nuts_fused_warmup_run(*k2, layout=layout), k2[1:9], 8),
    }
    for name, (ms, b_ms, b_by) in times.items():
        print(f"time {name}: {ms:.4f} ms per {CHUNK}-draw launch at "
              f"C={chains} d={model.dim}; bound {b_ms:.5f} ms ({b_by})")
    return times


# ---------------------------------------------------------------------------
# The data-carrying path: kernels K1-args and K2-args on logistic regression
# ---------------------------------------------------------------------------


def glm_reference(path=GLM_REFERENCE):
    """The JAX package's posterior moments of the regression (the file names
    the command that made it)."""
    ref = json.loads(path.read_text())
    return np.array(ref["mean"]), np.array(ref["std"]), ref


def glm_posterior_inputs(model, device, ref_mean, ref_std, seed=1,
                         chains=GLM_CHAINS):
    """A post-warmup-like state of the regression, made with numpy around
    the reference posterior: positions drawn from its marginals, the
    transform near its scales, steps near the adapted one."""
    rng = np.random.default_rng(seed)
    f = lambda x: torch.as_tensor(x, dtype=torch.float32, device=device)  # noqa: E731
    dim = model.dim
    q = f(ref_mean + ref_std * rng.normal(size=(chains, dim)))
    stds = f(ref_std * rng.uniform(0.8, 1.2, size=(chains, dim)))
    mean = f(ref_mean + 0.1 * ref_std * rng.normal(size=(chains, dim)))
    logp, g = model.logp_and_grad(q)
    logdet = -torch.log(stds).sum(1)
    step = f(rng.uniform(0.4, 0.55, size=chains))
    return q, g, logp, stds, mean, logdet, step, step.clone()


def time_glm_by_matmul(model, device, chains=GLM_CHAINS):
    """The regression's two products at the path's [chains, d] by
    ``torch.matmul`` in IEEE float32, alone and inside the host's closed
    form (with its elementwise pass and sums): the yardstick for the
    kernels' products, not a launch's work."""
    rng = np.random.default_rng(5)
    q = torch.as_tensor(0.1 * rng.normal(size=(chains, model.dim)),
                        dtype=torch.float32, device=device)
    xt = model.hook_parts()[2][0]
    rows = xt.shape[1]

    def products():
        return torch.matmul(torch.matmul(q, xt), xt.T)

    products()
    model.logp_and_grad(q)
    ms_two = cuda_events_ms(products, 20)
    ms = cuda_events_ms(lambda: model.logp_and_grad(q), 20)
    flop = chains * 4 * rows * model.dim
    print(f"glm products by two torch.matmul calls (TF32 off): {ms_two:.4f} "
          f"ms for q [{chains}, {model.dim}], x [{rows}, "
          f"{model.dim}] ({flop / ms_two / 1e9:.4g} TFLOP/s); the host's "
          f"closed form around them {ms:.4f} ms per batched evaluation")
    return ms_two, ms


def glm_moment_errors(trace, settings, dim, ref_mean, ref_std):
    """(max |mean - reference| in posterior std, max |std / reference - 1|)
    over the regression's coordinates, after the shape and finiteness
    checks of the posterior draws."""
    pos = trace.posterior["position"]
    if pos.shape != (settings.num_chains, settings.num_draws, dim):
        raise AssertionError(f"posterior shape {pos.shape}")
    flat = pos.reshape(-1, pos.shape[-1]).astype(np.float64)
    if not np.isfinite(flat).all():
        raise AssertionError("non-finite posterior draws")
    mean, std = flat.mean(0), flat.std(0)
    return (float(np.max(np.abs(mean - ref_mean) / ref_std)),
            float(np.max(np.abs(std / ref_std - 1.0))))


def require_glm_moments(mean_err, std_err):
    if not mean_err < GLM_MEAN_TOL:
        raise AssertionError(f"a posterior mean is {mean_err} posterior "
                             "standard deviations from the reference")
    if not std_err < GLM_STD_TOL:
        raise AssertionError(f"a posterior std differs by {std_err} "
                             "(relative) from the reference")


def glm_main_path(model, settings, device, ref_mean, ref_std,
                  kernels=("nuts_fused_mid_posterior",
                           "nuts_fused_mid_warmup"), what="data path"):
    """A regression's NUTS path through Sampler.run, held against the JAX
    package's posterior; ``kernels`` names the launch counters it must move
    (every other fused NUTS kernel must stay at 0).  Returns (launches,
    warmup seconds)."""
    from nuts_rs_tpu_torch.kernels import nuts_fused as nf

    zero_launch_counts()
    trace, init_s, warm_s, post_s, total_s = run_sampler(model, settings,
                                                         device)
    launches = read_launch_counts(nf.LAUNCHES, kernels)
    others = {k: n for k, n in nf.LAUNCHES.items() if k not in kernels and n}
    if others:
        raise AssertionError(f"{what} launched other kernels: {others}")
    rows = model.hook_parts()[2][1].shape[0]
    st = trace.sample_stats
    mean_err, std_err = glm_moment_errors(trace, settings, model.dim,
                                          ref_mean, ref_std)
    n_div = int(st["diverging"].sum())
    acc = float(st["mean_tree_accept"].mean())
    n_grad = int(st["n_steps"].sum())
    n_warm = int(trace.warmup_sample_stats["n_steps"].sum())
    print(f"{what}: logistic regression N={rows} d={model.dim} "
          f"chains={settings.num_chains} tune={settings.num_tune} "
          f"draws={settings.num_draws}: init {init_s:.3f} s, warmup "
          f"{warm_s:.3f} s, posterior {post_s:.3f} s, total with trace "
          f"assembly {total_s:.3f} s, {n_grad / post_s:.6g} posterior "
          f"gradient evaluations/s ({n_grad} in the posterior, {n_warm} in "
          f"the warmup), launches {launches}")
    print(f"{what} posterior: max |mean - reference| "
          f"{mean_err:.4f} posterior std (gate {GLM_MEAN_TOL}), max |std / "
          f"reference - 1| {std_err:.4f} (gate {GLM_STD_TOL}), divergences "
          f"{n_div} mean accept {acc:.4f} step size "
          f"{float(np.median(st['step_size_bar'][:, -1])):.4f} mean tree "
          f"depth {float(st['depth'].mean()):.3f} mean n_steps "
          f"{float(st['n_steps'].mean()):.2f}")
    require_glm_moments(mean_err, std_err)
    if n_div:
        raise AssertionError(f"{n_div} divergences on the regression")
    if not 0.7 < acc < 0.95:
        raise AssertionError(f"mean accept {acc} outside (0.7, 0.95)")
    return launches, warm_s


# ---------------------------------------------------------------------------
# MCLMC: kernels K3 (posterior) and K4 (warmup)
# ---------------------------------------------------------------------------


def mclmc_settings():
    from nuts_rs_tpu_torch import DiagMclmcSettings

    return DiagMclmcSettings(num_chains=CHAINS, num_tune=TUNE,
                             num_draws=DRAWS, seed=SEED,
                             posterior_kernel="pallas")


def mclmc_posterior_args(model, settings, device, seed=1, state=None):
    """K3's inputs: a post-warmup-like state (``state``: one made elsewhere,
    as ``posterior_inputs`` returns it) with unit-sphere velocities."""
    from nuts_rs_tpu_torch import MclmcTrajectoryKind

    q, g, logp, stds, mean, logdet, step, _ = state or posterior_inputs(
        model, device, seed)
    v = torch.randn(*q.shape, generator=torch.Generator().manual_seed(
        seed)).to(device)
    v = (v / v.norm(dim=1, keepdim=True)).contiguous()
    bar = torch.full_like(step, settings.step_size)
    mopts = settings._mclmc_options(MclmcTrajectoryKind.MICROCANONICAL)
    return (q, g, logp, v, stds, mean, logdet, step * 0.5, bar), mopts


def check_mclmc_posterior(model, settings, device, name="K3", state=None,
                          block=None):
    """K3 or, with ``name`` and maybe a state of its own and a logical chain
    block, the mid-d MCLMC posterior kernel against its plain version."""
    from nuts_rs_tpu_torch.kernels import mclmc_fused as mf
    from nuts_rs_tpu_torch.kernels import nuts_fused as nf

    args, mopts = mclmc_posterior_args(model, settings, device, state=state)
    jitter = settings.step_size_settings.jitter
    out_k, out_p, ms, plain_ms = timed_pair(
        lambda: mf.mclmc_fused_run(7, *args, CHECK_K3_DRAWS, model, mopts,
                                   jitter, block),
        lambda: mf.mclmc_fused_run_reference(7, *args, CHECK_K3_DRAWS, model,
                                             mopts, jitter, block))
    n, err = compare(name, out_k, out_p, ("q_f", "g_f", "logp_f", "v_f"),
                     mf.STAT_NAMES, MCLMC_INT_STATS)
    chains = args[0].shape[0]
    B = nf._check_block(chains, block, nf.cl_kernel(model, model.dim))
    print(f"{name} check: C={chains} d={model.dim} B={B} K={CHECK_K3_DRAWS} "
          f"microcanonical: integer stats equal on all {n} (chain, draw) "
          f"entries, max abs err {err:.3g} (draws, final state, all stats); "
          f"kernel {ms:.4f} ms, plain {plain_ms:.2f} ms")
    return check_row("mclmc", model, args, out_k, err, ms, plain_ms)


def mclmc_warmup_setup(model, settings, device, lo, hi, kind, state=None):
    """K4's inputs for schedule rows lo..hi-1 from the initial state of
    ``settings.num_chains`` chains, or from ``state``, a post-warmup-like one
    as ``posterior_inputs`` returns it, with unit-sphere velocities and empty
    estimators (what the path hands the kernel at the trajectory switch,
    where the mass matrix is tuned; the microcanonical dynamics from the
    initial state of a d=100 regression halve for hundreds of iterations)."""
    from nuts_rs_tpu_torch.adapt.schedule import build_schedule
    from nuts_rs_tpu_torch.chain import (
        MCLMC_FLAG_COLUMNS, DiagStrategy, init_chain_state,
        pack_mclmc_warmup_state, warmup_flags)
    from nuts_rs_tpu_torch.sampler import _schedule_chunk

    config = settings.chain_config()
    made_up = state
    if made_up is None:
        state = init_chain_state(SEED, model, DiagStrategy(config), config,
                                 settings.num_chains, torch.float32, device)
    sched = build_schedule(settings.num_tune, settings.num_draws,
                           settings.adapt)
    flags = warmup_flags(
        settings.extra_flags(_schedule_chunk(sched, lo, hi), lo, hi), device,
        MCLMC_FLAG_COLUMNS)
    tail = (model, settings._mclmc_options(kind), config.step_size,
            config.use_grad_based_estimate)
    if made_up is not None:
        from nuts_rs_tpu_torch.kernels import mclmc_fused as mf

        q, g, logp, stds, mean, logdet = made_up[:6]
        v = torch.randn(*q.shape, generator=torch.Generator().manual_seed(
            3)).to(device)
        v = (v / v.norm(dim=1, keepdim=True)).contiguous()
        est = torch.zeros(q.shape[0], 8, q.shape[1], device=device)
        sca = torch.zeros(q.shape[0], mf.NSCA, device=device)
        sca[:, mf.SCA_LOGDET] = logdet
        return (13, flags, q, g, logp, v, stds, mean, est, sca, *tail)
    est, sca = pack_mclmc_warmup_state(state)
    t = state.transform
    return (13, flags, state.pt.q, state.pt.g, state.pt.logp, state.pt.v,
            t.stds.contiguous(), t.mean.contiguous(), est, sca, *tail)


def check_mclmc_warmup(model, settings, device, name="K4", block=None,
                       micro_state=None, euclid_state=None):
    """K4 or, with ``name`` and maybe a logical chain block, the mid-d MCLMC
    warmup kernel, on schedule rows that hold a momentum resample, a window
    switch and mass-matrix updates: from draw 0 with the Euclidean kinetic
    energy, and across the trajectory switch with the microcanonical one
    (each from the initial state, or from ``euclid_state`` /
    ``micro_state``, see ``mclmc_warmup_setup``).  The row's times and bound
    are those of the microcanonical rows."""
    from nuts_rs_tpu_torch import MclmcTrajectoryKind as Kind
    from nuts_rs_tpu_torch.kernels import mclmc_fused as mf
    from nuts_rs_tpu_torch.kernels import nuts_fused as nf

    err, n, rows = 0.0, 0, []
    for lo, kind, state in (
            (0, Kind.EUCLIDEAN, euclid_state),
            (settings.switch_draw - 6, Kind.MICROCANONICAL, micro_state)):
        hi = lo + CHECK_K4_DRAWS
        args = mclmc_warmup_setup(model, settings, device, lo, hi, kind,
                                  state)
        flags = args[1].cpu().numpy()
        if not (flags[:, mf.FLAG_RESAMPLE].any()
                and flags[:, mf.FLAG_DO_SWITCH].any()):
            raise AssertionError(f"{name} check rows {lo}..{hi - 1} miss "
                                 "the resample or a window switch")
        out_k, out_p, ms, plain_ms = timed_pair(
            lambda: mf.mclmc_fused_warmup_run(*args, block),
            lambda: mf.mclmc_fused_warmup_run_reference(*args, block))
        n_i, err_i = compare(
            f"{name} rows {lo}..", out_k, out_p,
            ("q", "g", "logp", "v", "stds", "mean", "est", "sca"),
            mf.WARMUP_STAT_NAMES,
            MCLMC_INT_STATS + ("transformation_index",))
        n, err = n + n_i, max(err, err_i)
        rows.append(f"{lo}..{hi - 1} {kind.value}" + (
            " from a post-warmup-like state" if state is not None else ""))
    chains = settings.num_chains
    B = nf._check_block(chains, block, nf.cl_kernel(model, model.dim))
    print(f"{name} check: C={chains} d={model.dim} B={B} "
          f"K={CHECK_K4_DRAWS}, schedule "
          f"rows {' and '.join(rows)} (each holds a momentum resample and a "
          "window switch): integer stats equal on all "
          f"{n} (chain, draw) entries, max abs err {err:.3g} (draws, final "
          f"state, est, sca, all stats); kernel {ms:.4f} ms, plain "
          f"{plain_ms:.2f} ms (microcanonical rows)")
    return check_row("mclmc", model, args[1:10], out_k, err, ms, plain_ms)


def mclmc_main_path(model, settings, device):
    from nuts_rs_tpu_torch.kernels import mclmc_fused as mf

    zero_launch_counts()
    trace, init_s, warm_s, post_s, _ = run_sampler(model, settings, device)
    launches = read_launch_counts(
        mf.LAUNCHES, ("mclmc_fused_posterior", "mclmc_fused_warmup"))
    pos = trace.posterior["position"].astype(np.float64)
    st = trace.sample_stats
    mean, std = float(pos.mean()), float(pos.std())
    n_div = int(st["diverging"].sum())
    n_grad = int(st["n_steps"].sum())
    print(f"MCLMC main path: d={DIM} chains={CHAINS} tune={TUNE} "
          f"draws={DRAWS}: init {init_s:.3f} s, warmup {warm_s:.3f} s, "
          f"posterior {post_s:.3f} s, {n_grad / post_s:.6g} posterior "
          f"gradient evaluations/s ({n_grad} in the posterior), launches "
          f"{launches}")
    print(f"MCLMC posterior: mean {mean:.5f} std {std:.5f} (JAX package on "
          f"the CPU: {MCLMC_JAX_STD}) divergences {n_div} mean n_steps "
          f"{float(st['n_steps'].mean()):.3f} mean |energy_change| "
          f"{float(np.abs(st['energy_change']).mean()):.4g}")
    if not abs(mean - MU) < 0.02:
        raise AssertionError(f"MCLMC posterior mean {mean} not within 0.02 "
                             f"of {MU}")
    if not abs(std - MCLMC_JAX_STD) < MCLMC_STD_TOL:
        raise AssertionError(f"MCLMC posterior std {std} not within "
                             f"{MCLMC_STD_TOL} of {MCLMC_JAX_STD}")
    if n_div:
        raise AssertionError(f"{n_div} MCLMC divergences on an iid normal")
    return launches


def time_mclmc_kernels(model, settings, device, state=None):
    """Each MCLMC kernel alone at its path's launch (``settings.num_chains``
    chains, one 128-draw chunk; the warmup kernel on the microcanonical
    warmup rows from the trajectory switch; ``state``: a post-warmup-like
    state of their own for both kernels, else the posterior kernel's is
    ``posterior_inputs``' and the warmup kernel's the initial state)."""
    from nuts_rs_tpu_torch import MclmcTrajectoryKind
    from nuts_rs_tpu_torch.kernels import mclmc_fused as mf
    from nuts_rs_tpu_torch.kernels import nuts_fused as nf

    args, mopts = mclmc_posterior_args(model, settings, device, seed=2,
                                       state=state)
    jitter = settings.step_size_settings.jitter
    sw = settings.switch_draw
    k4 = mclmc_warmup_setup(model, settings, device, sw, sw + CHUNK,
                            MclmcTrajectoryKind.MICROCANONICAL, state)
    mid = "_mid" if nf.cl_kernel(model, model.dim) == "mid" else ""
    times = {
        f"mclmc_fused{mid}_posterior": chunk_time(
            "mclmc", model,
            lambda: mf.mclmc_fused_run(3, *args, CHUNK, model, mopts, jitter),
            args, 5),
        f"mclmc_fused{mid}_warmup": chunk_time(
            "mclmc", model, lambda: mf.mclmc_fused_warmup_run(*k4), k4[1:10],
            9),
    }
    for name, (ms, b_ms, b_by) in times.items():
        print(f"time {name}: {ms:.4f} ms per {CHUNK}-draw launch at "
              f"C={settings.num_chains} d={model.dim}; bound {b_ms:.5f} ms "
              f"({b_by})")
    return times


def mclmc_glm_main_path(model, settings, device, ref_mean, ref_std):
    """The MCLMC data path through Sampler.run, held against the JAX
    package's sync MCLMC posterior of the same model."""
    from nuts_rs_tpu_torch.kernels import mclmc_fused as mf

    zero_launch_counts()
    trace, init_s, warm_s, post_s, total_s = run_sampler(model, settings,
                                                         device)
    launches = read_launch_counts(
        mf.LAUNCHES, ("mclmc_fused_mid_posterior", "mclmc_fused_mid_warmup"))
    st = trace.sample_stats
    mean_err, std_err = glm_moment_errors(trace, settings, model.dim,
                                          ref_mean, ref_std)
    n_div = int(st["diverging"].sum())
    n_steps = float(st["n_steps"].mean())
    n_grad = int(st["n_steps"].sum())
    n_warm = int(trace.warmup_sample_stats["n_steps"].sum())
    print(f"MCLMC data path: logistic regression N={GLM_ROWS} d={model.dim} "
          f"chains={settings.num_chains} tune={settings.num_tune} "
          f"draws={settings.num_draws}: init {init_s:.3f} s, warmup "
          f"{warm_s:.3f} s, posterior {post_s:.3f} s, total with trace "
          f"assembly {total_s:.3f} s, {n_grad / post_s:.6g} posterior "
          f"gradient evaluations/s ({n_grad} in the posterior, {n_warm} in "
          f"the warmup), launches {launches}")
    print(f"MCLMC data path posterior: max |mean - reference| "
          f"{mean_err:.4f} posterior std (gate {GLM_MEAN_TOL}), max |std / "
          f"reference - 1| {std_err:.4f} (gate {GLM_STD_TOL}), divergences "
          f"{n_div} (warmup "
          f"{int(trace.warmup_sample_stats['diverging'].sum())}), mean "
          f"n_steps {n_steps:.3f} (gate {MGLM_NSTEPS}), mean "
          f"|energy_change| "
          f"{float(np.abs(st['energy_change']).mean()):.4g}")
    require_glm_moments(mean_err, std_err)
    if n_div:
        raise AssertionError(f"{n_div} MCLMC divergences on the regression")
    if not MGLM_NSTEPS[0] < n_steps < MGLM_NSTEPS[1]:
        raise AssertionError(f"mean n_steps {n_steps} outside {MGLM_NSTEPS}")
    return launches


KERNELS = (
    ("nuts_fused_posterior", "nuts_fused_posterior.cu",
     "nuts_rs_tpu/kernels/nuts_pallas.py:82"),
    ("nuts_fused_warmup", "nuts_fused_warmup.cu",
     "nuts_rs_tpu/kernels/nuts_pallas.py:942"),
    ("mclmc_fused_posterior", "mclmc_fused_posterior.cu",
     "nuts_rs_tpu/kernels/mclmc_pallas.py:59"),
    ("mclmc_fused_warmup", "mclmc_fused_warmup.cu",
     "nuts_rs_tpu/kernels/mclmc_pallas.py:504"),
    ("nuts_fused_ld_posterior", "nuts_fused_ld_posterior.cu",
     "nuts_rs_tpu/kernels/nuts_pallas.py:124"),
    ("nuts_fused_ld_warmup", "nuts_fused_ld_warmup.cu",
     "nuts_rs_tpu/kernels/nuts_pallas.py:959"),
    ("nuts_fused_mid_posterior", "nuts_fused_mid_posterior.cu",
     "nuts_rs_tpu/kernels/nuts_pallas.py:84"),
    ("nuts_fused_mid_warmup", "nuts_fused_mid_warmup.cu",
     "nuts_rs_tpu/kernels/nuts_pallas.py:944"),
    ("mclmc_fused_mid_posterior", "mclmc_fused_mid_posterior.cu",
     "nuts_rs_tpu/kernels/mclmc_pallas.py:61"),
    ("mclmc_fused_mid_warmup", "mclmc_fused_mid_warmup.cu",
     "nuts_rs_tpu/kernels/mclmc_pallas.py:506"),
    ("nuts_fused_stream_posterior", "nuts_fused_stream_posterior.cu",
     "nuts_rs_tpu/kernels/nuts_pallas.py:217"),
)


def path_nuts(device, checks, launches, times):
    """NUTS at d=10: K1, K2."""
    from nuts_rs_tpu_torch import DiagNutsSettings
    from nuts_rs_tpu_torch.models.gaussian import normal_logp

    model = normal_logp(DIM, MU)
    settings = DiagNutsSettings(num_chains=CHAINS, num_tune=TUNE,
                                num_draws=DRAWS, seed=SEED,
                                posterior_kernel="pallas")
    checks["nuts_fused_posterior"] = check_posterior(
        model, settings.nuts_options(), device)
    checks["nuts_fused_warmup"] = check_warmup(model, settings, device)
    launches.update(main_path(model, settings, device,
                              ("nuts_fused_posterior", "nuts_fused_warmup")))
    times.update(time_kernels(model, settings, device))


def path_mclmc(device, checks, launches, times):
    """MCLMC at d=10: K3, K4."""
    from nuts_rs_tpu_torch.models.gaussian import normal_logp

    model = normal_logp(DIM, MU)
    msettings = mclmc_settings()
    checks["mclmc_fused_posterior"] = check_mclmc_posterior(model, msettings,
                                                            device)
    checks["mclmc_fused_warmup"] = check_mclmc_warmup(model, msettings,
                                                      device)
    launches.update(mclmc_main_path(model, msettings, device))
    times.update(time_mclmc_kernels(model, msettings, device))


def path_large_d(device, checks, launches, times):
    """NUTS at d=1000, the dim-on-lanes layout: K1-ld, K2-ld."""
    from nuts_rs_tpu_torch import DiagNutsSettings
    from nuts_rs_tpu_torch.models.gaussian import normal_logp

    ld_model = normal_logp(LD_DIM, MU)
    ld_settings = DiagNutsSettings(num_chains=LD_CHAINS, num_tune=LD_TUNE,
                                   num_draws=LD_DRAWS, seed=SEED,
                                   posterior_kernel="pallas")
    checks["nuts_fused_ld_posterior"] = check_posterior(
        ld_model, ld_settings.nuts_options(), device, "ld", LD_CHAINS,
        LD_STEP)
    checks["nuts_fused_ld_warmup"] = check_warmup(
        ld_model, ld_settings, device, "ld", LD_CHAINS,
        rows=CHECK_K2_SHORT_ROWS)
    launches.update(main_path(
        ld_model, ld_settings, device,
        ("nuts_fused_ld_posterior", "nuts_fused_ld_warmup"),
        what="large-d path"))
    times.update(time_kernels(ld_model, ld_settings, device, "ld", LD_CHAINS,
                              LD_STEP))


def path_data(device, checks, launches, times):
    """NUTS with model data at d=100: K1-args, K2-args (mid-d cl)."""
    from nuts_rs_tpu_torch import DiagNutsSettings
    from nuts_rs_tpu_torch.models.gaussian import (
        logistic_regression,
        normal_logp,
    )

    ref_mean, ref_std, ref = glm_reference()
    print(f"data path reference: {ref['engine']}, {ref['chains']} chains x "
          f"{ref['draws']} draws, Monte-Carlo error of a mean at most "
          f"{ref['max_mc_error_of_mean_in_std']:.4f} posterior std")
    glm = logistic_regression(GLM_ROWS, GLM_DIM, SEED).to(device)
    glm_settings = DiagNutsSettings(num_chains=GLM_CHAINS, num_tune=GLM_TUNE,
                                    num_draws=GLM_DRAWS, seed=SEED,
                                    posterior_kernel="pallas")
    time_glm_by_matmul(glm, device)
    checks["nuts_fused_mid_posterior"] = check_posterior(
        glm, glm_settings.nuts_options(), device, chains=GLM_CHAINS,
        name="K1-args",
        args=glm_posterior_inputs(glm, device, ref_mean, ref_std))
    checks["nuts_fused_mid_warmup"] = check_warmup(
        glm, glm_settings, device, chains=GLM_CHAINS, name="K2-args",
        rows=CHECK_K2_ARGS_ROWS)
    # the same kernels without data, on N(3, 1) at a d that had no kernel,
    # in logical blocks of 8 chains (clusters; the path runs chains alone)
    mid_model = normal_logp(MID_DIM, MU)
    mid_settings = DiagNutsSettings(num_chains=MID_CHAINS, num_tune=TUNE,
                                    num_draws=DRAWS, seed=SEED,
                                    posterior_kernel="pallas")
    check_posterior(mid_model, mid_settings.nuts_options(), device,
                    chains=MID_CHAINS, step=(0.45, 0.6), name="mid-d K1 B=8",
                    block=8)
    check_warmup(mid_model, mid_settings, device, chains=MID_CHAINS,
                 name="mid-d K2 B=8", block=8, rows=CHECK_K2_SHORT_ROWS)
    launches.update(glm_main_path(glm, glm_settings, device, ref_mean,
                                  ref_std)[0])
    times.update(time_kernels(
        glm, glm_settings, device, chains=GLM_CHAINS,
        k1=glm_posterior_inputs(glm, device, ref_mean, ref_std, seed=2)))


def path_mclmc_data(device, checks, launches, times):
    """MCLMC with model data at d=100: K3-args, K4-args (mid-d)."""
    from nuts_rs_tpu_torch import DiagMclmcSettings
    from nuts_rs_tpu_torch.models.gaussian import (
        logistic_regression,
        normal_logp,
    )

    glm = logistic_regression(GLM_ROWS, GLM_DIM, SEED).to(device)
    mid_model = normal_logp(MID_DIM, MU)
    mref_mean, mref_std, mref = glm_reference(MGLM_REFERENCE)
    print(f"MCLMC data path reference: {mref['engine']}, {mref['chains']} "
          f"chains x {mref['draws']} draws, {mref['divergences']} "
          f"divergences, {mref['mean_n_steps']:.3f} leapfrogs a draw, "
          "Monte-Carlo error of a mean at most "
          f"{mref['max_mc_error_of_mean_in_std']:.4f} posterior std")
    mglm_settings = DiagMclmcSettings(
        num_chains=GLM_CHAINS, num_tune=GLM_TUNE, num_draws=GLM_DRAWS,
        seed=SEED, posterior_kernel="pallas")
    checks["mclmc_fused_mid_posterior"] = check_mclmc_posterior(
        glm, mglm_settings, device, name="K3-args",
        state=glm_posterior_inputs(glm, device, mref_mean, mref_std))
    checks["mclmc_fused_mid_warmup"] = check_mclmc_warmup(
        glm, mglm_settings, device, name="K4-args",
        micro_state=glm_posterior_inputs(glm, device, mref_mean, mref_std,
                                         seed=3),
        # the Euclidean rows too: from the initial state their plain version
        # took 45-65 s of the script (hundreds of halving iterations)
        euclid_state=glm_posterior_inputs(glm, device, mref_mean, mref_std,
                                          seed=4))
    # the same kernels without data, on N(3, 1) at d=100, in logical blocks
    # of 8 chains (clusters; the path runs chains alone)
    mmid_settings = DiagMclmcSettings(
        num_chains=MID_CHAINS, num_tune=TUNE, num_draws=DRAWS, seed=SEED,
        posterior_kernel="pallas")
    check_mclmc_posterior(
        mid_model, mmid_settings, device, name="mid-d K3 B=8", block=8,
        state=posterior_inputs(mid_model, device, chains=MID_CHAINS,
                               step=(0.45, 0.6)))
    check_mclmc_warmup(mid_model, mmid_settings, device, name="mid-d K4 B=8",
                       block=8)
    launches.update(mclmc_glm_main_path(glm, mglm_settings, device, mref_mean,
                                        mref_std))
    times.update(time_mclmc_kernels(
        glm, mglm_settings, device,
        state=glm_posterior_inputs(glm, device, mref_mean, mref_std, seed=2)))


def path_stream(device, checks, launches, times):
    """NUTS with streamed data, 131072 rows at d=100: the sync engine for
    the warmup, K1-stream for the posterior."""
    from nuts_rs_tpu_torch import DiagNutsSettings
    from nuts_rs_tpu_torch.kernels import nuts_fused as nf
    from nuts_rs_tpu_torch.models.gaussian import logistic_regression

    ref_mean, ref_std, ref = glm_reference(BIG_REFERENCE)
    print(f"streamed-data path reference: {ref['engine']}, {ref['chains']} "
          f"chains x {ref['draws']} draws, {ref['mean_n_steps']:.2f} "
          "leapfrogs a draw, Monte-Carlo error of a mean at most "
          f"{ref['max_mc_error_of_mean_in_std']:.4f} posterior std")
    big = logistic_regression(BIG_ROWS, GLM_DIM, SEED).to(device)
    settings = DiagNutsSettings(num_chains=BIG_CHAINS, num_tune=BIG_TUNE,
                                num_draws=BIG_DRAWS, seed=SEED,
                                posterior_kernel="pallas")
    opts = settings.nuts_options()
    print(f"streamed-data path: {big.data_bytes / 1e6:.1f} MB of data in "
          f"{-(-BIG_ROWS // big.stream_tile_rows)} tiles of "
          f"{big.stream_tile_rows} rows")
    matmul_ms, _ = time_glm_by_matmul(big, device, BIG_CHAINS)
    checks["nuts_fused_stream_posterior"] = check_posterior(
        big, opts, device, name="K1-stream", stream=True,
        args=glm_posterior_inputs(big, device, ref_mean, ref_std,
                                  chains=BIG_CHECK_CHAINS))
    got, warm_s = glm_main_path(
        big, settings, device, ref_mean, ref_std,
        kernels=("nuts_fused_stream_posterior",), what="streamed-data path")
    want = -(-BIG_DRAWS // CHUNK)
    if got["nuts_fused_stream_posterior"] != want:
        raise AssertionError(f"K1-stream launched {got} times, not {want}")
    launches.update(got)
    print(f"sync engine: {warm_s / BIG_TUNE:.4f} s per warmup draw "
          f"({BIG_TUNE} draws of {BIG_CHAINS} chains in lock step, "
          f"{warm_s:.2f} s)")
    k1 = glm_posterior_inputs(big, device, ref_mean, ref_std, seed=2,
                              chains=BIG_CHAINS)
    # one timed call and no first one: the path has just run this kernel, and
    # a launch takes seconds
    box = []
    ms = cuda_events_ms(lambda: box.append(nf.nuts_fused_run(
        3, *k1, CHUNK, big, opts, 0.1, stream=True)), 1)
    b_ms, b_by = bound("nuts", big, k1, box[0], box[0][4])
    times["nuts_fused_stream_posterior"] = (ms, b_ms, b_by)
    evals = float(box[0][4]["n_steps"].sum())
    print(f"time nuts_fused_stream_posterior: {ms:.4f} ms per {CHUNK}-draw "
          f"launch at C={BIG_CHAINS} d={big.dim} N={BIG_ROWS}; bound "
          f"{b_ms:.5f} ms ({b_by}); the two products of one batched "
          f"evaluation by torch.matmul take {matmul_ms:.4f} ms "
          f"({evals / CHUNK / BIG_CHAINS:.2f} evaluations a draw and chain)")


PATHS = {"nuts": path_nuts, "mclmc": path_mclmc, "large_d": path_large_d,
         "data": path_data, "mclmc_data": path_mclmc_data,
         "stream": path_stream}
# the sources each path launches (the smem-size helpers of the mid-d and ld
# warmup kernels live in their posterior sources)
PATH_SOURCES = {
    "nuts": ("nuts_fused_posterior", "nuts_fused_warmup"),
    "mclmc": ("mclmc_fused_posterior", "mclmc_fused_warmup"),
    "large_d": ("nuts_fused_ld_posterior", "nuts_fused_ld_warmup"),
    "data": ("nuts_fused_mid_posterior", "nuts_fused_mid_warmup"),
    "mclmc_data": ("mclmc_fused_mid_posterior", "mclmc_fused_mid_warmup"),
    "stream": ("nuts_fused_stream_posterior",),
}


def ptxas_summary(stem, log):
    """One line for a source from nvcc's ``-Xptxas -v`` output (kept whole in
    ``log``): its entry functions, the most registers and stack bytes of any,
    and the bytes spilled by all."""
    if not log.exists():
        return f"ptxas {stem}: built before this run"
    text = log.read_text()
    regs = [int(n) for n in re.findall(r"Used (\d+) registers", text)]
    stack = [int(n) for n in re.findall(r"(\d+) bytes stack frame", text)]
    spill = [int(n) for n in re.findall(r"(\d+) bytes spill stores", text)]
    return (f"ptxas {stem}: {len(regs)} entry functions, at most "
            f"{max(regs, default=0)} registers and {max(stack, default=0)} "
            f"bytes of stack, {sum(spill)} bytes of spill stores in all")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", choices=sorted(PATHS), default=None,
                    help="drive this path alone and build only its kernels")
    only = ap.parse_args(argv).only
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA card "
                           "(torch.cuda.is_available() is false)")
    from nuts_rs_tpu_torch.kernels import _build

    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(card)
    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                          text=True, check=True, timeout=60)
    print(f"nvcc: {nvcc.stdout.strip().splitlines()[-1]}; torch "
          f"{torch.__version__} (CUDA {torch.version.cuda})")
    paths = [only] if only else list(PATHS)
    stems = [stem for path in paths for stem in PATH_SOURCES[path]]
    t0 = time.monotonic()
    _build.build(stems)
    print(f"build: {time.monotonic() - t0:.1f} s ({len(stems)} sources, one "
          f"nvcc each, together, into {_build.BUILD_DIR})")
    for stem in stems:
        print("  " + ptxas_summary(stem, _build.BUILD_DIR / f"build_{stem}.log"))

    checks, launches, times = {}, {}, {}
    for path in paths:
        t0 = time.monotonic()
        PATHS[path](device, checks, launches, times)
        print(f"path {path}: {time.monotonic() - t0:.1f} s")

    kernels = []
    for name, source, replaces in KERNELS:
        if name not in checks:
            continue  # --only: another path's kernel
        chunk_ms, chunk_bound_ms, chunk_bound_by = times[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "nuts_rs_tpu_torch/csrc/" + source,
            "replaces": replaces, "launches": launches[name],
            **checks[name], "library_ms": None, "chunk_ms": chunk_ms,
            "chunk_bound_ms": chunk_bound_ms,
            "chunk_bound_by": chunk_bound_by})
    if not only and len(kernels) != len(KERNELS):
        raise AssertionError("a kernel of the table was not checked")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
