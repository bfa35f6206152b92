#!/usr/bin/env python3
"""Where the time of the port's main paths goes, on one CUDA card.

Run from the repository root on a machine with one NVIDIA GPU:

    python3 profile_main_path.py [--repeats 3] [--trace trace.json]

The paths are chip_smoke.py's: ``Sampler(...)`` and ``run()`` with
``posterior_kernel="pallas"`` on N(3, 1) at d=10 with 1024 chains, 300
tuning and 700 posterior draws, with ``DiagNutsSettings`` (kernels K1, K2)
and with ``DiagMclmcSettings`` (K3, K4), the large-d path: NUTS at
d=1000 with 512 chains, 200 tuning and 300 posterior draws (K1-ld, K2-ld),
the data path: NUTS on logistic regression with 1000 rows and 100
columns, 1024 chains, 300 tuning and 400 posterior draws (K1-args, K2-args),
and the MCLMC data path: the same model and sizes with
``DiagMclmcSettings`` (K3-args, K4-args).
After building the kernels it prints, for each path,

1. for ``--repeats`` unprofiled runs: the total seconds, Sampler
   construction (init and init search), and for every chunk the runner's
   host seconds, the wait for the device after it and the rest of the
   chunk (stats to the host and into storage), then ``finalize``;
2. for one run under ``torch.profiler``: the device time per kernel or
   copy, and the device's busy share of the profiled wall (``--trace``
   also writes a Chrome trace, one file per path);
3. each kernel's milliseconds per 128-draw launch at chain blocks
   B = 8 ... 128 (the ld kernels: 1 ... 8, their cluster sizes; CUDA
   events, same inputs), and at the default block the fused posterior's
   loop iterations per block and leapfrogs per draw;
4. for the ld kernels, milliseconds per 128-draw launch and microseconds
   per block iteration at d = 256 ... 2048 with 512 chains;
5. K1-ld per 128-draw launch at B = 1 ... 8 on the states the large-d
   path's own warmup ends in (adapted step sizes and mass matrices, not
   the made-up states of 3), with each block's iterations: what the
   block's wait for its slowest chain costs on the path itself; then the
   same at B = 1 and B = 8 on the first 64 ... 264 of those chains, around
   the card's 132 SMs (where a second wave of blocks or clusters starts);
6. for the data path, the same own-state sweep of K1-args (B = 1 ... 8,
   then 120 ... 1024 chains), and the mid-d posterior kernel without data
   (N(3, 1) at d=100, 1024 chains) beside it, in microseconds per block
   iteration: the difference is what the regression's evaluation costs;
7. for the MCLMC data path, the own-state sweep of K3-args (B = 1 ... 8,
   then 120 ... 1024 chains: how many chain blocks the card holds at once),
   and the mid-d MCLMC posterior kernel without data (N(3, 1) at d=100, 1024
   chains) beside it: what a trajectory's iteration costs beside the
   evaluation.

8. for the streamed-data path (``--only-stream``: NUTS on the regression
   with 131072 rows, 256 chains, 300 tuning and 400 posterior draws; the
   per-draw sync engine, then K1-stream), one run with its phases: Sampler
   construction, the seconds of every warmup chunk with the tree iterations
   the chains took in lock step, the posterior chunks split as in 1; then
   what a tree iteration of the sync engine costs beside the model's batched
   evaluation alone and its two products by ``torch.matmul``; then K1-stream
   per 128-draw launch on the path's own post-warmup states: on all 256
   chains in one logical block (the JAX runner's pick) and in blocks of 128
   and 64 run one after another, and on the first 64 and 128 chains, in
   microseconds per round of evaluations and the share of the card's FP32
   issue rate that the two products take.
9. for the model zoo's two paths (``--only-zoo``: stochastic volatility at
   T = 1000 with 512 chains, 400 tuning and 300 posterior draws on
   K2-ld-args / K1-ld-args; radon with 1024 chains, 300 + 400 draws on
   K2-args / K1-args), items 1 and 2: the chunks' host and device split
   and the device's busy share under the profiler.
10. for the flow path (``--only-flow``: ``funnel(10)`` under
   ``FlowNutsSettings`` with the default coupling flow, 256 chains, 600
   tuning and 600 posterior draws, the JAX package's flow benchmark), one
   run: every warmup chunk of the per-draw sync engine with its tree
   iterations in lock step, ms each, and the refits' seconds, the posterior
   chunks on K1-flow, end to end; a warmup draw at the tuned state under the
   profiler (device busy); K1-flow on the path's own post-warmup states at
   B = 1 ... 8.  ``--log FILE`` appends its lines to FILE as they come (a
   long run's partial record).  Only ``--only-flow`` runs it: the full
   configuration takes about 11 minutes, more than all the other items.
11. ``--stream-launch TREE [TREE ...]``: K1-stream's 128-draw launch on
   ``chip_smoke.py``'s made-up states (256 chains, 131072 rows), in a
   process of its own for each checkout given, built from that checkout:
   an earlier commit unpacked beside this one (``git archive``) is timed
   the same way in the same call (parent, this, this, parent).
12. ``--sv-launch TREE [TREE ...]``: on the SV path (T = 1000, 512 chains),
   K1-ld-args' first 128-draw posterior launch on the path's own
   post-warmup states and K2-ld-args' first full 128-row warmup launch on
   the path's own warmup states, in a process of its own for each checkout
   given, with their leapfrogs, block iterations, bounds and the SV
   instantiation's ptxas line, the launches' inputs saved; then each
   checkout in the order given (parent, this, this, parent) on every saved
   set, so that two checkouts are timed on the same states; then, in this
   checkout, the ablation of K1-ld-args on its saved posterior states with
   every tree forced to maxdepth 7 (the same 127 leapfrogs a draw for any
   model): one chain block an SM and two, each as it is, without SV's two
   scans and their barriers, and without its three barriers alone, and
   K1-ld on the iid normal at d = 1002 from the same states; in
   microseconds of an SM and of one chain a leapfrog, with the blocks an
   SM of each.
13. ``--data-launch TREE [TREE ...]``: as item 12 for the mid-d kernels on
   the data path (logistic regression, 1000 rows, d = 100, 1024 chains) and
   the radon path (1024 chains): K1-args' first 128-draw posterior launch
   on the path's own post-warmup states and K2-args' first full 128-row
   warmup launch (draws 2-130) on its own warmup states, in a process of its
   own for each checkout given, with their leapfrogs, block iterations,
   bounds and the chains a CUDA block (G) and blocks an SM where the
   checkout has them, the launches' inputs saved; then each checkout in the
   order given (parent, this, this, parent) on every saved set; then the
   ablation: K1-args on this checkout's saved states with every tree forced
   to maxdepth 3 (32 draws of 7 leapfrogs), in every checkout given, and in
   this one also without the model's evaluation, in microseconds a block
   iteration and of an SM a chain's leapfrog.
14. ``--mclmc-data-launch TREE [TREE ...]``: as item 13 for the mid-d MCLMC
   kernels on the MCLMC data path (the regression, 1024 chains, 300 + 400
   draws): K3-args' first 128-draw posterior launch on the path's own
   post-warmup states, K4-args' Euclidean launch (draws 0-90) and its first
   microcanonical chunk (draws 90-218) on the path's own warmup states,
   and K3-args' first posterior launch on the own states of each functor's
   MCLMC path at its card-test or zoo shape (the iid normal at d = 100 with
   1024 and 256 chains, radon with 1024, the rank-1 normal, the funnel,
   correlated_normal and stochastic volatility at T = 300 with 256), in a
   process of its own for each checkout given, with leapfrogs, block
   iterations, bounds and the chains a CUDA block (G) and blocks an SM
   where the checkout has them, the inputs saved; then each checkout in the
   order given (parent, this, this, parent) on every saved set, in ms a
   launch, us a block iteration and us of an SM a chain's leapfrog; then,
   in this checkout, the ablation of K3-args on its saved regression states
   (32 draws of a fixed 6 leapfrogs, no halvings), with the evaluation and
   without it.
15. ``--ld-launch TREE [TREE ...]``: as item 12 for K1-ld and K2-ld on the
   large-d path (N(3, 1) at d = 1000, 512 chains, 200 + 300 draws): K1-ld's
   first 128-draw posterior launch on the path's own post-warmup states (at
   the path's B = 8 and at B = 1) and K2-ld's first full 128-row warmup
   launch (draws 2-130) on its own warmup states, in a process of its own
   for each checkout given, with leapfrogs, block iterations, bounds, the
   form, chain blocks an SM and resident clusters of 8 where the checkout
   has them, and the ptxas lines of both sources, the launches' inputs
   saved; then each checkout in the order given (parent, this, this,
   parent) on every saved set; then, in this checkout, the ablation of
   K1-ld on its saved posterior states with every tree at maxdepth 4 (15
   leapfrogs a draw, the path's own trees; NRT_ABLATE_FIXED_TREES), each
   build of ``LD_ABLATIONS`` (today's leapfrog and the merged one, at one
   and two blocks an SM, the merged one also without the early loads, and
   both with NRT_LD_CLOCKS: chain 0's SM cycles a leapfrog in the pass, its
   reduction, the checks after it and the scalar tree) with its ptxas line
   and SASS instruction counts: microseconds a leapfrog of one chain alone
   (132 chains, one an SM) and of each of two chains sharing an SM (264
   chains), and of an SM a leapfrog at the path's 512 chains in clusters
   of 8.
16. ``--flow-launch TREE [TREE ...]``: K1-flow's first 128-draw posterior
   launch on the flow path's own post-warmup states, saved once in this
   checkout: ``chip_smoke.py``'s cut path (64 chains, 30 tuning draws) and,
   with ``--flow-full``, the full configuration (256 chains, 600 tuning
   draws, about 11 minutes of sync warmup); then each checkout in the order
   given (parent, this, this, parent) on every saved set at B = 1, 2, 4 and
   8 (the cut path's 64 chains tiled to 256, as ``chip_smoke.py`` times
   them), in ms a launch, block iterations and us each, with the flow's
   form and chain blocks an SM where the checkout has them and the ptxas
   lines of the funnel's instantiations; then, in this checkout, the
   ablation of K1-flow on the cut path's saved states with every tree at
   maxdepth 4 (15 leapfrogs a draw; NRT_ABLATE_FIXED_TREES), each build of
   ``FLOW_ABLATIONS`` (the warp form at one and two chain blocks an SM,
   today's form, the flow's passes left out, the warp form with block
   barriers, with bank conflicts, with today's loops, and both forms with
   NRT_FLOW_CLOCKS: chain 0's SM cycles an evaluation in the forward pass,
   the model, the backward pass and the rest of the block iteration), in
   us a block iteration of one chain alone on an SM (132 chains), of two
   chains an SM (264) and at 256 chains.
17. ``--mclmc-launch TREE [TREE ...]``: on the MCLMC d = 10 path (N(3, 1),
   1024 chains, 300 + 700 draws), K3's first 128-draw posterior launch on
   the path's own tuned state, K4's Euclidean launch (draws 0-90) and its
   first microcanonical chunk (draws 90-218) on the path's own warmup
   states, saved once in this checkout; then each checkout in the order
   given (parent, this, this, parent) on the saved launches, in ms a launch
   and us a block iteration, and the path end to end by items 1 and 2 (one
   warm-up run, three repeats, one profiled run); then, in this checkout,
   the same launches in builds of ``MCLMC_D10_ABLATIONS``: a chain's lanes
   fixed at 1, 4, 8 and 16 (NRT_MCLMC_LANES), and at the rule's lanes and
   at one lane without the Box-Muller normals (NRT_ABLATE_MCLMC_NORMALS),
   with approximate divisions in the ESH step and the refresh
   (NRT_ABLATE_MCLMC_DIVISIONS) and with both.
18. ``--nuts-launch TREE [TREE ...]``: on the NUTS d = 10 path (N(3, 1),
   1024 chains, 300 + 700 draws), K1's first 128-draw posterior launch on
   the path's own tuned state and K2's first full chunk (draws 2-130) on
   the path's own warmup state, saved once in this checkout; then each
   checkout in the order given (parent, this, this, parent) on the saved
   launches, in ms a launch and us a block iteration, and the path end to
   end by items 1 and 2 (one warm-up run, three repeats, one profiled run);
   then, in this checkout, the same launches in builds of
   ``NUTS_D10_ABLATIONS``: a chain's lanes fixed at 1, 2, 8 and 16
   (NRT_NUTS_LANES; the rule's are 4), 8 and 16 lanes in blocks of at most
   512 threads (NRT_NUTS_MAX_THREADS: up to 128 registers a thread), the
   fresh momentum's normals without the hashes and Box-Muller
   (NRT_ABLATE_NUTS_NORMALS) at the rule's lanes and at one lane, and the
   checkpoint stacks in shared memory (NRT_NUTS_SMEM_STACKS) at the rule's
   lanes and at 16 lanes with 128 registers; then each build's registers,
   stack and spills an instantiation.
19. for the sync MCLMC path (``--only-mclmc-sync``: chip_smoke.py's, the
   MCLMC main configuration on the sync MCLMC engine with four extra
   stores; no kernel is built), one run with each chunk's seconds, the host
   loop's iterations a draw, their milliseconds and the successful
   leapfrogs an iteration; then 20 draws at the tuned state under
   torch.profiler: the device's busy share and its kernels an iteration.

The card's name and power limit come first.  Every number is this run's.
"""

from __future__ import annotations

import argparse
import collections
import re
import subprocess
import sys
import time

import numpy as np
import torch

# the streamed-data path at the JAX benchmark's draws (chip_smoke.py cuts them)
from chip_smoke import BIG_FULL_DRAWS as BIG_DRAWS
from chip_smoke import BIG_FULL_TUNE as BIG_TUNE
from chip_smoke import (
    BIG_CHAINS, BIG_ROWS, CHAINS, CHUNK, DIM, DRAWS, FLOW_CHAINS, FLOW_DIM,
    FLOW_FULL_CHAINS, FLOW_FULL_DRAWS, FLOW_FULL_TUNE, FLOW_TUNE, GLM_CHAINS,
    GLM_DIM, GLM_DRAWS, GLM_ROWS, GLM_TUNE, LD_CHAINS, LD_DIM, LD_DRAWS,
    LD_STEP, LD_TUNE, MGLM_REFERENCE, MID_DIM, MSYNC_STORES, MU, PATH_SOURCES,
    RADON_CHAINS,
    RADON_DRAWS, RADON_TUNE, SEED, SV_CHAINS, SV_DRAWS, SV_T, SV_TUNE, TUNE,
    card_line,
    cuda_events_ms, glm_posterior_inputs, glm_reference, mclmc_posterior_args,
    mclmc_settings, mclmc_warmup_setup, posterior_inputs, warmup_setup)

BLOCKS = (8, 16, 32, 64, 128)
LD_BLOCKS = (1, 2, 4, 8)
LD_SWEEP_DIMS = (256, 512, 1000, 2048)
# chain counts around the card's 132 SMs: where a launch of one chain block
# an SM goes from one wave of blocks (or clusters) to two
LD_WAVE_CHAINS = (64, 96, 104, 112, 120, 128, 136, 264)
GLM_WAVE_CHAINS = (120, 128, 256, 512, 1024)


def run_main_path(model, settings, device):
    """One Sampler construction, run and finalize, timed per chunk.
    Returns (total_s, init_s, chunks, finalize_s, trace) with chunks a list
    of (first_draw, end_draw, runner_s, wait_s, rest_s)."""
    from nuts_rs_tpu_torch import Sampler

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    t0 = time.perf_counter()
    sampler = Sampler(model, settings, device=device)
    sync()
    init_s = time.perf_counter() - t0
    split = []

    def timed(runner):
        def run(state, flags):
            t = time.perf_counter()
            out = runner(state, flags)
            t_host = time.perf_counter()
            sync()
            split.append((t_host - t, time.perf_counter() - t_host))
            return out
        return run

    sampler._phase_runners = [(a, b, timed(r))
                              for a, b, r in sampler._phase_runners]
    chunks = []
    while not sampler.finished:
        t = time.perf_counter()
        lo, stats, _ = sampler.run_next_chunk()
        chunk_s = time.perf_counter() - t
        runner_s, wait_s = split[-1]
        chunks.append((lo, lo + stats["n_steps"].shape[1], runner_s, wait_s,
                       chunk_s - runner_s - wait_s))
    t = time.perf_counter()
    trace = sampler.trace.finalize()
    finalize_s = time.perf_counter() - t
    return time.perf_counter() - t0, init_s, chunks, finalize_s, trace


def print_run(label, result, tune):
    total_s, init_s, chunks, finalize_s, trace = result
    warm = int(trace.warmup_sample_stats["n_steps"].sum())
    post = int(trace.sample_stats["n_steps"].sum())
    post_s = sum(c[2] + c[3] + c[4] for c in chunks if c[0] >= tune)
    print(f"{label}: total {total_s:.4f} s, init {init_s:.4f} s, finalize "
          f"{finalize_s:.4f} s, posterior chunks {post_s:.4f} s "
          f"({post / post_s:.6g} gradient evaluations/s), gradient "
          f"evaluations warmup {warm} posterior {post}")
    for lo, hi, runner_s, wait_s, rest_s in chunks:
        print(f"  chunk {lo}-{hi}: runner (host) {runner_s:.4f} s, device "
              f"wait {wait_s:.4f} s, stats to host + record {rest_s:.4f} s")


def profile_once(model, settings, device, trace_path=None):
    """One main-path run under torch.profiler: device seconds per kernel or
    copy and the busy share of the profiled wall."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_main_path(model, settings, device)
        wall_s = time.perf_counter() - t0
    per_name = collections.defaultdict(lambda: [0, 0.0])
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            entry = per_name[e.name[:70]]
            entry[0] += 1
            entry[1] += e.time_range.elapsed_us() * 1e-6
    busy_s = sum(s for _, s in per_name.values())
    print(f"profiled wall {wall_s:.4f} s, device busy {busy_s:.4f} s "
          f"({100 * busy_s / wall_s:.1f}%)")
    for name, (n, s) in sorted(per_name.items(), key=lambda kv: -kv[1][1])[:8]:
        print(f"  device {s * 1e3:.3f} ms in {n} launches: {name}")
    if trace_path:
        prof.export_chrome_trace(trace_path)
        print(f"  chrome trace: {trace_path}")


def nuts_launches(model, settings, device, layout="cl",
                  step=(0.8, 1.0), k1=None):
    """(posterior, warmup) launches of K1 and K2 (or K1-ld and K2-ld, or the
    mid-d kernels with the posterior inputs ``k1``) at a chain block B, and
    the posterior's stats, on the path's shapes."""
    from nuts_rs_tpu_torch.kernels import nuts_fused as nf

    opts = settings.nuts_options()
    chains = settings.num_chains
    if k1 is None:
        k1 = posterior_inputs(model, device, seed=2, chains=chains, step=step)
    k2 = warmup_setup(model, settings, device, 2, 2 + CHUNK, chains)
    return (lambda B: nf.nuts_fused_run(3, *k1, CHUNK, model, opts, 0.1,
                                        B, layout)[4],
            lambda B: nf.nuts_fused_warmup_run(*k2, B, layout))


def ld_launches(model, settings, device):
    return nuts_launches(model, settings, device, "ld", LD_STEP)


def glm_launches(model, settings, device):
    """K1-args and K2-args on made-up states around the JAX package's
    posterior of the regression."""
    ref_mean, ref_std, _ = glm_reference()
    return nuts_launches(model, settings, device, k1=glm_posterior_inputs(
        model, device, ref_mean, ref_std, seed=2,
        chains=settings.num_chains))


def mclmc_launches(model, settings, device):
    """The same for K3 and K4 (K4 on the microcanonical warmup rows)."""
    from nuts_rs_tpu_torch import MclmcTrajectoryKind
    from nuts_rs_tpu_torch.kernels import mclmc_fused as mf

    k3, mopts = mclmc_posterior_args(model, settings, device, seed=2)
    jitter = settings.step_size_settings.jitter
    sw = settings.switch_draw
    k4 = mclmc_warmup_setup(model, settings, device, sw, sw + CHUNK,
                            MclmcTrajectoryKind.MICROCANONICAL)
    return (lambda B: mf.mclmc_fused_run(3, *k3, CHUNK, model, mopts, jitter,
                                         B)[5],
            lambda B: mf.mclmc_fused_warmup_run(*k4, B))


def mclmc_data_launches(model, settings, device):
    """K3-args and K4-args on made-up states around the JAX package's MCLMC
    posterior of the regression (K4-args on the microcanonical warmup
    rows)."""
    from nuts_rs_tpu_torch import MclmcTrajectoryKind
    from nuts_rs_tpu_torch.kernels import mclmc_fused as mf

    ref_mean, ref_std, _ = glm_reference(MGLM_REFERENCE)
    state = glm_posterior_inputs(model, device, ref_mean, ref_std, seed=2,
                                 chains=settings.num_chains)
    k3, mopts = mclmc_posterior_args(model, settings, device, seed=2,
                                     state=state)
    jitter = settings.step_size_settings.jitter
    sw = settings.switch_draw
    k4 = mclmc_warmup_setup(model, settings, device, sw, sw + CHUNK,
                            MclmcTrajectoryKind.MICROCANONICAL, state)
    return (lambda B: mf.mclmc_fused_run(3, *k3, CHUNK, model, mopts, jitter,
                                         B)[5],
            lambda B: mf.mclmc_fused_warmup_run(*k4, B))


def sweep_blocks(launches, blocks, chains):
    """ms per 128-draw launch of each kernel at every chain block size."""
    post, warm = launches
    for B in blocks:
        post(B)
        warm(B)
        print(f"B={B}: blocks {chains // B}, posterior "
              f"{cuda_events_ms(lambda: post(B), 3):.4f} ms, warmup "
              f"{cuda_events_ms(lambda: warm(B), 3):.4f} ms per "
              f"{CHUNK}-draw launch")
    out = post(None)
    iters = out["loop_iterations"].cpu().numpy()
    print(f"posterior loop iterations per block (default B): min "
          f"{iters.min()} max {iters.max()}; leapfrogs per draw mean "
          f"{float(np.mean(out['n_steps'].cpu().numpy())):.4f}")


def sweep_ld_dims(settings, device):
    """K1-ld per 128-draw launch against d, with the same step size and
    chains: what of a block iteration grows with the coordinates a thread
    owns, and what does not."""
    from nuts_rs_tpu_torch.models.gaussian import normal_logp

    for dim in LD_SWEEP_DIMS:
        model = normal_logp(dim, MU)
        post, _ = ld_launches(model, settings, device)
        out = post(None)
        ms = cuda_events_ms(lambda: post(None), 3)
        iters = float(out["loop_iterations"].float().mean())
        print(f"ld d={dim}: posterior {ms:.4f} ms per {CHUNK}-draw launch, "
              f"{iters:.0f} block iterations, {1e3 * ms / iters:.3f} us an "
              f"iteration, leapfrogs per draw "
              f"{float(out['n_steps'].mean()):.3f}")


def sweep_ld_own_states(model, settings, device, layout="ld", name="K1-ld",
                        waves=LD_WAVE_CHAINS):
    """K1-ld (or, with ``layout="cl"``, the mid-d posterior kernel) at every
    cluster size on the post-warmup state of the path itself: the Sampler
    runs its tuning chunks, then the posterior runner's launch
    (chain.py::make_fused_posterior_runner) is repeated here at each chain
    block B on that state.  Returns the launch at the default block as
    (ms, mean block iterations)."""
    from nuts_rs_tpu_torch.kernels import nuts_fused as nf

    model, state, config, step, bars = tuned_state(model, settings, device)
    t = state.transform

    def post(B, n=settings.num_chains):
        return nf.nuts_fused_run(
            5, state.pt.q[:n], state.pt.g[:n], state.pt.logp[:n], t.stds[:n],
            t.mean[:n], t.logdet[:n], step[:n], bars[:n], CHUNK, model,
            config.nuts, config.step_size.jitter, B, layout)[4]

    return sweep_own_states(post, name, waves)[LD_BLOCKS[-1]]


def tuned_state(model, settings, device):
    """(model on the device, chain state, config, first step, step bars)
    after the Sampler ran the path's own tuning chunks."""
    from nuts_rs_tpu_torch import Sampler
    from nuts_rs_tpu_torch.adapt import step_size as ss

    sampler = Sampler(model, settings, device=device)
    while sampler._next_draw < settings.num_tune:
        sampler.run_next_chunk()
    state, config = sampler.state, sampler.config
    step = state.step.step_size
    print(f"own states after {sampler._next_draw} tuning draws: step size "
          f"min {float(step.min()):.4f} median {float(step.median()):.4f} "
          f"max {float(step.max()):.4f}")
    return (sampler.model, state, config, step,
            ss.step_size_bar(state.step, config.step_size))


def sweep_own_states(post, name, waves):
    """``post(B, n)``, a posterior launch's stats on the first n chains of
    the path's own state at chain block B, timed at every cluster size and
    then at B = 1 and 8 on the first n chains for n in ``waves``.  Returns
    {B: (ms, mean block iterations)}."""
    by_block = {}
    for B in LD_BLOCKS:
        out = post(B)
        ms = cuda_events_ms(lambda: post(B), 3)
        iters = out["loop_iterations"].cpu().numpy()
        steps = out["n_steps"].cpu().numpy()
        print(f"own states B={B}: {name} {ms:.4f} ms per {CHUNK}-draw launch; "
              f"block iterations min {iters.min()} mean {iters.mean():.1f} "
              f"max {iters.max()}; leapfrogs per draw mean "
              f"{steps.mean():.4f} min {steps.min()} max {steps.max()}")
        by_block[B] = (ms, float(iters.mean()))
    # the first n of those chains: a step in the time between two counts is
    # a second wave, and tells how many blocks or clusters the card holds
    for n in waves:
        post(1, n), post(8, n)
        print(f"own states, first {n} chains: {name} B=1 "
              f"{cuda_events_ms(lambda: post(1, n), 3):.4f} ms, B=8 "
              f"{cuda_events_ms(lambda: post(8, n), 3):.4f} ms per "
              f"{CHUNK}-draw launch")
    return by_block


def evaluation_cost(glm, glm_settings, device):
    """What the regression's evaluation costs inside K1-args: the kernel on
    the data path's own post-warmup states beside the same kernel without
    data, on N(3, 1) at the same d and chains, in microseconds per block
    iteration of a launch."""
    from nuts_rs_tpu_torch import DiagNutsSettings
    from nuts_rs_tpu_torch.models.gaussian import normal_logp

    ms_g, it_g = sweep_ld_own_states(glm, glm_settings, device, "cl",
                                     "K1-args", GLM_WAVE_CHAINS)
    plain = DiagNutsSettings(num_chains=GLM_CHAINS, num_tune=GLM_TUNE,
                             num_draws=GLM_DRAWS, seed=SEED,
                             posterior_kernel="pallas")
    ms_n, it_n = sweep_ld_own_states(normal_logp(MID_DIM, MU), plain, device,
                                     "cl", "mid-d K1 without data", ())
    print(f"per block iteration of a {CHUNK}-draw launch at {GLM_CHAINS} "
          f"chains, B=8: K1-args {1e3 * ms_g / it_g:.3f} us, the same kernel "
          f"on N(3, 1) at d={MID_DIM} {1e3 * ms_n / it_n:.3f} us")


def sweep_mclmc_own_states(model, settings, device, name,
                           waves=GLM_WAVE_CHAINS):
    """The mid-d MCLMC posterior kernel at every cluster size on the
    post-warmup state of the path itself: the Sampler runs its tuning
    chunks, then the posterior runner's launch
    (chain.py::make_fused_mclmc_posterior_runner) is repeated here at each
    chain block B on that state, and at B = 1 and 8 on its first n chains.
    Returns the launch at B = 1 as (ms, mean block iterations)."""
    from nuts_rs_tpu_torch import MclmcTrajectoryKind
    from nuts_rs_tpu_torch.kernels import mclmc_fused as mf

    model, state, config, step, bars = tuned_state(model, settings, device)
    t = state.transform
    mopts = settings._mclmc_options(MclmcTrajectoryKind.MICROCANONICAL)

    def post(B, n=settings.num_chains):
        return mf.mclmc_fused_run(
            5, state.pt.q[:n], state.pt.g[:n], state.pt.logp[:n],
            state.pt.v[:n].contiguous(), t.stds[:n], t.mean[:n],
            t.logdet[:n], step[:n], bars[:n], CHUNK, model, mopts,
            config.step_size.jitter, B)[5]

    return sweep_own_states(post, name, waves)[1]


def mclmc_iteration_cost(glm, glm_settings, device):
    """What a trajectory's iteration costs beside the regression's
    evaluation inside K3-args: the kernel on the MCLMC data path's own
    post-warmup states beside the same kernel without data, on N(3, 1) at
    the same d and chains, in microseconds per iteration of a launch."""
    from nuts_rs_tpu_torch import DiagMclmcSettings
    from nuts_rs_tpu_torch.models.gaussian import normal_logp

    ms_g, it_g = sweep_mclmc_own_states(glm, glm_settings, device, "K3-args")
    plain = DiagMclmcSettings(num_chains=GLM_CHAINS, num_tune=GLM_TUNE,
                              num_draws=GLM_DRAWS, seed=SEED,
                              posterior_kernel="pallas")
    ms_n, it_n = sweep_mclmc_own_states(
        normal_logp(MID_DIM, MU), plain, device, "mid-d K3 without data",
        (128, 264, 528, 1024))
    print(f"per iteration of a {CHUNK}-draw launch at {GLM_CHAINS} chains, "
          f"B=1: K3-args {1e3 * ms_g / it_g:.3f} us, the same kernel on "
          f"N(3, 1) at d={MID_DIM} {1e3 * ms_n / it_n:.3f} us (launch time "
          "over a chain's iterations: the waves of chain blocks are in it)")


def mclmc_sync_path(device):
    """Item 19: chip_smoke.py's sync MCLMC path (the MCLMC main
    configuration on the sync MCLMC engine, with its four extra stores): one
    run with each chunk's seconds, the host loop's iterations a draw and
    the successful leapfrogs an iteration (its attempts, where no step
    halves); then 20 draws at the tuned state under torch.profiler: the
    device's busy share and kernels an iteration."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from nuts_rs_tpu_torch import DiagMclmcSettings, Sampler
    from nuts_rs_tpu_torch.kernels import mclmc as tm
    from nuts_rs_tpu_torch.models.gaussian import normal_logp

    settings = DiagMclmcSettings(num_chains=CHAINS, num_tune=TUNE,
                                 num_draws=DRAWS, seed=SEED, **MSYNC_STORES)
    # one call of refresh_coefficients an attempt, so one a loop iteration
    coeffs0, calls = tm.refresh_coefficients, [0]

    def coeffs(*a):
        calls[0] += 1
        return coeffs0(*a)

    tm.refresh_coefficients = coeffs
    try:
        t0 = time.perf_counter()
        sampler = Sampler(normal_logp(DIM, MU), settings, device=device)
        torch.cuda.synchronize(device)
        print(f"sync MCLMC path: Sampler construction "
              f"{time.perf_counter() - t0:.3f} s")
        steps = 0
        while not sampler.finished:
            t, c0 = time.perf_counter(), calls[0]
            lo, stats, _ = sampler.run_next_chunk()
            sec = time.perf_counter() - t
            k = stats["n_steps"].shape[1]
            its = calls[0] - c0
            steps += int(stats["n_steps"].sum())
            print(f"  draws {lo}-{lo + k}: {sec:.3f} s, {1e3 * sec / k:.2f} "
                  f"ms a draw, {its / k:.2f} loop iterations a draw, "
                  f"{1e3 * sec / its:.3f} ms each, "
                  f"{stats['n_steps'].sum() / its:.1f} successful leapfrogs "
                  f"an iteration of {CHAINS} chains")
        t = time.perf_counter()
        sampler.trace.finalize()
        print(f"  finalize {time.perf_counter() - t:.3f} s; end to end "
              f"{time.perf_counter() - t0:.3f} s, {calls[0]} loop iterations "
              f"for {TUNE + DRAWS} draws, {steps} leapfrogs")
        runner = sampler._phase_runners[-1][2]
        flags = {name: np.zeros(20, bool) for name in (
            "is_tuning", "update_estimators", "do_switch", "do_update",
            "use_late_estimator", "reinit_step_size", "use_best_guess",
            "advance_da", "resample_velocity")}
        runner(sampler.state, flags)
        torch.cuda.synchronize(device)
        c0 = calls[0]
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            runner(sampler.state, flags)
            torch.cuda.synchronize(device)
            wall_s = time.perf_counter() - t
        its = calls[0] - c0
    finally:
        tm.refresh_coefficients = coeffs0
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_s = sum(e.time_range.elapsed_us() for e in dev) * 1e-6
    print(f"20 draws at the tuned state under torch.profiler: wall "
          f"{wall_s:.3f} s ({1e3 * wall_s / its:.3f} ms a loop iteration, "
          f"{its / 20:.2f} a draw), device busy {busy_s:.3f} s "
          f"({100 * busy_s / wall_s:.1f}%) in {len(dev)} kernels and copies "
          f"({len(dev) / its:.0f} a loop iteration)")
    per_name = collections.defaultdict(lambda: [0, 0.0])
    for e in dev:
        entry = per_name[e.name[:60]]
        entry[0] += 1
        entry[1] += e.time_range.elapsed_us() * 1e-6
    for name, (n, sec_) in sorted(per_name.items(),
                                  key=lambda kv: -kv[1][1])[:6]:
        print(f"  device {sec_ * 1e3:.3f} ms in {n} launches: {name}")


def stream_path(device):
    """Item 8: the streamed-data path's phases, the sync engine's tree
    iteration and K1-stream on the path's own post-warmup states."""
    from nuts_rs_tpu_torch import DiagNutsSettings, Sampler
    from nuts_rs_tpu_torch.adapt import step_size as ss
    from nuts_rs_tpu_torch.kernels import nuts_fused as nf
    from nuts_rs_tpu_torch.kernels.nuts import nuts_draw
    from nuts_rs_tpu_torch.models.gaussian import logistic_regression

    def sync():
        torch.cuda.synchronize(device)

    print("== stream path")
    t0 = time.perf_counter()
    big = logistic_regression(BIG_ROWS, GLM_DIM, SEED).to(device)
    sync()
    print(f"model: {big.data_bytes / 1e6:.1f} MB of data made and copied in "
          f"{time.perf_counter() - t0:.3f} s")
    settings = DiagNutsSettings(num_chains=BIG_CHAINS, num_tune=BIG_TUNE,
                                num_draws=BIG_DRAWS, seed=SEED,
                                posterior_kernel="pallas")
    t0 = time.perf_counter()
    sampler = Sampler(big, settings, device=device)
    sync()
    print(f"Sampler construction (init points, init search): "
          f"{time.perf_counter() - t0:.3f} s")
    tuned = None
    while not sampler.finished:
        if sampler._next_draw == settings.num_tune:
            tuned = sampler.state
        t = time.perf_counter()
        lo, stats, _ = sampler.run_next_chunk()
        sync()
        sec = time.perf_counter() - t
        steps = stats["n_steps"]
        if lo < settings.num_tune:
            # the chains of a draw wait for its deepest tree
            its = int(steps.max(0).sum())
            print(f"  warmup chunk {lo}-{lo + steps.shape[1]}: {sec:.3f} s, "
                  f"{its} tree iterations in lock step "
                  f"({1e3 * sec / its:.3f} ms each), deepest tree "
                  f"{int(stats['depth'].max())}, leapfrogs a draw and chain "
                  f"{float(steps.mean()):.2f}")
        else:
            print(f"  posterior chunk {lo}-{lo + steps.shape[1]}: "
                  f"{sec:.3f} s, leapfrogs a draw and chain "
                  f"{float(steps.mean()):.2f}")
    state, config = tuned, sampler.config
    step = state.step.step_size
    bars = ss.step_size_bar(state.step, config.step_size)
    print(f"own states after {settings.num_tune} tuning draws: step size "
          f"min {float(step.min()):.4f} median {float(step.median()):.4f} "
          f"max {float(step.max()):.4f}")

    # one tree iteration of the sync engine beside the evaluation alone
    q = state.pt.q
    xt = big.hook_parts()[2][0]
    big.logp_and_grad(q)
    eval_ms = cuda_events_ms(lambda: big.logp_and_grad(q), 10)
    mm_ms = cuda_events_ms(
        lambda: torch.matmul(torch.matmul(q, xt), xt.T), 10)
    t = time.perf_counter()
    _, info = nuts_draw(12345, state.pt, state.transform, step,
                        big.logp_and_grad, config.nuts)
    sync()
    sec = time.perf_counter() - t
    its = int(info.n_steps.max())
    print(f"sync engine at the tuned state: one draw {sec:.3f} s for {its} "
          f"tree iterations ({1e3 * sec / its:.3f} ms each); the model's "
          f"batched evaluation alone {eval_ms:.3f} ms, its two products by "
          f"torch.matmul {mm_ms:.3f} ms")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        nuts_draw(12345, state.pt, state.transform, step, big.logp_and_grad,
                  config.nuts)
        sync()
        wall_s = time.perf_counter() - t
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_s = sum(e.time_range.elapsed_us() for e in dev) * 1e-6
    print(f"the same draw under torch.profiler: wall {wall_s:.3f} s, device "
          f"busy {busy_s:.3f} s ({100 * busy_s / wall_s:.1f}%) in {len(dev)} "
          f"kernels and copies ({len(dev) / its:.0f} a tree iteration)")
    per_name = collections.defaultdict(lambda: [0, 0.0])
    for e in dev:
        entry = per_name[e.name[:60]]
        entry[0] += 1
        entry[1] += e.time_range.elapsed_us() * 1e-6
    for name, (n, sec_) in sorted(per_name.items(),
                                  key=lambda kv: -kv[1][1])[:6]:
        print(f"  device {sec_ * 1e3:.3f} ms in {n} launches: {name}")

    t_ = state.transform
    args = (state.pt.q, state.pt.g, state.pt.logp, t_.stds, t_.mean,
            t_.logdet, step, bars)

    def post(n, block):
        a = tuple(x[:n].contiguous() for x in args)
        return nf.nuts_fused_run(3, *a, CHUNK, big, config.nuts, 0.1, block,
                                 stream=True)[4]

    # the logical block of all chains (the JAX runner's 256, the default),
    # smaller blocks one after another in the same launch, and fewer chains
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0])
    rate = sms * 128 * mhz * 1e6
    sweep = [(BIG_CHAINS, b) for b in (None, 128, 64)]
    sweep += [(n, None) for n in (64, 128)]
    for n, block in sweep:
        out = post(n, block)
        ms = cuda_events_ms(lambda: post(n, block), 1)
        iters = out["loop_iterations"].float()
        evals = float(out["n_steps"].sum())
        B = n if block is None else block
        # a round: every chain's evaluation, 4 N d FP32 instructions each in
        # the two products; the blocks of a launch run one after another
        round_us = 1e3 * ms / (float(iters.max()) * n // B)
        share = 4 * B * BIG_ROWS * GLM_DIM / (round_us * 1e-6) / rate
        print(f"own states, first {n} chains, blocks of {B}: K1-stream "
              f"{ms:.2f} ms per {CHUNK}-draw launch, block iterations mean "
              f"{float(iters.mean()):.1f} max {int(iters.max())}, "
              f"{round_us:.1f} us per round of {B} evaluations, "
              f"{100 * share:.1f}% of the FP32 issue rate ({sms} SMs x 128 "
              f"x {mhz:.0f} MHz), {evals} evaluations")


def flow_path(device, log_path=None):
    """Item 10: the flow path at its full configuration, one run: Sampler
    construction, every warmup chunk with its tree iterations in lock step
    and the refits inside it, the posterior chunks, end to end; a warmup
    draw of the sync engine at the tuned state under torch.profiler (its
    device-busy share); K1-flow on the path's own post-warmup states."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from nuts_rs_tpu_torch import FlowNutsSettings, Sampler
    from nuts_rs_tpu_torch.adapt import step_size as ss
    from nuts_rs_tpu_torch.flows.coupling import tree_map
    from nuts_rs_tpu_torch.kernels import nuts_fused as nf
    from nuts_rs_tpu_torch.kernels.nuts import nuts_draw
    from nuts_rs_tpu_torch.models.gaussian import funnel

    out = open(log_path, "a") if log_path else None

    def say(line):
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    def sync():
        torch.cuda.synchronize(device)

    say("== flow path")
    model = funnel(FLOW_DIM).to(device)
    settings = FlowNutsSettings(num_chains=FLOW_FULL_CHAINS,
                                num_tune=FLOW_FULL_TUNE,
                                num_draws=FLOW_FULL_DRAWS, seed=SEED,
                                posterior_kernel="pallas")
    t_start = time.perf_counter()
    sampler = Sampler(model, settings, device=device)
    sync()
    say(f"Sampler construction (init points, flow init, init search): "
        f"{time.perf_counter() - t_start:.3f} s")
    strategy = sampler.strategy
    adapt = strategy.adapt_update
    refits = []

    def timed_refit(state, mask=None):
        sync()
        t = time.perf_counter()
        new = adapt(state, mask)
        sync()
        refits.append(time.perf_counter() - t)
        return new

    strategy.adapt_update = timed_refit
    tuned, warm_s, post_s = None, 0.0, 0.0
    post_grads, warm_its = 0, 0
    while not sampler.finished:
        if sampler._next_draw == settings.num_tune:
            tuned = sampler.state
        n_refits = len(refits)
        t = time.perf_counter()
        lo, stats, _ = sampler.run_next_chunk()
        sync()
        sec = time.perf_counter() - t
        steps = stats["n_steps"]
        hi = lo + steps.shape[1]
        if lo < settings.num_tune:
            its = int(steps.max(0).sum())
            warm_its += its
            warm_s += sec
            r = refits[n_refits:]
            say(f"  warmup chunk {lo}-{hi}: {sec:.3f} s, {its} tree "
                f"iterations in lock step "
                f"({1e3 * (sec - sum(r)) / its:.3f} ms each outside the "
                f"refits), {len(r)} refits {sum(r):.3f} s, deepest tree "
                f"{int(stats['depth'].max())}, leapfrogs a draw and chain "
                f"{float(steps.mean()):.2f}, divergent "
                f"{float(stats['diverging'].mean()):.4f}")
        else:
            post_s += sec
            post_grads += int(steps.sum())
            say(f"  posterior chunk {lo}-{hi}: {sec:.3f} s, leapfrogs a "
                f"draw and chain {float(steps.mean()):.2f}")
    t = time.perf_counter()
    trace = sampler.trace.finalize()
    fin_s = time.perf_counter() - t
    total_s = time.perf_counter() - t_start
    pos = trace.posterior["position"]
    v = pos[..., 0].astype(np.float64)
    say(f"flow path: warmup {warm_s:.3f} s ({warm_s / settings.num_tune:.3f}"
        f" s a draw; {warm_its} tree iterations in lock step, refits "
        f"{sum(refits):.3f} s in {len(refits)}), posterior {post_s:.3f} s "
        f"({post_grads / post_s:.6g} gradient evaluations/s, {post_grads} "
        f"evaluations), finalize {fin_s:.3f} s, end to end {total_s:.3f} s; "
        f"launches of K1-flow {nf.LAUNCHES['nuts_fused_flow_posterior']}; "
        f"v mean {v.mean():.4f} std {v.std():.4f} (N(0, 3)), divergence "
        f"share {float(trace.sample_stats['diverging'].mean()):.4f}")

    state, config = tuned, sampler.config
    step = state.step.step_size
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        _, info = nuts_draw(12345, state.pt, state.transform, step,
                            model.logp_and_grad, config.nuts, strategy.ops)
        sync()
        wall_s = time.perf_counter() - t
    its = int(info.n_steps.max())
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_s = sum(e.time_range.elapsed_us() for e in dev) * 1e-6
    say(f"a sync-engine draw at the tuned state under torch.profiler: "
        f"{its} tree iterations, wall {wall_s:.3f} s "
        f"({1e3 * wall_s / its:.3f} ms each), device busy {busy_s:.3f} s "
        f"({100 * busy_s / wall_s:.1f}%) in {len(dev)} kernels and copies "
        f"({len(dev) / its:.0f} a tree iteration)")

    packed = strategy.spec.kernel_pack(
        tree_map(lambda p: p[0], state.transform.params))
    bars = ss.step_size_bar(state.step, config.step_size)
    z = state.pt.z.contiguous()
    zc = torch.zeros(z.shape[0], device=device)
    args = (z, torch.zeros_like(z), zc, torch.ones_like(z),
            torch.zeros_like(z), zc.clone(), step.contiguous(), bars)
    for block in (1, 2, 4, 8):
        def launch(block=block):
            return nf.nuts_fused_run(3, *args, CHUNK, model, config.nuts,
                                     0.1, block, flow=packed)[4]
        res = launch()
        ms = cuda_events_ms(launch, 3)
        iters = res["loop_iterations"].float()
        say(f"own states, {block} a block: K1-flow {ms:.3f} ms per {CHUNK}"
            f"-draw launch, block iterations mean {float(iters.mean()):.1f} "
            f"max {int(iters.max())} ({1e3 * ms / float(iters.max()):.2f} us "
            f"each), leapfrogs a draw {float(res['n_steps'].mean()):.2f}")
    if out:
        out.close()


def zoo_paths(device, repeats, trace):
    """Item 9: the SV and radon paths, items 1 and 2 of each."""
    from nuts_rs_tpu_torch import DiagNutsSettings
    from nuts_rs_tpu_torch.models.hierarchical import radon
    from nuts_rs_tpu_torch.models.stochastic_volatility import (
        stochastic_volatility)

    for label, model, chains, tune, draws in (
            ("SV", stochastic_volatility(T=SV_T, seed=SEED), SV_CHAINS,
             SV_TUNE, SV_DRAWS),
            ("radon", radon(seed=SEED), RADON_CHAINS, RADON_TUNE,
             RADON_DRAWS)):
        settings = DiagNutsSettings(num_chains=chains, num_tune=tune,
                                    num_draws=draws, seed=SEED,
                                    posterior_kernel="pallas")
        print(f"== {label} path")
        run_main_path(model, settings, device)  # first launches, allocator
        for rep in range(repeats):
            print_run(f"run {rep}", run_main_path(model, settings, device),
                      tune)
        profile_once(model, settings, device, trace and trace.replace(
            ".json", f"_{label.lower()}.json"))


# Item 11: K1-stream's 128-draw launch on chip_smoke's made-up states at the
# cell's sizes, in the tree given (its own package and chip_smoke, so that
# an earlier commit's tree, unpacked beside this one, is timed alike); run in
# a process of its own, one warm launch and one timed.
STREAM_LAUNCH = """
import torch
import chip_smoke as cs
from nuts_rs_tpu_torch.kernels import nuts_fused as nf
from nuts_rs_tpu_torch.kernels.nuts import NutsOptions
from nuts_rs_tpu_torch.models.gaussian import logistic_regression
dev = torch.device("cuda", 0)
big = logistic_regression(cs.BIG_ROWS, cs.GLM_DIM, cs.SEED).to(dev)
mean, std, _ = cs.glm_reference(cs.BIG_REFERENCE)
args = cs.glm_posterior_inputs(big, dev, mean, std, seed=2,
                               chains=cs.BIG_CHAINS)
def run():
    return nf.nuts_fused_run(3, *args, cs.CHUNK, big,
                             NutsOptions(maxdepth=10), 0.1, stream=True)
out = run()
torch.cuda.synchronize()
ms = cs.cuda_events_ms(run, 1)
print(f"K1-stream made-up states: {ms:.2f} ms per {cs.CHUNK}-draw launch, "
      f"block iterations max {int(out[4]['loop_iterations'].max())}")
"""


def stream_launch(trees):
    """Item 11 for each tree in turn (e.g. parent, this one, this one,
    parent)."""
    for tree in trees:
        out = subprocess.run([sys.executable, "-c", STREAM_LAUNCH], cwd=tree,
                             capture_output=True, text=True, check=True)
        print(f"{tree}: {out.stdout.strip().splitlines()[-1]}")


# Item 12: K1-ld-args' 128-draw launch on the SV path's own post-warmup
# states and K2-ld-args' first full 128-row launch on the path's own warmup
# states, in the tree given (its own package and chip_smoke); run in a
# process of its own: the path's Sampler runs until its first posterior
# launch, the two launches it made are repeated here, and their inputs are
# saved to the file given (SV_TIME repeats them in another tree).
SV_LAUNCH = """
import re, sys, torch
import chip_smoke as cs
from nuts_rs_tpu_torch import DiagNutsSettings, Sampler
from nuts_rs_tpu_torch.kernels import _build, nuts_fused as nf
from nuts_rs_tpu_torch.models.stochastic_volatility import (
    stochastic_volatility)
dev = torch.device("cuda", 0)
settings = DiagNutsSettings(num_chains=cs.SV_CHAINS, num_tune=cs.SV_TUNE,
                            num_draws=cs.SV_DRAWS, seed=cs.SEED,
                            posterior_kernel="pallas")
seen = {}
run0, warm0 = nf.nuts_fused_run, nf.nuts_fused_warmup_run
def run(*a, **k):
    seen.setdefault("post", (a, k))
    return run0(*a, **k)
def warm(*a, **k):
    if a[1].shape[0] == cs.CHUNK:
        seen.setdefault("warm", (a, k))
    return warm0(*a, **k)
nf.nuts_fused_run, nf.nuts_fused_warmup_run = run, warm
sampler = Sampler(stochastic_volatility(T=cs.SV_T, seed=cs.SEED), settings,
                  device=dev)
while "post" not in seen:
    sampler.run_next_chunk()
nf.nuts_fused_run, nf.nuts_fused_warmup_run = run0, warm0
p, w = seen["post"][0], seen["warm"][0]
torch.save({"post": p[:9], "K": p[9], "jitter": p[12], "warm": w[:9],
            "grad": w[12]}, sys.argv[1])
for name, fn, key, at in (("K1-ld-args", run0, "post", 4),
                          ("K2-ld-args", warm0, "warm", 8)):
    a, k = seen[key]
    out = fn(*a, **k)
    torch.cuda.synchronize()
    ms = cs.cuda_events_ms(lambda: fn(*a, **k), 3)
    st = out[at]
    b_ms, b_by = cs.bound("nuts", sampler.model, a[1:9], out, st)
    it = st["loop_iterations"].float()
    print(f"{name} own states: {ms:.4f} ms per launch of "
          f"{tuple(st['n_steps'].shape)} (chains, draws); leapfrogs "
          f"{int(st['n_steps'].sum())}, per draw "
          f"{float(st['n_steps'].float().mean()):.2f}; block iterations "
          f"mean {float(it.mean()):.1f} max {int(it.max())}; bound "
          f"{b_ms:.4f} ms ({b_by})")
log = (_build.BUILD_DIR / "build_nuts_fused_ld_args_posterior.log")
text = log.read_text() if log.exists() else ""
for entry in text.split("Compiling entry function")[1:]:
    if "StochasticVolatility" in entry.split("\\n")[0]:
        nums = [re.findall(p, entry) for p in (
            r"Used (\\d+) registers", r"(\\d+) bytes stack frame",
            r"(\\d+) bytes spill stores", r"(\\d+) bytes spill loads")]
        print("ptxas K1-ld-args (SV): registers {} stack {} spill stores {} "
              "spill loads {}".format(*(n[0] if n else "?" for n in nums)))
"""

# Item 12's comparison on common inputs: this tree's K1-ld-args and
# K2-ld-args on the launches SV_LAUNCH saved (each tree's own path), so
# that two trees are timed on the same states.
SV_TIME = """
import sys, torch
import chip_smoke as cs
from nuts_rs_tpu_torch import DiagNutsSettings
from nuts_rs_tpu_torch.kernels import nuts_fused as nf
from nuts_rs_tpu_torch.models.stochastic_volatility import (
    stochastic_volatility)
dev = torch.device("cuda", 0)
config = DiagNutsSettings(num_chains=cs.SV_CHAINS, seed=cs.SEED,
                          posterior_kernel="pallas").chain_config()
model = stochastic_volatility(T=cs.SV_T, seed=cs.SEED).to(dev)
for path in sys.argv[1:]:
    s = torch.load(path)
    runs = (("K1-ld-args", lambda: nf.nuts_fused_run(
                *s["post"], s["K"], model, config.nuts, s["jitter"],
                layout="ld"), 4),
            ("K2-ld-args", lambda: nf.nuts_fused_warmup_run(
                *s["warm"], model, config.nuts, config.step_size, s["grad"],
                layout="ld"), 8))
    for name, fn, at in runs:
        out = fn()
        torch.cuda.synchronize()
        ms = cs.cuda_events_ms(fn, 3)
        it = out[at]["loop_iterations"]
        print(f"{name} on {path.rsplit('/', 1)[-1]}: {ms:.4f} ms; "
              f"leapfrogs {int(out[at]['n_steps'].sum())}, block "
              f"iterations max {int(it.max())}")
"""

# Item 12's ablation, in this tree only: K1-ld-args on the saved own states
# with every tree forced to maxdepth 7 (127 leapfrogs a draw whatever the
# model, NRT_ABLATE_FIXED_TREES), built with the macros given: one chain
# block an SM (NRT_LD_ARGS_MIN_BLOCKS=1, the design before this one) and
# two, each as it is, without SV's two scans and their barriers
# (NRT_ABLATE_SV_SCANS: the prefixes 0.0; the functor's values change) and
# with the scans but without SV's three barriers (NRT_ABLATE_SV_BARRIERS:
# the warps read whatever the totals hold, its sums are its warps'); beside
# the first, K1-ld on the iid normal at d = 1002 from the same points,
# steps and mass matrices.
SV_ABLATE = """
import sys, torch
import chip_smoke as cs
from nuts_rs_tpu_torch.kernels import _build, nuts_fused as nf
from nuts_rs_tpu_torch.kernels.nuts import NutsOptions
from nuts_rs_tpu_torch.models.gaussian import normal_logp
from nuts_rs_tpu_torch.models.stochastic_volatility import (
    stochastic_volatility)
_build.NVCC_DEFINES[:] = sys.argv[2:]
dev = torch.device("cuda", 0)
saved = torch.load(sys.argv[1])
args, jitter = saved["post"], saved["jitter"]
K, D = 32, 7
opts = NutsOptions(maxdepth=D)
sv = stochastic_volatility(T=cs.SV_T, seed=cs.SEED).to(dev)
label = " ".join(m.removeprefix("NRT_") for m in sys.argv[2:])
one_block = "NRT_LD_ARGS_MIN_BLOCKS=1" in sys.argv
cases = [("K1-ld-args SV", sv, args, "ld_args")]
if one_block and not any(m.startswith("NRT_ABLATE_SV") for m in sys.argv):
    iid = normal_logp(sv.dim, 0.0)
    q = args[1]
    logp, g = iid.logp_and_grad(q)
    cases.append(("K1-ld iid normal", iid,
                  (args[0], q, g.contiguous(), logp.contiguous())
                  + tuple(args[4:9]), "ld"))
for name, model, a, kind in cases:
    def fn():
        return nf.nuts_fused_run(*a, K, model, opts, jitter, block=1,
                                 layout="ld")
    out = fn()
    torch.cuda.synchronize()
    ms = cs.cuda_events_ms(fn, 3)
    leaps = int(out[4]["n_steps"].sum())
    per_sm = (_build.ld_args_blocks_per_sm("posterior", model, D)
              if kind == "ld_args" else 1)
    us = 1e3 * ms * torch.cuda.get_device_properties(0).multi_processor_count
    print(f"ablation [{label}] {name}: {ms:.4f} ms, {leaps} leapfrogs "
          f"({leaps / (a[1].shape[0] * K):.1f} a draw), {per_sm} blocks an "
          f"SM; {us / leaps:.4f} us of an SM a leapfrog, "
          f"{per_sm * us / leaps:.4f} us a leapfrog of one chain")
"""

SV_ABLATIONS = tuple(
    ("NRT_ABLATE_FIXED_TREES", *blocks, *skip)
    for blocks in (("NRT_LD_ARGS_MIN_BLOCKS=1",), ())
    for skip in ((), ("NRT_ABLATE_SV_SCANS",), ("NRT_ABLATE_SV_BARRIERS",)))


def sv_launch(trees):
    """Item 12: each distinct tree's own SV path, its launches saved; then
    every tree in the order given (e.g. parent, this one, this one, parent)
    timed on every saved set of launches; then the ablation in this tree."""
    from pathlib import Path

    from nuts_rs_tpu_torch.kernels import _build

    here = Path(__file__).resolve().parent
    _build.BUILD_DIR.mkdir(exist_ok=True)
    saved = {}
    for tree in trees:
        key = Path(tree).resolve()
        if key in saved:
            continue
        saved[key] = str(_build.BUILD_DIR / f"sv_states_{len(saved)}.pt")
        out = subprocess.run([sys.executable, "-c", SV_LAUNCH, saved[key]],
                             cwd=tree, capture_output=True, text=True)
        if out.returncode:
            raise RuntimeError(f"{tree}: {out.stderr[-3000:]}")
        for line in out.stdout.strip().splitlines():
            print(f"{tree}: {line} [saved as {saved[key]}]")
    for tree in trees:
        out = subprocess.run([sys.executable, "-c", SV_TIME,
                              *saved.values()], cwd=tree,
                             capture_output=True, text=True)
        if out.returncode:
            raise RuntimeError(f"{tree}: {out.stderr[-3000:]}")
        for line in out.stdout.strip().splitlines():
            print(f"{tree}: {line}")
    states = saved.get(here) or next(iter(saved.values()))
    for defines in SV_ABLATIONS:
        out = subprocess.run([sys.executable, "-c", SV_ABLATE, states,
                              *defines], cwd=here, capture_output=True,
                             text=True)
        if out.returncode:
            raise RuntimeError(f"ablation {defines}: {out.stderr[-3000:]}")
        print(out.stdout.strip())


# Item 13: K1-args' first 128-draw posterior launch on the data path's (or
# radon path's) own post-warmup states and K2-args' first full 128-row
# warmup launch on its own warmup states, in the tree given, as SV_LAUNCH
# does for the SV path.
DATA_LAUNCH = """
import sys, torch
import chip_smoke as cs
from nuts_rs_tpu_torch import DiagNutsSettings, Sampler
from nuts_rs_tpu_torch.kernels import _build, nuts_fused as nf
from nuts_rs_tpu_torch.models.gaussian import logistic_regression
from nuts_rs_tpu_torch.models.hierarchical import radon
dev = torch.device("cuda", 0)
which, path = sys.argv[1], sys.argv[2]
if which == "glm":
    model = logistic_regression(cs.GLM_ROWS, cs.GLM_DIM, cs.SEED)
    chains, tune, draws = cs.GLM_CHAINS, cs.GLM_TUNE, cs.GLM_DRAWS
else:
    model = radon(seed=cs.SEED)
    chains, tune, draws = cs.RADON_CHAINS, cs.RADON_TUNE, cs.RADON_DRAWS
settings = DiagNutsSettings(num_chains=chains, num_tune=tune,
                            num_draws=draws, seed=cs.SEED,
                            posterior_kernel="pallas")
seen = {}
run0, warm0 = nf.nuts_fused_run, nf.nuts_fused_warmup_run
def run(*a, **k):
    seen.setdefault("post", (a, k))
    return run0(*a, **k)
def warm(*a, **k):
    if a[1].shape[0] == cs.CHUNK:
        seen.setdefault("warm", (a, k))
    return warm0(*a, **k)
nf.nuts_fused_run, nf.nuts_fused_warmup_run = run, warm
sampler = Sampler(model, settings, device=dev)
while "post" not in seen:
    sampler.run_next_chunk()
nf.nuts_fused_run, nf.nuts_fused_warmup_run = run0, warm0
p, w = seen["post"][0], seen["warm"][0]
torch.save({"post": p[:9], "K": p[9], "jitter": p[12], "warm": w[:9],
            "grad": w[12]}, path)
model, D = sampler.model, settings.nuts_options().maxdepth
for name, fn, key, at, kind in (("K1-args", run0, "post", 4, "posterior"),
                                ("K2-args", warm0, "warm", 8, "warmup")):
    a, k = seen[key]
    out = fn(*a, **k)
    torch.cuda.synchronize()
    ms = cs.cuda_events_ms(lambda: fn(*a, **k), 3)
    st = out[at]
    b_ms, b_by = cs.bound("nuts", model, a[1:9], out, st)
    it = st["loop_iterations"].float()
    group = ""
    if hasattr(_build, "mid_launch_group"):
        G = _build.mid_launch_group(kind, model.dim, D, model, chains, 1,
                                    _build.sm_count(dev))
        group = (f"; G = {G} chains a CUDA block, "
                 f"{_build.mid_blocks_per_sm(kind, model, D, G)} blocks an SM")
    print(f"{which} {name} own states: {ms:.4f} ms per launch of "
          f"{tuple(st['n_steps'].shape)} (chains, draws); leapfrogs "
          f"{int(st['n_steps'].sum())}, per draw "
          f"{float(st['n_steps'].float().mean()):.2f}; loop iterations "
          f"mean {float(it.mean()):.1f} max {int(it.max())}; bound "
          f"{b_ms:.4f} ms ({b_by}){group}")
"""

# Item 13's comparison on common inputs: this tree's K1-args and K2-args on
# the launches DATA_LAUNCH saved, 5 calls after a first.
DATA_TIME = """
import sys, torch
import chip_smoke as cs
from nuts_rs_tpu_torch import DiagNutsSettings
from nuts_rs_tpu_torch.kernels import nuts_fused as nf
from nuts_rs_tpu_torch.models.gaussian import logistic_regression
from nuts_rs_tpu_torch.models.hierarchical import radon
dev = torch.device("cuda", 0)
config = DiagNutsSettings(seed=cs.SEED,
                          posterior_kernel="pallas").chain_config()
for spec in sys.argv[1:]:
    which, path = spec.split("=", 1)
    model = (logistic_regression(cs.GLM_ROWS, cs.GLM_DIM, cs.SEED)
             if which == "glm" else radon(seed=cs.SEED)).to(dev)
    s = torch.load(path)
    runs = (("K1-args", lambda: nf.nuts_fused_run(
                *s["post"], s["K"], model, config.nuts, s["jitter"]), 4),
            ("K2-args", lambda: nf.nuts_fused_warmup_run(
                *s["warm"], model, config.nuts, config.step_size,
                s["grad"]), 8))
    for name, fn, at in runs:
        out = fn()
        torch.cuda.synchronize()
        ms = cs.cuda_events_ms(fn, 5)
        it = out[at]["loop_iterations"]
        print(f"{which} {name} on {path.rsplit('/', 1)[-1]}: {ms:.4f} ms; "
              f"leapfrogs {int(out[at]['n_steps'].sum())}, loop "
              f"iterations max {int(it.max())}")
"""


# Item 13's ablation: K1-args on a saved set of its own states with every
# tree forced to maxdepth 3 (NRT_ABLATE_FIXED_TREES: 7 leapfrogs a draw,
# whatever the model's values), in the tree given and with the macros given
# (NRT_ABLATE_EVAL: without the model's evaluation); microseconds a block
# iteration and of an SM a chain's leapfrog.
DATA_ABLATE = """
import sys, torch
import chip_smoke as cs
from nuts_rs_tpu_torch.kernels import _build, nuts_fused as nf
from nuts_rs_tpu_torch.kernels.nuts import NutsOptions
from nuts_rs_tpu_torch.models.gaussian import logistic_regression
from nuts_rs_tpu_torch.models.hierarchical import radon
_build.NVCC_DEFINES[:] = sys.argv[2:]
dev = torch.device("cuda", 0)
label = " ".join(m.removeprefix("NRT_") for m in sys.argv[2:])
K, D = 32, 3
opts = NutsOptions(maxdepth=D)
for spec in sys.argv[1].split(","):
    which, path = spec.split("=", 1)
    model = (logistic_regression(cs.GLM_ROWS, cs.GLM_DIM, cs.SEED)
             if which == "glm" else radon(seed=cs.SEED)).to(dev)
    s = torch.load(path)
    def fn():
        return nf.nuts_fused_run(*s["post"], K, model, opts, s["jitter"])
    out = fn()
    torch.cuda.synchronize()
    ms = cs.cuda_events_ms(fn, 3)
    it = int(out[4]["loop_iterations"].max())
    leaps = int(out[4]["n_steps"].sum())
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    print(f"ablation [{label}] {which} K1-args: {ms:.4f} ms, {leaps} "
          f"leapfrogs, block iterations max {it}: {1e3 * ms / it:.3f} us "
          f"an iteration, {1e3 * ms * sms / leaps:.4f} us of an SM a "
          "leapfrog")
"""

DATA_ABLATIONS = (("NRT_ABLATE_FIXED_TREES",),
                  ("NRT_ABLATE_FIXED_TREES", "NRT_ABLATE_EVAL"))


def data_launch(trees):
    """Item 13: each distinct tree's own data and radon paths, their
    launches saved; then every tree in the order given (e.g. parent, this
    one, this one, parent) timed on every saved set."""
    from pathlib import Path

    from nuts_rs_tpu_torch.kernels import _build

    _build.BUILD_DIR.mkdir(exist_ok=True)
    saved = {}
    for tree in trees:
        key = Path(tree).resolve()
        if key in saved:
            continue
        saved[key] = []
        for which in ("glm", "radon"):
            path = str(_build.BUILD_DIR / f"{which}_states_{len(saved)}.pt")
            saved[key].append(f"{which}={path}")
            out = subprocess.run([sys.executable, "-c", DATA_LAUNCH, which,
                                  path], cwd=tree, capture_output=True,
                                 text=True)
            if out.returncode:
                raise RuntimeError(f"{tree}: {out.stderr[-3000:]}")
            for line in out.stdout.strip().splitlines():
                print(f"{tree}: {line} [saved as {path}]")
    specs = [spec for specs in saved.values() for spec in specs]
    for tree in trees:
        out = subprocess.run([sys.executable, "-c", DATA_TIME, *specs],
                             cwd=tree, capture_output=True, text=True)
        if out.returncode:
            raise RuntimeError(f"{tree}: {out.stderr[-3000:]}")
        for line in out.stdout.strip().splitlines():
            print(f"{tree}: {line}")
    # the ablation on this checkout's states: every tree given with fixed
    # trees (the design before this one, if it is among them, for its
    # iteration), this checkout also without the evaluation
    here = Path(__file__).resolve().parent
    states = ",".join(saved.get(here) or next(iter(saved.values())))
    for tree in dict.fromkeys(trees):
        own = Path(tree).resolve() == here
        for defines in DATA_ABLATIONS if own else DATA_ABLATIONS[:1]:
            out = subprocess.run([sys.executable, "-c", DATA_ABLATE, states,
                                  *defines], cwd=tree, capture_output=True,
                                 text=True)
            if out.returncode:
                raise RuntimeError(f"{tree} ablation {defines}: "
                                   f"{out.stderr[-3000:]}")
            for line in out.stdout.strip().splitlines():
                print(f"{tree}: {line}")


# Item 14: the MCLMC data path's own launches (K3-args' first posterior
# chunk, K4-args' Euclidean launch and first microcanonical chunk) and each
# functor's own first K3-args launch, in the tree given, saved for
# MCLMC_TIME.
MCLMC_CASES = """
import chip_smoke as cs
from nuts_rs_tpu_torch.models import gaussian as tg
from nuts_rs_tpu_torch.models.hierarchical import radon
from nuts_rs_tpu_torch.models.stochastic_volatility import (
    stochastic_volatility)
CASES = {  # name: (model, chains)
    "glm": (lambda: tg.logistic_regression(cs.GLM_ROWS, cs.GLM_DIM, cs.SEED),
            cs.GLM_CHAINS),
    "normal": (lambda: tg.normal_logp(cs.MID_DIM, cs.MU), 1024),
    "normal256": (lambda: tg.normal_logp(cs.MID_DIM, cs.MU), 256),
    "radon": (lambda: radon(seed=cs.SEED), 1024),
    "rank1": (lambda: tg.correlated_normal_rank1(100), 256),
    "funnel": (lambda: tg.funnel(10), 256),
    "correlated_normal": (lambda: tg.correlated_normal(100), 256),
    "sv": (lambda: stochastic_volatility(T=300, seed=cs.SEED), 256),
}
"""

MCLMC_LAUNCH = MCLMC_CASES + """
import sys, torch
from nuts_rs_tpu_torch import DiagMclmcSettings, Sampler
from nuts_rs_tpu_torch.kernels import _build, mclmc_fused as mf
dev = torch.device("cuda", 0)
which, path = sys.argv[1], sys.argv[2]
make, chains = CASES[which]
model = make()
settings = DiagMclmcSettings(num_chains=chains, num_tune=cs.GLM_TUNE,
                             num_draws=cs.GLM_DRAWS, seed=cs.SEED,
                             posterior_kernel="pallas")
seen = {}
run0, warm0 = mf.mclmc_fused_run, mf.mclmc_fused_warmup_run
def keep(a):
    return tuple(x.clone() if torch.is_tensor(x) else x for x in a)
def run(*a, **k):
    seen.setdefault("post", (keep(a), k))
    return run0(*a, **k)
def warm(*a, **k):
    if "euclid" not in seen:
        seen["euclid"] = (keep(a), k)
    elif "micro" not in seen and a[1].shape[0] == cs.CHUNK:
        seen["micro"] = (keep(a), k)
    return warm0(*a, **k)
mf.mclmc_fused_run, mf.mclmc_fused_warmup_run = run, warm
sampler = Sampler(model, settings, device=dev)
while "post" not in seen:
    sampler.run_next_chunk()
mf.mclmc_fused_run, mf.mclmc_fused_warmup_run = run0, warm0
keys = ("post", "euclid", "micro") if which == "glm" else ("post",)
# the model (closures) is made again where the launch is timed
at = {"post": 11, "euclid": 10, "micro": 10}
torch.save({key: (seen[key][0][:at[key]] + (None,)
                  + seen[key][0][at[key] + 1:], seen[key][1])
            for key in keys}, path)
model = sampler.model
for key in keys:
    a, k = seen[key]
    fn = (lambda: run0(*a, **k)) if key == "post" else (
        lambda: warm0(*a, **k))
    out = fn()
    torch.cuda.synchronize()
    ms = cs.cuda_events_ms(fn, 3)
    st = out[5] if key == "post" else out[9]
    inputs = a[1:10] if key == "post" else a[1:10]
    b_ms, b_by = cs.bound("mclmc", model, inputs, out, st)
    it = st["loop_iterations"].float()
    group = ""
    mopts = a[12] if key == "post" else a[11]
    if (hasattr(_build, "mclmc_mid_form")
            and _build.mclmc_mid_form(model, mopts) == "group"):
        G = _build.mclmc_mid_group(model.dim, model)
        kind = "posterior" if key == "post" else "warmup"
        group = (f"; group form, G = {G} chains a CUDA block, "
                 f"{_build.mclmc_mid_blocks_per_sm(kind, model, G)} blocks "
                 "an SM")
    print(f"{which} {key} own states: {ms:.4f} ms per launch of "
          f"{tuple(st['n_steps'].shape)} (chains, draws); leapfrogs "
          f"{int(st['n_steps'].sum())}, per draw "
          f"{float(st['n_steps'].float().mean()):.3f}; loop iterations "
          f"mean {float(it.mean()):.1f} max {int(it.max())}; bound "
          f"{b_ms:.4f} ms ({b_by}){group}")
"""

# Item 14's comparison on common inputs: this tree's K3-args and K4-args on
# the launches MCLMC_LAUNCH saved, 5 calls after a first.
MCLMC_TIME = MCLMC_CASES + """
import sys, torch
from nuts_rs_tpu_torch.kernels import mclmc_fused as mf
dev = torch.device("cuda", 0)
sms = torch.cuda.get_device_properties(0).multi_processor_count
for spec in sys.argv[1:]:
    which, path = spec.split("=", 1)
    model = CASES[which][0]().to(dev)
    saved = torch.load(path, weights_only=False)
    for key, (a, k) in saved.items():
        at = 11 if key == "post" else 10  # the model's argument
        a = a[:at] + (model,) + a[at + 1:]
        if key == "post":
            fn, at = (lambda: mf.mclmc_fused_run(*a, **k)), 5
        else:
            fn, at = (lambda: mf.mclmc_fused_warmup_run(*a, **k)), 9
        out = fn()
        torch.cuda.synchronize()
        ms = cs.cuda_events_ms(fn, 5)
        st = out[at]
        it = int(st["loop_iterations"].max())
        leaps = int(st["n_steps"].sum())
        print(f"{which} {key} on {path.rsplit('/', 1)[-1]}: {ms:.4f} ms; "
              f"leapfrogs {leaps}, loop iterations max {it}: "
              f"{1e3 * ms / it:.3f} us a block iteration, "
              f"{1e3 * ms * sms / leaps:.4f} us of an SM a chain's leapfrog")
"""

# Item 14's ablation: K3-args on this tree's saved regression states, 32
# draws with every draw at 6 leapfrogs and no halvings
# (NRT_ABLATE_FIXED_STEPS), and with the macros given (NRT_ABLATE_EVAL:
# without the model's evaluation).
MCLMC_ABLATE = MCLMC_CASES + """
import sys, torch
from nuts_rs_tpu_torch.kernels import _build, mclmc_fused as mf
_build.NVCC_DEFINES[:] = sys.argv[2:]
dev = torch.device("cuda", 0)
label = " ".join(m.removeprefix("NRT_") for m in sys.argv[2:])
sms = torch.cuda.get_device_properties(0).multi_processor_count
which, path = sys.argv[1].split("=", 1)
model = CASES[which][0]().to(dev)
a, k = torch.load(path, weights_only=False)["post"]
a = a[:10] + (32, model) + a[12:]
fn = lambda: mf.mclmc_fused_run(*a, **k)
out = fn()
torch.cuda.synchronize()
ms = cs.cuda_events_ms(fn, 3)
it = int(out[5]["loop_iterations"].max())
leaps = int(out[5]["n_steps"].sum())
print(f"ablation [{label}] {which} K3-args: {ms:.4f} ms, {leaps} "
      f"leapfrogs, block iterations max {it}: {1e3 * ms / it:.3f} us an "
      f"iteration, {1e3 * ms * sms / leaps:.4f} us of an SM a leapfrog")
"""

MCLMC_ABLATIONS = (("NRT_ABLATE_FIXED_STEPS",),
                   ("NRT_ABLATE_FIXED_STEPS", "NRT_ABLATE_EVAL"))
MCLMC_WHICH = ("glm", "normal", "normal256", "radon", "rank1", "funnel",
               "correlated_normal", "sv")


def mclmc_data_launch(trees):
    """Item 14: each distinct tree's own MCLMC data path and functor paths,
    their launches saved; then every tree in the order given (e.g. parent,
    this one, this one, parent) timed on every saved set; then the ablation
    in this tree."""
    from pathlib import Path

    from nuts_rs_tpu_torch.kernels import _build

    _build.BUILD_DIR.mkdir(exist_ok=True)
    saved = {}
    for tree in trees:
        key = Path(tree).resolve()
        if key in saved:
            continue
        saved[key] = []
        for which in MCLMC_WHICH:
            path = str(_build.BUILD_DIR / f"mclmc_{which}_{len(saved)}.pt")
            saved[key].append(f"{which}={path}")
            out = subprocess.run([sys.executable, "-c", MCLMC_LAUNCH, which,
                                  path], cwd=tree, capture_output=True,
                                 text=True)
            if out.returncode:
                raise RuntimeError(f"{tree}: {out.stderr[-3000:]}")
            for line in out.stdout.strip().splitlines():
                print(f"{tree}: {line} [saved as {path}]", flush=True)
    specs = [spec for specs in saved.values() for spec in specs]
    for tree in trees:
        out = subprocess.run([sys.executable, "-c", MCLMC_TIME, *specs],
                             cwd=tree, capture_output=True, text=True)
        if out.returncode:
            raise RuntimeError(f"{tree}: {out.stderr[-3000:]}")
        for line in out.stdout.strip().splitlines():
            print(f"{tree}: {line}", flush=True)
    here = Path(__file__).resolve().parent
    glm = (saved.get(here) or next(iter(saved.values())))[0]
    for defines in MCLMC_ABLATIONS:
        out = subprocess.run([sys.executable, "-c", MCLMC_ABLATE, glm,
                              *defines], cwd=here, capture_output=True,
                             text=True)
        if out.returncode:
            raise RuntimeError(f"ablation {defines}: {out.stderr[-3000:]}")
        print(out.stdout.strip(), flush=True)


# Item 15: K1-ld's first 128-draw posterior launch on the large-d path's own
# post-warmup states (at the path's B = 8 and at B = 1) and K2-ld's first
# full 128-row warmup launch on its own warmup states, in the tree given, as
# SV_LAUNCH does for the SV path; the inputs saved for LD_TIME.
LD_LAUNCH = """
import re, sys, torch
import chip_smoke as cs
from nuts_rs_tpu_torch import DiagNutsSettings, Sampler
from nuts_rs_tpu_torch.kernels import _build, nuts_fused as nf
from nuts_rs_tpu_torch.models.gaussian import normal_logp
dev = torch.device("cuda", 0)
settings = DiagNutsSettings(num_chains=cs.LD_CHAINS, num_tune=cs.LD_TUNE,
                            num_draws=cs.LD_DRAWS, seed=cs.SEED,
                            posterior_kernel="pallas")
seen = {}
run0, warm0 = nf.nuts_fused_run, nf.nuts_fused_warmup_run
def run(*a, **k):
    seen.setdefault("post", (a, k))
    return run0(*a, **k)
def warm(*a, **k):
    if a[1].shape[0] == cs.CHUNK:
        seen.setdefault("warm", (a, k))
    return warm0(*a, **k)
nf.nuts_fused_run, nf.nuts_fused_warmup_run = run, warm
sampler = Sampler(normal_logp(cs.LD_DIM, cs.MU), settings, device=dev)
while "post" not in seen:
    sampler.run_next_chunk()
nf.nuts_fused_run, nf.nuts_fused_warmup_run = run0, warm0
p, w = seen["post"][0], seen["warm"][0]
torch.save({"post": p[:9], "K": p[9], "jitter": p[12], "warm": w[:9],
            "grad": w[12]}, sys.argv[1])
D = settings.nuts_options().maxdepth
for name, fn, key, at, kind in (("K1-ld", run0, "post", 4, "posterior"),
                                ("K2-ld", warm0, "warm", 8, "warmup")):
    a, k = seen[key]
    out = fn(*a, **k)
    torch.cuda.synchronize()
    ms = cs.cuda_events_ms(lambda: fn(*a, **k), 5)
    st = out[at]
    b_ms, b_by = cs.bound("nuts", sampler.model, a[1:9], out, st)
    it = st["loop_iterations"].float()
    where = "one chain block an SM, 15 clusters of 8 (parent's form)"
    if hasattr(_build, "ld_occupancy"):
        per_sm, clusters = _build.ld_occupancy(kind, cs.LD_DIM, D)
        where = (f"form {_build.ld_form(kind, cs.LD_DIM, D)}, {per_sm} chain "
                 f"blocks an SM, {clusters} clusters of 8 resident")
    print(f"{name} own states: {ms:.4f} ms per launch of "
          f"{tuple(st['n_steps'].shape)} (chains, draws); leapfrogs "
          f"{int(st['n_steps'].sum())}, per draw "
          f"{float(st['n_steps'].float().mean()):.2f}; block iterations "
          f"mean {float(it.mean()):.1f} max {int(it.max())}; bound "
          f"{b_ms:.4f} ms ({b_by}); {where}")
for stem in ("nuts_fused_ld_posterior", "nuts_fused_ld_warmup"):
    log = _build.build_log(stem)
    text = log.read_text() if log.exists() else ""
    for entry in text.split("Compiling entry function")[1:]:
        nums = [re.findall(p, entry) for p in (
            r"Used (\\d+) registers", r"(\\d+) bytes stack frame",
            r"(\\d+) bytes spill stores", r"(\\d+) bytes spill loads")]
        mangled = entry.split("\\n")[0]  # <..., MIN_BLOCKS, MERGED>
        form = ("min blocks " + (re.findall(r"Li(\\d)E", mangled) or ["1"])[0]
                + (", merged" if "Lb1EEEv" in mangled else ", today's"))
        print("ptxas {} ({}): registers {} stack {} spill stores {} spill "
              "loads {}".format(stem, form,
                                *(n[0] if n else "?" for n in nums)))
"""

# Item 15's comparison on common inputs: this tree's K1-ld (B = 8 and B = 1)
# and K2-ld on the launches LD_LAUNCH saved, 5 calls after a first.
LD_TIME = """
import sys, torch
import chip_smoke as cs
from nuts_rs_tpu_torch import DiagNutsSettings
from nuts_rs_tpu_torch.kernels import nuts_fused as nf
from nuts_rs_tpu_torch.models.gaussian import normal_logp
dev = torch.device("cuda", 0)
config = DiagNutsSettings(num_chains=cs.LD_CHAINS, seed=cs.SEED,
                          posterior_kernel="pallas").chain_config()
model = normal_logp(cs.LD_DIM, cs.MU)
for path in sys.argv[1:]:
    s = torch.load(path)
    runs = [(f"K1-ld B={b}", lambda b=b: nf.nuts_fused_run(
                *s["post"], s["K"], model, config.nuts, s["jitter"], block=b,
                layout="ld"), 4) for b in (8, 1)]
    runs.append(("K2-ld", lambda: nf.nuts_fused_warmup_run(
        *s["warm"], model, config.nuts, config.step_size, s["grad"],
        layout="ld"), 8))
    for name, fn, at in runs:
        out = fn()
        torch.cuda.synchronize()
        ms = cs.cuda_events_ms(fn, 5)
        it = out[at]["loop_iterations"]
        print(f"{name} on {path.rsplit('/', 1)[-1]}: {ms:.4f} ms; "
              f"leapfrogs {int(out[at]['n_steps'].sum())}, block "
              f"iterations max {int(it.max())}")
"""

# Item 15's ablation, in this tree only: K1-ld on the saved own states with
# every tree at maxdepth 4 (15 leapfrogs a draw, NRT_ABLATE_FIXED_TREES),
# built with the macros given (csrc/nuts_tree_ld.cuh) into a build
# directory of their own; a first argument "build" builds the library,
# prints its ptxas lines and stops.  One chain alone on an SM: 132 chains
# at B = 1; two chains sharing each SM: 264; the path's 512 chains in
# clusters of 8.
LD_ABLATE = """
import re, sys, torch
import chip_smoke as cs
from nuts_rs_tpu_torch.kernels import _build, nuts_fused as nf
from nuts_rs_tpu_torch.kernels.nuts import NutsOptions
from nuts_rs_tpu_torch.models.gaussian import normal_logp
_build.NVCC_DEFINES[:] = sys.argv[2:]
label = " ".join(m.removeprefix("NRT_") for m in sys.argv[2:])
_build.BUILD_DIR = _build.BUILD_DIR / re.sub(r"[^A-Za-z0-9]+", "_", label)
if sys.argv[1] == "build":
    _build.build(["nuts_fused_ld_posterior"])
    text = (_build.BUILD_DIR / "build_nuts_fused_ld_posterior.log").read_text()
    for entry in text.split("Compiling entry function")[1:]:
        if ("Li1ELb0EEEv" in entry.split("\\n")[0]
                and "LD_TODAY" not in label):
            continue  # today's form at one block: the fallback kernel
        nums = [re.findall(p, entry)[:1] or ["?"] for p in (
            r"Used (\\d+) registers", r"(\\d+) bytes stack frame",
            r"(\\d+) bytes spill stores", r"(\\d+) bytes spill loads")]
        print("ptxas [{}]: registers {} stack {} spill stores {} spill loads "
              "{}".format(label, *(n[0] for n in nums)))
    import collections, shutil, subprocess
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(_build._library_path(
        "nuts_fused_ld_posterior"))], capture_output=True, text=True).stdout
    for fn in sass.split("Function : ")[1:]:
        name = fn.split("\\n")[0]
        if "Li1ELb0EEEv" in name and "LD_TODAY" not in label:
            continue
        op = r"/\\*[0-9a-f]{4,}\\*/\\s+(?:@!?U?P\\w+\\s+)?([A-Z][A-Z0-9.]*)"
        ops = collections.Counter(m.split(".")[0] for m in re.findall(op, fn))
        keys = ("LDS", "STS", "LDG", "STG", "SHFL", "BAR", "LDL", "STL",
                "FADD", "FMUL", "BRA")
        print(f"sass [{label}]: {sum(ops.values())} instructions; "
              + ", ".join(f"{k} {ops[k]}" for k in keys))
    raise SystemExit(0)
dev = torch.device("cuda", 0)
saved = torch.load(sys.argv[1])
args, jitter = saved["post"], saved["jitter"]
K, D = 32, 4
opts = NutsOptions(maxdepth=D)
model = normal_logp(cs.LD_DIM, cs.MU)
per_sm, clusters = _build.ld_occupancy("posterior", cs.LD_DIM, D)
sms = torch.cuda.get_device_properties(0).multi_processor_count
line = [f"ablation [{label}]: {per_sm} blocks an SM, {clusters} clusters"]
for C, B, what in ((sms, 1, "one chain alone"),
                   (2 * sms, 1, "two chains an SM"),
                   (cs.LD_CHAINS, 8, "path's 512 at B=8")):
    a = (args[0],) + tuple(x[:C] for x in args[1:])
    def fn():
        return nf.nuts_fused_run(*a, K, model, opts, jitter, block=B,
                                 layout="ld")
    out = fn()
    torch.cuda.synchronize()
    ms = cs.cuda_events_ms(fn, 10)
    leaps = int(out[4]["n_steps"].sum())
    line.append(f"{what}: {ms:.4f} ms, {1e3 * ms * C / leaps:.4f} us a "
                f"chain's leapfrog, {1e3 * ms * sms / leaps:.4f} us of an "
                "SM a leapfrog")
    if "NRT_LD_CLOCKS" in sys.argv and C == sms:
        import ctypes
        lib = _build.library("nuts_fused_ld_posterior")
        clocks = (ctypes.c_ulonglong * 5)()
        lib.nrt_ld_clocks.argtypes = [ctypes.c_int, ctypes.c_void_p]
        lib.nrt_ld_clocks(1, ctypes.cast(clocks, ctypes.c_void_p))
        fn()
        torch.cuda.synchronize()
        lib.nrt_ld_clocks(1, ctypes.cast(clocks, ctypes.c_void_p))
        total = sum(clocks[:4])
        n = leaps / C
        phases = ", ".join(
            f"{name} {clocks[k] / n:.0f} ({100 * clocks[k] / total:.1f}%)"
            for k, name in enumerate(("pass", "leapfrog reduction",
                                      "checks", "scalar tree")))
        line.append(f"chain 0's cycles a leapfrog: {phases}; {total / n:.0f} "
                    f"in all, {clocks[4]} block iterations, "
                    f"{total / (1e3 * ms):.0f} MHz over the timed launches")
print("; ".join(line))
"""

LD_ABLATIONS = tuple(
    ("NRT_ABLATE_FIXED_TREES", *build) for build in (
        ("NRT_LD_TODAY",), ("NRT_LD_TODAY", "NRT_LD_MIN_BLOCKS=2"), (),
        ("NRT_LD_MIN_BLOCKS=2",), ("NRT_LD_EARLY=0",),
        ("NRT_LD_CLOCKS", "NRT_LD_TODAY"), ("NRT_LD_CLOCKS",)))


def ld_launch(trees):
    """Item 15: each distinct tree's own large-d path, its launches saved;
    then every tree in the order given (e.g. parent, this one, this one,
    parent) timed on every saved set; then the ablation in this tree, its
    six builds made together first."""
    from pathlib import Path

    from nuts_rs_tpu_torch.kernels import _build

    here = Path(__file__).resolve().parent
    _build.BUILD_DIR.mkdir(exist_ok=True)
    builds = [subprocess.Popen([sys.executable, "-c", LD_ABLATE, "build",
                                *defines], cwd=here, stdout=subprocess.PIPE,
                               text=True)
              for defines in LD_ABLATIONS]
    saved = {}
    for tree in trees:
        key = Path(tree).resolve()
        if key in saved:
            continue
        saved[key] = str(_build.BUILD_DIR / f"ld_states_{len(saved)}.pt")
        out = subprocess.run([sys.executable, "-c", LD_LAUNCH, saved[key]],
                             cwd=tree, capture_output=True, text=True)
        if out.returncode:
            raise RuntimeError(f"{tree}: {out.stderr[-3000:]}")
        for line in out.stdout.strip().splitlines():
            print(f"{tree}: {line} [saved as {saved[key]}]", flush=True)
    for tree in trees:
        out = subprocess.run([sys.executable, "-c", LD_TIME,
                              *saved.values()], cwd=tree,
                             capture_output=True, text=True)
        if out.returncode:
            raise RuntimeError(f"{tree}: {out.stderr[-3000:]}")
        for line in out.stdout.strip().splitlines():
            print(f"{tree}: {line}", flush=True)
    for p in builds:
        print(p.communicate()[0].strip(), flush=True)
        if p.returncode:
            raise RuntimeError("an ablation build failed")
    states = saved.get(here) or next(iter(saved.values()))
    for defines in LD_ABLATIONS:
        out = subprocess.run([sys.executable, "-c", LD_ABLATE, states,
                              *defines], cwd=here, capture_output=True,
                             text=True)
        if out.returncode:
            raise RuntimeError(f"ablation {defines}: {out.stderr[-3000:]}")
        print(out.stdout.strip(), flush=True)


# Item 16: K1-flow's first 128-draw posterior launch on the flow path's own
# post-warmup states (argv: output file, chains, tuning draws), in this tree;
# its inputs and the packed flow saved for FLOW_TIME.
FLOW_LAUNCH = """
import sys, time, torch
import chip_smoke as cs
from nuts_rs_tpu_torch import FlowNutsSettings, Sampler
from nuts_rs_tpu_torch.kernels import nuts_fused as nf
from nuts_rs_tpu_torch.models.gaussian import funnel
dev = torch.device("cuda", 0)
path, chains, tune = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
settings = FlowNutsSettings(num_chains=chains, num_tune=tune,
                            num_draws=cs.CHUNK, seed=cs.SEED,
                            posterior_kernel="pallas")
seen = {}
run0 = nf.nuts_fused_run
def run(*a, **k):
    if k.get("flow") is not None:
        seen.setdefault("post", (a, k))
    return run0(*a, **k)
nf.nuts_fused_run = run
t0 = time.monotonic()
sampler = Sampler(funnel(cs.FLOW_DIM).to(dev), settings, device=dev)
while "post" not in seen:
    sampler.run_next_chunk()
nf.nuts_fused_run = run0
a, k = seen["post"]
p = k["flow"]
torch.save({"args": a[:9], "K": a[9], "jitter": a[12],
            "maxdepth": a[11].maxdepth,
            "max_energy_error": a[11].max_energy_error,
            "arrays": [x.cpu() for x in p.arrays],
            "max_scale": p.max_scale, "max_shift": p.max_shift}, path)
st = a[7]
print(f"flow path at {chains} chains, {tune} tuning draws: warmup "
      f"{time.monotonic() - t0:.1f} s; first posterior launch's steps "
      f"{float(st.min()):.4f}-{float(st.max()):.4f}")
"""

# Item 16's comparison on common inputs: this tree's K1-flow at B = 1, 2, 4,
# 8 on the launches FLOW_LAUNCH saved (fewer than 256 chains tiled to 256),
# 3 calls after a first; the flow's form, blocks an SM and ptxas lines where
# the tree has them.
FLOW_TIME = """
import re, sys, torch
import chip_smoke as cs
from nuts_rs_tpu_torch.flows.coupling import PackedFlow
from nuts_rs_tpu_torch.kernels import _build, nuts_fused as nf
from nuts_rs_tpu_torch.kernels.nuts import NutsOptions
from nuts_rs_tpu_torch.models.gaussian import funnel
dev = torch.device("cuda", 0)
model = funnel(cs.FLOW_DIM).to(dev)
for path in sys.argv[1:]:
    s = torch.load(path)
    packed = PackedFlow([x.to(dev) for x in s["arrays"]], s["max_scale"],
                        s["max_shift"])
    opts = NutsOptions(maxdepth=s["maxdepth"],
                       max_energy_error=s["max_energy_error"])
    seed, args = s["args"][0], [x.to(dev) for x in s["args"][1:]]
    C0 = args[0].shape[0]
    reps = cs.FLOW_FULL_CHAINS // C0
    args = [x.repeat(reps, *[1] * (x.dim() - 1)) for x in args]
    where = "one form, one chain block an SM (parent's)"
    if hasattr(_build, "flow_blocks_per_sm"):
        form, per_sm = _build.flow_blocks_per_sm(
            model, opts.maxdepth, packed.num_layers, packed.hidden)
        where = f"{form} form, {per_sm} chain blocks an SM"
    name = path.rsplit("/", 1)[-1]
    for B in (1, 2, 4, 8):
        def fn(B=B):
            return nf.nuts_fused_run(seed, *args, s["K"], model, opts,
                                     s["jitter"], B, flow=packed)
        out = fn()
        torch.cuda.synchronize()
        ms = cs.cuda_events_ms(fn, 3)
        it = int(out[4]["loop_iterations"].max())
        print(f"K1-flow B={B} on {name} ({C0} chains tiled to "
              f"{len(args[0])}): {ms:.4f} ms; block iterations max {it}, "
              f"{1e3 * ms / it:.3f} us each; leapfrogs "
              f"{int(out[4]['n_steps'].sum())}; {where}")
text = "".join(
    log.read_text() for log in _build.BUILD_DIR.glob("build_nuts_fused_flow*.log"))
for entry in text.split("Compiling entry function")[1:]:
    mangled = entry.split("\\n")[0]
    if "Funnel" not in mangled:
        continue
    form = "warp" if "FunnelELb1E" in mangled else "today's"
    nums = [re.findall(p, entry)[:1] or ["?"] for p in (
        r"Used (\\d+) registers", r"(\\d+) bytes stack frame",
        r"(\\d+) bytes spill stores", r"(\\d+) bytes spill loads")]
    print("ptxas K1-flow, funnel ({}): registers {} stack "
          "{} spill stores {} spill loads {}".format(
              form, *(n[0] for n in nums)))
"""

# Item 16's ablation, in this tree only: K1-flow on the cut path's saved
# states with every tree at maxdepth 4 (15 leapfrogs a draw,
# NRT_ABLATE_FIXED_TREES), built with the macros given
# (csrc/coupling_flow.cuh, nuts_fused_flow_posterior.cuh) into a build
# directory of their own; a first argument "build" builds the library,
# prints the funnel's ptxas lines and stops.  One chain alone on an SM: 132
# chains; two an SM: 264; then 256 chains.
FLOW_ABLATE = """
import ctypes, re, sys, torch
import chip_smoke as cs
from nuts_rs_tpu_torch.flows.coupling import PackedFlow
from nuts_rs_tpu_torch.kernels import _build, nuts_fused as nf
from nuts_rs_tpu_torch.kernels.nuts import NutsOptions
from nuts_rs_tpu_torch.models.gaussian import funnel
_build.NVCC_DEFINES[:] = sys.argv[2:]
label = " ".join(m.removeprefix("NRT_") for m in sys.argv[2:])
_build.BUILD_DIR = _build.BUILD_DIR / re.sub(r"[^A-Za-z0-9]+", "_", label)
if sys.argv[1] == "build":
    _build.build(cs.PATH_SOURCES["flow"])
    text = "".join((_build.build_log(stem)).read_text()
                   for stem in cs.PATH_SOURCES["flow"])
    for entry in text.split("Compiling entry function")[1:]:
        mangled = entry.split("\\n")[0]
        if "Funnel" not in mangled:
            continue
        form = "warp" if "FunnelELb1E" in mangled else "today's"
        nums = [re.findall(p, entry)[:1] or ["?"] for p in (
            r"Used (\\d+) registers", r"(\\d+) bytes stack frame",
            r"(\\d+) bytes spill stores", r"(\\d+) bytes spill loads")]
        print("ptxas [{}] {}: registers {} stack {} spill stores {} spill "
              "loads {}".format(label, form, *(n[0] for n in nums)))
    raise SystemExit(0)
dev = torch.device("cuda", 0)
s = torch.load(sys.argv[1])
packed = PackedFlow([x.to(dev) for x in s["arrays"]], s["max_scale"],
                    s["max_shift"])
K, D = 32, 4
opts = NutsOptions(maxdepth=D, max_energy_error=s["max_energy_error"])
model = funnel(cs.FLOW_DIM).to(dev)
seed, args = s["args"][0], [x.to(dev) for x in s["args"][1:]]
C0 = args[0].shape[0]
form, per_sm = _build.flow_blocks_per_sm(model, D, packed.num_layers,
                                         packed.hidden)
sms = torch.cuda.get_device_properties(0).multi_processor_count
line = [f"ablation [{label}]: {form} form, {per_sm} chain blocks an SM"]
for C, what in ((sms, "one chain an SM"), (2 * sms, "two chains an SM"),
                (cs.FLOW_FULL_CHAINS, "256 chains")):
    a = [x.repeat(-(-C // C0), *[1] * (x.dim() - 1))[:C] for x in args]
    def fn():
        return nf.nuts_fused_run(seed, *a, K, model, opts, s["jitter"], 1,
                                 flow=packed)
    out = fn()
    torch.cuda.synchronize()
    ms = cs.cuda_events_ms(fn, 5)
    it = int(out[4]["loop_iterations"].max())
    leaps = int(out[4]["n_steps"].sum())
    line.append(f"{what}: {ms:.4f} ms, {it} block iterations, "
                f"{1e3 * ms / it:.3f} us each, {1e3 * ms * sms / leaps:.4f} "
                "us of an SM a leapfrog")
    if "NRT_FLOW_CLOCKS" in sys.argv and C == sms:
        lib = _build.library(_build.FLOW_LIBRARIES[form])
        clocks = (ctypes.c_ulonglong * 11)()
        lib.nrt_flow_clocks.argtypes = [ctypes.c_int, ctypes.c_void_p]
        lib.nrt_flow_clocks(1, ctypes.cast(clocks, ctypes.c_void_p))
        fn()
        torch.cuda.synchronize()
        lib.nrt_flow_clocks(1, ctypes.cast(clocks, ctypes.c_void_p))
        n = clocks[10]
        total = sum(clocks[:10])
        coarse = (("forward pass", sum(clocks[0:5])), ("model", clocks[5]),
                  ("backward pass", sum(clocks[6:9])), ("rest", clocks[9]))
        phases = ", ".join(f"{name} {c / n:.0f} ({100 * c / total:.1f}%)"
                           for name, c in coarse)
        fine = ", ".join(
            f"{name} {clocks[k] / n:.0f}" for k, name in enumerate((
                "z m", "h sums", "h tanh", "head sums", "s t z'", "model",
                "gs gt", "gpre sums", "w1T sums")))
        line.append(f"chain 0's cycles an evaluation: {phases}; "
                    f"{total / n:.0f} in all over {n} evaluations, "
                    f"{total / (1e3 * ms):.0f} MHz over a launch; by phase "
                    f"(today's form: forward in z m, backward in gs gt): "
                    f"{fine}")
print("; ".join(line))
"""

FLOW_ABLATIONS = tuple(
    ("NRT_ABLATE_FIXED_TREES", *build) for build in (
        (), ("NRT_FLOW_MIN_BLOCKS=1",), ("NRT_FLOW_TODAY",),
        ("NRT_FLOW_NO_PASSES",), ("NRT_FLOW_BARRIERS",),
        ("NRT_FLOW_CONFLICTS",), ("NRT_FLOW_ROLLED",), ("NRT_FLOW_CLOCKS",),
        ("NRT_FLOW_CLOCKS", "NRT_FLOW_TODAY")))


def flow_launch(trees, full):
    """Item 16: the flow path's first posterior launch saved in this tree
    (the cut path's and, with ``full``, the full configuration's); then
    every tree in the order given timed on every saved set; then the
    ablation in this tree, its builds made together first."""
    from pathlib import Path

    from nuts_rs_tpu_torch.kernels import _build

    here = Path(__file__).resolve().parent
    _build.BUILD_DIR.mkdir(exist_ok=True)
    builds = [subprocess.Popen([sys.executable, "-c", FLOW_ABLATE, "build",
                                *defines], cwd=here, stdout=subprocess.PIPE,
                               text=True)
              for defines in FLOW_ABLATIONS]
    sets = [("cut", FLOW_CHAINS, FLOW_TUNE)]
    if full:
        sets.append(("full", FLOW_FULL_CHAINS, FLOW_FULL_TUNE))
    saved = []
    for label, chains, tune in sets:
        path = str(_build.BUILD_DIR / f"flow_states_{label}.pt")
        out = subprocess.run([sys.executable, "-c", FLOW_LAUNCH, path,
                              str(chains), str(tune)], cwd=here,
                             capture_output=True, text=True)
        if out.returncode:
            raise RuntimeError(f"flow states {label}: {out.stderr[-3000:]}")
        print(f"{out.stdout.strip()} [saved as {path}]", flush=True)
        saved.append(path)
    for tree in trees:
        out = subprocess.run([sys.executable, "-c", FLOW_TIME, *saved],
                             cwd=tree, capture_output=True, text=True)
        if out.returncode:
            raise RuntimeError(f"{tree}: {out.stderr[-3000:]}")
        for line in out.stdout.strip().splitlines():
            print(f"{tree}: {line}", flush=True)
    for p in builds:
        print(p.communicate()[0].strip(), flush=True)
        if p.returncode:
            raise RuntimeError("an ablation build failed")
    for defines in FLOW_ABLATIONS:
        out = subprocess.run([sys.executable, "-c", FLOW_ABLATE, saved[0],
                              *defines], cwd=here, capture_output=True,
                             text=True)
        if out.returncode:
            raise RuntimeError(f"ablation {defines}: {out.stderr[-3000:]}")
        print(out.stdout.strip(), flush=True)


# Item 17: the MCLMC d = 10 path's own launches (K3's first 128-draw
# posterior launch from the tuned state, K4's Euclidean launch and its first
# microcanonical chunk), saved for MCLMC_D10_TIME.
MCLMC_D10_LAUNCH = """
import sys, torch
import chip_smoke as cs
from nuts_rs_tpu_torch import Sampler
from nuts_rs_tpu_torch.kernels import mclmc_fused as mf
from nuts_rs_tpu_torch.models.gaussian import normal_logp
dev = torch.device("cuda", 0)
seen = {}
run0, warm0 = mf.mclmc_fused_run, mf.mclmc_fused_warmup_run
def keep(a):
    return tuple(x.clone() if torch.is_tensor(x) else x for x in a)
def run(*a, **k):
    seen.setdefault("post", (keep(a), k))
    return run0(*a, **k)
def warm(*a, **k):
    if "euclid" not in seen:
        seen["euclid"] = (keep(a), k)
    elif "micro" not in seen and a[1].shape[0] == cs.CHUNK:
        seen["micro"] = (keep(a), k)
    return warm0(*a, **k)
mf.mclmc_fused_run, mf.mclmc_fused_warmup_run = run, warm
sampler = Sampler(normal_logp(cs.DIM, cs.MU), cs.mclmc_settings(), device=dev)
while "post" not in seen:
    sampler.run_next_chunk()
mf.mclmc_fused_run, mf.mclmc_fused_warmup_run = run0, warm0
at = {"post": 11, "euclid": 10, "micro": 10}  # the model, made again
torch.save({key: (a[:at[key]] + (None,) + a[at[key] + 1:], k)
            for key, (a, k) in seen.items()}, sys.argv[1])
for key, (a, k) in seen.items():
    rows, chains = (a[10], a[1]) if key == "post" else (a[1].shape[0], a[2])
    print(f"saved {key}: {rows} draws of {chains.shape[0]} chains")
"""

# Item 17's timing on the saved launches in the tree given (5 calls after a
# first), then the path end to end (items 1 and 2) unless "--launches".
MCLMC_D10_TIME = """
import sys, torch
import chip_smoke as cs
import profile_main_path as pm
from nuts_rs_tpu_torch.kernels import _build, mclmc_fused as mf
from nuts_rs_tpu_torch.models.gaussian import normal_logp
label = ""
if sys.argv[2] != "-":
    _build.NVCC_DEFINES[:] = sys.argv[2].split(",")
    label = "[" + " ".join(m.removeprefix("NRT_")
                           for m in _build.NVCC_DEFINES) + "] "
dev = torch.device("cuda", 0)
model = normal_logp(cs.DIM, cs.MU).to(dev)
saved = torch.load(sys.argv[1], weights_only=False)
for key in ("post", "micro", "euclid"):
    a, k = saved[key]
    at = 11 if key == "post" else 10
    a = a[:at] + (model,) + a[at + 1:]
    if key == "post":
        fn, at = (lambda: mf.mclmc_fused_run(*a, **k)), 5
    else:
        fn, at = (lambda: mf.mclmc_fused_warmup_run(*a, **k)), 9
    out = fn()
    torch.cuda.synchronize()
    ms = cs.cuda_events_ms(fn, 5)
    st = out[at]
    it = int(st["loop_iterations"].max())
    lanes = (f", {_build.mclmc_lanes(cs.DIM, 32)} lanes a chain"
             if hasattr(_build, "mclmc_lanes") else ", one thread a chain")
    print(f"{label}{'K3' if key == 'post' else 'K4'} {key}: {ms:.4f} ms; "
          f"leapfrogs {int(st['n_steps'].sum())}, block iterations max "
          f"{it}: {1e3 * ms / it:.3f} us a block iteration{lanes}",
          flush=True)
if "--path" in sys.argv:
    settings = cs.mclmc_settings()
    pm.run_main_path(model, settings, dev)
    for rep in range(3):
        pm.print_run(f"run {rep}", pm.run_main_path(model, settings, dev),
                     settings.num_tune)
    pm.profile_once(model, settings, dev)
"""

# Item 17's builds: a chain's lanes fixed, and the normals and divisions
# left out (timing only; these change results)
MCLMC_D10_ABLATIONS = (
    ("NRT_MCLMC_LANES=1",), ("NRT_MCLMC_LANES=4",), ("NRT_MCLMC_LANES=8",),
    ("NRT_MCLMC_LANES=16",), ("NRT_ABLATE_MCLMC_NORMALS",),
    ("NRT_ABLATE_MCLMC_DIVISIONS",),
    ("NRT_ABLATE_MCLMC_NORMALS", "NRT_ABLATE_MCLMC_DIVISIONS"),
    ("NRT_MCLMC_LANES=1", "NRT_ABLATE_MCLMC_NORMALS"),
    ("NRT_MCLMC_LANES=1", "NRT_ABLATE_MCLMC_DIVISIONS"))


def mclmc_launch(trees):
    """Item 17: the MCLMC d = 10 path's launches, parent against change,
    then this tree's ablation builds."""
    launch_and_ablate(trees, MCLMC_D10_LAUNCH, MCLMC_D10_TIME,
                      MCLMC_D10_ABLATIONS, "mclmc_d10_launches.pt",
                      ("mclmc_fused_posterior", "mclmc_fused_warmup"))


def nuts_launch(trees):
    """Item 18: the NUTS d = 10 path's launches, parent against change,
    then this tree's ablation builds."""
    launch_and_ablate(trees, NUTS_D10_LAUNCH, NUTS_D10_TIME,
                      NUTS_D10_ABLATIONS, "nuts_d10_launches.pt",
                      ("nuts_fused_posterior", "nuts_fused_warmup"))


# Item 18: the NUTS d = 10 path's own launches (K1's first 128-draw
# posterior launch from the tuned state, K2's first full chunk), saved for
# NUTS_D10_TIME.
NUTS_D10_LAUNCH = """
import sys, torch
import chip_smoke as cs
from nuts_rs_tpu_torch import DiagNutsSettings, Sampler
from nuts_rs_tpu_torch.kernels import nuts_fused as nf
from nuts_rs_tpu_torch.models.gaussian import normal_logp
dev = torch.device("cuda", 0)
seen = {}
run0, warm0 = nf.nuts_fused_run, nf.nuts_fused_warmup_run
def keep(a):
    return tuple(x.clone() if torch.is_tensor(x) else x for x in a)
def run(*a, **k):
    seen.setdefault("post", (keep(a), k))
    return run0(*a, **k)
def warm(*a, **k):
    if "warm" not in seen and a[1].shape[0] == cs.CHUNK:
        seen["warm"] = (keep(a), k)
    return warm0(*a, **k)
nf.nuts_fused_run, nf.nuts_fused_warmup_run = run, warm
settings = DiagNutsSettings(num_chains=cs.CHAINS, num_tune=cs.TUNE,
                            num_draws=cs.DRAWS, seed=cs.SEED,
                            posterior_kernel="pallas")
sampler = Sampler(normal_logp(cs.DIM, cs.MU), settings, device=dev)
while "post" not in seen:
    sampler.run_next_chunk()
nf.nuts_fused_run, nf.nuts_fused_warmup_run = run0, warm0
at = {"post": 10, "warm": 9}  # the model, made again
torch.save({key: (a[:at[key]] + (None,) + a[at[key] + 1:], k)
            for key, (a, k) in seen.items()}, sys.argv[1])
for key, (a, k) in seen.items():
    rows, chains = (a[9], a[1]) if key == "post" else (a[1].shape[0], a[2])
    print(f"saved {key}: {rows} draws of {chains.shape[0]} chains")
"""

# Item 18's timing on the saved launches in the tree given (5 calls after a
# first), then the path end to end (items 1 and 2) with "--path".
NUTS_D10_TIME = """
import sys, torch
import chip_smoke as cs
import profile_main_path as pm
from nuts_rs_tpu_torch import DiagNutsSettings
from nuts_rs_tpu_torch.kernels import _build, nuts_fused as nf
from nuts_rs_tpu_torch.models.gaussian import normal_logp
label = ""
if sys.argv[2] != "-":
    _build.NVCC_DEFINES[:] = sys.argv[2].split(",")
    label = "[" + " ".join(m.removeprefix("NRT_")
                           for m in _build.NVCC_DEFINES) + "] "
dev = torch.device("cuda", 0)
model = normal_logp(cs.DIM, cs.MU).to(dev)
saved = torch.load(sys.argv[1], weights_only=False)
for key in ("post", "warm"):
    a, k = saved[key]
    at = 10 if key == "post" else 9
    a = a[:at] + (model,) + a[at + 1:]
    if key == "post":
        fn, at = (lambda: nf.nuts_fused_run(*a, **k)), 4
    else:
        fn, at = (lambda: nf.nuts_fused_warmup_run(*a, **k)), 8
    out = fn()
    torch.cuda.synchronize()
    ms = cs.cuda_events_ms(fn, 5)
    st = out[at]
    it = int(st["loop_iterations"].max())
    lanes = (f", {_build.nuts_lanes(cs.DIM, nf.DEFAULT_BLOCK)} lanes a chain"
             if hasattr(_build, "nuts_lanes") else ", one thread a chain")
    print(f"{label}{'K1' if key == 'post' else 'K2'} {key}: {ms:.4f} ms; "
          f"leapfrogs {int(st['n_steps'].sum())}, depth up to "
          f"{int(st['depth'].max())}, block iterations max {it}: "
          f"{1e3 * ms / it:.3f} us a block iteration{lanes}", flush=True)
if "--path" in sys.argv:
    settings = DiagNutsSettings(num_chains=cs.CHAINS, num_tune=cs.TUNE,
                                num_draws=cs.DRAWS, seed=cs.SEED,
                                posterior_kernel="pallas")
    pm.run_main_path(model, settings, dev)
    for rep in range(3):
        pm.print_run(f"run {rep}", pm.run_main_path(model, settings, dev),
                     settings.num_tune)
    pm.profile_once(model, settings, dev)
"""

# Item 18's builds: a chain's lanes fixed, the fresh momentum's normals left
# out (timing only; changes results), the stacks in shared memory
NUTS_D10_ABLATIONS = (
    ("NRT_NUTS_LANES=1",), ("NRT_NUTS_LANES=2",), ("NRT_NUTS_LANES=8",),
    ("NRT_NUTS_LANES=16",),
    ("NRT_NUTS_LANES=8", "NRT_NUTS_MAX_THREADS=512"),
    ("NRT_NUTS_LANES=16", "NRT_NUTS_MAX_THREADS=512"),
    ("NRT_ABLATE_NUTS_NORMALS",),
    ("NRT_NUTS_LANES=1", "NRT_ABLATE_NUTS_NORMALS"),
    ("NRT_NUTS_SMEM_STACKS",),
    ("NRT_NUTS_LANES=16", "NRT_NUTS_MAX_THREADS=512",
     "NRT_NUTS_SMEM_STACKS"))


def launch_and_ablate(trees, launch, time_src, ablations, saved_name, stems):
    """Items 17 and 18: the path's launches saved in this tree by
    ``launch``; every tree in the order given (e.g. parent, this one, this
    one, parent) timed on them by ``time_src`` with its path end to end;
    then this tree's ``ablations`` builds of ``stems``, compiled together,
    each timed on the same launches."""
    from pathlib import Path

    from nuts_rs_tpu_torch.kernels import _build

    _build.BUILD_DIR.mkdir(exist_ok=True)
    here = Path(__file__).resolve().parent
    saved = str(_build.BUILD_DIR / saved_name)
    out = subprocess.run([sys.executable, "-c", launch, saved], cwd=here,
                         capture_output=True, text=True)
    if out.returncode:
        raise RuntimeError(out.stderr[-3000:])
    print(out.stdout.strip(), flush=True)
    for tree in trees:
        out = subprocess.run([sys.executable, "-c", time_src, saved, "-",
                              "--path"], cwd=tree, capture_output=True,
                             text=True)
        if out.returncode:
            raise RuntimeError(f"{tree}: {out.stderr[-3000:]}")
        for line in out.stdout.strip().splitlines():
            print(f"{tree}: {line}", flush=True)
    build = ("import sys\nfrom nuts_rs_tpu_torch.kernels import _build\n"
             "_build.NVCC_DEFINES[:] = sys.argv[1].split(',')\n"
             f"_build.build({list(stems)!r})")
    procs = [subprocess.Popen([sys.executable, "-c", build, ",".join(d)],
                              cwd=here, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for d in ablations]
    for defines, p in zip(ablations, procs):
        text = p.communicate()[0].strip()
        if p.returncode:
            raise RuntimeError(f"ablation build {defines}: {text[-3000:]}")
    for defines in ablations:
        out = subprocess.run([sys.executable, "-c", time_src, saved,
                              ",".join(defines)], cwd=here,
                             capture_output=True, text=True)
        if out.returncode:
            raise RuntimeError(f"ablation {defines}: {out.stderr[-3000:]}")
        print(out.stdout.strip(), flush=True)
    for defines in [()] + list(ablations):
        _build.NVCC_DEFINES[:] = defines
        for stem in stems:
            log = _build.build_log(stem)
            if log.exists():
                print(f"ptxas {stem} [{' '.join(defines) or 'as built'}]: "
                      + "; ".join(ptxas_entries(log.read_text())),
                      flush=True)
    _build.NVCC_DEFINES[:] = []


def ptxas_entries(text):
    """Each entry function of an ``-Xptxas -v`` log: its name with its
    template's integer and boolean arguments, registers, stack frame and
    spill stores."""
    lines = []
    for entry in text.split("Compiling entry function")[1:]:
        mangled = entry.split("\n")[0]
        name = re.findall(r"nrt\d+(\w+?)I", mangled)
        targs = ",".join(re.findall(r"L[ib](\d+)E", mangled))
        nums = [re.findall(p, entry)[:1] or ["?"] for p in (
            r"Used (\d+) registers", r"(\d+) bytes stack frame",
            r"(\d+) bytes spill stores")]
        lines.append("{}<{}> {} registers, {} stack, {} spill".format(
            name[0] if name else mangled[:40], targs, *(n[0] for n in nums)))
    return lines


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--repeats", type=int, default=3)
    parser.add_argument("--trace", help="write a Chrome trace here")
    parser.add_argument("--only-large-d", action="store_true",
                        help="skip the two d=10 paths")
    parser.add_argument("--only-own-states", action="store_true",
                        help="item 5 alone")
    parser.add_argument("--only-data", action="store_true",
                        help="the data path alone, items 1-3 and 6")
    parser.add_argument("--only-mclmc-data", action="store_true",
                        help="the MCLMC data path alone, items 1-3 and 7")
    parser.add_argument("--only-stream", action="store_true",
                        help="the streamed-data path alone, item 8")
    parser.add_argument("--only-zoo", action="store_true",
                        help="the SV and radon paths alone, item 9")
    parser.add_argument("--only-mclmc-sync", action="store_true",
                        help="the sync MCLMC path alone, item 19")
    parser.add_argument("--only-flow", action="store_true",
                        help="the flow path alone at its full configuration,"
                             " item 10")
    parser.add_argument("--log", help="append item 10's lines here too, as "
                        "they come")
    parser.add_argument("--stream-launch", nargs="+", metavar="TREE",
                        help="item 11 alone, for each checkout in turn")
    parser.add_argument("--sv-launch", nargs="+", metavar="TREE",
                        help="item 12 alone, for each checkout in turn, "
                             "then its ablation in this one")
    parser.add_argument("--data-launch", nargs="+", metavar="TREE",
                        help="item 13 alone, for each checkout in turn")
    parser.add_argument("--mclmc-data-launch", nargs="+", metavar="TREE",
                        help="item 14 alone, for each checkout in turn, "
                             "then its ablation in this one")
    parser.add_argument("--ld-launch", nargs="+", metavar="TREE",
                        help="item 15 alone, for each checkout in turn, "
                             "then its ablation in this one")
    parser.add_argument("--flow-launch", nargs="+", metavar="TREE",
                        help="item 16 alone, for each checkout in turn, "
                             "then its ablation in this one")
    parser.add_argument("--mclmc-launch", nargs="+", metavar="TREE",
                        help="item 17 alone, for each checkout in turn, "
                             "then its ablation in this one")
    parser.add_argument("--nuts-launch", nargs="+", metavar="TREE",
                        help="item 18 alone, for each checkout in turn, "
                             "then its ablation in this one")
    parser.add_argument("--flow-full", action="store_true",
                        help="item 16 on the full configuration's states "
                             "too (about 11 minutes more)")
    args = parser.parse_args()
    only = ("large-d" if args.only_large_d else "data" if args.only_data
            else "mclmc-data" if args.only_mclmc_data else None)
    if not torch.cuda.is_available():
        raise RuntimeError("profile_main_path.py needs a CUDA card")
    from nuts_rs_tpu_torch import DiagMclmcSettings, DiagNutsSettings
    from nuts_rs_tpu_torch.kernels import _build
    from nuts_rs_tpu_torch.models.gaussian import (
        logistic_regression,
        normal_logp,
    )

    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    print(card_line())
    if args.stream_launch:
        stream_launch(args.stream_launch)
        print(card_line())
        return 0
    if args.sv_launch:
        sv_launch(args.sv_launch)
        print(card_line())
        return 0
    if args.data_launch:
        data_launch(args.data_launch)
        print(card_line())
        return 0
    if args.mclmc_data_launch:
        mclmc_data_launch(args.mclmc_data_launch)
        print(card_line())
        return 0
    if args.ld_launch:
        ld_launch(args.ld_launch)
        print(card_line())
        return 0
    if args.flow_launch:
        flow_launch(args.flow_launch, args.flow_full)
        print(card_line())
        return 0
    if args.mclmc_launch:
        mclmc_launch(args.mclmc_launch)
        print(card_line())
        return 0
    if args.nuts_launch:
        nuts_launch(args.nuts_launch)
        print(card_line())
        return 0
    if args.only_mclmc_sync:
        mclmc_sync_path(device)
        print(card_line())
        return 0
    if args.only_stream:
        _build.build(["nuts_fused_stream_posterior"])
        stream_path(device)
        print(card_line())
        return 0
    if args.only_flow:
        _build.build(PATH_SOURCES["flow"])
        flow_path(device, args.log)
        print(card_line())
        return 0
    if args.only_zoo:
        _build.build([*PATH_SOURCES["sv"], *PATH_SOURCES["radon"]])
        zoo_paths(device, args.repeats, args.trace)
        print(card_line())
        return 0
    _build.build()
    model = normal_logp(DIM, MU)
    nuts = DiagNutsSettings(num_chains=CHAINS, num_tune=TUNE,
                            num_draws=DRAWS, seed=SEED,
                            posterior_kernel="pallas")
    large = DiagNutsSettings(num_chains=LD_CHAINS, num_tune=LD_TUNE,
                             num_draws=LD_DRAWS, seed=SEED,
                             posterior_kernel="pallas")
    glm = logistic_regression(GLM_ROWS, GLM_DIM, SEED).to(device)
    data = DiagNutsSettings(num_chains=GLM_CHAINS, num_tune=GLM_TUNE,
                            num_draws=GLM_DRAWS, seed=SEED,
                            posterior_kernel="pallas")
    mdata = DiagMclmcSettings(num_chains=GLM_CHAINS, num_tune=GLM_TUNE,
                              num_draws=GLM_DRAWS, seed=SEED,
                              posterior_kernel="pallas")
    if args.only_own_states:
        sweep_ld_own_states(normal_logp(LD_DIM, MU), large, device)
        print(card_line())
        return 0
    for label, model, settings, launches, blocks in (
            ("NUTS", model, nuts, nuts_launches, BLOCKS),
            ("MCLMC", model, mclmc_settings(), mclmc_launches, BLOCKS),
            ("large-d", normal_logp(LD_DIM, MU), large, ld_launches,
             LD_BLOCKS),
            ("data", glm, data, glm_launches, LD_BLOCKS),
            ("mclmc-data", glm, mdata, mclmc_data_launches, LD_BLOCKS)):
        if only and label != only:
            continue
        print(f"== {label} path")
        run_main_path(model, settings, device)  # first launches, allocator
        for rep in range(args.repeats):
            print_run(f"run {rep}", run_main_path(model, settings, device),
                      settings.num_tune)
        trace = (args.trace.replace(".json", f"_{label.lower()}.json")
                 if args.trace else None)
        profile_once(model, settings, device, trace)
        sweep_blocks(launches(model, settings, device), blocks,
                     settings.num_chains)
    if only in (None, "large-d"):
        sweep_ld_dims(large, device)
        sweep_ld_own_states(normal_logp(LD_DIM, MU), large, device)
    if only in (None, "data"):
        evaluation_cost(glm, data, device)
    if only in (None, "mclmc-data"):
        mclmc_iteration_cost(glm, mdata, device)
    if only is None:
        stream_path(device)
        zoo_paths(device, args.repeats, args.trace)
    print(card_line())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
