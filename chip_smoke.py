#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (nuts_rs_tpu_torch) on one CUDA card.

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

It builds the fused CUDA kernels from ``nuts_rs_tpu_torch/csrc`` (nvcc,
sm_90a), holds each kernel against its plain PyTorch version on the card,
and drives nineteen paths through ``Sampler(...).run()``, fourteen of them
with ``posterior_kernel="pallas"`` (``--only PATH`` drives one path,
one of them or the float64 ``low_rank64``:
``nuts``, ``control``, ``pipeline``, ``mclmc``, ``float64``, ``large_d``,
``data``, ``mclmc_data``,
``stream``, ``sv``, ``radon``, ``zoo``, ``flow``, ``mclmc_sync``,
``exact_normal``, ``mclmc_d400``, ``low_rank``, ``low_rank64``,
``low_rank_exact`` or ``cross_chain``, and builds only its kernels).  The ``float64`` path runs
the NUTS and MCLMC d=10 configurations below at ``dtype=float64``: K1-K4
on float32 copies of the state, as the JAX package plans them, without a
warning, the main paths' gates, and the trace's dtypes the JAX run's
(NUTS float64, MCLMC float32).  The ``low_rank`` path is BASELINE config
2, ``correlated_normal_rank1(100)`` under ``LowRankNutsSettings`` (64
chains, 800 tuning draws, the posterior cut to 200, at the default
float32), demoted from ``"pallas"`` to the sync engine with the JAX
warning, held to a bound on the chains whose step collapsed and, over the
others, to the analytic moments (every coordinate, and the variance along
the inflated direction u), the divergence share and the accept rate, and
to the refits' eigenvalues; ``low_rank64`` (with ``--only`` alone) the
same at float64, where no chain may collapse; ``low_rank_exact`` the reference's whitening oracle at
float64 (``fisher_distance`` < 1e-10); ``cross_chain`` the NUTS d=10
model and chains with ``cross_chain_adaptation=True`` on the sync engine
(one mass matrix and adapted step for every chain, the main path's
moment gates).  The
``control`` path drives the Sampler's control surface on the NUTS d=10
configuration below (K1, K2): a checkpoint at the first chunk boundary at
or after draw 428, ``abort``, and a restore into a fresh sampler, equal to
the uninterrupted run bit for bit; the same checkpoint restored on the
CPU (its state bit for bit, its first 2 draws on the plain versions within
the kernel checks' tolerances, integer stats equal); ``wait_timeout(0.0)``;
a pause from a progress callback, ``resume`` and the final
``ChainProgress``; a ``ConvergenceStop(rhat_max=1.01, min_ess_bulk=400)``
(shorter than 700 posterior draws, the moment gates); ``expand_fn`` and a
draw-indexed ``expand_host_fn`` at float16 draws (equal to ``exp(q - 3)``
of the float32 run's positions; the index invariant to the chunk size);
and the stuck-chain detector raising on 256 frozen chains of 1024 on the
sync engine.  The ``pipeline`` path drives, on the same configuration,
``run()`` pipelined against a ``run_next_chunk`` loop (the same trace bit
for bit; end-to-end and posterior seconds and K1 / K2's busy share, by
CUDA events, of each), ``run()`` into ``ZarrConfig(async_writes=True)``
(every array read back equal to the serial run's; the Zarr write and
``finalize`` seconds beside memory storage's), ``max_chains_per_launch=512``
(twice K1's and K2's launches, the moment gates, each group's first
posterior launch against its plain version), ``profile_dir`` (a chunk's
Chrome trace names K1's kernel) and ``auto_recover``: a real
``torch.cuda.OutOfMemoryError`` replayed at half the launch size, and a
child process whose runner hits a device-side assert and raises
``DeviceLostError``, whose spill a second child, started beside it,
restores and finishes, the two equal to the uninterrupted run bit for bit
(in a whole run the two children start beside the flow path's sync
warmup, once K1 and K2 are built, and end before any kernel is checked or
timed).  The SV path's first run passes ``fail_after=None``
(``check_stuck`` needs its whole trace); a second run with the default
``fail_after=100``, paused at draw 130, must raise ``ChainFailedError``
exactly where the detector replayed on the first run's draws says, or
not at all where the replay names no chain.  The exact-normal path runs
with ``progress_tick=16`` and checks the ticks.  The last three are the sync
engines': ``mclmc_sync`` is the MCLMC d=10 configuration below on the sync
MCLMC engine (``DiagMclmcSettings``' default ``posterior_kernel="sync"``)
with the ``store_gradient``, ``store_unconstrained``, ``store_divergences``
and ``store_mass_matrix`` extra stores (the MCLMC gates below, the stored
gradient within 1e-5 of -(q - 3), ``mass_matrix_inv`` of shape
[C, draws, d], no fused launch); ``exact_normal`` is NUTS with the
exact-normal kinetic energy on N(3, 1) at d=10 with 1024 chains, 100 +
300 draws, a ``"pallas"`` request demoted to the sync NUTS engine with the
JAX package's warning (the analytic moments, no divergence, acceptance at
least 0.99: the JAX engine's is 0.999999 there, no fused launch);
``mclmc_d400`` is MCLMC on N(3, 1) at d=400 with 512 chains, 200 + 300
draws, between the fused MCLMC warmup's limit and the posterior's: the
sync warmup, then K3's mid form, without a warning, held against the JAX
sync engine (``tests/data/mclmc_normal_d400_reference.json``, made by
``tests/data/make_mclmc_sync_reference.py``), its first posterior launch
checked bit for bit on the path's own post-warmup states (K = 2, after
asserting that the plain version's trajectories move) and timed.  In a
whole run ``low_rank`` (``--beside 0``) and these two with
``cross_chain`` and ``low_rank_exact`` (``--beside 1``) run in two more
processes beside the flow path's sync warmup; the flow path waits for
them before it checks or times a kernel.  The NUTS d=10 path also runs ``Sampler.run`` once more
with the transfer knobs (``keep_stats``, float16 ``draw_dtype`` and
``stats_dtype``, ``store_warmup=False``: no warmup group, the kept stats
alone, the positions the first run's cast to float16 bit for bit), and the
large-d path twice more, at float32 and at float16 ``draw_dtype``, with
their copies', ``finalize``'s and end-to-end seconds.  Two run
N(3, 1) at d=10 with 1024 chains,
300 tuning and 700 posterior draws: NUTS (``DiagNutsSettings``, kernels K1
and K2) and MCLMC (``DiagMclmcSettings``, kernels K3 and K4, a chain's
coordinates on 16 lanes).  The third is
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
data, more than a block's shared memory and the card's L2), 256 chains, 100
tuning and 256 posterior draws (the JAX benchmark's 300 and 400 cut for this
script's time; ``profile_main_path.py --only-stream`` runs them whole): the
per-draw sync engine (plain PyTorch) for the warmup, then the posterior on
kernel K1-stream, whose logical block is the JAX runner's (all 256 chains,
one cooperative grid: every pass over the tiles of 512 rows serves every
chain, its rows split over all SMs); its posterior is held against the JAX
package's sync engine on the same rows
(``tests/data/logreg_big_reference.json``), and its launch counts must be 2
of K1-stream and none of a fused warmup kernel.  K1-stream is checked at the
path's rows and dimension on 64 chains (one block of 64), and timed per
128-draw launch on made-up states and on the path's own final states, with
the microseconds a round of 256 evaluations takes and the share of the
card's FP32 issue rate that its two products are.  The seventh is
the model zoo's headline, stochastic volatility with T = 1000 returns
(d = 1002, above the chains-on-lanes limit), 512 chains, 400 tuning and 300
posterior draws, on the dim-on-lanes kernels with the model's data,
K1-ld-args and K2-ld-args; the eighth radon (85 groups of 12 rows, d = 89),
1024 chains, 300 tuning and 400 posterior draws, on K1-args and K2-args
with the Radon functor.  Both are held against the JAX package's sync
engine on a CPU (``tests/data/sv_t1000_reference.json``,
``tests/data/radon_reference.json``, made by
``tests/data/make_zoo_reference.py``): every coordinate's and each named
quantity's (SV: sigma and nu; radon: mu_a, beta, sigma, sigma_a) posterior
mean within 0.1 posterior std and std within 10%, a divergence share at
most the reference's plus 0.2 percentage points and two standard errors
of the reference's share (SV: 0.23 points each), mean accept in
(0.7, 0.95), launches of their two kernels and of no other fused NUTS
kernel; these hold the chains that are not stuck where they started
(``stuck_chains``: SV's far starts in log sigma, where every tree
diverges); the stuck chains are held against those that the JAX
package's sync engine leaves stuck when it starts from this run's own
starts beyond log sigma 0 (the reference's ``far_starts``): every one
started there, and the chains stuck in one engine only, b here and c
there, satisfy |b - c| <= 3 sqrt(b + c); radon's reference records none,
so no radon chain may stick.  The ninth drives
the three other hook models, the rank-1 normal
(d = 100), the funnel (d = 10) and correlated_normal (d = 100), each with
256 chains, 200 tuning and 200 draws on the mid-d kernels, the two normals
held against their analytic moments (0.1 std, 10%).  The tenth is the
flow path: ``funnel(10)`` under ``FlowNutsSettings`` with the default
coupling flow (4 layers of 32), the JAX package's flow benchmark (256
chains, 600 + 600 draws; ``profile_main_path.py --only-flow`` runs it
whole) cut to 64 chains, 30 tuning and 512 posterior draws: the warmup on
the per-draw sync engine with the flow's refits (draws 10 and 20), the
posterior on kernel K1-flow through the frozen pooled flow; held against
the JAX package's sync engine at the same settings over 8 seeds
(``tests/data/flow_funnel_reference.json``, made by
``tests/data/make_flow_reference.py``): v's and every u_i = x_i e^(-v/2)'s
mean and std (u_i is N(0, 1) under the funnel, with light tails; the x_i's
own stds are printed, not gated: their run-to-run spread is 23-50%) within
max(0.1 std, 10%) or 3 sqrt(1 + 1/8) of the 8 runs' run-to-run spread,
the divergence share at most the seed-0 run's plus 0.2 points and two of
its standard errors, a refit kept, exactly 4 launches of K1-flow and none
of another fused kernel, all in the flow's warp form (``_build.flow_form``:
both passes on one warp at d <= 32 and H <= 32).  K1-flow is checked bit
for bit on the path's own states (64 chains, 2 draws) and timed at 256
chains on the path's own and on made-up states, beside the flow's forward
and vector-Jacobian product by batched PyTorch calls.  Its other form,
today's (every thread of the chain's block; d > 32 or H > 32), has a row of
its own: ``funnel(40)`` through the default flow driven by ``Sampler.run``
with 8 chains, 5 tuning and 128 posterior draws (one launch, in today's
form; every chain must move), a check launch of 8 chains and one draw
through a flow off the identity, max abs err 0, and its 128-draw launch
timed at 256 chains on made-up states; both launches' trees must grow
(depth above 0 somewhere, not every draw divergent).  The model
functors
(``csrc/models.cuh``) are rows of the kernel line of their own, checked in
the kernels that evaluate them: SV's in K1-ld-args and K2-ld-args at the
path's d on 64 chains (2 draws, and warmup schedule rows 7..8 with the
window switch, from a post-warmup-like state), radon's in K1-args and
K2-args the same way at 8 draws, the other three's in K1-args on 64
chains and 2 draws; a
functor's launches are the kernel launches of its path that evaluated
it.  For each path it sets
the launch counts to 0, runs, reads them, and checks that its kernels ran
and that the posterior is right.  Every kernel is held against its plain
version at its path's chains and dimension (8 posterior or up to 16 warmup
draws); the mid-d kernels, NUTS and MCLMC, also on N(3, 1) at d=100 with 64
chains in logical blocks of 8.  Cut to keep the script under five minutes:
K2-args is checked on 2 schedule rows (7..8, with the window switch), not
16, K2-ld and the mid-d K2 without data on 8 (2..9); K4-args' rows start
from a post-warmup-like state, not the initial one; the streamed-data path
runs a third of its warmup and two of its four posterior launches, and
K1-stream's 128-draw launch is timed once, and so is that of K1-flow's
today's form; K1-stream, K1-ld-args, K1-flow and K1-args on the three zoo
functors are checked on 2 draws; the zoo's checks run 64 chains and two
warmup rows, and the zoo path's three functors are timed in the posterior
kernel alone.  The build runs beside the paths (the host's cores less two,
niced, in the order the paths need the sources), each path waiting for its
own sources alone; the flow path runs first, its sync warmup needing no
kernel, and the streamed-data path second.

Each kernel is timed (CUDA events) beside its plain version on the check's
inputs (``ms``, ``plain_ms``, with the bound ``bound_ms`` of that work), and
alone at its path's 128-draw launch (``chunk_ms``, ``chunk_bound_ms``;
K1-flow's, K1-stream's, K1-ld-args', K2-ld-args', K1-args' and K2-args'
(and radon's row, K1-args on the radon path) on the path's own states,
with ``chunk_ms_made_up`` beside: a posterior kernel's own launch is its
path's first posterior launch, a warmup kernel's the path's first full
chunk of 128 warmup draws; the mid-d kernels' chains a CUDA block, G, and
blocks an SM are printed with them; the block form of K4-args on the MCLMC
data path's Euclidean launch, rows 0 .. the trajectory switch from the
initial state, with its slowest chain's iterations).  The
bound is the larger of the bytes the call must move (every input read once,
every output written once) over 3.35 TB/s and its FP32 operations over 67
TFLOP/s, the card's published peaks; operations are counted from the
leapfrogs the run's data needed (``n_steps``), ``FLOP_PER_COORD`` per
coordinate, and for the logistic regression 4 N d + 4 (N + d) more per
evaluation, for the other functors what ``model_flop_per_grad`` counts,
with their data among the bytes.  No single PyTorch call computes
a NUTS or MCLMC launch, so ``library_ms`` is null; the time of one batched
evaluation of the regression by two ``torch.matmul`` calls is printed as a
yardstick for its products.

Output: the card's name and power limit, the nvcc version, the host's
usable cores, the checks and timings, each path's seconds with its checks'
plain versions', each nvcc's seconds and ptxas line, a JSON line
``{"kernels": [...]}`` and, last,
``{"ok": true, "device": {...}}``.  Any failure raises and exits non-zero;
without a CUDA card it exits non-zero before printing a result.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
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
# the checks whose plain versions took longest at 8 draws (on one host:
# K1-ld-args 20.0 s, K1-stream 10.7, K1-args on the funnel 10.2, K1-flow on
# its path's own states 9.9, on the rank-1 normal 5.4): 2 draws, every chain
CHECK_SHORT_DRAWS = 2
# K2-args' check: rows 7..8 keep the window switch of row 8; its plain version
# took 89 s of the script at 16 rows, 48-58 s at 8 and 18-24 s at 4 (every tree
# from the initial state is a deep one), and the script has five minutes for
# nine paths
CHECK_K2_ARGS_ROWS = (7, 9)
# K2, K2-ld and the mid-d kernel without data: rows 2..9, with the switch of
# row 8 (K2's check on rows 2..17 took 5.1 s of plain version)
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
# 49-96 s with the host's speed): a third of the warmup, two posterior
# launches
BIG_TUNE, BIG_DRAWS = 100, 256
BIG_CHECK_CHAINS = 64  # of the K1-stream check (its plain version's time)
BIG_REFERENCE = GLM_REFERENCE.with_name("logreg_big_reference.json")
# the stochastic-volatility path (the JAX package's flagship realistic model,
# examples/stochastic_volatility.py): T = 1000 returns, d = 1002, above the
# chains-on-lanes limit, so the dim-on-lanes kernels with data
SV_T, SV_CHAINS, SV_TUNE, SV_DRAWS = 1000, 512, 400, 300
SV_REFERENCE = GLM_REFERENCE.with_name("sv_t1000_reference.json")
SV_STEP = (0.04, 0.06)  # near the reference's adapted step (made-up states)
# the detector's SV run stops here (a pause): the first chunk end past
# draw 100, where a chain frozen from its start is named (draw 130)
SV_DETECTOR_DRAWS = 130
# radon at the JAX model's sizes: 85 groups of 12 rows, d = 89
RADON_CHAINS, RADON_TUNE, RADON_DRAWS = 1024, 300, 400
RADON_REFERENCE = GLM_REFERENCE.with_name("radon_reference.json")
RADON_STEP = (0.4, 0.55)
# a path's divergence share may exceed its reference's by this much and two
# standard errors of the reference's share over its chains (SV's 64 chains:
# 0.0023, more than the 0.002 alone; PERF.md)
DIV_SHARE_TOL = 0.002
# the flow path: funnel(10) under FlowNutsSettings with the default coupling
# flow (4 layers of 32), the JAX package's flow benchmark (BASELINE.md
# "config 3", 256 chains, 600 + 600 draws; profile_main_path.py --only-flow
# runs it whole).  Cut here for the script's five minutes: the warmup runs
# on the per-draw sync engine, whose draws wait for the deepest of the
# chains' trees (1.7-7.8 s a draw at 256 chains before the flow fits), so
# 64 chains and 30 tuning draws (refits at draws 10 and 20), and 512
# posterior draws (4 launches of K1-flow, about a second)
FLOW_DIM, FLOW_FULL_CHAINS, FLOW_FULL_TUNE, FLOW_FULL_DRAWS = 10, 256, 600, 600
FLOW_CHAINS, FLOW_TUNE, FLOW_DRAWS = 64, 30, 512
FLOW_REFERENCE = GLM_REFERENCE.with_name("flow_funnel_reference.json")
# K1-flow's today's form (d > 32): funnel(40) through the default flow, 8
# chains, 5 tuning draws on the sync engine (without them 3 of the 8 chains
# stayed at their start for all 128 draws; with 3 every chain moved on the
# plain version on a CPU), one 128-draw launch; its check
# launch 8 chains, one draw (trees to depth 7-8: 15.4 s of plain version at
# two draws)
FLOW_TODAY_DIM, FLOW_TODAY_CHAINS, FLOW_TODAY_K = 40, 8, 1
FLOW_TODAY_TUNE = 5
# the check and timed launches' inputs, under which the trees grow (depth up
# to 9 on the plain version; a flow moved N(0, 0.2^2) with steps U(0.2, 0.4)
# made every draw diverge at its first leapfrog): a flow moved N(0, 0.05^2)
# off the identity, z = 0.8 N(0, 1), steps U(0.05, 0.1)
FLOW_TODAY_SCALE, FLOW_TODAY_STEP = 0.05, (0.05, 0.1)
# the gates of PERF.md (section 2), on v and on every u_i = x_i e^(-v/2):
# a mean within max(0.1, 3 sqrt(1 + 1 / R) s) posterior std of the average
# of the JAX engine's R runs at seeds 0 .. R - 1, and a std within
# max(10%, 3 sqrt(1 + 1 / R) s'), s and s' the run-to-run standard
# deviations of those runs (a run here is one more such run; the average
# of R has s / sqrt(R) of error)
FLOW_MEAN_TOL, FLOW_STD_TOL, FLOW_SPREAD_FACTOR = 0.1, 0.1, 3.0
# the zoo's kernel checks: short launches, two warmup rows (7 and 8, with the
# window switch of row 8), to keep the script's time
ZOO_CHECK_CHAINS, ZOO_CHECK_ROWS = 64, (7, 9)
# the hook models without a path of their own of the JAX benchmark, driven
# through Sampler.run at the sizes of the JAX package's tests
ZOO_CHAINS, ZOO_TUNE, ZOO_DRAWS = 256, 200, 200
ZOO_MEAN_TOL, ZOO_STD_TOL = 0.1, 0.1  # against their analytic moments
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
# the sync MCLMC path: the MCLMC main configuration on the sync MCLMC engine
# (DiagMclmcSettings' default posterior_kernel="sync") with four extra
# stores; its gates are the MCLMC path's (the std is the JAX package's sync
# engine's at exactly these settings) and the stores'
MSYNC_STORES = dict(store_gradient=True, store_unconstrained=True,
                    store_divergences=True, store_mass_matrix=True)
MSYNC_GRAD_TOL = 1e-5  # stored gradient against -(q - 3), absolute
# the mixed MCLMC plan: d = 400 lies between the fused MCLMC warmup's limit
# (361) and the posterior's (484), so the sync warmup, then K3's mid form;
# the JAX benchmark's normal_d1000 chain and draw counts; held against the
# JAX sync engine at the same settings (tests/data/
# make_mclmc_sync_reference.py) as the other references are
M400_DIM, M400_CHAINS, M400_TUNE, M400_DRAWS = 400, 512, 200, 300
M400_REFERENCE = GLM_REFERENCE.with_name("mclmc_normal_d400_reference.json")
M400_CHECK_DRAWS = 2
# the exact-normal path: NUTS with the exact-normal kinetic energy, demoted
# from "pallas" to the sync NUTS engine; the main path's chains and d, its
# draws cut from 300 + 700 (the sync engine is host-bound).  NUTS is exact,
# so the analytic moments hold; the acceptance is the JAX sync engine's at
# these settings, near 1 (the integrator is exact for the adapted standard
# normal, so dual averaging grows the step until the rotation wraps)
EXACT_TUNE, EXACT_DRAWS = 100, 300
EXACT_MIN_ACCEPT = 0.99
EXACT_TICK = 16  # its run's progress_tick: in-chunk progress every 16 draws
# the float64 path: the NUTS and MCLMC main configurations at
# dtype=float64 with posterior_kernel="pallas", on K1 / K2 and K3 / K4 as
# in the JAX package (each launch takes float32 copies of the state); the
# trace's dtypes are the JAX run's at the same settings on the CPU under
# x64 (tests/test_torch_aliases_dtype.py holds the port's to them): NUTS's
# float64 warmup chunks join its float32 posterior chunks into float64
# groups, MCLMC hands float32 throughout
F64_FLOAT = {"nuts": np.float64, "mclmc": np.float32}
# the low-rank path: BASELINE config 2 (BASELINE.md:41,335-337, a 100-d
# correlated Gaussian exercising low-rank mass-matrix adaptation, 64
# chains), correlated_normal_rank1(100): covariance 1.5 (I + 999 u u^T);
# LowRankNutsSettings' 800 tuning draws, whose refits need them, and the
# posterior cut from 1000 draws for the script's time
LR_DIM, LR_CHAINS, LR_TUNE, LR_DRAWS, LR_FULL_DRAWS = 100, 64, 800, 200, 1000
LR_SCALE, LR_EIG = 1.5, 1000.0
# at float32, the port's default, the refits fail until a window holds about
# 300 draws, and a few of those that take are hundreds of per cent off the
# float64 refit of the same window, in the JAX package's code as in the
# port's (tests/data/low_rank_float32_witness.py): a chain that takes one
# can have its step collapse in the divergences that follow, its trees then
# at maxdepth 10.  A chain is collapsed where its posterior step is below
# LR_COLLAPSED_STEP; at most LR_MAX_COLLAPSED of the 64 may be (none in the
# JAX package's float32 runs on the CPU at seeds 0-2 nor in the port's with
# the refits' eigendecompositions on the host's LAPACK; 1-6 where the card's
# own float32 solver decomposed them, PERF.md section 7), and the moment
# gates hold the others.  low_rank64 (``--only low_rank64``, not in a whole
# run, for its time) runs the preset at float64, the JAX package's dtype
# under x64, where every refit takes and no chain may collapse.
LR_COLLAPSED_STEP = 1e-6
LR_MAX_COLLAPSED = 2
LR_MEAN_TOL, LR_STD_TOL, LR_VAR_U_TOL = 0.1, 0.1, 0.1
LR_MAX_DIV_SHARE = 0.01
# the low-rank oracle (nuts-rs tests/sample_normal.rs:320-356, the JAX twin
# tests/test_low_rank.py:122-140): correlated_normal(10, 0.5), 1 chain,
# 500 + 100 draws at float64, the whole spectrum kept; the adapted
# transform whitens the target exactly
LRX_DIM, LRX_TUNE, LRX_DRAWS, LRX_CUTOFF, LRX_SEED = 10, 500, 100, 1.00001, 42
LRX_FISHER = 1e-10
# the cross-chain path: the NUTS main configuration's model and chains on
# the sync engine with pooled adaptation, draws cut from 300 + 700 (the
# sync engine takes about 28.5 ms a draw there)
XC_TUNE, XC_DRAWS = 100, 200
XC_JITTER = 0.1  # StepSizeSettings' default: each chain's own step jitter
# the transfer knobs' run of the NUTS d = 10 path
KNOBS = dict(keep_stats=("mean_tree_accept",), draw_dtype=np.float16,
             stats_dtype=np.float16, store_warmup=False)
ALWAYS_KEPT = {"position", "diverging", "n_steps", "step_size"}
# Kernels and plain versions round alike (-fmad=false, sums in coordinate
# order, IEEE division), so every integer stat of every (chain, draw) must
# agree and every float is compared, on all chains, within RTOL / ATOL.
RTOL = 1e-4
ATOL = 1e-5
# a 128-draw launch this long or longer is timed over one call after the
# first, a shorter one over three (their spread is a few per cent at most)
LONG_LAUNCH_MS = 50.0
# The build beside the paths: its nvcc at this priority (nice -n), as many
# at a time as the host has cores less BUILD_SPARE_CORES (for the paths' own
# host work: the main process, the two beside it and the pipeline path's two
# children), in the order the paths need them
BUILD_NICE = 10
BUILD_SPARE_CORES = 4
# the processes beside the paths run at this priority: the main process's
# flow path, host-bound too, is the run's critical path
BESIDE_NICE = 5


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
    """FP32 operations of one evaluation beyond FLOP_PER_COORD's, counted
    from the functor (csrc/models.cuh), each exp, log and sqrt as one: the
    regression's two products and its elementwise pass over rows and columns,
    as the JAX benchmark counts them (bench.py:271-278); radon's 9 a row
    (residual 3, u, e, three sums 4) and 6 a group; SV's 33 a coordinate
    (the two scans 4, h 2, exp 1, z 1, w 2, log1p 5, the term 4, b 3, a 1,
    the summed products 3, the four sums 4, the gradient 3); the rank-1
    normal's 12, the funnel's and correlated_normal's 5 a coordinate."""
    name, _, tensors = model.hook_parts()
    d = model.dim
    if name == "logistic_regression":
        n = tensors[0].shape[1]
        return 4 * n * d + 4 * (n + d)
    if name == "radon":
        return 9 * tensors[0].shape[0] + 6 * (d - 4)
    return {"stochastic_volatility": 33, "correlated_normal_rank1": 12,
            "funnel": 5, "correlated_normal": 5}.get(name, 0) * d


def hook_bytes(model):
    """Bytes of the functor's data as the kernels read them (radon's group
    index, not the JAX model's one-hot matrix that ``data_bytes`` counts
    for the size rules)."""
    return sum(t.numel() * t.element_size() for t in model.hook_parts()[2])


def bound(kind, model, inputs, out, stats):
    """(bound_ms, bound_by) of one launch from its inputs and results; a
    model's data count among the bytes, read once per launch."""
    grads = float(stats["n_steps"].sum())
    t_ops = grads * (model.dim * FLOP_PER_COORD[kind]
                     + model_flop_per_grad(model)) / FP32_FLOP_PER_S
    t_bytes = (tensor_bytes(inputs, out) + hook_bytes(model)) / HBM_BYTES_PER_S
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


# seconds spent in the checks' plain versions (timed_pair), read by main
# for each path
PLAIN_SECONDS = [0.0]


def timed_pair(kernel, plain, repeats=3):
    """Run a kernel and its plain version on the same inputs: (kernel's
    result, plain result, kernel ms per call over ``repeats`` calls, plain
    ms of its one call)."""
    out_k = kernel()
    torch.cuda.synchronize()
    ms = cuda_events_ms(kernel, repeats)
    box = []
    plain_ms = cuda_events_ms(lambda: box.append(plain()), 1)
    PLAIN_SECONDS[0] += plain_ms / 1e3
    return out_k, box[0], ms, plain_ms


def chunk_time(kind, model, fn, inputs, stats_at, grow=None):
    """A kernel alone at its path's 128-draw launch: (ms over 3 calls after
    a first one, or over one where the first took LONG_LAUNCH_MS or more,
    bound_ms, bound_by).  With ``grow`` (the launch's name) the first
    call's trees must grow (``require_growing_trees``)."""
    box = []
    first_ms = cuda_events_ms(lambda: box.append(fn()), 1)
    out = box[0]
    if grow:
        require_growing_trees(out[stats_at], grow)
    ms = cuda_events_ms(fn, 1 if first_ms >= LONG_LAUNCH_MS else 3)
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


def nuts_lanes(name, model, block):
    """`` T=n``, the lanes of a chain in K1 / K2 (``_build.nuts_lanes``) at
    the check's block, for the checks of those two."""
    from nuts_rs_tpu_torch.kernels import _build
    from nuts_rs_tpu_torch.kernels import nuts_fused as nf

    if name not in GROWING_CHECKS:
        return ""
    return f" T={_build.nuts_lanes(model.dim, block or nf.DEFAULT_BLOCK)}"


def tree_summary(stats):
    """The deepest tree and the divergent share of a launch's draws, for a
    check's line."""
    return (f"depth up to {int(stats['depth'].max())}, "
            f"{float(stats['diverging'].float().mean()):.1%} of draws "
            "divergent")


# the checks of the chains-on-lanes NUTS kernels, whose plain versions' trees
# must grow before the comparison (require_growing_trees)
GROWING_CHECKS = ("K1", "K2")


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
                    stream=False, draws=CHECK_K1_DRAWS):
    """K1 (cl), K1-ld or, with ``name`` and maybe its own inputs ``args``
    and logical chain block, the mid-d cl kernel or (``stream``) the
    streamed one against its plain version, over ``draws`` draws."""
    from nuts_rs_tpu_torch.kernels import nuts_fused as nf

    name = name or ("K1-ld" if layout == "ld" else "K1")
    if args is None:
        args = posterior_inputs(model, device, chains=chains, step=step)
    out_k, out_p, ms, plain_ms = timed_pair(
        lambda: nf.nuts_fused_run(7, *args, draws, model, opts, 0.1, block,
                                  layout, stream),
        lambda: nf.nuts_fused_run_reference(7, *args, draws, model, opts, 0.1,
                                            block, layout, stream))
    if name in GROWING_CHECKS:
        require_growing_trees(out_p[4], f"{name} check")
    n, err = compare(name, out_k, out_p, ("q_f", "g_f", "logp_f"),
                     nf.STAT_NAMES, INT_STATS)
    blocks = len(set(out_k[4]["loop_iterations"].cpu().tolist()))
    chains = args[0].shape[0]
    print(f"{name} check: C={chains} d={model.dim} K={draws}"
          f"{nuts_lanes(name, model, block)}: integer stats equal on all "
          f"{n} (chain, draw) entries, max abs "
          f"err {err:.3g} (draws, final state, all stats); {blocks} distinct "
          f"block iteration counts; {tree_summary(out_p[4])}; kernel "
          f"{ms:.4f} ms, plain {plain_ms:.2f} ms")
    return check_row("nuts", model, args, out_k, err, ms, plain_ms)


def warmup_setup(model, settings, device, lo, hi, chains=CHAINS, state=None):
    """A warmup launch's inputs for schedule rows lo..hi-1: from the initial
    state of ``chains`` chains, or from ``state``, a post-warmup-like one as
    ``posterior_inputs`` returns it, whose estimators hold its own point
    once and whose dual averaging starts at its step."""
    from nuts_rs_tpu_torch.adapt.schedule import build_schedule
    from nuts_rs_tpu_torch.chain import (
        DiagStrategy, init_chain_state, pack_warmup_state, warmup_flags)
    from nuts_rs_tpu_torch.kernels import nuts_fused as nf
    from nuts_rs_tpu_torch.sampler import _schedule_chunk

    config = settings.chain_config()
    sched = build_schedule(settings.num_tune, settings.num_draws,
                           settings.adapt)
    flags = warmup_flags(_schedule_chunk(sched, lo, hi), device)
    tail = (model, config.nuts, config.step_size,
            config.use_grad_based_estimate)
    if state is not None:
        q, g, logp, stds, mean, logdet, step, _ = state
        est = torch.zeros(q.shape[0], 8, q.shape[1], device=device)
        est[:, 0], est[:, 2], est[:, 4], est[:, 6] = q, g, q, g
        sca = torch.zeros(q.shape[0], nf.NSCA, device=device)
        sca[:, nf.SCA_STEP] = step
        sca[:, nf.SCA_DA_LS] = sca[:, nf.SCA_DA_LSA] = torch.log(step)
        sca[:, nf.SCA_DA_MU] = torch.log(10.0 * step)
        sca[:, nf.SCA_DA_CNT] = 1.0
        sca[:, nf.SCA_CNT_FG] = sca[:, nf.SCA_CNT_BG] = 1.0
        sca[:, nf.SCA_LOGDET] = logdet
        return (11, flags, q, g, logp, stds, mean, est, sca, *tail)
    state = init_chain_state(SEED, model, DiagStrategy(config), config,
                             chains, torch.float32, device)
    est, sca = pack_warmup_state(state)
    t = state.transform
    return (11, flags, state.pt.q, state.pt.g, state.pt.logp,
            t.stds.contiguous(), t.mean.contiguous(), est, sca, *tail)


def check_warmup(model, settings, device, layout="cl", chains=CHAINS,
                 name=None, block=None, rows=CHECK_K2_SHORT_ROWS,
                 state=None, repeats=3):
    """K2 (cl), K2-ld or, with ``name`` and maybe a logical chain block, the
    mid-d cl kernel or K2-ld-args against its plain version, on schedule
    rows ``rows[0] .. rows[1] - 1`` from the initial state or from
    ``state`` (see ``warmup_setup``); the kernel timed over ``repeats``
    calls after a first."""
    from nuts_rs_tpu_torch.kernels import nuts_fused as nf

    name = name or ("K2-ld" if layout == "ld" else "K2")
    # schedule rows 2.. are the second warmup phase's: estimator updates,
    # mass-matrix updates every draw and the first window switch (row 8)
    lo, hi = rows
    draws = hi - lo
    args = warmup_setup(model, settings, device, lo, hi, chains, state)
    if not args[1][:, nf.FLAG_DO_SWITCH].any():
        raise AssertionError(f"{name} check rows hold no window switch")
    out_k, out_p, ms, plain_ms = timed_pair(
        lambda: nf.nuts_fused_warmup_run(*args, block, layout),
        lambda: nf.nuts_fused_warmup_run_reference(*args, block, layout),
        repeats)
    if name in GROWING_CHECKS:
        require_growing_trees(out_p[8], f"{name} check")
    n, err = compare(name, out_k, out_p,
                     ("q", "g", "logp", "stds", "mean", "est", "sca"),
                     nf.WARMUP_STAT_NAMES, INT_STATS)
    chains = args[2].shape[0]
    print(f"{name} check: C={chains} d={model.dim} K={draws}"
          f"{nuts_lanes(name, model, block)} (schedule rows {lo}..{hi - 1}, "
          "a window switch among them, from "
          f"{'a post-warmup-like' if state else 'the initial'} state): "
          f"integer stats equal on all {n} (chain, draw) entries, "
          f"max abs err {err:.3g} (draws, final state, est, sca, all "
          f"stats); {tree_summary(out_p[8])}; kernel {ms:.4f} ms ({repeats} "
          f"calls), plain {plain_ms:.2f} ms")
    return check_row("nuts", model, args[1:9], out_k, err, ms, plain_ms)


def zero_launch_counts():
    from nuts_rs_tpu_torch.kernels import _build
    from nuts_rs_tpu_torch.kernels import mclmc_fused as mf
    from nuts_rs_tpu_torch.kernels import nuts_fused as nf

    for counts in (nf.LAUNCHES, mf.LAUNCHES, _build.MODEL_LAUNCHES,
                   _build.FLOW_FORM_LAUNCHES,
                   _build.MCLMC_BLOCK_FORM_LAUNCHES):
        for name in counts:
            counts[name] = 0


def read_launch_counts(counts, names):
    """The path's own counts, after it ran; each must be at least 1."""
    launches = {name: counts[name] for name in names}
    for name, n in launches.items():
        if n < 1:
            raise AssertionError(f"the main path never launched {name}")
    return launches


def run_sampler(model, settings, device, starts=None, samplers=None,
                rate_seconds=None, **knobs):
    """Sampler.run with its seconds: set-up, warmup, posterior and the
    whole; ``starts``, a list, receives the chains' initial positions,
    ``samplers`` the sampler; ``rate_seconds`` sets its
    ``progress_rate_seconds``; ``knobs`` are the Sampler's other keyword
    arguments (the transfer knobs, the control surface's)."""
    from nuts_rs_tpu_torch import Sampler

    t0 = time.monotonic()
    sampler = Sampler(model, settings, device=device, **knobs)
    if rate_seconds is not None:
        sampler.progress_rate_seconds = rate_seconds
    init_s = time.monotonic() - t0
    if starts is not None:
        starts.append(sampler.state.pt.q.cpu().numpy())
    if samplers is not None:
        samplers.append(sampler)
    trace = sampler.run()
    total_s = time.monotonic() - t0
    tune = settings.num_tune
    warm_s = sum(s for lo, hi, s in sampler.chunk_seconds if lo < tune)
    post_s = sum(s for lo, hi, s in sampler.chunk_seconds if lo >= tune)
    return trace, init_s, warm_s, post_s, total_s


def main_path(model, settings, device, kernels, what="main path",
              traces=None):
    """One NUTS path through Sampler.run with its gates; ``kernels`` names
    the launch counters it must move; ``traces``, a list, receives the
    trace."""
    from nuts_rs_tpu_torch.kernels import nuts_fused as nf

    zero_launch_counts()
    trace, init_s, warm_s, post_s, total_s = run_sampler(model, settings,
                                                         device)
    if traces is not None:
        traces.append(trace)
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
                 step=(0.8, 1.0), k1=None, k2_state=None, warmup=True):
    """Each NUTS kernel alone at its path's launch: ``chains`` chains, one
    128-draw chunk (``k1``: the posterior kernel's own inputs; ``k2_state``:
    a post-warmup-like state for the warmup kernel, else the initial one;
    without ``warmup`` the posterior kernel alone)."""
    from nuts_rs_tpu_torch.kernels import nuts_fused as nf

    opts = settings.nuts_options()
    if k1 is None:
        k1 = posterior_inputs(model, device, seed=2, chains=chains, step=step)
    kind = nf._kernel_kind(model, model.dim, layout, opts.maxdepth)
    suffix = "" if kind == "thread" else "_" + kind
    # K1 and K2's timed launches must grow trees
    grow = kind == "thread"
    times = {
        f"nuts_fused{suffix}_posterior": chunk_time(
            "nuts", model,
            lambda: nf.nuts_fused_run(3, *k1, CHUNK, model, opts, 0.1,
                                      layout=layout), k1, 4,
            grow and "K1 timed launch")}
    if warmup:
        k2 = warmup_setup(model, settings, device, 2, 2 + CHUNK, chains,
                          k2_state)
        times[f"nuts_fused{suffix}_warmup"] = chunk_time(
            "nuts", model,
            lambda: nf.nuts_fused_warmup_run(*k2, layout=layout), k2[1:9], 8,
            grow and "K2 timed launch")
    for name, (ms, b_ms, b_by) in times.items():
        print(f"time {name}: {ms:.4f} ms per {CHUNK}-draw launch at "
              f"C={chains} d={model.dim}; bound {b_ms:.5f} ms ({b_by})")
    return times


@contextlib.contextmanager
def first_launches(seen):
    """Keep a path's first posterior launch and its first full warmup launch
    of CHUNK rows in ``seen`` ("post", "warm": the function and its
    arguments), to be timed again on the path's own states."""
    from nuts_rs_tpu_torch.kernels import nuts_fused as nf

    run0, warm0 = nf.nuts_fused_run, nf.nuts_fused_warmup_run

    def run(*a, **k):
        seen.setdefault("post", (run0, a, k))
        return run0(*a, **k)

    def warm(*a, **k):
        if a[1].shape[0] == CHUNK:
            seen.setdefault("warm", (warm0, a, k))
        return warm0(*a, **k)

    nf.nuts_fused_run, nf.nuts_fused_warmup_run = run, warm
    try:
        yield seen
    finally:
        nf.nuts_fused_run, nf.nuts_fused_warmup_run = run0, warm0


def time_own_launches(model, seen, names, made, what):
    """The kept launches (``first_launches``) timed again on the path's own
    states, for the posterior and the warmup kernel ``names``, printed
    beside ``made`` (time_kernels' times on made-up states) with the mid-d
    kernels' chains a CUDA block or the ld_args kernels' blocks an SM;
    returns {name: (ms, bound_ms, bound_by)}."""
    from nuts_rs_tpu_torch.kernels import _build

    own = {}
    for key, name, at in (("post", names[0], 4), ("warm", names[1], 8)):
        fn, a, k = seen[key]
        own[name] = ms, b_ms, b_by = chunk_time(
            "nuts", model, lambda fn=fn, a=a, k=k: fn(*a, **k), a[1:9], at)
        kind = name.rsplit("_", 1)[-1]
        D = a[11 if key == "post" else 10].maxdepth
        chains = a[1 if key == "post" else 2].shape[0]
        if "_mid_" in name:
            G = _build.mid_launch_group(kind, model.dim, D, model, chains, 1,
                                        _build.sm_count(a[1].device))
            where = (f"G = {G} chains a CUDA block, "
                     f"{_build.mid_blocks_per_sm(kind, model, D, G)} blocks "
                     "an SM")
        else:
            where = (f"{_build.ld_args_blocks_per_sm(kind, model, D)} chain "
                     "blocks an SM")
        print(f"time {name} ({what}) on the path's own states: {ms:.4f} ms "
              f"per {CHUNK}-draw launch at C={chains} d={model.dim} ({where}"
              f"; made-up states {made[name][0]:.4f} ms); bound {b_ms:.5f} "
              f"ms ({b_by})")
    return own


# ---------------------------------------------------------------------------
# The data-carrying path: kernels K1-args and K2-args on logistic regression
# ---------------------------------------------------------------------------


def glm_reference(path=GLM_REFERENCE):
    """The JAX package's posterior moments of the regression (the file names
    the command that made it)."""
    ref = json.loads(path.read_text())
    return np.array(ref["mean"]), np.array(ref["std"]), ref


def glm_posterior_inputs(model, device, ref_mean, ref_std, seed=1,
                         chains=GLM_CHAINS, step=(0.4, 0.55)):
    """A post-warmup-like state, made with numpy around a posterior's
    marginals (a reference's, or the analytic ones): positions drawn from
    them, the transform near their scales, steps drawn from ``step`` (by
    default near the regression's adapted one)."""
    rng = np.random.default_rng(seed)
    f = lambda x: torch.as_tensor(x, dtype=torch.float32, device=device)  # noqa: E731
    dim = model.dim
    q = f(ref_mean + ref_std * rng.normal(size=(chains, dim)))
    stds = f(ref_std * rng.uniform(0.8, 1.2, size=(chains, dim)))
    mean = f(ref_mean + 0.1 * ref_std * rng.normal(size=(chains, dim)))
    logp, g = model.logp_and_grad(q)
    logdet = -torch.log(stds).sum(1)
    step = f(rng.uniform(*step, size=chains))
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
                           "nuts_fused_mid_warmup"), what="data path",
                  samplers=None):
    """A regression's NUTS path through Sampler.run, held against the JAX
    package's posterior; ``kernels`` names the launch counters it must move
    (every other fused NUTS kernel must stay at 0); ``samplers``, a list,
    receives the sampler.  Returns (launches, warmup seconds)."""
    from nuts_rs_tpu_torch.kernels import nuts_fused as nf

    zero_launch_counts()
    trace, init_s, warm_s, post_s, total_s = run_sampler(
        model, settings, device, samplers=samplers)
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


def lanes(model, B):
    """`` T=n``, the lanes of a chain in K3 / K4 (``_build.mclmc_lanes``),
    where the model takes them."""
    from nuts_rs_tpu_torch.kernels import _build
    from nuts_rs_tpu_torch.kernels import nuts_fused as nf

    if nf.cl_kernel(model, model.dim) != "thread":
        return ""
    return f" T={_build.mclmc_lanes(model.dim, B)}"


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
    print(f"{name} check: C={chains} d={model.dim} B={B}{lanes(model, B)} "
          f"K={CHECK_K3_DRAWS} "
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
                       micro_state=None, euclid_state=None, euclid_row=None):
    """K4 or, with ``name`` and maybe a logical chain block, the mid-d MCLMC
    warmup kernel, on schedule rows that hold a momentum resample, a window
    switch and mass-matrix updates: from draw 0 with the Euclidean kinetic
    energy, and across the trajectory switch with the microcanonical one
    (each from the initial state, or from ``euclid_state`` /
    ``micro_state``, see ``mclmc_warmup_setup``).  The row's times and bound
    are those of the microcanonical rows; with ``euclid_row`` (a dict) the
    Euclidean rows' own check row goes there too."""
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
        if kind is Kind.EUCLIDEAN and euclid_row is not None:
            euclid_row.update(check_row("mclmc", model, args[1:10], out_k,
                                        err_i, ms, plain_ms))
        rows.append(f"{lo}..{hi - 1} {kind.value}" + (
            " from a post-warmup-like state" if state is not None else ""))
    chains = settings.num_chains
    B = nf._check_block(chains, block, nf.cl_kernel(model, model.dim))
    print(f"{name} check: C={chains} d={model.dim} B={B}{lanes(model, B)} "
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
    # K3-args and K4-args: the regression's microcanonical draws in their
    # group form (the path's posterior and microcanonical warmup launches),
    # every other launch of theirs in mclmc_fused_mid_*.cu
    # (_build.MCLMC_MID_FORMS, the block form; its rows below); one count
    # for both forms
    ("mclmc_fused_mid_posterior", "mclmc_fused_group_posterior.cu",
     "nuts_rs_tpu/kernels/mclmc_pallas.py:61"),
    ("mclmc_fused_mid_warmup", "mclmc_fused_group_warmup.cu",
     "nuts_rs_tpu/kernels/mclmc_pallas.py:506"),
    ("nuts_fused_stream_posterior", "nuts_fused_stream_posterior.cu",
     "nuts_rs_tpu/kernels/nuts_pallas.py:217"),
    ("nuts_fused_ld_args_posterior", "nuts_fused_ld_args_posterior.cu",
     "nuts_rs_tpu/kernels/nuts_pallas.py:124"),
    ("nuts_fused_ld_args_warmup", "nuts_fused_ld_args_warmup.cu",
     "nuts_rs_tpu/kernels/nuts_pallas.py:959"),
    # the model hooks: device functors in csrc/models.cuh, in the kernels'
    # bodies as the JAX models' logp is in the Pallas bodies
    ("stochastic_volatility", "models.cuh",
     "nuts_rs_tpu/models/stochastic_volatility.py:59"),
    ("radon", "models.cuh", "nuts_rs_tpu/models/hierarchical.py:99"),
    ("correlated_normal_rank1", "models.cuh",
     "nuts_rs_tpu/models/gaussian.py:66"),
    ("funnel", "models.cuh", "nuts_rs_tpu/models/gaussian.py:107"),
    ("correlated_normal", "models.cuh", "nuts_rs_tpu/models/gaussian.py:96"),
    # K1 through a frozen coupling flow (make_kernel's flow= branch), the
    # flow's passes on one warp (the flow path), and in today's form
    ("nuts_fused_flow_posterior", "nuts_fused_flow_warp_posterior.cu",
     "nuts_rs_tpu/kernels/nuts_pallas.py:202"),
    ("nuts_fused_flow_posterior_today", "nuts_fused_flow_posterior.cu",
     "nuts_rs_tpu/kernels/nuts_pallas.py:202"),
    # K3's mid form in its block form (a model without data), on the d = 400
    # MCLMC path's posterior after the sync warmup; its launches are the
    # mid posterior count of that path
    ("mclmc_fused_mid_block_posterior", "mclmc_fused_mid_posterior.cu",
     "nuts_rs_tpu/kernels/mclmc_pallas.py:61"),
    # K4-args in its block form (the pair form: one chain on two CUDA
    # blocks, the regression's rows in their shared memory), the MCLMC data
    # path's Euclidean launch; its launches are that path's block-form
    # warmup launches
    ("mclmc_fused_mid_block_warmup", "mclmc_fused_mid_warmup.cu",
     "nuts_rs_tpu/kernels/mclmc_pallas.py:506"),
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
    traces = []
    launches.update(main_path(model, settings, device,
                              ("nuts_fused_posterior", "nuts_fused_warmup"),
                              traces=traces))
    MAIN_TRACE["nuts"] = (settings, traces[0])
    knob_run(model, settings, device, traces[0])
    times.update(time_kernels(model, settings, device))


def knob_run(model, settings, device, full):
    """The NUTS d = 10 path once more with the transfer knobs (``KNOBS``):
    no warmup group, exactly the kept and the always-kept stats at their
    dtypes, and the positions the first run's ``full`` cast to float16, bit
    for bit (same seed, same kernels)."""
    trace, init_s, warm_s, post_s, total_s = run_sampler(model, settings,
                                                         device, **KNOBS)
    for group in ("warmup_posterior", "warmup_sample_stats"):
        held = {k: v.shape for k, v in getattr(trace, group).items()
                if v.shape[1]}
        if held:
            raise AssertionError(f"store_warmup=False stored {group}: {held}")
    names = set(trace.sample_stats) | set(trace.posterior)
    want = ALWAYS_KEPT | set(KNOBS["keep_stats"])
    if names != want:
        raise AssertionError(f"keep_stats: stored {sorted(names)}, expected "
                             f"{sorted(want)}")
    pos = trace.posterior["position"]
    if pos.dtype != np.float16 or trace.sample_stats[
            "mean_tree_accept"].dtype != np.float16:
        raise AssertionError("draw_dtype / stats_dtype: positions "
                             f"{pos.dtype}, mean_tree_accept "
                             f"{trace.sample_stats['mean_tree_accept'].dtype}")
    if trace.sample_stats["n_steps"].dtype != np.int32:
        raise AssertionError("stats_dtype cast an integer stat")
    cast = full.posterior["position"].astype(np.float16)
    if not np.array_equal(pos.view(np.uint16), cast.view(np.uint16)):
        bad = int((pos.view(np.uint16) != cast.view(np.uint16)).sum())
        raise AssertionError(f"draw_dtype: {bad} positions differ from the "
                             "first run's cast to float16")
    knobs = ", ".join(f"{k}={np.dtype(v).name if 'dtype' in k else v!r}"
                      for k, v in KNOBS.items())
    print(f"transfer knobs ({knobs}): warmup {warm_s:.3f} s, posterior "
          f"{post_s:.3f} s, total with trace assembly {total_s:.3f} s; no "
          f"warmup group, stats "
          f"{sorted(names)}, positions float16 equal to the first run's cast "
          f"on all {pos.size}")


# the NUTS d = 10 path's uninterrupted run, which the control path reuses
# (``--only control`` runs its own)
MAIN_TRACE = {}
# the control path's checkpoint: the first chunk boundary at or after this
# draw (a posterior launch, so the restored sampler's first launch draws a
# freshly jittered step)
CONTROL_CHECKPOINT_AT = 428
CONTROL_CPU_DRAWS = 2  # the CPU sampler's draws from the card's checkpoint
CONTROL_STOP = dict(rhat_max=1.01, min_ess_bulk=400.0)


def same_trace(got, want, what, first=0, end=None):
    """Every group of ``got`` equal, bit for bit, to ``want``'s draws from
    global draw ``first`` to ``end`` (``got`` holds those draws)."""
    tune = want.warmup_posterior["position"].shape[1]
    for group in ("posterior", "sample_stats", "warmup_posterior",
                  "warmup_sample_stats"):
        start = 0 if group.startswith("warmup") else tune
        cut = max(0, first - start)
        stop = None if end is None else max(0, end - start)
        a, b = getattr(got, group), getattr(want, group)
        if set(a) != set(b):
            raise AssertionError(f"{what}: {group} holds {sorted(a)}, the "
                                 f"uninterrupted run {sorted(b)}")
        for name, v in b.items():
            if not np.array_equal(a[name], v[:, cut:stop], equal_nan=True):
                raise AssertionError(f"{what}: {group}/{name} differs from "
                                     "the uninterrupted run's")


def progress_gates(sampler, trace, what):
    """Every chain's final ChainProgress against the trace: all draws
    finished, its divergences the posterior's, its leapfrogs all of them."""
    total = sampler.settings.num_tune + sampler.settings.num_draws
    div = trace.sample_stats["diverging"].sum(1)
    steps = (trace.warmup_sample_stats["n_steps"].sum(1, dtype=np.int64)
             + trace.sample_stats["n_steps"].sum(1, dtype=np.int64))
    for c, p in enumerate(sampler.progress):
        if (p.finished_draws != total or p.divergences != int(div[c])
                or p.total_num_steps != int(steps[c]) or p.failed):
            raise AssertionError(
                f"{what}: chain {c}'s progress {p.finished_draws} draws, "
                f"{p.divergences} divergences, {p.total_num_steps} "
                f"leapfrogs, failed {p.failed}; the trace {total}, "
                f"{int(div[c])}, {int(steps[c])}")


def draw_index(positions, first_draw):
    """expand_host_fn of the control path: each draw's global index."""
    C, k = positions.shape[:2]
    return {"draw_index": np.broadcast_to(
        first_draw + np.arange(k, dtype=np.int64), (C, k)).copy()}


def path_control(device, checks, launches, times):
    """The Sampler's control surface on the main path's configuration (NUTS
    d = 10, 1024 chains, 300 + 700 draws, K1 and K2): checkpoint and
    restore on the card bit for bit and across to the CPU, wait_timeout,
    pause from a progress callback and resume, ChainProgress, a
    ConvergenceStop and the expansions under float16 draws."""
    import dataclasses
    import tempfile

    from nuts_rs_tpu_torch import ConvergenceStop, DiagNutsSettings, Sampler
    from nuts_rs_tpu_torch.checkpoint import state_leaves
    from nuts_rs_tpu_torch.kernels import nuts_fused as nf
    from nuts_rs_tpu_torch.models.gaussian import normal_logp

    model = normal_logp(DIM, MU)
    settings = DiagNutsSettings(num_chains=CHAINS, num_tune=TUNE,
                                num_draws=DRAWS, seed=SEED,
                                posterior_kernel="pallas")
    names = ("nuts_fused_posterior", "nuts_fused_warmup")
    zero_launch_counts()
    t0 = time.monotonic()
    kept = MAIN_TRACE.get("nuts")
    if kept is not None and kept[0] == settings:
        full, reused = kept[1], "the main path's"
    else:
        full, reused = run_sampler(model, settings, device)[0], "its own"

    # checkpoint at a chunk boundary, abort, restore in a fresh sampler
    a = Sampler(model, settings, device=device)
    while a._next_draw < CONTROL_CHECKPOINT_AT:
        a.run_next_chunk()
    at = a._next_draw
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "state.npz")
        a.checkpoint(path)
        snap = a.abort()
        if snap.posterior["position"].shape[1] != at - TUNE:
            raise AssertionError("abort's snapshot holds "
                                 f"{snap.posterior['position'].shape}")
        try:
            a.run()
        except RuntimeError:
            pass
        else:
            raise AssertionError("run() after abort() did not raise")
        b = Sampler(model, settings, device=device)
        b.restore(path)
        # the card's checkpoint on the CPU: its state bit for bit, then its
        # first draws on the kernels' plain versions against the card's
        cpu = Sampler(model, settings, device="cpu",
                      chunk_size=CONTROL_CPU_DRAWS)
        cpu.restore(path)
    for x, y in zip(state_leaves(cpu.state), state_leaves(b.state)):
        if isinstance(x, torch.Tensor):
            if x.device.type != "cpu" or not torch.equal(x, y.cpu()):
                raise AssertionError("the card's checkpoint restored on the "
                                     "CPU differs")
        elif x != y:
            raise AssertionError("the card's checkpoint's draw index differs")
    restored = b.run()
    same_trace(restored, full, "restored run", first=at)
    t_ck = time.monotonic()
    _, cstats, _ = cpu.run_next_chunk()
    t_cpu = time.monotonic() - t_ck
    k = CONTROL_CPU_DRAWS
    cross = close(torch.from_numpy(cstats["position"]),
                  torch.from_numpy(restored.posterior["position"][:, :k]),
                  "the CPU's first restored draws against the card's")
    for name in ("depth", "n_steps", "diverging"):
        if not np.array_equal(cstats[name],
                              restored.sample_stats[name][:, :k]):
            raise AssertionError(f"the CPU's first restored {name} differ "
                                 "from the card's")

    t_ck = time.monotonic() - t0 - t_cpu

    # wait_timeout(0), pause from the callback, resume
    t1 = time.monotonic()
    def pause_once(progress):
        if not pause_once.done:
            pause_once.done = True
            p.pause()

    pause_once.done = False
    p = Sampler(model, settings, device=device, progress_callback=pause_once)
    if p.wait_timeout(0.0) is not None or p.finished or p._next_draw:
        raise AssertionError("wait_timeout(0.0) ran or returned a trace")
    try:
        p.run()
    except RuntimeError:
        paused_at = p._next_draw
    else:
        raise AssertionError("run() paused from the callback did not raise")
    if not 0 < paused_at < TUNE + DRAWS or paused_at != p.chunk_seconds[-1][1]:
        raise AssertionError(f"paused at draw {paused_at}")
    p.resume()
    resumed = p.run()
    same_trace(resumed, full, "paused and resumed run")
    progress_gates(p, resumed, "paused and resumed run")

    t_pause = time.monotonic() - t1

    # the convergence stop
    t1 = time.monotonic()
    stop = Sampler(model, settings, device=device,
                   stop_when=ConvergenceStop(**CONTROL_STOP))
    stopped = stop.run()
    spos = stopped.posterior["position"]
    n_post = spos.shape[1]
    if not (stop.converged and n_post < DRAWS
            and stop._next_draw == TUNE + n_post
            == stop.chunk_seconds[-1][1]):
        raise AssertionError(f"ConvergenceStop: converged {stop.converged}, "
                             f"{n_post} posterior draws, cursor "
                             f"{stop._next_draw}")
    same_trace(stopped, full, "stopped run", end=TUNE + n_post)
    smean = float(spos.mean(dtype=np.float64))
    sstd = float(spos.std(dtype=np.float64))
    if not (abs(smean - MU) < 0.02 and abs(sstd - 1.0) < 0.05):
        raise AssertionError(f"ConvergenceStop posterior mean {smean} std "
                             f"{sstd}")

    t_stop = time.monotonic() - t1

    # the expansions at float16 draws: exp(q - 3) of the float32 positions
    # on the card, the draw index invariant to the chunk size
    t1 = time.monotonic()
    emodel = dataclasses.replace(
        model, expand_fn=lambda q: {"e": torch.exp(q - 3.0)},
        expand_host_fn=draw_index)
    exp_traces = {}
    for chunk in (CHUNK, CHUNK // 2):
        exp_traces[chunk] = Sampler(
            emodel, settings, device=device, chunk_size=chunk,
            draw_dtype=np.float16).run()
    q32 = full.posterior["position"]
    want_e = torch.exp(torch.from_numpy(q32).to(device) - 3.0).cpu().numpy()
    e16 = exp_traces[CHUNK]
    if e16.posterior["position"].dtype != np.float16 or not np.array_equal(
            e16.posterior["position"], q32.astype(np.float16)):
        raise AssertionError("expansion run: positions not the float32 "
                             "run's cast to float16")
    if e16.posterior["e"].dtype != np.float32 or not np.array_equal(
            e16.posterior["e"], want_e):
        raise AssertionError("expand_fn did not read the float32 positions")
    for chunk, tr in exp_traces.items():
        for group, first, n in (("warmup_posterior", 0, TUNE),
                                ("posterior", TUNE, DRAWS)):
            want = np.broadcast_to(np.arange(first, first + n), (CHAINS, n))
            if not np.array_equal(getattr(tr, group)["draw_index"], want):
                raise AssertionError(f"expand_host_fn's draw index at chunk "
                                     f"size {chunk} ({group})")
    t_exp = time.monotonic() - t1
    got = read_launch_counts(nf.LAUNCHES, names)
    t1 = time.monotonic()
    frozen_chains_raise(device)
    t_det = time.monotonic() - t1
    print(f"control path ({reused} uninterrupted run): checkpoint at draw "
          f"{at}, restored on the card: every group equal bit for bit; on "
          f"the CPU: the state bit for bit, its first {k} draws within "
          f"rtol {RTOL} / atol {ATOL} of the card's (max abs diff "
          f"{cross:.3g}); wait_timeout(0.0) None; paused from the callback "
          f"at draw {paused_at}, resumed: equal bit for bit, every chain's "
          f"progress {TUNE + DRAWS} draws with the trace's divergences and "
          "leapfrogs; "
          f"ConvergenceStop({CONTROL_STOP}) at draw {stop._next_draw} "
          f"({n_post} posterior draws, mean {smean:.5f} std {sstd:.5f}); "
          f"expansions at float16 draws: e = exp(q32 - 3) bit for bit, the "
          f"draw index equal at chunk sizes {sorted(exp_traces)}; launches "
          f"{got}; {time.monotonic() - t0:.1f} s (uninterrupted run and "
          f"checkpoint {t_ck:.2f}, the CPU's draws {t_cpu:.2f}, pause "
          f"{t_pause:.2f}, stop {t_stop:.2f}, expansions {t_exp:.2f}, "
          f"frozen chains {t_det:.2f}); frozen chains on the card: "
          "ChainFailedError at draw 16 naming exactly those started at the "
          "frozen point", flush=True)


def frozen_chains_raise(device):
    """The stuck-chain detector on the card: 1024 chains of a model whose
    logp is NaN beyond q[0] = 5 but at the bit-exact point (100, ..., 100),
    every fourth chain started there, the others at 0.5, on the sync
    engine at a fixed step (``tests/test_torch_failure.py``'s mixed run;
    maxdepth 2 keeps the healthy chains' trees, and so the host loop,
    short): ``fail_after=8`` at 4-draw chunks names them at draw 12
    (streaks 3, 7, 11), and the pipelined ``run()`` stores the chunk it
    launched before (draws 12..15), as the JAX ``run()`` does: it must
    raise ChainFailedError at draw 16 naming exactly the chains started at
    the point, each failed in its ChainProgress and the rest not."""
    from nuts_rs_tpu_torch import (ChainFailedError, DiagNutsSettings,
                                   Sampler, StepSizeMethod, StepSizeSettings)
    from nuts_rs_tpu_torch.models.model import Model

    def logp_grad(q):
        ok = (q[:, 0] < 5.0) | (q == 100.0).all(-1)
        logp = torch.where(ok, -0.5 * torch.sum(q * q, -1), torch.nan)
        return logp, torch.where(ok[:, None], -q, torch.nan)

    init = np.full((CHAINS, DIM), 0.5, np.float32)
    frozen = list(range(0, CHAINS, 4))
    init[frozen] = 100.0
    settings = DiagNutsSettings(
        num_chains=CHAINS, num_tune=20, num_draws=20, seed=SEED, maxdepth=2,
        step_size=StepSizeSettings(method=StepSizeMethod.FIXED,
                                   fixed_value=0.5))
    model = Model(logp_fn=lambda q: logp_grad(q[None])[0][0], dim=DIM,
                  logp_grad_fn=logp_grad, name="frozen")
    sampler = Sampler(model, settings, chunk_size=4, init_positions=init,
                      fail_after=8, device=device)
    try:
        sampler.run()
    except ChainFailedError as e:
        if e.chains != frozen or sampler._next_draw != 16:
            raise AssertionError(f"frozen chains: named {len(e.chains)} "
                                 f"chains at draw {sampler._next_draw}")
    else:
        raise AssertionError("frozen chains: no ChainFailedError")
    if [p.failed for p in sampler.progress] != [c % 4 == 0
                                                 for c in range(CHAINS)]:
        raise AssertionError("frozen chains: ChainProgress.failed flags")


# the pipeline path: the split launches' group size, the child processes'
# fault (the second posterior launch) and their time limit
PIPE_SPLIT = 512
PIPE_FAULT_LAUNCH = 2
PIPE_CHILD_SECONDS = 300
# the Zarr run: one chunk a chain and array (Zarr's chunks are a chain's,
# as the JAX backend's, so an array is 1024 files at least), the native
# writer's threads (its default is 2), and the transfer knobs that keep
# its trace to 5 arrays: the card's host wrote about 2,300 files a second
# (34 arrays, 34,816 files: 15.0 s of run() against 0.4 s into memory,
# and 18 s to read them back); the CPU tests hold every array of the
# layout against the JAX backend's
PIPE_ZARR_DRAWS = TUNE + DRAWS
PIPE_ZARR_THREADS = 8
PIPE_ZARR_KNOBS = dict(keep_stats=("mean_tree_accept",), store_warmup=False)
# a child of the pipeline path: the main path with auto_recover and a
# recovery path, whose posterior runner launches an out-of-bounds index on
# the card at its PIPE_FAULT_LAUNCH-th call (a device-side assert, sticky),
# so DeviceLostError must come; then it saves what it stored
PIPE_CHILD_FAULT = """
import os, sys, numpy as np, torch
import chip_smoke as cs
from nuts_rs_tpu_torch import DeviceLostError, DiagNutsSettings, Sampler
from nuts_rs_tpu_torch.models.gaussian import normal_logp
out, rec = sys.argv[1], sys.argv[2]
dev = torch.device("cuda", 0)
settings = DiagNutsSettings(num_chains=cs.CHAINS, num_tune=cs.TUNE,
                            num_draws=cs.DRAWS, seed=cs.SEED,
                            posterior_kernel="pallas")
s = Sampler(normal_logp(cs.DIM, cs.MU), settings, device=dev,
            auto_recover=1, recovery_path=rec)
calls = [0]
def faulting(runner):
    def run(state, flags):
        calls[0] += 1
        res = runner(state, flags)
        if calls[0] == cs.PIPE_FAULT_LAUNCH:
            x = torch.zeros(4, device=dev)
            x[torch.full((1,), 1 << 20, dtype=torch.long, device=dev)] = 1.0
            torch.cuda.synchronize(dev)
        return res
    return run
s._phase_runners[-1] = s._phase_runners[-1][:2] + (
    faulting(s._phase_runners[-1][2]),)
try:
    s.run()
except DeviceLostError as e:
    tr = s.trace.finalize()
    np.savez(out, warm=tr.warmup_posterior["position"],
             post=tr.posterior["position"],
             steps=tr.sample_stats["n_steps"])
    print(f"DeviceLostError at draw {s._next_draw}: {str(e)[:160]}",
          flush=True)
    # the context is dead: freeing its tensors at exit would abort
    os._exit(0)
sys.exit("no DeviceLostError")
"""
# the second child: a fresh process, started beside the first, builds its
# sampler, waits for the first child's stored draws (written after the
# spill), restores the spilled snapshot and finishes the run
PIPE_CHILD_RESTORE = """
import os, sys, time, numpy as np, torch
import chip_smoke as cs
from nuts_rs_tpu_torch import DiagNutsSettings, Sampler
from nuts_rs_tpu_torch.models.gaussian import normal_logp
out, rec, part = sys.argv[1], sys.argv[2], sys.argv[3]
settings = DiagNutsSettings(num_chains=cs.CHAINS, num_tune=cs.TUNE,
                            num_draws=cs.DRAWS, seed=cs.SEED,
                            posterior_kernel="pallas")
s = Sampler(normal_logp(cs.DIM, cs.MU), settings,
            device=torch.device("cuda", 0))
deadline = time.monotonic() + cs.PIPE_CHILD_SECONDS
while not os.path.exists(part):
    if time.monotonic() > deadline:
        sys.exit("the faulting child wrote nothing")
    time.sleep(0.05)
s.restore(rec)
at = s._next_draw
tr = s.run()
np.savez(out, at=at, warm=tr.warmup_posterior["position"],
         post=tr.posterior["position"], steps=tr.sample_stats["n_steps"])
print(f"restored at draw {at}, finished at draw {s._next_draw}")
"""


def timed_launches(sink):
    """Record CUDA events around every K1 / K2 call into ``sink`` (the
    kernels' device time, without waiting for the card); returns the
    function that undoes it."""
    from nuts_rs_tpu_torch.kernels import nuts_fused as nf

    run0, warm0 = nf.nuts_fused_run, nf.nuts_fused_warmup_run

    def wrap(fn):
        def call(*a, **k):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*a, **k)
            end.record()
            sink.append((start, end))
            return out
        return call

    nf.nuts_fused_run, nf.nuts_fused_warmup_run = wrap(run0), wrap(warm0)

    def undo():
        nf.nuts_fused_run, nf.nuts_fused_warmup_run = run0, warm0
    return undo


def pipeline_run(model, settings, device, serial, **knobs):
    """The main path once, by ``run()`` or (``serial``) a ``run_next_chunk``
    loop: (trace, sampler, end-to-end seconds, posterior seconds from the
    first posterior launch to the end, the kernels' busy share of the
    end-to-end wall, the storage's finalize seconds)."""
    from nuts_rs_tpu_torch import Sampler

    events, first_post, fin = [], [], []
    undo = timed_launches(events)
    try:
        torch.cuda.synchronize()
        t0 = time.monotonic()
        s = Sampler(model, settings, device=device, **knobs)
        launch0, finalize0 = s._launch_chunk, s.trace.finalize

        def launch():
            if s._next_draw >= settings.num_tune and not first_post:
                first_post.append(time.monotonic())
            return launch0()

        def finalize():
            t = time.monotonic()
            out = finalize0()
            fin.append(time.monotonic() - t)
            return out

        s._launch_chunk, s.trace.finalize = launch, finalize
        if serial:
            while not s.finished:
                s.run_next_chunk()
            trace = s.trace.finalize()
        else:
            trace = s.run()
        torch.cuda.synchronize()
        t_end = time.monotonic()
    finally:
        undo()
    wall = t_end - t0
    busy = sum(a.elapsed_time(b) for a, b in events) / 1e3
    return trace, s, wall, t_end - first_post[0], busy / wall, fin[0]


# runs the two children side by side, beside the pipeline path, and relays
# their lines, the faulting child's first
PIPE_CHILDREN = """
import subprocess, sys
import chip_smoke as cs
part, rec, done = sys.argv[1:4]
procs = [subprocess.Popen([sys.executable, "-c", src, *args],
                          stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                          text=True)
         for src, args in ((cs.PIPE_CHILD_FAULT, (part, rec)),
                           (cs.PIPE_CHILD_RESTORE, (done, rec, part)))]
bad = []
for p in procs:
    if bad:  # the restoring child would wait for a spill that never comes
        p.kill()
    out, err = p.communicate(timeout=cs.PIPE_CHILD_SECONDS)
    print(out.strip(), flush=True)
    if p.returncode:
        bad.append(f"exit {p.returncode}: {out[-1500:]} {err[-1500:]}")
sys.exit("; ".join(bad) or None)
"""


def pipeline_children(tmp):
    """Start the two children (PIPE_CHILDREN) in the directory ``tmp``;
    returns the Popen and the files they write, their lines' log last."""
    here = Path(__file__).resolve().parent
    files = [os.path.join(tmp, f"{n}.npz") for n in ("part", "rec", "done")]
    log = os.path.join(tmp, "children.log")
    with open(log, "w") as out:
        proc = subprocess.Popen(
            [sys.executable, "-c", PIPE_CHILDREN, *files], cwd=here,
            stdout=out, stderr=subprocess.STDOUT, text=True)
    return proc, files + [log]


# In a whole run the children start beside the flow path's sync warmup, as
# soon as K1 and K2 are built (a child must not build them too), and end
# before any kernel is checked or timed (wait_beside); the pipeline path
# then reads what they wrote.
PIPE_EARLY = []  # [(thread, box)]


def start_pipeline_children():
    import tempfile
    import threading

    from nuts_rs_tpu_torch.kernels import _build

    box = {"tmp": tempfile.TemporaryDirectory()}

    def start():
        try:
            _build.build(PATH_SOURCES["pipeline"])
            box["children"] = pipeline_children(box["tmp"].name)
        except Exception as e:  # raised again in the pipeline path
            box["error"] = e

    thread = threading.Thread(target=start, daemon=True)
    thread.start()
    PIPE_EARLY.append((thread, box))


def wait_pipeline_children():
    for thread, box in PIPE_EARLY:
        thread.join()
        if "children" in box:
            box["children"][0].wait(timeout=2 * PIPE_CHILD_SECONDS)


def stop_pipeline_children():
    for thread, box in PIPE_EARLY:
        thread.join()
        if "children" in box and box["children"][0].poll() is None:
            box["children"][0].kill()
            box["children"][0].wait()
        box["tmp"].cleanup()
    PIPE_EARLY.clear()


def pipeline_restore_gates(proc, files, serial):
    """Wait for the children: the faulting one raised DeviceLostError and
    spilled its snapshot, the second restored it and finished; the two
    together hold every draw of the uninterrupted run ``serial`` exactly
    once, bit for bit."""
    proc.wait(timeout=2 * PIPE_CHILD_SECONDS)
    part, rec, done, log = files
    out = Path(log).read_text()
    if proc.returncode or "DeviceLostError" not in out:
        raise AssertionError(f"the children: exit {proc.returncode}: "
                             f"{out[-3000:]}")
    if not os.path.exists(rec):
        raise AssertionError("the faulting child spilled no snapshot")
    a, b = np.load(part), np.load(done)
    at = int(b["at"])
    warm = serial.warmup_posterior["position"]
    post = serial.posterior["position"]
    steps = serial.sample_stats["n_steps"]
    if at <= TUNE:
        raise AssertionError(f"the snapshot is at draw {at}, in the warmup")
    p = at - TUNE
    if not (np.array_equal(a["warm"], warm)
            and np.array_equal(a["post"][:, :p], post[:, :p])
            and np.array_equal(a["steps"][:, :p], steps[:, :p])
            and a["post"].shape[1] == p):
        raise AssertionError("the faulting child's stored draws differ from "
                             "the uninterrupted run's")
    if not (np.array_equal(b["post"], post[:, p:])
            and np.array_equal(b["steps"], steps[:, p:])
            and b["warm"].shape[1] == 0):
        raise AssertionError("the restored child's draws differ from the "
                             "uninterrupted run's")
    lines = out.strip().splitlines()
    return lines[0], lines[-1], at


def path_pipeline(device, checks, launches, times):
    """run()'s pipelining, split launches, the Zarr backend, profile_dir
    and auto_recover on the main path's configuration (NUTS d = 10, 1024
    chains, 300 + 700 draws, K1 and K2)."""
    import dataclasses
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    from nuts_rs_tpu_torch import DiagNutsSettings, ZarrConfig
    from nuts_rs_tpu_torch.kernels import nuts_fused as nf
    from nuts_rs_tpu_torch.models.gaussian import normal_logp
    from nuts_rs_tpu_torch.storage.zarr_format import read_array

    model = normal_logp(DIM, MU)
    settings = DiagNutsSettings(num_chains=CHAINS, num_tune=TUNE,
                                num_draws=DRAWS, seed=SEED,
                                posterior_kernel="pallas")
    names = ("nuts_fused_posterior", "nuts_fused_warmup")
    t_path = time.monotonic()
    # the serial loop, then run() pipelined, into memory, twice each in
    # turn: end-to-end and posterior seconds, the kernels' busy share
    zero_launch_counts()
    runs = {"serial": [], "pipelined": []}
    for rep in range(2):
        for how in ("serial", "pipelined"):
            runs[how].append(pipeline_run(model, settings, device,
                                          how == "serial"))
    counts = read_launch_counts(nf.LAUNCHES, names)
    once = {k: n // 4 for k, n in counts.items()}
    serial = runs["serial"][0][0]
    for how, rs in runs.items():
        for r in rs:
            same_trace(r[0], serial, f"{how} run")
    card = card_line()
    for how, rs in runs.items():
        print(f"pipeline path, {how} ({card}): end to end "
              + ", ".join(f"{r[2]:.3f}" for r in rs) + " s; posterior "
              + ", ".join(f"{r[3]:.3f}" for r in rs) + " s; K1 / K2 busy "
              + ", ".join(f"{100 * r[4]:.1f}%" for r in rs)
              + " of the end-to-end wall", flush=True)
    copier = runs["pipelined"][0][1]._copier
    if copier.reused_in_flight or not copier.reused:
        raise AssertionError(f"copy stream: {copier.reused} buffers reused, "
                             f"{copier.reused_in_flight} while in flight")

    early = PIPE_EARLY.pop() if PIPE_EARLY else None
    with tempfile.TemporaryDirectory() as tmp:
        # the children run beside what follows (started beside the flow
        # path in a whole run); no timing below
        if early is None:
            proc, files = pipeline_children(tmp)
        else:
            early[0].join()
            if "error" in early[1]:
                raise early[1]["error"]
            proc, files = early[1]["children"]
        try:
            # run() into Zarr through the native writer, against memory
            t0 = time.monotonic()
            s_z = pipeline_run(model, settings, device, False,
                               storage=ZarrConfig(
                                   os.path.join(tmp, "trace.zarr"),
                                   chunk_draws=PIPE_ZARR_DRAWS,
                                   async_writes=True,
                                   writer_threads=PIPE_ZARR_THREADS),
                               **PIPE_ZARR_KNOBS)
            zpath = s_z[0]
            kept = ALWAYS_KEPT | set(PIPE_ZARR_KNOBS["keep_stats"])
            wanted = [(group, name, want) for group in (
                "posterior", "sample_stats")
                for name, want in getattr(serial, group).items()
                if name in kept]
            stored = {g: sorted(n for n in os.listdir(os.path.join(zpath, g))
                                if not n.startswith((
                                    ".", "divergence_",
                                    "transformation_update_")))
                      for g in ("posterior", "sample_stats",
                                "warmup_posterior", "warmup_sample_stats")}
            if {n for g in stored.values() for n in g} != kept or any(
                    stored[g] for g in stored if g.startswith("warmup")):
                raise AssertionError(f"Zarr with the knobs stored {stored}")
            # read back on the host's cores (file reads and zlib release
            # the GIL)
            with ThreadPoolExecutor(os.cpu_count() or 4) as pool:
                read = list(pool.map(lambda w: read_array(
                    os.path.join(zpath, w[0], w[1])), wanted))
            n_arrays = len(wanted)
            for (group, name, want), got in zip(wanted, read):
                want = (want.astype(np.int64) if want.dtype == np.int32
                        else want)
                if got.dtype != want.dtype or not np.array_equal(
                        got, want, equal_nan=True):
                    raise AssertionError(f"Zarr {group}/{name} differs from "
                                         "the serial run's")
            mem = runs["pipelined"][0]
            print(f"pipeline path, Zarr ({PIPE_ZARR_KNOBS}: {n_arrays} "
                  f"arrays; the native writer, async, "
                  f"{PIPE_ZARR_THREADS} threads, codec "
                  f"{s_z[1].trace.groups[('posterior', False)].codec}, "
                  f"{PIPE_ZARR_DRAWS} draws a chunk, one file a chain and "
                  f"array): run() {s_z[2]:.3f} s "
                  f"end to end of which finalize {s_z[5]:.4f} s, against "
                  f"{mem[2]:.3f} s and {mem[5]:.4f} s into memory; all "
                  f"{n_arrays} arrays read back equal to the serial run's; "
                  f"{time.monotonic() - t0:.1f} s", flush=True)

            # max_chains_per_launch: twice the launches, the gates, and the
            # first split posterior launch of each group against its plain
            # version
            seen = []
            run0 = nf.nuts_fused_run

            def spy(*a, **k):
                if len(seen) < CHAINS // PIPE_SPLIT:
                    seen.append((tuple(x.clone() if torch.is_tensor(x)
                                       else x for x in a), dict(k)))
                return run0(*a, **k)

            nf.nuts_fused_run = spy
            try:
                zero_launch_counts()
                split, _, split_s, _, _, _ = pipeline_run(
                    model, settings, device, False,
                    max_chains_per_launch=PIPE_SPLIT)
            finally:
                nf.nuts_fused_run = run0
            got = read_launch_counts(nf.LAUNCHES, names)
            if any(got[k] != 2 * once[k] for k in names):
                raise AssertionError(f"max_chains_per_launch={PIPE_SPLIT}: "
                                     f"launches {got}, unsplit {once}")
            split_gates(split)
            errs = []
            for g, (a, k) in enumerate(seen):
                a = a[:9] + (CHECK_SHORT_DRAWS,) + a[10:]
                out_k = nf.nuts_fused_run(*a, **k)
                out_p = nf.nuts_fused_run_reference(*a, **k)
                require_growing_trees(out_p[4], f"split launch {g}")
                errs.append(compare(f"split launch {g}", out_k, out_p,
                                    ("q_f", "g_f", "logp_f"), nf.STAT_NAMES,
                                    INT_STATS)[1])
            print(f"pipeline path, max_chains_per_launch={PIPE_SPLIT}: "
                  f"launches {got} (unsplit {once}); run() {split_s:.3f} s; "
                  f"the moment gates pass; the first posterior launch of "
                  f"each group (seeds {[a[0] for a, _ in seen]}) against "
                  f"its plain version at {CHECK_SHORT_DRAWS} draws: integer "
                  f"stats equal, max abs err {max(errs):.3g}", flush=True)

            # profile_dir: a trace a chunk, naming K1's kernel
            t0 = time.monotonic()
            prof_dir = os.path.join(tmp, "profile")
            short = dataclasses.replace(settings, num_tune=0,
                                        num_draws=CHUNK)
            zero_launch_counts()
            pipeline_run(model, short, device, False, profile_dir=prof_dir)
            traces = sorted(os.listdir(prof_dir))
            text = Path(prof_dir, traces[0]).read_text()
            if len(traces) != 1 or "posterior_kernel" not in text:
                raise AssertionError(f"profile_dir: {traces}, K1 named: "
                                     f"{'posterior_kernel' in text}")
            print(f"pipeline path, profile_dir: {traces[0]} "
                  f"({len(text)} bytes) names K1's posterior_kernel; "
                  f"{time.monotonic() - t0:.1f} s", flush=True)

            # auto_recover: a real out-of-memory error at the second
            # posterior launch, replayed at half the launch size
            t0 = time.monotonic()
            oom = oom_run(model, settings, device, serial)
            print(f"pipeline path, auto_recover: {oom}; "
                  f"{time.monotonic() - t0:.1f} s", flush=True)
            t0 = time.monotonic()
            lost, restored, at = pipeline_restore_gates(proc, files, serial)
            waited = time.monotonic() - t0
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if early is not None:
                early[1]["tmp"].cleanup()
    print(f"pipeline path, device lost: {lost}; {restored}; the two "
          f"children's draws equal the uninterrupted run's bit for bit "
          f"(snapshot at draw {at}); waited {waited:.1f} s for them; the "
          f"path {time.monotonic() - t_path:.1f} s", flush=True)


def split_gates(trace):
    """The main path's moment gates on a split run's trace."""
    pos = trace.posterior["position"]
    st = trace.sample_stats
    mean = float(pos.mean(dtype=np.float64))
    std = float(pos.std(dtype=np.float64))
    n_div = int(st["diverging"].sum())
    acc = float(st["mean_tree_accept"].mean())
    if not (abs(mean - MU) < 0.02 and abs(std - 1.0) < 0.05 and n_div == 0
            and 0.7 < acc < 0.95):
        raise AssertionError(f"split run: mean {mean} std {std} divergences "
                             f"{n_div} accept {acc}")


def oom_run(model, settings, device, serial):
    """auto_recover on a real torch.cuda.OutOfMemoryError: the posterior
    runner asks the caching allocator for a terabyte at its
    PIPE_FAULT_LAUNCH-th call; the run replays from the last stored chunk
    at half the launch size and stores every draw once.  The first group's
    chains keep their streams (its seed and program ids are the unsplit
    launch's), so they equal the uninterrupted run's bit for bit; the
    others do up to the snapshot."""
    import warnings

    from nuts_rs_tpu_torch import Sampler

    s = Sampler(model, settings, device=device, auto_recover=1)
    calls = [0]
    runner0 = s._phase_runners[-1][2]

    def runner(state, flags):
        calls[0] += 1
        if calls[0] == PIPE_FAULT_LAUNCH:
            torch.empty(1 << 40, dtype=torch.uint8, device=device)
        return runner0(state, flags)

    s._phase_runners[-1] = s._phase_runners[-1][:2] + (runner,)
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        trace = s.run()
    faults = [str(w.message) for w in seen
              if "device fault" in str(w.message)]
    if len(faults) != 1 or "OutOfMemoryError" not in faults[0]:
        raise AssertionError(f"auto_recover: warnings {faults}")
    half = CHAINS // 2
    at = int(re.search(r"at draw (\d+)", faults[0]).group(1)) - TUNE
    pos, want = trace.posterior["position"], serial.posterior["position"]
    if (pos.shape != want.shape or s.max_chains_per_launch != half
            or not np.array_equal(pos[:half], want[:half])
            or not np.array_equal(pos[:, :at], want[:, :at])
            or not np.array_equal(trace.warmup_posterior["position"],
                                  serial.warmup_posterior["position"])):
        raise AssertionError("auto_recover: the recovered trace is not the "
                             "uninterrupted run's where it must be")
    progress_gates(s, trace, "recovered run")
    return (f"a real OutOfMemoryError ({faults[0].split('(')[1][:60]}...) "
            f"at posterior launch {PIPE_FAULT_LAUNCH}, replayed from draw "
            f"{TUNE + at} at max_chains_per_launch={s.max_chains_per_launch}:"
            f" every draw stored once, the first {half} chains equal the "
            "uninterrupted run's bit for bit, the rest up to the snapshot")


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
    from nuts_rs_tpu_torch.kernels import _build
    from nuts_rs_tpu_torch.models.gaussian import normal_logp

    ld_model = normal_logp(LD_DIM, MU)
    ld_settings = DiagNutsSettings(num_chains=LD_CHAINS, num_tune=LD_TUNE,
                                   num_draws=LD_DRAWS, seed=SEED,
                                   posterior_kernel="pallas")
    checks["nuts_fused_ld_posterior"] = check_posterior(
        ld_model, ld_settings.nuts_options(), device, "ld", LD_CHAINS,
        LD_STEP)
    # the short check launch's time over 10 calls: over 3 it read 24.9 and
    # 10.5 ms on the same inputs in two runs (PERF.md section 7)
    checks["nuts_fused_ld_warmup"] = check_warmup(
        ld_model, ld_settings, device, "ld", LD_CHAINS,
        rows=CHECK_K2_SHORT_ROWS, repeats=10)
    D = ld_settings.nuts_options().maxdepth
    for kind in ("posterior", "warmup"):
        per_sm, clusters = _build.ld_occupancy(kind, LD_DIM, D)
        print(f"K{1 if kind == 'posterior' else 2}-ld at d={LD_DIM}: "
              f"{_build.ld_form(kind, LD_DIM, D)} form, {per_sm} chain "
              f"blocks an SM, {clusters} clusters of {_build.MAX_LD_BLOCK} "
              "resident")
    launches.update(main_path(
        ld_model, ld_settings, device,
        ("nuts_fused_ld_posterior", "nuts_fused_ld_warmup"),
        what="large-d path"))
    copies = {np.dtype(dt or np.float32).name: copy_run(
        ld_model, ld_settings, device, dt) for dt in (None, np.float16)}
    print("large-d path, copies to the host, finalize, end to end (s): "
          + "; ".join(f"draw_dtype={k}: {c:.3f}, {f:.3f}, {e:.3f}"
                      for k, (c, f, e) in copies.items()))
    times.update(time_kernels(ld_model, ld_settings, device, "ld", LD_CHAINS,
                              LD_STEP))


def copy_run(model, settings, device, draw_dtype):
    """Sampler.run split into (seconds of the chunks' copies to the host,
    of ``finalize``, end to end); a copy's seconds run from the chunk's
    stats ready on the card (a synchronize) to their numpy arrays."""
    from nuts_rs_tpu_torch import Sampler

    class Timed(Sampler):
        copy_s = 0.0

        def _start_copies(self, lo, hi, stats, t0):
            torch.cuda.synchronize()
            self.t_ready = time.monotonic()
            return super()._start_copies(lo, hi, stats, t0)

        def _finish_chunk(self, chunk):
            out = super()._finish_chunk(chunk)
            Timed.copy_s += time.monotonic() - self.t_ready
            return out

    t0 = time.monotonic()
    sampler = Timed(model, settings, device=device, draw_dtype=draw_dtype)
    while not sampler.finished:
        sampler.run_next_chunk()
    t1 = time.monotonic()
    trace = sampler.trace.finalize()
    t2 = time.monotonic()
    want = np.float16 if draw_dtype is not None else np.float32
    if trace.posterior["position"].dtype != want:
        raise AssertionError(f"positions stored at "
                             f"{trace.posterior['position'].dtype}")
    return Timed.copy_s, t2 - t1, t2 - t0


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
    names = ("nuts_fused_mid_posterior", "nuts_fused_mid_warmup")
    with first_launches({}) as seen:
        launches.update(glm_main_path(glm, glm_settings, device, ref_mean,
                                      ref_std)[0])
    made = time_kernels(
        glm, glm_settings, device, chains=GLM_CHAINS,
        k1=glm_posterior_inputs(glm, device, ref_mean, ref_std, seed=2))
    times.update(time_own_launches(glm, seen, names, made, "data path"))
    for name in names:
        checks[name]["chunk_ms_made_up"] = made[name][0]


def path_mclmc_data(device, checks, launches, times):
    """MCLMC with model data at d=100: K3-args, K4-args (mid-d; the
    regression's microcanonical draws in the group form, its Euclidean
    warmup draws and the iid normal in the 256-threads-a-chain form)."""
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
    # the Euclidean rows in the block form's pair (its own row), the
    # microcanonical ones in the group form
    euclid_row = {}
    checks["mclmc_fused_mid_warmup"] = check_mclmc_warmup(
        glm, mglm_settings, device, name="K4-args",
        micro_state=glm_posterior_inputs(glm, device, mref_mean, mref_std,
                                         seed=3),
        # the Euclidean rows too: from the initial state their plain version
        # took 45-65 s of the script (hundreds of halving iterations)
        euclid_state=glm_posterior_inputs(glm, device, mref_mean, mref_std,
                                          seed=4), euclid_row=euclid_row)
    checks["mclmc_fused_mid_block_warmup"] = euclid_row
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
    launches["mclmc_fused_mid_block_warmup"] = block_warmup_launches(
        "the MCLMC data path", "pair")
    times.update(time_mclmc_kernels(
        glm, mglm_settings, device,
        state=glm_posterior_inputs(glm, device, mref_mean, mref_std, seed=2)))
    times["mclmc_fused_mid_block_warmup"] = time_euclidean_launch(
        glm, mglm_settings, device)


def block_warmup_launches(what, form):
    """The block-form MCLMC warmup kernel's launches on a path that just ran
    (``_build.MCLMC_BLOCK_FORM_LAUNCHES``): every one in ``form``, at least
    one."""
    from nuts_rs_tpu_torch.kernels import _build

    counts = {k.split()[1]: n for k, n in
              _build.MCLMC_BLOCK_FORM_LAUNCHES.items()
              if k.startswith("warmup") and n}
    if set(counts) != {form}:
        raise AssertionError(f"{what}: block-form warmup launches {counts}, "
                             f"not all in the {form} form")
    return counts[form]


def time_euclidean_launch(model, settings, device):
    """K4-args' Euclidean launch of the MCLMC data path on its own inputs
    (rows 0 .. the trajectory switch from the sampler's initial state), in
    the block form the rule gives it: (ms, bound_ms, bound_by), with the
    slowest chain's iterations printed."""
    from nuts_rs_tpu_torch import MclmcTrajectoryKind
    from nuts_rs_tpu_torch.kernels import _build
    from nuts_rs_tpu_torch.kernels import mclmc_fused as mf

    sw = settings.switch_draw
    args = mclmc_warmup_setup(model, settings, device, 0, sw,
                              MclmcTrajectoryKind.EUCLIDEAN)
    box = []

    def run():
        out = mf.mclmc_fused_warmup_run(*args)
        if not box:
            box.append(out[9]["loop_iterations"])
        return out

    timed = chunk_time("mclmc", model, run, args[1:10], 9)
    it = box[0].double()
    form = _build.block_form_name(_build.mclmc_block_form(
        model.dim, model, 1, args[11]))
    print(f"time mclmc_fused_mid_block_warmup on the path's own Euclidean "
          f"launch (rows 0..{sw - 1} from the initial state, "
          f"C={settings.num_chains}, {form} form): {timed[0]:.4f} ms; "
          f"iterations: slowest chain {int(it.max())}, mean "
          f"{float(it.mean()):.1f}: {1e3 * timed[0] / float(it.max()):.3f} "
          f"us an iteration of the slowest chain; bound {timed[1]:.5f} ms "
          f"({timed[2]})")
    return timed


def fused_launches():
    """Every fused-kernel launch counter of the port, by name."""
    from nuts_rs_tpu_torch.kernels import mclmc_fused as mf
    from nuts_rs_tpu_torch.kernels import nuts_fused as nf

    return {**nf.LAUNCHES, **mf.LAUNCHES}


def require_no_fused_launch(what):
    ran = {k: v for k, v in fused_launches().items() if v}
    if ran:
        raise AssertionError(f"{what} launched fused kernels: {ran}")


def path_mclmc_sync(device, checks, launches, times):
    """The MCLMC main configuration on the sync MCLMC engine (the default
    posterior_kernel="sync"), with four extra stores; no fused kernel."""
    from nuts_rs_tpu_torch import DiagMclmcSettings
    from nuts_rs_tpu_torch.models.gaussian import normal_logp

    model = normal_logp(DIM, MU)
    settings = DiagMclmcSettings(num_chains=CHAINS, num_tune=TUNE,
                                 num_draws=DRAWS, seed=SEED, **MSYNC_STORES)
    zero_launch_counts()
    trace, init_s, warm_s, post_s, total_s = run_sampler(model, settings,
                                                         device)
    require_no_fused_launch("the sync MCLMC path")
    pos = trace.posterior["position"].astype(np.float64)
    st, ws = trace.sample_stats, trace.warmup_sample_stats
    mean, std = float(pos.mean()), float(pos.std())
    n_div = int(st["diverging"].sum()) + int(ws["diverging"].sum())
    n_steps = float(st["n_steps"].mean())
    grad_err = max(
        float(np.abs(s["gradient"] + (p["position"].astype(np.float64) - MU)
                     ).max())
        for s, p in ((st, trace.posterior), (ws, trace.warmup_posterior)))
    mm = st["mass_matrix_inv"].shape
    n_grad = int(st["n_steps"].sum())
    print(f"sync MCLMC path: d={DIM} chains={CHAINS} tune={TUNE} "
          f"draws={DRAWS}, stores {sorted(MSYNC_STORES)}: init {init_s:.3f} "
          f"s, warmup {warm_s:.3f} s, posterior {post_s:.3f} s, total with "
          f"trace assembly {total_s:.3f} s, "
          f"{(warm_s + post_s) / (TUNE + DRAWS) * 1e3:.2f} ms a draw, "
          f"{n_grad / max(post_s, 1e-9):.6g} posterior gradient "
          "evaluations/s; no fused launch")
    print(f"sync MCLMC posterior: mean {mean:.5f} std {std:.5f} (JAX sync "
          f"engine: {MCLMC_JAX_STD}) divergences {n_div} mean n_steps "
          f"{n_steps:.3f} (gate {MGLM_NSTEPS}), max |gradient + (q - 3)| "
          f"{grad_err:.3g} (gate {MSYNC_GRAD_TOL}), mass_matrix_inv {mm}, "
          f"divergence_reason max {int(st['divergence_reason'].max())}")
    if not abs(mean - MU) < 0.02:
        raise AssertionError(f"sync MCLMC mean {mean} not within 0.02 of {MU}")
    if not abs(std - MCLMC_JAX_STD) < MCLMC_STD_TOL:
        raise AssertionError(f"sync MCLMC std {std} not within "
                             f"{MCLMC_STD_TOL} of {MCLMC_JAX_STD}")
    if n_div:
        raise AssertionError(f"{n_div} sync MCLMC divergences")
    if not MGLM_NSTEPS[0] < n_steps < MGLM_NSTEPS[1]:
        raise AssertionError(f"mean n_steps {n_steps} outside {MGLM_NSTEPS}")
    if not grad_err <= MSYNC_GRAD_TOL:
        raise AssertionError(f"stored gradient off -(q - 3) by {grad_err}")
    if mm != (CHAINS, DRAWS, DIM):
        raise AssertionError(f"mass_matrix_inv of shape {mm}")


def path_mclmc_d400(device, checks, launches, times):
    """MCLMC at d = 400: the sync warmup (above the fused warmup's limit),
    then K3's mid form for the posterior, without a warning."""
    import warnings

    from nuts_rs_tpu_torch import DiagMclmcSettings, MclmcTrajectoryKind
    from nuts_rs_tpu_torch.adapt import step_size as ss
    from nuts_rs_tpu_torch.kernels import _build
    from nuts_rs_tpu_torch.kernels import mclmc_fused as mf
    from nuts_rs_tpu_torch.models.gaussian import normal_logp

    model = normal_logp(M400_DIM, MU)
    settings = DiagMclmcSettings(num_chains=M400_CHAINS, num_tune=M400_TUNE,
                                 num_draws=M400_DRAWS, seed=SEED,
                                 posterior_kernel="pallas")
    mopts = settings._mclmc_options(MclmcTrajectoryKind.MICROCANONICAL)
    form = _build.mclmc_mid_form(model, mopts)
    ref_mean, ref_std, ref = glm_reference(M400_REFERENCE)
    zero_launch_counts()
    samplers, states = [], []
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        from nuts_rs_tpu_torch import Sampler

        t0 = time.monotonic()
        sampler = Sampler(model, settings, device=device)
        samplers.append(sampler)
        while not sampler.finished:
            if sampler._next_draw == M400_TUNE:
                states.append(sampler.state)
                torch.cuda.synchronize()
                warm_s = time.monotonic() - t0
            sampler.run_next_chunk()
        trace = sampler.trace.finalize()
        total_s = time.monotonic() - t0
    noted = [str(w.message) for w in seen
             if issubclass(w.category, UserWarning)]
    counts = fused_launches()
    post = counts.pop("mclmc_fused_mid_posterior")
    block_form = _build.block_form_name(_build.mclmc_block_form(
        M400_DIM, model, 1, mopts))
    forms = {k: n for k, n in _build.MCLMC_BLOCK_FORM_LAUNCHES.items() if n}
    if noted:
        raise AssertionError(f"the d = 400 plan warned: {noted}")
    if (post < 1 or any(counts.values()) or form != "block"
            or forms != {f"posterior {block_form}": post}):
        raise AssertionError(f"d = 400 launches: mid posterior {post}, "
                             f"others {counts}, form {form}, block-form "
                             f"launches {forms}")
    launches["mclmc_fused_mid_block_posterior"] = post
    st = trace.sample_stats
    mean_err, std_err = glm_moment_errors(trace, settings, M400_DIM,
                                          ref_mean, ref_std)
    n_div = int(st["diverging"].sum())
    print(f"MCLMC d=400 path: chains={M400_CHAINS} tune={M400_TUNE} "
          f"draws={M400_DRAWS}: sync warmup {warm_s:.3f} s (with set-up), "
          f"total {total_s:.3f} s, {post} launches of K3's {form} form "
          f"({block_form}), no fused warmup launch, no warning")
    print(f"MCLMC d=400 posterior: max |mean - reference| {mean_err:.4f} "
          f"posterior std (gate {GLM_MEAN_TOL}; the reference's Monte-Carlo "
          f"error {ref['max_mc_error_of_mean_in_std']:.4f}), max |std / "
          f"reference - 1| {std_err:.4f} (gate {GLM_STD_TOL}), divergences "
          f"{n_div} (warmup "
          f"{int(trace.warmup_sample_stats['diverging'].sum())}), mean "
          f"n_steps {float(st['n_steps'].mean()):.3f}")
    require_glm_moments(mean_err, std_err)
    if n_div:
        raise AssertionError(f"{n_div} MCLMC divergences at d = 400")
    # the path's first posterior launch on its own post-warmup states
    state = states[0]
    t = state.transform
    sset = settings.step_size_settings
    args = (state.pt.q, state.pt.g, state.pt.logp, state.pt.v.contiguous(),
            t.stds.contiguous(), t.mean.contiguous(), t.logdet,
            state.step.step_size, ss.step_size_bar(state.step, sset))
    out_k, out_p, ms, plain_ms = timed_pair(
        lambda: mf.mclmc_fused_run(7, *args, M400_CHECK_DRAWS, model, mopts,
                                   sset.jitter),
        lambda: mf.mclmc_fused_run_reference(7, *args, M400_CHECK_DRAWS,
                                             model, mopts, sset.jitter))
    ps = out_p[-1]
    if not (ps["n_steps"] > 0).any() or bool((ps["diverging"] > 0.5).all()):
        raise AssertionError("d = 400 check: the plain version's "
                             "trajectories do not move")
    n, err = compare("K3 mid d=400", out_k, out_p,
                     ("q_f", "g_f", "logp_f", "v_f"), mf.STAT_NAMES,
                     MCLMC_INT_STATS)
    print(f"K3 mid (block form) check on the d=400 path's own post-warmup "
          f"states: C={M400_CHAINS} d={M400_DIM} K={M400_CHECK_DRAWS}: "
          f"integer stats equal on all {n} (chain, draw) entries, max abs "
          f"err {err:.3g} (draws, final state, all stats); mean n_steps "
          f"{float(ps['n_steps'].mean()):.2f}, "
          f"{float((ps['diverging'] > 0.5).float().mean()):.1%} divergent; "
          f"kernel {ms:.4f} ms, plain {plain_ms:.2f} ms")
    checks["mclmc_fused_mid_block_posterior"] = check_row(
        "mclmc", model, args, out_k, err, ms, plain_ms)
    timed = chunk_time(
        "mclmc", model,
        lambda: mf.mclmc_fused_run(3, *args, CHUNK, model, mopts,
                                   sset.jitter), args, 5)
    times["mclmc_fused_mid_block_posterior"] = timed
    print(f"time mclmc_fused_mid_block_posterior on the path's own states: "
          f"{timed[0]:.4f} ms per {CHUNK}-draw launch at C={M400_CHAINS} "
          f"d={M400_DIM}; bound {timed[1]:.5f} ms ({timed[2]})")


def path_exact_normal(device, checks, launches, times):
    """NUTS with the exact-normal kinetic energy: a "pallas" request demoted
    to the sync NUTS engine with the JAX package's warning."""
    import warnings

    from nuts_rs_tpu_torch import DiagNutsSettings, KineticKind
    from nuts_rs_tpu_torch.models.gaussian import normal_logp

    model = normal_logp(DIM, MU)
    settings = DiagNutsSettings(num_chains=CHAINS, num_tune=EXACT_TUNE,
                                num_draws=EXACT_DRAWS, seed=SEED,
                                kinetic_energy=KineticKind.EXACT_NORMAL,
                                posterior_kernel="pallas")
    zero_launch_counts()
    samplers, ticks = [], []

    def record(progress):
        # the sampler's cursor stays at a chunk's start during its ticks
        ticks.append((samplers[0]._next_draw, progress[0].finished_draws,
                      progress[0].total_num_steps))

    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        trace, init_s, warm_s, post_s, total_s = run_sampler(
            model, settings, device, samplers=samplers, rate_seconds=0.0,
            progress_tick=EXACT_TICK, progress_callback=record)
    noted = [str(w.message) for w in seen
             if "does not support: kinetic_energy=EXACT_NORMAL" in str(
                 w.message)]
    if len(noted) != 1:
        raise AssertionError("the exact-normal demotion's warning is "
                             f"missing: {[str(w.message) for w in seen]}")
    require_no_fused_launch("the exact-normal path")
    pos = trace.posterior["position"].astype(np.float64)
    st = trace.sample_stats
    mean, std = float(pos.mean()), float(pos.std())
    n_div = int(st["diverging"].sum())
    acc = float(st["mean_tree_accept"].mean())
    print(f"exact-normal path: d={DIM} chains={CHAINS} tune={EXACT_TUNE} "
          f"draws={EXACT_DRAWS}: init {init_s:.3f} s, warmup {warm_s:.3f} s, "
          f"posterior {post_s:.3f} s, total {total_s:.3f} s, "
          f"{(warm_s + post_s) / (EXACT_TUNE + EXACT_DRAWS) * 1e3:.2f} ms a "
          f"draw; demoted with the JAX warning; no fused launch")
    print(f"exact-normal posterior: mean {mean:.5f} std {std:.5f} "
          f"divergences {n_div} mean accept {acc:.6f} step size "
          f"{float(np.median(st['step_size_bar'][:, -1])):.4f} mean n_steps "
          f"{float(st['n_steps'].mean()):.3f}")
    if not abs(mean - MU) < 0.02:
        raise AssertionError(f"exact-normal mean {mean} not within 0.02")
    if not abs(std - 1.0) < 0.05:
        raise AssertionError(f"exact-normal std {std} not within 0.05 of 1")
    if n_div:
        raise AssertionError(f"{n_div} exact-normal divergences")
    if not acc >= EXACT_MIN_ACCEPT:
        raise AssertionError(f"exact-normal mean accept {acc} below "
                             f"{EXACT_MIN_ACCEPT}")
    progress_tick_gates(samplers[0], trace, ticks, EXACT_TICK)


def progress_tick_gates(sampler, trace, ticks, every):
    """The in-chunk ticks of a sync-engine run (``progress_tick=every``,
    a callback at every call): within each chunk a tick every ``every``
    draws, its finished draws rising, its running leapfrog count chain 0's
    exact one through that draw; the chunk end's exact values after them;
    the final progress the trace's."""
    want = []
    for lo, hi, _ in sampler.chunk_seconds:
        want += [(lo, lo + j) for j in range(every, hi - lo + 1, every)]
        want.append((hi, hi))
    got = [(lo, d) for lo, d, _ in ticks]
    if got != want:
        raise AssertionError(f"progress_tick: calls {got[:12]}..., expected "
                             f"{want[:12]}...")
    steps = np.concatenate([trace.warmup_sample_stats["n_steps"][0],
                            trace.sample_stats["n_steps"][0]])
    steps = np.cumsum(steps, dtype=np.int64)
    for lo, d, n in ticks:
        if n != steps[d - 1]:
            raise AssertionError(f"progress_tick: {n} leapfrogs at draw {d}, "
                                 f"the trace {steps[d - 1]}")
    progress_gates(sampler, trace, "progress_tick run")
    print(f"progress_tick={every}: {len(ticks) - len(sampler.chunk_seconds)}"
          f" ticks inside {len(sampler.chunk_seconds)} chunks, each chunk's "
          "end replacing them; every call's leapfrog count chain 0's exact "
          "one")


def fp32_issue_per_s():
    """FP32 instructions the card can issue a second on its CUDA cores: 128
    lanes an SM at the SM's maximum clock (``nvidia-smi``)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60)
    mhz = float(out.stdout.strip().splitlines()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return sms * 128 * mhz * 1e6, sms, mhz


def path_stream(device, checks, launches, times):
    """NUTS with streamed data, 131072 rows at d=100: the sync engine for
    the warmup, K1-stream for the posterior (one logical block of all 256
    chains, the JAX runner's)."""
    from nuts_rs_tpu_torch import DiagNutsSettings
    from nuts_rs_tpu_torch.adapt import step_size as ss
    from nuts_rs_tpu_torch.chain import stream_block
    from nuts_rs_tpu_torch.kernels import _build
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
    block = stream_block(big, opts.maxdepth, BIG_CHAINS)
    check_block = stream_block(big, opts.maxdepth, BIG_CHECK_CHAINS)
    tiles = -(-BIG_ROWS // big.stream_tile_rows)
    S, CG = _build.stream_tiling(big.dim, block, opts.maxdepth)
    print(f"streamed-data path: {big.data_bytes / 1e6:.1f} MB of data in "
          f"{tiles} tiles of {big.stream_tile_rows} rows, one range a tile; "
          f"logical block {block} chains (the check's {check_block}), "
          f"sub-tiles of {S} rows, groups of {CG} chains, "
          f"{_build.stream_smem_bytes(big.dim, opts.maxdepth, S, CG)} bytes "
          "of shared memory a chain")
    matmul_ms, _ = time_glm_by_matmul(big, device, BIG_CHAINS)
    checks["nuts_fused_stream_posterior"] = check_posterior(
        big, opts, device, name="K1-stream", stream=True,
        draws=CHECK_SHORT_DRAWS,
        args=glm_posterior_inputs(big, device, ref_mean, ref_std,
                                  chains=BIG_CHECK_CHAINS))
    t0 = time.monotonic()
    samplers = []
    got, warm_s = glm_main_path(
        big, settings, device, ref_mean, ref_std,
        kernels=("nuts_fused_stream_posterior",), what="streamed-data path",
        samplers=samplers)
    want = -(-BIG_DRAWS // CHUNK)
    if got["nuts_fused_stream_posterior"] != want:
        raise AssertionError(f"K1-stream launched {got} times, not {want}")
    launches.update(got)
    post_chunks = [s_ for lo, hi, s_ in samplers[0].chunk_seconds
                   if lo >= BIG_TUNE]
    print(f"sync engine: {warm_s / BIG_TUNE:.4f} s per warmup draw "
          f"({BIG_TUNE} draws of {BIG_CHAINS} chains in lock step, "
          f"{warm_s:.2f} s); posterior chunks "
          f"{', '.join(f'{s_:.3f}' for s_ in post_chunks)} s; the run "
          f"{time.monotonic() - t0:.1f} s")
    # K1-stream's 128-draw launch on made-up states and on the path's own
    # (its final state: positions, transform, adapted steps); one timed call
    # each after the path's own launches
    state = samplers[0].state
    bars = ss.step_size_bar(state.step, samplers[0].config.step_size)
    t_ = state.transform
    own = (state.pt.q, state.pt.g, state.pt.logp, t_.stds.contiguous(),
           t_.mean.contiguous(), t_.logdet, state.step.step_size.contiguous(),
           bars.contiguous())
    made = glm_posterior_inputs(big, device, ref_mean, ref_std, seed=2,
                                chains=BIG_CHAINS)
    rate, sms, mhz = fp32_issue_per_s()
    results = {}
    for label, k1 in (("made-up", made), ("own", own)):
        box = []
        ms = cuda_events_ms(lambda: box.append(nf.nuts_fused_run(
            3, *k1, CHUNK, big, opts, 0.1, stream=True)), 1)
        out = box[0]
        b_ms, b_by = bound("nuts", big, k1, out, out[4])
        iters = int(out[4]["loop_iterations"].max())
        round_us = 1e3 * ms / iters
        share = 4 * BIG_CHAINS * BIG_ROWS * big.dim / (round_us * 1e-6) / rate
        evals = float(out[4]["n_steps"].sum())
        results[label] = (ms, b_ms, b_by)
        print(f"time nuts_fused_stream_posterior on {label} states: "
              f"{ms:.4f} ms per {CHUNK}-draw launch at C={BIG_CHAINS} "
              f"(B={block}) d={big.dim} N={BIG_ROWS}; bound {b_ms:.5f} ms "
              f"({b_by}; with -fmad=false the FP32 floor is twice the "
              f"operations'); {iters} block iterations, {round_us:.2f} us "
              f"each round of {BIG_CHAINS} evaluations, "
              f"{100 * share:.1f}% of the card's FP32 issue rate "
              f"({sms} SMs x 128 lanes x {mhz:.0f} MHz) for the two "
              f"products; {evals / CHUNK / BIG_CHAINS:.2f} evaluations a "
              "draw and chain")
    print(f"the two products of one batched evaluation of all "
          f"{BIG_CHAINS} chains by torch.matmul take {matmul_ms:.4f} ms")
    times["nuts_fused_stream_posterior"] = results["own"]
    checks["nuts_fused_stream_posterior"]["chunk_ms_made_up"] = \
        results["made-up"][0]


# ---------------------------------------------------------------------------
# The model zoo: stochastic volatility on K1-ld-args / K2-ld-args, radon on
# K1-args / K2-args, the other hook models' functors
# ---------------------------------------------------------------------------


def zoo_reference(path):
    """A JAX CPU reference of tests/data/make_zoo_reference.py."""
    ref = json.loads(path.read_text())
    print(f"{ref['model']} reference: {ref['engine']}, {ref['chains']} "
          f"chains x {ref['draws']} draws ({ref['tune']} tuning), divergence "
          f"share {ref['divergence_share']:.5f} (standard error "
          f"{ref['divergence_share_mc_error']:.5f}), accept "
          f"{ref['mean_tree_accept']:.4f}, {ref['mean_n_steps']:.2f} "
          f"leapfrogs a draw, Monte-Carlo error of a mean at most "
          f"{ref['max_mc_error_of_mean_in_std']:.4f} posterior std, of a std "
          f"{ref['max_mc_error_of_std']:.4f}")
    return ref


def stuck_chains(pos):
    """Chains that stay where they are: a chain whose own posterior standard
    deviation of the first coordinate is under a hundredth of the median of
    the chains' (tests/data/make_zoo_reference.py applies the same rule to
    the reference).  SV's far starts in log sigma make them: every tree
    diverges and the step adapts to nothing there."""
    sd = pos[..., 0].std(1)
    return sd < 0.01 * np.median(sd)


def check_stuck(ref, settings, q0, stuck, what):
    """Holds the chains stuck where they started, ``stuck`` (indices), to
    the reference's record of the JAX package's sync engine run from this
    run's own starts beyond log sigma 0 with this run's settings
    (``far_starts``; none stuck without such a record): every stuck chain
    started there, and over those matched starts the chains stuck in one
    engine only, b here and c there, satisfy |b - c| <= 3 sqrt(b + c)
    (McNemar's test at three standard errors; equal sets pass)."""
    far = ref.get("far_starts")
    if far is None:
        if stuck:
            raise AssertionError(f"{what}: chains {stuck} stuck where they "
                                 "started; the reference records none")
        return
    want = (far["port_chains"], far["tune"], far["draws"], far["seed"])
    got = (settings.num_chains, settings.num_tune, settings.num_draws,
           settings.seed)
    if want != got:
        raise AssertionError(f"{what}: the reference's far starts are of a "
                             f"run with {want}, this one has {got}")
    chains = np.nonzero(q0[:, 0] > 0.0)[0]
    if chains.tolist() != far["chains"] or not np.array_equal(
            q0[chains, 0], np.float32(far["start_log_sigma"])):
        raise AssertionError(f"{what}: the starts beyond log sigma 0 are not "
                             "those of the reference's far_starts")
    here, there = set(stuck), set(far["stuck"])
    b, c = len(here - there), len(there - here)
    print(f"{what}: chains stuck where they started {sorted(here)}, the JAX "
          f"package's sync engine from the same starts {sorted(there)}: "
          f"{b} stuck here only, {c} there only (gate |b - c| <= "
          f"{3.0 * np.sqrt(b + c):.3f})")
    below = here - set(far["chains"])
    if below:
        raise AssertionError(f"{what}: chains {sorted(below)} stuck from "
                             "starts below log sigma 0")
    if abs(b - c) > 3.0 * np.sqrt(b + c):
        raise AssertionError(f"{what}: the stuck chains differ from the "
                             "reference's beyond McNemar's three standard "
                             "errors")


def zoo_main_path(model, settings, device, ref, named, kernels, what,
                  kept=None, fail_after=100):
    """A NUTS path of the zoo through Sampler.run, held against its JAX CPU
    reference: the chains stuck where they started (``stuck_chains``)
    against those that the JAX package's sync engine leaves stuck from the
    same starts (``check_stuck``; none where the reference records no far
    starts), and over the other chains
    every coordinate's and every ``named`` quantity's posterior mean within
    GLM_MEAN_TOL posterior std and std within GLM_STD_TOL, the divergence
    share at most the reference's plus DIV_SHARE_TOL and two of its
    standard errors, the mean accept in (0.7, 0.95); launches of
    ``kernels`` and no other fused NUTS kernel.  ``kept``, a list, receives
    the sampler, the trace and the starts; ``fail_after`` is the Sampler's.
    Returns the launches and the functor's count."""
    from nuts_rs_tpu_torch.kernels import _build
    from nuts_rs_tpu_torch.kernels import nuts_fused as nf

    zero_launch_counts()
    starts, samplers = [], []
    trace, init_s, warm_s, post_s, total_s = run_sampler(
        model, settings, device, starts, samplers, fail_after=fail_after)
    if kept is not None:
        kept.extend((samplers[0], trace, starts[0]))
    launches = read_launch_counts(nf.LAUNCHES, kernels)
    others = {k: n for k, n in nf.LAUNCHES.items() if k not in kernels and n}
    if others:
        raise AssertionError(f"{what} launched other kernels: {others}")
    functor = model.hook_parts()[0]
    functor_launches = _build.MODEL_LAUNCHES[functor]
    if functor_launches != sum(launches.values()):
        raise AssertionError(f"{what}: {functor_launches} launches evaluated "
                             f"{functor}, the path made {launches}")
    pos = trace.posterior["position"]
    if pos.shape != (settings.num_chains, settings.num_draws, model.dim):
        raise AssertionError(f"posterior shape {pos.shape}")
    pos = pos.astype(np.float64)
    if not np.isfinite(pos).all():
        raise AssertionError("non-finite posterior draws")
    stuck = stuck_chains(pos)
    check_stuck(ref, settings, starts[0], np.nonzero(stuck)[0].tolist(), what)
    pos = pos[~stuck]
    flat = pos.reshape(-1, model.dim)
    ref_mean, ref_std = np.array(ref["mean"]), np.array(ref["std"])
    mean_err = np.abs(flat.mean(0) - ref_mean) / ref_std
    std_err = np.abs(flat.std(0) / ref_std - 1.0)
    worst = [f"coordinates: mean {mean_err.max():.4f} (at "
             f"{int(mean_err.argmax())}), std {std_err.max():.4f} (at "
             f"{int(std_err.argmax())})"]
    errs = [mean_err.max()], [std_err.max()]
    for name, fn in named.items():
        x = fn(pos)
        r = ref["named"][name]
        em = abs(x.mean() - r["mean"]) / r["std"]
        es = abs(x.std() / r["std"] - 1.0)
        worst.append(f"{name} {x.mean():.5g} +- {x.std():.4g} (reference "
                     f"{r['mean']:.5g} +- {r['std']:.4g}): mean {em:.4f}, "
                     f"std {es:.4f}")
        errs[0].append(em)
        errs[1].append(es)
    n_grad = int(trace.sample_stats["n_steps"].sum())
    st = {k: v[~stuck] for k, v in trace.sample_stats.items()}
    div = float(st["diverging"].mean())
    acc = float(st["mean_tree_accept"].mean())
    n_warm = int(trace.warmup_sample_stats["n_steps"].sum())
    print(f"{what}: {model.name} d={model.dim} chains={settings.num_chains} "
          f"tune={settings.num_tune} draws={settings.num_draws}: init "
          f"{init_s:.3f} s, warmup {warm_s:.3f} s, posterior {post_s:.3f} s, "
          f"total with trace assembly {total_s:.3f} s, {n_grad / post_s:.6g} "
          f"posterior gradient evaluations/s ({n_grad} in the posterior, "
          f"{n_warm} in the warmup), launches {launches}, functor "
          f"{functor} evaluated by {functor_launches}")
    print(f"{what} posterior against the reference (gates: mean within "
          f"{GLM_MEAN_TOL} posterior std, std within {GLM_STD_TOL}); "
          + "; ".join(worst))
    div_limit = (ref["divergence_share"] + DIV_SHARE_TOL
                 + 2.0 * ref["divergence_share_mc_error"])
    print(f"{what}: divergence share {div:.5f} (gate <= reference "
          f"{ref['divergence_share']:.5f} + {DIV_SHARE_TOL} + 2 x "
          f"{ref['divergence_share_mc_error']:.5f} = {div_limit:.5f}), mean "
          "accept "
          f"{acc:.4f} (reference {ref['mean_tree_accept']:.4f}), step size "
          f"{float(np.median(st['step_size_bar'][:, -1])):.4f} (reference "
          f"{ref['median_step_size_bar']:.4f}), mean n_steps "
          f"{float(st['n_steps'].mean()):.2f} (reference "
          f"{ref['mean_n_steps']:.2f})")
    require_glm_moments(max(errs[0]), max(errs[1]))
    if not div <= div_limit:
        raise AssertionError(f"{what}: divergence share {div}")
    if not 0.7 < acc < 0.95:
        raise AssertionError(f"mean accept {acc} outside (0.7, 0.95)")
    return launches, functor_launches


def draws_of(trace, group, key, lo, hi):
    """Global draws [lo, hi) of ``group``'s ``key`` ("posterior" or
    "sample_stats", with its warmup twin) of a trace of every draw."""
    warm, post = getattr(trace, "warmup_" + group)[key], \
        getattr(trace, group)[key]
    tune = warm.shape[1]
    return np.concatenate([warm[:, lo:min(hi, tune)],
                           post[:, max(lo - tune, 0):max(hi - tune, 0)]], 1)


def detector_replay(trace, boundaries, fail_after):
    """The stuck-chain detector replayed on a whole run's stored draws,
    chunk by chunk: at each chunk end a chain's streak is its trailing run
    of draws that diverged and left every coordinate bit-equal to the draw
    before (NaN equal to NaN; the run's first draw counts as moved).
    Returns [(chunk end, the chains whose streak first reaches
    ``fail_after`` there)] for every end in ``boundaries``."""
    streak, prev, lo, named, out = None, None, 0, set(), []
    for end in boundaries:
        pos = draws_of(trace, "posterior", "position", lo, end)
        div = draws_of(trace, "sample_stats", "diverging", lo, end)
        before = np.concatenate([(pos[:, :1] if prev is None else prev),
                                 pos[:, :-1]], 1)
        same = ((pos == before) | (np.isnan(pos) & np.isnan(before))).all(-1)
        if prev is None:
            same[:, 0] = False
            streak = np.zeros(len(div), np.int64)
        for t in range(end - lo):
            streak = np.where(div[:, t] & same[:, t], streak + 1, 0)
        prev, lo = pos[:, -1:], end
        new = [c for c in np.nonzero(streak >= fail_after)[0].tolist()
               if c not in named]
        named.update(new)
        out.append((end, new))
    return out


def longest_frozen(trace, chains):
    """Each of ``chains``' longest run of draws that diverged and left
    every coordinate bit-equal to the draw before, over the whole run, and
    its share of divergent draws."""
    out = {}
    for c in chains:
        pos = np.concatenate([trace.warmup_posterior["position"][c],
                              trace.posterior["position"][c]])
        div = np.concatenate([trace.warmup_sample_stats["diverging"][c],
                              trace.sample_stats["diverging"][c]])
        stuck = div[1:] & (pos[1:] == pos[:-1]).all(-1)
        run = best = 0
        for x in stuck:
            run = run + 1 if x else 0
            best = max(best, run)
        out[c] = (best, float(div.mean()))
    return out


def sv_detector(model, settings, device, first, trace, q0, names):
    """SV once more with the JAX package's default ``fail_after=100``, to
    draw SV_DETECTOR_DRAWS (a progress callback pauses it there): the
    detector must stop it with ChainFailedError exactly where its replay on
    the first run's stored draws says (same seed and chunks), naming those
    chains, each among the first run's ``stuck_chains`` and never leaving
    its start in the partial trace, which equals the first run's draws; a
    chain frozen and divergent through draw 100 makes the raise required;
    where the replay names none by then, the run pauses unfailed.  The
    pipelined ``run()`` stops one chunk after the chunk end where the pause
    or the first named chain comes (it stores the chunk it launched
    before, as the JAX ``run()`` does), and the chains named in that chunk
    are named too."""
    from nuts_rs_tpu_torch import ChainFailedError, Sampler
    from nuts_rs_tpu_torch.kernels import nuts_fused as nf

    fail_after = 100
    # the pause comes at the first chunk end at or past SV_DETECTOR_DRAWS
    # and the run stops one chunk later; the replay reads the first run's
    # draws up to there
    ends = [hi for _, hi, _ in first.chunk_seconds]
    stop_at = min(e for e in ends if e >= SV_DETECTOR_DRAWS)
    after = {e: n for e, n in zip(ends, ends[1:])}
    replay = detector_replay(trace, [e for e in ends
                                     if e <= after[stop_at]], fail_after)
    first_named = next((e for e, new in replay if new), None)
    end = after[min(stop_at, first_named or stop_at)]
    want = [c for e, new in replay if e <= end for c in new]
    at = end if want else None
    ends = [e for e in ends if e <= end]
    stuck = np.nonzero(stuck_chains(
        trace.posterior["position"].astype(np.float64)))[0].tolist()
    pos = trace.warmup_posterior["position"]
    div = trace.warmup_sample_stats["diverging"]
    # frozen through draw fail_after: the raise is required
    still = [c for c in range(len(q0))
             if (pos[c, :fail_after + 1] == q0[c]).all()
             and div[c, 1:fail_after + 1].all()]
    zero_launch_counts()
    t0 = time.monotonic()

    def pause_there(progress):
        if progress[0].finished_draws >= SV_DETECTOR_DRAWS:
            sampler.pause()

    sampler = Sampler(model, settings, device=device, fail_after=fail_after,
                      progress_callback=pause_there)
    sampler.progress_rate_seconds = 0.0
    err = None
    try:
        sampler.run()
    except ChainFailedError as e:
        err = e
    except RuntimeError:
        pass  # paused
    seconds = time.monotonic() - t0
    got = {k: n for k, n in nf.LAUNCHES.items() if n}
    print(f"SV detector (fail_after={fail_after}, to draw "
          f"{SV_DETECTOR_DRAWS}): replay on the first run's {len(ends)} "
          f"chunk ends names {want} at draw {at}; chains frozen through draw "
          f"{fail_after}: {still}; stuck_chains' longest frozen runs and "
          f"divergent shares: {longest_frozen(trace, stuck)}; the run "
          + (f"raised ChainFailedError at draw {sampler._next_draw} naming "
             f"{err.chains}" if err is not None
             else f"paused unfailed at draw {sampler._next_draw}")
          + f", {seconds:.2f} s, launches {got}", flush=True)
    if still and err is None:
        raise AssertionError(f"SV detector: chains {still} were frozen "
                             f"through draw {fail_after} and no "
                             "ChainFailedError came")
    if at is None:
        if err is not None or any(p.failed for p in sampler.progress):
            raise AssertionError("SV detector: a chain failed where its "
                                 "replay names none")
        if sampler._next_draw != end:
            raise AssertionError(f"SV detector: paused at draw "
                                 f"{sampler._next_draw}, not {end}")
        return
    if err is None or err.chains != want or sampler._next_draw != at:
        raise AssertionError(f"SV detector: expected ChainFailedError at "
                             f"draw {at} naming {want}")
    if not set(want) <= set(stuck):
        raise AssertionError(f"SV detector: named {want}, stuck_chains "
                             f"{stuck}")
    part = err.trace.warmup_posterior["position"]
    if part.shape[1] != at or not np.array_equal(part, pos[:, :at]):
        raise AssertionError("SV detector: the partial trace differs from "
                             "the first run's draws")
    for c in want:
        if not (part[c] == q0[c]).all():
            raise AssertionError(f"SV detector: chain {c} left its start")
    if not all(p.failed == (c in want)
               for c, p in enumerate(sampler.progress)):
        raise AssertionError("SV detector: ChainProgress.failed flags")
    read_launch_counts(nf.LAUNCHES, names[1:])


def path_sv(device, checks, launches, times):
    """Stochastic volatility, T = 1000 (d = 1002), 512 chains: the
    dim-on-lanes kernels with the model's data, K1-ld-args and K2-ld-args."""
    from nuts_rs_tpu_torch import DiagNutsSettings
    from nuts_rs_tpu_torch.models.stochastic_volatility import (
        stochastic_volatility)

    ref = zoo_reference(SV_REFERENCE)
    model = stochastic_volatility(T=SV_T, seed=SEED).to(device)
    settings = DiagNutsSettings(num_chains=SV_CHAINS, num_tune=SV_TUNE,
                                num_draws=SV_DRAWS, seed=SEED,
                                posterior_kernel="pallas")
    opts = settings.nuts_options()
    centre, spread = np.array(ref["mean"]), np.array(ref["std"])

    def state(seed, chains=ZOO_CHECK_CHAINS):
        return glm_posterior_inputs(model, device, centre, spread, seed,
                                    chains, SV_STEP)

    k1 = check_posterior(model, opts, device, "ld", name="K1-ld-args",
                         args=state(1), draws=CHECK_SHORT_DRAWS)
    k2 = check_warmup(model, settings, device, "ld", name="K2-ld-args",
                      rows=ZOO_CHECK_ROWS, state=state(3))
    checks["nuts_fused_ld_args_posterior"] = k1
    checks["nuts_fused_ld_args_warmup"] = k2
    checks["stochastic_volatility"] = functor_row(k1, k2)
    # the path's own launches, kept to be timed again: its first posterior
    # launch (the post-warmup states) and its first full warmup chunk
    names = ("nuts_fused_ld_args_posterior", "nuts_fused_ld_args_warmup")
    kept = []
    with first_launches({}) as seen:
        # fail_after=None: check_stuck holds the chains stuck where they
        # started against the JAX reference's, which needs the whole trace;
        # the detector's own run follows (sv_detector)
        got, functor_launches = zoo_main_path(
            model, settings, device, ref,
            {"sigma": lambda p: np.exp(p[..., 0]),
             "nu": lambda p: np.exp(p[..., 1])}, names, "SV path", kept,
            fail_after=None)
    launches.update(got)
    launches["stochastic_volatility"] = functor_launches
    sv_detector(model, settings, device, *kept, names)
    made = time_kernels(model, settings, device, "ld", SV_CHAINS,
                        k1=state(2, SV_CHAINS), k2_state=state(4, SV_CHAINS))
    times.update(time_own_launches(model, seen, names, made, "SV path"))
    for name in names:
        checks[name]["chunk_ms_made_up"] = made[name][0]
    times["stochastic_volatility"] = times["nuts_fused_ld_args_posterior"]


def path_radon(device, checks, launches, times):
    """Radon, 85 groups of 12 rows (d = 89), 1024 chains: the mid-d kernels
    with the model's data, K1-args and K2-args, on the Radon functor."""
    from nuts_rs_tpu_torch import DiagNutsSettings
    from nuts_rs_tpu_torch.models.hierarchical import radon

    ref = zoo_reference(RADON_REFERENCE)
    model = radon(seed=SEED).to(device)
    settings = DiagNutsSettings(num_chains=RADON_CHAINS,
                                num_tune=RADON_TUNE, num_draws=RADON_DRAWS,
                                seed=SEED, posterior_kernel="pallas")
    opts = settings.nuts_options()
    centre, spread = np.array(ref["mean"]), np.array(ref["std"])

    def state(seed, chains=ZOO_CHECK_CHAINS):
        return glm_posterior_inputs(model, device, centre, spread, seed,
                                    chains, RADON_STEP)

    k1 = check_posterior(model, opts, device, name="K1-args radon",
                         args=state(1))
    k2 = check_warmup(model, settings, device, name="K2-args radon",
                      rows=ZOO_CHECK_ROWS, state=state(3))
    checks["radon"] = functor_row(k1, k2)
    names = ("nuts_fused_mid_posterior", "nuts_fused_mid_warmup")
    with first_launches({}) as seen:
        got, functor_launches = zoo_main_path(
            model, settings, device, ref,
            {"mu_a": lambda p: p[..., 0], "beta": lambda p: p[..., 1],
             "sigma": lambda p: np.exp(p[..., 2]),
             "sigma_a": lambda p: np.exp(p[..., 3])}, names, "radon path")
    launches["radon"] = functor_launches
    made = time_kernels(model, settings, device, chains=RADON_CHAINS,
                        k1=state(2, RADON_CHAINS),
                        k2_state=state(4, RADON_CHAINS))
    own = time_own_launches(model, seen, names, made, "radon path")
    # the functor's row: K1-args on radon, the path's own states
    times["radon"] = own["nuts_fused_mid_posterior"]
    checks["radon"]["chunk_ms_made_up"] = made["nuts_fused_mid_posterior"][0]


def functor_row(*rows):
    """A functor's check row from the kernel checks that evaluated it: the
    largest error, the times and bound of the first."""
    row = dict(rows[0])
    row["max_abs_err"] = max(r["max_abs_err"] for r in rows)
    return row


def path_zoo(device, checks, launches, times):
    """The other hook models, on the mid-d kernels: the rank-1 normal at
    d = 100, the funnel at d = 10 and correlated_normal at d = 100, each
    checked on K1-args against its plain version and driven through
    Sampler.run (moments held against the analytic ones; the funnel's only
    for finiteness, its known NUTS bias and divergences aside)."""
    from nuts_rs_tpu_torch import DiagNutsSettings
    from nuts_rs_tpu_torch.kernels import _build
    from nuts_rs_tpu_torch.kernels import nuts_fused as nf
    from nuts_rs_tpu_torch.models import gaussian as g

    rng = np.random.default_rng(42)
    u = rng.normal(size=100)
    u /= np.linalg.norm(u)
    cases = (
        ("correlated_normal_rank1", g.correlated_normal_rank1(100),
         np.sqrt(1.5 * (1.0 + 999.0 * u * u)), (0.1, 0.2)),
        ("funnel", g.funnel(10), None, (0.2, 0.3)),
        ("correlated_normal", g.correlated_normal(100), np.full(100, 1.5 ** 0.5),
         (0.4, 0.6)),
    )
    for name, model, std, step in cases:
        model = model.to(device)
        settings = DiagNutsSettings(num_chains=ZOO_CHAINS, num_tune=ZOO_TUNE,
                                    num_draws=ZOO_DRAWS, seed=SEED,
                                    posterior_kernel="pallas")
        spread = std if std is not None else np.full(model.dim, 1.0)
        args = glm_posterior_inputs(model, device, np.zeros(model.dim),
                                    spread, chains=ZOO_CHECK_CHAINS,
                                    step=step)
        checks[name] = check_posterior(model, settings.nuts_options(), device,
                                       name=f"K1-args {name}", args=args,
                                       draws=CHECK_SHORT_DRAWS)
        kernels = ("nuts_fused_mid_posterior", "nuts_fused_mid_warmup")
        zero_launch_counts()
        trace, init_s, warm_s, post_s, total_s = run_sampler(
            model, settings, device)
        got = read_launch_counts(nf.LAUNCHES, kernels)
        others = {k: n for k, n in nf.LAUNCHES.items()
                  if k not in kernels and n}
        if others or _build.MODEL_LAUNCHES[name] != sum(got.values()):
            raise AssertionError(f"{name} path launched {dict(nf.LAUNCHES)}")
        launches[name] = _build.MODEL_LAUNCHES[name]
        pos = trace.posterior["position"].astype(np.float64)
        if not np.isfinite(pos).all():
            raise AssertionError(f"{name}: non-finite posterior draws")
        flat = pos.reshape(-1, model.dim)
        line = (f"{name} path: d={model.dim} chains={ZOO_CHAINS} "
                f"tune={ZOO_TUNE} draws={ZOO_DRAWS}: warmup {warm_s:.3f} s, "
                f"posterior {post_s:.3f} s, launches {got}, divergences "
                f"{int(trace.sample_stats['diverging'].sum())}, mean accept "
                f"{float(trace.sample_stats['mean_tree_accept'].mean()):.4f}")
        if std is not None:
            mean_err = float(np.max(np.abs(flat.mean(0)) / std))
            std_err = float(np.max(np.abs(flat.std(0) / std - 1.0)))
            line += (f"; against the analytic moments: max |mean| "
                     f"{mean_err:.4f} std, max |std / std - 1| {std_err:.4f} "
                     f"(gates {ZOO_MEAN_TOL}, {ZOO_STD_TOL})")
            if not (mean_err < ZOO_MEAN_TOL and std_err < ZOO_STD_TOL):
                raise AssertionError(line)
        print(line)
        times[name] = time_kernels(
            model, settings, device, chains=ZOO_CHAINS,
            k1=glm_posterior_inputs(model, device, np.zeros(model.dim),
                                    spread, 2, ZOO_CHAINS, step),
            warmup=False)["nuts_fused_mid_posterior"]


# ---------------------------------------------------------------------------
# The flow path: the sync warmup with the coupling flow's refits, then the
# posterior on K1-flow through the frozen pooled flow
# ---------------------------------------------------------------------------


def flow_flop_per_grad(packed, d):
    """FP32 operations of one evaluation of the flow beyond the tree's and
    the model's: about 12 L H d for the forward and the backward pass
    (three products of H x d a layer each way, two operations each)."""
    return 12 * packed.num_layers * packed.hidden * d


def flow_bound(model, packed, inputs, out):
    """(bound_ms, bound_by) of one K1-flow launch: the tree's 23 and the
    funnel's 5 operations a coordinate and the flow's per evaluation, over
    FP32 peak, against the inputs, outputs and packed parameters over
    device memory's rate."""
    grads = float(out[4]["n_steps"].sum())
    d = model.dim
    t_ops = grads * (d * FLOP_PER_COORD["nuts"] + model_flop_per_grad(model)
                     + flow_flop_per_grad(packed, d)) / FP32_FLOP_PER_S
    t_bytes = tensor_bytes(inputs, out, packed.arrays) / HBM_BYTES_PER_S
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def flow_inputs(z, step, bar):
    """K1-flow's inputs: z in the position slot, the unread ones zero / one."""
    zc = torch.zeros(z.shape[0], device=z.device)
    return (z.contiguous(), torch.zeros_like(z), zc, torch.ones_like(z),
            torch.zeros_like(z), zc.clone(), step.contiguous(),
            bar.contiguous())


def flow_u(pos):
    """u_i = x_i e^(-v/2), i = 1 .. d-1: N(0, 1) under the funnel whatever v
    is, with light tails where the x_i's are heavy."""
    return pos[..., 1:] * np.exp(-0.5 * pos[..., :1])


def flow_moment_gates(pos, ref):
    """(worst share of a mean gate, worst share of a std gate, failures) of
    the gates on v and on every u_i against the reference's replicate runs:
    each mean within max(FLOW_MEAN_TOL, k s) std and each std within
    max(FLOW_STD_TOL, k s') of their averages, k = FLOW_SPREAD_FACTOR
    sqrt(1 + 1 / R).  A gate of 100% or more (a reference that cannot tell
    a collapsed coordinate from a right one) raises."""
    rep = ref["replicates"]
    k = FLOW_SPREAD_FACTOR * (1.0 + 1.0 / len(rep["seeds"])) ** 0.5
    u = flow_u(pos)
    coords = [("v", pos[..., 0], rep["mean"][0], rep["std"][0],
               rep["sd_of_mean_in_std"][0], rep["sd_of_std"][0])]
    coords += [(f"u{j + 1}", u[..., j], rep["u_mean"][j], rep["u_std"][j],
                rep["u_sd_of_mean_in_std"][j], rep["u_sd_of_std"][j])
               for j in range(u.shape[-1])]
    failures, worst_m, worst_s = [], 0.0, 0.0
    for name, x, m_ref, s_ref, sd_m, sd_s in coords:
        m_err = abs(x.mean() - m_ref) / s_ref
        s_err = abs(x.std() / s_ref - 1.0)
        m_tol = max(FLOW_MEAN_TOL, k * sd_m)
        s_tol = max(FLOW_STD_TOL, k * sd_s)
        if m_tol >= 1.0 or s_tol >= 1.0:
            raise AssertionError(f"flow path gate of {name} at {m_tol:.3f} "
                                 f"std, {s_tol:.3f}: the reference's spread "
                                 "is too wide to test it")
        worst_m, worst_s = max(worst_m, m_err / m_tol), max(worst_s,
                                                            s_err / s_tol)
        if m_err > m_tol or s_err > s_tol:
            failures.append(f"{name}: mean {x.mean():.4f} (reference "
                            f"{m_ref:.4f}, {m_err:.4f} std, gate {m_tol:.4f})"
                            f", std {x.std():.4f} (reference {s_ref:.4f}, "
                            f"{s_err:.4f}, gate {s_tol:.4f})")
    return worst_m, worst_s, failures


def path_flow(device, checks, launches, times):
    """funnel(10) under FlowNutsSettings: the warmup on the per-draw sync
    engine with the coupling flow's refits, the posterior on K1-flow."""
    from nuts_rs_tpu_torch import FlowNutsSettings, Sampler
    from nuts_rs_tpu_torch.adapt import step_size as ss
    from nuts_rs_tpu_torch.flows.coupling import tree_map
    from nuts_rs_tpu_torch.kernels import _build
    from nuts_rs_tpu_torch.kernels import mclmc_fused as mf
    from nuts_rs_tpu_torch.kernels import nuts_fused as nf
    from nuts_rs_tpu_torch.models.gaussian import funnel
    from nuts_rs_tpu_torch.transform.ops import flow_vjp

    ref = json.loads(FLOW_REFERENCE.read_text())
    rep = ref["replicates"]
    print(f"flow path reference: {ref['engine']}, {ref['settings']}: "
          f"{ref['refits']} refits, divergence share "
          f"{ref['divergence_share']:.4f} +- "
          f"{ref['divergence_share_mc_error']:.4f}; {len(rep['seeds'])} runs "
          f"at seeds {rep['seeds'][0]}..{rep['seeds'][-1]}: run-to-run "
          f"spread of a mean at most {max(rep['sd_of_mean_in_std']):.4f} "
          f"std, of a std at most {max(rep['sd_of_std']):.4f}")
    model = funnel(FLOW_DIM).to(device)
    settings = FlowNutsSettings(num_chains=FLOW_CHAINS, num_tune=FLOW_TUNE,
                                num_draws=FLOW_DRAWS, seed=SEED,
                                posterior_kernel="pallas")
    kernel = "nuts_fused_flow_posterior"
    zero_launch_counts()
    t0 = time.monotonic()
    sampler = Sampler(model, settings, device=device)
    init_s = time.monotonic() - t0
    trace = sampler.run()
    total_s = time.monotonic() - t0
    # the sync-engine paths' process ends before any kernel is timed
    wait_beside()
    got = read_launch_counts(nf.LAUNCHES, (kernel,))
    others = {k: n for k, n in {**nf.LAUNCHES, **mf.LAUNCHES}.items()
              if k != kernel and n}
    want = -(-FLOW_DRAWS // CHUNK)
    if others or got[kernel] != want or \
            _build.MODEL_LAUNCHES["funnel"] != want:
        raise AssertionError(f"flow path launched {got}, {others}, funnel "
                             f"{_build.MODEL_LAUNCHES['funnel']}; want "
                             f"{want} of K1-flow alone")
    plan = [(a, b) for a, b, _ in sampler._phase_runners]
    if plan != [(0, FLOW_TUNE), (FLOW_TUNE, FLOW_TUNE + FLOW_DRAWS)]:
        raise AssertionError(f"flow path phases {plan}: not the sync warmup "
                             "then the K1-flow posterior")
    if _build.FLOW_FORM_LAUNCHES != {"warp": want, "today": 0}:
        raise AssertionError(f"flow path forms {_build.FLOW_FORM_LAUNCHES}: "
                             f"want {want} in the warp form")
    launches[kernel] = got[kernel]
    warm_s = sum(s for lo, hi, s in sampler.chunk_seconds if lo < FLOW_TUNE)
    post_s = sum(s for lo, hi, s in sampler.chunk_seconds if lo >= FLOW_TUNE)
    pos = trace.posterior["position"].astype(np.float64)
    st, wst = trace.sample_stats, trace.warmup_sample_stats
    refits = int(wst["transformation_index"][:, -1].max())
    params = sampler.state.transform.params
    accepted = float(params["layers"][0]["net"]["w2"].abs().max()) > 0.0
    div = st["diverging"].astype(np.float64)
    div_share = float(div.mean())
    div_gate = (ref["divergence_share"] + DIV_SHARE_TOL
                + 2.0 * ref["divergence_share_mc_error"])
    its = int(wst["n_steps"].max(0).sum())
    n_grad = int(st["n_steps"].sum())
    print(f"flow path: d={FLOW_DIM} chains={FLOW_CHAINS} tune={FLOW_TUNE} "
          f"draws={FLOW_DRAWS}, coupling flow 4 x 32: init {init_s:.3f} s, "
          f"sync warmup {warm_s:.3f} s ({warm_s / FLOW_TUNE:.4f} s a draw, "
          f"{its} tree iterations in lock step, {1e3 * warm_s / its:.3f} ms "
          f"each), posterior {post_s:.3f} s ({n_grad / post_s:.6g} gradient "
          f"evaluations/s), total {total_s:.3f} s, launches {got}; refits "
          f"{refits} (one kept: {accepted})")
    worst_m, worst_s, failures = flow_moment_gates(pos, ref)
    v, u = pos[..., 0], flow_u(pos)
    x_ratio = pos[..., 1:].std((0, 1)) / np.asarray(rep["std"][1:])
    print(f"flow path posterior: v mean {v.mean():.4f} std {v.std():.4f} "
          f"(analytic N(0, 3); reference {rep['mean'][0]:.4f}, "
          f"{rep['std'][0]:.4f}); u_i = x_i e^(-v/2) means "
          f"{u.mean((0, 1)).min():.4f}..{u.mean((0, 1)).max():.4f}, stds "
          f"{u.std((0, 1)).min():.4f}..{u.std((0, 1)).max():.4f} (analytic "
          f"N(0, 1)); worst of v and the u_i at {worst_m:.3f} of its mean "
          f"gate and {worst_s:.3f} of its std gate; x_i stds (not gated) "
          f"{x_ratio.min():.3f}..{x_ratio.max():.3f} of the reference's; "
          f"divergence share "
          f"{div_share:.4f} (gate {div_gate:.4f}), mean accept "
          f"{float(st['mean_tree_accept'].mean()):.4f}, leapfrogs a draw "
          f"{float(st['n_steps'].mean()):.2f} (reference "
          f"{ref['mean_n_steps']:.2f})")
    if failures:
        raise AssertionError("flow path moments: " + "; ".join(failures))
    if div_share > div_gate:
        raise AssertionError(f"flow path divergence share {div_share} above "
                             f"{div_gate}")
    if refits < 1 or not accepted:
        raise AssertionError(f"flow path: {refits} refits, none kept")

    # K1-flow against its plain version on the path's own states (after the
    # warmup's refits: nets off the identity), all chains, 2 draws
    state, config = sampler.state, sampler.config
    opts = config.nuts
    packed = sampler.strategy.spec.kernel_pack(
        tree_map(lambda v: v[0], params))
    bars = ss.step_size_bar(state.step, config.step_size)
    args = flow_inputs(state.pt.z, state.step.step_size, bars)
    out_k, out_p, ms, plain_ms = timed_pair(
        lambda: nf.nuts_fused_run(5, *args, CHECK_SHORT_DRAWS, model, opts,
                                  0.1, flow=packed),
        lambda: nf.nuts_fused_run_reference(5, *args, CHECK_SHORT_DRAWS,
                                            model, opts, 0.1, flow=packed))
    n, err = compare("K1-flow", out_k, out_p, ("q", "z", "logp"),
                     nf.STAT_NAMES, INT_STATS)
    if err != 0.0:
        raise AssertionError(f"K1-flow differs from its plain version by "
                             f"{err}")
    b_ms, b_by = flow_bound(model, packed, args, out_k)
    checks[kernel] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                      "bound_ms": b_ms, "bound_by": b_by}
    form, per_sm = _build.flow_blocks_per_sm(model, opts.maxdepth,
                                             packed.num_layers, packed.hidden)
    print(f"K1-flow check: C={FLOW_CHAINS} d={FLOW_DIM} K={CHECK_SHORT_DRAWS} "
          f"on the path's own states: integer stats equal on all {n} (chain,"
          f" draw) entries, max abs err {err:.3g} (draws, final q, z, logp, "
          f"all stats); kernel {ms:.4f} ms, plain {plain_ms:.2f} ms; {form} "
          f"form, {per_sm} chain blocks an SM")

    # K1-flow alone at the configuration's 256 chains, 128 draws: on the
    # path's own states, tiled to 256 (the kernels line's chunk_ms), and on
    # made-up states near the posterior (z ~ N(0, 1), steps around the
    # path's)
    rng = np.random.default_rng(3)
    C = FLOW_FULL_CHAINS
    med = float(state.step.step_size.median())
    made = flow_inputs(
        torch.tensor(rng.normal(size=(C, FLOW_DIM)), dtype=torch.float32,
                     device=device),
        torch.tensor(rng.uniform(0.9 * med, 1.1 * med, size=C),
                     dtype=torch.float32, device=device),
        torch.full((C,), med, device=device))
    reps = C // FLOW_CHAINS
    own = flow_inputs(state.pt.z.repeat(reps, 1),
                      state.step.step_size.repeat(reps), bars.repeat(reps))
    results = {}
    for label, inputs in (("own", own), ("made-up", made)):
        def launch(inputs=inputs):
            return nf.nuts_fused_run(7, *inputs, CHUNK, model, opts, 0.1,
                                     flow=packed)
        out = launch()
        torch.cuda.synchronize()
        ms_ = cuda_events_ms(launch, 3)
        b_ms_, b_by_ = flow_bound(model, packed, inputs, out)
        iters = int(out[4]["loop_iterations"].max())
        results[label] = (ms_, b_ms_, b_by_)
        print(f"time K1-flow on {label} states: {ms_:.4f} ms per {CHUNK}-draw "
              f"launch at C={C} d={FLOW_DIM}, 4 x 32 flow; bound {b_ms_:.5f} "
              f"ms ({b_by_}); {iters} block iterations at most, "
              f"{1e3 * ms_ / iters:.2f} us each; leapfrogs a draw "
              f"{float(out[4]['n_steps'].mean()):.2f}")
    times[kernel] = results["own"]
    checks[kernel]["chunk_ms_made_up"] = results["made-up"][0]

    # the yardstick: the flow's forward pass and vector-Jacobian product for
    # all 256 chains by batched PyTorch calls (torch.bmm / matmul, TF32 off)
    spec = sampler.strategy.spec
    p0 = tree_map(lambda v: v[0], params)
    z = made[0]
    g = torch.randn_like(z)
    fwd_ms = cuda_events_ms(lambda: spec.forward(p0, z), 20)
    vjp_ms = cuda_events_ms(lambda: flow_vjp(spec, p0, z, g), 20)
    print(f"yardstick: the flow's forward for {C} chains by batched PyTorch "
          f"calls {fwd_ms:.4f} ms, forward and vjp {vjp_ms:.4f} ms (TF32 "
          "off; the sync engine pays it at every leapfrog of the warmup)")
    flow_today(device, checks, launches, times)


def perturbed_flow(spec, d, seed, scale, device):
    """``spec``'s parameters at a random start, every net weight and bias
    moved by N(0, scale^2) off the identity map, packed for K1-flow on
    ``device``."""
    from nuts_rs_tpu_torch.flows.coupling import tree_map

    rng = np.random.default_rng(seed)
    q0 = torch.tensor(rng.normal(size=(1, d)), dtype=torch.float32)
    params = tree_map(lambda v: v[0], spec.init(seed, d, q0, -q0 - 0.5))
    for layer in params["layers"]:
        for k, v in layer["net"].items():
            layer["net"][k] = v + torch.tensor(
                scale * rng.normal(size=tuple(v.shape)), dtype=torch.float32)
    return spec.kernel_pack(tree_map(lambda v: v.to(device), params))


def flow_today_inputs(spec, device, chains, seed):
    """(packed flow, K1-flow's eight posterior inputs) of today's form's
    check (``chains`` = FLOW_TODAY_CHAINS) and timed launch
    (FLOW_FULL_CHAINS) at funnel(FLOW_TODAY_DIM)."""
    d = FLOW_TODAY_DIM
    packed = perturbed_flow(spec, d, 7, FLOW_TODAY_SCALE, device)
    rng = np.random.default_rng(seed)
    z = torch.tensor(0.8 * rng.normal(size=(chains, d)), dtype=torch.float32,
                     device=device)
    step = torch.tensor(rng.uniform(*FLOW_TODAY_STEP, size=chains),
                        dtype=torch.float32, device=device)
    return packed, flow_inputs(z, step, step.clone())


def require_growing_trees(stats, what):
    """Raise unless some tree grew past depth 0 and not every draw
    diverged: draws that all diverge at their first leapfrog check no
    tree."""
    depth = stats["depth"].cpu().numpy()
    div = stats["diverging"].cpu().numpy()
    if depth.max() < 1 or div.all():
        raise AssertionError(f"{what}: no tree grows (depth at most "
                             f"{depth.max()}, {div.mean():.0%} of draws "
                             "divergent)")


def flow_today(device, checks, launches, times):
    """K1-flow in today's form (d > 32): funnel(40) through the default flow
    by Sampler.run (8 chains, 5 tuning draws, one 128-draw launch; every
    chain must move), a check launch through a flow off the identity, and
    its 128-draw launch at 256 chains on made-up states; both launches'
    trees grow."""
    from nuts_rs_tpu_torch import FlowNutsSettings
    from nuts_rs_tpu_torch.kernels import _build
    from nuts_rs_tpu_torch.kernels import nuts_fused as nf
    from nuts_rs_tpu_torch.models.gaussian import funnel

    d, C = FLOW_TODAY_DIM, FLOW_TODAY_CHAINS
    row, kernel = "nuts_fused_flow_posterior_today", "nuts_fused_flow_posterior"
    model = funnel(d).to(device)
    settings = FlowNutsSettings(num_chains=C, num_tune=FLOW_TODAY_TUNE,
                                num_draws=CHUNK, seed=SEED,
                                posterior_kernel="pallas")
    zero_launch_counts()
    samplers = []
    trace, _, warm_s, post_s, run_s = run_sampler(model, settings, device,
                                                  samplers=samplers)
    sampler = samplers[0]
    got = read_launch_counts(nf.LAUNCHES, (kernel,))
    forms = dict(_build.FLOW_FORM_LAUNCHES)
    if got[kernel] != 1 or forms != {"warp": 0, "today": 1}:
        raise AssertionError(f"funnel({d}) through the flow launched {got}, "
                             f"forms {forms}: want one in today's form")
    pos = trace.posterior["position"]
    if pos.shape != (C, CHUNK, d) or not np.isfinite(pos).all():
        raise AssertionError(f"funnel({d}) through the flow: draws of shape "
                             f"{pos.shape}, finite {np.isfinite(pos).all()}")
    moved = (pos != pos[:, :1]).any(axis=(1, 2))
    if not moved.all():
        raise AssertionError(f"funnel({d}) through the flow: chains "
                             f"{np.nonzero(~moved)[0].tolist()} never left "
                             "their first draw")
    launches[row] = forms["today"]

    spec = sampler.strategy.spec
    packed, args = flow_today_inputs(spec, device, C, 4)
    opts = sampler.config.nuts
    form, per_sm = _build.flow_blocks_per_sm(model, opts.maxdepth,
                                             packed.num_layers, packed.hidden)
    if form != "today":
        raise AssertionError(f"funnel({d}) takes K1-flow's {form} form")
    out_k, out_p, ms, plain_ms = timed_pair(
        lambda: nf.nuts_fused_run(5, *args, FLOW_TODAY_K, model, opts, 0.1,
                                  flow=packed),
        lambda: nf.nuts_fused_run_reference(5, *args, FLOW_TODAY_K, model,
                                            opts, 0.1, flow=packed))
    require_growing_trees(out_p[4], "K1-flow (today's form) check")
    n, err = compare("K1-flow (today's form)", out_k, out_p, ("q", "z", "logp"),
                     nf.STAT_NAMES, INT_STATS)
    if err != 0.0:
        raise AssertionError(f"K1-flow in today's form differs from its "
                             f"plain version by {err}")
    b_ms, b_by = flow_bound(model, packed, args, out_k)
    checks[row] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                   "bound_ms": b_ms, "bound_by": b_by}
    st = out_p[4]
    print(f"K1-flow in today's form: funnel({d}) by Sampler.run, {C} chains, "
          f"{FLOW_TODAY_TUNE} + {CHUNK} draws in {run_s:.3f} s (warmup "
          f"{warm_s:.3f} s, posterior {post_s:.3f} s; every chain moves), "
          f"launches {forms}; check C={C} "
          f"d={d} K={FLOW_TODAY_K} through a 4 x 32 flow off the identity: "
          f"integer stats equal on all {n} (chain, draw) entries, max abs err "
          f"{err:.3g}; depth up to {int(st['depth'].max())}, "
          f"{float(st['diverging'].float().mean()):.0%} of draws divergent, "
          f"{float(st['n_steps'].float().mean()):.2f} leapfrogs a draw; "
          f"kernel {ms:.4f} ms, plain {plain_ms:.2f} ms; {per_sm} chain "
          "blocks an SM")

    _, made = flow_today_inputs(spec, device, FLOW_FULL_CHAINS, 5)

    # one timed call (2.8 s at 256 chains on this form's growing trees),
    # after the check launch of the same kernel
    box = []
    ms_ = cuda_events_ms(lambda: box.append(nf.nuts_fused_run(
        7, *made, CHUNK, model, opts, 0.1, flow=packed)), 1)
    out = box[0]
    require_growing_trees(out[4], "K1-flow (today's form) timed launch")
    b_ms_, b_by_ = flow_bound(model, packed, made, out)
    iters = int(out[4]["loop_iterations"].max())
    times[row] = (ms_, b_ms_, b_by_)
    print(f"time K1-flow in today's form on made-up states: {ms_:.4f} ms per "
          f"{CHUNK}-draw launch at C={FLOW_FULL_CHAINS} d={d}, 4 x 32 flow; "
          f"bound {b_ms_:.5f} ms ({b_by_}); {iters} block iterations at "
          f"most, {1e3 * ms_ / iters:.2f} us each; leapfrogs a draw "
          f"{float(out[4]['n_steps'].float().mean()):.2f}, depth up to "
          f"{int(out[4]['depth'].max())}, "
          f"{float(out[4]['diverging'].float().mean()):.0%} of draws "
          "divergent")


# ---------------------------------------------------------------------------
# Slice 20: float64 on the fused kernels (fault D), the low-rank presets and
# cross-chain adaptation on one card (the last three on the sync engine)
# ---------------------------------------------------------------------------


def trace_dtypes(trace):
    """The float dtypes of a trace's four groups, as one set each."""
    return {group: sorted({str(np.asarray(v).dtype)
                           for v in getattr(trace, group).values()
                           if np.asarray(v).dtype.kind == "f"})
            for group in ("posterior", "sample_stats", "warmup_posterior",
                          "warmup_sample_stats")}


def plan_warnings(seen):
    return [str(w.message) for w in seen
            if issubclass(w.category, UserWarning)]


def path_float64(device, checks, launches, times):
    """The NUTS and MCLMC main configurations at dtype=float64 with
    posterior_kernel="pallas": planned on K1 / K2 and K3 / K4, as the JAX
    package plans them (fault D), without a warning; the main paths' gates;
    the trace's dtypes the JAX run's."""
    import warnings

    from nuts_rs_tpu_torch import DiagNutsSettings
    from nuts_rs_tpu_torch.kernels import mclmc_fused as mf
    from nuts_rs_tpu_torch.kernels import nuts_fused as nf
    from nuts_rs_tpu_torch.models.gaussian import normal_logp

    model = normal_logp(DIM, MU)
    runs = (("nuts", DiagNutsSettings(num_chains=CHAINS, num_tune=TUNE,
                                      num_draws=DRAWS, seed=SEED,
                                      posterior_kernel="pallas"),
             nf.LAUNCHES, ("nuts_fused_posterior", "nuts_fused_warmup")),
            ("mclmc", mclmc_settings(), mf.LAUNCHES,
             ("mclmc_fused_posterior", "mclmc_fused_warmup")))
    for name, settings, counts, kernels in runs:
        zero_launch_counts()
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            trace, init_s, warm_s, post_s, total_s = run_sampler(
                model, settings, device, dtype=torch.float64)
        got = read_launch_counts(counts, kernels)
        said = plan_warnings(seen)
        pos = trace.posterior["position"].astype(np.float64)
        st = trace.sample_stats
        mean, std = float(pos.mean()), float(pos.std())
        n_div = int(st["diverging"].sum())
        n_grad = int(st["n_steps"].sum())
        dtypes = trace_dtypes(trace)
        want = {g: [np.dtype(F64_FLOAT[name]).name] for g in dtypes}
        print(f"float64 {name} path: d={DIM} chains={CHAINS} tune={TUNE} "
              f"draws={DRAWS}: init {init_s:.3f} s, warmup {warm_s:.3f} s, "
              f"posterior {post_s:.3f} s, total {total_s:.3f} s, "
              f"{n_grad / post_s:.6g} posterior gradient evaluations/s, "
              f"launches {got}; mean {mean:.5f} std {std:.5f} divergences "
              f"{n_div}; trace float dtypes {dtypes} (the JAX run's: "
              f"{want}); plan warnings {said}")
        if said:
            raise AssertionError(f"the float64 {name} plan warned: {said}")
        if dtypes != want:
            raise AssertionError(f"float64 {name} trace dtypes {dtypes}, "
                                 f"the JAX run's {want}")
        if not abs(mean - MU) < 0.02:
            raise AssertionError(f"float64 {name} mean {mean}")
        target = 1.0 if name == "nuts" else MCLMC_JAX_STD
        tol = 0.05 if name == "nuts" else MCLMC_STD_TOL
        if not abs(std - target) < tol:
            raise AssertionError(f"float64 {name} std {std} not within {tol} "
                                 f"of {target}")
        if n_div:
            raise AssertionError(f"{n_div} float64 {name} divergences")
        if name == "nuts":
            acc = float(st["mean_tree_accept"].mean())
            if not 0.7 < acc < 0.95:
                raise AssertionError(f"float64 mean accept {acc}")


def rank1_moments(dim, scale, eig):
    """The rank-1 normal's coordinate stds, its direction u and the
    variance along u, analytic: covariance scale (I + (eig - 1) u u^T),
    u from np.random.default_rng(42) as the model draws it."""
    rng = np.random.default_rng(42)
    u = rng.normal(size=dim)
    u /= np.linalg.norm(u)
    return np.sqrt(scale * (1.0 + (eig - 1.0) * u * u)), u, scale * eig


def path_low_rank(device, checks, launches, times, draws=LR_DRAWS,
                  dtype=torch.float32):
    """BASELINE config 2 under LowRankNutsSettings on the sync engine: a
    "pallas" request demoted with the JAX package's warning, no fused
    launch, the collapsed chains' share, and over the others the analytic
    moments (every coordinate and the inflated direction), the divergence
    share, the accept rate; the refits' eigenvalues."""
    import warnings

    from nuts_rs_tpu_torch import LowRankNutsSettings, LowRankSettings
    from nuts_rs_tpu_torch.models.gaussian import correlated_normal_rank1

    settings = LowRankNutsSettings(
        num_chains=LR_CHAINS, num_draws=draws, seed=SEED,
        posterior_kernel="pallas",
        low_rank=LowRankSettings(store_mass_matrix=True))
    assert settings.num_tune == LR_TUNE
    zero_launch_counts()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        trace, init_s, warm_s, post_s, total_s = run_sampler(
            correlated_normal_rank1(LR_DIM, LR_SCALE, LR_EIG), settings,
            device, dtype=dtype)
    said = plan_warnings(seen)
    if not any("does not support: mass_matrix='low_rank' (the fused "
               "low-rank transform measured slower than XLA)" in w
               for w in said):
        raise AssertionError(f"the low-rank demotion's warning: {said}")
    require_no_fused_launch("the low-rank path")
    sd, u, var_u = rank1_moments(LR_DIM, LR_SCALE, LR_EIG)
    st, ws = trace.sample_stats, trace.warmup_sample_stats
    collapsed = np.nonzero(st["step_size"][:, -1] < LR_COLLAPSED_STEP)[0]
    keep = np.setdiff1d(np.arange(LR_CHAINS), collapsed)
    pos = trace.posterior["position"][keep].astype(np.float64).reshape(
        -1, LR_DIM)
    mean_err = float(np.max(np.abs(pos.mean(0)) / sd))
    std_err = float(np.max(np.abs(pos.std(0) / sd - 1.0)))
    var_u_err = abs(float(np.var(pos @ u)) / var_u - 1.0)
    div = float(st["diverging"][keep].mean())
    acc = float(st["mean_tree_accept"][keep].mean())
    updates = np.nonzero(np.diff(ws["transformation_index"][0]))[0] + 1
    n_eig = ws["num_eigenvalues"][:, updates[-1]] if len(updates) else None
    ev = trace.transformation_updates[0]
    top = float(ws["mass_matrix_eigvals"][:, -1].max())
    n_grad = int(st["n_steps"].sum())
    lockstep = int(ws["n_steps"].max(0).sum() + st["n_steps"].max(0).sum())
    name = str(dtype).replace("torch.", "")
    print(f"low-rank path ({name}): d={LR_DIM} chains={LR_CHAINS} "
          f"tune={LR_TUNE} draws={draws}: init {init_s:.3f} s, warmup "
          f"{warm_s:.3f} s ({1e3 * warm_s / LR_TUNE:.2f} ms a draw), "
          f"posterior {post_s:.3f} s ({1e3 * post_s / draws:.2f} ms a draw), "
          f"total {total_s:.3f} s, {lockstep} tree iterations in lock step, "
          f"{n_grad / post_s:.6g} posterior gradient evaluations/s; no fused "
          f"launch; {len(updates)} transform updates on chain 0, "
          f"num_eigenvalues at the last "
          f"{None if n_eig is None else n_eig.tolist()[:8]}, largest "
          f"eigenvalue {top:.4g}; collapsed chains (posterior step below "
          f"{LR_COLLAPSED_STEP}) {collapsed.tolist()}")
    print(f"low-rank posterior ({name}, the {len(keep)} chains not "
          f"collapsed): max |mean| {mean_err:.4f} std (gate {LR_MEAN_TOL}), "
          f"max |std / std - 1| {std_err:.4f} (gate {LR_STD_TOL}), variance "
          f"along u {float(np.var(pos @ u)):.2f} against {var_u:.1f} "
          f"({var_u_err:.4f}, gate {LR_VAR_U_TOL}), divergence share "
          f"{div:.5f} (gate {LR_MAX_DIV_SHARE}), mean accept {acc:.4f}, mean "
          f"n_steps {float(st['n_steps'][keep].mean()):.2f}")
    most = LR_MAX_COLLAPSED if dtype == torch.float32 else 0
    if len(collapsed) > most:
        raise AssertionError(f"{len(collapsed)} low-rank chains collapsed "
                             f"at {name} (at most {most})")
    if not (mean_err < LR_MEAN_TOL and std_err < LR_STD_TOL
            and var_u_err < LR_VAR_U_TOL):
        raise AssertionError("low-rank posterior moments off")
    if not div <= LR_MAX_DIV_SHARE:
        raise AssertionError(f"low-rank divergence share {div}")
    if not 0.7 < acc < 0.95:
        raise AssertionError(f"low-rank mean accept {acc}")
    if n_eig is None or not (n_eig >= 1).all():
        raise AssertionError(f"num_eigenvalues at the last update {n_eig}")
    if not ("mass_matrix_eigvals" in ev and ev["mass_matrix_eigvals"].shape
            == (len(ev["draw"]), LR_DIM) and ev["num_eigenvalues"][-1] >= 1):
        raise AssertionError("transformation_updates hold no eigenvalues")


def path_low_rank64(device, checks, launches, times):
    """The low-rank path's preset at float64 (the JAX package's dtype
    under x64), where every refit takes: no chain may collapse."""
    path_low_rank(device, checks, launches, times, dtype=torch.float64)


def path_low_rank_exact(device, checks, launches, times):
    """The reference's strongest oracle at float64 on the card's
    torch.linalg: the adapted low-rank transform whitens
    correlated_normal(10, 0.5) exactly."""
    from nuts_rs_tpu_torch import LowRankNutsSettings, LowRankSettings
    from nuts_rs_tpu_torch.models.gaussian import correlated_normal

    settings = LowRankNutsSettings(
        num_chains=1, num_tune=LRX_TUNE, num_draws=LRX_DRAWS, seed=LRX_SEED,
        low_rank=LowRankSettings(eigval_cutoff=LRX_CUTOFF))
    zero_launch_counts()
    trace, init_s, warm_s, post_s, total_s = run_sampler(
        correlated_normal(LRX_DIM, 0.5), settings, device,
        dtype=torch.float64, chunk_size=300)
    require_no_fused_launch("the low-rank oracle")
    fisher = trace.sample_stats["fisher_distance"]
    n_div = int(trace.sample_stats["diverging"].sum())
    print(f"low-rank oracle: correlated_normal({LRX_DIM}, 0.5), 1 chain, "
          f"{LRX_TUNE} + {LRX_DRAWS} draws at float64: total {total_s:.3f} "
          f"s; max fisher_distance {float(fisher.max()):.3g} (gate "
          f"{LRX_FISHER}), divergences {n_div}")
    if not (fisher.shape == (1, LRX_DRAWS) and (fisher < LRX_FISHER).all()):
        raise AssertionError("the low-rank transform does not whiten exactly")
    if n_div:
        raise AssertionError(f"{n_div} divergences in the low-rank oracle")


def path_cross_chain(device, checks, launches, times, draws=XC_DRAWS):
    """The NUTS main configuration's model and chains with
    cross_chain_adaptation=True on the sync engine: one mass matrix and one
    adapted step for every chain, the main path's moment gates."""
    from nuts_rs_tpu_torch import DiagNutsSettings
    from nuts_rs_tpu_torch.models.gaussian import normal_logp

    settings = DiagNutsSettings(num_chains=CHAINS, num_tune=XC_TUNE,
                                num_draws=draws, seed=SEED,
                                cross_chain_adaptation=True,
                                store_mass_matrix=True)
    zero_launch_counts()
    trace, init_s, warm_s, post_s, total_s = run_sampler(
        normal_logp(DIM, MU), settings, device)
    require_no_fused_launch("the cross-chain path")
    ws, st = trace.warmup_sample_stats, trace.sample_stats

    def every(name):
        return np.concatenate([ws[name], st[name]], 1)

    def shared(x):
        return bool((x == x[:1]).all())

    tid = every("transformation_index")
    first = int(np.argmax(tid[0] != tid[0, 0]))  # after the first update
    same = {name: shared(every(name)[:, first:]) for name in (
        "mass_matrix_inv", "transformation_mu")}
    same["transformation_index"] = shared(tid)
    same["step_size_bar"] = shared(every("step_size_bar"))
    ss = every("step_size")
    spread = float((ss.max(0) / ss.min(0)).max())
    pos = trace.posterior["position"].astype(np.float64)
    mean, std = float(pos.mean()), float(pos.std())
    n_div = int(st["diverging"].sum())
    acc = float(st["mean_tree_accept"].mean())
    print(f"cross-chain path: d={DIM} chains={CHAINS} tune={XC_TUNE} "
          f"draws={draws}: init {init_s:.3f} s, warmup {warm_s:.3f} s, "
          f"posterior {post_s:.3f} s, total {total_s:.3f} s "
          f"({1e3 * (warm_s + post_s) / (XC_TUNE + draws):.2f} ms a draw); "
          f"shared over the chains {same} (the mass matrix from draw "
          f"{first}); each chain's jittered step within a factor {spread:.4f}"
          f" of the others' (at most {(1 + XC_JITTER) / (1 - XC_JITTER):.4f})"
          f"; mean {mean:.5f} std {std:.5f} posterior divergences {n_div} "
          f"mean accept {acc:.4f}")
    if not all(same.values()) or not 0 < first < 10:
        raise AssertionError(f"the pooled adaptation is not shared: {same}")
    if not spread <= (1 + XC_JITTER) / (1 - XC_JITTER) + 1e-6:
        raise AssertionError(f"step sizes spread by {spread}")
    if not abs(mean - MU) < 0.02:
        raise AssertionError(f"cross-chain mean {mean}")
    if not abs(std - 1.0) < 0.05:
        raise AssertionError(f"cross-chain std {std}")
    if n_div:
        raise AssertionError(f"{n_div} cross-chain divergences")
    if not 0.7 < acc < 0.95:
        raise AssertionError(f"cross-chain mean accept {acc}")


# The paths on the sync engines alone launch no kernel and are host-bound
# (one small kernel, or one CUDA graph, after another): in a whole run they
# run in two more processes, started together, beside the flow path's
# sync warmup, also host-bound, and the flow path waits for them before it
# checks or times a kernel (wait_beside), so no kernel is timed beside them.
BESIDE_GROUPS = (("low_rank",),
                 ("mclmc_sync", "exact_normal", "cross_chain",
                  "low_rank_exact"))
BESIDE_PATHS = tuple(p for group in BESIDE_GROUPS for p in group)
# the paths that run with --only alone
ONLY_PATHS = ("low_rank64",)
BESIDE = []  # the processes beside, their groups and starts


def start_beside():
    """Start each group of sync-engine paths in a process of its own
    (``--beside N``)."""
    for n, group in enumerate(BESIDE_GROUPS):
        proc = subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--beside",
             str(n)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        BESIDE.append((proc, group, time.monotonic()))


def wait_beside():
    """Wait for the processes beside, relay their lines, raise if one
    failed; wait for the pipeline path's children too."""
    wait_pipeline_children()
    failed = []
    while BESIDE:
        proc, group, t0 = BESIDE.pop(0)
        out, _ = proc.communicate(timeout=900)
        print(out, end="")
        print(f"paths {', '.join(group)} in a process beside: "
              f"{time.monotonic() - t0:.1f} s from its start, exit "
              f"{proc.returncode}", flush=True)
        if proc.returncode:
            failed += group
    if failed:
        raise AssertionError(f"the paths {failed} failed")


def stop_beside():
    for proc, _, _ in BESIDE:
        proc.kill()
        proc.wait()
    BESIDE.clear()


# in the order they run: the two paths whose sync warmups need no kernel
# first, so that the build runs beside them
PATHS = {"flow": path_flow, "mclmc_sync": path_mclmc_sync,
         "exact_normal": path_exact_normal, "stream": path_stream,
         "nuts": path_nuts, "control": path_control,
         "pipeline": path_pipeline, "mclmc": path_mclmc,
         "float64": path_float64, "large_d": path_large_d,
         "data": path_data, "mclmc_data": path_mclmc_data,
         "mclmc_d400": path_mclmc_d400, "sv": path_sv, "radon": path_radon,
         "zoo": path_zoo, "low_rank": path_low_rank,
         "low_rank64": path_low_rank64,
         "low_rank_exact": path_low_rank_exact,
         "cross_chain": path_cross_chain}
# the sources each path launches (the smem-size helpers of the mid-d and ld
# warmup kernels live in their posterior sources)
PATH_SOURCES = {
    "nuts": ("nuts_fused_posterior", "nuts_fused_warmup"),
    "control": ("nuts_fused_posterior", "nuts_fused_warmup"),
    "pipeline": ("nuts_fused_posterior", "nuts_fused_warmup"),
    "mclmc": ("mclmc_fused_posterior", "mclmc_fused_warmup"),
    "large_d": ("nuts_fused_ld_posterior", "nuts_fused_ld_warmup"),
    "data": ("nuts_fused_mid_posterior", "nuts_fused_mid_warmup"),
    "mclmc_data": ("mclmc_fused_mid_posterior", "mclmc_fused_mid_warmup",
                   "mclmc_fused_group_posterior", "mclmc_fused_group_warmup"),
    "stream": ("nuts_fused_stream_posterior",),
    "sv": ("nuts_fused_ld_args_posterior", "nuts_fused_ld_args_warmup"),
    "radon": ("nuts_fused_mid_posterior", "nuts_fused_mid_warmup"),
    "zoo": ("nuts_fused_mid_posterior", "nuts_fused_mid_warmup"),
    "flow": ("nuts_fused_flow_warp_posterior", "nuts_fused_flow_posterior"),
    "float64": ("nuts_fused_posterior", "nuts_fused_warmup",
                "mclmc_fused_posterior", "mclmc_fused_warmup"),
    # the sync engines launch no kernel
    "mclmc_sync": (),
    "exact_normal": (),
    "low_rank": (),
    "low_rank64": (),
    "low_rank_exact": (),
    "cross_chain": (),
    "mclmc_d400": ("mclmc_fused_mid_posterior",),
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
    ap.add_argument("--beside", type=int, choices=range(len(BESIDE_GROUPS)),
                    default=None,
                    help="drive this group of sync-engine paths alone, as a "
                         "process beside a whole run does")
    args = ap.parse_args(argv)
    only = args.only
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA card "
                           "(torch.cuda.is_available() is false)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.beside is not None:
        os.nice(BESIDE_NICE)
        device = torch.device("cuda", 0)
        for path in BESIDE_GROUPS[args.beside]:
            t0 = time.monotonic()
            PATHS[path](device, {}, {}, {})
            print(f"path {path}: {time.monotonic() - t0:.1f} s", flush=True)
        return 0
    from nuts_rs_tpu_torch.kernels import _build

    device = torch.device("cuda", 0)
    card = card_line()
    print(card)
    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                          text=True, check=True, timeout=60)
    print(f"nvcc: {nvcc.stdout.strip().splitlines()[-1]}; torch "
          f"{torch.__version__} (CUDA {torch.version.cuda})")
    paths = [only] if only else [p for p in PATHS
                                 if p not in BESIDE_PATHS + ONLY_PATHS]
    stems = list(dict.fromkeys(stem for path in paths
                               for stem in PATH_SOURCES[path]))
    # the build runs beside the paths, in the order they need its sources,
    # niced and cores - BUILD_SPARE_CORES nvcc at a time; a path waits for
    # its own sources alone (_build.library).  The flow path comes first:
    # its sync warmup needs no kernel, and the build ends during it.
    cores = len(os.sched_getaffinity(0))
    jobs = max(1, cores - BUILD_SPARE_CORES)
    _build.start_build(stems, nice=BUILD_NICE, jobs=jobs)
    print(f"build: {len(stems)} sources, one nvcc each, {jobs} at a time at "
          f"nice {BUILD_NICE} beside the paths, in their order, into "
          f"{_build.BUILD_DIR}; the host's usable cores: {cores}", flush=True)

    checks, launches, times = {}, {}, {}
    try:
        if not only:
            start_beside()
            start_pipeline_children()
        for path in paths:
            t0, plain0 = time.monotonic(), PLAIN_SECONDS[0]
            PATHS[path](device, checks, launches, times)
            print(f"path {path}: {time.monotonic() - t0:.1f} s, of which the "
                  f"checks' plain versions {PLAIN_SECONDS[0] - plain0:.1f} s",
                  flush=True)
        wait_beside()
    finally:
        stop_beside()
        stop_pipeline_children()
    _build.build(stems)  # raises where a source failed
    nvcc_s = _build.BUILD_INFO["nvcc_seconds"]
    print(f"build: the last nvcc ended "
          f"{max(nvcc_s.values(), default=0.0):.1f} s after the start")
    for stem in stems:
        took = f"nvcc {nvcc_s[stem]:.1f} s; " if stem in nvcc_s else ""
        print(f"  {took}"
              + ptxas_summary(stem, _build.build_log(stem)))

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
