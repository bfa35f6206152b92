#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (nuts_rs_tpu_torch) on one CUDA card.

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

It builds the fused CUDA kernels from ``nuts_rs_tpu_torch/csrc`` (nvcc,
sm_90a), holds each kernel against its plain PyTorch version on the card,
and drives two paths, each ``Sampler(...).run()`` on N(3, 1) at d=10 with
1024 chains, 300 tuning and 700 posterior draws and
``posterior_kernel="pallas"``: NUTS (``DiagNutsSettings``, kernels K1 and
K2) and MCLMC (``DiagMclmcSettings``, kernels K3 and K4).  For each path it
checks that its kernels ran and that the posterior is right, then times
each kernel against its plain version at the main path's shapes.

Output: the card's name and power limit, the nvcc version, the build time,
the checks and timings, a JSON line ``{"kernels": [...]}`` and, last,
``{"ok": true, "device": {...}}``.  Any failure raises and exits non-zero;
without a CUDA card it exits non-zero before printing a result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

DIM, MU, CHAINS, TUNE, DRAWS, SEED = 10, 3.0, 1024, 300, 700, 0
CHUNK = 128          # the Sampler's chunk: draws per launch on the main path
CHECK_K1_DRAWS = 8   # posterior draws per chain in the kernel check
CHECK_K2_DRAWS = 16  # warmup draws in the kernel check
CHECK_K3_DRAWS = 8   # MCLMC posterior draws per chain in the kernel check
CHECK_K4_DRAWS = 16  # MCLMC warmup draws in each kernel check
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


def posterior_inputs(model, device, seed=1):
    """A post-warmup-like state of the main path's model, made with numpy."""
    rng = np.random.default_rng(seed)
    f = lambda x: torch.as_tensor(x, dtype=torch.float32, device=device)  # noqa: E731
    q = f(MU + rng.normal(size=(CHAINS, DIM)))
    stds = f(rng.uniform(0.8, 1.2, size=(CHAINS, DIM)))
    mean = f(MU + 0.1 * rng.normal(size=(CHAINS, DIM)))
    logp, g = model.logp_and_grad(q)
    logdet = -torch.log(stds).sum(1)
    step = f(rng.uniform(0.8, 1.0, size=CHAINS))
    return q, g, logp, stds, mean, logdet, step, step.clone()


def check_posterior(model, opts, device):
    from nuts_rs_tpu_torch.kernels import nuts_fused as nf

    args = posterior_inputs(model, device)
    out_k = nf.nuts_fused_run(7, *args, CHECK_K1_DRAWS, model, opts, 0.1)
    torch.cuda.synchronize()
    out_p = nf.nuts_fused_run_reference(7, *args, CHECK_K1_DRAWS, model,
                                        opts, 0.1)
    n = require_same_ints(out_k[4], out_p[4], "K1")
    err = close(out_k[3], out_p[3], "K1 draws")
    for i, name in enumerate(("q_f", "g_f", "logp_f")):
        err = max(err, close(out_k[i], out_p[i], f"K1 {name}"))
    for name in nf.STAT_NAMES:
        err = max(err, close(out_k[4][name], out_p[4][name], f"K1 {name}"))
    print(f"K1 check: C={CHAINS} d={DIM} B=32 K={CHECK_K1_DRAWS}: integer "
          f"stats equal on all {n} (chain, draw) entries, max abs err "
          f"{err:.3g} (draws, final state, all stats)")
    return err


def warmup_setup(model, settings, device, lo, hi):
    from nuts_rs_tpu_torch.adapt.schedule import build_schedule
    from nuts_rs_tpu_torch.chain import (
        DiagStrategy, init_chain_state, pack_warmup_state, warmup_flags)
    from nuts_rs_tpu_torch.sampler import _schedule_chunk

    config = settings.chain_config()
    state = init_chain_state(SEED, model, DiagStrategy(config), config,
                             CHAINS, torch.float32, device)
    sched = build_schedule(TUNE, DRAWS, settings.adapt)
    flags = warmup_flags(_schedule_chunk(sched, lo, hi), device)
    est, sca = pack_warmup_state(state)
    t = state.transform
    return (11, flags, state.pt.q, state.pt.g, state.pt.logp,
            t.stds.contiguous(), t.mean.contiguous(), est, sca, model,
            config.nuts, config.step_size, config.use_grad_based_estimate)


def check_warmup(model, settings, device):
    from nuts_rs_tpu_torch.kernels import nuts_fused as nf

    # schedule rows 2.. are the second warmup phase's: estimator updates,
    # mass-matrix updates every draw and the early window switches
    args = warmup_setup(model, settings, device, 2, 2 + CHECK_K2_DRAWS)
    out_k = nf.nuts_fused_warmup_run(*args)
    torch.cuda.synchronize()
    out_p = nf.nuts_fused_warmup_run_reference(*args)
    n = require_same_ints(out_k[8], out_p[8], "K2")
    err = close(out_k[7], out_p[7], "K2 draws")
    for i, name in enumerate(("q", "g", "logp", "stds", "mean", "est",
                              "sca")):
        err = max(err, close(out_k[i], out_p[i], f"K2 {name}"))
    for name in nf.WARMUP_STAT_NAMES:
        err = max(err, close(out_k[8][name], out_p[8][name], f"K2 {name}"))
    print(f"K2 check: C={CHAINS} d={DIM} B=32 K={CHECK_K2_DRAWS} "
          f"(schedule rows 2..{1 + CHECK_K2_DRAWS}): integer stats equal on "
          f"all {n} (chain, draw) entries, max abs err {err:.3g} (draws, "
          "final state, est, sca, all stats)")
    return err


def zero_launch_counts():
    from nuts_rs_tpu_torch.kernels import mclmc_fused as mf
    from nuts_rs_tpu_torch.kernels import nuts_fused as nf

    for counts in (nf.LAUNCHES, mf.LAUNCHES):
        for name in counts:
            counts[name] = 0


def read_launch_counts(counts):
    """The path's own counts, after it ran; each must be at least 1."""
    launches = dict(counts)
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
    warm_s = sum(s for lo, hi, s in sampler.chunk_seconds if lo < TUNE)
    post_s = sum(s for lo, hi, s in sampler.chunk_seconds if lo >= TUNE)
    return trace, init_s, warm_s, post_s


def main_path(model, settings, device):
    from nuts_rs_tpu_torch.kernels import nuts_fused as nf

    zero_launch_counts()
    trace, init_s, warm_s, post_s = run_sampler(model, settings, device)
    launches = read_launch_counts(nf.LAUNCHES)
    pos = trace.posterior["position"].astype(np.float64)
    st = trace.sample_stats
    mean, std = float(pos.mean()), float(pos.std())
    n_div = int(st["diverging"].sum())
    acc = float(st["mean_tree_accept"].mean())
    n_grad = int(st["n_steps"].sum())
    print(f"main path: d={DIM} chains={CHAINS} tune={TUNE} draws={DRAWS}: "
          f"init {init_s:.3f} s, warmup {warm_s:.3f} s, posterior "
          f"{post_s:.3f} s, {n_grad / post_s:.6g} posterior gradient "
          f"evaluations/s ({n_grad} in the posterior), launches {launches}")
    print(f"posterior: mean {mean:.5f} std {std:.5f} divergences {n_div} "
          f"mean accept {acc:.4f} step size "
          f"{float(np.median(st['step_size_bar'][:, -1])):.4f} mean tree "
          f"depth {float(st['depth'].mean()):.3f}")
    if not abs(mean - MU) < 0.02:
        raise AssertionError(f"posterior mean {mean} not within 0.02 of {MU}")
    if not abs(std - 1.0) < 0.05:
        raise AssertionError(f"posterior std {std} not within 0.05 of 1")
    if n_div:
        raise AssertionError(f"{n_div} divergences on an iid normal")
    if not 0.7 < acc < 0.95:
        raise AssertionError(f"mean accept {acc} outside (0.7, 0.95)")
    return launches


def time_kernels(model, settings, device):
    """ms per launch of each kernel and of its plain version, at the main
    path's shapes (1024 chains, d=10, one 128-draw chunk)."""
    from nuts_rs_tpu_torch.kernels import nuts_fused as nf

    opts = settings.nuts_options()
    k1 = posterior_inputs(model, device, seed=2)
    k2 = warmup_setup(model, settings, device, 2, 2 + CHUNK)

    def post():
        nf.nuts_fused_run(3, *k1, CHUNK, model, opts, 0.1)

    def post_plain():
        nf.nuts_fused_run_reference(3, *k1, CHUNK, model, opts, 0.1)

    def warm():
        nf.nuts_fused_warmup_run(*k2)

    def warm_plain():
        nf.nuts_fused_warmup_run_reference(*k2)

    post()
    warm()
    times = {
        "nuts_fused_posterior": (cuda_events_ms(post, 3),
                                 cuda_events_ms(post_plain, 1)),
        "nuts_fused_warmup": (cuda_events_ms(warm, 3),
                              cuda_events_ms(warm_plain, 1)),
    }
    for name, (ms, plain_ms) in times.items():
        print(f"time {name}: kernel {ms:.4f} ms, plain PyTorch {plain_ms:.2f} "
              f"ms per {CHUNK}-draw launch at C={CHAINS} d={DIM}")
    return times


# ---------------------------------------------------------------------------
# MCLMC: kernels K3 (posterior) and K4 (warmup)
# ---------------------------------------------------------------------------


def mclmc_settings():
    from nuts_rs_tpu_torch import DiagMclmcSettings

    return DiagMclmcSettings(num_chains=CHAINS, num_tune=TUNE,
                             num_draws=DRAWS, seed=SEED,
                             posterior_kernel="pallas")


def mclmc_posterior_args(model, settings, device, seed=1):
    """K3's inputs: a post-warmup-like state with unit-sphere velocities."""
    from nuts_rs_tpu_torch import MclmcTrajectoryKind

    q, g, logp, stds, mean, logdet, step, _ = posterior_inputs(
        model, device, seed)
    v = torch.randn(CHAINS, DIM, generator=torch.Generator().manual_seed(
        seed)).to(device)
    v = (v / v.norm(dim=1, keepdim=True)).contiguous()
    bar = torch.full_like(step, settings.step_size)
    mopts = settings._mclmc_options(MclmcTrajectoryKind.MICROCANONICAL)
    return (q, g, logp, v, stds, mean, logdet, step * 0.5, bar), mopts


def check_mclmc_posterior(model, settings, device):
    from nuts_rs_tpu_torch.kernels import mclmc_fused as mf

    args, mopts = mclmc_posterior_args(model, settings, device)
    jitter = settings.step_size_settings.jitter
    out_k = mf.mclmc_fused_run(7, *args, CHECK_K3_DRAWS, model, mopts, jitter)
    torch.cuda.synchronize()
    out_p = mf.mclmc_fused_run_reference(7, *args, CHECK_K3_DRAWS, model,
                                         mopts, jitter)
    n = require_same_ints(out_k[5], out_p[5], "K3", MCLMC_INT_STATS)
    err = close(out_k[4], out_p[4], "K3 draws")
    for i, name in enumerate(("q_f", "g_f", "logp_f", "v_f")):
        err = max(err, close(out_k[i], out_p[i], f"K3 {name}"))
    for name in mf.STAT_NAMES:
        err = max(err, close(out_k[5][name], out_p[5][name], f"K3 {name}"))
    print(f"K3 check: C={CHAINS} d={DIM} B=32 K={CHECK_K3_DRAWS} "
          f"microcanonical: integer stats equal on all {n} (chain, draw) "
          f"entries, max abs err {err:.3g} (draws, final state, all stats)")
    return err


def mclmc_warmup_setup(model, settings, device, lo, hi, kind):
    """K4's inputs for schedule rows lo..hi-1 from the initial state."""
    from nuts_rs_tpu_torch.adapt.schedule import build_schedule
    from nuts_rs_tpu_torch.chain import (
        MCLMC_FLAG_COLUMNS, DiagStrategy, init_chain_state,
        pack_mclmc_warmup_state, warmup_flags)
    from nuts_rs_tpu_torch.sampler import _schedule_chunk

    config = settings.chain_config()
    state = init_chain_state(SEED, model, DiagStrategy(config), config,
                             CHAINS, torch.float32, device)
    sched = build_schedule(TUNE, DRAWS, settings.adapt)
    flags = settings.extra_flags(_schedule_chunk(sched, lo, hi), lo, hi)
    est, sca = pack_mclmc_warmup_state(state)
    t = state.transform
    return (13, warmup_flags(flags, device, MCLMC_FLAG_COLUMNS), state.pt.q,
            state.pt.g, state.pt.logp, state.pt.v, t.stds.contiguous(),
            t.mean.contiguous(), est, sca, model,
            settings._mclmc_options(kind), config.step_size,
            config.use_grad_based_estimate)


def check_mclmc_warmup(model, settings, device):
    """K4 on schedule rows that hold a momentum resample, a window switch
    and mass-matrix updates: from draw 0 with the Euclidean kinetic energy,
    and across the trajectory switch with the microcanonical one."""
    from nuts_rs_tpu_torch import MclmcTrajectoryKind as Kind
    from nuts_rs_tpu_torch.kernels import mclmc_fused as mf

    err, n, rows = 0.0, 0, []
    for lo, kind in ((0, Kind.EUCLIDEAN),
                     (settings.switch_draw - 6, Kind.MICROCANONICAL)):
        hi = lo + CHECK_K4_DRAWS
        args = mclmc_warmup_setup(model, settings, device, lo, hi, kind)
        flags = args[1].cpu().numpy()
        if not (flags[:, mf.FLAG_RESAMPLE].any()
                and flags[:, mf.FLAG_DO_SWITCH].any()):
            raise AssertionError(f"K4 check rows {lo}..{hi - 1} miss the "
                                 "resample or a window switch")
        out_k = mf.mclmc_fused_warmup_run(*args)
        torch.cuda.synchronize()
        out_p = mf.mclmc_fused_warmup_run_reference(*args)
        n += require_same_ints(out_k[9], out_p[9], f"K4 rows {lo}..",
                               MCLMC_INT_STATS + ("transformation_index",))
        err = max(err, close(out_k[8], out_p[8], "K4 draws"))
        for i, name in enumerate(("q", "g", "logp", "v", "stds", "mean",
                                  "est", "sca")):
            err = max(err, close(out_k[i], out_p[i], f"K4 {name}"))
        for name in mf.WARMUP_STAT_NAMES:
            err = max(err, close(out_k[9][name], out_p[9][name],
                                 f"K4 {name}"))
        rows.append(f"{lo}..{hi - 1} {kind.value}")
    print(f"K4 check: C={CHAINS} d={DIM} B=32 K={CHECK_K4_DRAWS}, schedule "
          f"rows {' and '.join(rows)} (each holds a momentum resample and a "
          "window switch): integer stats equal on all "
          f"{n} (chain, draw) entries, max abs err {err:.3g} (draws, final "
          "state, est, sca, all stats)")
    return err


def mclmc_main_path(model, settings, device):
    from nuts_rs_tpu_torch.kernels import mclmc_fused as mf

    zero_launch_counts()
    trace, init_s, warm_s, post_s = run_sampler(model, settings, device)
    launches = read_launch_counts(mf.LAUNCHES)
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


def time_mclmc_kernels(model, settings, device):
    """ms per 128-draw launch of K3 and K4 and of their plain versions at
    the main path's shapes (1024 chains, d=10; K4 on the microcanonical
    warmup rows from the trajectory switch)."""
    from nuts_rs_tpu_torch import MclmcTrajectoryKind
    from nuts_rs_tpu_torch.kernels import mclmc_fused as mf

    args, mopts = mclmc_posterior_args(model, settings, device, seed=2)
    jitter = settings.step_size_settings.jitter
    sw = settings.switch_draw
    k4 = mclmc_warmup_setup(model, settings, device, sw, sw + CHUNK,
                            MclmcTrajectoryKind.MICROCANONICAL)

    def post():
        mf.mclmc_fused_run(3, *args, CHUNK, model, mopts, jitter)

    def post_plain():
        mf.mclmc_fused_run_reference(3, *args, CHUNK, model, mopts, jitter)

    def warm():
        mf.mclmc_fused_warmup_run(*k4)

    def warm_plain():
        mf.mclmc_fused_warmup_run_reference(*k4)

    post()
    warm()
    times = {
        "mclmc_fused_posterior": (cuda_events_ms(post, 3),
                                  cuda_events_ms(post_plain, 1)),
        "mclmc_fused_warmup": (cuda_events_ms(warm, 3),
                               cuda_events_ms(warm_plain, 1)),
    }
    for name, (ms, plain_ms) in times.items():
        print(f"time {name}: kernel {ms:.4f} ms, plain PyTorch {plain_ms:.2f} "
              f"ms per {CHUNK}-draw launch at C={CHAINS} d={DIM}")
    return times


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA card "
                           "(torch.cuda.is_available() is false)")
    from nuts_rs_tpu_torch import DiagNutsSettings
    from nuts_rs_tpu_torch.kernels import _build
    from nuts_rs_tpu_torch.models.gaussian import normal_logp

    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(card_line())
    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                          text=True, check=True, timeout=60)
    print(f"nvcc: {nvcc.stdout.strip().splitlines()[-1]}; torch "
          f"{torch.__version__} (CUDA {torch.version.cuda})")
    t0 = time.monotonic()
    _build.library()
    print(f"build: {time.monotonic() - t0:.1f} s ({_build.BUILD_INFO['library']})")
    log = (_build.BUILD_DIR / "build.log")
    if log.exists():
        for line in log.read_text().splitlines():
            if "Used" in line or "spill" in line:
                print("  ptxas: " + line.strip().removeprefix("ptxas info    : "))

    model = normal_logp(DIM, MU)
    settings = DiagNutsSettings(num_chains=CHAINS, num_tune=TUNE,
                                num_draws=DRAWS, seed=SEED,
                                posterior_kernel="pallas")
    err1 = check_posterior(model, settings.nuts_options(), device)
    err2 = check_warmup(model, settings, device)
    launches = main_path(model, settings, device)
    times = time_kernels(model, settings, device)

    msettings = mclmc_settings()
    err3 = check_mclmc_posterior(model, msettings, device)
    err4 = check_mclmc_warmup(model, msettings, device)
    launches.update(mclmc_main_path(model, msettings, device))
    times.update(time_mclmc_kernels(model, msettings, device))

    kernels = [
        {"name": "nuts_fused_posterior", "route": "cuda",
         "source": "nuts_rs_tpu_torch/csrc/nuts_fused_posterior.cu",
         "replaces": "nuts_rs_tpu/kernels/nuts_pallas.py:82",
         "launches": launches["nuts_fused_posterior"], "max_abs_err": err1,
         "ms": times["nuts_fused_posterior"][0],
         "plain_ms": times["nuts_fused_posterior"][1]},
        {"name": "nuts_fused_warmup", "route": "cuda",
         "source": "nuts_rs_tpu_torch/csrc/nuts_fused_warmup.cu",
         "replaces": "nuts_rs_tpu/kernels/nuts_pallas.py:942",
         "launches": launches["nuts_fused_warmup"], "max_abs_err": err2,
         "ms": times["nuts_fused_warmup"][0],
         "plain_ms": times["nuts_fused_warmup"][1]},
        {"name": "mclmc_fused_posterior", "route": "cuda",
         "source": "nuts_rs_tpu_torch/csrc/mclmc_fused_posterior.cu",
         "replaces": "nuts_rs_tpu/kernels/mclmc_pallas.py:59",
         "launches": launches["mclmc_fused_posterior"], "max_abs_err": err3,
         "ms": times["mclmc_fused_posterior"][0],
         "plain_ms": times["mclmc_fused_posterior"][1]},
        {"name": "mclmc_fused_warmup", "route": "cuda",
         "source": "nuts_rs_tpu_torch/csrc/mclmc_fused_warmup.cu",
         "replaces": "nuts_rs_tpu/kernels/mclmc_pallas.py:504",
         "launches": launches["mclmc_fused_warmup"], "max_abs_err": err4,
         "ms": times["mclmc_fused_warmup"][0],
         "plain_ms": times["mclmc_fused_warmup"][1]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
