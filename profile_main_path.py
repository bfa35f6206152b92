#!/usr/bin/env python3
"""Where the time of the port's main paths goes, on one CUDA card.

Run from the repository root on a machine with one NVIDIA GPU:

    python3 profile_main_path.py [--repeats 3] [--trace trace.json]

The paths are chip_smoke.py's: ``Sampler(...)`` and ``run()`` on N(3, 1)
at d=10 with 1024 chains, 300 tuning and 700 posterior draws,
``posterior_kernel="pallas"``, with ``DiagNutsSettings`` (kernels K1, K2)
and with ``DiagMclmcSettings`` (K3, K4).  After building the kernels it
prints, for each path,

1. for ``--repeats`` unprofiled runs: the total seconds, Sampler
   construction (init and init search), and for every chunk the runner's
   host seconds, the wait for the device after it and the rest of the
   chunk (stats to the host and into storage), then ``finalize``;
2. for one run under ``torch.profiler``: the device time per kernel or
   copy, and the device's busy share of the profiled wall (``--trace``
   also writes a Chrome trace, one file per path);
3. each kernel's milliseconds per 128-draw launch at chain blocks
   B = 8 ... 128 (CUDA events, same inputs), and at B = 32 the fused
   posterior's loop iterations per block and leapfrogs per draw.

The card's name and power limit come first.  Every number is this run's.
"""

from __future__ import annotations

import argparse
import collections
import time

import numpy as np
import torch

from chip_smoke import (
    CHAINS, CHUNK, DIM, DRAWS, MU, SEED, TUNE, card_line, cuda_events_ms,
    mclmc_posterior_args, mclmc_settings, mclmc_warmup_setup,
    posterior_inputs, warmup_setup)

BLOCKS = (8, 16, 32, 64, 128)


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


def print_run(label, result):
    total_s, init_s, chunks, finalize_s, trace = result
    warm = int(trace.warmup_sample_stats["n_steps"].sum())
    post = int(trace.sample_stats["n_steps"].sum())
    post_s = sum(c[2] + c[3] + c[4] for c in chunks if c[0] >= TUNE)
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


def nuts_launches(model, settings, device):
    """(posterior, warmup) launches of K1 and K2 at a chain block B, and
    K1's stats, on the main path's shapes."""
    from nuts_rs_tpu_torch.kernels import nuts_fused as nf

    opts = settings.nuts_options()
    k1 = posterior_inputs(model, device, seed=2)
    k2 = warmup_setup(model, settings, device, 2, 2 + CHUNK)
    return (lambda B: nf.nuts_fused_run(3, *k1, CHUNK, model, opts, 0.1,
                                        B)[4],
            lambda B: nf.nuts_fused_warmup_run(*k2, B))


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


def sweep_blocks(launches):
    """ms per 128-draw launch of each kernel at every chain block size."""
    post, warm = launches
    for B in BLOCKS:
        post(B)
        warm(B)
        print(f"B={B}: blocks {CHAINS // B}, posterior "
              f"{cuda_events_ms(lambda: post(B), 3):.4f} ms, warmup "
              f"{cuda_events_ms(lambda: warm(B), 3):.4f} ms per "
              f"{CHUNK}-draw launch")
    out = post(32)
    iters = out["loop_iterations"].cpu().numpy()
    print(f"posterior loop iterations per block (B=32): min {iters.min()} "
          f"max {iters.max()}; leapfrogs per draw mean "
          f"{float(np.mean(out['n_steps'].cpu().numpy())):.4f}")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--repeats", type=int, default=3)
    parser.add_argument("--trace", help="write a Chrome trace here")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("profile_main_path.py needs a CUDA card")
    from nuts_rs_tpu_torch import DiagNutsSettings
    from nuts_rs_tpu_torch.kernels import _build
    from nuts_rs_tpu_torch.models.gaussian import normal_logp

    device = torch.device("cuda", 0)
    print(card_line())
    _build.library()
    model = normal_logp(DIM, MU)
    nuts = DiagNutsSettings(num_chains=CHAINS, num_tune=TUNE,
                            num_draws=DRAWS, seed=SEED,
                            posterior_kernel="pallas")
    for label, settings, launches in (("NUTS", nuts, nuts_launches),
                                      ("MCLMC", mclmc_settings(),
                                       mclmc_launches)):
        print(f"== {label} path")
        run_main_path(model, settings, device)  # first launches, allocator
        for rep in range(args.repeats):
            print_run(f"run {rep}", run_main_path(model, settings, device))
        trace = (args.trace.replace(".json", f"_{label.lower()}.json")
                 if args.trace else None)
        profile_once(model, settings, device, trace)
        sweep_blocks(launches(model, settings, device))
    print(card_line())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
