#!/usr/bin/env python3
"""Reference posterior of the flow path from the JAX package's sync NUTS
engine on the CPU: ``funnel(10)`` under ``FlowNutsSettings`` with the
built-in coupling flow at its default ``CouplingFlowConfig`` (4 layers of 32
hidden units), at the settings of ``chip_smoke.py``'s flow path, warmup and
posterior both on the sync engine (``posterior_kernel="sync"``):

    python3 tests/data/make_flow_reference.py \
        --chains 64 --tune 30 --draws 512 --replicates 8 \
        --out tests/data/flow_funnel_reference.json

Writes, as text, for v = q[0] and every x_i = q[i] the posterior mean and
standard deviation (float64 moments over the draws) with their Monte-Carlo
errors (``make_zoo_reference.moments``: the error of the mean in posterior
standard deviations, ``1 / sqrt(ESS)``, and the relative error of the
standard deviation), the divergence share and its standard error over the
chains, the mean acceptance, leapfrogs a draw, the number of refits the
warmup made (``transformation_index`` of the last warmup draw: every refit
bumps it, kept or not) and whether a kept one moved the nets off the
identity, and v's analytic marginal N(0, 3) beside its moments.  The same
moments and errors go in for u_i = x_i e^(-v/2), i = 1..9 (``u_*``): under
the target u_i is N(0, 1) whatever v is, so its tails are light where
x_i's are not, and it holds the x_i given v as v's moments hold v.

With ``--replicates R`` it runs the same settings at seeds ``seed`` ...
``seed + R - 1`` and adds their spread (``replicates``): each run's
per-coordinate means and standard deviations and divergence share, their
averages over the runs, and the run-to-run standard deviation of a
coordinate's mean (in posterior standard deviations) and of its standard
deviation (relative), and the same for u_i (``u_*``).  That spread is a
run's own error as a whole: every run trains its own flow in its warmup,
which decides how well it reaches the funnel's neck and mouth, and the
x_i's heavy tails make one run's ESS-based error of a standard deviation
far too small (seeds 0-3: x_i's standard deviation from 5.1 to 14.7
between runs, against an ESS error of at most 16% within one).
``chip_smoke.py`` holds the
PyTorch/CUDA port's run of the same configuration against these numbers;
the port itself never imports JAX.
"""

import argparse
import json
import os
import sys
import time
from pathlib import Path

os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
sys.path.insert(0, str(Path(__file__).resolve().parent))

import nuts_rs_tpu as nt  # noqa: E402
from make_zoo_reference import moments  # noqa: E402
from nuts_rs_tpu.models.gaussian import funnel  # noqa: E402


def u_draws(pos):
    """u_i = x_i e^(-v/2), i = 1 .. d-1: N(0, 1) under the funnel, whatever
    v is."""
    return pos[..., 1:] * np.exp(-0.5 * pos[..., :1])


def spread(runs, key):
    """Average over the runs of their per-coordinate means and stds under
    ``key``, and the run-to-run standard deviation of a mean (in the
    average std) and of a std (relative)."""
    means = np.array([r[key + "mean"] for r in runs])
    stds = np.array([r[key + "std"] for r in runs])
    avg_std = stds.mean(0)
    return {key + "mean": means.mean(0).tolist(),
            key + "std": avg_std.tolist(),
            key + "sd_of_mean_in_std": (means.std(0, ddof=1)
                                        / avg_std).tolist(),
            key + "sd_of_std": (stds.std(0, ddof=1) / avg_std).tolist()}


def replicates(a, pos0, div0):
    """The run-to-run spread over seeds a.seed .. a.seed + R - 1 (the first
    is the run already made: its draws ``pos0``, divergences ``div0``)."""
    runs = []
    for r in range(a.replicates):
        if r == 0:
            pos, div = pos0, float(div0.mean())
        else:
            trace = nt.sample(funnel(10), nt.FlowNutsSettings(
                num_chains=a.chains, num_tune=a.tune, num_draws=a.draws,
                seed=a.seed + r, posterior_kernel="sync"))
            pos = np.asarray(trace.posterior["position"], np.float64)
            div = float(np.asarray(trace.sample_stats["diverging"]).mean())
        flat = pos.reshape(-1, pos.shape[-1])
        u = u_draws(flat)
        runs.append({"seed": a.seed + r, "mean": flat.mean(0).tolist(),
                     "std": flat.std(0).tolist(),
                     "u_mean": u.mean(0).tolist(), "u_std": u.std(0).tolist(),
                     "divergence_share": div})
        print(json.dumps(runs[-1]), flush=True)
    return {"seeds": [r["seed"] for r in runs], "runs": runs,
            **spread(runs, ""), **spread(runs, "u_")}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--chains", type=int, default=64)
    ap.add_argument("--tune", type=int, default=30)
    ap.add_argument("--draws", type=int, default=512)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--replicates", type=int, default=1)
    ap.add_argument("--out", default=str(Path(__file__).with_name(
        "flow_funnel_reference.json")))
    a = ap.parse_args()
    settings = nt.FlowNutsSettings(num_chains=a.chains, num_tune=a.tune,
                                   num_draws=a.draws, seed=a.seed,
                                   posterior_kernel="sync")
    t0 = time.time()
    sampler = nt.Sampler(funnel(10), settings)
    trace = sampler.run()
    seconds = time.time() - t0
    pos = np.asarray(trace.posterior["position"], np.float64)
    st = {k: np.asarray(v) for k, v in trace.sample_stats.items()}
    wst = {k: np.asarray(v) for k, v in trace.warmup_sample_stats.items()}
    div = st["diverging"].astype(np.float64)
    coords = [moments(pos[..., j]) for j in range(pos.shape[-1])]
    u = u_draws(pos)
    u_coords = [moments(u[..., j]) for j in range(u.shape[-1])]
    tid = wst["transformation_index"][:, -1]
    # refits that changed the flow: the last warmup draw's parameters are
    # not the first's (a refused refit keeps them)
    params = sampler.state.transform.params
    changed = float(np.abs(np.asarray(
        params["layers"][0]["net"]["w2"])).max()) > 0.0
    out = {
        "model": "funnel(10)",
        "settings": (f"FlowNutsSettings(num_chains={a.chains}, num_tune="
                     f"{a.tune}, num_draws={a.draws}, seed={a.seed}, "
                     "posterior_kernel='sync'), coupling_flow() "
                     "(4 layers, 32 hidden)"),
        "engine": "nuts_rs_tpu (JAX package), posterior_kernel='sync', CPU",
        "command": (f"python3 tests/data/make_flow_reference.py --chains "
                    f"{a.chains} --tune {a.tune} --draws {a.draws} "
                    f"--seed {a.seed}"),
        "chains": a.chains, "tune": a.tune, "draws": a.draws,
        "seed": a.seed, "seconds": seconds,
        "refits": int(tid.max()),
        "flow_changed_from_identity_nets": bool(changed),
        "divergences": int(div.sum()),
        "divergence_share": float(div.mean()),
        "divergence_share_mc_error": float(
            div.mean(1).std(ddof=1) / np.sqrt(len(div))),
        "warmup_divergence_share": float(wst["diverging"].mean()),
        "mean_tree_accept": float(st["mean_tree_accept"].mean()),
        "mean_n_steps": float(st["n_steps"].mean()),
        "warmup_mean_n_steps": float(wst["n_steps"].mean()),
        "median_step_size": float(np.median(st["step_size_bar"][:, -1])),
        "v_analytic": {"mean": 0.0, "std": 3.0},
        "max_mc_error_of_mean_in_std": max(c[2] for c in coords),
        "max_mc_error_of_std": max(c[3] for c in coords),
        "mean": [c[0] for c in coords],
        "std": [c[1] for c in coords],
        "mc_error_of_mean_in_std": [c[2] for c in coords],
        "mc_error_of_std": [c[3] for c in coords],
        "u_analytic": {"mean": 0.0, "std": 1.0},
        "u_mean": [c[0] for c in u_coords],
        "u_std": [c[1] for c in u_coords],
        "u_mc_error_of_mean_in_std": [c[2] for c in u_coords],
        "u_mc_error_of_std": [c[3] for c in u_coords],
    }
    if a.replicates > 1:
        out["command"] += f" --replicates {a.replicates}"
        out["replicates"] = replicates(a, pos, div)
    Path(a.out).write_text(json.dumps(out, indent=1) + "\n")
    print(json.dumps({k: v for k, v in out.items()
                      if not k.endswith(("mean", "std", "in_std",
                                         "of_std"))}))
    print("v", coords[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
