#!/usr/bin/env python3
"""Reference posterior moments of ``logistic_regression(rows, 100, seed=0)``
from the JAX package's sync engines on the CPU: NUTS (the default) or, with
``--sampler mclmc``, unadjusted MCLMC under ``DiagMclmcSettings``, whose
posterior carries its own small bias and so has a file of its own.  ``--rows``
sets the rows of data (default 1000); 131072 is the streamed-data model,
whose file is ``logreg_big_reference.json``.

    python3 tests/data/make_logreg_d100_reference.py \
        --chains 128 --tune 300 --draws 500 --out tests/data/logreg_d100_reference.json
    python3 tests/data/make_logreg_d100_reference.py --sampler mclmc \
        --chains 128 --tune 300 --draws 500 --out tests/data/mclmc_logreg_d100_reference.json
    python3 tests/data/make_logreg_d100_reference.py --rows 131072 \
        --chains 32 --tune 300 --draws 300 --out tests/data/logreg_big_reference.json

Writes, as text, the per-coordinate posterior mean and standard deviation
(float64 moments over all chains and draws) with the settings and the run's
diagnostics.  ``chip_smoke.py`` holds the PyTorch/CUDA port's runs of the
same model against these numbers; the port itself never imports JAX.
"""

import argparse
import json
import os
import sys
from pathlib import Path

os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import nuts_rs_tpu as nt  # noqa: E402
from nuts_rs_tpu.models.gaussian import logistic_regression  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--chains", type=int, default=128)
    ap.add_argument("--tune", type=int, default=300)
    ap.add_argument("--draws", type=int, default=500)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rows", type=int, default=1000)
    ap.add_argument("--sampler", choices=("nuts", "mclmc"), default="nuts")
    ap.add_argument("--out", default=None)
    a = ap.parse_args()
    mclmc = a.sampler == "mclmc"
    stem = "logreg_d100" if a.rows == 1000 else (
        "logreg_big" if a.rows == 131072 else f"logreg_n{a.rows}")
    out_path = a.out or str(Path(__file__).with_name(
        ("mclmc_" if mclmc else "") + stem + "_reference.json"))
    model = logistic_regression(n_data=a.rows, dim=100, seed=0)
    make = nt.DiagMclmcSettings if mclmc else nt.DiagNutsSettings
    settings = make(num_chains=a.chains, num_tune=a.tune, num_draws=a.draws,
                    seed=a.seed, posterior_kernel="sync")
    trace = nt.sample(model, settings)
    pos = np.asarray(trace.posterior["position"], np.float64)
    st = trace.sample_stats
    flat = pos.reshape(-1, pos.shape[-1])
    # spread of the chain means, in posterior standard deviations: the
    # Monte-Carlo error of `mean` is about this over sqrt(chains)
    chain_means = pos.mean(1)
    if mclmc:
        engine = ("nuts_rs_tpu (JAX package), DiagMclmcSettings, "
                  "posterior_kernel='sync', CPU")
        sampler_stats = {
            "step_size": settings.step_size,
            "momentum_decoherence_length":
                settings.momentum_decoherence_length,
            "mean_abs_energy_change": float(np.abs(np.asarray(
                st["energy_change"])).mean()),
        }
    else:
        engine = "nuts_rs_tpu (JAX package), posterior_kernel='sync', CPU"
        sampler_stats = {
            "mean_tree_accept": float(np.asarray(
                st["mean_tree_accept"]).mean()),
            "median_step_size_bar": float(np.median(
                np.asarray(st["step_size_bar"])[:, -1])),
        }
    out = {
        "model": f"logistic_regression(n_data={a.rows}, dim=100, seed=0)",
        "engine": engine,
        "command": "python3 tests/data/make_logreg_d100_reference.py "
                   + ("--sampler mclmc " if mclmc else "")
                   + (f"--rows {a.rows} " if a.rows != 1000 else "")
                   + f"--chains {a.chains} --tune {a.tune} --draws {a.draws} "
                   f"--seed {a.seed}",
        "chains": a.chains, "tune": a.tune, "draws": a.draws, "seed": a.seed,
        "divergences": int(np.asarray(st["diverging"]).sum()),
        "mean_n_steps": float(np.asarray(st["n_steps"]).mean()),
        **sampler_stats,
        "max_mc_error_of_mean_in_std": float(np.max(
            chain_means.std(0) / flat.std(0) / np.sqrt(a.chains))),
        "mean": [float(x) for x in flat.mean(0)],
        "std": [float(x) for x in flat.std(0)],
    }
    Path(out_path).write_text(json.dumps(out, indent=1) + "\n")
    print(json.dumps({k: v for k, v in out.items()
                      if k not in ("mean", "std")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
