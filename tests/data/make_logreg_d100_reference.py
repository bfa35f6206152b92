#!/usr/bin/env python3
"""Reference posterior moments of ``logistic_regression(1000, 100, seed=0)``
from the JAX package's sync NUTS engine on the CPU.

    python3 tests/data/make_logreg_d100_reference.py \
        --chains 128 --tune 300 --draws 500 --out tests/data/logreg_d100_reference.json

Writes, as text, the per-coordinate posterior mean and standard deviation
(float64 moments over all chains and draws) with the settings and the run's
diagnostics.  ``chip_smoke.py`` holds the PyTorch/CUDA port's run of the
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
    ap.add_argument("--out", default=str(Path(__file__).with_name(
        "logreg_d100_reference.json")))
    a = ap.parse_args()
    model = logistic_regression(n_data=1000, dim=100, seed=0)
    settings = nt.DiagNutsSettings(num_chains=a.chains, num_tune=a.tune,
                                   num_draws=a.draws, seed=a.seed,
                                   posterior_kernel="sync")
    trace = nt.sample(model, settings)
    pos = np.asarray(trace.posterior["position"], np.float64)
    st = trace.sample_stats
    flat = pos.reshape(-1, pos.shape[-1])
    # spread of the chain means, in posterior standard deviations: the
    # Monte-Carlo error of `mean` is about this over sqrt(chains)
    chain_means = pos.mean(1)
    out = {
        "model": "logistic_regression(n_data=1000, dim=100, seed=0)",
        "engine": "nuts_rs_tpu (JAX package), posterior_kernel='sync', CPU",
        "command": "python3 tests/data/make_logreg_d100_reference.py "
                   f"--chains {a.chains} --tune {a.tune} --draws {a.draws} "
                   f"--seed {a.seed}",
        "chains": a.chains, "tune": a.tune, "draws": a.draws, "seed": a.seed,
        "divergences": int(np.asarray(st["diverging"]).sum()),
        "mean_tree_accept": float(np.asarray(st["mean_tree_accept"]).mean()),
        "mean_n_steps": float(np.asarray(st["n_steps"]).mean()),
        "median_step_size_bar": float(np.median(
            np.asarray(st["step_size_bar"])[:, -1])),
        "max_mc_error_of_mean_in_std": float(np.max(
            chain_means.std(0) / flat.std(0) / np.sqrt(a.chains))),
        "mean": [float(x) for x in flat.mean(0)],
        "std": [float(x) for x in flat.std(0)],
    }
    Path(a.out).write_text(json.dumps(out, indent=1) + "\n")
    print(json.dumps({k: v for k, v in out.items()
                      if k not in ("mean", "std")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
