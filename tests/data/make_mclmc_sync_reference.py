#!/usr/bin/env python3
"""Reference posterior moments of ``normal_logp(dim, 3.0)`` under unadjusted
MCLMC from the JAX package's sync MCLMC engine on the CPU
(``DiagMclmcSettings``, ``posterior_kernel="sync"``), whose posterior
carries the sampler's own small bias, so the port's runs are held against
it and not against the analytic N(3, 1).

    python3 tests/data/make_mclmc_sync_reference.py --dim 400 \
        --chains 512 --tune 200 --draws 300 \
        --out tests/data/mclmc_normal_d400_reference.json

Writes, as text, the per-coordinate posterior mean and standard deviation
(float64 moments over all chains and draws) with the settings, the run's
diagnostics and the Monte-Carlo error of the means: the spread of the chain
means over the square root of the chains, in posterior standard deviations,
the largest over the coordinates.  ``chip_smoke.py`` (the ``mclmc_d400``
path) holds the PyTorch/CUDA port's run of the same model and settings
against these numbers; the port itself never imports JAX.
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

import nuts_rs_tpu as nt  # noqa: E402
from nuts_rs_tpu.models.gaussian import normal_logp  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dim", type=int, default=400)
    ap.add_argument("--chains", type=int, default=512)
    ap.add_argument("--tune", type=int, default=200)
    ap.add_argument("--draws", type=int, default=300)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    a = ap.parse_args()
    out_path = a.out or str(Path(__file__).with_name(
        f"mclmc_normal_d{a.dim}_reference.json"))
    settings = nt.DiagMclmcSettings(num_chains=a.chains, num_tune=a.tune,
                                    num_draws=a.draws, seed=a.seed,
                                    posterior_kernel="sync")
    t0 = time.monotonic()
    trace = nt.sample(normal_logp(a.dim, 3.0), settings, chunk_size=100)
    seconds = time.monotonic() - t0
    pos = np.asarray(trace.posterior["position"], np.float64)
    st = trace.sample_stats
    flat = pos.reshape(-1, pos.shape[-1])
    chain_means = pos.mean(1)
    out = {
        "model": f"normal_logp({a.dim}, 3.0)",
        "engine": ("nuts_rs_tpu (JAX package), DiagMclmcSettings, "
                   "posterior_kernel='sync', CPU, float32"),
        "command": "python3 tests/data/make_mclmc_sync_reference.py "
                   f"--dim {a.dim} --chains {a.chains} --tune {a.tune} "
                   f"--draws {a.draws} --seed {a.seed}",
        "chains": a.chains, "tune": a.tune, "draws": a.draws, "seed": a.seed,
        "seconds": seconds,
        "divergences": int(np.asarray(st["diverging"]).sum()),
        "mean_n_steps": float(np.asarray(st["n_steps"]).mean()),
        "mean_abs_energy_change": float(np.abs(np.asarray(
            st["energy_change"])).mean()),
        "pooled_mean": float(flat.mean()), "pooled_std": float(flat.std()),
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
