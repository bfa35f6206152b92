#!/usr/bin/env python3
"""Reference posterior moments of the model zoo's two data-carrying models
from the JAX package's sync NUTS engine on the CPU:
``stochastic_volatility(T=1000, seed=0)`` (d = 1002) and ``radon()`` (J = 85
groups of 12 rows, d = 89).

    python3 tests/data/make_zoo_reference.py --model sv \
        --chains 64 --tune 400 --draws 400 --out tests/data/sv_t1000_reference.json
    python3 tests/data/make_zoo_reference.py --model radon \
        --chains 64 --tune 400 --draws 500 --out tests/data/radon_reference.json
    python3 tests/data/make_zoo_reference.py --model sv --far-starts \
        --out tests/data/sv_t1000_reference.json

``--far-starts`` adds to an existing SV reference the chains that the
PyTorch port's own ``Sampler`` (``nuts_rs_tpu_torch``, seed 0, the 512
chains of ``chip_smoke.py``) starts far out in log sigma, ``q0 > 0``
(sigma above ten times its prior mean), run from those very points by the
JAX package's sync engine with the settings of ``chip_smoke.py``'s SV path
(400 tuning, 300 posterior draws, seed 0, no ``fail_after``), and which of
them stay stuck where they started (``far_starts``: their indices among the
512, ``stuck``, the starts where the JAX model's own float32 gradient is not
finite, and their seconds).  ``chip_smoke.py`` holds the port's stuck
chains against those (McNemar's test over the matched starts).

Writes, as text, the chains stuck where they started (``stuck_chains``:
SV's far starts in log sigma make them, in both packages' samplers), and
over the other chains the
divergence share with its standard error over the chains and the posterior
mean and standard deviation (float64 moments over their draws) of every coordinate and of the model's named
quantities (SV: ``sigma = exp(q0)``, ``nu = exp(q1)``; radon: ``mu_a``,
``beta``, ``sigma = exp(q2)``, ``sigma_a = exp(q3)``), each with its
Monte-Carlo error in posterior standard deviations: the error of the mean is
``1 / sqrt(ESS)`` of the draws, the relative error of the standard deviation
``sd((x - mean)^2) / (2 var sqrt(ESS'))`` with ``ESS'`` that of the squared
deviations.  The ESS is the Geyer initial-monotone-sequence estimate over
split chains, a copy of ``nuts_rs_tpu/diagnostics.py::_ess_from_matrix``
without the rank normalisation (the errors are those of plain moments).
``chip_smoke.py`` holds the PyTorch/CUDA port's runs of the same models
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
from nuts_rs_tpu.models.hierarchical import radon  # noqa: E402
from nuts_rs_tpu.models.stochastic_volatility import (  # noqa: E402
    stochastic_volatility,
)


def _split_chains(x):
    c, k = x.shape
    half = k // 2
    return np.concatenate([x[:, :half], x[:, k - half:]], axis=0)


def _ess(z):
    """Geyer initial-monotone-sequence ESS of z [C, n] (a copy of the JAX
    package's ``diagnostics._ess_from_matrix``)."""
    c, n = z.shape
    if n < 4 or not np.isfinite(z).all() or np.ptp(z) == 0.0:
        return float("nan")
    xc = z - z.mean(axis=1, keepdims=True)
    m = 1 << int(np.ceil(np.log2(2 * n)))
    f = np.fft.rfft(xc, m, axis=1)
    acov = np.fft.irfft(f * np.conj(f), m, axis=1)[:, :n].real / n
    chain_mean = z.mean(axis=1)
    mean_var = acov[:, 0].mean() * n / (n - 1.0)
    var_plus = mean_var * (n - 1.0) / n
    if c > 1:
        var_plus += chain_mean.var(ddof=1)
    if var_plus == 0.0:
        return float("nan")
    rho = np.zeros(n)
    rho[0] = 1.0
    rho_even = 1.0
    rho_odd = 1.0 - (mean_var - acov[:, 1].mean()) / var_plus
    rho[1] = rho_odd
    t = 1
    while t < n - 3 and (rho_even + rho_odd) > 0.0:
        rho_even = 1.0 - (mean_var - acov[:, t + 1].mean()) / var_plus
        rho_odd = 1.0 - (mean_var - acov[:, t + 2].mean()) / var_plus
        if (rho_even + rho_odd) >= 0.0:
            rho[t + 1] = rho_even
            rho[t + 2] = rho_odd
        t += 2
    max_t = t - 2
    if rho_even > 0.0:
        rho[max_t + 1] = rho_even
    t = 1
    while t <= max_t - 2:
        if rho[t + 1] + rho[t + 2] > rho[t - 1] + rho[t]:
            rho[t + 1] = (rho[t - 1] + rho[t]) / 2.0
            rho[t + 2] = rho[t + 1]
        t += 2
    tau = -1.0 + 2.0 * rho[: max_t + 1].sum() + rho[max_t + 1]
    tau = max(tau, 1.0 / np.log10(c * n + 10.0))
    return float(c * n / tau)


def moments(x):
    """(mean, std, MC error of the mean in std, relative MC error of the
    std) of draws x [chain, draw]."""
    x = np.asarray(x, np.float64)
    mean, std = x.mean(), x.std()
    ess_mean = _ess(_split_chains(x))
    dev2 = (x - mean) ** 2
    ess_sq = _ess(_split_chains(dev2))
    err_std = dev2.std() / (2.0 * std * std * np.sqrt(ess_sq))
    return float(mean), float(std), float(1.0 / np.sqrt(ess_mean)), \
        float(err_std)


def stuck_chains(pos):
    """Chains that stay where they are: a chain whose own posterior standard
    deviation of the first coordinate is under a hundredth of the median of
    the chains' (SV: a start far out in log sigma, where every tree
    diverges and the step adapts to nothing; both packages' samplers leave
    such a start stuck).  Such chains are counted and left out of every
    moment (the same rule as chip_smoke.py's)."""
    sd = pos[..., 0].std(1)
    return sd < 0.01 * np.median(sd)


PORT_CHAINS, PORT_TUNE, PORT_DRAWS = 512, 400, 300


def far_starts(out_path, seed):
    """The JAX sync engine from the port's seed-``seed`` starts that lie
    beyond log sigma 0, recorded into the reference at ``out_path``."""
    import torch
    from nuts_rs_tpu_torch import DiagNutsSettings as TorchSettings
    from nuts_rs_tpu_torch import Sampler as TorchSampler
    from nuts_rs_tpu_torch.models.stochastic_volatility import (
        stochastic_volatility as torch_sv)

    torch.set_num_threads(1)
    port = TorchSampler(torch_sv(T=1000, seed=0), TorchSettings(
        num_chains=PORT_CHAINS, num_tune=PORT_TUNE, num_draws=PORT_DRAWS,
        seed=seed, posterior_kernel="pallas"), device="cpu")
    q0 = port.state.pt.q.numpy()
    far = np.nonzero(q0[:, 0] > 0.0)[0]
    model = stochastic_volatility(T=1000, seed=0)
    # the JAX model's own float32 gradient at each start: where it is not
    # finite the engine cannot move (and the JAX package's init would have
    # drawn that start again)
    _, g = jax.vmap(jax.value_and_grad(model.logp_fn))(q0[far])
    grad_finite = np.isfinite(np.asarray(g)).all(1)
    settings = nt.DiagNutsSettings(num_chains=len(far), num_tune=PORT_TUNE,
                                   num_draws=PORT_DRAWS, seed=seed,
                                   posterior_kernel="sync")
    t0 = time.time()
    trace = nt.sample(model, settings, init_positions=q0[far],
                      fail_after=None)
    seconds = time.time() - t0
    pos = np.asarray(trace.posterior["position"], np.float64)
    stuck = stuck_chains(pos)
    ref = json.loads(Path(out_path).read_text())
    ref["far_starts"] = {
        "rule": f"q0 > 0 at the port's seed-{seed} starts of {PORT_CHAINS} "
                "chains",
        "command": "python3 tests/data/make_zoo_reference.py --model sv "
                   f"--far-starts --seed {seed}",
        "engine": "nuts_rs_tpu (JAX package), posterior_kernel='sync', CPU, "
                  "init_positions from nuts_rs_tpu_torch.Sampler",
        "port_chains": PORT_CHAINS, "tune": PORT_TUNE, "draws": PORT_DRAWS,
        "seed": seed, "seconds": seconds,
        "chains": far.tolist(),
        "start_log_sigma": q0[far, 0].astype(np.float64).tolist(),
        "stuck": far[stuck].tolist(),
        "jax_f32_gradient_not_finite": far[~grad_finite].tolist(),
        "chain_std_of_q0": pos[..., 0].std(1).tolist(),
        "chain_divergence_share": np.asarray(
            trace.sample_stats["diverging"], np.float64).mean(1).tolist(),
    }
    Path(out_path).write_text(json.dumps(ref, indent=1) + "\n")
    print(json.dumps({k: v for k, v in ref["far_starts"].items()
                      if k not in ("chain_std_of_q0", "start_log_sigma",
                                   "chain_divergence_share")}))
    return 0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", choices=("sv", "radon"), required=True)
    ap.add_argument("--chains", type=int, default=64)
    ap.add_argument("--tune", type=int, default=400)
    ap.add_argument("--draws", type=int, default=500)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--far-starts", action="store_true")
    a = ap.parse_args()
    if a.far_starts:
        return far_starts(a.out or str(Path(__file__).with_name(
            "sv_t1000_reference.json")), a.seed)
    if a.model == "sv":
        model = stochastic_volatility(T=1000, seed=0)
        label = "stochastic_volatility(T=1000, seed=0)"
        stem = "sv_t1000"
        named = {"sigma": lambda p: np.exp(p[..., 0]),
                 "nu": lambda p: np.exp(p[..., 1])}
    else:
        model = radon()
        label = "radon(J=85, n_per=12, seed=0)"
        stem = "radon"
        named = {"mu_a": lambda p: p[..., 0], "beta": lambda p: p[..., 1],
                 "sigma": lambda p: np.exp(p[..., 2]),
                 "sigma_a": lambda p: np.exp(p[..., 3])}
    out_path = a.out or str(Path(__file__).with_name(
        stem + "_reference.json"))
    settings = nt.DiagNutsSettings(num_chains=a.chains, num_tune=a.tune,
                                   num_draws=a.draws, seed=a.seed,
                                   posterior_kernel="sync")
    t0 = time.time()
    trace = nt.sample(model, settings)
    seconds = time.time() - t0
    pos = np.asarray(trace.posterior["position"], np.float64)
    st = trace.sample_stats
    div = np.asarray(st["diverging"], np.float64)
    stuck = stuck_chains(pos)
    keep = ~stuck
    pos, div = pos[keep], div[keep]
    st = {k: np.asarray(v)[keep] for k, v in st.items()}
    coords = [moments(pos[..., j]) for j in range(pos.shape[-1])]
    out = {
        "model": label,
        "engine": "nuts_rs_tpu (JAX package), posterior_kernel='sync', CPU",
        "command": f"python3 tests/data/make_zoo_reference.py --model "
                   f"{a.model} --chains {a.chains} --tune {a.tune} "
                   f"--draws {a.draws} --seed {a.seed}",
        "chains": a.chains, "tune": a.tune, "draws": a.draws, "seed": a.seed,
        "seconds": seconds,
        "stuck_chains": int(stuck.sum()),
        "stuck_chain_indices": np.nonzero(stuck)[0].tolist(),
        "divergences": int(div.sum()),
        "divergence_share": float(div.mean()),
        # the standard error of that share from the spread of the chains'
        # own shares (divergences cluster in chains)
        "divergence_share_mc_error": float(
            div.mean(1).std(ddof=1) / np.sqrt(len(div))),
        "mean_tree_accept": float(np.asarray(st["mean_tree_accept"]).mean()),
        "mean_n_steps": float(np.asarray(st["n_steps"]).mean()),
        "median_step_size_bar": float(np.median(
            np.asarray(st["step_size_bar"])[:, -1])),
        "max_mc_error_of_mean_in_std": max(c[2] for c in coords),
        "max_mc_error_of_std": max(c[3] for c in coords),
        "named": {},
        "mean": [c[0] for c in coords],
        "std": [c[1] for c in coords],
        "mc_error_of_mean_in_std": [c[2] for c in coords],
        "mc_error_of_std": [c[3] for c in coords],
    }
    for name, fn in named.items():
        m, s, em, es = moments(fn(pos))
        out["named"][name] = {"mean": m, "std": s,
                              "mc_error_of_mean_in_std": em,
                              "mc_error_of_std": es}
    Path(out_path).write_text(json.dumps(out, indent=1) + "\n")
    print(json.dumps({k: v for k, v in out.items()
                      if k not in ("mean", "std", "mc_error_of_mean_in_std",
                                   "mc_error_of_std")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
