"""Convergence diagnostics: rank-normalized split-R-hat and effective sample
size (bulk and tail).

Port of ``nuts_rs_tpu/diagnostics.py`` (numpy and scipy, a copy; the JAX
package's module falls back to JAX's ``ndtri`` without scipy, this one
needs scipy).

The reference (pymc-devs/nuts-rs) ships no diagnostics — its users reach for
ArviZ after sampling.  With thousands of vmapped chains per chip the batched
variants are cheap enough to run after every chunk, so they are built in
here.  The estimators follow the rank-normalization approach of
Vehtari, Gelman, Simpson, Carpenter, Buerkner (2021), the same formulas
ArviZ/Stan implement; all inputs are ``[chain, draw]`` or
``[chain, draw, dim]`` numpy arrays (a finalized trace's layout).
"""

from __future__ import annotations

import numpy as np

from scipy.special import ndtri as _ndtri


def _split_chains(x: np.ndarray) -> np.ndarray:
    """[C, K] -> [2C, K//2]: split each chain in half (drops an odd draw)."""
    c, k = x.shape
    half = k // 2
    return np.concatenate([x[:, :half], x[:, k - half:]], axis=0)


def _rank_normalize(x: np.ndarray) -> np.ndarray:
    """Fractional ranks -> normal scores over the pooled sample."""
    shape = x.shape
    flat = x.reshape(-1)
    ranks = np.empty_like(flat)
    order = np.argsort(flat, kind="stable")
    ranks[order] = np.arange(1, flat.size + 1, dtype=flat.dtype)
    z = _ndtri((ranks - 3.0 / 8.0) / (flat.size + 1.0 / 4.0))
    return np.asarray(z, dtype=np.float64).reshape(shape)


def _autocov(x: np.ndarray) -> np.ndarray:
    """Per-chain autocovariance by FFT; x [C, n] -> [C, n] (biased by n)."""
    c, n = x.shape
    xc = x - x.mean(axis=1, keepdims=True)
    m = 1 << int(np.ceil(np.log2(2 * n)))
    f = np.fft.rfft(xc, m, axis=1)
    acov = np.fft.irfft(f * np.conj(f), m, axis=1)[:, :n].real
    return acov / n


def _ess_from_matrix(z: np.ndarray) -> float:
    """Geyer initial-monotone-sequence ESS for z [C, n] (already prepared)."""
    c, n = z.shape
    if n < 4 or not np.isfinite(z).all():
        return float("nan")
    if np.ptp(z) == 0.0:
        return float("nan")
    acov = _autocov(z)
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

    # enforce monotone non-increasing pair sums
    t = 1
    while t <= max_t - 2:
        if rho[t + 1] + rho[t + 2] > rho[t - 1] + rho[t]:
            rho[t + 1] = (rho[t - 1] + rho[t]) / 2.0
            rho[t + 2] = rho[t + 1]
        t += 2

    tau = -1.0 + 2.0 * rho[: max_t + 1].sum() + rho[max_t + 1]
    tau = max(tau, 1.0 / np.log10(c * n + 10.0))
    return float(c * n / tau)


def _per_dim(x: np.ndarray, fn) -> np.ndarray:
    x = np.asarray(x, dtype=np.float64)
    if x.ndim == 2:
        return fn(x)
    return np.stack([_per_dim(x[..., i], fn) for i in range(x.shape[-1])],
                    axis=-1)


def split_rhat(x: np.ndarray) -> np.ndarray:
    """Rank-normalized split-R-hat; x [chain, draw(, dim)] -> scalar (or [dim]).

    Values near 1.0 indicate convergence; > 1.01 is suspect.
    """

    def one(mat):
        if np.ptp(mat) == 0.0:
            return float("nan")   # ranking would fabricate variation
        z = _rank_normalize(_split_chains(mat))
        c, n = z.shape
        if n < 2:
            return float("nan")
        chain_mean = z.mean(axis=1)
        chain_var = z.var(axis=1, ddof=1)
        w = chain_var.mean()
        b = n * chain_mean.var(ddof=1) if c > 1 else 0.0
        if w == 0.0:
            return float("nan")
        var_hat = (n - 1.0) / n * w + b / n
        return float(np.sqrt(var_hat / w))

    return _per_dim(x, one)


def ess_bulk(x: np.ndarray) -> np.ndarray:
    """Bulk effective sample size on rank-normalized split chains."""

    def one(mat):
        if np.ptp(mat) == 0.0:
            return float("nan")
        return _ess_from_matrix(_rank_normalize(_split_chains(mat)))

    return _per_dim(x, one)


def ess_tail(x: np.ndarray, prob: float = 0.05) -> np.ndarray:
    """Tail ESS: min ESS of the ``prob`` / ``1-prob`` quantile indicators."""

    def one(mat):
        out = []
        for p in (prob, 1.0 - prob):
            q = np.quantile(mat, p)
            # The 0/1 indicator is already outlier-robust; rank-normalizing
            # it would order the ties arbitrarily and destroy the ESS.
            ind = _split_chains((mat <= q).astype(np.float64))
            out.append(_ess_from_matrix(ind))
        return float(np.nanmin(out))

    return _per_dim(x, one)


def summary(trace, var: str = "position") -> dict:
    """Per-dimension convergence summary for a finalized in-memory trace."""
    x = np.asarray(trace.posterior[var], dtype=np.float64)
    return {
        "mean": x.mean(axis=(0, 1)),
        "std": x.std(axis=(0, 1)),
        "rhat": split_rhat(x),
        "ess_bulk": ess_bulk(x),
        "ess_tail": ess_tail(x),
    }
