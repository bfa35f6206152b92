"""Stochastic volatility: the ecosystem's flagship realistic benchmark.

Port of ``nuts_rs_tpu/models/stochastic_volatility.py``: the non-centered
Student-t stochastic-volatility model over ``T`` daily returns ``r_t``,

    sigma ~ Exponential(lam_sigma),  nu ~ Exponential(lam_nu)
    h_t   = sigma * cumsum(eps),  eps_t ~ N(0, 1)
    r_t   ~ StudentT(nu, 0, exp(h_t / 2))

over ``q = [log_sigma, log_nu, eps_1..T]`` (dim = T + 2), the Exponential
priors with their ``+ log x`` Jacobians.  At the realistic T = 1000 the
fused NUTS runners take it in the dim-on-lanes layout with its returns as
model data (kernels K1-ld-args and K2-ld-args).

The sync-engine form (``logp_fn``) uses ``torch.cumsum``, ``torch.lgamma``
and ``torch.log1p``.  The device functor (``csrc/models.cuh::
StochasticVolatility``) and its plain counterpart here carry the closed-form
gradient, whose ``d/d eps`` is a reverse cumulative sum, and spell the
special functions they need out of basic operations (:func:`lgamma`,
:func:`digamma`, :func:`log1p`), so that the kernel and its plain version
round alike; the two scans and every sum follow the order stated in
:func:`stochastic_volatility_logp_grad`.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..ops import TSUM_THREADS
from .model import Model

_HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)
# Stirling's series of lgamma: 1/12, -1/360, 1/1260, -1/1680, 1/1188,
# -691/360360, 1/156 (B_2k / (2k (2k - 1)), in powers 1/x, 1/x^3, ...)
_LGAMMA_SERIES = (1.0 / 12.0, -1.0 / 360.0, 1.0 / 1260.0, -1.0 / 1680.0,
                  1.0 / 1188.0, -691.0 / 360360.0, 1.0 / 156.0)
# the asymptotic series of digamma: 1/12, 1/120, 1/252, 1/240, 1/132,
# 691/32760, 1/12 (B_2k / 2k, in powers 1/x^2, 1/x^4, ..., signs
# alternating from -)
_DIGAMMA_SERIES = (1.0 / 12.0, 1.0 / 120.0, 1.0 / 252.0, 1.0 / 240.0,
                   1.0 / 132.0, 691.0 / 32760.0, 1.0 / 12.0)
# the recurrences shift x up to 6 in at most this many steps (x >= 0)
_SHIFT_STEPS = 6
_WARPS = TSUM_THREADS // 32


def generate_returns(T: int = 1000, sigma: float = 0.1, nu: float = 8.0,
                     seed: int = 0) -> np.ndarray:
    """Synthetic daily returns drawn from the generative model, as the JAX
    package draws them."""
    rng = np.random.default_rng(seed)
    h = sigma * np.cumsum(rng.normal(size=T))
    scale = np.exp(h / 2.0)
    return (rng.standard_t(nu, size=T) * scale).astype(np.float64)


def _one(x):
    return torch.ones_like(x)


def lgamma(x):
    """log Gamma(x) for x >= 0, as csrc/models.cuh::sv_lgamma computes it:
    ``p *= x; x += 1`` while x < 6 (at most 6 steps), then Stirling's series
    to 1/x^13 at the shifted x, minus ``log p``."""
    p = _one(x)
    for _ in range(_SHIFT_STEPS):
        m = x < 6.0
        p = torch.where(m, p * x, p)
        x = torch.where(m, x + 1.0, x)
    s = _one(x) / x
    s2 = s * s
    c = _LGAMMA_SERIES
    ser = c[6]
    for k in range(5, -1, -1):
        ser = c[k] + s2 * ser
    ser = s * ser
    return (((x - 0.5) * torch.log(x) - x) + _HALF_LOG_2PI) + ser \
        - torch.log(p)


def digamma(x):
    """The digamma function for x >= 0, as csrc/models.cuh::sv_digamma
    computes it: ``acc += 1 / x; x += 1`` while x < 6 (at most 6 steps),
    then the asymptotic series to 1/x^14 at the shifted x, minus ``acc``."""
    acc = torch.zeros_like(x)
    for _ in range(_SHIFT_STEPS):
        m = x < 6.0
        acc = torch.where(m, acc + _one(x) / x, acc)
        x = torch.where(m, x + 1.0, x)
    s = _one(x) / x
    s2 = s * s
    c = _DIGAMMA_SERIES
    ser = c[6]
    for k in range(5, -1, -1):
        ser = c[k] - s2 * ser
    ser = s2 * ser
    return ((torch.log(x) - 0.5 * s) - ser) - acc


def log1p(w):
    """log(1 + w), as csrc/models.cuh::sv_log1p computes it: with
    ``u = 1 + w``, w itself where u rounds to 1, else
    ``log(u) * (w / (u - 1))``."""
    u = 1.0 + w
    return torch.where(u == 1.0, w, torch.log(u) * (w / (u - 1.0)))


def _run_length(T):
    """Coordinates of a contiguous run: thread t of the 256 owns eps
    ``t R .. t R + R - 1``."""
    return max(1, -(-T // TSUM_THREADS))


def _scan_exclusive(S):
    """Exclusive prefix sums of the 256 run totals ``S [C, 256]`` in the
    functor's order: an inclusive Hillis-Steele scan inside each warp of 32
    (offsets 1, 2, 4, 8, 16: ``x_i + x_{i-o}``), the same over the 8 warp
    totals (1, 2, 4), then ``warp prefix + lane prefix`` (0.0 where there is
    none)."""
    C = S.shape[0]
    x = S.reshape(C, _WARPS, 32)
    for o in (1, 2, 4, 8, 16):
        x = torch.cat([x[..., :o], x[..., o:] + x[..., :-o]], -1)
    W = x[..., 31]
    for o in (1, 2, 4):
        W = torch.cat([W[:, :o], W[:, o:] + W[:, :-o]], -1)
    zero = torch.zeros_like(W[:, :1])
    wex = torch.cat([zero, W[:, :-1]], -1)
    lex = torch.cat([torch.zeros_like(x[..., :1]), x[..., :-1]], -1)
    return (wex[..., None] + lex).reshape(C, TSUM_THREADS)


def _runs(x, T, R):
    """[C, T] -> [C, 256, R], padded with 0.0."""
    pad = TSUM_THREADS * R - T
    if pad:
        x = torch.nn.functional.pad(x, (0, pad))
    return x.reshape(x.shape[0], TSUM_THREADS, R)


def _run_sums(x, T, R):
    """Each run's terms added in ascending order: [C, 256]."""
    x = _runs(x, T, R)
    s = x[..., 0]
    for r in range(1, R):
        s = s + x[..., r]
    return s


def stochastic_volatility_logp_grad(q, lam_sigma, lam_nu, r, csum):
    """Plain counterpart of the ``stochastic_volatility`` device functor
    (csrc/models.cuh::StochasticVolatility): ``(logp [C], grad [C, d])`` at
    ``q [C, d]`` for the returns ``r [T]``, ``d = T + 2``.

    With ``sigma = exp(q0)``, ``nu = exp(q1)``, ``k = (nu + 1) 0.5``, the
    cumulative sum ``c`` of ``eps = q[2:]`` and, per t, ``h = sigma c``,
    ``scale = exp(h 0.5)``, ``z = r / scale``, ``w = z z / nu``,
    ``L = log1p(w)``: the Student-t term ``(A - log(scale)) - k L`` with
    ``A = (lgamma(k) - lgamma(nu 0.5)) - 0.5 log(nu pi)`` (the JAX body's
    spelling, ``stochastic_volatility.py:40-44``), ``b = (k w) / (1 + w)``,
    ``a = b - 0.5 = d term / dh``.  Then
    ``logp = ((-lam_sigma sigma + q0) + (-lam_nu nu + q1)) - 0.5 sum eps^2
    + sum term``, and the gradient ``(1 - lam_sigma sigma) + sum a h`` for
    q0, ``((1 - lam_nu nu) + T (0.5 nu (digamma(k) - digamma(nu 0.5)) -
    0.5)) + sum (b - 0.5 nu L)`` for q1 and ``sigma rs_t - eps_t`` for
    eps_t, ``rs`` the reverse cumulative sum of ``a``.

    Order (the functor's).  Thread t of 256 owns the contiguous run of R =
    ceil(T / 256) coordinates ``t R ..`` (positions past T count 0.0).
    Cumulative sum: the run's inclusive sums in ascending order, the
    exclusive scan of the 256 run totals (:func:`_scan_exclusive`), then
    ``prefix + local``.  Reverse cumulative sum: the same on the reversed
    runs and threads.  Each of the four sums: the run's terms in ascending
    order, then ``csum`` over the 256 run sums."""
    C, d = q.shape
    T = d - 2
    R = _run_length(T)
    ls, lnu, eps = q[:, 0], q[:, 1], q[:, 2:]
    sigma, nu = torch.exp(ls), torch.exp(lnu)
    k = (nu + 1.0) * 0.5
    nuh = nu * 0.5
    A = (lgamma(k) - lgamma(nuh)) - 0.5 * torch.log(nu * math.pi)
    # cumulative sum of eps
    E = _runs(eps, T, R)
    loc = [E[..., 0]]
    for i in range(1, R):
        loc.append(loc[-1] + E[..., i])
    loc = torch.stack(loc, -1)
    c = (_scan_exclusive(loc[..., R - 1])[..., None] + loc).reshape(C, -1)
    h = sigma[:, None] * c[:, :T]
    scale = torch.exp(h * 0.5)
    z = r.to(q.dtype) / scale
    w = (z * z) / nu[:, None]
    L = log1p(w)
    term = (A[:, None] - torch.log(scale)) - k[:, None] * L
    b = (k[:, None] * w) / (1.0 + w)
    a = b - 0.5
    s_term = csum(_run_sums(term, T, R))
    s_ah = csum(_run_sums(a * h, T, R))
    s_nu = csum(_run_sums(b - nuh[:, None] * L, T, R))
    s_ee = csum(_run_sums(eps * eps, T, R))
    # reverse cumulative sum of a
    Ar = _runs(a, T, R)
    rev = [Ar[..., R - 1]]
    for i in range(R - 2, -1, -1):
        rev.append(rev[-1] + Ar[..., i])
    rev = torch.stack(rev[::-1], -1)
    suffix = _scan_exclusive(rev[..., 0].flip(-1)).flip(-1)
    rs = (suffix[..., None] + rev).reshape(C, -1)[:, :T]
    logp = (-lam_sigma * sigma + ls) + (-lam_nu * nu + lnu)
    logp = logp + -0.5 * s_ee
    logp = logp + s_term
    g0 = (1.0 - lam_sigma * sigma) + s_ah
    g1 = ((1.0 - lam_nu * nu)
          + T * (nuh * (digamma(k) - digamma(nuh)) - 0.5)) + s_nu
    grad = torch.cat([g0[:, None], g1[:, None],
                      sigma[:, None] * rs - eps], 1)
    return logp, grad


def stochastic_volatility(returns: np.ndarray | None = None, T: int = 1000,
                          lam_sigma: float = 10.0, lam_nu: float = 0.1,
                          seed: int = 0) -> Model:
    """Build the model; with ``returns=None`` uses synthetic data of length
    ``T`` from :func:`generate_returns` (known ground truth)."""
    if returns is None:
        returns = generate_returns(T, seed=seed)
    r = np.asarray(returns, np.float64)
    T = r.shape[0]
    dim = T + 2

    def build(hook, r64):
        def logp(q):
            log_sigma, log_nu, eps = q[0], q[1], q[2:]
            sigma = torch.exp(log_sigma)
            nu = torch.exp(log_nu)
            lp = -lam_sigma * sigma + log_sigma
            lp = lp + (-lam_nu * nu + log_nu)
            lp = lp - 0.5 * torch.sum(eps * eps)
            scale = torch.exp(sigma * torch.cumsum(eps, 0) / 2.0)
            zz = r64.to(q.dtype) / scale
            return lp + torch.sum(
                torch.lgamma((nu + 1.0) / 2.0) - torch.lgamma(nu / 2.0)
                - 0.5 * torch.log(nu * math.pi) - torch.log(scale)
                - (nu + 1.0) / 2.0 * torch.log1p(zz * zz / nu))

        def expand(q):
            sigma = torch.exp(q[0])
            return {"sigma": sigma, "nu": torch.exp(q[1]),
                    "volatility": torch.exp(
                        sigma * torch.cumsum(q[2:], 0) / 2.0)}

        def on_device(dev):
            return build(tuple(t.to(dev) for t in hook), r64.to(dev))

        return Model(
            logp_fn=logp, dim=dim,
            kernel_hook=("stochastic_volatility", (lam_sigma, lam_nu), hook),
            on_device=on_device, expand_fn=expand,
            dims={"volatility": ("time",)}, coords={"time": np.arange(T)},
            name=f"stochastic_volatility_{T}")

    return build((torch.from_numpy(r.astype(np.float32)),),
                 torch.as_tensor(r))
