"""Analytic test models.

Port of ``nuts_rs_tpu/models/gaussian.py``: ``normal_logp`` (``:20-28``),
``mv_normal`` (``:31-42``), ``correlated_normal_rank1`` (``:45-76``),
``correlated_normal`` (``:79-101``), ``funnel`` (``:104-114``),
``eight_schools`` (``:117-146``) and ``logistic_regression``
(``:149-180,230-232``) with its dense data channel, the counterpart of
``Model.pallas_logp_grad``, and its streaming form (``:182-228``, kernel
K1-stream).  The models whose JAX form reaches the fused Pallas kernels
carry a device functor (``csrc/models.cuh``) and its plain counterpart in
``PLAIN_FUNCTORS``: the rank-1 normal through its ``pallas_spec``, the
funnel and ``correlated_normal`` through their closures, which the JAX
runners trace into the kernel body (``nuts_rs_tpu/chain.py:686-690``).
``mv_normal`` and ``eight_schools`` capture array constants, which the JAX
package's kernels refuse; it falls back to its sync engine for them, and
here they run on the sync engine (``posterior_kernel="sync"``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import hsum, ieee_matmul, logaddexp, tsum
from .model import Model


def iid_normal_logp_grad(q, mu, csum):
    """Plain counterpart of the ``iid_normal`` device functor
    (csrc/models.cuh): ``(logp [C], grad [C, d])`` at ``q [C, d]``, with the
    sum over the parameter axis taken by ``csum``."""
    diff = q - mu
    return -0.5 * csum(diff * diff), -diff


def logistic_regression_logp_grad(q, xt, y, csum):
    """Plain counterpart of the ``logistic_regression`` device functor
    (csrc/models.cuh::LogisticRegression): ``(logp [C], grad [C, d])`` at
    ``q [C, d]`` for the data ``xt [d, N]`` (x transposed) and ``y [N]``.

    The spellings are the JAX body's (``gaussian.py:173-179``) and every sum
    takes the functor's order: a logit's terms in ascending j, the
    log-likelihood's and each gradient column's terms over n in the block
    order (``ops.tsum``), the prior's terms by ``csum``, which is ``tsum``
    too for every kernel that evaluates this functor.  Divisions are tensor
    by tensor, as everywhere a plain version must round like its kernel."""
    logits = xt[0] * q[:, 0:1]
    for j in range(1, xt.shape[0]):
        logits = logits + xt[j] * q[:, j:j + 1]
    ll = tsum(y * logits - logaddexp(torch.zeros_like(logits), logits))
    p = torch.ones_like(logits) / (1.0 + torch.exp(-logits))
    grad = tsum(xt * (y - p)[:, None, :]) - q
    return ll - 0.5 * csum(q * q), grad


def correlated_normal_rank1_logp_grad(q, coef, u, s, csum):
    """Plain counterpart of the ``correlated_normal_rank1`` device functor
    (csrc/models.cuh::CorrelatedNormalRank1): ``(logp [C], grad [C, d])`` at
    ``q [C, d]`` for ``u [d]`` and the scale diagonal ``s [d]``, in the JAX
    body's spelling (``gaussian.py:66-70``): ``y = q / sqrt(s)``, ``logp =
    -0.5 (y.y + coef (u.y) (u.y))``, and its closed-form gradient
    ``-(y + coef (u.y) u) / sqrt(s)``.  The two dots by ``csum``."""
    root = torch.sqrt(s)
    y = q / root
    proj = csum(u * y)
    logp = -0.5 * (csum(y * y) + coef * proj * proj)
    return logp, -(y + (coef * proj)[:, None] * u) / root


def correlated_normal_logp_grad(q, c, csum):
    """Plain counterpart of the ``correlated_normal`` device functor
    (csrc/models.cuh::CorrelatedNormal): ``logp = -0.5 q.q + 0.5 c s s``
    with ``s`` the sum of q (``gaussian.py:96-98``), gradient ``c s - q``;
    both sums by ``csum``."""
    s = csum(q)
    logp = -0.5 * csum(q * q) + 0.5 * c * s * s
    return logp, (c * s)[:, None] - q


def funnel_logp_grad(q, csum):
    """Plain counterpart of the ``funnel`` device functor
    (csrc/models.cuh::Funnel), Neal's funnel in the JAX body's spelling
    (``gaussian.py:107-111``): ``v = q0``, ``t = v / 3``, ``e = exp(-v)``,
    ``logp = -0.5 t t + (-0.5 S - h v)`` with ``S`` the sum of ``x x e``
    over the coordinates ``x = q[1:]`` and ``h = 0.5 (d - 1)``; gradient
    ``(0.5 S - t / 3) - h`` for v and ``-(x e)`` for x.  ``S`` sums the
    terms of all d coordinates by ``csum``, coordinate 0's term 0.0."""
    d = q.shape[-1]
    v = q[:, 0]
    three = torch.full_like(v, 3.0)
    t = v / three
    e = torch.exp(-v)
    terms = q * q * e[:, None]
    terms = torch.cat([torch.zeros_like(terms[:, :1]), terms[:, 1:]], 1)
    S = csum(terms)
    h = 0.5 * (d - 1)
    logp = -0.5 * (t * t) + (-0.5 * S - h * v)
    gv = (0.5 * S - t / three) - h
    return logp, torch.cat([gv[:, None], -(q[:, 1:] * e[:, None])], 1)


# Elements of the [chains, d, rows] product that the streamed plain functor
# forms at once; more chains are evaluated in groups.
_STREAM_PRODUCT_ELEMENTS = 1 << 28
# Most ranges a streamed evaluation splits its tiles into: kernel K1-stream
# writes one partial sum per range and chain, and adds them in turn.
STREAM_MAX_RANGES = 256


def stream_ranges(n_tiles: int) -> int:
    """The ranges the tiles of a streamed evaluation fall into by default:
    one a tile, at most ``STREAM_MAX_RANGES`` (a constant of the sum order,
    not of the card)."""
    return min(n_tiles, STREAM_MAX_RANGES)


def stream_quads(n_data: int, tile_rows: int, ranges: int):
    """The rows of a streamed evaluation in its sum order: ``(rows [R, Q, 4],
    present [R, Q, 4])``, range r holding the tiles ``[r T // R, (r + 1) T //
    R)`` of ``tile_rows`` rows, cut from its first row into quads of 4 rows;
    ``rows`` indexes the data (0 where no row is), ``present`` marks a row of
    the data.  Every range holds at least one tile (``1 <= R <= T``)."""
    T = -(-n_data // tile_rows)
    lo = torch.tensor([(r * T // ranges) * tile_rows for r in range(ranges)])
    hi = torch.tensor([min(((r + 1) * T // ranges) * tile_rows, n_data)
                       for r in range(ranges)])
    Q = int(-(-(hi - lo).max() // 4))
    rows = lo[:, None, None] + torch.arange(4 * Q).reshape(1, Q, 4)
    present = rows < hi[:, None, None]
    return torch.where(present, rows, 0), present


def _sum_quads(terms, present):
    """Terms ``[..., R, Q, 4]`` summed in the streamed order: a quad's present
    terms left to right, a range's quads left to right, the ranges in
    ascending order (``[...]``)."""
    quad = terms[..., 0]
    for k in range(1, 4):
        quad = torch.where(present[..., k], quad + terms[..., k], quad)
    rng = quad[..., 0]
    for i in range(1, quad.shape[-1]):
        rng = torch.where(present[:, i, 0], rng + quad[..., i], rng)
    total = rng[..., 0]
    for r in range(1, rng.shape[-1]):
        total = total + rng[..., r]
    return total


def logistic_regression_stream_logp_grad(q, xt, y, tile_rows, csum,
                                         ranges=None):
    """Plain counterpart of the ``logistic_regression_stream`` device functor
    (csrc/models.cuh::LogisticRegressionStream), the evaluation of kernel
    K1-stream: ``(logp [C], grad [C, d])`` at ``q [C, d]`` for the data
    ``xt [d, N]`` and ``y [N]`` in tiles of ``tile_rows`` rows, as the JAX
    model's ``tile_eval`` and ``finalize`` walk them
    (``gaussian.py:202-228``).

    Sum order, the functor's: a logit's terms in ascending j.  The T tiles
    fall into ``ranges`` ranges (default :func:`stream_ranges`), range r the
    tiles ``[r T // R, (r + 1) T // R)``; over a range's rows, for the
    log-likelihood and each gradient column alike, quads of 4 rows from the
    range's first row (:func:`stream_quads`), a quad's terms added left to
    right, then the range's quads left to right, then the ranges in
    ascending order.  A row past the data's end is no term (the JAX model's
    zero-weight padding rows add 0).  Last the prior, its terms by ``csum``
    (``tsum``).  The terms are formed side by side and only their sums are
    added in turn; the [C, d, rows] product is formed for a group of chains
    at a time."""
    d, N = xt.shape
    T = -(-N // tile_rows)
    R = stream_ranges(T) if ranges is None else ranges
    if not 1 <= R <= T:
        raise ValueError(f"ranges must be 1..{T} (the tiles), got {R}")
    rows, present = stream_quads(N, tile_rows, R)
    rows, present = rows.to(q.device), present.to(q.device)
    xg = xt[:, rows]                 # [d, R, Q, 4]
    yg = y[rows]
    group = max(1, _STREAM_PRODUCT_ELEMENTS // (d * rows.numel()))
    lls, grads = [], []
    for lo in range(0, q.shape[0], group):
        qc = q[lo:lo + group, :, None, None, None]
        logits = xg[0] * qc[:, 0]
        for j in range(1, d):
            logits = logits + xg[j] * qc[:, j]
        ll = yg * logits - logaddexp(torch.zeros_like(logits), logits)
        p = torch.ones_like(logits) / (1.0 + torch.exp(-logits))
        res = yg - p
        lls.append(_sum_quads(ll, present))
        grads.append(_sum_quads(xg * res[:, None], present))
    return (torch.cat(lls) - 0.5 * csum(q * q), torch.cat(grads) - q)


# Plain counterparts of the device model functors, by ``Model.kernel_hook``
# name: ``fn(q, *hook_floats, *hook_tensors, csum)``; a streamed functor, the
# hook's name with ``_stream`` appended, also takes the model's
# ``stream_tile_rows`` before ``csum`` and its ranges after it.  The fused
# kernels' plain versions evaluate a model through these, with the sum of
# the kernel that serves it, as the kernels evaluate it through the functor.
PLAIN_FUNCTORS = {
    "iid_normal": iid_normal_logp_grad,
    "logistic_regression": logistic_regression_logp_grad,
    "logistic_regression_stream": logistic_regression_stream_logp_grad,
    "correlated_normal_rank1": correlated_normal_rank1_logp_grad,
    "correlated_normal": correlated_normal_logp_grad,
    "funnel": funnel_logp_grad,
}


def _register_plain_functors():
    """The plain functors of the models in modules of their own."""
    from .hierarchical import radon_logp_grad
    from .stochastic_volatility import stochastic_volatility_logp_grad

    PLAIN_FUNCTORS["radon"] = radon_logp_grad
    PLAIN_FUNCTORS["stochastic_volatility"] = stochastic_volatility_logp_grad


def stream_tile_rows(n_data: int) -> int:
    """The JAX model's tile (``gaussian.py:193``)."""
    return 512 if n_data >= 512 else 8


def normal_logp(dim: int, mu: float = 3.0) -> Model:
    """iid Normal(mu, 1) in every coordinate; nuts-rs src/math/test_logps.rs:9.

    The closed form is the host's evaluation (init points, step-size
    searches) and sums with ``ops.hsum``."""
    mu = float(mu)

    def logp(q):
        return -0.5 * torch.sum(torch.square(q - mu))

    def logp_grad(q):
        return iid_normal_logp_grad(q, mu, hsum)

    return Model(logp_fn=logp, dim=dim, logp_grad_fn=logp_grad,
                 kernel_hook=("iid_normal", (mu,)), name=f"normal_{dim}d")


def _const(a):
    """A float64 tensor of host data, which a ``logp_fn`` casts to the
    position's dtype as the JAX models cast theirs."""
    return torch.as_tensor(np.asarray(a, np.float64))


def mv_normal(cov) -> Model:
    """Multivariate normal with dense covariance (nuts-rs
    src/transform/mod.rs:39).  No device functor: its JAX form captures the
    precision matrix, which the JAX package's kernels refuse."""
    cov = np.asarray(cov, dtype=np.float64)
    dim = cov.shape[0]

    def build(prec):
        def logp(q):
            p = prec.to(q.dtype)
            return -0.5 * q @ p @ q

        return Model(logp_fn=logp, dim=dim, name=f"mvnormal_{dim}d",
                     on_device=lambda dev: build(prec.to(dev)))

    return build(_const(np.linalg.inv(cov)))


def correlated_normal_rank1(dim: int, scale: float = 1.5,
                            eig: float = 1000.0) -> Model:
    """Rank-1 correlated Gaussian via its Woodbury precision: covariance
    ``diag(s)^1/2 (I + (eig - 1) u u^T) diag(s)^1/2`` (nuts-rs
    ``tests/sample_normal.rs:29-108``), ``u`` from
    ``np.random.default_rng(42)`` as in the JAX package.  Its data ``u`` and
    ``s`` travel to the kernels as the JAX model's ``pallas_spec`` args; the
    host evaluates the functor's closed form with ``ops.hsum``."""
    rng = np.random.default_rng(42)
    u = rng.normal(size=dim)
    u /= np.linalg.norm(u)
    stds = np.full(dim, scale)
    coef = 1.0 / eig - 1.0
    hook = (torch.from_numpy(u.astype(np.float32)),
            torch.from_numpy(stds.astype(np.float32)))

    def build(hook, u64, s64):
        def logp(q):
            y = q / torch.sqrt(s64.to(q.dtype))
            proj = u64.to(q.dtype) @ y
            return -0.5 * (y @ y + coef * proj * proj)

        def logp_grad(q):
            return correlated_normal_rank1_logp_grad(
                q, coef, u64.to(q.dtype), s64.to(q.dtype), hsum)

        def on_device(dev):
            return build(tuple(t.to(dev) for t in hook), u64.to(dev),
                         s64.to(dev))

        return Model(logp_fn=logp, dim=dim, logp_grad_fn=logp_grad,
                     name=f"corr_normal_{dim}d",
                     kernel_hook=("correlated_normal_rank1", (coef,), hook),
                     on_device=on_device)

    return build(hook, _const(u), _const(stds))


def correlated_normal(dim: int, rank1_scale: float = 0.5) -> Model:
    """Correlated normal with covariance ``I + rank1_scale 1 1^T`` (nuts-rs
    tests/sample_normal.rs:21-107): by Woodbury the precision is
    ``I - c 1 1^T`` with ``c = rank1_scale / (1 + rank1_scale dim)``; the
    host evaluates the functor's closed form with ``ops.hsum``."""
    c = rank1_scale / (1.0 + rank1_scale * dim)

    def logp(q):
        s = torch.sum(q)
        return -0.5 * torch.sum(q * q) + 0.5 * c * s * s

    def logp_grad(q):
        return correlated_normal_logp_grad(q, c, hsum)

    return Model(logp_fn=logp, dim=dim, logp_grad_fn=logp_grad,
                 name=f"corr_normal_{dim}d",
                 kernel_hook=("correlated_normal", (c,)))


def funnel(dim: int = 10) -> Model:
    """Neal's funnel: v ~ N(0, 3), x_i | v ~ N(0, exp(v/2))."""

    def logp(q):
        v, x = q[0], q[1:]
        lp_v = -0.5 * (v / 3.0) ** 2
        lp_x = (-0.5 * torch.sum(torch.square(x) * torch.exp(-v))
                - 0.5 * (dim - 1) * v)
        return lp_v + lp_x

    return Model(logp_fn=logp, dim=dim, name=f"funnel_{dim}d",
                 kernel_hook=("funnel", ()))


def eight_schools() -> Model:
    """Non-centered eight schools; q = [mu, log_tau, theta_tilde x 8].  No
    device functor: its JAX form captures the data, which the JAX package's
    kernels refuse."""

    def build(y, sigma):
        def logp(q):
            mu, log_tau, tt = q[0], q[1], q[2:]
            theta = mu + torch.exp(log_tau) * tt
            lp = -0.5 * (mu / 5.0) ** 2
            lp = lp - 0.5 * (log_tau / 5.0) ** 2
            lp = lp - 0.5 * torch.sum(tt * tt)
            return lp + torch.sum(-0.5 * torch.square(
                (y.to(q.dtype) - theta) / sigma.to(q.dtype)))

        def expand(q):
            mu, log_tau, tt = q[0], q[1], q[2:]
            return {"mu": mu, "tau": torch.exp(log_tau),
                    "theta": mu + torch.exp(log_tau) * tt}

        return Model(logp_fn=logp, dim=10, expand_fn=expand,
                     dims={"theta": ["school"]},
                     coords={"school": np.arange(8)}, name="eight_schools",
                     on_device=lambda dev: build(y.to(dev), sigma.to(dev)))

    return build(_const([28.0, 8.0, -3.0, 7.0, -1.0, 1.0, 18.0, 12.0]),
                 _const([15.0, 10.0, 16.0, 11.0, 9.0, 11.0, 10.0, 18.0]))


def logistic_regression_tensors(x, y):
    """The ``logistic_regression`` functor's data from the design matrix
    ``x [N, d]`` and the labels ``y [N]`` or ``[N, 1]`` (numpy): ``(xt
    [d, N], y [N])``, contiguous float32 tensors on the CPU."""
    x = np.asarray(x, np.float32)
    y = np.asarray(y, np.float32).reshape(x.shape[0])
    return (torch.from_numpy(np.ascontiguousarray(x.T)),
            torch.from_numpy(np.ascontiguousarray(y)))


def logistic_regression_from_tensors(xt, y, name=None,
                                     tile_rows=None) -> Model:
    """The model of :func:`logistic_regression` on given data tensors
    ``(xt [d, N], y [N])``, which decide the device its closed forms run
    on.  ``tile_rows``: the rows of a streamed tile (default: the JAX
    model's, :func:`stream_tile_rows`)."""
    dim = xt.shape[0]
    if tile_rows is None:
        tile_rows = stream_tile_rows(xt.shape[1])

    def logp(q):
        logits = q.to(xt.dtype) @ xt
        ll = torch.sum(y * logits - torch.logaddexp(torch.zeros_like(logits),
                                                    logits))
        return ll - 0.5 * torch.sum(q * q)

    def logp_grad(q):
        # the host's batched closed form: two plain matrix products, as the
        # JAX package leaves them to XLA outside its kernels
        with ieee_matmul():
            logits = q @ xt
            ll = torch.sum(y * logits - logaddexp(torch.zeros_like(logits),
                                                  logits), -1)
            p = torch.ones_like(logits) / (1.0 + torch.exp(-logits))
            grad = (y - p) @ xt.T - q
        # one reduction: the sync engine evaluates this every tree iteration
        return ll - 0.5 * torch.sum(q * q, -1), grad

    def on_device(device):
        return logistic_regression_from_tensors(xt.to(device), y.to(device),
                                                name, tile_rows)

    return Model(logp_fn=logp, dim=dim, logp_grad_fn=logp_grad,
                 kernel_hook=("logistic_regression", (), (xt, y)),
                 stream_tile_rows=tile_rows, on_device=on_device, name=name or f"logreg_{dim}d")


def logistic_regression(n_data: int = 1000, dim: int = 100,
                        seed: int = 0) -> Model:
    """Bayesian logistic regression with a standard-normal prior on the
    weights.  The data come from ``np.random.default_rng(seed)`` exactly as
    in the JAX package, so both packages hold the same x and y."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n_data, dim)).astype(np.float32)
    w_true = rng.normal(size=dim).astype(np.float32) / np.sqrt(dim)
    p = 1.0 / (1.0 + np.exp(-(x @ w_true)))
    y = (rng.uniform(size=n_data) < p).astype(np.float32)
    return logistic_regression_from_tensors(*logistic_regression_tensors(x, y))


_register_plain_functors()
