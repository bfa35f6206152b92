"""Analytic test models.

Port of ``nuts_rs_tpu/models/gaussian.py``: ``normal_logp`` (``:20-28``) and
``logistic_regression`` (``:149-180,230-232``) with its dense data channel,
the counterpart of ``Model.pallas_logp_grad``; its streaming form
(``:182-228``) comes with kernel K1-stream.  The other models are queue-1
item 10 of ROADMAP.md.
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


# Plain counterparts of the device model functors, by ``Model.kernel_hook``
# name: ``fn(q, *hook_floats, *hook_tensors, csum)``.  The fused kernels'
# plain versions evaluate a model through these, with the sum of the kernel
# that serves it, as the kernels evaluate it through the functor.
PLAIN_FUNCTORS = {"iid_normal": iid_normal_logp_grad,
                  "logistic_regression": logistic_regression_logp_grad}


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


def logistic_regression_tensors(x, y):
    """The ``logistic_regression`` functor's data from the design matrix
    ``x [N, d]`` and the labels ``y [N]`` or ``[N, 1]`` (numpy): ``(xt
    [d, N], y [N])``, contiguous float32 tensors on the CPU."""
    x = np.asarray(x, np.float32)
    y = np.asarray(y, np.float32).reshape(x.shape[0])
    return (torch.from_numpy(np.ascontiguousarray(x.T)),
            torch.from_numpy(np.ascontiguousarray(y)))


def logistic_regression_from_tensors(xt, y, name=None) -> Model:
    """The model of :func:`logistic_regression` on given data tensors
    ``(xt [d, N], y [N])``, which decide the device its closed forms run
    on."""
    dim = xt.shape[0]

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
        return ll - 0.5 * hsum(q * q), grad

    def on_device(device):
        return logistic_regression_from_tensors(xt.to(device), y.to(device),
                                                name)

    return Model(logp_fn=logp, dim=dim, logp_grad_fn=logp_grad,
                 kernel_hook=("logistic_regression", (), (xt, y)),
                 on_device=on_device, name=name or f"logreg_{dim}d")


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
