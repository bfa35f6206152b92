"""Analytic test models.

Port of ``nuts_rs_tpu/models/gaussian.py``; only ``normal_logp``
(``:20-28``) so far.  The other models are queue-1 item 10 of ROADMAP.md.
"""

from __future__ import annotations

import torch

from ..ops import hsum
from .model import Model


def iid_normal_logp_grad(q, mu, csum):
    """Plain counterpart of the ``iid_normal`` device functor
    (csrc/models.cuh): ``(logp [C], grad [C, d])`` at ``q [C, d]``, with the
    sum over the parameter axis taken by ``csum``."""
    diff = q - mu
    return -0.5 * csum(diff * diff), -diff


# Plain counterparts of the device model functors, by ``Model.kernel_hook``
# name: ``fn(q, *hook_params, csum)``.  The fused kernels' plain versions
# evaluate a model through these, with the sum of their layout, as the
# kernels evaluate it through the functor.
PLAIN_FUNCTORS = {"iid_normal": iid_normal_logp_grad}


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
