"""Analytic test models.

Port of ``nuts_rs_tpu/models/gaussian.py``; only ``normal_logp``
(``:20-28``) so far.  The other models are queue-1 item 10 of ROADMAP.md.
"""

from __future__ import annotations

import torch

from ..ops import dsum
from .model import Model


def normal_logp(dim: int, mu: float = 3.0) -> Model:
    """iid Normal(mu, 1) in every coordinate; nuts-rs src/math/test_logps.rs:9.

    The closed form sums in coordinate order, as the kernels' ``iid_normal``
    functor does (csrc/models.cuh)."""
    mu = float(mu)

    def logp(q):
        return -0.5 * torch.sum(torch.square(q - mu))

    def logp_grad(q):
        diff = q - mu
        return -0.5 * dsum(diff * diff), -diff

    return Model(logp_fn=logp, dim=dim, logp_grad_fn=logp_grad,
                 kernel_hook=("iid_normal", (mu,)), name=f"normal_{dim}d")
