"""User-facing model contract.

Port of ``nuts_rs_tpu/models/model.py``.  A model is a scalar log density
over the unconstrained parameter vector; the sampler evaluates it batched
over chains, on ``[C, d]`` tensors.  Recoverable logp errors are NaN/-inf
values, which the sampler treats as divergences.

Where the JAX model carries its Pallas hooks (``pallas_spec``,
``pallas_logp_grad``, ``pallas_stream``, ``model.py:103-119``), this one
carries ``kernel_hook``: the name of a ``__device__`` model functor that is
compiled into the fused CUDA kernels (``csrc/models.cuh``), with its float
parameters.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping, Optional

import torch

from ..kernels.rng import host_uniform

# Salt of the init-position draws (host stream, see kernels/rng.py).
SALT_INIT_POSITION = 0x1A11


@dataclasses.dataclass(frozen=True)
class Model:
    """A target distribution defined by an unnormalized log density.

    Parameters
    ----------
    logp_fn:
        ``logp_fn(q: Tensor[dim]) -> Tensor[]`` over one chain's position.
    dim:
        Number of unconstrained parameters.
    logp_grad_fn:
        Optional closed-form batched value and gradient,
        ``fn(q: Tensor[C, dim]) -> (logp Tensor[C], grad Tensor[C, dim])``.
        Without it the gradient comes from ``torch.func``.
    init_position_fn:
        Optional ``fn(u: Tensor[C, dim]) -> Tensor[C, dim]`` mapping
        uniforms in (0, 1) to initial positions; defaults to U(-2, 2) per
        coordinate (the nutpie convention).
    kernel_hook:
        ``(name, (float, ...))``: the device model functor the fused CUDA
        kernels evaluate, and its parameters; the kernels' plain versions
        evaluate its plain counterpart (``gaussian.PLAIN_FUNCTORS``).
        Models without one cannot take the fused engine.
    dims / coords:
        xarray-style dimension names / coordinate arrays.
    """

    logp_fn: Callable[[torch.Tensor], torch.Tensor]
    dim: int
    logp_grad_fn: Optional[Callable] = None
    init_position_fn: Optional[Callable] = None
    kernel_hook: Optional[tuple] = None
    dims: Mapping[str, Any] = dataclasses.field(default_factory=dict)
    coords: Mapping[str, Any] = dataclasses.field(default_factory=dict)
    name: str = "model"

    def logp_and_grad(self, q: torch.Tensor):
        """Batched ``(logp [C], grad [C, d])`` at ``q [C, d]``."""
        if self.logp_grad_fn is not None:
            return self.logp_grad_fn(q)
        from torch.func import grad_and_value, vmap

        grad, logp = vmap(grad_and_value(self.logp_fn))(q)
        return logp, grad

    def init_position(self, seed: int, attempt: int, num_chains: int,
                      dtype, device) -> torch.Tensor:
        """Initial positions [C, d] from the counter hash."""
        u = host_uniform(seed, attempt, SALT_INIT_POSITION,
                         (num_chains, self.dim), device)
        if self.init_position_fn is not None:
            q = self.init_position_fn(u)
        else:
            q = -2.0 + 4.0 * u
        return q.to(dtype)
