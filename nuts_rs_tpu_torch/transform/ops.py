"""Dispatch between the affine and the flow coordinate transforms.

Port of ``nuts_rs_tpu/transform/ops.py`` (``:33-125``).  The sampler's
dynamics are generic over the transformation (nuts-rs ``Transformation``
trait, src/transform/transformation.rs:12-71): the transform *state* is an
:class:`~nuts_rs_tpu_torch.transform.affine.AffineTransform` or a
:class:`FlowTransform` holding learned parameters, and the *operations* are
a Python object chosen once:

* ``AFFINE_OPS``: the diagonal or low-rank affine map, whose logdet is a
  constant of the transform.
* ``FlowOps(spec)``: a normalizing flow (``flows/coupling.py``): forward
  and inverse are batched PyTorch functions, the transformed gradient is
  the Jacobian transpose of the forward map by ``torch.autograd.grad``, and
  logdet depends on the position (nuts-rs ``ExternalTransformation``,
  src/transform/external.rs:10-104).

Every function takes ``[C, d]`` positions and parameters with a leading
chain axis, as the JAX package's vmapped pytrees carry them.  The flow's
products run under :func:`~nuts_rs_tpu_torch.ops.ieee_matmul` (TF32 off,
the counterpart of JAX's ``"highest"`` precision): the flow defines the
energy.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional

import torch

from ..ops import ieee_matmul
from .affine import (
    AffineTransform,
    grad_to_transformed,
    to_transformed,
    to_untransformed,
)


class FlowTransform(NamedTuple):
    """Flow transform state: learned parameters (a dict of tensors, each
    with a leading chain axis) and a version counter [C] int32, bumped on
    every refit."""

    params: Any
    id: torch.Tensor


@dataclasses.dataclass(frozen=True)
class FlowSpec:
    """The flow contract (the ``Math`` flow hooks of nuts-rs,
    src/math/math.rs:262-313).

    ``forward(params, z) -> (q, logdet)`` maps the standard-normal space to
    the parameter space; ``logdet`` is log|det dq/dz|, the forward
    Jacobian's log-determinant, and ``inverse(params, q) -> (z, logdet)``
    returns the same quantity at q.  Both take ``z``/``q`` [n, d] with
    ``params`` either per row (leading axis n) or shared (no leading axis).
    ``init(seed, dim, q0, g0) -> params`` per chain from [C, d] positions and
    gradients; ``update(seed, params, draws, grads, logps, mask) -> params``
    refits one set of parameters (no chain axis) from a training window.

    ``kernel_pack(params) -> PackedFlow`` flattens one set of parameters into
    the layout of the fused posterior kernel K1-flow (the counterpart of
    ``pallas_pack``; ``flows/coupling.py``, whose coupling layers the kernel
    evaluates, as ``pallas_forward`` does).  None: the flow runs on the sync
    engine only.
    """

    forward: Callable
    inverse: Callable
    init: Callable
    update: Callable
    kernel_pack: Optional[Callable] = None


def vjp(outputs, cotangents, x, create_graph=False):
    """The vector-Jacobian product of ``outputs`` at ``x`` with
    ``cotangents``; an output that does not depend on anything
    differentiable (the diagonal flow's constant logdet) contributes
    nothing."""
    pairs = [(o, c) for o, c in zip(outputs, cotangents) if o.requires_grad]
    grad, = torch.autograd.grad([o for o, _ in pairs], x,
                                grad_outputs=[c for _, c in pairs],
                                create_graph=create_graph, allow_unused=True)
    return torch.zeros_like(x) if grad is None else grad


def flow_vjp(spec: FlowSpec, params, z, g, create_graph=False):
    """(q, logdet, zg) at ``z``: zg = (dq/dz)^T g + d logdet / dz, the
    gradient of logp(F(z)) + logdet(z) with respect to z for a gradient
    ``g`` of logp at q = F(z).  With ``create_graph`` the result stays
    differentiable in the parameters (the Fisher loss's double backward);
    ``z`` may then be a function of them."""
    with torch.enable_grad(), ieee_matmul():
        if not create_graph:
            z = z.detach().requires_grad_(True)
        q, logdet = spec.forward(params, z)
        zg = vjp((q, logdet), (g, torch.ones_like(logdet)), z,
                 create_graph=create_graph)
    if not create_graph:
        q, logdet = q.detach(), logdet.detach()
    return q, logdet, zg


class AffineOps:
    """Operations on :class:`AffineTransform` states, diagonal or low-rank
    (``transform/affine.py`` carries the low-rank factors through)."""

    is_flow = False

    def eval_from_z(self, t: AffineTransform, z, logp_grad_fn):
        """z -> (q, logp, g, zg, logdet); the leapfrog's hot call."""
        q = to_untransformed(t, z)
        logp, g = logp_grad_fn(q)
        return q, logp, g, grad_to_transformed(t, g), t.logdet.to(z.dtype)

    def eval_from_q(self, t: AffineTransform, q, g, logp_grad_fn=None):
        """(q, g) -> (z, zg, logdet): re-sync the caches after a transform
        update (nuts-rs ``inv_transform_normalize``)."""
        return (to_transformed(t, q), grad_to_transformed(t, g),
                t.logdet.to(q.dtype))


class FlowOps:
    """Operations on :class:`FlowTransform` states."""

    is_flow = True

    def __init__(self, spec: FlowSpec):
        self.spec = spec

    def eval_from_z(self, t: FlowTransform, z, logp_grad_fn):
        with torch.enable_grad(), ieee_matmul():
            zz = z.detach().requires_grad_(True)
            q, logdet = self.spec.forward(t.params, zz)
        logp, g = logp_grad_fn(q.detach())
        with ieee_matmul():
            zg = vjp((q, logdet), (g, torch.ones_like(logdet)), zz)
        return q.detach(), logp, g, zg, logdet.detach()

    def eval_from_q(self, t: FlowTransform, q, g, logp_grad_fn=None):
        with ieee_matmul():
            z, logdet = self.spec.inverse(t.params, q)
        _, _, zg = flow_vjp(self.spec, t.params, z, g)
        return z, zg, logdet


AFFINE_OPS = AffineOps()
