"""Euclidean leapfrog and trajectory initialization, batched over chains.

Port of the Euclidean part of ``nuts_rs_tpu/dynamics/hamiltonian.py``
(``:31-229``).  Every function works on ``[C, d]`` tensors (the chain axis
that JAX adds with ``vmap`` is written out).  The other kinetic energies
(exact-normal, microcanonical) raise ``NotImplementedError``; they come
with MCLMC, queue-1 item 13 of ROADMAP.md.
"""

from __future__ import annotations

import enum
from typing import NamedTuple

import torch

from ..kernels.rng import host_normals
from ..ops import dsum
from ..transform.affine import (
    AffineTransform,
    grad_to_transformed,
    to_transformed,
    to_untransformed,
)
from .point import Point


class KineticKind(enum.Enum):
    EUCLIDEAN = "euclidean"
    EXACT_NORMAL = "exact_normal"
    MICROCANONICAL = "microcanonical"


def require_euclidean(kind: KineticKind) -> None:
    if kind is not KineticKind.EUCLIDEAN:
        raise NotImplementedError(
            f"kinetic_energy={kind.name} is not ported yet (ROADMAP.md "
            "queue 1 item 13, MCLMC and the non-Euclidean dynamics)")


class LeapfrogResult(NamedTuple):
    point: Point
    diverging: torch.Tensor     # [C] bool
    energy_error: torch.Tensor  # [C] E_new - energy_baseline


def leapfrog(pt: Point, direction, step_size, transform: AffineTransform,
             logp_grad_fn, kind: KineticKind, energy_baseline,
             max_energy_error, step_size_factor=1.0) -> LeapfrogResult:
    """One velocity-Verlet step (nuts-rs transformed_hamiltonian.rs:524-615).

    ``direction`` is +1/-1 (int or [C]); divergence is
    ``err > max_energy_error`` or a non-finite energy."""
    require_euclidean(kind)
    dtype = pt.z.dtype
    eps = (torch.as_tensor(direction, dtype=dtype, device=pt.z.device)
           * step_size * step_size_factor)
    eps = eps.expand(pt.z.shape[:-1])[..., None]
    v1 = pt.v + (eps / 2.0) * pt.zg
    z1 = pt.z + eps * v1
    q1 = to_untransformed(transform, z1)
    logp1, g1 = logp_grad_fn(q1)
    zg1 = grad_to_transformed(transform, g1)
    v2 = v1 + (eps / 2.0) * zg1
    new_pt = Point(
        q=q1, g=g1, z=z1, zg=zg1, v=v2, logp=logp1,
        logdet=transform.logdet.to(dtype),
        ke=0.5 * dsum(v2 * v2),
        idx=pt.idx + torch.as_tensor(direction, dtype=torch.int32,
                                     device=pt.z.device),
    )
    energy_error = new_pt.energy - energy_baseline
    diverging = (energy_error > max_energy_error) | ~torch.isfinite(
        energy_error)
    return LeapfrogResult(new_pt, diverging, energy_error)


def sample_momentum(seed: int, it: int, salt1: int, salt2: int, shape,
                    dtype, device, kind: KineticKind):
    """Fresh Gaussian momentum from the counter hash (flat index)."""
    require_euclidean(kind)
    return host_normals(seed, it, salt1, salt2, shape, device).to(dtype)


def init_point_from_q(q, transform: AffineTransform, logp_grad_fn) -> Point:
    """Build a full point from an untransformed position."""
    logp, g = logp_grad_fn(q)
    return Point(
        q=q, g=g, z=to_transformed(transform, q),
        zg=grad_to_transformed(transform, g),
        v=torch.zeros_like(q), logp=logp,
        logdet=transform.logdet.to(q.dtype),
        ke=torch.zeros_like(logp),
        idx=torch.zeros(q.shape[:-1], dtype=torch.int32, device=q.device),
    )


def initialize_trajectory(pt: Point, transform: AffineTransform,
                          kind: KineticKind, v) -> Point:
    """Set the momentum ``v`` and re-sync the transform cache before a draw
    (nuts-rs initialize_trajectory, transformed_hamiltonian.rs:687-736).
    The caller draws ``v`` (see ``sample_momentum``)."""
    require_euclidean(kind)
    return pt._replace(
        v=v, z=to_transformed(transform, pt.q),
        zg=grad_to_transformed(transform, pt.g),
        logdet=transform.logdet.to(pt.q.dtype),
        ke=0.5 * dsum(v * v),
        idx=torch.zeros_like(pt.idx),
    )
