"""Leapfrog integrators, trajectory initialization and the MCLMC momentum
refresh, batched over chains.

Port of ``nuts_rs_tpu/dynamics/hamiltonian.py`` (``:31-250``) for its
three kinetic energies: Euclidean (velocity Verlet), exact-normal (the
geodesic integrator, exact for a standard-normal potential: a half kick by
``z + zg``, a rotation by the step, a half kick) and microcanonical (ESH,
unit-sphere momentum).  The transform enters through its operations ``ops``
(``transform/ops.py``: ``AFFINE_OPS`` by default, ``FlowOps`` for a flow,
whose logdet depends on the position), as in the JAX module
(``:80,113,178-215``).  Every function works on ``[C, d]`` tensors (the
chain axis that JAX adds with ``vmap`` is written out).  The exact-normal
kinetic energy runs on the sync engines only, as in the JAX package.
"""

from __future__ import annotations

import enum
import math
from typing import NamedTuple

import torch

from ..kernels.rng import host_normals
from ..ops import hsum
from ..transform.affine import AffineTransform
from ..transform.ops import AFFINE_OPS
from .point import Point


class KineticKind(enum.Enum):
    EUCLIDEAN = "euclidean"
    EXACT_NORMAL = "exact_normal"
    MICROCANONICAL = "microcanonical"


def esh_momentum_update(zg, v, step, csum=hsum):
    """One ESH momentum half-step; returns (v_new [C, d], delta_ke [C]).

    Port of ``_esh_momentum_update`` (``hamiltonian.py:40-61``; nuts-rs
    ``src/math/math.rs:188-204``).  ``step`` is [C]; ``csum`` sums over the
    parameter axis."""
    n = zg.shape[-1]
    grad_norm = torch.sqrt(csum(zg * zg))
    g_hat = zg / grad_norm[:, None]
    alpha = csum(v * g_hat)
    dims_m1 = float(n - 1)
    delta = step * grad_norm / dims_m1
    zeta = torch.exp(-delta)
    coeff_g = (1.0 - zeta) * (1.0 + zeta + alpha * (1.0 - zeta))
    v_raw = coeff_g[:, None] * g_hat + (2.0 * zeta)[:, None] * v
    v_new = v_raw / torch.sqrt(csum(v_raw * v_raw))[:, None]
    dke = (delta - math.log(2.0)
           + torch.log1p(alpha + (1.0 - alpha) * zeta * zeta)) * dims_m1
    return v_new, dke


class LeapfrogResult(NamedTuple):
    point: Point
    diverging: torch.Tensor     # [C] bool
    energy_error: torch.Tensor  # [C] E_new - energy_baseline


def leapfrog(pt: Point, direction, step_size, transform: AffineTransform,
             logp_grad_fn, kind: KineticKind, energy_baseline,
             max_energy_error, step_size_factor=1.0,
             csum=hsum, ops=AFFINE_OPS) -> LeapfrogResult:
    """One leapfrog step (nuts-rs transformed_hamiltonian.rs:524-615).

    ``direction`` is +1/-1 (int or [C]).  Divergence: Euclidean and
    exact-normal use ``err > max_energy_error``, microcanonical
    ``|err| >= max_energy_error``; a non-finite energy always diverges.
    ``csum`` sums over the parameter axis (the host's ``hsum``; the sync
    engines pass ``torch.sum``)."""
    dtype = pt.z.dtype
    if isinstance(direction, int):
        # a host direction multiplies last: +-1 times a product is exact,
        # so the bits are those of direction * step * factor, without a
        # host-to-device copy of the direction
        eps_c = torch.as_tensor(step_size * step_size_factor * direction,
                                dtype=dtype, device=pt.z.device)
    else:
        eps_c = (torch.as_tensor(direction, dtype=dtype, device=pt.z.device)
                 * step_size * step_size_factor)
    eps_c = eps_c.expand(pt.z.shape[:-1])
    eps = eps_c[..., None]
    micro = kind is KineticKind.MICROCANONICAL
    exact = kind is KineticKind.EXACT_NORMAL
    sqrt_n = math.sqrt(pt.z.shape[-1])
    ke = pt.ke
    if micro:
        v1, dke1 = esh_momentum_update(pt.zg, pt.v, sqrt_n * eps_c / 2.0,
                                       csum)
        ke = ke + dke1
        z1 = pt.z + eps * sqrt_n * v1
    elif exact:
        # std_norm_grad_flow, then std_norm_flow (util.rs:650,507-511)
        v1 = pt.v + (eps / 2.0) * (pt.z + pt.zg)
        cos_e, sin_e = torch.cos(eps), torch.sin(eps)
        z1 = pt.z * cos_e + v1 * sin_e
        v1 = -pt.z * sin_e + v1 * cos_e
    else:
        v1 = pt.v + (eps / 2.0) * pt.zg
        z1 = pt.z + eps * v1
    q1, logp1, g1, zg1, logdet1 = ops.eval_from_z(transform, z1,
                                                  logp_grad_fn)
    if micro:
        v2, dke2 = esh_momentum_update(zg1, v1, sqrt_n * eps_c / 2.0, csum)
        ke = ke + dke2
    elif exact:
        v2 = v1 + (eps / 2.0) * (z1 + zg1)
        ke = 0.5 * csum(v2 * v2)
    else:
        v2 = v1 + (eps / 2.0) * zg1
        ke = 0.5 * csum(v2 * v2)
    new_pt = Point(
        q=q1, g=g1, z=z1, zg=zg1, v=v2, logp=logp1,
        logdet=logdet1.to(dtype), ke=ke,
        idx=pt.idx + (direction if isinstance(direction, int) else
                      torch.as_tensor(direction, dtype=torch.int32,
                                      device=pt.z.device)),
    )
    energy_error = new_pt.energy - energy_baseline
    if micro:
        bad = torch.abs(energy_error) >= max_energy_error
    else:
        bad = energy_error > max_energy_error
    diverging = bad | ~torch.isfinite(energy_error)
    return LeapfrogResult(new_pt, diverging, energy_error)


def is_turning(z1, v1, i1, z2, v2, i2):
    """U-turn criterion between two trajectory states, per chain (port of
    ``hamiltonian.py:147-163``; nuts-rs transformed_hamiltonian.rs:617-638):
    order the states by index in trajectory; with dz = z_end - z_start the
    trajectory turns if dz . v_start < 0 or dz . v_end < 0.  ``z``, ``v`` are
    [C, d] and ``i`` [C]."""
    swap = (i1 > i2)[..., None]
    z_lo, v_lo = torch.where(swap, z2, z1), torch.where(swap, v2, v1)
    z_hi, v_hi = torch.where(swap, z1, z2), torch.where(swap, v1, v2)
    dz = z_hi - z_lo
    return (hsum(dz * v_lo) < 0.0) | (hsum(dz * v_hi) < 0.0)


def sample_momentum(seed: int, it: int, salt1: int, salt2: int, shape,
                    dtype, device, kind: KineticKind, csum=hsum):
    """Fresh Gaussian momentum from the counter hash (flat index); on the
    unit sphere for the microcanonical kind (transformed_hamiltonian.rs
    :696-704); Gaussian for the Euclidean and exact-normal kinds."""
    v = host_normals(seed, it, salt1, salt2, shape, device).to(dtype)
    if kind is KineticKind.MICROCANONICAL:
        v = v / torch.sqrt(csum(v * v))[..., None]
    return v


def init_point_from_q(q, transform: AffineTransform, logp_grad_fn,
                      ops=AFFINE_OPS) -> Point:
    """Build a full point from an untransformed position."""
    logp, g = logp_grad_fn(q)
    z, zg, logdet = ops.eval_from_q(transform, q, g, logp_grad_fn)
    return Point(
        q=q, g=g, z=z, zg=zg,
        v=torch.zeros_like(q), logp=logp,
        logdet=logdet.to(q.dtype),
        ke=torch.zeros_like(logp),
        idx=torch.zeros(q.shape[:-1], dtype=torch.int32, device=q.device),
    )


def initialize_trajectory(pt: Point, transform: AffineTransform,
                          kind: KineticKind, v=None,
                          ops=AFFINE_OPS, csum=hsum) -> Point:
    """Set the momentum and re-sync the transform cache before a draw
    (nuts-rs initialize_trajectory, transformed_hamiltonian.rs:687-736).
    The caller draws a fresh ``v`` (see ``sample_momentum``); ``v=None``
    carries ``pt.v`` verbatim, as ``resample_velocity=False`` does.  Under a
    flow the re-sync is an inverse and a forward vector-Jacobian product.
    The kinetic energy is 0 on the unit sphere, ``0.5 |v|^2`` for the
    Euclidean and exact-normal kinds."""
    v = pt.v if v is None else v
    z, zg, logdet = ops.eval_from_q(transform, pt.q, pt.g)
    if kind is KineticKind.MICROCANONICAL:
        ke = torch.zeros_like(pt.logp)
    else:
        ke = 0.5 * csum(v * v)
    return pt._replace(
        v=v, z=z, zg=zg, logdet=logdet.to(pt.q.dtype), ke=ke,
        idx=torch.zeros_like(pt.idx),
    )


def refresh_coefficients(step_size, factor, decoherence_length,
                         kind: KineticKind, v):
    """The partial refresh's coefficients for velocities like ``v`` [C, d]
    (transformed_hamiltonian.rs:777-826), with h = step * factor / 2:
    microcanonical nu = sqrt(expm1(2 h / L) / n); Euclidean and
    exact-normal (alpha, beta) = (exp(-h / L), sqrt(1 - alpha^2)), each
    [C, 1].  ``step_size`` and ``factor`` are floats or [C]."""
    half_step = torch.as_tensor(step_size * factor / 2.0,
                                dtype=v.dtype, device=v.device)
    half_step = half_step.expand(v.shape[:-1])[..., None]
    if kind is KineticKind.MICROCANONICAL:
        n = float(v.shape[-1])
        return torch.sqrt(torch.expm1(2.0 * half_step / decoherence_length)
                          / n)
    alpha = torch.exp(-half_step / decoherence_length)
    return alpha, torch.sqrt(1.0 - alpha * alpha)


def refresh_momentum(pt: Point, noise, coeffs, kind: KineticKind,
                     csum=hsum) -> Point:
    """The partial refresh with ``refresh_coefficients``' ``coeffs``:
    microcanonical v <- normalize(v + nu z), else
    v <- alpha v + beta z with ke = |v|^2 / 2."""
    if kind is KineticKind.MICROCANONICAL:
        v = pt.v + coeffs * noise
        return pt._replace(v=v / torch.sqrt(csum(v * v))[..., None])
    alpha, beta = coeffs
    v = alpha * pt.v + beta * noise
    return pt._replace(v=v, ke=0.5 * csum(v * v))


def partial_momentum_refresh(pt: Point, noise, step_size, factor,
                             decoherence_length, kind: KineticKind) -> Point:
    """MCLMC Ornstein-Uhlenbeck partial momentum refresh
    (transformed_hamiltonian.rs:777-826): ``refresh_momentum`` with the
    coefficients of ``step_size * factor``."""
    return refresh_momentum(pt, noise, refresh_coefficients(
        step_size, factor, decoherence_length, kind, pt.v), kind)
