"""Diagonal affine coordinate transformation, batched over chains.

Port of the diagonal part of ``nuts_rs_tpu/transform/affine.py``
(``:37-134,163-171``).  The sampler runs the dynamics in the whitened space
z, with ``q = sigma * z + mean``.  Every field carries a leading chains
axis.  The low-rank part is queue-1 item 14 of ROADMAP.md.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops import hsum


class AffineTransform(NamedTuple):
    mean: torch.Tensor      # [C, d]
    stds: torch.Tensor      # [C, d]  sigma
    inv_stds: torch.Tensor  # [C, d]  1/sigma
    logdet: torch.Tensor    # [C]     log|det J_{F^-1}|
    id: torch.Tensor        # [C]     int32 version counter


def identity_transform(num_chains: int, dim: int, dtype,
                       device) -> AffineTransform:
    ones = torch.ones(num_chains, dim, dtype=dtype, device=device)
    return AffineTransform(
        mean=torch.zeros(num_chains, dim, dtype=dtype, device=device),
        stds=ones,
        inv_stds=ones.clone(),
        logdet=torch.zeros(num_chains, dtype=dtype, device=device),
        id=torch.full((num_chains,), -1, dtype=torch.int32, device=device),
    )


def to_transformed(t: AffineTransform, q):
    """q -> z."""
    return (q - t.mean) * t.inv_stds


def to_untransformed(t: AffineTransform, z):
    """z -> q."""
    return z * t.stds + t.mean


def grad_to_transformed(t: AffineTransform, g):
    """g -> zg."""
    return g * t.stds


def diag_logdet(inv_stds):
    return hsum(torch.log(inv_stds))


def set_diag(t: AffineTransform, stds, mean, changed=True) -> AffineTransform:
    """Replace the diagonal part; ``changed`` (bool or [C] bool) keeps the
    old values where False."""
    changed = torch.as_tensor(changed, device=stds.device)
    c2 = changed[..., None] if changed.dim() else changed
    stds = torch.where(c2, stds, t.stds)
    mean = torch.where(c2, mean, t.mean)
    inv_stds = 1.0 / stds
    return AffineTransform(mean=mean, stds=stds, inv_stds=inv_stds,
                           logdet=diag_logdet(inv_stds),
                           id=t.id + changed.to(torch.int32))


def init_diag_from_grad(t: AffineTransform, q, g, fill_invalid: float = 1.0,
                        clamp=(1e-20, 1e20)) -> AffineTransform:
    """sigma^2 = 1/|g| initial guess (nuts-rs diagonal.rs:133-154)."""
    var = 1.0 / torch.clamp(torch.abs(g), clamp[0], clamp[1])
    var = torch.where(torch.isfinite(var), var,
                      torch.full_like(var, fill_invalid))
    stds = torch.sqrt(var)
    mean = q + var * g
    return set_diag(t, stds, mean)
