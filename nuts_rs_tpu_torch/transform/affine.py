"""Affine (diagonal + optional low-rank) coordinate transformation, batched
over chains.

Port of ``nuts_rs_tpu/transform/affine.py`` (whole).  The sampler runs the
dynamics in the whitened space z; the transform maps between z and the
user's parameter space q:

  diagonal:   q = sigma * z + mean,              z = (q - mean) / sigma
  low-rank:   q = sigma * (L(z; U, sqrt(lam)) + mu_lr) + mean
              z = L((q - mean)/sigma - mu_lr; U, 1/sqrt(lam))
  where       L(r; U, w) = r + U ((w - 1) * (U^T r))

The gradient maps covariantly: zg = L(sigma * g; U, sqrt(lam)).  The
low-rank factors are padded to a static rank r; a padded column carries
eigenvalue 1, so it is an exact no-op (lam - 1 = 0).  A transform whose
``vecs`` is None is diagonal.  log|det J_{F^-1}| = sum(log(1/sigma)) -
1/2 sum(log lam) (nuts-rs ``src/transform/low_rank.rs:95-110``).  Every
field carries a leading chains axis.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..ops import hsum, ieee_matmul


class AffineTransform(NamedTuple):
    mean: torch.Tensor      # [C, d]
    stds: torch.Tensor      # [C, d]  sigma
    inv_stds: torch.Tensor  # [C, d]  1/sigma
    logdet: torch.Tensor    # [C]     log|det J_{F^-1}|
    id: torch.Tensor        # [C]     int32 version counter
    # the low-rank extension; None for a diagonal transform
    vecs: Optional[torch.Tensor] = None           # [C, d, r] orthonormal U
    vals_sqrt: Optional[torch.Tensor] = None      # [C, r] lam^{1/2}
    vals_sqrt_inv: Optional[torch.Tensor] = None  # [C, r] lam^{-1/2}
    mu_lr: Optional[torch.Tensor] = None          # [C, d] inner translation


def identity_transform(num_chains: int, dim: int, dtype, device,
                       rank: Optional[int] = None) -> AffineTransform:
    ones = torch.ones(num_chains, dim, dtype=dtype, device=device)
    t = AffineTransform(
        mean=torch.zeros(num_chains, dim, dtype=dtype, device=device),
        stds=ones,
        inv_stds=ones.clone(),
        logdet=torch.zeros(num_chains, dtype=dtype, device=device),
        id=torch.full((num_chains,), -1, dtype=torch.int32, device=device),
    )
    if rank is not None:
        t = t._replace(
            vecs=torch.zeros(num_chains, dim, rank, dtype=dtype,
                             device=device),
            vals_sqrt=torch.ones(num_chains, rank, dtype=dtype,
                                 device=device),
            vals_sqrt_inv=torch.ones(num_chains, rank, dtype=dtype,
                                     device=device),
            mu_lr=torch.zeros(num_chains, dim, dtype=dtype, device=device))
    return t


def _lowrank_apply(vecs, vals, rhs):
    """(I + U (diag(vals) - I) U^T) rhs, as two batched products in IEEE
    arithmetic (the counterpart of JAX's ``"highest"`` precision; nuts-rs
    ``Math::apply_lowrank_transform``, src/math/math.rs:131)."""
    with ieee_matmul():
        proj = torch.matmul(rhs[..., None, :], vecs)[..., 0, :]
        back = torch.matmul(vecs, ((vals - 1.0) * proj)[..., None])
    return rhs + back[..., 0]


def to_transformed(t: AffineTransform, q):
    """q -> z (nuts-rs ``compute_transformed_position``)."""
    z = (q - t.mean) * t.inv_stds
    if t.vecs is not None:
        z = _lowrank_apply(t.vecs, t.vals_sqrt_inv, z - t.mu_lr)
    return z


def to_untransformed(t: AffineTransform, z):
    """z -> q (nuts-rs ``compute_untransformed_position``)."""
    if t.vecs is not None:
        return (_lowrank_apply(t.vecs, t.vals_sqrt, z) + t.mu_lr) * t.stds \
            + t.mean
    return z * t.stds + t.mean


def grad_to_transformed(t: AffineTransform, g):
    """g -> zg = J_F^T g (nuts-rs ``compute_transformed_gradient``)."""
    zg = g * t.stds
    if t.vecs is not None:
        zg = _lowrank_apply(t.vecs, t.vals_sqrt, zg)
    return zg


def diag_logdet(inv_stds):
    return hsum(torch.log(inv_stds))


def _mask(changed, like):
    """``changed`` (bool or [C] bool) as a tensor on ``like``'s device."""
    return torch.as_tensor(changed, device=like.device)


def _rows(m, x):
    """The [C] mask ``m`` broadcast against ``x`` [C, ...]."""
    return m.reshape(m.shape + (1,) * (x.dim() - m.dim())) if m.dim() else m


def set_diag(t: AffineTransform, stds, mean, changed=True) -> AffineTransform:
    """Replace the diagonal part; ``changed`` (bool or [C] bool) keeps the
    old values where False.  A low-rank transform keeps its factors."""
    changed = _mask(changed, stds)
    stds = torch.where(_rows(changed, stds), stds, t.stds)
    mean = torch.where(_rows(changed, mean), mean, t.mean)
    inv_stds = 1.0 / stds
    logdet = diag_logdet(inv_stds)
    if t.vecs is not None:
        logdet = logdet - 0.5 * torch.sum(torch.log(torch.square(
            t.vals_sqrt)), -1)
    return t._replace(mean=mean, stds=stds, inv_stds=inv_stds, logdet=logdet,
                      id=t.id + changed.to(torch.int32))


def set_low_rank(t: AffineTransform, stds, mean, vals, vecs, mu_lr,
                 changed=True) -> AffineTransform:
    """Replace the whole transform (nuts-rs ``LowRankMassMatrix::update``,
    low_rank.rs:164-190): ``vals`` [C, r] are the filtered eigenvalues
    padded with 1.0; ``changed`` (bool or [C] bool) keeps a chain's old
    transform where False."""
    changed = _mask(changed, stds)

    def pick(new, old):
        return torch.where(_rows(changed, new), new, old)

    stds = pick(stds, t.stds)
    mean = pick(mean, t.mean)
    vals = pick(vals, torch.square(t.vals_sqrt))
    vecs = pick(vecs, t.vecs)
    mu_lr = pick(mu_lr, t.mu_lr)
    inv_stds = 1.0 / stds
    logdet = diag_logdet(inv_stds) - 0.5 * torch.sum(torch.log(vals), -1)
    vals_sqrt = torch.sqrt(vals)
    return t._replace(mean=mean, stds=stds, inv_stds=inv_stds, logdet=logdet,
                      vecs=vecs, vals_sqrt=vals_sqrt,
                      vals_sqrt_inv=1.0 / vals_sqrt, mu_lr=mu_lr,
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
