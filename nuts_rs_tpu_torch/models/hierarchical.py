"""Hierarchical partial-pooling regression (the "radon" model family).

Port of ``nuts_rs_tpu/models/hierarchical.py``.  Generative model over
observations ``y_i`` in groups ``g_i`` with a covariate ``x_i``:

    mu_a    ~ N(0, 10),  sigma_a ~ HalfNormal(1)
    beta    ~ N(0, 10),  sigma   ~ HalfNormal(1)
    a_j     = mu_a + sigma_a * z_j,  z_j ~ N(0, 1)   (non-centered)
    y_i     ~ N(a_{g_i} + beta * x_i, sigma)

over ``q = [mu_a, beta, log_sigma, log_sigma_a, z_1..J]`` (dim = J + 4),
the HalfNormal priors with their ``+ log s`` Jacobians.

The sync-engine form (``logp_fn``) takes the group effect with the gather
``a[groups]``, as the JAX model's XLA path does.  The JAX model hands its
Pallas kernels a one-hot ``G [N, J]`` instead, because a gather does not
lower there; the device functor (``csrc/models.cuh::Radon``) needs neither:
it holds the rows stably sorted by group with the groups' row offsets, and
a thread walks its group's rows.  The size rules still count the JAX
model's arrays (``Model.args_bytes``), so both packages choose one layout.
"""

from __future__ import annotations

import numpy as np
import torch

from .model import Model

_HALF_LOG_2PI = float(0.5 * np.log(2.0 * np.pi))


def generate_radon(J: int = 85, n_per: int = 12, seed: int = 0):
    """Synthetic radon-style data with known ground truth
    (mu_a=1.5, sigma_a=0.3, beta=-0.7, sigma=0.8), drawn as the JAX
    package draws them."""
    rng = np.random.default_rng(seed)
    groups = np.repeat(np.arange(J), n_per)
    x = rng.binomial(1, 0.5, size=groups.shape[0]).astype(np.float64)
    a = 1.5 + 0.3 * rng.normal(size=J)
    y = a[groups] - 0.7 * x + 0.8 * rng.normal(size=groups.shape[0])
    return y, x, groups


def radon_tensors(y, x, groups, dtype=np.float32):
    """The ``radon`` functor's data: ``(x [N], y [N])`` (float32, or
    ``dtype``) in the rows' stable order by group and ``offsets [J + 1]``
    int32, group j's rows being ``offsets[j] .. offsets[j + 1] - 1`` of that
    order."""
    groups = np.asarray(groups, np.int64)
    J = int(groups.max()) + 1
    order = np.argsort(groups, kind="stable")
    offsets = np.zeros(J + 1, np.int32)
    offsets[1:] = np.cumsum(np.bincount(groups, minlength=J))
    return (torch.from_numpy(np.asarray(x, dtype)[order].copy()),
            torch.from_numpy(np.asarray(y, dtype)[order].copy()),
            torch.from_numpy(offsets))


def radon_logp_grad(q, x, y, offsets, csum):
    """Plain counterpart of the ``radon`` device functor
    (csrc/models.cuh::Radon): ``(logp [C], grad [C, d])`` at ``q [C, d]``.

    Group j's sums run over its rows in ascending order, each starting from
    0.0: ``u = r / sigma`` with the residual ``r = (a_j + beta x) - y``,
    ``Q_j = sum u u``, ``E_j = sum u / sigma``, ``X_j = sum (u / sigma) x``.
    The groups' sums, ``sum z z`` and ``sum z_j E_j`` go over the groups by
    ``csum``.  Here the groups are padded to their largest size and their
    rows added column by column.  The log density is the JAX model's
    (``hierarchical.py:71-86``) in its order of terms; the gradient is
    ``-(mu_a / 10) / 10 - E`` for mu_a, ``-(beta / 10) / 10 - X`` for beta,
    ``((1 - sigma^2) + Q) - N`` for log_sigma, ``(1 - sigma_a^2) - sigma_a
    sum z_j E_j`` for log_sigma_a and ``-z_j - sigma_a E_j`` for z_j."""
    C = q.shape[0]
    J = offsets.shape[0] - 1
    N = x.shape[0]
    sizes = (offsets[1:] - offsets[:-1]).long()
    n_max = int(sizes.max()) if J else 0
    cols = torch.arange(n_max, device=q.device)
    valid = cols[None, :] < sizes[:, None]                       # [J, n]
    rows = torch.where(valid, offsets[:-1, None].long() + cols[None, :], 0)
    xg, yg = x[rows].to(q.dtype), y[rows].to(q.dtype)            # [J, n]
    mu_a, beta, ls, lsa = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    z = q[:, 4:]
    sigma, sa = torch.exp(ls), torch.exp(lsa)
    a = mu_a[:, None] + sa[:, None] * z                          # [C, J]
    sig = sigma[:, None]
    zero = torch.zeros(C, J, dtype=q.dtype, device=q.device)
    Qg, Eg, Xg = zero, zero, zero
    for k in range(n_max):
        r = (a + beta[:, None] * xg[:, k]) - yg[:, k]
        u = r / sig
        e = u / sig
        m = valid[:, k]
        Qg = torch.where(m, Qg + u * u, Qg)
        Eg = torch.where(m, Eg + e, Eg)
        Xg = torch.where(m, Xg + e * xg[:, k], Xg)
    Q, E, X = csum(Qg), csum(Eg), csum(Xg)
    zz, zE = csum(z * z), csum(z * Eg)
    ten = torch.full_like(mu_a, 10.0)
    t1, t2 = mu_a / ten, beta / ten
    lp = -0.5 * (t1 * t1) - 0.5 * (t2 * t2)
    lp = lp + (-0.5 * (sigma * sigma) + ls)
    lp = lp + (-0.5 * (sa * sa) + lsa)
    lp = lp + -0.5 * zz
    lp = lp + (-0.5 * Q - N * (ls + _HALF_LOG_2PI))
    grad = torch.cat([
        (-(t1 / ten) - E)[:, None], (-(t2 / ten) - X)[:, None],
        (((1.0 - sigma * sigma) + Q) - N)[:, None],
        ((1.0 - sa * sa) - sa * zE)[:, None],
        -z - sa[:, None] * Eg], 1)
    return lp, grad


def radon(y: np.ndarray | None = None, x: np.ndarray | None = None,
          groups: np.ndarray | None = None, J: int = 85, n_per: int = 12,
          seed: int = 0) -> Model:
    """Build the hierarchical model; with ``y=None`` uses synthetic data
    from :func:`generate_radon`."""
    if y is None:
        if x is not None or groups is not None:
            raise ValueError("radon: pass all of (y, x, groups) or none")
        y, x, groups = generate_radon(J=J, n_per=n_per, seed=seed)
    elif x is None or groups is None:
        raise ValueError("radon: pass all of (y, x, groups) or none")
    y = np.asarray(y, np.float64)
    x = np.asarray(x, np.float64)
    groups = np.asarray(groups, np.int64)
    J = int(groups.max()) + 1
    N = y.shape[0]
    dim = J + 4

    def build(hook, yv, xv, gv):
        def logp(q):
            mu_a, beta, log_sigma, log_sigma_a = q[0], q[1], q[2], q[3]
            z = q[4:]
            sigma = torch.exp(log_sigma)
            sigma_a = torch.exp(log_sigma_a)
            a = mu_a + sigma_a * z
            resid = (a[gv] + beta * xv.to(q.dtype)) - yv.to(q.dtype)
            lp = -0.5 * (mu_a / 10.0) ** 2 - 0.5 * (beta / 10.0) ** 2
            lp = lp + (-0.5 * sigma ** 2 + log_sigma)
            lp = lp + (-0.5 * sigma_a ** 2 + log_sigma_a)
            lp = lp - 0.5 * torch.sum(z * z)
            return lp + (-0.5 * torch.sum((resid / sigma) ** 2)
                         - N * (log_sigma + _HALF_LOG_2PI))

        def expand(q):
            mu_a, log_sigma_a = q[0], q[3]
            return {"mu_a": mu_a, "beta": q[1], "sigma": torch.exp(q[2]),
                    "sigma_a": torch.exp(log_sigma_a),
                    "a": mu_a + torch.exp(log_sigma_a) * q[4:]}

        def on_device(dev):
            return build(tuple(t.to(dev) for t in hook), yv.to(dev),
                         xv.to(dev), gv.to(dev))

        return Model(
            logp_fn=logp, dim=dim, kernel_hook=("radon", (), hook),
            on_device=on_device, args_bytes=4 * (N * J + 2 * N),
            expand_fn=expand, dims={"a": ("group",)},
            coords={"group": np.arange(J)}, name=f"radon_J{J}")

    return build(radon_tensors(y, x, groups), torch.as_tensor(y),
                 torch.as_tensor(x), torch.as_tensor(groups))
