"""The port's low-rank affine transform (``transform/affine.py``) against
the JAX package's, on the CPU.

Twin of ``tests/test_transforms.py`` and the transform half of
``tests/test_low_rank.py``: round trips, the gradient map against the
dense Jacobian, the log determinant against ``torch.linalg.slogdet`` of
the dense Jacobian at float64, and ``to_transformed`` /
``to_untransformed`` / ``grad_to_transformed`` against the JAX functions
(vmapped over chains) from one set of factors made with numpy: rtol 1e-12
at float64, 2e-6 at float32.  ``set_diag`` keeps a low-rank transform's
factors (``init_diag_from_grad`` goes through it at a low-rank run's
start)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nuts_rs_tpu.transform import affine as jaff
from nuts_rs_tpu_torch.transform import affine as taff
from nuts_rs_tpu_torch.transform.ops import AFFINE_OPS

C, D, R = 3, 5, 2
TOL = {torch.float64: dict(rtol=1e-12, atol=1e-12),
       torch.float32: dict(rtol=2e-6, atol=2e-6)}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _factors(seed=0, c=C, d=D, r=R):
    """Per-chain factors: orthonormal columns, eigenvalues around 1 (one
    above, one below), positive stds, a mean and an inner translation."""
    rng = np.random.default_rng(seed)
    vecs = np.stack([np.linalg.qr(rng.normal(size=(d, r)))[0]
                     for _ in range(c)])
    vals = np.exp(rng.normal(size=(c, r)) * 1.5)
    return dict(stds=np.exp(rng.normal(size=(c, d)) * 0.5),
                mean=rng.normal(size=(c, d)), vals=vals, vecs=vecs,
                mu_lr=rng.normal(size=(c, d)) * 0.3)


def _torch_t(f, dtype):
    c, d = f["stds"].shape
    t = taff.identity_transform(c, d, dtype, "cpu", rank=f["vecs"].shape[-1])
    ones = torch.ones(c, dtype=torch.bool)
    t = taff.set_low_rank(
        t, *(torch.as_tensor(f[k], dtype=dtype) for k in (
            "stds", "mean", "vals", "vecs", "mu_lr")), changed=ones)
    return t


def _jax_t(f, dtype):
    def one(stds, mean, vals, vecs, mu_lr):
        t = jaff.identity_transform(stds.shape[0], dtype, rank=vals.shape[0])
        return jaff.set_low_rank(t, stds, mean, vals, vecs, mu_lr)
    return jax.vmap(one)(*(jnp.asarray(f[k], dtype) for k in (
        "stds", "mean", "vals", "vecs", "mu_lr")))


def _np(x):
    return np.asarray(x.detach() if torch.is_tensor(x) else x)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_maps_equal_the_jax_ones(dtype):
    f = _factors(1)
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    t, jt = _torch_t(f, dtype), _jax_t(f, jdt)
    rng = np.random.default_rng(7)
    x = rng.normal(size=(C, D))
    for name, fn, jfn in (
            ("to_transformed", taff.to_transformed, jaff.to_transformed),
            ("to_untransformed", taff.to_untransformed, jaff.to_untransformed),
            ("grad_to_transformed", taff.grad_to_transformed,
             jaff.grad_to_transformed)):
        got = fn(t, torch.as_tensor(x, dtype=dtype))
        want = jax.vmap(jfn)(jt, jnp.asarray(x, jdt))
        assert got.dtype == dtype
        np.testing.assert_allclose(_np(got), np.asarray(want),
                                   **TOL[dtype], err_msg=name)
    np.testing.assert_allclose(_np(t.logdet), np.asarray(jt.logdet),
                               **TOL[dtype])
    for name in ("vals_sqrt", "vals_sqrt_inv", "inv_stds"):
        np.testing.assert_allclose(_np(getattr(t, name)),
                                   np.asarray(getattr(jt, name)),
                                   **TOL[dtype], err_msg=name)
    np.testing.assert_array_equal(_np(t.id), np.asarray(jt.id))


def test_round_trips():
    f = _factors(2)
    t = _torch_t(f, torch.float64)
    rng = np.random.default_rng(3)
    x = torch.as_tensor(rng.normal(size=(C, D)))
    torch.testing.assert_close(taff.to_untransformed(t, taff.to_transformed(
        t, x)), x, rtol=0, atol=1e-12)
    torch.testing.assert_close(taff.to_transformed(t, taff.to_untransformed(
        t, x)), x, rtol=0, atol=1e-12)


def _dense_jacobian(t, c):
    """dq/dz of chain c, column by column (the map is affine)."""
    z0 = torch.zeros(C, D, dtype=torch.float64)
    q0 = taff.to_untransformed(t, z0)[c]
    cols = []
    for j in range(D):
        e = z0.clone()
        e[c, j] = 1.0
        cols.append(taff.to_untransformed(t, e)[c] - q0)
    return torch.stack(cols, 1)


def test_gradient_map_and_logdet_against_the_dense_jacobian():
    f = _factors(4)
    t = _torch_t(f, torch.float64)
    g = torch.as_tensor(np.random.default_rng(5).normal(size=(C, D)))
    zg = taff.grad_to_transformed(t, g)
    for c in range(C):
        jac = _dense_jacobian(t, c)
        # against the autograd Jacobian too
        auto = torch.autograd.functional.jacobian(
            lambda z: taff.to_untransformed(
                t, torch.cat([torch.zeros(c, D, dtype=z.dtype), z[None],
                              torch.zeros(C - c - 1, D, dtype=z.dtype)]))[c],
            torch.zeros(D, dtype=torch.float64))
        torch.testing.assert_close(jac, auto, rtol=1e-12, atol=1e-12)
        torch.testing.assert_close(zg[c], jac.T @ g[c], rtol=1e-12,
                                   atol=1e-12)
        # log|det J_{F^-1}| = -log|det dq/dz|
        sign, logabs = torch.linalg.slogdet(jac)
        assert float(sign) > 0
        torch.testing.assert_close(t.logdet[c], -logabs, rtol=1e-12,
                                   atol=1e-12)


def test_padded_low_rank_is_diagonal():
    f = _factors(6)
    f["vals"] = np.ones_like(f["vals"])
    f["mu_lr"] = np.zeros_like(f["mu_lr"])
    t = _torch_t(f, torch.float64)
    d = taff.set_diag(taff.identity_transform(C, D, torch.float64, "cpu"),
                      torch.as_tensor(f["stds"]), torch.as_tensor(f["mean"]))
    x = torch.as_tensor(np.random.default_rng(0).normal(size=(C, D)))
    torch.testing.assert_close(taff.to_transformed(t, x),
                               taff.to_transformed(d, x), rtol=0, atol=1e-12)
    torch.testing.assert_close(t.logdet, d.logdet, rtol=0, atol=1e-12)


def test_set_diag_keeps_the_factors():
    """The port's old ``set_diag`` rebuilt the tuple from its five
    diagonal fields and would have dropped the factors; the JAX one
    replaces the diagonal part and adds the factors' -1/2 sum log lam."""
    f = _factors(8)
    t = _torch_t(f, torch.float64)
    jt = _jax_t(f, jnp.float64)
    rng = np.random.default_rng(9)
    q, g = rng.normal(size=(C, D)), rng.normal(size=(C, D))
    t2 = taff.init_diag_from_grad(t, torch.as_tensor(q), torch.as_tensor(g))
    jt2 = jax.vmap(jaff.init_diag_from_grad)(jt, jnp.asarray(q),
                                             jnp.asarray(g))
    for name in ("vecs", "vals_sqrt", "vals_sqrt_inv", "mu_lr"):
        assert getattr(t2, name) is getattr(t, name)
    for name in ("stds", "mean", "logdet"):
        np.testing.assert_allclose(_np(getattr(t2, name)),
                                   np.asarray(getattr(jt2, name)),
                                   rtol=1e-12, atol=1e-12, err_msg=name)
    np.testing.assert_array_equal(_np(t2.id), np.asarray(jt2.id))
    # a per-chain mask keeps the other chains' diagonal part
    keep = torch.tensor([True, False, True])
    t3 = taff.set_diag(t, t2.stds, t2.mean, changed=keep)
    torch.testing.assert_close(t3.stds[1], t.stds[1])
    torch.testing.assert_close(t3.stds[0], t2.stds[0])
    assert t3.id.tolist() == (t.id + keep.to(torch.int32)).tolist()


def test_affine_ops_carry_the_low_rank_transform():
    f = _factors(10)
    t = _torch_t(f, torch.float64)
    z = torch.as_tensor(np.random.default_rng(11).normal(size=(C, D)))

    def logp_grad(q):
        return -0.5 * (q * q).sum(-1), -q

    q, logp, g, zg, logdet = AFFINE_OPS.eval_from_z(t, z, logp_grad)
    torch.testing.assert_close(q, taff.to_untransformed(t, z))
    torch.testing.assert_close(zg, taff.grad_to_transformed(t, -q))
    assert logdet is t.logdet or torch.equal(logdet, t.logdet)
    z2, zg2, _ = AFFINE_OPS.eval_from_q(t, q, g)
    torch.testing.assert_close(z2, z, rtol=0, atol=1e-12)
    torch.testing.assert_close(zg2, zg)
