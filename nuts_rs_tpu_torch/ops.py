"""Reductions with a fixed summation order, and the other arithmetic that
kernels, plain versions and host code must spell alike.

Counterpart of ``nuts_rs_tpu/parallel/axis.py::dsum`` without the mesh
axis.  The fused CUDA kernels sum over the parameter axis in order
j = 0 .. d-1; the plain PyTorch versions use this helper so that both take
the same order and agree to the last bit wherever the elementwise math
agrees (``torch.sum`` may reduce in another order).

The dim-on-lanes (``ld``) kernels spread one chain's coordinates over the
``TSUM_THREADS`` threads of a CUDA block, so their sums cannot run in
coordinate order.  ``tsum`` is their order, shared with
``csrc/nuts_tree_ld.cuh::Reducer``: thread ``t`` sums its coordinates
``t, t + T, t + 2T, ...`` in ascending order (missing ones count as 0.0),
then the T partials are halved lane-wise inside each warp of 32
(16, 8, 4, 2, 1: the ``__shfl_xor_sync`` butterfly) and the warps' sums are
halved in turn (``x[:h] + x[h:]``).
"""

from __future__ import annotations

import contextlib

import torch

# Threads per chain of the ld kernels (nrt::LD_T in csrc/nuts_tree_ld.cuh).
# Part of the contract between the kernels and their plain versions.
TSUM_THREADS = 256


def _halve(x):
    """Sum over the last axis (a power of two) by ``x[:h] + x[h:]``."""
    h = x.shape[-1] // 2
    while h:
        x = x[..., :h] + x[..., h:2 * h]
        h //= 2
    return x[..., 0]


def tsum(x, T: int = TSUM_THREADS):
    """Sum over the last axis in the ld kernels' order (see above)."""
    d = x.shape[-1]
    n = -(-d // T)
    if n * T != d:
        x = torch.nn.functional.pad(x, (0, n * T - d))
    x = x.reshape(*x.shape[:-1], n, T)
    s = x[..., 0, :]
    for i in range(1, n):
        s = s + x[..., i, :]
    return _halve(_halve(s.reshape(*s.shape[:-1], T // 32, 32)))


def hsum(x):
    """The host code's sum over the last axis (energies, norms, log
    determinants, a model's closed form outside the kernels).  Not a third
    order, and no part of the contract with a kernel: host values are
    inputs that a kernel and its plain version share.  It chooses for cost
    alone: ``dsum`` up to ``TSUM_THREADS`` coordinates (what the host summed
    with before the dim-on-lanes layout, so its values at those sizes stay
    what they were), ``tsum`` above, a dozen tensor operations where
    ``dsum`` takes d."""
    return dsum(x) if x.shape[-1] <= TSUM_THREADS else tsum(x)


def dsum(x):
    """Sum over the last axis in order j = 0 .. d-1."""
    s = x[..., 0]
    for j in range(1, x.shape[-1]):
        s = s + x[..., j]
    return s


def logaddexp(x1, x2):
    """jax.lax.logaddexp's formula (lax/other.py) out of primitive tensor
    operations, which the kernels share (csrc/nuts_tree.cuh)."""
    amax = torch.maximum(x1, x2)
    delta = x1 - x2
    return torch.where(torch.isnan(delta), x1 + x2,
                       amax + torch.log1p(torch.exp(-torch.abs(delta))))


def tanh(x):
    """tanh(x) = sign(x) (1 - e) / (1 + e) with e = exp(-2 |x|): one
    definition from exp and IEEE arithmetic, which the flow kernel K1-flow
    (csrc/coupling_flow.cuh::ftanh) and its plain version share, so both
    round alike (CUDA's tanhf and torch.tanh need not).  Absolute error a
    few 1e-8 in float32."""
    e = torch.exp(-2.0 * torch.abs(x))
    return torch.copysign((1.0 - e) / (1.0 + e), x)


@contextlib.contextmanager
def ieee_matmul():
    """IEEE float32 matrix products on the card inside the block (no TF32),
    for the host's evaluation of a model whose energies the sampler
    compares; the setting is restored on leaving."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
