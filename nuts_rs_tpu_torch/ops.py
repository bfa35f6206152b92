"""Reductions with a fixed summation order.

Counterpart of ``nuts_rs_tpu/parallel/axis.py::dsum`` without the mesh
axis.  The fused CUDA kernels sum over the parameter axis in order
j = 0 .. d-1; the plain PyTorch versions use this helper so that both take
the same order and agree to the last bit wherever the elementwise math
agrees (``torch.sum`` may reduce in another order).
"""

from __future__ import annotations


def dsum(x):
    """Sum over the last axis in order j = 0 .. d-1."""
    s = x[..., 0]
    for j in range(1, x.shape[-1]):
        s = s + x[..., j]
    return s
