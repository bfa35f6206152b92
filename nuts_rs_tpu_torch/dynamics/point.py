"""Phase-space point, batched over chains.

Port of ``nuts_rs_tpu/dynamics/point.py``: a NamedTuple of tensors with a
leading chains axis.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class Point(NamedTuple):
    q: torch.Tensor       # [C, d] untransformed position
    g: torch.Tensor       # [C, d] gradient of logp wrt q
    z: torch.Tensor       # [C, d] transformed position
    zg: torch.Tensor      # [C, d] transformed gradient
    v: torch.Tensor       # [C, d] velocity
    logp: torch.Tensor    # [C]
    logdet: torch.Tensor  # [C]
    ke: torch.Tensor      # [C] kinetic energy 0.5 |v|^2
    idx: torch.Tensor     # [C] int32 signed index in trajectory

    @property
    def energy(self) -> torch.Tensor:
        """E = KE - (logp + logdet)."""
        return self.ke - (self.logp + self.logdet)


def chains_where(cond, a, b):
    """Per-chain select on a [C] bool mask between two tensors with a
    leading chains axis, or two (nested) tuples of such tensors (a None
    field, a diagonal transform's low-rank ones, stays None)."""
    if a is None:
        return None
    if isinstance(a, torch.Tensor):
        return torch.where(cond.reshape(cond.shape + (1,) * (a.dim() - 1)),
                           a, b)
    return type(a)(*(chains_where(cond, x, y) for x, y in zip(a, b)))


def point_where(cond, a: Point, b: Point) -> Point:
    """Per-chain select between two points on a [C] bool mask."""
    return chains_where(cond, a, b)
