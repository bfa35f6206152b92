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


def point_where(cond, a: Point, b: Point) -> Point:
    """Per-chain select between two points on a [C] bool mask."""
    def sel(x, y):
        return torch.where(cond.reshape(cond.shape + (1,) * (x.dim() - 1)),
                           x, y)
    return Point(*(sel(x, y) for x, y in zip(a, b)))
