"""Cross-chain statistics pooling.

Port of ``merge_running_variance`` from ``nuts_rs_tpu/parallel/
collectives.py`` (``:20-51``).  The reference adapts every chain on its
own (SURVEY.md section 2.12); the JAX package can pool the adaptation's
statistics over every chain.  Here the chains are the leading axis of one
tensor on one device, so pooling is a sum over that axis; pooling over a
mesh of cards (the JAX ``psum``) is ROADMAP.md item 17b.
"""

from __future__ import annotations

from ..adapt.mass_matrix import RunningVariance


def merge_running_variance(rv: RunningVariance) -> RunningVariance:
    """Every chain's running-variance state merged into one, broadcast
    back to every chain: the parallel-Welford merge, with the
    count-weighted mean and each chain's ``var_sum`` augmented by the
    between-chain term n_i (m_i - m)^2."""
    counts = rv.count                                     # [C]
    C = counts.shape[0]
    n = counts.sum(0)
    mean = (counts[:, None] * rv.mean).sum(0) / n.clamp(min=1.0)
    between = counts[:, None] * (rv.mean - mean[None, :]).square()
    var_sum = (rv.var_sum + between).sum(0)
    return RunningVariance(mean=mean.expand(C, -1).contiguous(),
                           var_sum=var_sum.expand(C, -1).contiguous(),
                           count=n.expand(C).contiguous())
