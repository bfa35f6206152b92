"""Diagonal mass-matrix estimation from draw/gradient variances.

Port of ``nuts_rs_tpu/adapt/mass_matrix.py`` (whole), batched over chains:
vectors are ``[C, d]`` and counts ``[C]``.  A foreground and a background
pair of running-variance estimators over accepted draws and gradients,
with the rule sigma^2 = sqrt(var_draw / var_grad) and translation
mu = mean_draw + sigma^2 * mean_grad (nuts-rs
``src/transform/adapt/diagonal.rs``).  ``var_sum`` accumulates
(x - running_mean_before)^2, as the reference's estimator does
(``cpu_math.rs:605-631``); it is not textbook Welford.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..transform.affine import AffineTransform, set_diag

LOWER_LIMIT = 1e-20
UPPER_LIMIT = 1e20


class RunningVariance(NamedTuple):
    mean: torch.Tensor     # [C, d]
    var_sum: torch.Tensor  # [C, d]
    count: torch.Tensor    # [C] float count of included samples


def new_running_variance(num_chains, dim, dtype, device) -> RunningVariance:
    return RunningVariance(
        mean=torch.zeros(num_chains, dim, dtype=dtype, device=device),
        var_sum=torch.zeros(num_chains, dim, dtype=dtype, device=device),
        count=torch.zeros(num_chains, dtype=dtype, device=device),
    )


def add_sample(rv: RunningVariance, value, include=True) -> RunningVariance:
    include = torch.as_tensor(include, device=value.device).expand(
        rv.count.shape)
    count = rv.count + include.to(rv.count.dtype)
    first = (count == 1.0)[:, None]
    diff = value - rv.mean
    mean = torch.where(first, value,
                       rv.mean + diff / torch.clamp(count, min=1.0)[:, None])
    var_sum = rv.var_sum + torch.where(first, torch.zeros_like(diff),
                                       diff * diff)
    inc = include[:, None]
    return RunningVariance(mean=torch.where(inc, mean, rv.mean),
                           var_sum=torch.where(inc, var_sum, rv.var_sum),
                           count=count)


class DiagAdaptState(NamedTuple):
    """Foreground + background estimator pairs (diagonal.rs:108-115)."""

    draw: RunningVariance
    grad: RunningVariance
    draw_bg: RunningVariance
    grad_bg: RunningVariance


def new_diag_adapt_state(num_chains, dim, dtype, device) -> DiagAdaptState:
    def rv():
        return new_running_variance(num_chains, dim, dtype, device)
    return DiagAdaptState(draw=rv(), grad=rv(), draw_bg=rv(), grad_bg=rv())


def update_estimators(s: DiagAdaptState, draw, grad, is_good) -> DiagAdaptState:
    """Feed fg and bg when the draw is good (diagonal.rs:134-141)."""
    return DiagAdaptState(
        draw=add_sample(s.draw, draw, is_good),
        grad=add_sample(s.grad, grad, is_good),
        draw_bg=add_sample(s.draw_bg, draw, is_good),
        grad_bg=add_sample(s.grad_bg, grad, is_good),
    )


def switch(s: DiagAdaptState) -> DiagAdaptState:
    """Promote background to foreground, reset background (diagonal.rs:143-148)."""
    C, d = s.draw.mean.shape
    dtype, device = s.draw.mean.dtype, s.draw.mean.device
    return DiagAdaptState(
        draw=s.draw_bg, grad=s.grad_bg,
        draw_bg=new_running_variance(C, d, dtype, device),
        grad_bg=new_running_variance(C, d, dtype, device),
    )


def adapt_diag(s: DiagAdaptState, transform: AffineTransform,
               use_grad_based_estimate: bool = True,
               update_mask=None) -> AffineTransform:
    """Recompute the diagonal transform from the foreground estimators
    (diagonal.rs:161-196); chains with fewer than 3 good samples keep their
    transform, and so do the chains outside ``update_mask`` [C] (the
    good-draw window mode's per-chain update decision)."""
    enough = s.draw.count >= 3.0
    if update_mask is not None:
        enough = enough & update_mask
    if use_grad_based_estimate:
        val = torch.sqrt(s.draw.var_sum / s.grad.var_sum)
    else:
        scale = 1.0 / torch.clamp(s.draw.count, min=1.0)
        val = s.draw.var_sum * scale[:, None]
    invalid = ~torch.isfinite(val) | (val == 0.0)
    var = torch.clamp(val, LOWER_LIMIT, UPPER_LIMIT)
    var = torch.where(invalid, torch.square(transform.stds), var)
    stds = torch.sqrt(var)
    if use_grad_based_estimate:
        mean = s.draw.mean + var * s.grad.mean
    else:
        mean = s.draw.mean
    return set_diag(transform, stds, mean, changed=enough)
