"""Chain state to and from numpy arrays.

No counterpart in the JAX package.  ``state_to_numpy`` reads any object
with the ``ChainState`` attribute layout (``pt``, ``transform``,
``diag_adapt``, ``step``, ``draw_idx``), so it takes this package's state
and the JAX package's state alike, without importing JAX; with
``state_from_numpy`` the tests start both packages from one state.  The
point carries its velocity ``v`` and kinetic energy ``ke``, which MCLMC
threads from one draw to the next, and the step state carries MCLMC's
jittered ``step_size``.  Model parameters pass through ``Model``
construction, not through the state; ``model_from_pallas_args`` builds a
data-carrying model of this package from the arrays the JAX model hands to
the Pallas kernels' ``model_args`` channel, or from those of its
``pallas_stream``.  A learned flow's parameters (``flows/coupling.py``, the
JAX package's pytree of the same keys, with or without the chain axis), its
``FlowTransform`` and its ``FlowWindow`` cross with
``flow_params_from_numpy``, ``flow_transform_from_numpy`` and
``flow_window_from_numpy``, so that both packages compute the same thing
from parameters the JAX package drew.
"""

from __future__ import annotations

import numpy as np
import torch

from .adapt.flow import FlowWindow
from .adapt.mass_matrix import DiagAdaptState, RunningVariance
from .adapt.step_size import StepSizeState
from .chain import ChainState
from .dynamics.point import Point
from .models.gaussian import (
    logistic_regression_from_tensors,
    logistic_regression_tensors,
)
from .transform.affine import AffineTransform
from .transform.ops import FlowTransform

_ESTIMATORS = ("draw", "grad", "draw_bg", "grad_bg")
_STEP_FIELDS = ("log_step", "log_step_adapted", "hbar", "mu", "count",
                "adam_m", "adam_v", "adam_t", "step_size")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def state_to_numpy(state) -> dict:
    """Flat dict of numpy arrays (leading chains axis) from a chain state."""
    pt, t = state.pt, state.transform
    out = {name: _np(getattr(pt, name))
           for name in ("q", "g", "z", "zg", "v", "logp", "ke")}
    out.update(stds=_np(t.stds), mean=_np(t.mean), logdet=_np(t.logdet),
               transform_id=_np(t.id))
    for est in _ESTIMATORS:
        rv = getattr(state.diag_adapt, est)
        out[f"{est}_mean"] = _np(rv.mean)
        out[f"{est}_var_sum"] = _np(rv.var_sum)
        out[f"{est}_count"] = _np(rv.count)
    for name in _STEP_FIELDS:
        out[f"step_{name}"] = _np(getattr(state.step, name))
    out["draw_idx"] = np.asarray(int(np.asarray(state.draw_idx)))
    return out


def state_from_numpy(arrays, device="cpu", dtype=torch.float32) -> ChainState:
    """The chain state of this package from :func:`state_to_numpy` arrays."""
    def f(name):
        return torch.as_tensor(np.array(arrays[name]), dtype=dtype,
                               device=device)

    def i32(name):
        return torch.as_tensor(np.array(arrays[name]), dtype=torch.int32,
                               device=device)

    stds = f("stds")
    transform = AffineTransform(mean=f("mean"), stds=stds,
                                inv_stds=1.0 / stds, logdet=f("logdet"),
                                id=i32("transform_id"))
    q = f("q")
    pt = Point(q=q, g=f("g"), z=f("z"), zg=f("zg"), v=f("v"), logp=f("logp"),
               logdet=transform.logdet, ke=f("ke"),
               idx=torch.zeros(q.shape[:-1], dtype=torch.int32,
                               device=device))
    diag = DiagAdaptState(*(
        RunningVariance(mean=f(f"{e}_mean"), var_sum=f(f"{e}_var_sum"),
                        count=f(f"{e}_count")) for e in _ESTIMATORS))
    step = StepSizeState(**{
        name: (i32 if name == "adam_t" else f)(f"step_{name}")
        for name in _STEP_FIELDS})
    return ChainState(pt=pt, transform=transform, diag_adapt=diag, step=step,
                      draw_idx=int(np.asarray(arrays["draw_idx"])))


def model_from_pallas_args(kind: str, args, name=None, tile_rows=None,
                           dim=None):
    """This package's model from the numpy arrays of the JAX model's
    ``pallas_logp_grad`` (``(fn, args)``) or ``pallas_stream``
    (``StreamSpec.args``), so that both packages evaluate the same data.
    ``kind`` names the model family and the form of ``args``:

    ``"logistic_regression"`` takes ``(x [N, d], y [N, 1])`` and holds them
    as the device functor reads them, ``(xt [d, N], y [N])``.

    ``"logistic_regression_stream"`` takes a stream spec's padded arrays and
    its ``tile_rows``: either ``(x [R, d], y [R, 1], w [R, 1])`` or the one
    packed array ``[R, PCOLS]`` of the shipped model (columns ``[0, dim)``
    x, ``dim`` y, ``dim + 1`` w; pass ``dim``), where ``w`` is 1 on the N
    rows of data and 0 on the padding rows that fill the last tile.  The
    port's functor needs no padding rows (a row past the data's end counts
    exactly nothing), so the model holds the N weighted rows as
    ``(xt [d, N], y [N])`` with ``stream_tile_rows = tile_rows``: the same
    tiles in the same order."""
    if kind == "logistic_regression_stream":
        if tile_rows is None:
            raise ValueError("a stream spec's arrays come with its tile_rows")
        arrays = [np.asarray(a) for a in args]
        if len(arrays) == 1:
            if dim is None:
                raise ValueError("the packed array needs the model's dim")
            p = arrays[0]
            x, y, w = p[:, :dim], p[:, dim], p[:, dim + 1]
        else:
            x, y, w = arrays
        w = w.reshape(-1)
        n = int(w.sum())
        if not (np.all(w[:n] == 1.0) and np.all(w[n:] == 0.0)
                and x.shape[0] - n < tile_rows):
            raise ValueError("stream weights must be 1 on the rows of data "
                             "and 0 on less than a tile of padding rows")
        return logistic_regression_from_tensors(
            *logistic_regression_tensors(x[:n], y.reshape(-1)[:n]),
            name=name, tile_rows=int(tile_rows))
    if kind != "logistic_regression":
        raise NotImplementedError(
            f"model_from_pallas_args converts the logistic regression's "
            f"arrays; build {kind!r} with its own constructor "
            "(nuts_rs_tpu_torch.models), which makes the JAX model's data")
    x, y = (np.asarray(a) for a in args)
    return logistic_regression_from_tensors(
        *logistic_regression_tensors(x, y), name=name)


def flow_params_to_numpy(params) -> dict:
    """A flow's parameter dict (``layers`` of ``mask`` and ``net`` {w1, b1,
    w2, b2}, ``log_sigma``, ``mu``; the diagonal flow has only the last two)
    as numpy arrays, from either package."""
    out = {k: _np(params[k]) for k in ("log_sigma", "mu")}
    if "layers" in params:
        out["layers"] = [
            {"mask": _np(layer["mask"]),
             "net": {k: _np(v) for k, v in layer["net"].items()}}
            for layer in params["layers"]]
    return out


def flow_params_from_numpy(params, device="cpu", dtype=torch.float32):
    """This package's flow parameters from a parameter pytree of numpy (or
    JAX) arrays with the JAX package's keys, with or without the chain
    axis."""
    def t(x):
        return torch.as_tensor(np.array(x), dtype=dtype, device=device)

    out = {k: t(params[k]) for k in ("log_sigma", "mu")}
    if "layers" in params:
        out["layers"] = [
            {"mask": t(layer["mask"]),
             "net": {k: t(v) for k, v in layer["net"].items()}}
            for layer in params["layers"]]
    return out


def flow_transform_from_numpy(params, transform_id, device="cpu",
                              dtype=torch.float32) -> FlowTransform:
    """A ``FlowTransform`` from per-chain parameters and the version counter
    [C] (the JAX ``FlowTransform.id``)."""
    return FlowTransform(
        params=flow_params_from_numpy(params, device, dtype),
        id=torch.as_tensor(np.array(transform_id), dtype=torch.int32,
                           device=device))


def flow_window_from_numpy(window, device="cpu",
                           dtype=torch.float32) -> FlowWindow:
    """A ``FlowWindow`` from the JAX one's arrays (draws, grads [C, cap, d],
    logps [C, cap], count [C])."""
    def t(x, dt=dtype):
        return torch.as_tensor(np.array(x), dtype=dt, device=device)

    return FlowWindow(draws=t(window.draws), grads=t(window.grads),
                      logps=t(window.logps),
                      count=t(window.count, torch.int32))
