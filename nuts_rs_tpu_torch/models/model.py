"""User-facing model contract.

Port of ``nuts_rs_tpu/models/model.py``.  A model is a scalar log density
over the unconstrained parameter vector; the sampler evaluates it batched
over chains, on ``[C, d]`` tensors.  Recoverable logp errors are NaN/-inf
values, which the sampler treats as divergences.

Where the JAX model carries its Pallas hooks (``pallas_spec``,
``pallas_logp_grad``, ``pallas_stream``, ``model.py:103-119``), this one
carries ``kernel_hook``: the name of a ``__device__`` model functor that is
compiled into the fused CUDA kernels (``csrc/models.cuh``), with its float
parameters and, for a model with data, its tensors: the counterpart of the
arrays in ``pallas_logp_grad`` that the Pallas kernels' ``model_args``
channel carries.  ``stream_tile_rows`` is the counterpart of
``pallas_stream`` (``StreamSpec``, ``model.py:23-70``): the same tensors,
evaluated in row tiles.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping, Optional

import torch

from ..kernels.rng import host_uniform

# Salt of the init-position draws (host stream, see kernels/rng.py).
SALT_INIT_POSITION = 0x1A11


@dataclasses.dataclass(frozen=True)
class Model:
    """A target distribution defined by an unnormalized log density.

    Parameters
    ----------
    logp_fn:
        ``logp_fn(q: Tensor[dim]) -> Tensor[]`` over one chain's position.
    dim:
        Number of unconstrained parameters.
    logp_grad_fn:
        Optional closed-form batched value and gradient,
        ``fn(q: Tensor[C, dim]) -> (logp Tensor[C], grad Tensor[C, dim])``.
        Without it the gradient comes from ``torch.func``.
    init_position_fn:
        Optional ``fn(u: Tensor[C, dim]) -> Tensor[C, dim]`` mapping
        uniforms in (0, 1) to initial positions; defaults to U(-2, 2) per
        coordinate (the nutpie convention).
    kernel_hook:
        ``(name, (float, ...))`` or ``(name, (float, ...), (tensor, ...))``:
        the device model functor the fused CUDA kernels evaluate, its float
        parameters and the model's data, float32 tensors in the layout the
        functor reads (``csrc/models.cuh``; ``kernels/_build.py`` checks
        them per functor and hands their device pointers and sizes to the
        launch).  The kernels' plain versions evaluate the functor's plain
        counterpart, ``gaussian.PLAIN_FUNCTORS[name](q, *floats, *tensors,
        csum)``.  Models without a hook cannot take the fused engine.
        :meth:`hook_parts` reads either form.
    stream_tile_rows:
        Rows of a tile when the hook's data are streamed (the JAX package's
        ``StreamSpec.tile_rows``), or None for a model whose data cannot
        stream.  The streamed evaluation reads the same hook tensors; its
        functor is the hook's name with ``_stream`` appended, in the kernels
        (``csrc/models.cuh``) and in ``gaussian.PLAIN_FUNCTORS``, whose
        entry is called ``fn(q, *floats, *tensors, tile_rows, csum)``.  The
        contract is the JAX one without its lane-aligned packing: rows in
        tiles of ``stream_tile_rows``, tiles in ascending order, a row past
        the data's end (the JAX model's zero-weight padding) contributing
        exactly nothing, the prior added last.  The posterior runner
        streams when the data fail the resident kernels' size rule
        (``chain.fused_layout``).
    on_device:
        ``fn(device) -> Model``: the same model with its data (hook tensors
        and whatever the closed forms capture) on ``device``; :meth:`to`
        calls it.  Models without data need none.
    args_bytes:
        Bytes of the JAX model's Pallas ``model_args`` where the hook holds
        the same data in another form (radon's group index in place of the
        one-hot ``G``), so that the size rules (:attr:`data_bytes`) choose
        the layout the JAX runners choose; None: the hook tensors' bytes.
    expand_fn:
        Optional deterministics stored beside the positions in the
        posterior groups (the JAX model's ``expand_fn``, ``model.py:82-85``;
        nuts-rs ``Math::expand_vector``).  ``expand_fn(q: Tensor[dim]) ->
        dict[str, Tensor]`` over one position, which the sampler applies
        to a chunk's ``[C, k, dim]`` positions on its device with
        ``torch.func.vmap``; or, where its second parameter is required,
        ``expand_fn(q: Tensor[C, k, dim], generator) -> dict[str,
        Tensor[C, k, ...]]`` over the whole chunk, with a
        ``torch.Generator`` on the sampler's device for its random draws
        (the JAX key's counterpart), seeded from the counter hash of
        (seed + 1, the chunk's first draw).
    expand_host_fn:
        Optional host-side expansion (``model.py:120-139``):
        ``expand_host_fn(positions: ndarray[C, k, dim]) -> dict[str,
        ndarray[C, k, ...]]`` on numpy arrays, any numpy dtype (strings,
        datetime64); a two-argument ``fn(positions, first_draw)`` whose
        second parameter is required also gets the chunk's first global
        draw index, so draw-indexed outputs do not depend on the chunk
        size.  ``schema()`` probes it once with zeros ``[C, 1, dim]``, so
        it should have no side effects.  Both expansions read the
        float32 positions whatever ``draw_dtype`` stores.
    dims / coords:
        xarray-style dimension names / coordinate arrays.
    """

    logp_fn: Callable[[torch.Tensor], torch.Tensor]
    dim: int
    logp_grad_fn: Optional[Callable] = None
    init_position_fn: Optional[Callable] = None
    kernel_hook: Optional[tuple] = None
    stream_tile_rows: Optional[int] = None
    on_device: Optional[Callable] = None
    args_bytes: Optional[int] = None
    expand_fn: Optional[Callable] = None
    expand_host_fn: Optional[Callable] = None
    dims: Mapping[str, Any] = dataclasses.field(default_factory=dict)
    coords: Mapping[str, Any] = dataclasses.field(default_factory=dict)
    name: str = "model"

    def hook_parts(self):
        """``(name, floats, tensors)`` of the kernel hook."""
        name, floats, *rest = self.kernel_hook
        return name, tuple(floats), tuple(rest[0]) if rest else ()

    @property
    def carries_data(self) -> bool:
        """Whether the kernels must read tensors of this model (the JAX
        package's ``model_args``)."""
        return self.kernel_hook is not None and bool(self.hook_parts()[2])

    @property
    def data_bytes(self) -> int:
        """Bytes of the hook tensors, or :attr:`args_bytes` where set: the
        JAX runners' ``args_bytes``."""
        if self.kernel_hook is None:
            return 0
        if self.args_bytes is not None:
            return self.args_bytes
        return sum(t.numel() * t.element_size() for t in self.hook_parts()[2])

    def to(self, device) -> "Model":
        """This model with its data on ``device`` (itself when it has
        none), with this model's expansions; the sampler calls it once, at
        construction."""
        if self.on_device is None:
            return self
        moved = self.on_device(torch.device(device))
        # the expansions as this model carries them, which a caller may
        # have replaced (``dataclasses.replace``) after the model was built
        return dataclasses.replace(moved, expand_fn=self.expand_fn,
                                   expand_host_fn=self.expand_host_fn)

    def logp_and_grad(self, q: torch.Tensor):
        """Batched ``(logp [C], grad [C, d])`` at ``q [C, d]``."""
        if self.logp_grad_fn is not None:
            return self.logp_grad_fn(q)
        from torch.func import grad_and_value, vmap

        grad, logp = vmap(grad_and_value(self.logp_fn))(q)
        return logp, grad

    def init_position(self, seed: int, attempt: int, num_chains: int,
                      dtype, device) -> torch.Tensor:
        """Initial positions [C, d] from the counter hash."""
        u = host_uniform(seed, attempt, SALT_INIT_POSITION,
                         (num_chains, self.dim), device)
        if self.init_position_fn is not None:
            q = self.init_position_fn(u)
        else:
            q = -2.0 + 4.0 * u
        return q.to(dtype)
