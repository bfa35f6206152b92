"""Counter-based random numbers for the fused kernels and the host code.

Counterpart of ``nuts_rs_tpu/kernels/nuts_pallas.py`` ``_hash_bits``,
``_uniform``, ``_normals`` (``:65-79,180-194``) and ``_tz`` (``:54-62``);
``csrc/rng.cuh`` is the device twin of this module.

Every random number of the port comes from the murmur3 finalizer keyed by
``(seed, it, salt, idx)``.  The hash gives the same bits on the CPU and the
GPU (a ``torch.Generator`` does not), which is what lets a CUDA kernel be
held draw for draw against its plain PyTorch version.  ``torch.uint32``
lacks most operators, so the arithmetic runs in int64 and is masked to 32
bits; products are split into 16-bit halves so no int64 product overflows.

Fused-kernel sites follow the Pallas kernels' block layout: chain ``c``
lives in block ``pid = c // B`` at lane ``b = c % B``; the block's seed is
``seed + 0x51ED2701 * pid``; a scalar site has index ``b`` and a vector
site, coordinate ``j``, index ``j * B + b`` (the flat position in the
block's ``(d, B)`` shape).  In the dim-on-lanes layout (``layout="ld"``)
the block's vectors are ``(B, d)``, so a vector site has index
``b * d + j``; scalar sites and the block seed are the same.

A launch over a group of chains (``Sampler(max_chains_per_launch=B)``)
runs under :func:`chain_offset`: the host-side sites, whose flat index
leads with the chain, are shifted to the group's global chains, so the
sync engines and the launch jitter draw what one launch of every chain
draws; a fused kernel's program ids restart at 0 in each group, as in the
JAX package, whose runners salt each group's seed with its first chain's
key (``nuts_rs_tpu/chain.py:838-845``): :func:`group_seed` salts it with
the first chain's index.
"""

from __future__ import annotations

import contextlib
import contextvars
import math

import torch

MASK32 = 0xFFFFFFFF
PID_MUL = 0x51ED2701
_SALT_MUL = 2654435761
_IT_MUL = 0x9E3779B9
_IDX_MUL = 0x85EBCA77
_U_LO = 1e-12
_U_HI = 1.0 - 1e-7
TWO_PI = 2.0 * math.pi


def _mul32(x, c: int):
    """(x * c) mod 2^32 for int64 ``x`` in [0, 2^32) and a constant ``c``."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK32


def hash_bits(seed, it, salt: int, idx):
    """murmur3-finalized uint32 bits, as int64 values in [0, 2^32).

    ``seed``, ``it`` and ``idx`` are ints or int64 tensors (broadcast
    together); ``salt`` is a static site number, or an int64 tensor of
    site numbers that broadcasts with them.
    """
    if isinstance(salt, torch.Tensor):
        salt_c = _mul32(salt, _SALT_MUL)
    else:
        salt_c = (salt * _SALT_MUL) & MASK32
    h = ((seed & MASK32) ^ salt_c)
    h = (h + _mul32(torch.as_tensor(it, dtype=torch.int64) & MASK32, _IT_MUL)
         + _mul32(idx & MASK32, _IDX_MUL)) & MASK32
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    h = h ^ (h >> 16)
    return h


_FIRST_CHAIN = contextvars.ContextVar("first_chain", default=0)
# the purpose of a launch group's seed salt (chain.py's PURPOSE_* are 1..11)
_PURPOSE_GROUP = 12


@contextlib.contextmanager
def chain_offset(first_chain: int):
    """Run the enclosed launch as chains ``first_chain ..`` of the run."""
    token = _FIRST_CHAIN.set(int(first_chain))
    try:
        yield
    finally:
        _FIRST_CHAIN.reset(token)


def chain_index(size: int, num_chains: int, device):
    """The flat index ``0 .. size - 1`` of a site shaped [num_chains, ...],
    shifted to the launch group's global chains (:func:`chain_offset`)."""
    idx = torch.arange(size, dtype=torch.int64, device=device)
    first = _FIRST_CHAIN.get()
    if first:
        idx = idx + first * (size // num_chains)
    return idx


def group_seed(seed: int) -> int:
    """A fused launch's seed in its launch group: ``seed`` itself for the
    group of chain 0 (and for a launch of every chain), else salted by the
    group's first chain."""
    first = _FIRST_CHAIN.get()
    if not first:
        return seed
    return (int(seed) ^ derive_seed(first, 0, _PURPOSE_GROUP)) & 0x7FFFFFFF


def uniform_from_bits(bits):
    """24-bit uniforms clipped to [1e-12, 1 - 1e-7], in float32."""
    f = (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))
    return torch.clamp(f, _U_LO, _U_HI)


def box_muller(u1, u2):
    return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(TWO_PI * u2)


def tz(x, cap: int):
    """Trailing zeros of int ``x`` over bits 0..cap-1, ``cap`` for x == 0.

    Exactly the Pallas ``_tz``: a nonzero ``x`` with no set bit below
    ``cap`` gives 0.  The lowest set bit ``x & -x`` is a power of two, whose
    exponent ``frexp`` reads exactly (x < 2^24)."""
    low = (x & -x).to(torch.float32)
    t = (torch.frexp(low)[1] - 1).to(x.dtype)
    t = torch.where(t < cap, t, torch.zeros_like(t))
    return torch.where(x == 0, torch.full_like(x, cap), t)


class BlockRng:
    """The fused kernels' random sites for C chains in blocks of B.

    ``it`` is an int or an int64 tensor of shape [C] (per-chain counters,
    as the warmup kernel's blocks advance their counters independently).
    """

    def __init__(self, seed: int, C: int, dim: int, B: int, device,
                 layout: str = "cl"):
        c = torch.arange(C, dtype=torch.int64, device=device)
        pid = c // B
        self.seed = ((int(seed) & MASK32) + _mul32(pid, PID_MUL)) & MASK32
        lane = c % B
        self.sidx = lane
        j = torch.arange(dim, dtype=torch.int64, device=device)[None, :]
        if layout == "ld":
            self.vidx = lane[:, None] * dim + j
        else:
            self.vidx = j * B + lane[:, None]

    def _it(self, it, vector):
        if isinstance(it, torch.Tensor) and vector:
            return it[:, None]
        return it

    def uniform(self, it, salt: int):
        """Per-chain scalar site -> [C] float32."""
        return uniform_from_bits(hash_bits(self.seed, self._it(it, False),
                                           salt, self.sidx))

    def uniform_vec(self, it, salt: int):
        """Per-chain vector site -> [C, d] float32."""
        return uniform_from_bits(hash_bits(self.seed[:, None],
                                           self._it(it, True), salt,
                                           self.vidx))

    def normals_vec(self, it, salt1: int, salt2: int):
        return box_muller(self.uniform_vec(it, salt1),
                          self.uniform_vec(it, salt2))


def derive_seed(base_seed: int, draw_idx: int, purpose: int) -> int:
    """A 31-bit launch seed from (base seed, global draw index, purpose).

    Takes the place of the JAX runners' threefry-derived seeds
    (``chain.py:872-875``, ``:844-860``, ``:1097-1106``)."""
    h = hash_bits(torch.tensor(int(base_seed) & MASK32), int(draw_idx),
                  int(purpose), torch.tensor(0))
    return int(h) & 0x7FFFFFFF


def host_uniform(seed: int, it: int, salt: int, shape, device):
    """Uniforms over a flat index for host-side draws (init positions,
    init-search momentum, launch jitter) -> float32 tensor of ``shape``."""
    n = 1
    for s in shape:
        n *= s
    idx = chain_index(n, shape[0], device).reshape(shape)
    return uniform_from_bits(hash_bits(int(seed) & MASK32, it, salt, idx))


def host_normals(seed: int, it: int, salt1: int, salt2: int, shape, device):
    return box_muller(host_uniform(seed, it, salt1, shape, device),
                      host_uniform(seed, it, salt2, shape, device))
