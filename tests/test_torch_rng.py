"""The port's counter hash against the Pallas kernels' ``_hash_bits``.

nuts_rs_tpu_torch/kernels/rng.py must give the bits of
nuts_rs_tpu/kernels/nuts_pallas.py::_hash_bits exactly: the fused CUDA
kernels and their plain PyTorch versions are held draw for draw against the
interpret-mode Pallas kernels through it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nuts_rs_tpu.kernels.nuts_pallas import _hash_bits, _tz
from nuts_rs_tpu_torch.kernels import rng


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _jax_uniform(shape, seed, it, salt):
    bits = _hash_bits(shape, jnp.uint32(seed), jnp.uint32(it), salt)
    f = ((bits >> 8).astype(jnp.int32).astype(jnp.float32)
         * (1.0 / (1 << 24)))
    return np.array(jnp.clip(f, 1e-12, 1.0 - 1e-7))


def _flat_idx(shape):
    return torch.arange(int(np.prod(shape))).reshape(shape)


@pytest.mark.parametrize("shape", [(1, 4), (3, 5), (10, 32)])
@pytest.mark.parametrize("seed", [0, 7, 2**31 - 1, 3_000_000_000])
def test_hash_bits_bit_exact(shape, seed):
    for it in (0, 1, 1234, 2**31 + 5):
        for salt in (1, 4, 9):
            want = np.asarray(_hash_bits(shape, jnp.uint32(seed),
                                         jnp.uint32(it), salt))
            got = rng.hash_bits(torch.tensor(seed), it, salt,
                                _flat_idx(shape)).numpy()
            np.testing.assert_array_equal(got, want.astype(np.int64),
                                          err_msg=str((it, salt)))


@pytest.mark.parametrize("seed", [0, 11])
def test_uniforms_bit_exact(seed):
    shape = (64, 128)
    for it, salt in ((0, 1), (5, 4), (77, 9)):
        want = _jax_uniform(shape, seed, it, salt)
        got = rng.uniform_from_bits(
            rng.hash_bits(torch.tensor(seed), it, salt, _flat_idx(shape)))
        np.testing.assert_array_equal(got.numpy(), want)
        assert got.dtype == torch.float32


@pytest.mark.parametrize("seed", [0, 11])
def test_normals_close(seed):
    # XLA's log/cos differ from PyTorch's CPU kernels by an ulp on some
    # inputs: the Box-Muller normals agree to 1e-6 relative.
    shape = (64, 128)
    u1 = _jax_uniform(shape, seed, 3, 1)
    u2 = _jax_uniform(shape, seed, 3, 2)
    want = np.sqrt(-2.0 * np.log(u1, dtype=np.float32)) * np.cos(
        np.float32(2.0 * np.pi) * u2)
    want_jax = np.asarray(jnp.sqrt(-2.0 * jnp.log(u1))
                          * jnp.cos(2.0 * jnp.pi * u2))
    got = rng.box_muller(torch.from_numpy(u1), torch.from_numpy(u2)).numpy()
    np.testing.assert_allclose(got, want_jax, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_tz_matches():
    for cap in (3, 5, 10):
        x = np.arange(-4, 3000, dtype=np.int32)
        want = np.asarray(_tz(jnp.asarray(x), cap))
        got = rng.tz(torch.from_numpy(x), cap).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("B", [4, 8])
def test_block_sites_follow_the_pallas_block_layout(B):
    # chain c = pid * B + b; a vector site's coordinate j is the flat index
    # j * B + b of the block's (d, B) shape; the block seed is
    # seed + 0x51ED2701 * pid (nuts_pallas.py:176-177)
    C, d, seed = 2 * B, 3, 5
    r = rng.BlockRng(seed, C, d, B, "cpu")
    for pid in range(C // B):
        bseed = jnp.uint32((seed + 0x51ED2701 * pid) & 0xFFFFFFFF)
        lanes = slice(pid * B, (pid + 1) * B)
        for it, salt in ((0, 1), (3, 6)):
            want_s = _jax_uniform((1, B), int(bseed), it, salt)[0]
            np.testing.assert_array_equal(r.uniform(it, salt)[lanes].numpy(),
                                          want_s)
            want_v = _jax_uniform((d, B), int(bseed), it, salt)
            np.testing.assert_array_equal(
                r.uniform_vec(it, salt)[lanes].numpy(), want_v.T)


def test_per_chain_counters_select_their_own_stream():
    C, B, d = 8, 4, 2
    r = rng.BlockRng(3, C, d, B, "cpu")
    its = torch.tensor([5] * 4 + [9] * 4, dtype=torch.int64)
    both = r.uniform(its, 4)
    np.testing.assert_array_equal(both[:4].numpy(), r.uniform(5, 4)[:4])
    np.testing.assert_array_equal(both[4:].numpy(), r.uniform(9, 4)[4:])


def test_derived_seeds_differ_by_draw_and_purpose():
    seeds = {rng.derive_seed(0, draw, purpose)
             for draw in range(50) for purpose in range(1, 6)}
    assert len(seeds) == 250
    assert all(0 <= s < 2**31 for s in seeds)
