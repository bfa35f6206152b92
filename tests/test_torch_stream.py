"""The streamed-data NUTS path (kernel K1-stream) on the CPU, against the
JAX package.

The plain version of K1-stream (``nuts_fused_run_reference`` with
``stream=True``: the data evaluated tile after tile by
``gaussian.logistic_regression_stream_logp_grad``) replays
``nuts_pallas_run`` with ``stream=`` in interpret mode draw for draw, as
tests/test_pallas_stream.py runs it: every integer stat equal on every
(chain, draw), floats to rounding, at one logical block and at two.  The
streamed functor holds the JAX model's rows in the JAX model's tiles and
adds them in its stated order (ranges of tiles, quads of rows), the chain
block is the JAX runner's pick, the runners stream where the JAX runners
stream, and the slice as a whole (sync warmup, streamed posterior) agrees
with the JAX package in distribution.

Float tolerances are those of tests/test_torch_model_args.py (K1-args): the
plain version sums a logit's terms in ascending j and a range's rows in
quads of 4, XLA's dot in its own; rtol 2e-6 with atol 2e-6 on
positions and step sizes, 2e-5 on log densities and energy stats, 5e-5 on
the accept sums and 2e-3 on gradients.

The kernel itself runs only on a CUDA card:
tests/test_torch_kernels_cuda.py holds it against this plain version.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_pallas_stream import _logreg_pieces

import nuts_rs_tpu as jnt
import nuts_rs_tpu_torch as tnt
from nuts_rs_tpu.kernels.nuts import NutsOptions as JaxNutsOptions
from nuts_rs_tpu.kernels.nuts_pallas import nuts_pallas_run
from nuts_rs_tpu.models import gaussian as jg
from nuts_rs_tpu.sampler import _strategy_for
from nuts_rs_tpu_torch import chain as tchain
from nuts_rs_tpu_torch.convert import model_from_pallas_args
from nuts_rs_tpu_torch.kernels import _build
from nuts_rs_tpu_torch.kernels import nuts_fused as nf
from nuts_rs_tpu_torch.kernels.nuts import NutsOptions
from nuts_rs_tpu_torch.models import gaussian as tg
from nuts_rs_tpu_torch.ops import tsum

INT_STATS = ("depth", "diverging", "n_steps", "index_in_trajectory",
             "maxdepth_reached", "loop_iterations")
ENERGY_STATS = ("max_energy_error", "logp", "energy", "energy_error",
                "fisher_distance")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, what, rtol, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=what)


def _check_posterior(got, want):
    for name in INT_STATS:
        np.testing.assert_array_equal(got[4][name].numpy(),
                                      np.asarray(want[4][name]), err_msg=name)
    atols = {"q": 2e-6, "g": 2e-3, "logp": 2e-5, "draws": 2e-6}
    for i, name in enumerate(("q", "g", "logp", "draws")):
        _close(got[i], want[i], name, 2e-6, atols[name])
    _close(got[4]["step_size"], want[4]["step_size"], "step_size", 2e-6,
           2e-6)
    for name in ("sum_accept", "sum_accept_sym"):
        _close(got[4][name], want[4][name], name, 2e-6, 5e-5)
    for name in ENERGY_STATS:
        _close(got[4][name], want[4][name], name, 2e-6, 2e-5)


def _inputs(logp, C, dim, seed, step):
    rng = np.random.default_rng(seed)
    q0 = (rng.normal(size=(C, dim)) * 0.1).astype(np.float32)
    lp0, g0 = jax.vmap(jax.value_and_grad(logp))(jnp.asarray(q0))
    ones = np.ones((C, dim), np.float32)
    return (q0, np.asarray(g0, np.float32), np.asarray(lp0, np.float32),
            ones, 0 * ones, np.zeros(C, np.float32),
            np.full(C, step, np.float32), np.full(C, step, np.float32))


# ---------------------------------------------------------------------------
# (a) the plain version of K1-stream against interpret-mode Pallas stream=
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("num_draws,jitter", [(12, None), (25, 0.1)])
def test_k1_stream_plain_version_matches_pallas(num_draws, jitter):
    """N = 36 rows in tiles of 8: five tiles, a zero-weight tail of 4 rows;
    d = 4, maxdepth 6, 8 chains in one block, as
    tests/test_pallas_stream.py::_run."""
    n, d, tile, C = 36, 4, 8, 8
    spec, _, _, logp = _logreg_pieces(n, d, seed=3, tile_rows=tile)
    tm = model_from_pallas_args("logistic_regression_stream", spec.args,
                                tile_rows=tile)
    assert tm.stream_tile_rows == tile and tm.hook_parts()[2][1].shape == (n,)
    # block = C = 8 chains; the five tiles in five ranges (the default)
    args = _inputs(logp, C, d, 7, 0.22)
    want = nuts_pallas_run(11, *map(jnp.asarray, args), num_draws, None,
                           JaxNutsOptions(maxdepth=6), jitter, block=C,
                           interpret=True, stream=spec, model_args=())
    got = nf.nuts_fused_run_reference(11, *map(_t, args), num_draws, tm,
                                      NutsOptions(maxdepth=6), jitter,
                                      block=C, stream=True)
    assert int(np.asarray(want[4]["depth"]).max()) >= 3
    _check_posterior(got, want)


@pytest.mark.parametrize("ranges", [None, 2])
def test_k1_stream_plain_version_matches_pallas_in_two_blocks(ranges):
    """16 chains in two logical blocks of 8 (each block's seed by its
    program id, its own last iteration), the five tiles in five ranges (the
    default, one a tile) or in two of two and three tiles."""
    n, d, tile, C, B = 36, 4, 8, 16, 8
    spec, _, _, logp = _logreg_pieces(n, d, seed=3, tile_rows=tile)
    tm = model_from_pallas_args("logistic_regression_stream", spec.args,
                                tile_rows=tile)
    args = _inputs(logp, C, d, 9, 0.22)
    want = nuts_pallas_run(13, *map(jnp.asarray, args), 14, None,
                           JaxNutsOptions(maxdepth=6), 0.1, block=B,
                           interpret=True, stream=spec, model_args=())
    got = nf.nuts_fused_run_reference(13, *map(_t, args), 14, tm,
                                      NutsOptions(maxdepth=6), 0.1, block=B,
                                      stream=True, ranges=ranges)
    iters = np.asarray(want[4]["loop_iterations"])
    assert len(set(iters[:B])) == len(set(iters[B:])) == 1
    # max_energy_error is the leapfrog error of largest magnitude; chain 14's
    # draw 12 has two that mirror each other (-0.0082626 and +0.0082626), so
    # the sums' rounding picks its sign: held in magnitude here
    for out in (got[4], want[4]):
        out["max_energy_error"] = np.abs(np.asarray(out["max_energy_error"]))
    _check_posterior(got, want)


def test_k1_stream_plain_version_on_the_shipped_packed_spec():
    """``logistic_regression(64, 5)``: the JAX model packs (x, y, w) into one
    128-column array in tiles of 8 rows (``gaussian.py:193-200``); the port
    holds the same rows unpacked, in the same tiles."""
    jm = jg.logistic_regression(64, 5, seed=2)
    spec = jm.pallas_stream
    tm = model_from_pallas_args("logistic_regression_stream", spec.args,
                                tile_rows=spec.tile_rows, dim=5)
    ref = tg.logistic_regression(64, 5, seed=2)
    assert tm.stream_tile_rows == ref.stream_tile_rows == spec.tile_rows == 8
    for a, b in zip(tm.hook_parts()[2], ref.hook_parts()[2]):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    C = 8
    args = _inputs(jm.logp_fn, C, 5, 5, 0.3)
    want = nuts_pallas_run(4, *map(jnp.asarray, args), 10, None,
                           JaxNutsOptions(maxdepth=5), 0.1, block=C,
                           interpret=True, stream=spec, model_args=())
    got = nf.nuts_fused_run_reference(4, *map(_t, args), 10, ref,
                                      NutsOptions(maxdepth=5), 0.1, block=C,
                                      stream=True)
    _check_posterior(got, want)


def test_stream_single_tile_bit_identical():
    """One tile that holds every row: one range, and a tile larger than the
    data changes no bit (a row past the data's end is no term).  The
    resident plain version (K1-args') sums the rows in ``ops.tsum``'s order,
    the streamed one in quads (``gaussian.stream_quads``): the same draws to
    rounding, every integer stat equal."""
    n, d, C = 24, 4, 8
    tm = tg.logistic_regression(n, d, 3)
    args = list(map(_t, _inputs(jg.logistic_regression(n, d, 3).logp_fn, C,
                                d, 1, 0.3)))
    opts = NutsOptions(maxdepth=6)
    dense = nf.nuts_fused_run_reference(11, *args, 20, tm, opts, 0.1,
                                        block=4)
    first = None
    for rows in (24, 256, 300):
        model = dataclasses.replace(tm, stream_tile_rows=rows)
        got = nf.nuts_fused_run_reference(11, *args, 20, model, opts, 0.1,
                                          block=4, stream=True)
        if first is None:
            first = got
            _check_posterior(got, dense)
        for a, b in zip(got[:4], first[:4]):
            np.testing.assert_array_equal(a.numpy(), b.numpy())
        for name in first[4]:
            np.testing.assert_array_equal(got[4][name].numpy(),
                                          first[4][name].numpy(), name)


# ---------------------------------------------------------------------------
# (b) the streamed functor
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_data,dim,tile", [(64, 5, 8), (37, 4, 8),
                                             (600, 6, 64), (600, 6, 512),
                                             (1030, 3, 512)])
def test_streamed_functor_matches_autodiff_and_the_jax_model(n_data, dim,
                                                             tile):
    jm = jg.logistic_regression(n_data, dim, 1)
    tm = dataclasses.replace(tg.logistic_regression(n_data, dim, 1),
                             stream_tile_rows=tile)
    xt, y = tm.hook_parts()[2]
    q = np.random.default_rng(0).normal(size=(5, dim)).astype(np.float32)
    logp, grad = tg.logistic_regression_stream_logp_grad(_t(q), xt, y, tile,
                                                         tsum)
    logp_e, grad_e = nf._evaluators(tm, "stream")[1](_t(q))
    np.testing.assert_array_equal(logp.numpy(), logp_e.numpy())
    np.testing.assert_array_equal(grad.numpy(), grad_e.numpy())
    from torch.func import grad_and_value, vmap

    grad_a, logp_a = vmap(grad_and_value(tm.logp_fn))(_t(q))
    _close(logp, logp_a, "logp vs torch.func", 2e-4, 0)
    _close(grad, grad_a, "grad vs torch.func", 2e-4, 2e-4)
    logp_j, grad_j = jax.vmap(jm.logp_and_grad)(jnp.asarray(q))
    _close(logp, logp_j, "logp vs the JAX model", 2e-4, 0)
    _close(grad, grad_j, "grad vs the JAX model", 2e-4, 2e-4)
    # the JAX model's own tiles: tile_eval over its packed array, finalize
    spec = jm.pallas_stream
    if tile == spec.tile_rows:
        lp_acc = jnp.zeros((1, 5), jnp.float32)
        g_acc = jnp.zeros((dim, 5), jnp.float32)
        for t in range(spec.args[0].shape[0] // tile):
            lp_p, g_p = spec.tile_eval(
                jnp.asarray(q.T), jnp.asarray(spec.args[0][t * tile:
                                                           (t + 1) * tile]))
            lp_acc, g_acc = lp_acc + lp_p, g_acc + g_p
        lp_s, g_s = spec.finalize(jnp.asarray(q.T), lp_acc, g_acc)
        _close(logp, lp_s, "logp vs tile_eval", 2e-5, 0)
        _close(grad, np.asarray(g_s).T, "grad vs tile_eval", 2e-5, 2e-5)


@pytest.mark.parametrize("ranges", [1, 2, 5, 13])
def test_streamed_functor_adds_its_tiles_in_ranges(ranges):
    """The sum order over rows, whatever the chain block: the 13 tiles of 8
    rows (the last of 4) in ``ranges`` ranges, range r the tiles ``[r T //
    R, (r + 1) T // R)``; a range's rows in quads of 4 from its first row,
    each quad left to right, the quads left to right; the ranges in
    ascending order; the prior last.  Re-added here one row at a time from
    the functor's own terms, bit for bit."""
    tm = tg.logistic_regression(100, 4, 0)
    xt, y = tm.hook_parts()[2]
    q = _t(np.random.default_rng(2).normal(size=(3, 4)).astype(np.float32))
    tile, T = 8, 13
    logp, grad = tg.logistic_regression_stream_logp_grad(q, xt, y, tile,
                                                         tsum, ranges)
    rows, present = tg.stream_quads(100, tile, ranges)
    assert rows.shape[0] == ranges and int(present.sum()) == 100
    # the functor's terms, on its own layout
    xg = xt[:, rows]
    logits = xg[0] * q[:, 0, None, None, None]
    for j in range(1, 4):
        logits = logits + xg[j] * q[:, j, None, None, None]
    ll = y[rows] * logits - tg.logaddexp(torch.zeros_like(logits), logits)
    res = y[rows] - torch.ones_like(logits) / (1.0 + torch.exp(-logits))
    terms = torch.cat([ll[:, None], xg * res[:, None]], 1)  # [C, 1 + d, ...]
    total = None
    for r in range(ranges):
        lo = (r * T // ranges) * tile
        hi = min(((r + 1) * T // ranges) * tile, 100)
        part = None
        for n0 in range(lo, hi, 4):
            quad = None
            for n in range(n0, min(n0 + 4, hi)):
                i, k = divmod(n - lo, 4)
                term = terms[:, :, r, i, k]
                quad = term if quad is None else quad + term
            part = quad if part is None else part + quad
        total = part if total is None else total + part
    np.testing.assert_array_equal(logp.numpy(),
                                  (total[:, 0] - 0.5 * tsum(q * q)).numpy())
    np.testing.assert_array_equal(grad.numpy(), (total[:, 1:] - q).numpy())
    whole = tg.logistic_regression_stream_logp_grad(q, xt, y, tile, tsum, 1)
    _close(logp, whole[0], "logp vs one range", 1e-5, 1e-5)
    assert nf._evaluators(tm, "stream", ranges)[1](q)[0].shape == (3,)
    with pytest.raises(ValueError, match="ranges must be 1..13"):
        tg.logistic_regression_stream_logp_grad(q, xt, y, tile, tsum, 14)


def test_streamed_functor_evaluates_chains_in_groups(monkeypatch):
    """The [C, d, N] product is formed for a group of chains at a time and
    the grouping changes no bit."""
    tm = tg.logistic_regression(100, 4, 0)
    xt, y = tm.hook_parts()[2]
    q = _t(np.random.default_rng(1).normal(size=(7, 4)).astype(np.float32))
    whole = tg.logistic_regression_stream_logp_grad(q, xt, y, 8, tsum)
    monkeypatch.setattr(tg, "_STREAM_PRODUCT_ELEMENTS", 2 * 4 * 104)
    grouped = tg.logistic_regression_stream_logp_grad(q, xt, y, 8, tsum)
    for a, b in zip(whole, grouped):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_stream_form_of_model_from_pallas_args_checks_its_weights():
    x = np.zeros((16, 3), np.float32)
    y = np.zeros((16, 1), np.float32)
    w = np.ones((16, 1), np.float32)
    w[10:] = 0
    with pytest.raises(ValueError, match="tile_rows"):
        model_from_pallas_args("logistic_regression_stream", (x, y, w))
    with pytest.raises(ValueError, match="less than a tile"):
        model_from_pallas_args("logistic_regression_stream", (x, y, w),
                               tile_rows=4)
    w[3] = 0
    with pytest.raises(ValueError, match="stream weights"):
        model_from_pallas_args("logistic_regression_stream", (x, y, w),
                               tile_rows=8)
    with pytest.raises(ValueError, match="dim"):
        model_from_pallas_args("logistic_regression_stream",
                               (np.zeros((16, 128), np.float32),),
                               tile_rows=8)


# ---------------------------------------------------------------------------
# (c) the wrapper and the launch's sizes
# ---------------------------------------------------------------------------


def test_cpu_tensors_take_the_plain_version_and_arguments_are_checked():
    before = dict(nf.LAUNCHES)
    tm = tg.logistic_regression(40, 4, 1)
    args = list(map(_t, _inputs(jg.logistic_regression(40, 4, 1).logp_fn, 8,
                                4, 1, 0.3)))
    opts = NutsOptions(maxdepth=4)
    got = nf.nuts_fused_run(1, *args, 3, tm, opts, 0.1, block=4, stream=True)
    want = nf.nuts_fused_run_reference(1, *args, 3, tm, opts, 0.1, block=4,
                                       stream=True)
    for a, b in zip(got[:4], want[:4]):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert nf.LAUNCHES == before and "nuts_fused_stream_posterior" in before
    # the block: the JAX runner's by default (all 8 chains at this size),
    # else min(block, C), which must divide the chains
    assert nf._stream_sizes(tm, 8, 4, None, None) == (8, 5)
    assert nf._stream_sizes(tm, 8, 4, 16, 2) == (8, 2)
    with pytest.raises(ValueError, match="multiple of the chain block"):
        nf.nuts_fused_run(1, *args, 3, tm, opts, 0.1, block=3, stream=True)
    bad = list(args)
    bad[0] = args[0].T.contiguous().T  # not contiguous
    with pytest.raises(ValueError, match="contiguous"):
        nf.nuts_fused_run(1, *bad, 3, tm, opts, 0.1, stream=True)
    with pytest.raises(ValueError, match="chains-on-lanes only"):
        nf.nuts_fused_run(1, *args, 3, tm, opts, 0.1, layout="ld",
                          stream=True)
    with pytest.raises(ValueError, match="no streamed form"):
        nf.nuts_fused_run(1, *args, 3, tg.normal_logp(4), opts, 0.1,
                          stream=True)
    with pytest.raises(ValueError, match="CUDA tensors"):
        _build.launch_stream_posterior(1, *args, 3, tm, opts, 0.1, 8, 5)


@pytest.mark.parametrize("ranges,match", [
    (0, "ranges must be an int in 1..5"), (6, "ranges must be an int in 1..5"),
    (2.0, "ranges must be an int"), ("3", "ranges must be an int")])
def test_stream_ranges_are_checked(ranges, match):
    """R, the ranges the tiles fall into, is 1..T (every range holds a tile)
    on both devices; the kernel's workspace holds a partial sum a range,
    chain and column, and the block's positions."""
    tm = tg.logistic_regression(40, 4, 1)  # 5 tiles of 8
    args = list(map(_t, _inputs(jg.logistic_regression(40, 4, 1).logp_fn, 8,
                                4, 1, 0.3)))
    with pytest.raises(ValueError, match=match):
        nf.nuts_fused_run(1, *args, 3, tm, NutsOptions(maxdepth=4), 0.1,
                          stream=True, ranges=ranges)
    assert _build.stream_workspace_floats(5, 8, 4) == 4 * 8 + 5 * 8 * 5
    assert _build.stream_workspace_floats(256, 256, 100) == \
        100 * 256 + 256 * 256 * 101


def test_stream_shared_memory_does_not_grow_with_the_rows():
    # 21 vectors, the cached dots, the reduction scratch, the cluster
    # slots, then 4 floats of slack, S rows of x at an odd stride >= d + 1,
    # the group's positions or residuals and the quad sums
    assert _build.stream_smem_bytes(100, 10, 128, 64) == 4 * (
        21 * 100 + 22 + 176 + 16 + 4 + 128 * 101 + 128 * 64 + 32 * 64)
    assert _build.stream_smem_bytes(5, 6, 128, 8) == 4 * (
        21 * 5 + 14 + 176 + 16 + 4 + 128 * 7 + 128 * 8 + 32 * 8)
    # the main path's tiling: two chains' blocks an SM (1 KB each reserved)
    assert _build.stream_tiling(100, 256, 10) == (128, 64)
    assert 2 * (_build.stream_smem_bytes(100, 10, 128, 64) + 1024) <= 233472
    # the group no larger than the block needs; fewer chains at larger d
    assert _build.stream_tiling(4, 8, 6) == (128, 8)
    assert _build.stream_tiling(4, 12, 6) == (128, 16)
    assert _build.stream_tiling(200, 128, 10) == (128, 32)
    assert _build.stream_tiling(1000, 64, 10)[1] == 8
    with pytest.raises(NotImplementedError, match="d up to 1024"):
        _build.stream_tiling(1025, 64, 10)
    big = tg.logistic_regression_from_tensors(torch.zeros(100, 131072),
                                              torch.zeros(131072))
    assert big.stream_tile_rows == 512 and tg.stream_tile_rows(511) == 8
    assert tg.stream_ranges(256) == 256 and tg.stream_ranges(300) == 256
    assert tg.stream_ranges(5) == 5
    assert _build.mid_smem_bytes("posterior", 100, 10, big) \
        > _build.SMEM_OPT_IN_BYTES
    assert "nuts_fused_stream_posterior" in _build.SOURCES
    assert _build.MODEL_IDS["logistic_regression_stream"] == 2


@pytest.mark.parametrize("maxdepth", range(1, 11))
def test_stream_tiling_fits_two_blocks_an_sm(maxdepth):
    """A logical block of 256 chains is two CUDA blocks an SM, so each may
    use at most (233,472 - 2 x 1,024) / 2 = 115,712 bytes of shared memory.
    For ``logistic_regression(131072, d)`` at 256 chains, at every d whose
    JAX block is 256 (the runner's rule, ``chain.stream_block``), the
    sub-tile is chosen against that, not against one block's opt-in; the
    opt-in rule exceeded it at 78 (maxdepth, d) pairs, d within 123..182 at
    maxdepth 1 down to 123..126 at 6 (each refused at its first posterior
    launch on the card), and fits them all at S = 64.  Up to 132 chains a
    block keeps the opt-in."""
    from types import SimpleNamespace

    assert _build.stream_block_smem_limit(256) == 115712
    assert _build.stream_block_smem_limit(132) == _build.SMEM_OPT_IN_BYTES
    assert _build.stream_block_smem_limit(133) == 115712
    opt_in_pairs = 0
    for d in range(100, 200):
        big = SimpleNamespace(dim=d, stream_tile_rows=512, name=f"glm_{d}")
        try:
            B = tchain.stream_block(big, maxdepth, 256)
        except ValueError:
            continue
        if B != 256:
            continue
        S, CG = _build.stream_tiling(d, B, maxdepth)
        assert _build.stream_smem_bytes(d, maxdepth, S, CG) <= 115712, d
        # the old rule: the largest S that fits one block's opt-in
        S_old = _build.STREAM_MAX_SUBTILE
        while S_old > 4 and _build.stream_smem_bytes(
                d, maxdepth, S_old, CG) > _build.SMEM_OPT_IN_BYTES:
            S_old //= 2
        if _build.stream_smem_bytes(d, maxdepth, S_old, CG) > 115712:
            opt_in_pairs += 1
            assert 123 <= d <= 182 and S == 64
    # 78 in all: 36 d at maxdepth 1, 20 at 2, 6 at 3-5, 4 at 6
    want = {1: 36, 2: 20, 3: 6, 4: 6, 5: 6, 6: 4}.get(maxdepth, 0)
    assert opt_in_pairs == want


@pytest.mark.parametrize("chains", [256, 64, 320])
def test_stream_block_is_the_jax_runners_pick(monkeypatch, chains):
    """``logistic_regression(131072, 100)``: the JAX posterior runner passes
    its tier, 256, to ``nuts_pallas_run``, whose block is ``min(256, C)``
    and must divide the chains; the port's ``chain.stream_block`` gives the
    same block (256 at 256 chains, 64 at 64) and raises at 320 chains, where
    the JAX launch asserts, and the port's runner passes it to its kernel."""
    import nuts_rs_tpu.chain as jchain
    import nuts_rs_tpu.kernels.nuts_pallas as jpallas

    js = jnt.DiagNutsSettings(num_chains=chains, num_tune=20, num_draws=10,
                              posterior_kernel="pallas")
    jcfg = js.chain_config()
    jm = jg.logistic_regression(131072, 100, 0)
    strategy = _strategy_for(js, jcfg)
    seen = []
    real = jpallas.nuts_pallas_run

    class _Stop(Exception):
        pass

    def spy(seed, q, *args, **kw):
        seen.append(kw["block"])
        C = q.shape[0]
        if C % min(kw["block"], C):
            return real(seed, q, *args, **kw)  # the JAX launch's refusal
        raise _Stop

    monkeypatch.setattr(jpallas, "nuts_pallas_run", spy)
    runner = jchain.make_pallas_posterior_runner(jm, strategy, jcfg,
                                                 phase_start=20, base_seed=0)
    state = jnt.Sampler(jg.logistic_regression(32, 100, 0), js,
                        dtype=jnp.float32).state
    flags = {k: jnp.zeros(4, bool) for k in (
        "is_tuning", "update_estimators", "do_switch", "do_update",
        "use_late_estimator", "reinit_step_size", "use_best_guess",
        "advance_da")}
    tm = tg.logistic_regression_from_tensors(torch.zeros(100, 131072),
                                             torch.zeros(131072))
    if chains % 256 and chains > 256:
        with pytest.raises(AssertionError):
            runner(state, flags)
        with pytest.raises(ValueError, match="multiple of the streamed"):
            tchain.stream_block(tm, 10, chains)
        return
    with pytest.raises(_Stop):
        runner(state, flags)
    assert seen == [256]
    assert tchain.stream_block(tm, 10, chains) == min(256, chains) == chains

    # the port's runner launches its kernel with that block
    ts = tnt.DiagNutsSettings(num_chains=chains, num_tune=20, num_draws=10,
                              posterior_kernel="pallas")
    tstate = tnt.Sampler(tg.logistic_regression(32, 100, 0), ts,
                         device="cpu").state
    got = []

    def tspy(*args, **kw):
        got.append((kw["block"], kw["stream"]))
        raise _Stop

    monkeypatch.setattr(nf, "nuts_fused_run", tspy)
    trunner = tchain.make_fused_posterior_runner(
        tm, ts.chain_config(), phase_start=20, base_seed=0, device="cpu")
    with pytest.raises(_Stop):
        trunner(tstate, {"is_tuning": torch.zeros(4, dtype=torch.bool)})
    assert got == [(chains, True)]


# ---------------------------------------------------------------------------
# (d) the size rule, far beyond the resident limit
# ---------------------------------------------------------------------------


def test_far_beyond_the_limit_both_packages_stream_after_a_sync_warmup(
        monkeypatch):
    """12 MB of data: the JAX posterior runner streams them and the JAX
    warmup runner gives up (no tier fits: the sampler runs the sync
    warmup); so does the port.  The boundaries themselves are
    tests/test_torch_model_args.py::test_cl_limit_counts_the_data_as_the_jax_runners."""
    import nuts_rs_tpu.chain as jchain
    import nuts_rs_tpu.kernels.nuts_pallas as jpallas

    n, dim = 30000, 100
    js = jnt.DiagNutsSettings(num_chains=8, num_tune=20, num_draws=10,
                              posterior_kernel="pallas")
    jcfg = js.chain_config()
    jm = jg.logistic_regression(n, dim, 0)
    strategy = _strategy_for(js, jcfg)
    assert jchain.make_pallas_warmup_runner(jm, strategy, jcfg, base_seed=0,
                                            use_grad_based=True) is None
    seen = []

    class _Stop(Exception):
        pass

    def spy(*args, **kw):
        seen.append((kw.get("layout", "cl"), kw.get("stream") is not None))
        raise _Stop

    monkeypatch.setattr(jpallas, "nuts_pallas_run", spy)
    runner = jchain.make_pallas_posterior_runner(jm, strategy, jcfg,
                                                 phase_start=20, base_seed=0)
    state = jnt.Sampler(jg.logistic_regression(32, dim, 0), js,
                        dtype=jnp.float32).state
    flags = {k: jnp.zeros(4, bool) for k in (
        "is_tuning", "update_estimators", "do_switch", "do_update",
        "use_late_estimator", "reinit_step_size", "use_best_guess",
        "advance_da")}
    with pytest.raises(_Stop):
        runner(state, flags)
    assert seen == [("cl", True)]

    ts = tnt.DiagNutsSettings(num_chains=8, num_tune=20, num_draws=10,
                              posterior_kernel="pallas")
    tm = tg.logistic_regression_from_tensors(torch.zeros(dim, n),
                                             torch.zeros(n))
    config = ts.chain_config()
    assert tchain.fused_layout(tm, config, warmup=False) == "stream"
    assert tchain.fused_layout(tm, config, warmup=True) is None
    assert tchain.stream_bytes(tm) == 4 * 2 * 512 * 128
    phases = ts.build_phases(tm, config, "cpu")
    assert [(lo, hi) for lo, hi, _ in phases] == [(0, 20), (20, 30)]
    # MCLMC has no streamed kernel in either package: the run is on the
    # sync MCLMC engine, with the JAX package's warning (it used to raise
    # naming item 8)
    msettings = tnt.DiagMclmcSettings(num_chains=4, num_tune=5, num_draws=5,
                                      posterior_kernel="pallas")
    with pytest.warns(UserWarning, match="streaming-only likelihood"):
        phases = msettings.build_phases(tm, msettings.chain_config(), "cpu")
    assert {r.__qualname__.split(".")[0] for _, _, r in phases} == {
        "make_sync_mclmc_runner"}


# ---------------------------------------------------------------------------
# (e) the slice as a whole
# ---------------------------------------------------------------------------


def test_stream_slice_on_the_cpu_matches_the_jax_package(monkeypatch):
    """``sample`` on a model forced to stream (tiles of 64 rows, the layout
    rule answered for it): per-draw sync warmup, then the plain version of
    K1-stream; the posterior agrees with the JAX package's run of the same
    model."""
    def forced(model, config, warmup, device=None):
        return None if warmup else "stream"

    monkeypatch.setattr(tchain, "fused_layout", forced)
    base = dict(num_tune=120, num_draws=150, num_chains=8)
    model = dataclasses.replace(tg.logistic_regression(600, 6, 3),
                                stream_tile_rows=64)
    calls = []
    real = nf.nuts_fused_run

    def spy(*args, **kw):
        calls.append(kw.get("stream"))
        return real(*args, **kw)

    monkeypatch.setattr(nf, "nuts_fused_run", spy)
    sampler = tnt.Sampler(model, tnt.DiagNutsSettings(
        posterior_kernel="pallas", seed=5, **base), device="cpu")
    kinds = [r.__qualname__.split(".")[0] for _, _, r in
             sampler._phase_runners]
    assert kinds == ["make_sync_runner", "make_fused_posterior_runner"]
    before = dict(nf.LAUNCHES)
    trace = sampler.run()
    assert nf.LAUNCHES == before and calls == [True, True]
    jtrace = jnt.sample(jg.logistic_regression(600, 6, 3),
                        jnt.DiagNutsSettings(posterior_kernel="sync", seed=6,
                                             **base), chunk_size=400)
    pos = trace.posterior["position"].astype(np.float64)
    jpos = np.asarray(jtrace.posterior["position"], np.float64)
    assert pos.shape == (8, 150, 6)
    assert not trace.sample_stats["diverging"].any()
    std = jpos.std((0, 1))
    assert np.all(np.abs(pos.mean((0, 1)) - jpos.mean((0, 1))) < 0.25 * std)
    np.testing.assert_allclose(pos.std((0, 1)), std, rtol=0.25)
    assert 0.6 < trace.sample_stats["mean_tree_accept"].mean() < 0.99
