"""The low-rank refit at float32 in both packages, on the same windows.

Runs the port's sampler on the CPU at float32 (``correlated_normal_rank1(d)``
under ``LowRankNutsSettings``), and at each scheduled refit hands the same
per-chain windows to the port's ``compute_update`` and to the JAX package's,
each at float32 and at float64.  Prints, for each refit, the chains whose
transform each of the four changed and, for a float32 refit that changed,
the largest entry of its dense matrix dq/dz minus the float64 refit's, over
the largest entry of the latter; a summary closes the run.

    JAX_PLATFORMS=cpu python tests/data/low_rank_float32_witness.py \\
        --dim 12 --chains 8 --seed 0 --draws 300
"""

import argparse
import os
import sys
import warnings

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import nuts_rs_tpu_torch as tnt  # noqa: E402
from nuts_rs_tpu.adapt import low_rank as jlr  # noqa: E402
from nuts_rs_tpu.transform import affine as jaff  # noqa: E402
from nuts_rs_tpu_torch.adapt import low_rank as tlr  # noqa: E402
from nuts_rs_tpu_torch.models.gaussian import (  # noqa: E402
    correlated_normal_rank1)
from nuts_rs_tpu_torch.transform import affine as taff  # noqa: E402

GAMMA, CUTOFF = 1e-5, 2.0


def dense(stds, vecs, vals_sqrt):
    """dq/dz [C, d, d] of diag(stds) (I + U (diag(vals_sqrt) - 1) U^T)."""
    eye = np.eye(stds.shape[-1])[None]
    inner = np.einsum("cir,cr,cjr->cij", vecs, vals_sqrt - 1.0, vecs)
    return stds[:, :, None] * (eye + inner)


def port_refit(w, t, dtype):
    w = tlr.LowRankWindow(*(x.to(dtype) if x.is_floating_point() else x
                            for x in w))
    t = taff.AffineTransform(*(None if x is None else (
        x.to(dtype) if x.is_floating_point() else x) for x in t))
    r = tlr.compute_update(w, t, GAMMA, CUTOFF)
    return (r.id != t.id).numpy(), dense(
        r.stds.double().numpy(), r.vecs.double().numpy(),
        r.vals_sqrt.double().numpy())


def jax_refit(w, t, dtype):
    changed, mats = [], []
    for c in range(w.draws.shape[0]):
        jw = jlr.LowRankWindow(
            jnp.asarray(w.draws[c].numpy(), dtype),
            jnp.asarray(w.grads[c].numpy(), dtype),
            jnp.int32(int(w.write_pos[c])), jnp.int32(int(w.start[c])),
            jnp.int32(int(w.bg_start[c])))
        jt = jaff.AffineTransform(*(None if v is None else jnp.asarray(
            v[c].numpy(), dtype if v.is_floating_point() else jnp.int32)
            for v in t))
        r = jlr.compute_update(jw, jt, GAMMA, CUTOFF)
        changed.append(int(r.id) != int(jt.id))
        mats.append(dense(np.asarray(r.stds, np.float64)[None],
                          np.asarray(r.vecs, np.float64)[None],
                          np.asarray(r.vals_sqrt, np.float64)[None])[0])
    return np.array(changed), np.stack(mats)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dim", type=int, default=12)
    ap.add_argument("--chains", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--draws", type=int, default=300)
    args = ap.parse_args()
    torch.set_num_threads(1)
    errors = {"port": [], "jax": []}
    refits = {"port": 0, "jax": 0}
    orig = tlr.LowRankStrategy.adapt_update

    def witness(self, state):
        w, t = state.extra, state.transform
        got = {"port32": port_refit(w, t, torch.float32),
               "port64": port_refit(w, t, torch.float64),
               "jax32": jax_refit(w, t, jnp.float32),
               "jax64": jax_refit(w, t, jnp.float64)}
        ref = got["port64"][1]
        scale = np.abs(ref).max((1, 2))
        line = (f"refit at draw {int(state.draw_idx)}: changed "
                + ", ".join(f"{k} {int(v[0].sum())}" for k, v in got.items())
                + f"; jax64 against port64 "
                f"{np.abs(got['jax64'][1] - ref).max() / scale.max():.2g}")
        for pkg in ("port", "jax"):
            took = got[pkg + "32"][0] & got["port64"][0]
            refits[pkg] += int(took.sum())
            if took.any():
                err = (np.abs(got[pkg + "32"][1] - ref).max((1, 2))[took]
                       / scale[took])
                errors[pkg] += err.tolist()
                line += (f"; {pkg}32 on chains {np.nonzero(took)[0].tolist()}"
                         f" off by {np.round(err, 4).tolist()}")
        print(line, flush=True)
        return orig(self, state)

    tlr.LowRankStrategy.adapt_update = witness
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        s = tnt.Sampler(correlated_normal_rank1(args.dim),
                        tnt.LowRankNutsSettings(num_chains=args.chains,
                                                num_draws=10, seed=args.seed),
                        device="cpu", chunk_size=25)
        while s._next_draw < args.draws and not s.finished:
            s.run_next_chunk()
    for pkg in ("port", "jax"):
        e = np.array(errors[pkg])
        far = e[e > 0.01]
        print(f"{pkg} float32 refits that changed a transform: {refits[pkg]}"
              f"; {len(far)} of them off the float64 refit by more than 1%"
              + (f" (from {far.min():.3g} to {far.max():.3g})" if len(far)
                 else "")
              + f", the others by at most "
              f"{(e[e <= 0.01].max() if (e <= 0.01).any() else 0):.2g}")


if __name__ == "__main__":
    main()
