"""BASELINE config 2 in the JAX package on the CPU, chunk by chunk.

``correlated_normal_rank1(100)`` under ``LowRankNutsSettings(num_chains=64,
seed=SEED)`` on the JAX sync engine, at float32 (``32``) or float64
(``64``, under x64), to draw STOP: after each chunk of 25 draws the smallest
and median step of the 64 chains, their leapfrogs a draw, the divergences,
the transformation indices and the chains whose step is below 1e-6
(collapsed).

    python tests/data/low_rank_collapse_jax.py 32 SEED STOP
"""
import os, sys, time, warnings
os.environ["JAX_PLATFORMS"] = "cpu"
import jax
jax.config.update("jax_platforms", "cpu")
if sys.argv[1] == "64":
    jax.config.update("jax_enable_x64", True)
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))
import numpy as np
import nuts_rs_tpu as nt
from nuts_rs_tpu.models import gaussian
seed = int(sys.argv[2]); stop = int(sys.argv[3]) if len(sys.argv) > 3 else 1000
warnings.simplefilter("ignore")
s = nt.Sampler(gaussian.correlated_normal_rank1(100),
               nt.LowRankNutsSettings(num_chains=64, seed=seed, num_draws=200,
                                      posterior_kernel="sync"),
               chunk_size=25)
t0 = time.time()
lo = 0
while not s.finished:
    out = s.run_next_chunk()
    st = out[1] if isinstance(out, tuple) else out
    st = {k: np.asarray(v) for k, v in st.items()}
    step = st["step_size"][:, -1]
    ns = st["n_steps"].mean(1)
    tid = st["transformation_index"][:, -1]
    bad = np.nonzero(step < 1e-6)[0]
    print(f"{lo}: {time.time()-t0:.0f}s steps min {step.min():.3g} med {np.median(step):.3g} "
          f"n_steps mean {ns.mean():.1f} max {ns.max():.0f} div {st['diverging'].sum()} "
          f"tid min {tid.min()} max {tid.max()} collapsed {bad.tolist()}", flush=True)
    lo += 25
    if lo >= stop:
        break
