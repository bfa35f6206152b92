"""The low-rank presets (queue 1 item 14) through the port's ``Sampler``,
against the JAX package, on the CPU.

``LowRankNutsSettings`` and ``LowRankMclmcSettings`` on
``correlated_normal_rank1(12, scale=1.5, eig=50)`` (covariance
1.5 (I + 49 u u^T): one direction with 50 times the variance), at float64
in both packages, held in distribution against the JAX sync engine (its
threefry streams cannot be matched): every coordinate's mean within 0.25
of its standard deviation, its standard deviation within 15% and the
variance along u within 20% (NUTS: of the analytic ones; MCLMC, which is
unadjusted: of the JAX run's), at most 2% divergences, and the refits at
the same draws as the JAX run's (``transformation_index``, every refit
taking at float64 in both).  The eigenvalue stats
(``LowRankSettings(store_mass_matrix=True)``) have the JAX trace's names,
shapes and dtypes, in the trace, its transformation updates and the
schema; the JAX package's MCLMC draw step never emits them although its
``MclmcSettings.chain_config`` asks for them, the port's emits them as
its NUTS draw step does.  A ``"pallas"`` request is demoted with the JAX
reason, and the good-draw window mode keeps its JAX ``ValueError``."""

import warnings

import numpy as np
import pytest
import torch

import nuts_rs_tpu as jnt
from nuts_rs_tpu.models import gaussian as jg
import nuts_rs_tpu_torch as tnt
from nuts_rs_tpu_torch.models import gaussian as tg

D, SCALE, EIG = 12, 1.5, 50.0


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _analytic():
    rng = np.random.default_rng(42)  # the model's own u
    u = rng.normal(size=D)
    u /= np.linalg.norm(u)
    cov = SCALE * (np.eye(D) + (EIG - 1.0) * np.outer(u, u))
    return u, np.sqrt(np.diag(cov)), float(u @ cov @ u)


def _summary(trace, u):
    pos = np.asarray(trace.posterior["position"], np.float64).reshape(-1, D)
    return pos.mean(0), pos.std(0), float(np.var(pos @ u))


@pytest.mark.parametrize("sampler", ["nuts", "mclmc"])
def test_the_presets_against_the_jax_sync_engine(sampler):
    kw = dict(num_chains=4, num_tune=300, num_draws=300, seed=1)
    if sampler == "nuts":
        settings = tnt.LowRankNutsSettings(
            low_rank=tnt.LowRankSettings(store_mass_matrix=True), **kw)
        jsettings = jnt.LowRankNutsSettings(**kw)
    else:
        settings = tnt.LowRankMclmcSettings(
            low_rank=tnt.LowRankSettings(store_mass_matrix=True), **kw)
        jsettings = jnt.LowRankMclmcSettings(**kw)
    assert settings.mass_matrix == jsettings.mass_matrix == "low_rank"
    assert vars(settings.adapt) == vars(jsettings.adapt)
    trace = tnt.sample(tg.correlated_normal_rank1(D, SCALE, EIG), settings,
                       device="cpu", dtype=torch.float64)
    jtrace = jnt.sample(jg.correlated_normal_rank1(D, scale=SCALE, eig=EIG),
                        jsettings)
    u, sd, var_u = _analytic()
    mean, std, vu = _summary(trace, u)
    jmean, jstd, jvu = _summary(jtrace, u)
    for m in (mean, jmean):
        assert (np.abs(m) < 0.25 * sd).all(), m / sd
    if sampler == "nuts":
        np.testing.assert_allclose(std, sd, rtol=0.15)
        np.testing.assert_allclose(jstd, sd, rtol=0.15)
        np.testing.assert_allclose([vu, jvu], var_u, rtol=0.2)
    else:
        np.testing.assert_allclose(std, jstd, rtol=0.15)
        np.testing.assert_allclose(vu, jvu, rtol=0.2)
    for tr in (trace, jtrace):
        assert np.asarray(tr.sample_stats["diverging"]).mean() <= 0.02
    # the refits at the JAX run's draws
    np.testing.assert_array_equal(
        trace.warmup_sample_stats["transformation_index"],
        np.asarray(jtrace.warmup_sample_stats["transformation_index"]))
    # the inflated direction was kept at the last refit
    assert (trace.warmup_sample_stats["num_eigenvalues"][:, -1] >= 1).all()
    vals = trace.warmup_sample_stats["mass_matrix_eigvals"][:, -1]
    assert (vals.max(-1) > 2.0).all()
    ev = trace.transformation_updates[0]
    assert ev["mass_matrix_eigvals"].shape == (len(ev["draw"]), D)
    assert ev["num_eigenvalues"][-1] >= 1


def _groups(trace):
    return {g: {k: (np.asarray(v).shape, np.asarray(v).dtype)
                for k, v in getattr(trace, g).items()}
            for g in ("sample_stats", "warmup_sample_stats")}


@pytest.mark.parametrize("max_rank", [None, 2])
def test_the_eigenvalue_stats_are_the_jax_traces(max_rank):
    kw = dict(num_chains=2, num_tune=40, num_draws=10, seed=3,
              adapt=tnt.AdaptScheduleOptions(mass_matrix_update_freq=10))
    jkw = dict(kw, adapt=jnt.AdaptScheduleOptions(
        mass_matrix_update_freq=10))
    lr = dict(store_mass_matrix=True, max_rank=max_rank)
    model, jmodel = tg.correlated_normal_rank1(4), jg.correlated_normal_rank1(4)
    s = tnt.Sampler(model, tnt.LowRankNutsSettings(
        low_rank=tnt.LowRankSettings(**lr), **kw), device="cpu",
        dtype=torch.float64)
    js = jnt.Sampler(jmodel, jnt.LowRankNutsSettings(
        low_rank=jnt.LowRankSettings(**lr), **jkw))
    trace, jtrace = s.run(), js.run()
    got, want = _groups(trace), _groups(jtrace)
    # num_eigenvalues is jnp.sum of int32 flags: int32 on the JAX
    # package's device, int64 under the tests' x64; the port keeps int32
    for g in want.values():
        shape, dt = g["num_eigenvalues"]
        assert dt == np.int64
        g["num_eigenvalues"] = (shape, np.dtype(np.int32))
    assert got == want
    rank = max_rank or 4
    assert got["sample_stats"]["mass_matrix_eigvals"] == (
        (2, 10, rank), np.float64)
    assert got["sample_stats"]["num_eigenvalues"] == ((2, 10), np.int32)
    for ev, jev in zip(trace.transformation_updates,
                       jtrace.transformation_updates):
        assert set(ev) == set(jev)
        for k in ev:
            assert ev[k].shape == np.asarray(jev[k]).shape, k
    sch, jsch = s.schema(), js.schema()
    for group in ("sample_stats", "warmup_sample_stats"):
        for name in ("mass_matrix_eigvals", "num_eigenvalues"):
            a, b = sch[group][name], jsch[group][name]
            assert (a["shape"], a["dims"]) == (tuple(b["shape"]), b["dims"])
            assert np.dtype(a["dtype"]).kind == np.dtype(b["dtype"]).kind
            assert a["dtype"] == got[group][name][1]
    ev, jev = (x["events"]["transformation_update"] for x in (sch, jsch))
    assert set(ev) == set(jev)
    for name in ("mass_matrix_eigvals", "num_eigenvalues"):
        assert ev[name]["shape"] == tuple(jev[name]["shape"])
        assert np.dtype(ev[name]["dtype"]) == np.dtype(jev[name]["dtype"])
    # MCLMC: the port's draw step emits them as its NUTS one does
    mtrace = tnt.sample(model, tnt.LowRankMclmcSettings(
        low_rank=tnt.LowRankSettings(**lr), **kw), device="cpu",
        dtype=torch.float64)
    mgot = _groups(mtrace)["sample_stats"]
    for name in ("mass_matrix_eigvals", "num_eigenvalues"):
        assert mgot[name] == got["sample_stats"][name]


def test_a_fused_request_is_demoted_with_the_jax_reason():
    kw = dict(num_chains=4, num_tune=20, num_draws=4,
              posterior_kernel="pallas")
    for make, jmake in ((tnt.LowRankNutsSettings, jnt.LowRankNutsSettings),
                        (tnt.LowRankMclmcSettings,
                         jnt.LowRankMclmcSettings)):
        reasons = make(**kw)._pallas_disqualifiers()
        assert reasons == jmake(**kw)._pallas_disqualifiers()
        assert reasons and reasons[0].startswith("mass_matrix='low_rank'")
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            s = tnt.Sampler(tg.normal_logp(3, 1.0), make(**kw), device="cpu")
        assert any(reasons[0] in str(w.message) for w in seen)
        assert all("sync" in r.__qualname__ for _, _, r in s._phase_runners)
    with pytest.raises(ValueError, match="requires mass_matrix='diag'"):
        tnt.LowRankNutsSettings(adapt=tnt.AdaptScheduleOptions(
            window_by_good_draws=True)).chain_config()
    with pytest.raises(ValueError, match="requires mass_matrix='diag'"):
        jnt.LowRankNutsSettings(adapt=jnt.AdaptScheduleOptions(
            window_by_good_draws=True)).chain_config()


def test_the_csv_and_arrow_backends_carry_them_as_the_jax_ones(tmp_path):
    """The eigenvalue stats of a low-rank run's chunks in the port's CSV
    and Arrow backends and in the JAX package's, from the same chunks:
    the same files and tables (the CSV keeps the reference's scalar
    columns, so neither writes them there; Arrow keeps every stat)."""
    from nuts_rs_tpu.storage.arrow import ArrowStorage as JArrow
    from nuts_rs_tpu.storage.csv import CsvStorage as JCsv
    from nuts_rs_tpu_torch.storage.arrow import ArrowStorage
    from nuts_rs_tpu_torch.storage.csv import CsvStorage

    settings = tnt.LowRankNutsSettings(
        num_chains=2, num_tune=30, num_draws=6, seed=4,
        adapt=tnt.AdaptScheduleOptions(mass_matrix_update_freq=10),
        low_rank=tnt.LowRankSettings(store_mass_matrix=True, max_rank=2))
    s = tnt.Sampler(tg.correlated_normal_rank1(4), settings, chunk_size=8,
                    device="cpu")
    chunks = []
    while not s.finished:
        lo, stats, tuning = s.run_next_chunk()
        chunks.append((lo, stats, {}, tuning))
    assert "mass_matrix_eigvals" in chunks[0][1]
    backends = {"arrow": (ArrowStorage(settings, None, 2),
                          JArrow(settings, None, 2)),
                "csv": (CsvStorage(str(tmp_path / "t"), settings, None, 2),
                        JCsv(str(tmp_path / "j"), settings, None, 2))}
    for got, want in backends.values():
        for chunk in chunks:
            got.record_chunk(*chunk)
            want.record_chunk(*chunk)
    got, want = (b.finalize() for b in backends["arrow"])
    for group, table in want.items():
        assert got[group].equals(table), group
        assert "mass_matrix_eigvals" in table.column_names
        assert "num_eigenvalues" in table.column_names
    for b in backends["csv"]:
        b.finalize()
    for c in range(2):
        text = (tmp_path / "t" / f"chain_{c}.csv").read_text()
        assert text == (tmp_path / "j" / f"chain_{c}.csv").read_text()
        assert "eigenvalues" not in text.splitlines()[0]
