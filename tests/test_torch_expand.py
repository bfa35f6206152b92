"""The model's expansions and the file backends of the port on the CPU.

``expand_fn`` (one position through ``torch.func.vmap``, or a whole chunk
with a ``torch.Generator``) and ``expand_host_fn`` (numpy, with the chunk's
first draw where its second parameter is required) are stored beside the
positions; both read the float32 positions whatever ``draw_dtype`` stores,
and an all-tuning chunk under ``store_warmup=False`` expands nothing.
``schema()`` reflects them as the JAX package's ``schema()`` does, and a
backend with ``wants_schema`` gets the schema before the first chunk.  The
CSV and Arrow backends (copies of the JAX package's) write what the JAX
ones write for the same chunks, and take a run with expansions."""

import csv
import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nuts_rs_tpu as jnt
import nuts_rs_tpu_torch as tnt
from nuts_rs_tpu.models import gaussian as jg
from nuts_rs_tpu.storage.arrow import ArrowStorage as JArrowStorage
from nuts_rs_tpu.storage.csv import CsvStorage as JCsvStorage
from nuts_rs_tpu_torch.chain import PURPOSE_EXPAND
from nuts_rs_tpu_torch.kernels.rng import derive_seed
from nuts_rs_tpu_torch.models import gaussian as tg
from nuts_rs_tpu_torch.storage.arrow import ArrowStorage
from nuts_rs_tpu_torch.storage.core import StorageConfig
from nuts_rs_tpu_torch.storage.csv import CsvStorage
from nuts_rs_tpu_torch.storage.memory import MemoryStorage

GROUPS = ("posterior", "sample_stats", "warmup_posterior",
          "warmup_sample_stats")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _settings(kernel="sync", **kw):
    base = dict(num_chains=3, num_tune=12, num_draws=12, seed=2,
                posterior_kernel=kernel)
    base.update(kw)
    return tnt.DiagNutsSettings(**base)


def _exp_model(host=None):
    """N(3, 1) at d = 3 (a hook model) with e = exp(q - 3) and s = sum(q)."""
    base = tg.normal_logp(3, 3.0)
    return dataclasses.replace(
        base, expand_fn=lambda q: {"e": torch.exp(q - 3.0), "s": q.sum()},
        expand_host_fn=host)


def _draw_index(pos, first_draw):
    C, k = pos.shape[:2]
    return {"draw_no": np.broadcast_to(first_draw + np.arange(k),
                                       (C, k)).astype(np.int64)}


def test_eight_schools_deterministics_are_stored():
    model = tg.eight_schools()
    trace = tnt.sample(model, _settings(num_draws=10), chunk_size=7,
                       device="cpu")
    q = trace.posterior["position"]
    assert trace.posterior["theta"].shape == (3, 10, 8)
    for name in ("mu", "tau", "theta"):
        want = np.stack([np.stack([model.expand_fn(torch.as_tensor(x))[name]
                                   .numpy() for x in row]) for row in q])
        np.testing.assert_array_equal(trace.posterior[name], want)
    assert trace.warmup_posterior["tau"].shape == (3, 12)
    assert tnt.schema(model, _settings())["posterior"]["theta"]["dims"] == [
        "school"]


@pytest.mark.parametrize("kernel", ["sync", "pallas"])
def test_expansions_read_float32_positions_under_float16(kernel):
    model = _exp_model(host=lambda pos: {"twice": pos.astype(np.float64)
                                         * 2.0})
    full = tnt.sample(model, _settings(kernel), chunk_size=8, device="cpu")
    thin = tnt.sample(model, _settings(kernel), chunk_size=8, device="cpu",
                      draw_dtype=np.float16)
    q32 = full.posterior["position"]
    assert thin.posterior["position"].dtype == np.float16
    np.testing.assert_array_equal(thin.posterior["position"],
                                  q32.astype(np.float16))
    np.testing.assert_array_equal(
        thin.posterior["e"], torch.exp(torch.as_tensor(q32) - 3.0).numpy())
    np.testing.assert_array_equal(thin.posterior["twice"],
                                  q32.astype(np.float64) * 2.0)
    for name in ("e", "s", "twice"):
        np.testing.assert_array_equal(thin.posterior[name],
                                      full.posterior[name])
        np.testing.assert_array_equal(thin.warmup_posterior[name],
                                      full.warmup_posterior[name])


def test_host_expansion_arity_and_draw_index():
    calls = {}

    def one(pos):
        calls["one"] = True
        return {"n": np.zeros(pos.shape[:2], np.int32)}

    def defaulted(pos, scale=2.0):
        return {"scaled": pos * scale}

    def star(*args):
        assert len(args) == 1
        return {"star": args[0][..., 0]}

    for fn in (one, defaulted, star):
        trace = tnt.sample(_exp_model(host=fn), _settings(num_draws=4),
                           chunk_size=5, device="cpu")
    assert calls == {"one": True}
    assert "star" in trace.posterior
    # the draw index of a two-argument fn does not depend on chunk_size
    runs = [tnt.sample(_exp_model(host=_draw_index), _settings(),
                       chunk_size=c, device="cpu") for c in (5, 7)]
    for tr in runs:
        np.testing.assert_array_equal(
            tr.posterior["draw_no"],
            np.broadcast_to(np.arange(12, 24), (3, 12)))
        np.testing.assert_array_equal(
            tr.warmup_posterior["draw_no"],
            np.broadcast_to(np.arange(12), (3, 12)))


def test_two_argument_expand_fn_gets_a_seeded_generator():
    seen = []

    def noisy(q, gen):
        seen.append(gen.device)
        u = torch.rand(q.shape[:2], generator=gen, device=q.device)
        return {"u": u, "q0": q[..., 0]}

    model = dataclasses.replace(tg.normal_logp(3, 0.0), expand_fn=noisy)
    s = tnt.Sampler(model, _settings(), chunk_size=8, device="cpu")
    trace = s.run()
    a = tnt.sample(model, _settings(), chunk_size=8, device="cpu")
    np.testing.assert_array_equal(trace.posterior["u"], a.posterior["u"])
    assert all(d == torch.device("cpu") for d in seen)
    u = np.concatenate([trace.warmup_posterior["u"], trace.posterior["u"]],
                       1)
    for lo, hi, _ in s.chunk_seconds:
        gen = torch.Generator().manual_seed(derive_seed(3, lo,
                                                        PURPOSE_EXPAND))
        np.testing.assert_array_equal(
            u[:, lo:hi], torch.rand((3, hi - lo), generator=gen).numpy())
    np.testing.assert_array_equal(trace.posterior["q0"],
                                  trace.posterior["position"][..., 0])


def test_store_warmup_false_expands_no_all_tuning_chunk():
    firsts = []

    def host(pos, first_draw):
        firsts.append((first_draw, pos.shape[1]))
        return _draw_index(pos, first_draw)

    s = tnt.Sampler(_exp_model(host=host), _settings(), chunk_size=5,
                    device="cpu", store_warmup=False)
    trace = s.run()
    # chunks 0-5, 5-10 are all tuning; 10-15 crosses the warmup's end
    assert firsts == [(10, 5), (15, 5), (20, 4)]
    assert trace.warmup_posterior == {} or all(
        v.shape[1] == 0 for v in trace.warmup_posterior.values())
    np.testing.assert_array_equal(trace.posterior["draw_no"],
                                  np.broadcast_to(np.arange(12, 24), (3, 12)))
    assert trace.posterior["e"].shape == (3, 12, 3)


def _jax_exp_model(host):
    base = jg.normal_logp(3, 3.0)
    return dataclasses.replace(
        base, expand_fn=lambda key, q: {"e": jnp.exp(q - 3.0),
                                        "s": jnp.sum(q)},
        expand_host_fn=host, dims={"e": ["param"]})


def _labels(pos, first_draw):
    C, k = pos.shape[:2]
    lab = np.array([[f"d{first_draw + j}" for j in range(k)]] * C)
    return {**_draw_index(pos, first_draw), "label": lab.astype("<U8")}


@pytest.mark.parametrize("knobs", [{}, {"draw_dtype": np.float16},
                                   {"store_warmup": False}])
def test_schema_with_both_expansions_is_the_jax_packages(knobs):
    model = dataclasses.replace(_exp_model(host=_labels),
                                dims={"e": ["param"]})
    js = jnt.DiagNutsSettings(num_chains=3, num_tune=12, num_draws=12,
                              seed=2)
    want = jnt.schema(_jax_exp_model(_labels), js, dtype=jnp.float32,
                      **knobs)
    got = tnt.schema(model, _settings(), **knobs)
    for group in GROUPS + ("events",):
        assert got[group] == want[group], group
    assert {"e", "s", "draw_no", "label"} <= set(got["posterior"])
    s = tnt.Sampler(model, _settings(), chunk_size=7, device="cpu", **knobs)
    assert s.schema() == got
    trace = s.run()
    for group in GROUPS:
        arrays = {k: v for k, v in getattr(trace, group).items()
                  if v.shape[1]}
        assert set(arrays) == set(got[group]), group
        for name, v in arrays.items():
            assert v.dtype == got[group][name]["dtype"], name
            assert v.shape[2:] == got[group][name]["shape"], name


def test_a_failing_host_probe_warns_and_is_left_out():
    def picky(pos):
        if not pos.any():
            raise ValueError("zeros")
        return {"x": pos[..., 0]}

    with pytest.warns(UserWarning, match="schema probe"):
        sch = tnt.schema(_exp_model(host=picky), _settings())
    assert "x" not in sch["posterior"] and "e" in sch["posterior"]


class _Declaring(StorageConfig):
    """A memory backend that wants the schema upfront."""

    def __init__(self, fail=False):
        self.fail = fail
        self.declared = []

    def new_trace(self, settings, model, num_chains):
        cfg = self

        class Store(MemoryStorage):
            wants_schema = True

            def declare_schema(self, schema):
                if cfg.fail:
                    raise RuntimeError("no")
                cfg.declared.append(schema)

        return Store(settings, model, num_chains)


def test_declare_schema_comes_before_the_first_chunk():
    cfg = _Declaring()
    s = tnt.Sampler(_exp_model(host=_draw_index), _settings(),
                    storage=cfg, device="cpu")
    assert cfg.declared == [s.schema()] and s._next_draw == 0
    with pytest.warns(RuntimeWarning, match="reflection failed"):
        tnt.Sampler(_exp_model(), _settings(), storage=_Declaring(True),
                    device="cpu")


def _chunks():
    """The same chunks for both packages' backends: the stats of the sync
    engine with one expansion, a tuning and a posterior chunk."""
    rng = np.random.default_rng(4)
    C, d = 2, 3
    out = []
    for start, k, tun in ((0, 3, True), (3, 4, False)):
        stats = {"position": rng.normal(size=(C, k, d)).astype(np.float32),
                 "diverging": rng.random((C, k)) < 0.3,
                 "n_steps": rng.integers(1, 9, (C, k)).astype(np.int32),
                 "step_size": rng.random((C, k)).astype(np.float32),
                 "energy": rng.normal(size=(C, k)).astype(np.float32),
                 "gradient": rng.normal(size=(C, k, d)).astype(np.float32)}
        expanded = {"theta": rng.normal(size=(C, k, 2, 2)),
                    "count": np.full((C, k), start, np.int64)}
        out.append((start, stats, expanded, np.full(k, tun)))
    return out


def test_csv_files_are_the_jax_backends(tmp_path):
    settings = _settings(num_tune=3, num_draws=4)
    for pkg, cls in (("torch", CsvStorage), ("jax", JCsvStorage)):
        store = cls(str(tmp_path / pkg), settings, None, 2)
        for chunk in _chunks():
            store.record_chunk(*chunk)
        store.flush()
        assert store.inspect() is None
        store.finalize()
    for c in range(2):
        name = f"chain_{c}.csv"
        got = (tmp_path / "torch" / name).read_text()
        assert got == (tmp_path / "jax" / name).read_text()
        rows = list(csv.reader(got.splitlines()))
        assert rows[0][:4] == ["sample_id", "diverging", "n_steps",
                               "step_size"]
        assert "theta.2.1" in rows[0] and "position.3" in rows[0]
        assert [r[0] for r in rows[1:]] == ["-3", "-2", "-1", "0", "1", "2",
                                            "3"]


def test_csv_backend_takes_a_run(tmp_path):
    out = tnt.sample(_exp_model(host=_draw_index), _settings(),
                     storage=tnt.CsvConfig(str(tmp_path)), chunk_size=5,
                     device="cpu")
    assert out == str(tmp_path)
    files = sorted(os.listdir(tmp_path))
    assert files == ["chain_0.csv", "chain_1.csv", "chain_2.csv"]
    rows = list(csv.reader((tmp_path / "chain_1.csv").read_text()
                           .splitlines()))
    assert len(rows) == 1 + 24
    head = rows[0]
    assert {"e.1", "s", "draw_no", "position.1"} <= set(head)
    assert [int(r[head.index("draw_no")]) for r in rows[1:]] == list(range(24))


def test_arrow_tables_are_the_jax_backends():
    settings = _settings(num_tune=3, num_draws=4)
    got, want = ArrowStorage(settings, None, 2), JArrowStorage(settings,
                                                               None, 2)
    for chunk in _chunks():
        got.record_chunk(*chunk)
        want.record_chunk(*chunk)
    for group, table in want.finalize().items():
        assert got.finalize()[group].equals(table), group
        assert got.inspect()[group].equals(table), group


def test_arrow_backend_takes_a_run():
    out = tnt.sample(_exp_model(host=_draw_index), _settings(),
                     storage=tnt.ArrowConfig(), chunk_size=5, device="cpu")
    post = out["posterior"]
    assert post.num_rows == 3 * 12
    assert {"chain", "draw", "position", "e", "s",
            "draw_no"} <= set(post.column_names)
    np.testing.assert_array_equal(post.column("draw").to_numpy(),
                                  post.column("draw_no").to_numpy())
    assert post.schema.field("e").metadata[b"shape"] == b"[3]"
    assert out["warmup"].num_rows == 3 * 12
