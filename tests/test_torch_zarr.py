"""The port's Zarr backend (``storage/zarr.py``, ``storage/zarr_format.py``
and the native writer, copies of the JAX package's) on the CPU.

The same chunks recorded into the port's ``ZarrStorage`` and the JAX
package's give the same store: the same files, the same array metadata and
dims, the same chunk bytes once decompressed, the same sparse events
(int32 widened to int64, zlib, ``store_warmup=False``, the async native
writer and synchronous writes); each package reads the other's store with
its own ``read_array`` / ``read_attrs``; a run through
``ZarrConfig`` reads back equal to the same run into memory storage.  A
native build that fails raises with the compiler's stderr, and so does a
``ZarrConfig(async_writes=True)`` that needs it."""

import json
import os

import numpy as np
import pytest
import torch

from nuts_rs_tpu.storage import zarr as jzarr
from nuts_rs_tpu.storage import zarr_format as jfmt
import nuts_rs_tpu_torch as tnt
from nuts_rs_tpu_torch.native import writer as tw
from nuts_rs_tpu_torch.storage import zarr as tzarr
from nuts_rs_tpu_torch.storage import zarr_format as tfmt
from nuts_rs_tpu_torch.models.gaussian import normal_logp

GROUPS = ("posterior", "sample_stats", "warmup_posterior",
          "warmup_sample_stats")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _settings(**kw):
    base = dict(num_chains=3, num_tune=12, num_draws=12, seed=5,
                store_divergences=True, store_mass_matrix=True)
    base.update(kw)
    return tnt.DiagNutsSettings(**base)


def _both_stores(tmp_path, settings, async_writes, store_warmup=True):
    """A sampler whose chunks go to memory storage and to both packages'
    Zarr stores; returns (memory trace, port path, JAX path)."""
    model = normal_logp(3, 1.0)
    s = tnt.Sampler(model, settings, chunk_size=5, device="cpu")
    C = settings.num_chains
    paths = {k: str(tmp_path / f"{k}.zarr") for k in ("torch", "jax")}
    stores = {
        "torch": tzarr.ZarrStorage(paths["torch"], settings, model, C,
                                   chunk_draws=4, async_writes=async_writes,
                                   codec="zlib", store_warmup=store_warmup),
        "jax": jzarr.ZarrStorage(paths["jax"], settings, model, C,
                                 chunk_draws=4, async_writes=async_writes,
                                 codec="zlib", store_warmup=store_warmup)}
    for store in stores.values():
        store.declare_schema(s.schema())
    record0 = s.trace.record_chunk

    def record(*a):
        record0(*a)
        for store in stores.values():
            store.record_chunk(*a)

    s.trace.record_chunk = record
    trace = s.run()
    for store in stores.values():
        assert store.finalize()
    return trace, paths["torch"], paths["jax"]


def _files(root):
    out = set()
    for d, _, names in os.walk(root):
        out.update(os.path.relpath(os.path.join(d, n), root) for n in names)
    return out


@pytest.mark.parametrize("async_writes,store_warmup", [
    (True, True), (False, True), (True, False)])
def test_the_same_chunks_make_the_jax_packages_store(tmp_path, async_writes,
                                                     store_warmup):
    trace, tpath, jpath = _both_stores(tmp_path, _settings(), async_writes,
                                       store_warmup)
    files = _files(tpath)
    assert files == _files(jpath)
    for rel in sorted(files):
        a = open(os.path.join(tpath, rel), "rb").read()
        b = open(os.path.join(jpath, rel), "rb").read()
        if rel == ".zattrs":
            ta, ja = json.loads(a), json.loads(b)
            assert ta.pop("framework") == "nuts_rs_tpu_torch"
            assert ja.pop("framework") == "nuts_rs_tpu"
            assert ta == ja
        elif os.path.basename(rel).startswith("."):
            assert json.loads(a) == json.loads(b), rel
        else:
            assert tfmt._decompress(a, "zlib") == jfmt._decompress(
                b, "zlib"), rel
    # each package reads the other's store; both hold the memory trace
    groups = GROUPS if store_warmup else GROUPS[:2]
    assert {g for g in GROUPS if os.path.isdir(os.path.join(tpath, g))} \
        == set(groups)
    for g in groups:
        for name, want in getattr(trace, g).items():
            for read, root in ((jfmt.read_array, tpath),
                               (tfmt.read_array, jpath)):
                got = read(os.path.join(root, g, name))
                if want.dtype == np.int32:
                    want = want.astype(np.int64)
                assert got.dtype == want.dtype, (g, name)
                np.testing.assert_array_equal(got, want, err_msg=name)
            dims = jfmt.read_attrs(os.path.join(tpath, g, name))
            assert dims == tfmt.read_attrs(os.path.join(jpath, g, name))
            assert dims["_ARRAY_DIMENSIONS"][:2] == ["chain", "draw"]
    # the sparse events: each chain's transformation updates, from draw 0
    for root, read in ((tpath, jfmt.read_array), (jpath, tfmt.read_array)):
        ev = os.path.join(root, "sample_stats", "transformation_update_draw")
        draws = read(ev)
        assert draws.shape[0] == 3 and draws.dtype == np.int64
        assert (draws[:, 0] == 0).all()


def test_a_run_through_zarr_config_reads_back_as_memory_storage(tmp_path):
    settings = _settings(posterior_kernel="pallas", store_divergences=False,
                         store_mass_matrix=False)
    want = tnt.sample(normal_logp(3, 1.0), settings, chunk_size=5,
                      device="cpu")
    path = str(tmp_path / "run.zarr")
    got = tnt.sample(normal_logp(3, 1.0), settings, chunk_size=5,
                     device="cpu", storage=tnt.ZarrConfig(path,
                                                          chunk_draws=7))
    assert got == path
    for g in GROUPS:
        for name, arr in getattr(want, g).items():
            back = tfmt.read_array(os.path.join(path, g, name))
            np.testing.assert_array_equal(
                back, arr.astype(np.int64) if arr.dtype == np.int32 else arr)
    attrs = jfmt.read_attrs(path)
    assert attrs["sampler"] == "nuts" and attrs["framework"] == \
        "nuts_rs_tpu_torch"
    assert json.loads(attrs["settings"])["num_chains"] == 3


def test_an_fsspec_url_writes_through_fsspec():
    pytest.importorskip("fsspec")
    settings = _settings(store_divergences=False, store_mass_matrix=False)
    path = "memory://port-trace.zarr"
    tnt.sample(normal_logp(3, 1.0), settings, chunk_size=5, device="cpu",
               storage=tnt.ZarrConfig(path))
    pos = jfmt.read_array(path + "/posterior/position")
    assert pos.shape == (3, 12, 3) and np.isfinite(pos).all()


def test_a_failed_native_build_raises_with_the_compilers_stderr(
        tmp_path, monkeypatch):
    src = tmp_path / "broken.cpp"
    src.write_text("this is not C++;\n")
    with pytest.raises(tw.WriterBuildError, match="error") as err:
        tw.load(str(src), str(tmp_path / "out" / "broken.so"))
    assert "broken.cpp" in str(err.value)
    assert not os.path.exists(tmp_path / "out" / "broken.so")

    def fail(*a, **k):
        raise tw.WriterBuildError("g++: the build failed")

    monkeypatch.setattr(tw, "load", fail)
    with pytest.raises(tw.WriterBuildError, match="build failed"):
        tnt.Sampler(normal_logp(3, 1.0), _settings(), device="cpu",
                    storage=tnt.ZarrConfig(str(tmp_path / "t.zarr")))
    # async_writes=False is the explicit synchronous path
    tnt.Sampler(normal_logp(3, 1.0), _settings(), device="cpu",
                storage=tnt.ZarrConfig(str(tmp_path / "s.zarr"),
                                       async_writes=False)).run()


def test_the_writer_builds_into_the_build_directory():
    lib = tw.load()
    assert lib is tw.load()
    assert os.path.dirname(tw._LIB) == tw.BUILD_DIR
    assert os.path.basename(tw.BUILD_DIR) == "_build"
    assert os.path.exists(tw._LIB)
    assert not any(n.endswith(".so") for n in os.listdir(
        os.path.dirname(tw.__file__)))


def test_the_new_modules_leave_jax_out_and_ship_their_source():
    import subprocess
    import sys
    import tomllib
    from pathlib import Path

    repo = Path(__file__).resolve().parents[1]
    code = ("import sys, nuts_rs_tpu_torch.storage.zarr, "
            "nuts_rs_tpu_torch.storage.zarr_format, "
            "nuts_rs_tpu_torch.native.writer; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'nuts_rs_tpu.'))]; "
            "assert not bad, bad; print('ok')")
    out = subprocess.run([sys.executable, "-c", code], cwd=repo,
                         env=dict(os.environ, PYTHONPATH=str(repo)),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
    data = tomllib.loads((repo / "pyproject.toml").read_text())
    globs = data["tool"]["setuptools"]["package-data"]["nuts_rs_tpu_torch"]
    assert "native/*.cpp" in globs
    assert (repo / "nuts_rs_tpu_torch" / "native" / "trace_writer.cpp"
            ).exists()
