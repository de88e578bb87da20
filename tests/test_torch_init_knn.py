"""The port's initial clouds and scales against the JAX package: the
grid-hash KNN that sets every model's initial log-scales (the port's copy
of native/knn.cpp, built with native/build.sh's flags), its build, and the
point-e branch of `init_object_points`.

Tolerance: none. Distances, log-scales, points, colours and the cached PLY
are bit-equal.
"""

import concurrent.futures
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from dreamscene_tpu.models import gaussians as jg
from dreamscene_tpu.models import init as ji
from dreamscene_tpu_torch.models import gaussians as tg
from dreamscene_tpu_torch.models import init as ti

# One intra-op thread: the suite runs several worker processes at once, and
# one OpenMP team of all cores per worker makes these small tensors wait on
# each other (the six heaviest files of the port took 205 s on 8 cores with
# 6 workers, 66 s with one thread each).
torch.set_num_threads(1)


def require_jax_knn():
    """The JAX package builds native/libdsknn.so at first use without a
    lock, so a worker can load a half-written file while another worker
    writes it and fall back to cKDTree; wait until its library loads."""
    for _ in range(120):
        if jg._native_knn():
            return
        jg._KNN_LIB = None
        time.sleep(1.0)
    raise AssertionError("the JAX package's native KNN library does not load")


def cloud(case):
    rng = np.random.RandomState(11)
    if case == "uniform 1000":
        return rng.rand(1000, 3)
    if case == "uniform 50000":
        return rng.rand(50_000, 3) * 4.0 - 2.0
    box = np.array([-3.0, -2.5, 0.0, 3.0, 2.5, 2.8], np.float32)    # an indoor scene box
    return ti.init_env_points("indoor", box, seed=5, density=0.02)[0]


CASES = ["uniform 1000", "uniform 50000", "env shell"]


@pytest.mark.parametrize("case", CASES)
def test_mean_sq_dist_bit_equal(case):
    require_jax_knn()
    pts = cloud(case)
    ref = jg.mean_sq_dist_to_3nn(pts)
    got = tg.mean_sq_dist_to_3nn(pts)
    assert got.dtype == ref.dtype == np.float64
    assert np.array_equal(got, ref), int((got != ref).sum())


@pytest.mark.parametrize("case", CASES)
def test_create_from_points_scales_bit_equal(case):
    require_jax_knn()
    pts = cloud(case).astype(np.float32)
    cols = np.random.RandomState(12).rand(pts.shape[0], 3).astype(np.float32)
    ref = jg.create_from_points(pts, cols, sh_degree=1)
    got = tg.create_from_points(pts, cols, sh_degree=1, device="cpu")
    assert np.array_equal(got.params["scaling"].numpy(), np.asarray(ref.params.scaling))


def test_knn_build_failure_raises(tmp_path, monkeypatch):
    """No cKDTree fallback: a source that does not compile raises, and so
    does every distance query that needs the library."""
    bad = tmp_path / "knn.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(tg, "KNN_SOURCE", bad)
    monkeypatch.setattr(tg, "knn_library_path", lambda: tmp_path / "lib" / "libdsknn.so")
    monkeypatch.setattr(tg, "_KNN_LIB", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed on knn.cpp"):
        tg.build_knn()
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        tg.mean_sq_dist_to_3nn(np.random.RandomState(0).rand(100, 3))
    assert not (tmp_path / "lib" / "libdsknn.so").exists()


def test_knn_builds_once_under_the_lock(tmp_path, monkeypatch):
    """Builders that start together (pytest workers, ranks) build once:
    the others wait on the lock and then find the library up to date.
    flock locks belong to open file descriptions, so threads contend as
    processes do."""
    lib = tmp_path / "host" / "libdsknn.so"
    monkeypatch.setattr(tg, "knn_library_path", lambda: lib)
    with concurrent.futures.ThreadPoolExecutor(4) as ex:
        times = list(ex.map(lambda _: tg.build_knn(), range(4)))
    assert sum(t > 0 for t in times) == 1, times
    assert sorted(p.name for p in lib.parent.iterdir()) == [".lock", "libdsknn.so"]
    assert tg.build_knn() == 0.0
    assert tg.build_knn(force=True) > 0


def pointe_cloud():
    rng = np.random.RandomState(7)
    return (rng.randn(4096, 3).astype(np.float32) * 0.3, rng.rand(4096, 3).astype(np.float32))


@pytest.mark.parametrize("use_pointe_rgb", [False, True])
def test_pointe_branch_matches_jax(tmp_path, monkeypatch, use_pointe_rgb):
    """point-e's cloud (one seeded stand-in given to both packages) is
    flipped, lifted and spread over jitter balls draw for draw; the cache
    is written and read back alike."""
    base = pointe_cloud()
    monkeypatch.setattr(ji, "_try_pointe", lambda prompt, variant: base)
    monkeypatch.setattr(ti, "_try_pointe", lambda prompt, variant, device: base)
    dirs = {k: tmp_path / k for k in ("jax", "port")}
    for d in dirs.values():
        d.mkdir()
    kw = dict(use_pointe_rgb=use_pointe_rgb, seed=3)
    ref = ji.init_object_points("pointe_330k", "a vase", str(dirs["jax"]), **kw)
    got = ti.init_object_points("pointe_330k", "a vase", str(dirs["port"]), **kw)
    assert got[0].shape == (4096 * 20, 3) and got[2] == ref[2] == 1.0
    for a, b in zip(ref[:2], got[:2]):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    name = ji.hash_prompt("pointe_330k", "a vase") + "_init_points3d.ply"
    assert (dirs["port"] / name).read_bytes() == (dirs["jax"] / name).read_bytes()
    ref = ji.init_object_points("pointe_330k", "a vase", str(dirs["jax"]), **kw)
    got = ti.init_object_points("pointe_330k", "a vase", str(dirs["port"]), **kw)
    for a, b in zip(ref, got):
        assert np.array_equal(a, b)


def test_pointe_fallback_matches_jax(tmp_path, monkeypatch, caplog):
    """Without point-e both packages fall back to the ball, draw for draw,
    and cache nothing; the port's warning names the failure."""
    monkeypatch.setitem(sys.modules, "point_e", None)
    ref = ji.init_object_points("pointe", "a vase", str(tmp_path), num_pts=500, seed=4)
    with caplog.at_level("WARNING", logger="dreamscene_tpu_torch"):
        got = ti.init_object_points("pointe", "a vase", str(tmp_path), num_pts=500, seed=4)
    assert "ModuleNotFoundError" in caplog.text and "falling back to ball init" in caplog.text
    assert got[2] == ref[2] == 1.0
    for a, b in zip(ref[:2], got[:2]):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert list(Path(tmp_path).iterdir()) == []
