"""bench/throughput.py against the repo's bench.py: the same 300K-splat
scene bit for bit, the same orbit camera, the same tracked-capacity
arithmetic, and at a reduced size (20K splats of the bench scene at 128^2)
the same loss, raw entry count and gradients through the port's `render`
(plain versions on the CPU) as through the JAX `render` (Pallas kernels
interpreted).

Tolerances: integers bit-equal; the loss at rtol 1e-4; gradients atol 2e-4
after scaling by the JAX side's max |g| (the JAX suite's own).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from __graft_entry__ import _camera
from dreamscene_tpu.ops.rasterizer import render as j_render
from dreamscene_tpu.training.capacity import CapacityController as JCapacityController
from dreamscene_tpu_torch.bench import throughput as T

torch.set_num_threads(1)

SMALL_N, SMALL_SIZE = 20_000, 128


def test_build_scene_is_bench_scene_bit_for_bit():
    ours = T.build_scene(T.N_GAUSSIANS)
    theirs = bench.build_scene(bench.N_GAUSSIANS)
    assert T.N_GAUSSIANS == bench.N_GAUSSIANS
    assert set(ours) == set(theirs) == set(T.PARAMS)
    for k in T.PARAMS:
        a, b = ours[k], np.asarray(theirs[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert np.array_equal(a, b), k


def test_orbit_camera_is_graft_entry_camera():
    ours, theirs = T.camera(), _camera(T.WIDTH, T.HEIGHT)
    for f in ("world_view_transform", "full_proj_transform", "camera_center"):
        np.testing.assert_allclose(np.asarray(getattr(ours, f)), np.asarray(getattr(theirs, f)),
                                   atol=1e-6, err_msg=f)
    assert (ours.width, ours.height) == (theirs.width, theirs.height) == (512, 512)
    np.testing.assert_allclose([ours.tanfovx, ours.tanfovy], [theirs.tanfovx, theirs.tanfovy],
                               atol=1e-6)


def bench_capacity(raw, n):
    """bench.tracked_capacity's arithmetic on a given raw count."""
    ctrl = JCapacityController()
    ctrl.mult = ctrl._quantize(raw * ctrl.pad / n, n)
    return ctrl.capacity(n)


@pytest.mark.parametrize("raw, n", [(1_294_098, 300_000), (0, 300_000), (1, 300_000),
                                    (300_000, 300_000), (4_363_636, 300_000),
                                    (20_000_000, 300_000), (9_999, 2_000)])
def test_capacity_arithmetic_matches_bench(raw, n):
    assert T.capacity_for(raw, n) == bench_capacity(raw, n)


def test_headline_capacity_of_the_tpu_run():
    """BENCH_r05.json: 1,294,098 raw entries at N = 300,000 -> 1,425,000."""
    assert T.capacity_for(1_294_098, 300_000) == 1_425_000


@pytest.fixture(scope="module")
def small_views():
    """The first SMALL_N splats of the bench scene at SMALL_SIZE^2, through
    both renders at the tracked capacity (from the JAX side's raw count)."""
    scene = {k: v[:SMALL_N] for k, v in T.build_scene(T.N_GAUSSIANS).items()}
    cam = _camera(SMALL_SIZE, SMALL_SIZE)
    cam_j = dict(viewmatrix=jnp.asarray(cam.world_view_transform),
                 projmatrix=jnp.asarray(cam.full_proj_transform),
                 campos=jnp.asarray(cam.camera_center))

    def j_out(params, capacity):
        return j_render(**params, **cam_j, tanfovx=cam.tanfovx, tanfovy=cam.tanfovy,
                        width=SMALL_SIZE, height=SMALL_SIZE, bg=jnp.zeros((3,), jnp.float32),
                        sh_degree=T.SH_DEGREE, capacity=capacity, chunk=T.CHUNK,
                        interpret=True)

    def j_loss(params, capacity):
        out = j_out(params, capacity)
        return (jnp.mean(out["image"]) + 0.1 * jnp.mean(out["depth"])
                + 0.01 * jnp.mean(out["alpha"]))

    params_j = {k: jnp.asarray(v) for k, v in scene.items()}
    probe = min(16 * SMALL_N, JCapacityController.HARD_CAP)
    o = jax.jit(lambda p: j_out(p, probe))(params_j)
    raw_j = int(o["n_entries"]) + int(o["n_dropped"])
    capacity = bench_capacity(raw_j, SMALL_N)
    loss_j, grads_j = jax.jit(jax.value_and_grad(lambda p: j_loss(p, capacity)))(params_j)

    params_t = {k: torch.from_numpy(v.copy()) for k, v in scene.items()}
    cam_t = T.camera_tensors(T.camera(SMALL_SIZE, SMALL_SIZE), "cpu")
    cap_t, raw_t = T.tracked_capacity(params_t, cam_t, "cpu")
    loss_t, dropped_t, grads_t = T.step_fn(params_t, cam_t, capacity, device="cpu")()
    return dict(raw=(raw_j, raw_t), capacity=(capacity, cap_t), loss=(float(loss_j),
                float(loss_t)), dropped=int(dropped_t),
                grads=({k: np.asarray(grads_j[k]) for k in T.PARAMS},
                       {k: g.numpy() for k, g in zip(T.PARAMS, grads_t)}))


def test_small_view_raw_entries_and_capacity_match_jax(small_views):
    raw_j, raw_t = small_views["raw"]
    assert raw_t == raw_j > 0
    cap_j, cap_t = small_views["capacity"]
    assert cap_t == cap_j and small_views["dropped"] == 0


def test_small_view_loss_matches_jax(small_views):
    loss_j, loss_t = small_views["loss"]
    np.testing.assert_allclose(loss_t, loss_j, rtol=1e-4)


@pytest.mark.parametrize("name", T.PARAMS)
def test_small_view_gradients_match_jax(small_views, name):
    gj, gt = (g[name] for g in small_views["grads"])
    scale = float(np.abs(gj).max())
    assert scale > 0, name
    np.testing.assert_allclose(gt / scale, gj / scale, atol=2e-4, err_msg=name)
