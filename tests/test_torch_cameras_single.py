"""The port's single camera and ray bundles against the JAX package's:
`load_single_cam` (the 1920x1080 camera of the reference's
GenSingleCam/loadSingleCam, azimuths on both sides of the 180-degree
wrap), `Camera.rays`, `Camera.scaled` and `get_rays`, bit for bit."""

import dataclasses

import numpy as np
import pytest
import torch

from dreamscene_tpu.cameras import camera as jcam
from dreamscene_tpu.cameras import sampling as jsamp
from dreamscene_tpu.utils.config import GenerateCamParams as JParams
from dreamscene_tpu_torch.cameras import camera as tcam
from dreamscene_tpu_torch.cameras import sampling as tsamp
from dreamscene_tpu_torch.utils.config import GenerateCamParams as TParams

# One intra-op thread: the suite runs several worker processes at once, and
# one OpenMP team of all cores per worker makes these small tensors wait on
# each other (the six heaviest files of the port took 205 s on 8 cores with
# 6 workers, 66 s with one thread each).
torch.set_num_threads(1)

# (camera_center, object_center, theta, radius): phi = atan2 + 180 lands
# below 180 (no wrap), above it (delta azimuth wraps to negative), and at it
SINGLE = [((0.0, 0.0, 0.0), (1.0, 0.0, 0.0), 90.0, 3.5),
          ((0.0, 0.0, 0.0), (-1.0, 0.0, 0.0), 90.0, 3.5),
          ((0.3, -0.2, 1.4), (-2.4, 1.6, 0.0), 75.0, 2.5),
          ((0.3, -0.2, 1.4), (2.9, -2.2, 0.4), 100.0, 4.0),
          ((0.0, 0.0, 0.0), (0.0, 1.0, 0.0), 90.0, 3.5)]


def assert_same_camera(a, b):
    for f in dataclasses.fields(jcam.Camera):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and np.array_equal(x, y), f.name
        else:
            assert x == y and type(x) is type(y), (f.name, x, y)
    for prop in ("world_view_transform", "full_proj_transform", "camera_center"):
        assert np.array_equal(getattr(a, prop), getattr(b, prop)), prop


@pytest.mark.parametrize("cc, oc, theta, radius", SINGLE)
def test_load_single_cam_bit_equal(cc, oc, theta, radius):
    ref = jsamp.load_single_cam(JParams(), camera_center=cc, object_center=oc, theta=theta,
                                radius=radius)
    got = tsamp.load_single_cam(TParams(), camera_center=cc, object_center=oc, theta=theta,
                                radius=radius)
    assert (got.width, got.height) == (1920, 1080)
    assert -180.0 <= got.delta_azimuth <= 180.0
    assert_same_camera(ref, got)
    assert_same_camera(ref.scaled(2), got.scaled(2))
    assert (got.scaled(2).width, got.scaled(2).height) == (3840, 2160)
    for down in (8, 5):
        r, g = ref.rays(down), got.rays(down)
        assert g.shape == (1080 // down, 1920 // down, 6) and g.dtype == np.float32
        assert np.array_equal(g, r)


def test_single_cam_azimuth_wraps_past_180():
    got = tsamp.load_single_cam(TParams(), object_center=(1.0, 0.0, 0.0))
    assert got.delta_azimuth == -90.0          # phi 270 -> -90


@pytest.mark.parametrize("H, W", [(64, 64), (9, 17)])
def test_get_rays_bit_equal(H, W):
    rng = np.random.RandomState(H + W)
    c2w = np.eye(4)
    c2w[:3, :3] = np.linalg.qr(rng.randn(3, 3))[0]
    c2w[:3, 3] = rng.randn(3)
    focal = tcam.fov2focal(0.7, W)
    got = tcam.get_rays(focal, c2w, H=H, W=W)
    assert np.array_equal(got, jcam.get_rays(focal, c2w, H=H, W=W))
    np.testing.assert_allclose(np.linalg.norm(got[..., 3:], axis=-1), 1.0, rtol=1e-6)
