"""Camera model (host-side numpy; tensors enter torch only at render time).

Own copy of the JAX package's cameras/camera.py with the same semantics
(counterpart of the reference's RCamera + graphics_utils, reference:
utils/cam_utils.py:148-217, utils/graphics_utils.py:39-119).
Differences by design:
  * matrices are kept in **column-vector convention** (x_cam = V @ x_world);
    the reference stores torch-transposed (row-vector) copies because its
    CUDA rasterizer consumes them that way. This package's rasterizer takes
    the column-convention matrices directly.
  * cameras are plain frozen dataclasses (hashable by id, cheap to build on
    host per step) — no nn.Module, no device placement.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np


def fov2focal(fov: float, pixels: int) -> float:
    return pixels / (2 * math.tan(fov / 2))


def focal2fov(focal: float, pixels: int) -> float:
    return 2 * math.atan(pixels / (2 * focal))


def get_world2view(
    R: np.ndarray,
    t: np.ndarray,
    translate: np.ndarray | None = None,
    scale: float = 1.0,
) -> np.ndarray:
    """World-to-view matrix, column-vector convention.

    Mirrors getWorld2View2 (reference: graphics_utils.py:47-58): R is the
    camera-to-world rotation, t the world-to-view translation; the camera
    center may be rescaled/translated before re-inverting.
    """
    Rt = np.zeros((4, 4), dtype=np.float64)
    Rt[:3, :3] = R.T
    Rt[:3, 3] = t
    Rt[3, 3] = 1.0
    if translate is not None or scale != 1.0:
        translate = np.zeros(3) if translate is None else np.asarray(translate)
        c2w = np.linalg.inv(Rt)
        c2w[:3, 3] = c2w[:3, 3] * scale + translate
        Rt = np.linalg.inv(c2w)
    return Rt.astype(np.float32)


def get_projection_matrix(
    znear: float, zfar: float, fovx: float, fovy: float
) -> np.ndarray:
    """Perspective projection, column-vector convention
    (reference: graphics_utils.py:61-81). Maps view-space z in [znear,zfar]
    to NDC z in [0,1]; x,y to [-1,1] (times w)."""
    tan_half_fovy = math.tan(fovy / 2)
    tan_half_fovx = math.tan(fovx / 2)
    p = np.zeros((4, 4), dtype=np.float32)
    p[0, 0] = 1.0 / tan_half_fovx
    p[1, 1] = 1.0 / tan_half_fovy
    p[2, 2] = zfar / (zfar - znear)
    p[2, 3] = -(zfar * znear) / (zfar - znear)
    p[3, 2] = 1.0
    return p


@dataclasses.dataclass(frozen=True)
class Camera:
    """A single render camera.

    R: [3,3] camera-to-world rotation; T: [3] world-to-view translation
    (same split as the reference's RandCameraInfo). delta_* are the pose
    deltas vs the default front view, used by the view-dependent prompt
    selector (reference: cam_utils.py:47-134).
    """

    R: np.ndarray
    T: np.ndarray
    fovx: float
    fovy: float
    width: int
    height: int
    delta_polar: float = 0.0
    delta_azimuth: float = 0.0
    delta_radius: float = 0.0
    znear: float = 0.01
    zfar: float = 100.0
    trans: tuple = (0.0, 0.0, 0.0)
    scale: float = 1.0

    @property
    def world_view_transform(self) -> np.ndarray:
        """[4,4] world->view, column-vector convention."""
        return get_world2view(self.R, self.T, np.asarray(self.trans), self.scale)

    @property
    def projection_matrix(self) -> np.ndarray:
        return get_projection_matrix(self.znear, self.zfar, self.fovx, self.fovy)

    @property
    def full_proj_transform(self) -> np.ndarray:
        """[4,4] world->clip, column-vector convention."""
        return (self.projection_matrix @ self.world_view_transform).astype(np.float32)

    @property
    def camera_center(self) -> np.ndarray:
        return np.linalg.inv(self.world_view_transform)[:3, 3].astype(np.float32)

    @property
    def tanfovx(self) -> float:
        return math.tan(self.fovx / 2)

    @property
    def tanfovy(self) -> float:
        return math.tan(self.fovy / 2)
