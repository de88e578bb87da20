"""Object-level camera pose sampling (host-side numpy).

Copy of dreamscene_tpu/cameras/sampling.py, the parts the FPS step uses:
random poses and the anti-multi-face curriculum (reference:
utils/cam_utils.py:229-238, 584-790, 1732-1792). World convention: z-up; a pose is camera-to-world with columns
(-right, up, forward) and the camera placed on a sphere at (theta: polar
from +z, phi: azimuth measured from +y toward +x, i.e. centers =
r*(sin t sin p, sin t cos p, cos t)).

All randomness flows through an explicit numpy Generator for reproducible
runs (the reference seeds global `random`/torch, SURVEY.md §4 determinism).
"""

from __future__ import annotations

import dataclasses
import math
from typing import List

import numpy as np

from dreamscene_tpu_torch.cameras.camera import Camera, focal2fov, fov2focal

def safe_normalize(v, eps=1e-20):
    return v / np.sqrt(np.maximum(np.sum(v * v, axis=-1, keepdims=True), eps))


def gen_random_pos(rng: np.random.Generator, lo: float, hi: float, gamma: float = 1.0):
    """Gamma-warped symmetric sample in [lo, hi] (reference:
    cam_utils.py:229-238)."""
    mid = lo + (hi - lo) * 0.5
    radius = (hi - lo) * 0.5
    r = rng.random() ** gamma
    sign = -1.0 if rng.random() > 0.5 else 1.0
    return sign * r * radius + mid


def _lookat_pose(centers: np.ndarray, targets=0.0, up_noise=0.0) -> np.ndarray:
    """Camera-to-world pose(s) looking from `centers` toward `targets`
    (reference: cam_utils.py:685-700). centers [..., 3]."""
    forward = safe_normalize(centers - targets)
    up = np.asarray([0.0, 0.0, 1.0])
    right = safe_normalize(np.cross(forward, np.broadcast_to(up, forward.shape)))
    up_vec = safe_normalize(np.cross(right, forward) + up_noise)
    pose = np.tile(np.eye(4, dtype=np.float32), forward.shape[:-1] + (1, 1))
    pose[..., :3, :3] = np.stack([-right, up_vec, forward], axis=-1)
    pose[..., :3, 3] = centers
    return pose


def _pose_to_rt(pose: np.ndarray):
    """Reference's pose -> (R, T) plumbing (cam_utils.py:764-768)."""
    matrix = np.linalg.inv(pose)
    R = -np.transpose(matrix[:3, :3])
    R[:, 0] = -R[:, 0]
    T = -matrix[:3, 3]
    return R, T


def spherical_centers(radius, thetas_deg, phis_deg):
    t = np.deg2rad(np.asarray(thetas_deg, np.float64))
    p = np.deg2rad(np.asarray(phis_deg, np.float64))
    r = np.asarray(radius, np.float64)
    return np.stack(
        [r * np.sin(t) * np.sin(p), r * np.sin(t) * np.cos(p), r * np.cos(t)],
        axis=-1,
    )


def rand_poses(
    rng: np.random.Generator,
    opt,
    radius_range,
    theta_range,
    phi_range,
    uniform_sphere_rate=0.0,
    rand_cam_gamma=1.0,
):
    """Random spherical pose with jitter (reference: cam_utils.py:629-710).
    Returns (pose [4,4], theta_deg, phi_deg, radius)."""
    radius = gen_random_pos(rng, *radius_range)
    if rng.random() < uniform_sphere_rate:
        unit = np.array([rng.normal(), abs(rng.normal()), rng.normal()])
        unit = unit / np.linalg.norm(unit)
        theta = math.degrees(math.acos(unit[1]))
        phi = math.degrees(math.atan2(unit[0], unit[2]))
        if phi < 0:
            phi += 360
        centers = unit * radius
    else:
        theta = math.degrees(
            gen_random_pos(rng, *np.deg2rad(theta_range), rand_cam_gamma)
        )
        phi = math.degrees(gen_random_pos(rng, *np.deg2rad(phi_range), rand_cam_gamma))
        if phi < 0:
            phi += 360
        centers = spherical_centers(radius, theta, phi)

    targets = 0.0
    up_noise = 0.0
    if opt.jitter_pose:
        centers = centers + rng.random(3) * opt.jitter_center - opt.jitter_center / 2
        targets = rng.normal(size=3) * opt.jitter_target
        up_noise = rng.normal(size=3) * opt.jitter_up
    pose = _lookat_pose(centers, targets, up_noise)
    return pose, theta, phi, radius


def _make_camera(opt, pose, fovx, theta, phi, radius, ssaa=False) -> Camera:
    R, T = _pose_to_rt(pose)
    mul = opt.SSAA if ssaa else 1
    w, h = opt.image_w * mul, opt.image_h * mul
    fovy = focal2fov(fov2focal(fovx, h), w)
    d_azim = phi - opt.default_azimuth
    if d_azim > 180:
        d_azim -= 360
    return Camera(
        R=R.astype(np.float32),
        T=T.astype(np.float32),
        fovx=fovx,
        fovy=fovy,
        width=w,
        height=h,
        delta_polar=theta - opt.default_polar,
        delta_azimuth=d_azim,
        delta_radius=radius - opt.default_radius,
    )


def load_random_cam(rng, opt, ssaa=False) -> Camera:
    """reference: loadRandomCam (cam_utils.py:1732-1745), SSAA always on
    for the pose-gen resolution."""
    pose, theta, phi, radius = rand_poses(
        rng, opt, opt.radius_range, opt.theta_range, opt.phi_range,
        opt.uniform_sphere_rate, opt.rand_cam_gamma,
    )
    fov = rng.random() * (opt.fovy_range[1] - opt.fovy_range[0]) + opt.fovy_range[0]
    return _make_camera(opt, pose, fov, theta, phi, radius, ssaa=ssaa)


def _phi_range_for_dir(rng, opt, step_ratio, dirs):
    """reference: GenerateRandomCamerasAvoidMultiFace (cam_utils.py:712-743)."""
    if dirs == "random":
        if step_ratio < 0.1:
            rrc = rng.random()
            if rrc > 0.5:
                return [-30, 30]
            elif rrc > 0.75:
                return [-180, -150]
            else:
                return [150, 180]
        return opt.phi_range
    if dirs == "front":
        return [-32.5, 32.5]
    if dirs == "side":
        return [-147.5, -32.5] if rng.random() > 0.5 else [32.5, 147.5]
    if dirs == "back":
        return [-180, -147.5] if rng.random() > 0.5 else [147.5, 180]
    raise ValueError(dirs)


def load_random_cam_avoid_multiface(
    rng, opt, step_ratio: float, ssaa=False, size: int = 4
) -> List[Camera]:
    """Anti-multi-face curriculum: early steps lock the batch to one of
    front/back/side (reference: loadRandomCamAvoidMultiFace_4p,
    cam_utils.py:1747-1792)."""
    rcc = rng.random()
    if step_ratio < 0.1:
        dirs = "front" if rcc < 0.7 else "back"
    elif step_ratio < 0.7:
        dirs = "front" if rcc < 0.3 else ("back" if rcc < 0.6 else "side")
    else:
        dirs = "random"

    cams = []
    for _ in range(size):
        phi_range = _phi_range_for_dir(rng, opt, step_ratio, dirs)
        pose, theta, phi, radius = rand_poses(
            rng, opt, opt.radius_range, opt.theta_range, phi_range,
            opt.uniform_sphere_rate, opt.rand_cam_gamma,
        )
        fov = (
            rng.random() * (opt.fovy_range[1] - opt.fovy_range[0])
            + opt.fovy_range[0]
        )
        trans = (
            (0.0, 0.0, rng.random() * 0.5 - 0.2) if step_ratio > 0.7 else (0.0, 0.0, 0.0)
        )
        cam = _make_camera(opt, pose, fov, theta, phi, radius, ssaa=ssaa)
        cams.append(dataclasses.replace(cam, trans=trans))
    return cams
