"""Object-level camera pose sampling (host-side numpy).

Copy of dreamscene_tpu/cameras/sampling.py: random poses, the
anti-multi-face curriculum, the circle / clip / sphere / reco rigs and the
single camera (reference: utils/cam_utils.py:47-134, 229-310, 584-790,
1322-1535, 1732-1970). World convention: z-up; a pose is camera-to-world
with columns (-right, up, forward) and the camera placed on a sphere at
(theta: polar from +z, phi: azimuth measured from +y toward +x, i.e.
centers = r*(sin t sin p, sin t cos p, cos t)).

All randomness flows through an explicit numpy Generator for reproducible
runs (the reference seeds global `random`/torch, SURVEY.md §4 determinism).
"""

from __future__ import annotations

import dataclasses
import math
from typing import List

import numpy as np

from dreamscene_tpu_torch.cameras.camera import Camera, focal2fov, fov2focal

DIR_NAMES = ["front", "side", "back", "side", "overhead", "bottom", "zoom in"]


def safe_normalize(v, eps=1e-20):
    return v / np.sqrt(np.maximum(np.sum(v * v, axis=-1, keepdims=True), eps))


def get_dir_ind(theta_deg: float, phi_deg: float, radius: float,
                overhead_threshold: float = 30.0, front_threshold: float = 75.0,
                zoom_in_thresh: float = 1.1) -> str:
    """View-direction bucket for view-dependent prompts (reference:
    cam_utils.py:47-134, default branch). theta/phi are deltas against
    the default view: theta in [-90,90], phi in [-180,180]."""
    t = math.radians(theta_deg + 90.0)
    p = math.radians(phi_deg + 180.0)
    ot = math.radians(overhead_threshold)
    ft = math.radians(front_threshold)
    res = 0
    if (p >= 2 * math.pi - ft / 2) or (p < ft / 2):
        res = 0
    if ft / 2 <= p < math.pi - ft / 2:
        res = 1
    if math.pi - ft / 2 <= p < math.pi + ft / 2:
        res = 2
    if math.pi + ft / 2 <= p < 2 * math.pi - ft / 2:
        res = 3
    if t <= ot:
        res = 4
    if t >= math.pi - ot:
        res = 5
    if radius <= zoom_in_thresh:
        res = 6
    return DIR_NAMES[res]


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


def circle_poses(radius, theta_deg, phi_deg):
    """reference: cam_utils.py:277-309."""
    return _lookat_pose(spherical_centers(radius, theta_deg, phi_deg))


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


def load_circle_cam(opt, size=120, render45=True) -> List[Camera]:
    """Orbit rig at the default polar angle (+ an optional 45-degree ring)
    (reference: GenerateCircleCameras/loadCircleCam,
    cam_utils.py:1455-1535, 1838-1858)."""
    cams = []
    rings = [opt.default_polar] + ([opt.default_polar * 2 // 3] if render45 else [])
    for theta in rings:
        for idx in range(size):
            phi = idx / size * 360.0
            pose = circle_poses(opt.default_radius, theta, phi)
            cams.append(_make_camera(opt, pose, opt.default_fovy, theta, phi,
                                     opt.default_radius))
    return cams


def load_clip_cam(opt, angles=(75, 90), size=120, clip_radius=4.0) -> List[Camera]:
    """reference: GenerateClipCameras/loadClipCam (cam_utils.py:1411-1453,
    1815-1836)."""
    cams = []
    for ang in angles:
        for idx in range(size):
            phi = idx / size * 360.0
            pose = circle_poses(clip_radius, ang, phi)
            cams.append(_make_camera(opt, pose, opt.default_fovy, ang, phi, clip_radius))
    return cams


def load_sphere_cam(rng, opt, size=48) -> List[Camera]:
    """Random directions on the default-radius sphere, for the importance
    scoring pass (reference: sphere_poses/loadSphereCam,
    cam_utils.py:1322-1336, 1860-1880)."""
    cams = []
    for _ in range(size):
        c = rng.normal(size=3)
        c = c / np.linalg.norm(c) * opt.default_radius
        cams.append(_make_camera(opt, _lookat_pose(c), opt.default_fovy, 0.0, 0.0,
                                 opt.default_radius))
    return cams


def load_reco_cam(opt, circle_size=(4, 12, 14, 6), thetas=(100, 85, 75, 55),
                  scale=1.0) -> List[Camera]:
    """Fixed multi-ring rig of the refine phase (reference:
    GenerateRecoCameras/loadRecoCam, cam_utils.py:1369-1409, 1882-1892;
    layout from training/object_trainer.py:476)."""
    cams = []
    radius = opt.default_radius * scale
    for theta, n in zip(thetas, circle_size):
        for idx in range(n):
            phi = idx / n * 360.0
            pose = circle_poses(radius, theta, phi)
            cams.append(_make_camera(opt, pose, opt.default_fovy, theta, phi, radius))
    return cams


def load_single_cam(opt, camera_center=(0, 0, 0), object_center=(1, 0, 0),
                    theta=90.0, radius=3.5, fov=0.96, img_w=1920, img_h=1080) -> Camera:
    """reference: GenSingleCam/loadSingleCam (cam_utils.py:1894-1970)."""
    oc, cc = np.asarray(object_center, np.float64), np.asarray(camera_center, np.float64)
    phi = math.degrees(math.atan2(oc[0] - cc[0], oc[1] - cc[1])) + 180.0
    pose = circle_poses(radius, theta, phi)
    R, T = _pose_to_rt(pose)
    fovy = focal2fov(fov2focal(fov, img_h), img_w)
    d_azim = phi - opt.default_azimuth
    if d_azim > 180:
        d_azim -= 360
    return Camera(
        R=R.astype(np.float32), T=T.astype(np.float32), fovx=fov, fovy=fovy,
        width=img_w, height=img_h,
        delta_polar=theta - opt.default_polar, delta_azimuth=d_azim,
        delta_radius=radius - opt.default_radius, trans=tuple(cc),
    )
