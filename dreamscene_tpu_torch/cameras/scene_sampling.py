"""Scene-level camera sampling: stage curricula + inference paths.

Own copy of dreamscene_tpu/cameras/scene_sampling.py (numpy only, same
draws in the same order from the caller's generator), the numpy
re-implementation of the reference's scene camera machinery
(reference: utils/cam_utils.py:311-582 scene_poses/gen_random_delta,
840-1320 GenerateCamerasScene{Outdoor1-4, Indoor1-2}, 1537-1730 in-scene
circle rigs, 1972-2688 SceneCameraLoader).

Scene cameras live in *delta space*: poses are generated relative to an
anchor `trans` with a multiplier `scale` (negative scale mirrors the view
through the anchor), and the Camera carries (trans, scale) so its
world-to-view transform re-centers via get_world2view — exactly the
reference's getWorld2View2(R, T, trans, scale) convention.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from dreamscene_tpu_torch.cameras.camera import Camera, focal2fov, fov2focal
from dreamscene_tpu_torch.cameras.sampling import (
    _lookat_pose,
    _pose_to_rt,
    gen_random_pos,
    spherical_centers,
)


def sample_jit(rng, phi, jit_size, range_max, range_size, islist=False):
    """reference: cam_utils.py:220-228."""
    if islist:
        return [sample_jit(rng, p, jit_size, range_max, range_size) for p in phi]
    phi = phi + jit_size * rng.random()
    if phi > range_max:
        phi -= range_size
    return phi


def calc_radius(bbox, dim=2, sqrt=False):
    """reference: cam_utils.py:241-254."""
    bbox = np.asarray(bbox, np.float64)
    if dim == 2:
        if sqrt:
            return float(np.sqrt(np.sum(np.maximum(bbox[:2], bbox[3:5]) ** 2)))
        return float(np.min(np.abs(np.concatenate([bbox[0:2], bbox[3:5]]))))
    if dim == 3 and sqrt:
        return float(np.sqrt(np.sum(np.maximum(bbox[:3], bbox[3:]) ** 2)))
    raise KeyError


def distance_point_to_aabb(point, min_point, max_point):
    """2D in-plane distance to the box walls (reference:
    cam_utils.py:256-276)."""
    p = np.asarray(point, np.float64).reshape(-1)[:2]
    t = np.minimum(np.asarray(max_point)[:2] - p, p - np.asarray(min_point)[:2])
    return float(np.min(t))


def viewpoint_in_scene(center, scene_box, objects_args, object_collision=False):
    """0 = outside box, 1 = ok, 2 = inside an object bbox (reference:
    cam_utils.py:311-324)."""
    c = np.asarray(center, np.float64).reshape(-1)
    sb = np.asarray(scene_box, np.float64)
    if np.all(c > sb[:3]) and np.all(sb[3:] > c):
        if object_collision:
            for oa in objects_args:
                ob = np.asarray(oa.bbox, np.float64)
                if np.all(c > ob[:3]) and np.all(ob[3:] > c):
                    return 2
        return 1
    return 0


def gen_random_delta(
    rng, trans, scale, theta_range, phi_range, radius_range, scene_box,
    uniform_sphere_rate, rand_cam_gamma, objects_args, cam_pose_method,
    get_cam_outview=False, colli=True, radius_trans_max=3.0,
):
    """AABB-contained pose sampling with scale-annealed retry (reference:
    cam_utils.py:326-489). Raises after scale drifts out of [0.3, 3]."""
    while True:
        radius = gen_random_pos(rng, *radius_range)
        if rng.random() < uniform_sphere_rate:
            unit = np.array([rng.normal(), abs(rng.normal()), rng.normal()])
            unit = unit / np.linalg.norm(unit)
            thetas = math.acos(unit[1])
            phis = math.atan2(unit[0], unit[2])
            if phis < 0:
                phis += 2 * math.pi
            centers_delta = unit * radius
        else:
            thetas = gen_random_pos(rng, *theta_range, rand_cam_gamma)
            phis = gen_random_pos(rng, *phi_range, rand_cam_gamma)
            if phis < 0:
                phis += 2 * math.pi
            centers_delta = np.array(
                [
                    radius * math.sin(thetas) * math.sin(phis),
                    radius * math.sin(thetas) * math.cos(phis),
                    radius * math.cos(thetas),
                ]
            )
        targets = np.asarray(trans, np.float64).copy()
        if get_cam_outview:
            cd = centers_delta.copy()
            cd[:2] *= -1
            centers = cd * scale + targets
        else:
            centers = centers_delta * scale + targets

        check = viewpoint_in_scene(centers, scene_box, objects_args, colli)
        if check == 1 or cam_pose_method not in ("indoor", "outdoor"):
            return centers, targets, centers_delta, phis, thetas, radius, scale
        if (check == 2 and distance_point_to_aabb(
                centers, scene_box[:3], scene_box[3:]) < radius_trans_max * 0.75
                and cam_pose_method == "indoor"):
            factor = 1.02
        else:
            factor = 0.98
        if abs(scale) > 3 or abs(scale) < 0.3:
            raise RuntimeError(
                f"camera-scale recursion diverged (scale={scale})"
            )
        scale = scale * factor


def scene_poses(
    rng, opt, trans, scale, scene_box, objects_args, cam_pose_method,
    radius_range, theta_range, phi_range, uniform_sphere_rate=0.0,
    rand_cam_gamma=1.0, get_cam_outview_ratio=0.0, colli=True,
):
    """reference: cam_utils.py:491-582. Returns (pose, theta_deg, phi_deg,
    radius, scale)."""
    theta_range = list(np.deg2rad(theta_range))
    phi_range = list(np.deg2rad(phi_range))
    get_cam_outview = rng.random() < get_cam_outview_ratio
    radius_range = list(radius_range)
    if get_cam_outview:
        factor = 1.3
        radius_range[1] = min(radius_range[1], 3.0)
        radius_range[0] = min(radius_range[1], radius_range[0])
    else:
        factor = 0.8
        radius_range[0] = max(radius_range[0], 3.0)
        radius_range[1] = max(radius_range[0], radius_range[1])
    radius_range = [r * factor for r in radius_range]
    radius_trans_max = min(
        abs(scene_box[0]), abs(scene_box[1]), scene_box[3], scene_box[4]
    )
    centers, targets, centers_delta, phis, thetas, radius, scale = gen_random_delta(
        rng, trans, scale, theta_range, phi_range, radius_range, scene_box,
        uniform_sphere_rate, rand_cam_gamma, objects_args, cam_pose_method,
        get_cam_outview, colli, radius_trans_max,
    )

    targets_j = 0.0
    up_noise = 0.0
    if opt.jitter_pose:
        centers_delta = centers_delta + (
            rng.random(3) * opt.jitter_center - opt.jitter_center / 2
        )
        targets_j = rng.normal(size=3) * opt.jitter_target
        up_noise = rng.normal(size=3) * opt.jitter_up

    pose = _lookat_pose(centers_delta, targets_j, up_noise)
    pose[:3, 3] = centers_delta
    if get_cam_outview:
        pose[:2, 3] *= -1
    return pose, math.degrees(thetas), math.degrees(phis), radius, scale


@dataclasses.dataclass
class _StageSpec:
    radius_range: tuple
    theta_range: tuple
    fov: float | None          # None -> sample from opt.fovy_range
    outview_ratio: float = 0.0
    colli: bool = True


def _scene_cam(opt, pose, fov, theta, phi, radius, trans, scale, ssaa=True):
    R, T = _pose_to_rt(pose)
    mul = opt.SSAA if ssaa else 1
    w, h = opt.image_w * mul, opt.image_h * mul
    fovy = focal2fov(fov2focal(fov, h), w)
    d_azim = phi - opt.default_azimuth
    if d_azim > 180:
        d_azim -= 360
    return Camera(
        R=R.astype(np.float32), T=T.astype(np.float32), fovx=fov, fovy=fovy,
        width=w, height=h, delta_polar=theta - opt.default_polar,
        delta_azimuth=d_azim, delta_radius=radius - opt.default_radius,
        trans=tuple(np.asarray(trans, np.float64)), scale=float(scale),
    )


class SceneCameraLoader:
    """Stage camera curricula (reference: cam_utils.py:1972-2688)."""

    def __init__(self, rng: np.random.Generator, opt, scene_box, objects_args,
                 cam_pose_method):
        self.rng = rng
        self.opt = opt
        self.s_box = np.asarray(scene_box, np.float64)
        self.o_args = objects_args
        self.c_method = cam_pose_method

    # -- generic factory wrapping scene_poses ---------------------------
    def _gen(self, trans, scale, spec: _StageSpec, phi_range, ssaa=True):
        fov = spec.fov
        if fov is None:
            fov = (
                self.rng.random() * (self.opt.fovy_range[1] - self.opt.fovy_range[0])
                + self.opt.fovy_range[0]
            )
        pose, theta, phi, radius, scale = scene_poses(
            self.rng, self.opt, trans, scale, self.s_box, self.o_args,
            self.c_method, spec.radius_range, spec.theta_range, phi_range,
            uniform_sphere_rate=self.opt.uniform_sphere_rate,
            rand_cam_gamma=self.opt.rand_cam_gamma,
            get_cam_outview_ratio=spec.outview_ratio, colli=spec.colli,
        )
        return _scene_cam(self.opt, pose, fov, theta, phi, radius, trans,
                          scale, ssaa)

    # -- Stage 1 --------------------------------------------------------
    def Stage1_Outdoor(self):
        """Center ring, 12 jittered directions (cam_utils.py:1980-2022)."""
        trans = np.array(
            [0, 0, (self.s_box[5] + self.s_box[2]) / 2 + self.rng.random() - 0.5]
        )
        spec = _StageSpec((0.1, 0.5), (80, 110), 0.96, outview_ratio=0.5,
                          colli=False)
        cams = []
        size = 12
        for idx in range(size):
            pr = sample_jit(self.rng, [idx / size * 360] * 2, 360 / size, 360,
                            360, True)
            cams.append(self._gen(trans, 1.0, spec, pr))
        return cams

    def _outdoor_translated(self, spec_fn, z_fn):
        """Shared body of Stage1_Outdoor2/Stage2_Outdoor: 4 positions along
        a random diameter, the near two mirrored via scale=-1
        (cam_utils.py:2024-2190)."""
        cams = []
        trans_phi_d = self.rng.random() * 360 - 180
        trans_phi = math.radians(trans_phi_d)
        if trans_phi < 0:
            trans_phi += 2 * math.pi
        rmax = min(abs(self.s_box[0]), abs(self.s_box[1]), self.s_box[3],
                   self.s_box[4])
        fracs = [-0.5, -0.25, 0.25, 0.5]
        for i, f in enumerate(fracs):
            r = f * rmax + self.rng.random() * rmax / 10 - rmax / 20
            trans = np.array(
                [r * math.sin(trans_phi), r * math.cos(trans_phi), z_fn()]
            )
            scale = -1.0 if i <= 1 else 1.0
            cams.append(
                self._gen(trans, scale, spec_fn(scale),
                          [trans_phi_d, trans_phi_d])
            )
        return cams

    def Stage1_Outdoor2(self):
        def spec(scale):
            return _StageSpec((0.1, 1.1), (70, 100), 0.96, colli=False)

        z = lambda: (self.s_box[5] + self.s_box[2]) / 2 + self.rng.random() - 0.5
        return self._outdoor_translated(spec, z)

    def Stage2_Outdoor(self):
        def spec(scale):
            theta = (90, 90) if scale > 0 else (85, 95)
            return _StageSpec((0.1, 0.3), theta,
                              self.rng.random() * 0.48 + 0.96, colli=False)

        z = lambda: (self.s_box[5] + self.s_box[2]) * 2 / 3
        return self._outdoor_translated(spec, z)

    def Stage3_Outdoor(self, opti_target="env"):
        """16-direction rig at two polar angles per target
        (cam_utils.py:2192-2276)."""
        cams = []
        size = 16
        rmax = min(abs(self.s_box[0]), abs(self.s_box[1]), self.s_box[3],
                   self.s_box[4])
        theta_of = {"env": 95, "env2": 110, "floor": 70, "floor2": 55}
        for idx in range(size):
            trans_phi_d = idx / size * 360 - 180
            trans_phi = math.radians(trans_phi_d)
            if trans_phi < 0:
                trans_phi += 2 * math.pi
            if opti_target == "env":
                r = -rmax / 4
                z = (self.s_box[5] + self.s_box[2]) / 2
            else:
                r = -rmax * 2 / 3
                z = self.s_box[5]
            trans = np.array(
                [r * math.sin(trans_phi), r * math.cos(trans_phi), z]
            )
            for tgt in (opti_target, opti_target + "2"):
                fov = 1.2 if "floor" in tgt else 0.96
                spec = _StageSpec((0.5, 0.5), (theta_of[tgt], theta_of[tgt]),
                                  fov, colli=False)
                cams.append(
                    self._gen(trans, -1.0, spec, [trans_phi_d, trans_phi_d])
                )
        return cams

    def Stage1_Indoor(self, size=8, view_floor=False):
        """Wall ring (cam_utils.py:2278-2327)."""
        trans = np.array(
            [0, 0, (self.s_box[5] + self.s_box[2]) / 2 + self.rng.random() - 0.5]
        )
        rmax = min(abs(self.s_box[0]), abs(self.s_box[1]), self.s_box[3],
                   self.s_box[4])
        theta = (45, 90) if view_floor else (75, 115)
        spec = _StageSpec((rmax * 0.75, rmax * 1.1), theta, 0.96)
        cams = []
        for idx in range(size):
            try:
                pr = sample_jit(self.rng, [idx / size * 360] * 2, 360 / size,
                                360, 360, True)
                cams.append(self._gen(trans, 1.0, spec, pr))
            except RuntimeError:
                pass  # camera sampling failure (reference logs + continues)
        return cams

    def Stage2_Indoor(self, affine_params=None, idx=0, size=8):
        """Object-centric or room-interior ring (cam_utils.py:2329-2417)."""
        cams = []
        rmax = min(abs(self.s_box[0]), abs(self.s_box[1]), self.s_box[3],
                   self.s_box[4])
        if affine_params is not None:
            s = np.asarray(affine_params["S"], np.float64).reshape(-1)
            diff_z = (s[2] if s.size == 3 else s[0]) / 2 + self.rng.random() - 0.5
            trans = np.asarray(affine_params["T"], np.float64) + np.array(
                [0, 0, diff_z]
            )
            scale = float(np.clip(s[0], 0.75, 1.5))
            max_radius = distance_point_to_aabb(trans, self.s_box[:3],
                                                self.s_box[3:])
            spec = _StageSpec((3.0, max(max_radius, 3.0)), (60, 110), 0.96)
            for _ in range(8):
                cams.append(self._gen(trans, scale, spec, self.opt.phi_range))
        else:
            trans_phi_d = idx / size * 360 - 180
            trans_phi_d = sample_jit(self.rng, trans_phi_d, 360 / size, 180, 360)
            trans_phi = math.radians(trans_phi_d)
            if trans_phi < 0:
                trans_phi += 2 * math.pi
            r = rmax / 3
            trans = np.array(
                [
                    r * math.sin(trans_phi),
                    r * math.cos(trans_phi),
                    (self.s_box[5] + self.s_box[2]) / 2
                    + self.rng.random() * 2 - 1,
                ]
            )
            spec = _StageSpec((0.1, 1.0), (60, 110), 0.96)
            pr = [trans_phi_d + 180 - 60, trans_phi_d + 180 + 60]
            for _ in range(8):
                cams.append(self._gen(trans, 1.0, spec, pr))
        return cams

    # -- inference paths -------------------------------------------------
    def _circle_in_scene(self, trans, trans_45, scale, size, render45,
                         is_object, start_phi=0.0, end_phi=None,
                         mode="default"):
        """cam_utils.py:1537-1660."""
        opt = self.opt
        if mode == "default":
            fov = opt.default_fovy
            radius = (
                opt.default_radius if is_object else calc_radius(self.s_box) - 0.01
            )
        else:  # nearby
            fov = 0.96
            radius = 0.1
            if end_phi is not None and end_phi < start_phi:
                end_phi += 360
        cams = []
        for idx in range(size):
            theta = opt.default_polar
            phi = (idx / size * 360 + start_phi)
            if mode == "nearby" and end_phi is not None and phi > end_phi:
                break
            phi %= 360
            cam = self._circle_cam(trans, scale, radius, theta, phi, fov)
            if cam is not None:
                cams.append(cam)
        if render45:
            theta45 = opt.default_polar * 2 // 3
            r45 = radius / math.sin(math.radians(theta45))
            for idx in range(size):
                phi = (idx / size * 360 + start_phi) % 360
                cam = self._circle_cam(trans_45, scale, r45, theta45, phi, fov)
                if cam is not None:
                    cams.append(cam)
        return cams

    def _circle_cam(self, trans, scale, radius, theta, phi, fov):
        """scene_circle_poses + in-scene check (cam_utils.py:584-627)."""
        delta = spherical_centers(radius, theta, phi)
        center = delta * scale + np.asarray(trans, np.float64)
        if viewpoint_in_scene(center, self.s_box, self.o_args, True) != 1:
            return None
        pose = _lookat_pose(delta)
        return _scene_cam(self.opt, pose, fov, theta, phi, radius, trans,
                          scale, ssaa=False)

    def _affine_circle_params(self, affine_params, use_diffz=True):
        if affine_params is None:
            trans = np.array([0, 0, (self.s_box[5] + self.s_box[2]) / 2])
            trans_45 = np.array([0, 0, self.s_box[2]])
            return trans, trans_45, 1.0, False
        s = np.asarray(affine_params["S"], np.float64).reshape(-1)
        diff_z = (s[2] if s.size == 3 else s[0]) / 2
        trans_45 = np.asarray(affine_params["T"], np.float64)
        trans = trans_45 + (np.array([0, 0, diff_z]) if use_diffz else 0.0)
        return trans, trans_45, float(np.clip(s[0], 0.75, 1.5)), True

    def Circle(self, affine_params=None, circle_size=120, render45=True):
        trans, trans_45, scale, is_object = self._affine_circle_params(
            affine_params
        )
        cams = []
        while len(cams) < circle_size // 2:
            scale *= 0.98
            cams = self._circle_in_scene(trans, trans_45, scale, circle_size,
                                         render45, is_object)
        return cams

    def Circle2(self, start_phi=0.0, end_phi=None, affine_params=None,
                circle_size=120, render45=True):
        trans, trans_45, scale, is_object = self._affine_circle_params(
            affine_params, use_diffz=False
        )
        return self._circle_in_scene(
            trans, trans_45, scale, circle_size, render45, is_object,
            start_phi, end_phi, mode="nearby",
        )

    def Circle3(self, affine_params=None, circle_size=120, render45=True):
        trans, trans_45, scale, is_object = self._affine_circle_params(
            affine_params
        )
        if affine_params is None and self.c_method == "indoor":
            trans_45 = np.array([0, 0, (self.s_box[5] + self.s_box[2]) / 3])
        cams = []
        while len(cams) < circle_size // 2:
            scale *= 0.98
            cams = self._circle_in_scene(trans, trans_45, scale, circle_size,
                                         False, is_object)
        cams45 = []
        scale_45 = 1.2
        if render45:
            theta45 = self.opt.default_polar * 2 // 3
            radius = (
                self.opt.default_radius if is_object
                else calc_radius(self.s_box) - 0.01
            ) / math.sin(math.radians(theta45))
            while len(cams45) < circle_size // 2:
                scale_45 *= 0.98
                cams45 = [
                    c for c in (
                        self._circle_cam(
                            trans_45, scale_45, radius, theta45,
                            (i / circle_size * 360) % 360,
                            self.opt.default_fovy,
                        )
                        for i in range(circle_size)
                    ) if c is not None
                ]
        return cams + cams45

    def Line(self, start, stop, step_size=0.1, img_h=512, img_w=512):
        """Linear walkthrough (cam_utils.py:2419-2477)."""
        p0 = np.asarray(start, np.float64)
        p1 = np.asarray(stop, np.float64)
        num = max(int(np.linalg.norm(p1 - p0) / step_size), 1)
        phi = math.degrees(math.atan2(p1[0] - p0[0], p1[1] - p0[1])) + 180
        cams = []
        opt = self.opt
        for i in range(num):
            t = i / max(num - 1, 1)
            trans = p0 * (1 - t) + p1 * t
            delta = spherical_centers(1.0, 90.0, phi)
            pose = _lookat_pose(delta)
            cam = _scene_cam(opt, pose, 0.96, 90.0, phi, 1.0, trans, 1.0,
                             ssaa=False)
            cam = dataclasses.replace(cam, width=img_w, height=img_h)
            cams.append(cam)
        return cams
