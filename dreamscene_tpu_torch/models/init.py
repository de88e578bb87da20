"""Point-cloud initializers for objects, environments and floors
(host-side numpy), port of dreamscene_tpu/models/init.py (reference
gs_renderer.py:218-426):

  * object `default`: uniform ball via radius*cbrt(u) (gs_renderer.py:355-372);
  * object `pointe*`: point-e's text-to-cloud (utils/pointe.py), each point
    spread over a jitter ball (gs_renderer.py:380-414); the ball init when
    point-e or its weights are absent, as in the JAX package;
  * object `shapes`: area-weighted surface samples of a local OBJ mesh with
    the reference's axis swap, centring and /80 scaling
    (gs_renderer.py:334-349);
  * env indoor: 5 box-shell faces x 400K points; outdoor: a thick sphere
    shell, optionally the upper hemisphere (gs_renderer.py:218-277);
  * floor indoor / outdoor: a jittered plane / disk (gs_renderer.py:279-321).

Same numpy RandomState streams, drawn in the same order, as the JAX
package, so the same points come out for the same seed, bit for bit.
`default`, `shapes` and point-e clouds are cached as
"<md5(model-prompt)>_init_points3d.ply" in the experiment directory and
read back from there when present, as the JAX package does.
"""

from __future__ import annotations

import hashlib
import logging
import os

import numpy as np

from dreamscene_tpu_torch.models.ply import fetch_point_ply, store_point_ply
from dreamscene_tpu_torch.ops.sh import SH2RGB

logger = logging.getLogger("dreamscene_tpu_torch")


def hash_prompt(model: str, pos_prompt: str, neg_prompt: str = "") -> str:
    return hashlib.md5(f"{model}-{pos_prompt}-{neg_prompt}".encode()).hexdigest()


def sample_ball(num_pts: int, radius: float, rng: np.random.RandomState):
    phis = rng.random(num_pts) * 2 * np.pi
    costheta = rng.random(num_pts) * 2 - 1
    thetas = np.arccos(costheta)
    r = radius * np.cbrt(rng.random(num_pts))
    x = r * np.sin(thetas) * np.cos(phis)
    y = r * np.sin(thetas) * np.sin(phis)
    z = r * np.cos(thetas)
    return np.stack([x, y, z], axis=1)


def sample_mesh_surface(path: str, num_pts: int, rng: np.random.RandomState):
    """Uniform (area-weighted) surface samples of an OBJ mesh."""
    verts, faces = _load_mesh(path)
    v0, v1, v2 = verts[faces[:, 0]], verts[faces[:, 1]], verts[faces[:, 2]]
    areas = 0.5 * np.linalg.norm(np.cross(v1 - v0, v2 - v0), axis=1)
    idx = rng.choice(len(faces), size=num_pts, p=areas / areas.sum())
    u, v = rng.random(num_pts), rng.random(num_pts)
    flip = u + v > 1
    u[flip], v[flip] = 1 - u[flip], 1 - v[flip]
    pts = v0[idx] + u[:, None] * (v1[idx] - v0[idx]) + v[:, None] * (v2[idx] - v0[idx])
    return pts.astype(np.float32)


def _load_mesh(path: str):
    """Vertices and fan-triangulated faces of an OBJ file's `v` / `f` lines."""
    verts, faces = [], []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "v":
                verts.append([float(x) for x in parts[1:4]])
            elif parts[0] == "f":
                ids = [int(p.split("/")[0]) - 1 for p in parts[1:]]
                for i in range(1, len(ids) - 1):
                    faces.append([ids[0], ids[i], ids[i + 1]])
    return np.asarray(verts, np.float32), np.asarray(faces, np.int64)


def init_object_points(init_guided: str, init_prompt: str, exp_path: str,
                       num_pts: int = 20000, radius: float = 0.5,
                       use_pointe_rgb: bool = False, seed: int = 0, device="cpu"):
    """Returns (points [N,3], colors [N,3] in [0,1], spatial_lr_scale).
    `device` is where point-e runs for the `pointe*` inits."""
    rng = np.random.RandomState(seed)
    ply_path = os.path.join(exp_path, hash_prompt(init_guided, init_prompt)
                            + "_init_points3d.ply")
    if os.path.exists(ply_path):
        pts, rgb = fetch_point_ply(ply_path)
        return pts, rgb, 10.0 if init_guided == "default" else 1.0
    if init_guided.startswith("pointe"):
        base = _try_pointe(init_prompt, init_guided, device)
        if base is not None:
            xyz, rgb = _spread_pointe_cloud(*base, rng, use_pointe_rgb)
            store_point_ply(ply_path, xyz, rgb * 255)
            return xyz.astype(np.float32), rgb.astype(np.float32), 1.0
        logger.warning("point-e unavailable and no cached init cloud at %s; "
                       "falling back to ball init", ply_path)
    if init_guided == "default" or init_guided.startswith("pointe"):
        xyz = sample_ball(num_pts, radius, rng)
        rgb = SH2RGB(rng.random((num_pts, 3)) / 255.0)
        if init_guided == "default":       # the fallback ball is not cached
            store_point_ply(ply_path, xyz, rgb * 255)
        sls = 10.0 if init_guided == "default" else 1.0
        return xyz.astype(np.float32), rgb.astype(np.float32), sls
    if init_guided == "shapes":
        n = 50000
        coords = sample_mesh_surface(init_prompt, n, rng)
        adj = np.zeros_like(coords)
        adj[:, 0] = coords[:, 0]
        adj[:, 1] = coords[:, 2]
        adj[:, 2] = coords[:, 1]
        adj -= adj.mean(axis=0)
        adj /= 80.0
        rgb = SH2RGB(rng.random((n, 3)) / 255.0)
        store_point_ply(ply_path, adj, rgb * 255)
        return adj.astype(np.float32), rgb.astype(np.float32), 1.0
    raise ValueError(f"unknown init_guided: {init_guided}")


def _spread_pointe_cloud(xyz0, rgb0, rng: np.random.RandomState, use_pointe_rgb: bool):
    """point-e's [4096, 3] cloud with y flipped and z lifted by 0.15, each
    point spread over the same 20 jitter-ball offsets; its own colours
    (plus 1e-4 noise) or random ones (gs_renderer.py:380-414)."""
    xyz0 = xyz0.copy()
    xyz0[:, 1] = -xyz0[:, 1]
    xyz0[:, 2] = xyz0[:, 2] + 0.15
    n_ball = 20                           # 100000 // 5000
    thetas = rng.rand(n_ball) * np.pi
    phis = rng.rand(n_ball) * 2 * np.pi
    r = rng.rand(n_ball) * 0.05
    ball = np.stack([r * np.sin(thetas) * np.sin(phis),
                     r * np.sin(thetas) * np.cos(phis),
                     r * np.cos(thetas)], axis=-1)
    xyz = (xyz0[:, None, :] + ball[None, :, :]).reshape(-1, 3)
    if use_pointe_rgb:
        rgb = (rgb0[:, None, :] + rng.random((4096, n_ball, 3)) * 1e-4).reshape(-1, 3)
    else:
        rgb = SH2RGB(rng.random((xyz.shape[0], 3)) / 255.0)
    return xyz, rgb


def _try_pointe(prompt: str, variant: str, device):
    """point-e's text-to-cloud (utils/pointe.py): (xyz [4096,3], rgb
    [4096,3]), or None when point-e or its weights are unavailable; the
    warning names what failed."""
    try:
        from dreamscene_tpu_torch.utils.pointe import init_from_pointe

        return init_from_pointe(prompt, variant, device)
    except Exception as e:     # the JAX package also takes any failure as "unavailable"
        logger.warning("point-e init failed: %s: %s", type(e).__name__, e)
        return None


def init_env_points(cam_pose_method: str, scene_box: np.ndarray,
                    env_init_color=(255, 255, 255), zero_ground: bool = False,
                    seed: int = 0, density: float = 1.0):
    """Environment shell cloud; density < 1 scales the point counts down."""
    rng = np.random.RandomState(seed)
    if cam_pose_method == "indoor":
        num_pts = int(400000 * density)
        sb = np.asarray(scene_box, np.float64)
        lo = np.tile(sb[:3], (num_pts, 1)) - rng.random((num_pts, 3)) / 50.0
        hi = np.tile(sb[3:], (num_pts, 1)) + rng.random((num_pts, 3)) / 50.0
        xs = rng.random(num_pts) * (sb[3] - sb[0]) + sb[0]
        ys = rng.random(num_pts) * (sb[4] - sb[1]) + sb[1]
        zs = rng.random(num_pts) * (sb[5] - sb[2]) + sb[2]
        xyz = np.concatenate([
            np.stack([lo[:, 0], ys, zs], axis=1),   # x-min wall
            np.stack([hi[:, 0], ys, zs], axis=1),   # x-max wall
            np.stack([xs, lo[:, 1], zs], axis=1),   # y-min wall
            np.stack([xs, hi[:, 1], zs], axis=1),   # y-max wall
            np.stack([xs, ys, hi[:, 2]], axis=1),   # ceiling
        ], axis=0)
        colors = np.concatenate([np.full((num_pts, 3), c) for c in (0.5, 0.5, 0.7, 0.7, 0.9)],
                                axis=0)
        return xyz.astype(np.float32), colors.astype(np.float32)
    if cam_pose_method == "outdoor":
        sb = np.abs(np.asarray(scene_box, np.float64))
        radius_base = np.sqrt(np.sum(np.maximum(sb[:3], sb[3:]) ** 2))
        num_pts = int(np.ceil(radius_base * 50000 * density))
        phis = rng.random(num_pts) * 2 * np.pi
        costheta = rng.random(num_pts) if zero_ground else rng.random(num_pts) * 2 - 1
        thetas = np.arccos(costheta)
        radius = radius_base * np.cbrt(rng.random(num_pts) / 10 + 0.95)
        xyz = np.stack([radius * np.sin(thetas) * np.cos(phis),
                        radius * np.sin(thetas) * np.sin(phis),
                        radius * np.cos(thetas)], axis=1)
        colors = np.minimum(np.asarray(env_init_color, np.float64) / 255.0, 1.0)
        return xyz.astype(np.float32), np.tile(colors, (num_pts, 1)).astype(np.float32)
    raise ValueError(f"unknown cam_pose_method: {cam_pose_method}")


def init_floor_points(cam_pose_method: str, scene_box: np.ndarray,
                      floor_init_color=(255, 255, 255), zero_ground: bool = True,
                      seed: int = 0, density: float = 1.0):
    """Floor cloud: a jittered plane (indoor) or disk (outdoor)."""
    rng = np.random.RandomState(seed)
    if cam_pose_method == "indoor":
        num_pts = int(300000 * density)
        sb = np.asarray(scene_box, np.float64)
        boxs = np.tile(sb, (num_pts, 1)) + (rng.random((num_pts, 6)) / 50.0 - 0.01)
        xs = rng.random(num_pts) * (sb[3] - sb[0]) + sb[0]
        ys = rng.random(num_pts) * (sb[4] - sb[1]) + sb[1]
        xyz = np.stack([xs, ys, boxs[:, 2]], axis=1)
    elif cam_pose_method == "outdoor":
        sb = np.abs(np.asarray(scene_box, np.float64))
        radius_base = np.sqrt(np.sum(np.maximum(sb[:3], sb[3:]) ** 2))
        num_pts = int(np.ceil(radius_base * 20000 * density))
        r = radius_base * np.sqrt(rng.random(num_pts))
        phis = rng.random(num_pts) * 2 * np.pi
        z = rng.random(num_pts) / 10.0 - 0.1 + np.asarray(scene_box)[2]
        xyz = np.stack([r * np.cos(phis), r * np.sin(phis), z], axis=1)
    else:
        raise ValueError(f"unknown cam_pose_method: {cam_pose_method}")
    colors = np.minimum(np.asarray(floor_init_color, np.float64) / 255.0, 1.0)
    return xyz.astype(np.float32), np.tile(colors, (num_pts, 1)).astype(np.float32)
