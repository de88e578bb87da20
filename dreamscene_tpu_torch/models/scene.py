"""Scene composition: object placement, env/floor models, registry, combine.

Port of dreamscene_tpu/models/scene.py (reference SceneGaussian,
scene_gaussian.py:24-544). Each placed object instance, the environment
shell and the floor are independent fixed-capacity GaussianStates; a scene
render concatenates them (rendering.scene_render, training/scene_trainer)
and the gradients come back per model.

Placement (reference add_objects_to_scene, scene_gaussian.py:318-424):
  xyz        -> R @ S @ xyz, z-snapped so the lowest ACTIVE point sits at
                the centre's z, then + T
  log-scales -> + log(scale)   (per axis)
  quats      -> quat(R) * quat  (Hamilton, real first)
  SH coeffs  -> the exact per-band rotation (ops/transforms.rotate_sh), on
                the coefficient axis for every band, as the JAX package
                does (the reference rotates band 1 on the channel axis).

Departure: `export_layout` draws the boxes with numpy and writes the image
through utils/media.py instead of cv2, and draws no text labels.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from dreamscene_tpu_torch.models.gaussians import PARAM_FIELDS, GaussianState, adam_init
from dreamscene_tpu_torch.ops.quaternion import (
    matrix_to_quaternion,
    quaternion_raw_multiply,
    quaternion_to_matrix,
)
from dreamscene_tpu_torch.ops.transforms import euler_angles_to_matrix, rotate_sh


@dataclasses.dataclass
class ObjectArgs:
    """Per-instance placement record (reference scene_gaussian.py:24-31)."""

    object_id: str
    clas: int
    affine: dict           # {"T": [3], "R": rotation (deg euler or quat), "S": [3]}
    bbox: np.ndarray       # [6] world-space min/max after placement


@dataclasses.dataclass
class ObjectEntry:
    """Registry slot (reference ObjectGaussian, scene_gaussian.py:33-37)."""

    id: str
    state: GaussianState
    step: int = 0
    text: Optional[dict] = None


def rotation_matrix_from_param(rotation, device="cpu") -> torch.Tensor:
    """Euler degrees [3] (XYZ) or quaternion [4] -> [3, 3] (reference
    create_transform_matrix_RS, scene_gaussian.py:480-513)."""
    rotation = torch.as_tensor(np.asarray(rotation, np.float32), device=device)
    if rotation.shape[-1] == 3:
        return euler_angles_to_matrix(torch.deg2rad(rotation), "XYZ")
    return quaternion_to_matrix(rotation)


def place_object(state: GaussianState, center, rotation, scale, snap_floor: bool = True
                 ) -> tuple[GaussianState, ObjectArgs, np.ndarray]:
    """Apply an affine placement to a (trained) object model; returns a
    fresh placed instance with a new optimizer and zeroed statistics, its
    placement record and its world-space bbox."""
    dev = state.device
    scale = np.asarray(scale, np.float32)
    if scale.size == 1:
        scale = np.repeat(scale, 3)
    rot = rotation_matrix_from_param(rotation, dev)
    scale_t = torch.as_tensor(scale, device=dev)
    active = state.aux["active"]
    p = state.params

    transformed = (rot @ torch.diag(scale_t) @ p["xyz"].T).T
    z_min = torch.where(active, transformed[:, 2],
                        torch.full_like(transformed[:, 2], float("inf"))).min()
    t_center = torch.as_tensor(np.asarray(center, np.float32), device=dev).clone()
    if snap_floor:
        t_center[2] = t_center[2] - z_min
    new_xyz = transformed + t_center[None, :]

    quat_r = matrix_to_quaternion(rot)
    feats = rotate_sh(torch.cat([p["features_dc"], p["features_rest"]], dim=1), rot,
                      state.sh_degree)
    params = dict(p, xyz=new_xyz, scaling=p["scaling"] + torch.log(scale_t)[None, :],
                  rotation=quaternion_raw_multiply(quat_r.expand(p["rotation"].shape),
                                                   p["rotation"]),
                  features_dc=feats[:, :1, :], features_rest=feats[:, 1:, :])
    aux = dict(active=active, max_radii2d=torch.zeros_like(state.aux["max_radii2d"]),
               xyz_gradient_accum=torch.zeros_like(state.aux["xyz_gradient_accum"]),
               denom=torch.zeros_like(state.aux["denom"]))
    placed = dataclasses.replace(state, params=params, aux=aux, opt=adam_init(params))

    pts = new_xyz[active].cpu().numpy()
    bbox = np.concatenate([pts.min(axis=0), pts.max(axis=0)])
    args = ObjectArgs(object_id="", clas=0,
                      affine={"T": t_center.cpu().numpy(), "R": np.asarray(rotation),
                              "S": scale},
                      bbox=bbox)
    return placed, args, bbox


@dataclasses.dataclass
class SceneModel:
    """The scene: placed object instances + env + floor (reference
    SceneGaussian fields, scene_gaussian.py:39-51, 429-478)."""

    objects: dict = dataclasses.field(default_factory=dict)   # name -> ObjectEntry
    objects_args: list = dataclasses.field(default_factory=list)
    env: Optional[GaussianState] = None
    floor: Optional[GaussianState] = None
    scene_box: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(6, np.float32))
    stage_n: int = 0

    def grow_box(self, bbox: np.ndarray):
        self.scene_box[:3] = np.minimum(self.scene_box[:3], bbox[:3])
        self.scene_box[3:] = np.maximum(self.scene_box[3:], bbox[3:])

    def visible_states(self, keys=None) -> list[GaussianState]:
        """States for a scene render in the reference's concat order:
        objects..., floor, env (scene_gaussian.py:753-846)."""
        names = keys if keys is not None else list(self.objects)
        states = [self.objects[name].state for name in names]
        if self.floor is not None:
            states.append(self.floor)
        if self.env is not None:
            states.append(self.env)
        return states


def _draw_rect(img: np.ndarray, p0, p1, color, thickness: int = 2) -> None:
    """Axis-aligned rectangle outline with corners p0, p1 (x, y), clipped."""
    h, w = img.shape[:2]
    x0, x1 = sorted((p0[0], p1[0]))
    y0, y1 = sorted((p0[1], p1[1]))
    t = thickness // 2
    for xa, xb, ya, yb in ((x0 - t, x1 + t, y0 - t, y0 + t), (x0 - t, x1 + t, y1 - t, y1 + t),
                           (x0 - t, x0 + t, y0 - t, y1 + t), (x1 - t, x1 + t, y0 - t, y1 + t)):
        xa, xb = max(xa, 0), min(xb, w - 1)
        ya, yb = max(ya, 0), min(yb, h - 1)
        if xa <= xb and ya <= yb:
            img[ya:yb + 1, xa:xb + 1] = color


def export_layout(scene_box: np.ndarray, objects_args: list, path: str, seed: int = 0) -> None:
    """Top-down 2D layout image, one box per placed object, each in a
    colour drawn from RandomState(seed) as the JAX package draws it
    (reference export_layout, scene_gaussian.py:249-301). No labels."""
    from dreamscene_tpu_torch.utils.media import save_image_grid

    rng = np.random.RandomState(seed)
    w = float(scene_box[3] - scene_box[0])
    h = float(scene_box[4] - scene_box[1])
    if w <= 0 or h <= 0:
        return
    scale = 1024.0 / max(w, h)
    layout = np.zeros((int(scale * h), int(scale * w), 3), np.uint8)
    for oa in objects_args:
        lb = (int(scale * (oa.bbox[0] - scene_box[0])), int(scale * (scene_box[4] - oa.bbox[1])))
        rt = (int(scale * (oa.bbox[3] - scene_box[0])), int(scale * (scene_box[4] - oa.bbox[4])))
        _draw_rect(layout, lb, rt, rng.randint(0, 255, 3).astype(np.uint8))
    save_image_grid(path, [np.transpose(layout, (2, 0, 1)).astype(np.float32) / 255.0])


def final_combine_all(states: list[GaussianState]) -> GaussianState:
    """Concatenate models into one, rest-SH zero-padded to the highest
    degree (reference final_combine_all, scene_gaussian.py:519-544)."""
    max_deg = max(s.sh_degree for s in states)
    k = (max_deg + 1) ** 2

    def pad_rest(s):
        rest = s.params["features_rest"]
        if rest.shape[1] < k - 1:
            rest = torch.cat([rest, rest.new_zeros((rest.shape[0], k - 1 - rest.shape[1], 3))],
                             dim=1)
        return rest

    params = {f: torch.cat([pad_rest(s) if f == "features_rest" else s.params[f]
                            for s in states])
              for f in PARAM_FIELDS if f != "background"}
    params["background"] = states[0].params["background"]
    aux = {f: torch.cat([s.aux[f] for s in states]) for f in states[0].aux}
    return GaussianState(params=params, aux=aux, opt=adam_init(params), sh_degree=max_deg,
                         active_sh_degree=max_deg, spatial_lr_scale=states[0].spatial_lr_scale)
