"""Object point-cloud initializers (host-side numpy), the part of
dreamscene_tpu/models/init.py that object generation uses first:

  * `default`: uniform ball via radius*cbrt(u) (reference
    gs_renderer.py:355-372);
  * `pointe*`: the ball as well — point-e is an optional external model
    and the JAX package also falls back to the ball when it is absent
    (init.py:128-137).

Same numpy RandomState stream as the JAX package, so the same points come
out for the same seed. The `default` cloud is cached as
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


def init_object_points(init_guided: str, init_prompt: str, exp_path: str,
                       num_pts: int = 20000, radius: float = 0.5,
                       use_pointe_rgb: bool = False, seed: int = 0):
    """Returns (points [N,3], colors [N,3] in [0,1], spatial_lr_scale)."""
    rng = np.random.RandomState(seed)
    ply_path = os.path.join(exp_path, hash_prompt(init_guided, init_prompt)
                            + "_init_points3d.ply")
    if os.path.exists(ply_path):
        pts, rgb = fetch_point_ply(ply_path)
        return pts, rgb, 10.0 if init_guided == "default" else 1.0
    if init_guided == "default" or init_guided.startswith("pointe"):
        if init_guided != "default":
            logger.warning("point-e is not available to the port; "
                           "falling back to the ball init")
        xyz = sample_ball(num_pts, radius, rng)
        rgb = SH2RGB(rng.random((num_pts, 3)) / 255.0)
        if init_guided == "default":
            store_point_ply(ply_path, xyz, rgb * 255)
        sls = 10.0 if init_guided == "default" else 1.0
        return xyz.astype(np.float32), rgb.astype(np.float32), sls
    raise NotImplementedError(
        f"init_guided={init_guided!r} is not ported yet (ROADMAP queue A)")
