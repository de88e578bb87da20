"""Object point-cloud initializers (host-side numpy), the part of
dreamscene_tpu/models/init.py that object generation uses first:

  * `default`: uniform ball via radius*cbrt(u) (reference
    gs_renderer.py:355-372);
  * `pointe*`: the ball as well — point-e is an optional external model
    and the JAX package also falls back to the ball when it is absent
    (init.py:128-137).

Same numpy RandomState stream as the JAX package, so the same points come
out for the same seed. The JAX package also caches the cloud as a PLY;
PLY I/O is not ported yet (ROADMAP queue A, slice 2), so nothing is
written here.
"""

from __future__ import annotations

import logging

import numpy as np

from dreamscene_tpu_torch.ops.sh import SH2RGB

logger = logging.getLogger("dreamscene_tpu_torch")


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
    if init_guided == "default" or init_guided.startswith("pointe"):
        if init_guided != "default":
            logger.warning("point-e is not available to the port; "
                           "falling back to the ball init")
        xyz = sample_ball(num_pts, radius, rng)
        rgb = SH2RGB(rng.random((num_pts, 3)) / 255.0)
        sls = 10.0 if init_guided == "default" else 1.0
        return xyz.astype(np.float32), rgb.astype(np.float32), sls
    raise NotImplementedError(
        f"init_guided={init_guided!r} is not ported yet (ROADMAP queue A)")
