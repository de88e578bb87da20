"""The port's rasterizer VJP + masked-Adam chain really fits: the twin of
tests/test_convergence.py on the port's CPU path. A perturbed clone of a
60-splat ground truth must recover it against the ground truth's renders
from three cameras at 64^2: the L2 loss falls 10x within 100 Adam steps,
and the last 25 losses average below the first 25 (the JAX test's bounds).
The starting loss and the loss after the first Adam step are held against
the JAX test's own functions (Pallas kernels interpreted) at rtol 1e-4.

The port renders with 128-entry chunks where the JAX test takes the default
512: no tile holds more than the scene's 60 splats, so each tile's entries
fill one chunk either way and the images are the same, while the plain
compositing (a [tiles, pixels, chunk] block per chunk) runs 4x less work.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import torch

from dreamscene_tpu.models import gaussians as JG
from dreamscene_tpu_torch.models import gaussians as TG
from dreamscene_tpu_torch.ops.rasterizer import render
from tests.test_convergence import _render_params
from tests.test_rasterizer_parity import make_camera

torch.set_num_threads(1)

SH_DEGREE = 1
N = 60
CHUNK = 128
STEPS = 100
LRS = dict(xyz=2e-3, f_dc=2.5e-2, f_rest=1.25e-3, scaling=5e-3, rotation=1e-3, opacity=5e-2,
           background=0.0)
CAMS = [make_camera(64, 64, azim=a, elev=e) for a, e in [(0.3, 0.2), (2.1, -0.1), (4.2, 0.5)]]


def scene_arrays():
    """The JAX test's draws from RandomState(3): points, colours, then the
    perturbation of the clone's positions."""
    rng = np.random.RandomState(3)
    pts = rng.randn(N, 3).astype(np.float32) * 0.6
    cols = rng.uniform(0.2, 0.8, (N, 3)).astype(np.float32)
    jitter = rng.randn(N, 3).astype(np.float32) * 0.1
    return pts, cols, jitter


def port_render(p, active, cam):
    q = p["rotation"]
    return render(
        means3d=p["xyz"], scales=torch.exp(p["scaling"]),
        quats=q / torch.linalg.norm(q, dim=-1, keepdim=True),
        opacities=torch.sigmoid(p["opacity"][:, 0]),
        shs=torch.cat([p["features_dc"], p["features_rest"]], 1),
        viewmatrix=torch.as_tensor(cam.world_view_transform),
        projmatrix=torch.as_tensor(cam.full_proj_transform),
        campos=torch.as_tensor(cam.camera_center), tanfovx=cam.tanfovx, tanfovy=cam.tanfovy,
        width=cam.width, height=cam.height, bg=torch.zeros(3), sh_degree=SH_DEGREE,
        valid_mask=active, chunk=CHUNK, device="cpu")


def port_fit(steps=STEPS):
    """(loss0, the loss at each of `steps` Adam steps' starting
    parameters, as the JAX test records them: losses[0] is loss0)."""
    pts, cols, jitter = scene_arrays()
    gt = TG.create_from_points(pts, cols, sh_degree=SH_DEGREE, capacity=N, device="cpu")
    gt_p = dict(gt.params, scaling=torch.full_like(gt.params["scaling"], math.log(0.22)),
                opacity=torch.full_like(gt.params["opacity"], 2.0))
    active = gt.aux["active"]
    with torch.no_grad():
        targets = [port_render(gt_p, active, c)["image"] for c in CAMS]
    params = dict(gt_p, xyz=gt_p["xyz"] + torch.as_tensor(jitter),
                  features_dc=torch.zeros_like(gt_p["features_dc"]) + 0.3,
                  features_rest=torch.zeros_like(gt_p["features_rest"]),
                  scaling=gt_p["scaling"] - 0.4,
                  opacity=torch.zeros_like(gt_p["opacity"]))
    opt = TG.adam_init(params)

    def loss_fn(p):
        return sum(torch.mean((port_render(p, active, c)["image"] - t) ** 2)
                   for c, t in zip(CAMS, targets)) / len(CAMS)

    with torch.no_grad():
        loss0 = float(loss_fn(params))
    losses = []
    for _ in range(steps):
        leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        loss = loss_fn(leaves)
        grads = torch.autograd.grad(loss, [leaves[k] for k in TG.PARAM_FIELDS],
                                    allow_unused=True)
        grads = {k: torch.zeros_like(params[k]) if g is None else g
                 for k, g in zip(TG.PARAM_FIELDS, grads)}
        params, opt = TG.adam_update(params, grads, opt, active, LRS)
        losses.append(float(loss.detach()))
    return loss0, losses


def jax_first_losses():
    """loss0 and the loss after one Adam step, by the JAX test's functions
    (`_render_params` with interpret=True, the JAX package's Adam)."""
    pts, cols, jitter = scene_arrays()
    gt = JG.create_from_points(pts, cols, sh_degree=SH_DEGREE, capacity=N)
    gt_params = gt.params.replace(
        scaling=jnp.full_like(gt.params.scaling, math.log(0.22)),
        opacity=jnp.full_like(gt.params.opacity, 2.0))
    active = gt.aux.active
    bg = jnp.zeros((3,), jnp.float32)
    targets = [_render_params(gt_params, active, c, SH_DEGREE, bg)["image"] for c in CAMS]
    params = gt_params.replace(
        xyz=gt_params.xyz + jitter,
        features_dc=jnp.zeros_like(gt_params.features_dc) + 0.3,
        features_rest=jnp.zeros_like(gt_params.features_rest),
        scaling=gt_params.scaling - 0.4,
        opacity=jnp.zeros_like(gt_params.opacity))

    def loss_fn(p):
        err = 0.0
        for c, t in zip(CAMS, targets):
            err = err + jnp.mean((_render_params(p, active, c, SH_DEGREE, bg)["image"] - t) ** 2)
        return err / len(CAMS)

    loss0, g = jax.jit(jax.value_and_grad(loss_fn))(params)
    params1, _ = JG.adam_update(params, g, JG.adam_init(params), active, LRS)
    return float(loss0), float(jax.jit(loss_fn)(params1))


def test_recon_converges_10x():
    loss0, losses = port_fit()
    assert np.isfinite(losses).all()
    assert losses[-1] < loss0 / 10.0, (loss0, losses[-1])
    assert np.mean(losses[-25:]) < np.mean(losses[:25])


def test_first_losses_match_jax():
    """loss0 and the loss after one Adam step, port against JAX."""
    loss0, losses = port_fit(steps=2)
    j_loss0, j_loss1 = jax_first_losses()
    np.testing.assert_allclose(loss0, j_loss0, rtol=1e-4)
    np.testing.assert_allclose(losses[0], j_loss0, rtol=1e-4)
    np.testing.assert_allclose(losses[1], j_loss1, rtol=1e-4)
