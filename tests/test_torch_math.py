"""Math-core parity: SH, quaternions, covariance, projection, DDIM, tv loss and
the masked Adam step of the port against the JAX package on the same
numpy inputs.

Tolerance: atol 1e-6 (float32 elementwise math; the JAX package runs its
SH/covariance/projection products at Precision.HIGHEST, the port in
float32 with TF32 off). Projection's pixel means are compared relative
to their magnitude (rtol 1e-6), its integer radii exactly.
"""

import math

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from dreamscene_tpu.cameras import Camera as JCamera
from dreamscene_tpu.cameras.sampling import _pose_to_rt, circle_poses
from dreamscene_tpu.models import gaussians as jg
from dreamscene_tpu.ops import covariance as jcov
from dreamscene_tpu.ops import ddim as jddim
from dreamscene_tpu.ops import losses as jloss
from dreamscene_tpu.ops import projection as jproj
from dreamscene_tpu.ops import quaternion as jq
from dreamscene_tpu.ops import sh as jsh
from dreamscene_tpu_torch.models import gaussians as tg
from dreamscene_tpu_torch.ops import covariance as tcov
from dreamscene_tpu_torch.ops import ddim as tddim
from dreamscene_tpu_torch.ops import losses as tloss
from dreamscene_tpu_torch.ops import projection as tproj
from dreamscene_tpu_torch.ops import quaternion as tq
from dreamscene_tpu_torch.ops import sh as tsh

# One intra-op thread: the suite runs several worker processes at once, and
# one OpenMP team of all cores per worker makes these small tensors wait on
# each other (the six heaviest files of the port took 205 s on 8 cores with
# 6 workers, 66 s with one thread each).
torch.set_num_threads(1)

ATOL = 1e-6


def close(t, j, atol=ATOL, rtol=0.0):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=atol, rtol=rtol)


def unit(rng, n, d=3):
    v = rng.randn(n, d).astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


@pytest.mark.parametrize("deg", [0, 1, 2, 3, 4])
def test_sh_matches(deg):
    rng = np.random.RandomState(deg)
    dirs = unit(rng, 64)
    sh = rng.randn(64, 3, 25).astype(np.float32) * 0.5
    close(tsh.sh_basis(deg, torch.from_numpy(dirs)), jsh.sh_basis(deg, jnp.asarray(dirs)))
    close(tsh.eval_sh(deg, torch.from_numpy(sh), torch.from_numpy(dirs)),
          jsh.eval_sh(deg, jnp.asarray(sh), jnp.asarray(dirs)))


def test_quaternion_ops_match():
    rng = np.random.RandomState(0)
    a, b = unit(rng, 50, 4), unit(rng, 50, 4)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    close(tq.quaternion_multiply(ta, tb), jq.quaternion_multiply(jnp.asarray(a), jnp.asarray(b)))
    close(tq.quaternion_invert(ta), jq.quaternion_invert(jnp.asarray(a)))
    m = tq.quaternion_to_matrix(ta)
    close(m, jq.quaternion_to_matrix(jnp.asarray(a)))
    close(tq.matrix_to_quaternion(m), jq.matrix_to_quaternion(jnp.asarray(m.numpy())), atol=2e-6)


def test_covariance_matches():
    rng = np.random.RandomState(1)
    q = rng.randn(40, 4).astype(np.float32)
    s = np.exp(rng.randn(40, 3)).astype(np.float32)
    cov_t = tcov.build_covariance_3d(torch.from_numpy(s), torch.from_numpy(q), 0.7)
    cov_j = jcov.build_covariance_3d(jnp.asarray(s), jnp.asarray(q), 0.7)
    close(cov_t, cov_j, atol=1e-5, rtol=1e-6)
    close(tcov.strip_symmetric(cov_t), jcov.strip_symmetric(jnp.asarray(cov_t.numpy())))
    close(tcov.unstrip_symmetric(tcov.strip_symmetric(cov_t)), cov_t.numpy())


def test_projection_matches():
    rng = np.random.RandomState(2)
    n = 300
    pose = circle_poses(4.0, 80.0, 20.0)
    R, T = _pose_to_rt(pose)
    cam = JCamera(R=R.astype(np.float32), T=T.astype(np.float32), fovx=math.radians(50),
                  fovy=math.radians(45), width=72, height=40)
    means = (rng.randn(n, 3) * 0.8).astype(np.float32)
    scales = np.exp(rng.randn(n, 3) * 0.5 - 2.5).astype(np.float32)
    quats = rng.randn(n, 4).astype(np.float32)
    opac = rng.rand(n).astype(np.float32)
    shs = (rng.randn(n, 9, 3) * 0.3).astype(np.float32)
    mask = rng.rand(n) > 0.2
    args = [means, scales, quats, opac, shs, cam.world_view_transform,
            cam.full_proj_transform, cam.camera_center]
    kw = dict(width=72, height=40, sh_degree=2, scale_modifier=1.1)
    j = jproj.project_gaussians(*[jnp.asarray(a) for a in args], cam.tanfovx, cam.tanfovy,
                                valid_mask=jnp.asarray(mask), **kw)
    t = tproj.project_gaussians(*[torch.from_numpy(a) for a in args], cam.tanfovx,
                                cam.tanfovy, valid_mask=torch.from_numpy(mask), **kw)
    close(t.means2d, j.means2d, atol=1e-4, rtol=1e-6)
    close(t.depths, j.depths, rtol=1e-6)
    close(t.conics, j.conics, atol=1e-6, rtol=1e-5)
    close(t.colors, j.colors)
    np.testing.assert_array_equal(t.radii.numpy(), np.asarray(j.radii))
    np.testing.assert_array_equal(t.visible.numpy(), np.asarray(j.visible))
    close(tproj.ndc2pix(torch.tensor([-1.0, 0.3, 1.0]), 64),
          jproj.ndc2pix(jnp.asarray([-1.0, 0.3, 1.0]), 64))


def test_tv_and_l2_loss_match():
    rng = np.random.RandomState(3)
    x = rng.rand(2, 3, 17, 23).astype(np.float32)
    y = rng.rand(2, 3, 17, 23).astype(np.float32)
    close(tloss.tv_loss(torch.from_numpy(x)), jloss.tv_loss(jnp.asarray(x)))
    close(tloss.l2_loss(torch.from_numpy(x), torch.from_numpy(y)),
          jloss.l2_loss(jnp.asarray(x), jnp.asarray(y)))


def test_masked_adam_and_lrs_match():
    from dreamscene_tpu.utils.config import OptimizationParams

    rng = np.random.RandomState(4)
    shapes = dict(xyz=(20, 3), features_dc=(20, 1, 3), features_rest=(20, 3, 3),
                  scaling=(20, 3), rotation=(20, 4), opacity=(20, 1), background=(3,))
    p = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    g = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    active = rng.rand(20) > 0.3
    opt_args = OptimizationParams()
    for step in (1, 700):
        lrs = jg.group_lrs(opt_args, 10.0, step)
        assert tg.group_lrs(opt_args, 10.0, step) == lrs
    jp = jg.GaussianParams(**{k: jnp.asarray(v) for k, v in p.items()})
    jgr = jg.GaussianParams(**{k: jnp.asarray(v) for k, v in g.items()})
    jnew, jopt = jg.adam_update(jp, jgr, jg.adam_init(jp), jnp.asarray(active),
                                {k: jnp.asarray(v, jnp.float32) for k, v in lrs.items()})
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    tnew, topt = tg.adam_update(tp, {k: torch.from_numpy(v) for k, v in g.items()},
                                tg.adam_init(tp), torch.from_numpy(active), lrs)
    for k in shapes:
        close(tnew[k], getattr(jnew, k))
        close(topt.mu[k], getattr(jopt.mu, k))
        close(topt.nu[k], getattr(jopt.nu, k))
    assert topt.count == int(jopt.count) == 1


def test_ddim_math_matches():
    js, ts_ = jddim.make_schedule(), tddim.make_schedule()
    np.testing.assert_array_equal(ts_.alphas_cumprod.numpy(), np.asarray(js.alphas_cumprod))
    rng = np.random.RandomState(4)
    x = rng.randn(2, 4, 4, 4).astype(np.float32)
    e = rng.randn(2, 4, 4, 4).astype(np.float32)
    t = np.array([300, 700])
    for delta in [200, -150]:
        jp, jx0 = jddim.ddim_step(js, jnp.asarray(e), jnp.asarray(t), jnp.asarray(x), delta)
        tp, tx0 = tddim.ddim_step(ts_, torch.from_numpy(e), torch.from_numpy(t),
                                  torch.from_numpy(x), delta)
        np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-6)
        np.testing.assert_allclose(tx0.numpy(), np.asarray(jx0), atol=1e-6)
    np.testing.assert_allclose(
        tddim.add_noise(ts_, torch.from_numpy(x), torch.from_numpy(e), torch.from_numpy(t)).numpy(),
        np.asarray(jddim.add_noise(js, jnp.asarray(x), jnp.asarray(e), jnp.asarray(t))), atol=1e-6)
    np.testing.assert_allclose(
        tddim.pred_original(ts_, torch.from_numpy(e), torch.from_numpy(t), torch.from_numpy(x)).numpy(),
        np.asarray(jddim.pred_original(js, jnp.asarray(e), jnp.asarray(t), jnp.asarray(x))), atol=1e-6)
