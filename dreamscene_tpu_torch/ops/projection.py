"""Per-Gaussian screen-space projection (EWA splatting), torch autograd.

Port of dreamscene_tpu/ops/projection.py: screen mean, conic, view depth,
pixel radius and SH colour for every splat, with the CUDA preprocess's
0.3-px low-pass, 1.3*tanfov clamp, z <= 0.2 near cull and 3-sigma radius.
Autograd carries the record cotangents back to the splat parameters.

The view/clip products are float32 matmuls; TF32 is switched off here
explicitly (the JAX package measured a 0.4% screen error from a
reduced-precision product at this place).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from dreamscene_tpu_torch.ops.sh import eval_sh

torch.backends.cuda.matmul.allow_tf32 = False

NEAR_CULL_Z = 0.2
LOWPASS = 0.3
RADIUS_SIGMA = 3.0


class ProjectedSplats(NamedTuple):
    means2d: torch.Tensor      # [N, 2] pixel coords
    depths: torch.Tensor       # [N] view-space z
    conics: torch.Tensor       # [N, 3] (a, b, c) of the inverse 2D covariance
    colors: torch.Tensor       # [N, 3] view-dependent RGB (>= 0)
    opacities: torch.Tensor    # [N]
    radii: torch.Tensor        # [N] int32 pixel radius, 0 => culled
    visible: torch.Tensor      # [N] bool


def ndc2pix(v, size: int):
    """NDC [-1,1] -> pixel coordinate, CUDA convention ((v+1)*S-1)/2."""
    return ((v + 1.0) * size - 1.0) * 0.5


def project_gaussians(
    means3d, scales, quats, opacities, shs, viewmatrix, projmatrix, campos,
    tanfovx: float, tanfovy: float, width: int, height: int,
    sh_degree: int = 3, scale_modifier: float = 1.0, colors_precomp=None,
    cov3d_precomp=None, valid_mask=None,
) -> ProjectedSplats:
    """Project N Gaussians into screen space (see the JAX docstring for
    the conventions: column-vector view/clip matrices, wxyz quats,
    shs [N, K, 3])."""
    n = means3d.shape[0]
    tanfovx = float(tanfovx)
    tanfovy = float(tanfovy)
    fx = width / (2.0 * tanfovx)
    fy = height / (2.0 * tanfovy)

    hom = torch.cat([means3d, means3d.new_ones((n, 1))], dim=-1)
    p_view = hom @ viewmatrix.T
    tz = p_view[:, 2]
    p_clip = hom @ projmatrix.T
    p_w = 1.0 / (p_clip[:, 3] + 1e-7)
    ndc = p_clip[:, :3] * p_w[:, None]
    means2d = torch.stack(
        [ndc2pix(ndc[:, 0], width), ndc2pix(ndc[:, 1], height)], dim=-1)

    if cov3d_precomp is not None:
        c_xx, c_xy, c_xz, c_yy, c_yz, c_zz = cov3d_precomp.unbind(-1)
    else:
        qn = quats / torch.linalg.norm(quats, dim=-1, keepdim=True)
        w, x, y, z = qn.unbind(-1)
        s0 = scales[:, 0] * scale_modifier
        s1 = scales[:, 1] * scale_modifier
        s2 = scales[:, 2] * scale_modifier
        r00 = 1 - 2 * (y * y + z * z)
        r01 = 2 * (x * y - z * w)
        r02 = 2 * (x * z + y * w)
        r10 = 2 * (x * y + z * w)
        r11 = 1 - 2 * (x * x + z * z)
        r12 = 2 * (y * z - x * w)
        r20 = 2 * (x * z - y * w)
        r21 = 2 * (y * z + x * w)
        r22 = 1 - 2 * (x * x + y * y)
        a0, a1, a2 = r00 * s0, r01 * s1, r02 * s2
        b0, b1, b2 = r10 * s0, r11 * s1, r12 * s2
        g0, g1, g2 = r20 * s0, r21 * s1, r22 * s2
        c_xx = a0 * a0 + a1 * a1 + a2 * a2
        c_xy = a0 * b0 + a1 * b1 + a2 * b2
        c_xz = a0 * g0 + a1 * g1 + a2 * g2
        c_yy = b0 * b0 + b1 * b1 + b2 * b2
        c_yz = b0 * g0 + b1 * g1 + b2 * g2
        c_zz = g0 * g0 + g1 * g1 + g2 * g2

    lim_x, lim_y = 1.3 * tanfovx, 1.3 * tanfovy
    tzc = torch.where(torch.abs(tz) < 1e-6, torch.full_like(tz, 1e-6), tz)
    tx = torch.clamp(p_view[:, 0] / tzc, -lim_x, lim_x) * tzc
    ty = torch.clamp(p_view[:, 1] / tzc, -lim_y, lim_y) * tzc
    inv_z = 1.0 / tzc
    inv_z2 = inv_z * inv_z

    w_rot = viewmatrix[:3, :3]
    j00 = fx * inv_z
    j02 = -fx * tx * inv_z2
    j11 = fy * inv_z
    j12 = -fy * ty * inv_z2
    t00 = j00 * w_rot[0, 0] + j02 * w_rot[2, 0]
    t01 = j00 * w_rot[0, 1] + j02 * w_rot[2, 1]
    t02 = j00 * w_rot[0, 2] + j02 * w_rot[2, 2]
    t10 = j11 * w_rot[1, 0] + j12 * w_rot[2, 0]
    t11 = j11 * w_rot[1, 1] + j12 * w_rot[2, 1]
    t12 = j11 * w_rot[1, 2] + j12 * w_rot[2, 2]
    u0 = c_xx * t00 + c_xy * t01 + c_xz * t02
    u1 = c_xy * t00 + c_yy * t01 + c_yz * t02
    u2 = c_xz * t00 + c_yz * t01 + c_zz * t02
    v0 = c_xx * t10 + c_xy * t11 + c_xz * t12
    v1 = c_xy * t10 + c_yy * t11 + c_yz * t12
    v2 = c_xz * t10 + c_yz * t11 + c_zz * t12
    cxx = t00 * u0 + t01 * u1 + t02 * u2 + LOWPASS
    cxy = t10 * u0 + t11 * u1 + t12 * u2
    cyy = t10 * v0 + t11 * v1 + t12 * v2 + LOWPASS

    det = cxx * cyy - cxy * cxy
    det_ok = det > 0.0
    inv_det = 1.0 / torch.where(det_ok, det, torch.ones_like(det))
    conic = torch.stack([cyy * inv_det, -cxy * inv_det, cxx * inv_det], dim=-1)

    mid = 0.5 * (cxx + cyy)
    lam1 = mid + torch.sqrt(torch.clamp_min(mid * mid - det, 0.1))
    radius_f = torch.ceil(RADIUS_SIGMA * torch.sqrt(lam1))
    visible = (tz > NEAR_CULL_Z) & det_ok
    if valid_mask is not None:
        visible = visible & valid_mask.bool()
    radii = torch.where(visible, radius_f, torch.zeros_like(radius_f)).detach().to(torch.int32)
    visible = radii > 0

    if colors_precomp is not None:
        colors = colors_precomp
    else:
        assert shs is not None
        dirs = means3d - campos[None, :]
        dirs = dirs / torch.clamp_min(torch.linalg.norm(dirs, dim=-1, keepdim=True), 1e-8)
        rgb = eval_sh(sh_degree, shs.transpose(-1, -2), dirs) + 0.5
        colors = torch.clamp_min(rgb, 0.0)

    return ProjectedSplats(
        means2d=means2d, depths=tz, conics=conic, colors=colors,
        opacities=opacities, radii=radii, visible=visible,
    )
