"""3D occupancy-field extraction from a splat model, torch.

Port of dreamscene_tpu/models/fields.py (reference gs_renderer.py:491-573):
the alpha-weighted sum of 3D Gaussian densities on a regular grid over the
[-1,1]^3 cube, block by block. Each block's splats are culled on the host
with numpy by the JAX package's test and arithmetic, so both select the
same splats (a per-axis slab test narrows the candidates first); the
block's density is plain torch on the state's device,
[points, splats] pairs in chunks of splats so that a 50K-splat object at
resolution 128 stays within a few hundred MB.
"""

from __future__ import annotations

import numpy as np
import torch

from dreamscene_tpu_torch.ops.covariance import build_covariance_3d, strip_symmetric

# (point, splat) pairs evaluated at once per block
CHUNK_PAIRS = 1 << 23


def _inverse(covs: torch.Tensor) -> tuple:
    """The six entries of the inverse of packed covariances [..., 6]."""
    a, b, c, d, e, f = covs.unbind(-1)
    inv_det = 1.0 / (a * d * f + 2 * e * c * b - e**2 * a - c**2 * d - b**2 * f + 1e-24)
    return ((d * f - e**2) * inv_det, (e * c - b * f) * inv_det, (e * b - c * d) * inv_det,
            (a * f - c**2) * inv_det, (b * c - e * a) * inv_det, (a * d - b**2) * inv_det)


def _density(x, y, z, inv) -> torch.Tensor:
    inv_a, inv_b, inv_c, inv_d, inv_e, inv_f = inv
    power = (-0.5 * (x * x * inv_a + y * y * inv_d + z * z * inv_f)
             - x * y * inv_b - x * z * inv_c - y * z * inv_e)
    return torch.exp(torch.where(power > 0, torch.full_like(power, -1e10), power))


def gaussian_3d_coeff(xyzs: torch.Tensor, covs: torch.Tensor) -> torch.Tensor:
    """Density of unit-amplitude gaussians at offsets xyzs [M,3] given
    packed covariances covs [M,6] (reference: gs_renderer.py:97-130)."""
    return _density(xyzs[:, 0], xyzs[:, 1], xyzs[:, 2], _inverse(covs))


def _block_occupancy(pts, xyz, inv, opac) -> torch.Tensor:
    """sum_s opac_s * N(pts - xyz_s) for pts [P,3] over splats [S]."""
    out = torch.zeros(pts.shape[0], dtype=torch.float32, device=pts.device)
    step = max(CHUNK_PAIRS // pts.shape[0], 1)
    for s0 in range(0, xyz.shape[0], step):
        sl = slice(s0, s0 + step)
        off = pts[:, None, :] - xyz[None, sl, :]                      # [P,S,3]
        dens = _density(off[..., 0], off[..., 1], off[..., 2],
                        tuple(v[None, sl] for v in inv))
        out += (dens * opac[None, sl]).sum(-1)
    return out


def block_culls(xyz: np.ndarray, max_scale: np.ndarray, opac: np.ndarray, num_blocks: int,
                relax_ratio: float):
    """Yields ((xi, yi, zi), splat indices) for each block with splats, in
    the JAX package's loop order, culled by its test: distance to the
    block center <= block_radius + relax_ratio * max_scale, opacity > 0,
    evaluated with the same numpy arithmetic on the same arrays. A
    per-axis slab test first narrows each block to the splats it can keep
    (a superset), so each block's exact test runs on those alone."""
    block_size = 2.0 / num_blocks
    thr = block_size * 0.87 + relax_ratio * max_scale
    centers = [k * block_size - 1.0 + block_size / 2 for k in range(num_blocks)]
    # |x - c| <= distance: the slab test may only widen the set
    slack = thr.astype(np.float64) * (1 + 1e-9) + 1e-12
    slabs = [[np.abs(xyz[:, a].astype(np.float64) - c) <= slack for c in centers]
             for a in range(3)]
    for xi in range(num_blocks):
        for yi in range(num_blocks):
            cand_xy = slabs[0][xi] & slabs[1][yi]
            for zi in range(num_blocks):
                cand = np.nonzero(cand_xy & slabs[2][zi])[0]
                center = np.array([centers[xi], centers[yi], centers[zi]])
                d = np.linalg.norm(xyz[cand] - center, axis=-1)
                idx = cand[(d <= thr[cand]) & (opac[cand] > 0)]
                if idx.size:
                    yield (xi, yi, zi), idx


@torch.no_grad()
def extract_fields(state, resolution: int = 128, num_blocks: int = 16,
                   relax_ratio: float = 1.5) -> np.ndarray:
    """Occupancy grid [R,R,R] over the [-1,1]^3 cube (reference semantics:
    occ = sum_g opacity_g * N(x; mu_g, Sigma_g), splats culled per block
    by center distance <= block_radius + relax_ratio * max_scale)."""
    assert resolution % num_blocks == 0
    split = resolution // num_blocks
    dev = state.device

    opac_t = state.get_opacity[:, 0] * state.aux["active"]
    xyz_t = state.get_xyz
    inv = torch.stack(_inverse(strip_symmetric(
        build_covariance_3d(state.get_scaling, state.params["rotation"]))), -1)
    max_scale_t = state.get_scaling.amax(-1)
    opac, xyz, max_scale = (t.cpu().numpy() for t in (opac_t, xyz_t, max_scale_t))

    occ = torch.zeros((resolution,) * 3, dtype=torch.float32, device=dev)
    lin = np.linspace(-1, 1, resolution, dtype=np.float32)
    for (xi, yi, zi), idx in block_culls(xyz, max_scale, opac, num_blocks, relax_ratio):
        xs = lin[xi * split:(xi + 1) * split]
        ys = lin[yi * split:(yi + 1) * split]
        zs = lin[zi * split:(zi + 1) * split]
        gx, gy, gz = np.meshgrid(xs, ys, zs, indexing="ij")
        pts = np.stack([gx, gy, gz], axis=-1).reshape(-1, 3)
        sel = torch.from_numpy(idx).to(dev)
        vals = _block_occupancy(torch.from_numpy(pts).to(dev), xyz_t[sel], inv[sel].unbind(-1),
                                opac_t[sel])
        occ[xi * split:(xi + 1) * split, yi * split:(yi + 1) * split,
            zi * split:(zi + 1) * split] = vals.reshape(split, split, split)
    return occ.cpu().numpy()
