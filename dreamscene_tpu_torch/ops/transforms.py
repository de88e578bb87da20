"""Rigid transforms and spherical-harmonic rotation, torch.

Port of dreamscene_tpu/ops/transforms.py (it replaces pytorch3d's
euler_angles_to_matrix and e3nn's wigner_D as the reference uses them for
object placement, reference scene_gaussian.py:303-316, 355-375). The
real-SH band rotation D_l with

    sh_basis_l(R @ d) == D_l @ sh_basis_l(d)   for all unit d

is found by projection: the band basis is evaluated at 2l+1 fixed generic
directions and one linear system is solved per rotation. The directions
come from np.random.RandomState(1234 + l) and the basis inverse is taken
in float64 on the host, exactly as the JAX package does, so both packages
rotate with the same matrices.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from dreamscene_tpu_torch.ops.sh import sh_basis


def _axis_rotation(angle: torch.Tensor, axis: str) -> torch.Tensor:
    c, s = torch.cos(angle), torch.sin(angle)
    one, zero = torch.ones_like(c), torch.zeros_like(c)
    if axis == "X":
        rows = (one, zero, zero, zero, c, -s, zero, s, c)
    elif axis == "Y":
        rows = (c, zero, s, zero, one, zero, -s, zero, c)
    elif axis == "Z":
        rows = (c, -s, zero, s, c, zero, zero, zero, one)
    else:
        raise ValueError(axis)
    return torch.stack(rows, dim=-1).reshape(angle.shape + (3, 3))


def euler_angles_to_matrix(angles: torch.Tensor, convention: str = "XYZ") -> torch.Tensor:
    """Euler angles [..., 3] -> rotation matrix [..., 3, 3]:
    R = R_c0(a0) @ R_c1(a1) @ R_c2(a2) for convention "c0c1c2", as
    pytorch3d.transforms.euler_angles_to_matrix (reference call site
    scene_gaussian.py:489 with "XYZ")."""
    if len(convention) != 3:
        raise ValueError(f"convention {convention!r}: three axes expected")
    ms = [_axis_rotation(angles[..., i], convention[i]) for i in range(3)]
    return ms[0] @ ms[1] @ ms[2]


@functools.lru_cache(maxsize=None)
def _band_sample_dirs(l: int) -> np.ndarray:
    """2l+1 fixed generic unit directions (deterministic per band)."""
    rng = np.random.RandomState(1234 + l)
    d = rng.randn(2 * l + 1, 3)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return d.astype(np.float64)


def _band_slice(l: int) -> slice:
    return slice(l * l, (l + 1) * (l + 1))


@functools.lru_cache(maxsize=None)
def _band_basis_inv(l: int) -> np.ndarray:
    """Inverse of the [2l+1, 2l+1] band-l basis values at the sample
    directions: the basis in float32 (as the JAX package evaluates it),
    the inverse in float64, stored as float32."""
    d = torch.from_numpy(_band_sample_dirs(l).astype(np.float32))
    b = sh_basis(l, d)[:, _band_slice(l)].numpy()
    return np.linalg.inv(b.astype(np.float64)).astype(np.float32)


def sh_band_rotation_matrix(l: int, rot: torch.Tensor) -> torch.Tensor:
    """Real-SH band-l rotation matrix D_l [..., 2l+1, 2l+1] for rotation
    matrices rot [..., 3, 3]: sh_basis_l(rot @ d) = D_l @ sh_basis_l(d)."""
    if l == 0:
        return torch.ones(rot.shape[:-2] + (1, 1), dtype=rot.dtype, device=rot.device)
    dirs = torch.as_tensor(_band_sample_dirs(l), dtype=rot.dtype, device=rot.device)
    rdirs = torch.einsum("...ij,mj->...mi", rot, dirs)
    a = sh_basis(l, rdirs)[..., _band_slice(l)]
    b_inv = torch.as_tensor(_band_basis_inv(l), dtype=rot.dtype, device=rot.device)
    # D @ B^T = A^T  =>  D = (B_inv @ A)^T
    return torch.swapaxes(b_inv @ a, -1, -2)


def rotate_sh(sh: torch.Tensor, rot: torch.Tensor, deg: int) -> torch.Tensor:
    """Rotate SH coefficients [..., K, C] (K = (deg+1)**2) so appearance
    follows the rotation rot [3, 3]: coefficients of band l go to
    D_l @ coeff (D_l is orthogonal, so D_l^{-T} = D_l)."""
    out = [sh[..., _band_slice(0), :]]
    for l in range(1, deg + 1):
        d_l = sh_band_rotation_matrix(l, rot)
        out.append(torch.einsum("...ij,...jc->...ic", d_l, sh[..., _band_slice(l), :]))
    return torch.cat(out, dim=-2)
