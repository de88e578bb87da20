"""3D covariance construction for Gaussian splats, torch.

Port of dreamscene_tpu/ops/covariance.py: Sigma = R S S^T R^T from a
unit quaternion and per-axis scales. The JAX package runs the final
product at Precision.HIGHEST; here it is a float32 matmul with TF32 off
(set when the package loads).
"""

from __future__ import annotations

import torch

from dreamscene_tpu_torch.ops.quaternion import quaternion_to_matrix


def build_rotation(q: torch.Tensor) -> torch.Tensor:
    """Normalize quaternion [..., 4] (wxyz) and convert to [..., 3, 3]."""
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    return quaternion_to_matrix(q)


def build_scaling_rotation(scales: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """L = R @ diag(scales): [..., 3, 3]."""
    return build_rotation(q) * scales[..., None, :]


def build_covariance_3d(scales, q, scale_modifier=1.0) -> torch.Tensor:
    """Sigma = L @ L^T with L = R @ diag(scale_modifier * scales)."""
    l = build_scaling_rotation(scales * scale_modifier, q)
    return torch.matmul(l, l.transpose(-1, -2))


def strip_symmetric(cov: torch.Tensor) -> torch.Tensor:
    """Pack symmetric [..., 3, 3] into (xx, xy, xz, yy, yz, zz)."""
    return torch.stack(
        [cov[..., 0, 0], cov[..., 0, 1], cov[..., 0, 2],
         cov[..., 1, 1], cov[..., 1, 2], cov[..., 2, 2]],
        dim=-1,
    )


def unstrip_symmetric(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of strip_symmetric: [..., 6] -> [..., 3, 3]."""
    xx, xy, xz, yy, yz, zz = packed.unbind(-1)
    row0 = torch.stack([xx, xy, xz], dim=-1)
    row1 = torch.stack([xy, yy, yz], dim=-1)
    row2 = torch.stack([xz, yz, zz], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)
