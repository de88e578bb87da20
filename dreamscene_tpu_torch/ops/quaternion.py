"""Quaternion algebra (real-first wxyz convention), torch.

Port of dreamscene_tpu/ops/quaternion.py (reference:
utils/quaternion_utils.py:10-77). Broadcasts over leading batch dims.
"""

from __future__ import annotations

import torch


def standardize_quaternion(q: torch.Tensor) -> torch.Tensor:
    """Flip sign so the real part is non-negative."""
    return torch.where(q[..., 0:1] < 0, -q, q)


def quaternion_raw_multiply(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product a*b of quaternions [..., 4], real part first."""
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    ow = aw * bw - ax * bx - ay * by - az * bz
    ox = aw * bx + ax * bw + ay * bz - az * by
    oy = aw * by - ax * bz + ay * bw + az * bx
    oz = aw * bz + ax * by - ay * bx + az * bw
    return torch.stack((ow, ox, oy, oz), dim=-1)


def quaternion_multiply(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return standardize_quaternion(quaternion_raw_multiply(a, b))


def quaternion_invert(q: torch.Tensor) -> torch.Tensor:
    """Inverse of a unit quaternion (conjugate)."""
    return q * q.new_tensor([1.0, -1.0, -1.0, -1.0])


def quaternion_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion [..., 4] (wxyz) -> rotation matrix [..., 3, 3]."""
    w, x, y, z = q.unbind(-1)
    two_s = 2.0 / (q * q).sum(-1)
    m = torch.stack(
        [
            1 - two_s * (y * y + z * z),
            two_s * (x * y - z * w),
            two_s * (x * z + y * w),
            two_s * (x * y + z * w),
            1 - two_s * (x * x + z * z),
            two_s * (y * z - x * w),
            two_s * (x * z - y * w),
            two_s * (y * z + x * w),
            1 - two_s * (x * x + y * y),
        ],
        dim=-1,
    )
    return m.reshape(q.shape[:-1] + (3, 3))


def matrix_to_quaternion(m: torch.Tensor) -> torch.Tensor:
    """Rotation matrix [..., 3, 3] -> unit quaternion [..., 4] (wxyz),
    branch-free Shepperd-style construction."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    q_abs2 = torch.stack(
        [
            1.0 + m00 + m11 + m22,
            1.0 + m00 - m11 - m22,
            1.0 - m00 + m11 - m22,
            1.0 - m00 - m11 + m22,
        ],
        dim=-1,
    )
    q_abs = torch.sqrt(torch.clamp_min(q_abs2, 0.0))
    quat_w = torch.stack([q_abs2[..., 0], m21 - m12, m02 - m20, m10 - m01], dim=-1)
    quat_x = torch.stack([m21 - m12, q_abs2[..., 1], m10 + m01, m02 + m20], dim=-1)
    quat_y = torch.stack([m02 - m20, m10 + m01, q_abs2[..., 2], m12 + m21], dim=-1)
    quat_z = torch.stack([m10 - m01, m20 + m02, m21 + m12, q_abs2[..., 3]], dim=-1)
    cands = torch.stack([quat_w, quat_x, quat_y, quat_z], dim=-2)
    cands = cands / (2.0 * torch.clamp_min(q_abs, 1e-8))[..., None]
    best = torch.argmax(q_abs2, dim=-1)
    idx = best[..., None, None].expand(best.shape + (1, 4))
    q = torch.gather(cands, -2, idx)[..., 0, :]
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    return standardize_quaternion(q)
