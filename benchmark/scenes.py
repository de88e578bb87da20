"""The benchmark's inputs, made from the seed on the device: splat scenes,
cameras and the object's starting state. The program and the reference are
handed the same tensors; neither makes them.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed))


def box_scene(n: int, sh_degree: int, gen: torch.Generator, device) -> dict:
    """bench.py's 300K-splat scene, drawn on the device: half the splats on
    the shell of a 3.5 x 2.5 x 2.5 box, half N(0, 0.8^2) inside; unit
    quaternions, SH around grey (N(0, 0.2^2), DC + 0.5), log-normal scales
    exp(N(-3.2, 0.3^2)), sigmoid-normal opacities. One generator, drawn in
    bench.py's order."""
    k = (sh_degree + 1) ** 2
    n_shell = n // 2
    kw = dict(generator=gen, device=device)
    shell = torch.rand((n_shell, 3), **kw) * 2 - 1
    axis = torch.randint(0, 3, (n_shell,), **kw)
    sign = (torch.randint(0, 2, (n_shell,), **kw) * 2 - 1).float()
    shell[torch.arange(n_shell, device=device), axis] = sign
    shell = shell * torch.tensor([3.5, 2.5, 2.5], device=device)
    interior = torch.randn((n - n_shell, 3), **kw) * 0.8
    quats = torch.randn((n, 4), **kw)
    quats = quats / torch.linalg.norm(quats, dim=-1, keepdim=True)
    shs = torch.randn((n, k, 3), **kw) * 0.2
    shs[:, 0] += 0.5
    scales = torch.exp(torch.randn((n, 3), **kw) * 0.3 - 3.2)
    opacities = torch.sigmoid(torch.randn((n,), **kw))
    return dict(means3d=torch.cat([shell, interior]).contiguous(), scales=scales,
                quats=quats, opacities=opacities, shs=shs)


def _lookat(center: np.ndarray) -> np.ndarray:
    forward = center / np.linalg.norm(center)
    right = np.cross(forward, [0.0, 0.0, 1.0])
    right = right / np.linalg.norm(right)
    up = np.cross(right, forward)
    up = up / np.linalg.norm(up)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = np.stack([-right, up, forward], axis=-1)
    pose[:3, 3] = center
    return pose


def orbit_camera(width: int, height: int, radius: float, theta_deg: float, phi_deg: float,
                 fov_deg: float, device, znear: float = 0.01, zfar: float = 100.0) -> dict:
    """The render arguments of a camera on a sphere around the origin
    looking at it (z up), column-vector matrices: view, view-projection,
    centre, tan half-FoVs, size."""
    t, p = math.radians(theta_deg), math.radians(phi_deg)
    center = radius * np.array([math.sin(t) * math.sin(p), math.sin(t) * math.cos(p),
                                math.cos(t)])
    m = np.linalg.inv(_lookat(center))
    r = -m[:3, :3].T
    r[:, 0] = -r[:, 0]
    tvec = -m[:3, 3]
    view = np.zeros((4, 4))
    view[:3, :3] = r.T
    view[:3, 3] = tvec
    view[3, 3] = 1.0
    view = view.astype(np.float32)
    fov = math.radians(fov_deg)
    tan = math.tan(fov / 2)
    proj = np.zeros((4, 4), np.float32)
    proj[0, 0] = proj[1, 1] = 1.0 / tan
    proj[2, 2] = zfar / (zfar - znear)
    proj[2, 3] = -(zfar * znear) / (zfar - znear)
    proj[3, 2] = 1.0
    full = (proj @ view).astype(np.float32)
    campos = np.linalg.inv(view)[:3, 3].astype(np.float32)
    return dict(viewmatrix=torch.as_tensor(view, device=device),
                projmatrix=torch.as_tensor(full, device=device),
                campos=torch.as_tensor(campos, device=device), tanfovx=tan, tanfovy=tan,
                width=width, height=height)


def knn_log_scales(xyz: torch.Tensor, k: int = 3, block: int = 4096) -> torch.Tensor:
    """log(sqrt(mean squared distance to the k nearest other points)), the
    3DGS initial scale, by blocked exact search on the device."""
    out = []
    sq = (xyz * xyz).sum(-1)
    for i in range(0, xyz.shape[0], block):
        q = xyz[i:i + block]
        d2 = (sq[i:i + block, None] + sq[None, :] - 2.0 * (q @ xyz.T)).clamp_min(0.0)
        d2[torch.arange(q.shape[0], device=xyz.device), torch.arange(i, i + q.shape[0],
                                                                    device=xyz.device)] = \
            float("inf")
        out.append(d2.topk(k, dim=1, largest=False).values.mean(1))
    return torch.log(torch.sqrt(torch.cat(out).clamp_min(1e-7)))


def object_ball(n: int, capacity: int, sh_degree: int, radius: float,
                gen: torch.Generator, device, init_opacity: float = 0.1) -> dict:
    """The `default` init of an object as raw parameters of `capacity`
    rows, the first n active: points uniform in a ball of `radius`, DC
    features U(0, 1) / 255 (a grey ball, as the program's init draws it),
    isotropic log-scales from the 3 nearest neighbours, identity rotations,
    opacity logit of
    `init_opacity`, zero higher SH and background."""
    kw = dict(generator=gen, device=device)
    phi = torch.rand((n,), **kw) * 2 * math.pi
    cos_t = torch.rand((n,), **kw) * 2 - 1
    r = radius * torch.rand((n,), **kw) ** (1.0 / 3.0)
    sin_t = torch.sqrt(1 - cos_t * cos_t)
    pts = torch.stack([r * sin_t * torch.cos(phi), r * sin_t * torch.sin(phi), r * cos_t], -1)
    dc = torch.rand((n, 3), **kw) / 255.0
    k = (sh_degree + 1) ** 2
    xyz = torch.zeros((capacity, 3), device=device)
    xyz[:n] = pts
    fdc = torch.zeros((capacity, 1, 3), device=device)
    fdc[:n, 0] = dc
    scaling = torch.zeros((capacity, 3), device=device)
    scaling[:n] = knn_log_scales(pts)[:, None]
    rotation = torch.zeros((capacity, 4), device=device)
    rotation[:, 0] = 1.0
    opacity = torch.full((capacity, 1), math.log(init_opacity / (1 - init_opacity)),
                         device=device)
    return dict(xyz=xyz, features_dc=fdc,
                features_rest=torch.zeros((capacity, k - 1, 3), device=device),
                scaling=scaling, rotation=rotation, opacity=opacity,
                background=torch.zeros((3,), device=device))
