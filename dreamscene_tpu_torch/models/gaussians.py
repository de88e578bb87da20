"""Gaussian splat model state with a fixed capacity + masked Adam, torch.

Port of dreamscene_tpu/models/gaussians.py. A model holds a static
capacity C of rows and an `active` mask; parameters, Adam moments and
bookkeeping are plain dicts of tensors whose first axis is C. The
optimizer is the same hand-rolled Adam (eps 1e-15, the reference's
torch.optim.Adam setting) with one shared step count; inactive rows are
frozen.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from dreamscene_tpu_torch.ops.sh import RGB2SH

PARAM_FIELDS = ("xyz", "features_dc", "features_rest", "scaling", "rotation",
                "opacity", "background")
GROUP_OF_FIELD = {
    "xyz": "xyz",
    "features_dc": "f_dc",
    "features_rest": "f_rest",
    "scaling": "scaling",
    "rotation": "rotation",
    "opacity": "opacity",
    "background": "background",
}


@dataclasses.dataclass
class AdamState:
    count: int                 # shared step count
    mu: dict
    nu: dict


@dataclasses.dataclass
class GaussianState:
    """params: raw (pre-activation) tensors keyed by PARAM_FIELDS
    (xyz [C,3], features_dc [C,1,3], features_rest [C,K-1,3], scaling
    [C,3] log-scale, rotation [C,4] wxyz, opacity [C,1] logit,
    background [3]); aux: active [C] bool, max_radii2d, xyz_gradient_accum,
    denom [C] f32."""

    params: dict
    aux: dict
    opt: AdamState
    sh_degree: int = 3
    active_sh_degree: int = 0
    spatial_lr_scale: float = 1.0

    @property
    def get_scaling(self):
        return torch.exp(self.params["scaling"])

    @property
    def get_rotation(self):
        q = self.params["rotation"]
        return q / torch.linalg.norm(q, dim=-1, keepdim=True)

    @property
    def get_xyz(self):
        return self.params["xyz"]

    @property
    def get_opacity(self):
        return torch.sigmoid(self.params["opacity"])

    @property
    def get_background(self):
        return torch.sigmoid(self.params["background"])

    @property
    def get_features(self):
        return torch.cat([self.params["features_dc"], self.params["features_rest"]], dim=1)

    @property
    def capacity(self) -> int:
        return self.params["xyz"].shape[0]

    @property
    def device(self) -> torch.device:
        return self.params["xyz"].device

    def one_up_sh_degree(self) -> "GaussianState":
        if self.active_sh_degree < self.sh_degree:
            return dataclasses.replace(self, active_sh_degree=self.active_sh_degree + 1)
        return self


def num_active(state: GaussianState) -> int:
    return int(state.aux["active"].sum())


def mean_sq_dist_to_3nn(points: np.ndarray) -> np.ndarray:
    """Mean squared distance to the 3 nearest neighbours (the reference's
    distCUDA2), exact, through scipy's cKDTree."""
    from scipy.spatial import cKDTree

    tree = cKDTree(points)
    d, _ = tree.query(points, k=4, workers=-1)   # self + 3 NN
    return (d[:, 1:] ** 2).mean(axis=1)


def adam_init(params: dict) -> AdamState:
    return AdamState(count=0,
                     mu={k: torch.zeros_like(v) for k, v in params.items()},
                     nu={k: torch.zeros_like(v) for k, v in params.items()})


def create_from_points(points: np.ndarray, colors: np.ndarray, sh_degree: int = 3,
                       capacity: int | None = None, spatial_lr_scale: float = 1.0,
                       init_opacity: float = 0.1, device="cpu") -> GaussianState:
    """Build a model from a coloured point cloud: DC features from
    RGB2SH, isotropic log-scales from sqrt(mean sq dist to 3NN), identity
    rotations, opacity logit of `init_opacity`."""
    n = points.shape[0]
    if capacity is None:
        capacity = int(n * 1.5) + 1024
    capacity = max(capacity, n)
    k = (sh_degree + 1) ** 2

    dist2 = np.maximum(mean_sq_dist_to_3nn(points.astype(np.float64)), 1e-7)
    log_scales = np.log(np.sqrt(dist2)).astype(np.float32)
    xyz = np.zeros((capacity, 3), np.float32)
    xyz[:n] = points
    fdc = np.zeros((capacity, 1, 3), np.float32)
    fdc[:n, 0] = RGB2SH(np.asarray(colors, np.float32))
    scaling = np.zeros((capacity, 3), np.float32)
    scaling[:n] = log_scales[:, None]
    rotation = np.zeros((capacity, 4), np.float32)
    rotation[:, 0] = 1.0
    opacity = np.full((capacity, 1), float(np.log(init_opacity / (1 - init_opacity))),
                      np.float32)

    def t(a):
        return torch.as_tensor(a, device=device)

    params = dict(
        xyz=t(xyz), features_dc=t(fdc),
        features_rest=torch.zeros((capacity, k - 1, 3), device=device),
        scaling=t(scaling), rotation=t(rotation), opacity=t(opacity),
        background=torch.zeros((3,), device=device),
    )
    aux = dict(
        active=torch.arange(capacity, device=device) < n,
        max_radii2d=torch.zeros((capacity,), device=device),
        xyz_gradient_accum=torch.zeros((capacity,), device=device),
        denom=torch.zeros((capacity,), device=device),
    )
    return GaussianState(params=params, aux=aux, opt=adam_init(params),
                         sh_degree=sh_degree, active_sh_degree=0,
                         spatial_lr_scale=spatial_lr_scale)


@torch.no_grad()
def adam_update(params: dict, grads: dict, opt: AdamState, active: torch.Tensor,
                lrs: dict, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-15):
    """One Adam step with per-group lrs; inactive rows are frozen.
    Returns (new params, new AdamState); tensors are fresh."""
    count = opt.count + 1
    c1 = float(np.float32(1.0) - np.float32(b1) ** np.float32(count))
    c2 = float(np.float32(1.0) - np.float32(b2) ** np.float32(count))
    new_p, new_mu, new_nu = {}, {}, {}
    for field in PARAM_FIELDS:
        p, g = params[field], grads[field]
        m, v = opt.mu[field], opt.nu[field]
        lr = lrs[GROUP_OF_FIELD[field]]
        if field != "background":
            mask = active.reshape((-1,) + (1,) * (p.dim() - 1)).to(p.dtype)
            g = g * mask
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        update = (m / c1) / (torch.sqrt(v / c2) + eps)
        if field != "background":
            update = update * mask
        new_p[field] = p - lr * update
        new_mu[field] = m
        new_nu[field] = v
    return new_p, AdamState(count=count, mu=new_mu, nu=new_nu)


def get_expon_lr_func(lr_init, lr_final, lr_delay_steps=0, lr_delay_mult=1.0,
                      max_steps=1000000):
    """Exponential-decay lr schedule (reference: gs_renderer.py:56-77)."""

    def helper(step):
        if lr_init == lr_final:
            return lr_init
        if step < 0 or (lr_init == 0.0 and lr_final == 0.0):
            return 0.0
        if lr_delay_steps > 0:
            delay_rate = lr_delay_mult + (1 - lr_delay_mult) * np.sin(
                0.5 * np.pi * np.clip(step / lr_delay_steps, 0, 1))
        else:
            delay_rate = 1.0
        t = np.clip(step / max_steps, 0, 1)
        log_lerp = np.exp(np.log(lr_init) * (1 - t) + np.log(lr_final) * t)
        return float(delay_rate * log_lerp)

    return helper


def group_lrs(opt_args, spatial_lr_scale: float, step: int) -> dict:
    """Per-group lrs at `step` (reference: gs_renderer.py:612-711)."""
    iters = opt_args.iterations
    mult = opt_args.position_lr_delay_mult
    xyz_sched = get_expon_lr_func(opt_args.position_lr_init * spatial_lr_scale,
                                  opt_args.position_lr_final * spatial_lr_scale,
                                  lr_delay_mult=mult, max_steps=iters)
    feat_sched = get_expon_lr_func(opt_args.feature_lr, opt_args.feature_lr_final,
                                   lr_delay_mult=mult, max_steps=iters)
    rot_sched = get_expon_lr_func(opt_args.rotation_lr, opt_args.rotation_lr_final,
                                  lr_delay_mult=mult, max_steps=iters)
    scale_sched = get_expon_lr_func(opt_args.scaling_lr, opt_args.scaling_lr_final,
                                    lr_delay_mult=mult, max_steps=iters)
    return {
        "xyz": xyz_sched(step),
        "f_dc": feat_sched(step),
        "f_rest": opt_args.feature_lr / 20.0,
        "opacity": opt_args.opacity_lr,
        "scaling": scale_sched(step),
        "rotation": rot_sched(step),
        "background": opt_args.feature_lr,
    }
