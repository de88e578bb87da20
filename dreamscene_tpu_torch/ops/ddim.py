"""DDIM diffusion schedule + step math, torch (port of
dreamscene_tpu/ops/ddim.py; reference: guidance/sd_step.py:31-295).

`ddim_step` takes an arbitrary `delta_timestep`, including negative ones
(DDIM inversion, as Formation Pattern Sampling's ladder uses). Defaults
are Stable Diffusion's scaled-linear betas over 1000 timesteps.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class DiffusionSchedule(NamedTuple):
    alphas_cumprod: torch.Tensor       # [T] f32
    final_alpha_cumprod: torch.Tensor  # [] f32
    num_train_timesteps: int
    prediction_type: str               # "epsilon" | "v_prediction" | "sample"


def make_schedule(num_train_timesteps: int = 1000, beta_start: float = 0.00085,
                  beta_end: float = 0.012, beta_schedule: str = "scaled_linear",
                  prediction_type: str = "epsilon", set_alpha_to_one: bool = False,
                  device="cpu") -> DiffusionSchedule:
    if beta_schedule == "scaled_linear":
        betas = np.linspace(beta_start**0.5, beta_end**0.5, num_train_timesteps) ** 2
    elif beta_schedule == "linear":
        betas = np.linspace(beta_start, beta_end, num_train_timesteps)
    else:
        raise ValueError(beta_schedule)
    alphas_cumprod = np.cumprod(1.0 - betas).astype(np.float32)
    final = np.float32(1.0) if set_alpha_to_one else alphas_cumprod[0]
    return DiffusionSchedule(
        alphas_cumprod=torch.as_tensor(alphas_cumprod, device=device),
        final_alpha_cumprod=torch.as_tensor(final, device=device),
        num_train_timesteps=num_train_timesteps,
        prediction_type=prediction_type,
    )


def _expand(x, like):
    return x.reshape((-1,) + (1,) * (like.dim() - 1))


def _alpha_at(sched: DiffusionSchedule, t):
    """alphas_cumprod[t], with t < 0 mapping to final_alpha_cumprod."""
    t = torch.as_tensor(t, device=sched.alphas_cumprod.device)
    a = sched.alphas_cumprod[torch.clamp(t, 0, sched.num_train_timesteps - 1).long()]
    return torch.where(t >= 0, a, sched.final_alpha_cumprod)


def add_noise(sched: DiffusionSchedule, sample, noise, t):
    """x_t = sqrt(ac_t) x_0 + sqrt(1-ac_t) eps."""
    ac = _expand(_alpha_at(sched, t), sample)
    return torch.sqrt(ac) * sample + torch.sqrt(1.0 - ac) * noise


def pred_original(sched: DiffusionSchedule, model_output, t, sample):
    """x_0-hat from the model output (SD does not clip samples)."""
    ac = _expand(_alpha_at(sched, t), sample)
    bp = 1.0 - ac
    if sched.prediction_type == "epsilon":
        return (sample - torch.sqrt(bp) * model_output) / torch.sqrt(ac)
    if sched.prediction_type == "sample":
        return model_output
    if sched.prediction_type == "v_prediction":
        return torch.sqrt(ac) * sample - torch.sqrt(bp) * model_output
    raise ValueError(sched.prediction_type)


def _get_variance(sched: DiffusionSchedule, t, prev_t):
    ac_t = _alpha_at(sched, t)
    ac_p = _alpha_at(sched, prev_t)
    return ((1.0 - ac_p) / (1.0 - ac_t)) * (1.0 - ac_t / ac_p)


def ddim_step(sched: DiffusionSchedule, model_output, t, sample, delta_timestep,
              eta: float = 0.0, variance_noise=None):
    """Generalized DDIM update x_t -> x_{t - delta}; negative delta runs the
    chain upward (inversion). Returns (prev_sample, pred_original)."""
    dev = sample.device
    t = torch.as_tensor(t, device=dev)
    prev_t = t - torch.as_tensor(delta_timestep, device=dev)
    ac_t = _expand(_alpha_at(sched, t), sample)
    ac_p = _expand(_alpha_at(sched, prev_t), sample)
    bp_t = 1.0 - ac_t
    if sched.prediction_type == "epsilon":
        x0 = (sample - torch.sqrt(bp_t) * model_output) / torch.sqrt(ac_t)
        eps = model_output
    elif sched.prediction_type == "sample":
        x0 = model_output
        eps = (sample - torch.sqrt(ac_t) * x0) / torch.sqrt(bp_t)
    elif sched.prediction_type == "v_prediction":
        x0 = torch.sqrt(ac_t) * sample - torch.sqrt(bp_t) * model_output
        eps = torch.sqrt(ac_t) * model_output + torch.sqrt(bp_t) * sample
    else:
        raise ValueError(sched.prediction_type)
    variance = torch.abs(_get_variance(sched, t, prev_t))
    std_dev_t = eta * _expand(variance, sample)
    std_dev_t = torch.sqrt(torch.minimum((1.0 - ac_p) / 2.0, std_dev_t))
    direction = torch.sqrt(torch.clamp_min(1.0 - ac_p - std_dev_t**2, 0.0)) * eps
    prev_sample = torch.sqrt(ac_p) * x0 + direction
    if eta > 0 and variance_noise is not None:
        prev_sample = prev_sample + std_dev_t * variance_noise
    return torch.nan_to_num(prev_sample), x0
