"""Image-space losses, torch (port of dreamscene_tpu/ops/losses.py;
reference: utils/system_utils.py:39-127). Images are NCHW."""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


def tv_loss(x: torch.Tensor) -> torch.Tensor:
    """Total-variation loss on NCHW images (reference: system_utils.py:39-48)."""
    b, c, h, w = x.shape
    count_h = c * (h - 1) * w
    count_w = c * h * (w - 1)
    h_tv = torch.square(x[:, :, 1:, :] - x[:, :, :-1, :]).sum()
    w_tv = torch.square(x[:, :, :, 1:] - x[:, :, :, :-1]).sum()
    return 2.0 * (h_tv / count_h + w_tv / count_w) / b


def l1_loss(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    return torch.abs(pred - gt).mean()


def l2_loss(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    return torch.square(pred - gt).mean()


def safe_normalize(x: torch.Tensor, eps: float = 1e-20) -> torch.Tensor:
    return x / torch.sqrt(torch.clamp_min((x * x).sum(-1, keepdim=True), eps))


@functools.lru_cache(maxsize=None)
def _gaussian_window(window_size: int, sigma: float) -> np.ndarray:
    """The normalised 2-D Gaussian window, built in float64, cast to float32."""
    g = np.exp(-((np.arange(window_size) - window_size // 2) ** 2) / (2.0 * sigma**2))
    g /= g.sum()
    return np.outer(g, g).astype(np.float32)


def ssim(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11,
         size_average: bool = True) -> torch.Tensor:
    """SSIM on NCHW images with an 11x11 Gaussian window, sigma 1.5
    (reference: system_utils.py:86-126), as a depthwise convolution.
    `size_average` gives the mean over everything, else one value per image
    (the mean over C, H, W)."""
    channel = img1.shape[-3]
    w = torch.as_tensor(_gaussian_window(window_size, 1.5), dtype=img1.dtype,
                        device=img1.device)
    kernel = w[None, None].expand(channel, 1, window_size, window_size)
    pad = window_size // 2

    def conv(x):
        return F.conv2d(x, kernel, padding=pad, groups=channel)

    mu1, mu2 = conv(img1), conv(img2)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = conv(img1 * img1) - mu1_sq
    sigma2_sq = conv(img2 * img2) - mu2_sq
    sigma12 = conv(img1 * img2) - mu1_mu2

    c1, c2 = 0.01**2, 0.03**2
    ssim_map = ((2 * mu1_mu2 + c1) * (2 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2))
    if size_average:
        return ssim_map.mean()
    return ssim_map.mean(dim=(1, 2, 3))
