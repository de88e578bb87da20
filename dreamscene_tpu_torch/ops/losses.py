"""Image-space losses, torch (port of dreamscene_tpu/ops/losses.py;
reference: utils/system_utils.py:39-127). Images are NCHW."""

from __future__ import annotations

import torch


def tv_loss(x: torch.Tensor) -> torch.Tensor:
    """Total-variation loss on NCHW images (reference: system_utils.py:39-48)."""
    b, c, h, w = x.shape
    count_h = c * (h - 1) * w
    count_w = c * h * (w - 1)
    h_tv = torch.square(x[:, :, 1:, :] - x[:, :, :-1, :]).sum()
    w_tv = torch.square(x[:, :, :, 1:] - x[:, :, :, :-1]).sum()
    return 2.0 * (h_tv / count_h + w_tv / count_w) / b


def l2_loss(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    return torch.square(pred - gt).mean()
