"""Media output: orbit videos and image grids (port of
dreamscene_tpu/utils/media.py; reference training/object_trainer.py:81-118
video_inference and the guidance debug grids).

imageio writes the files when it is installed and can encode them;
otherwise the frames are kept as `<path>.npz` and a grid as `<path>.npy`,
as the JAX package does.
"""

from __future__ import annotations

import logging
import os

import numpy as np

logger = logging.getLogger("dreamscene_tpu_torch")


def write_video(path: str, frames: list[np.ndarray], fps: int = 30) -> bool:
    """Frames [H,W,3] uint8 -> mp4; returns False when it fell back to npz."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    try:
        import imageio

        imageio.mimwrite(path, frames, fps=fps, quality=8)
        return True
    except Exception as e:  # no imageio, or no codec
        logger.warning("video write failed (%s); dumping npz instead", e)
        np.savez_compressed(path + ".npz", frames=np.stack(frames))
        return False


def save_image_grid(path: str, images: list[np.ndarray]) -> None:
    """Stack [3,H,W] float images horizontally and save as jpg/png (or
    `<path>.npy` without imageio)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    imgs = [np.clip(np.transpose(i, (1, 2, 0)), 0, 1) for i in images]
    grid = (np.concatenate(imgs, axis=1) * 255).astype(np.uint8)
    try:
        import imageio

        imageio.imwrite(path, grid)
    except Exception:
        np.save(path + ".npy", grid)
