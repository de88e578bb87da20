"""Optional point-e text-to-point-cloud initializer, port of the JAX
package's utils/pointe.py (reference: utils/pointe_utils.py:13-73,
base40M-textvec + upsampler, optional Cap3D-finetuned checkpoints).

point-e is an optional external torch package. When it, or its weights,
is unavailable the object initializer falls back to the ball init
(models/init.py). Nothing is downloaded: the weights must already lie in
point-e's cache directory.

Fault of the reference, kept: whatever `variant` names, the base model is
always base40M-textvec (the Cap3D checkpoints of POINTE_MODELS are never
loaded), as in the JAX package.
"""

from __future__ import annotations

import os

import numpy as np
import torch

POINTE_MODELS = {
    "pointe": "base40M-textvec",
    "pointe_330k": "pointE_FT_330k",   # Cap3D finetune (reference: 33-46)
    "pointe_825k": "pointE_FT_825k",
}


def init_from_pointe(prompt: str, variant: str = "pointe", device="cpu"):
    """text -> (xyz [4096,3], rgb [4096,3] in [0,1]) on `device`.

    Needs the `point_e` package and its cached checkpoints; raises
    (ImportError, FileNotFoundError) when they are absent, and callers fall
    back to the ball initializer."""
    from point_e.diffusion.configs import DIFFUSION_CONFIGS, diffusion_from_config
    from point_e.diffusion.sampler import PointCloudSampler
    from point_e.models.configs import MODEL_CONFIGS, model_from_config
    from point_e.models.download import MODEL_PATHS, default_cache_dir

    def load_cached(name):
        # where point-e's own loader would download, raise
        path = os.path.join(default_cache_dir(), MODEL_PATHS[name].split("/")[-1])
        if not os.path.exists(path):
            raise FileNotFoundError(f"point-e checkpoint {name} is not at {path} "
                                    "(nothing is downloaded)")
        return torch.load(path, map_location=device)

    device = torch.device(device)
    base_name = "base40M-textvec"
    base_model = model_from_config(MODEL_CONFIGS[base_name], device)
    base_model.eval()
    base_diffusion = diffusion_from_config(DIFFUSION_CONFIGS[base_name])
    upsampler_model = model_from_config(MODEL_CONFIGS["upsample"], device)
    upsampler_model.eval()
    upsampler_diffusion = diffusion_from_config(DIFFUSION_CONFIGS["upsample"])
    base_model.load_state_dict(load_cached(base_name))
    upsampler_model.load_state_dict(load_cached("upsample"))

    sampler = PointCloudSampler(
        device=device,
        models=[base_model, upsampler_model],
        diffusions=[base_diffusion, upsampler_diffusion],
        num_points=[1024, 4096 - 1024],
        aux_channels=["R", "G", "B"],
        guidance_scale=[3.0, 0.0],
        model_kwargs_key_filter=("texts", ""),
    )
    samples = None
    for x in sampler.sample_batch_progressive(batch_size=1, model_kwargs=dict(texts=[prompt])):
        samples = x
    pc = sampler.output_to_point_clouds(samples)[0]
    xyz = np.asarray(pc.coords, np.float32)
    rgb = np.stack([pc.channels["R"], pc.channels["G"], pc.channels["B"]],
                   axis=1).astype(np.float32)
    return xyz, rgb
