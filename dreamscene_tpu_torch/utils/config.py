"""Typed config system: structured defaults <- YAML <- CLI dotlist.

Re-implements the reference's OmegaConf three-level merge (reference:
main.py:17-27) over the same dataclass schema (reference: config.py:5-245)
without the OmegaConf dependency: `load_config` merges a YAML file and
"a.b.c=value" dotlist overrides onto the dataclass defaults with type
coercion. The five separately-tunable OptimizationParams groups
(object/recon/scene/reconScene/fineScene) are preserved (SURVEY.md §5).

Device fields from the CUDA build (data_device/g_device) are kept for
config-file compatibility but ignored — the TPU build runs renderer and
guidance in one jitted program on the same mesh.
"""

from __future__ import annotations

import copy
import dataclasses
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import yaml


@dataclass
class ModelParams:
    # reference: config.py:6-23
    pretrained_model_path: Optional[str] = None
    workspace: str = "debug"
    batch: int = 10
    data_device: str = "tpu"
    eval: bool = False
    opt_path: Optional[str] = None
    # render-time augmentation ratios
    sh_deg_aug_ratio: float = 0.1
    bg_aug_ratio: float = 0.5
    shs_aug_ratio: float = 0.0
    scale_aug_ratio: float = 1.0


@dataclass
class OptimizationParams:
    # reference: config.py:27-76
    iterations: int = 2000
    position_lr_init: float = 0.00016
    position_lr_final: float = 0.0000016
    position_lr_delay_mult: float = 0.01
    position_lr_max_steps: int = 30_000
    feature_lr: float = 0.0050
    feature_lr_final: float = 0.0030
    opacity_lr: float = 0.05
    scaling_lr: float = 0.005
    rotation_lr: float = 0.001
    geo_iter: int = 0
    as_latent_ratio: float = 0.2
    scaling_lr_final: float = 0.001
    rotation_lr_final: float = 0.0002
    percent_dense: float = 0.003
    densify_grad_threshold: float = 0.00075
    lambda_tv: float = 1.0
    lambda_bin: float = 10.0
    lambda_scale: float = 1.0
    lambda_sat: float = 1.0
    lambda_radius: float = 1.0
    lambda_depth: float = 1.0
    lambda_tv_depth: float = 1.0
    densification_interval: int = 100
    opacity_reset_interval: int = 300
    densify_from_iter: int = 100
    densify_until_iter: int = 3000
    use_control_net_iter: int = 10000000
    use_progressive: bool = False
    progressive_view_iter: int = 500
    progressive_view_init_ratio: float = 0.2
    scale_up_cameras_iter: int = 500
    scale_up_factor: float = 0.95
    fovy_scale_up_factor: List[float] = field(default_factory=lambda: [0.75, 1.1])
    phi_scale_up_factor: float = 1.5
    max_point_number: int = 1200000
    only_recon_stage: bool = False
    style_prompt: str = ""
    style_negative_prompt: str = ""


@dataclass
class PipelineParams:
    # reference: config.py:80-83
    convert_SHs_python: bool = False
    compute_cov3D_python: bool = False
    debug: bool = False


@dataclass
class GenerateCamParams:
    # reference: config.py:87-116
    radius_range: List[float] = field(default_factory=lambda: [5.2, 5.5])
    max_radius_range: List[float] = field(default_factory=lambda: [3.5, 5.0])
    default_radius: float = 3.5
    theta_range: List[float] = field(default_factory=lambda: [45, 105])
    max_theta_range: List[float] = field(default_factory=lambda: [45, 105])
    phi_range: List[float] = field(default_factory=lambda: [-180, 180])
    max_phi_range: List[float] = field(default_factory=lambda: [-180, 180])
    fovy_range: List[float] = field(default_factory=lambda: [0.32, 0.60])
    max_fovy_range: List[float] = field(default_factory=lambda: [0.16, 0.60])
    rand_cam_gamma: float = 1.0
    angle_overhead: float = 30
    angle_front: float = 60
    render_45: bool = True
    uniform_sphere_rate: float = 0
    image_w: int = 512
    image_h: int = 512
    SSAA: int = 1
    default_polar: float = 90
    default_azimuth: float = 0
    default_fovy: float = 0.55
    jitter_pose: bool = True
    jitter_center: float = 0.05
    jitter_target: float = 0.05
    jitter_up: float = 0.01
    device: str = "tpu"


@dataclass
class ParallelParams:
    """Mesh layout for multi-chip training (no reference counterpart —
    the reference's only 'distribution' is a second CUDA device for SD,
    SURVEY.md §2 parallelism inventory; the TPU build defines the
    parallelism itself). dp shards the C_batch camera batch + guidance
    ladder; tp shards image tile-bands (and, with shard_splats, the
    splat axis: params/Adam state/projection split 1/tp, projected
    records all_gathered, grads psum_scattered back over ICI)."""
    dp: int = 1
    tp: int = 1
    shard_splats: bool = False


@dataclass
class GuidanceParams:
    # reference: config.py:120-166
    random_delta: bool = False
    guidance: str = "MTSD"
    g_device: str = "tpu"
    model_key: Optional[str] = None
    is_safe_tensor: bool = False
    base_model_key: Optional[str] = None
    controlnet_model_key: Optional[str] = None
    # probability the depth ControlNet conditions a step once
    # use_control_net_iter has passed. The reference trainers read this
    # field (object_trainer.py:347) but never declare it in config.py —
    # and the loaded controlnet is never invoked (multitime_sd_utils.py:
    # 88-91 is its only reference); here the hook is functional.
    controlnet_ratio: float = 0.5
    # Perp-Neg surface: VERIFIED DEAD in the reference — config.py:133-136
    # declares these and scene_trainer.py:41-48 builds perp_neg_f_*
    # weight tables, but nothing in the MTSD guidance path ever reads
    # either (grep: no other occurrence of perpneg/negative_w/
    # front_decay_factor/side_decay_factor/perp_neg_f). Kept only so
    # reference YAMLs parse; the values have no effect, as upstream.
    perpneg: bool = True
    negative_w: float = -2.0
    front_decay_factor: float = 2.0
    side_decay_factor: float = 10.0
    vram_O: bool = False
    fp16: bool = True
    hf_key: Optional[str] = None
    t_range: List[float] = field(default_factory=lambda: [0.02, 0.5])
    max_t_range: float = 0.98
    num_train_timesteps: Optional[int] = None
    fix_noise: bool = False
    noise_seed: int = 0
    delta_t: int = 80
    annealing_intervals: bool = True
    text: str = ""
    inverse_text: str = ""
    textual_inversion_path: Optional[str] = None
    # VERIFIED DEAD upstream: multitime_sd_utils.py:55 accepts LoRA_path
    # but never reads it (no loader call anywhere). Kept for YAML compat.
    LoRA_path: Optional[str] = None
    negative: str = ""
    guidance_scale: float = 7.5
    denoise_guidance_scale: float = 1.0
    lambda_guidance: float = 1.0
    xs_eta: float = 0.0
    C_batch_size: int = 4
    vis_interval: int = 100
    stage_refine_t: int = 125


@dataclass
class ObjectParams:
    # reference: config.py:210-226
    id: str = ""
    sh_degree: int = 3
    text: str = ""
    negative_text: str = ""
    image: str = ""
    init_guided: str = "pointe"
    init_prompt: str = ""
    cam_pose_method: str = "object"
    use_pointe_rgb: bool = False
    num_pts: int = 20000
    radius: float = 0.5


@dataclass
class ParamsGroups:
    # reference: config.py:170-206
    outdir: str = "logs"
    batch_size: int = 1
    H: int = 800
    W: int = 800
    visualize_samples: bool = False
    only_render: bool = False
    modelParams: ModelParams = field(default_factory=ModelParams)
    optimizationParams: OptimizationParams = field(default_factory=OptimizationParams)
    reconOptimizationParams: OptimizationParams = field(default_factory=OptimizationParams)
    sceneOptimizationParams: OptimizationParams = field(default_factory=OptimizationParams)
    reconSceneOptimizationParams: OptimizationParams = field(default_factory=OptimizationParams)
    fineSceneOptimizationParams: OptimizationParams = field(default_factory=OptimizationParams)
    pipelineParams: PipelineParams = field(default_factory=PipelineParams)
    generateCamParams: GenerateCamParams = field(default_factory=GenerateCamParams)
    sceneGenerateCamParams: GenerateCamParams = field(default_factory=GenerateCamParams)
    guidanceParams: GuidanceParams = field(default_factory=GuidanceParams)
    parallelParams: ParallelParams = field(default_factory=ParallelParams)
    editParams: Optional[Dict] = None
    seed: int = 0
    log: Optional[Dict] = None
    scene_configs: Optional[Dict] = None
    mode_args: Optional[Dict] = None


@dataclass
class ObjectsParamsGroups:
    # reference: config.py:229-245
    batch_size: int = 1
    H: int = 800
    W: int = 800
    visualize_samples: bool = False
    modelParams: ModelParams = field(default_factory=ModelParams)
    optimizationParams: OptimizationParams = field(default_factory=OptimizationParams)
    reconOptimizationParams: OptimizationParams = field(default_factory=OptimizationParams)
    pipelineParams: PipelineParams = field(default_factory=PipelineParams)
    generateCamParams: GenerateCamParams = field(default_factory=GenerateCamParams)
    guidanceParams: GuidanceParams = field(default_factory=GuidanceParams)
    parallelParams: ParallelParams = field(default_factory=ParallelParams)
    objectParams: ObjectParams = field(default_factory=ObjectParams)
    seed: int = 0
    log: Optional[Dict] = None
    mode_args: Optional[Dict] = None


# --------------------------------------------------------------------------
# merge engine
# --------------------------------------------------------------------------

def _coerce(value, target):
    """Coerce a YAML/CLI value to the type of the existing default."""
    if target is None or value is None:
        return value
    if isinstance(target, bool):
        if isinstance(value, str):
            return value.lower() in ("1", "true", "yes", "on")
        return bool(value)
    if isinstance(target, int) and not isinstance(target, bool):
        return int(float(value)) if not isinstance(value, (list, dict)) else value
    if isinstance(target, float):
        return float(value)
    return value


def merge_into(obj, updates: dict):
    """Recursively merge a dict into a dataclass instance (in place)."""
    for key, val in updates.items():
        if not hasattr(obj, key):
            setattr(obj, key, val)  # permissive like OmegaConf non-struct keys
            continue
        cur = getattr(obj, key)
        if dataclasses.is_dataclass(cur) and isinstance(val, dict):
            merge_into(cur, val)
        elif isinstance(cur, dict) and isinstance(val, dict):
            merged = copy.deepcopy(cur)
            merged.update(val)
            setattr(obj, key, merged)
        else:
            setattr(obj, key, _coerce(val, cur))
    return obj


def apply_dotlist(obj, dotlist: list[str]):
    """Apply "a.b.c=value" CLI overrides (values parsed as YAML)."""
    for item in dotlist:
        if "=" not in item:
            raise ValueError(f"bad override (want key=value): {item}")
        key, _, raw = item.partition("=")
        val = yaml.safe_load(raw)
        parts = key.strip().split(".")
        tgt = obj
        for p in parts[:-1]:
            tgt = getattr(tgt, p) if not isinstance(tgt, dict) else tgt[p]
        merge_into(tgt, {parts[-1]: val}) if not isinstance(tgt, dict) else tgt.update(
            {parts[-1]: val}
        )
    return obj


def load_config(path: str | None, dotlist: list[str] | None = None,
                object_mode: bool = False):
    """defaults <- YAML file <- dotlist (reference: main.py:17-27)."""
    cfg = ObjectsParamsGroups() if object_mode else ParamsGroups()
    if path:
        with open(path) as f:
            data = yaml.safe_load(f) or {}
        merge_into(cfg, data)
    if dotlist:
        apply_dotlist(cfg, dotlist)
    return cfg
