"""The scene step in the port (`scene_step`, plain versions on the CPU)
against the JAX package's jitted `SceneTrainer._scene_step_fn` (Pallas
kernels in interpret mode), on one tiny scene (32x32, two placed objects,
a tiny env and floor, SH degree 1 everywhere): the same state (carried
across by `convert.scene_model`), guidance weights (`convert.py`),
cameras, ladder, ladder noise and the JAX step's own VAE posterior draw,
recomputed from its key. One stage-1 guidance step (env trainable), once
more with the depth ControlNet conditioning the ladder, and one stage-3
recon step (every model trainable, the objects at the fine lrs).

Tolerances: loss rtol 1e-4; n_entries / n_dropped equal; each trainable
model's gradient per parameter group (read from Adam's first moment, 0.1*g
after one step) relative L2 <= 1e-3; params after Adam on rows with
|g| > 1e-3*max|g| at atol 1e-6; densification stats sliced per model:
denom and max radii equal, gradient accumulator relative L2 <= 1e-3;
models that do not train are returned unchanged.

The host side is held separately: the same seeds give the same cameras,
as_latent, ladders, background draws, ControlNet gates, flips, learning
rates and entry capacity in the JAX trainer's `_run_scene_step` order.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dreamscene_tpu.guidance import mtsd as jm
from dreamscene_tpu.models import gaussians as JG
from dreamscene_tpu.models import ply as JP
from dreamscene_tpu.models.gaussians import group_lrs as j_group_lrs
from dreamscene_tpu.training import object_trainer as jot
from dreamscene_tpu.training import scene_trainer as jst
from dreamscene_tpu.utils.config import ParamsGroups as JCfg
from dreamscene_tpu_torch import convert
from dreamscene_tpu_torch.cameras import Camera as TCamera
from dreamscene_tpu_torch.training import object_trainer as tot
from dreamscene_tpu_torch.training import scene_trainer as tst
from dreamscene_tpu_torch.utils.config import ParamsGroups as TCfg
from tests.test_torch_controlnet import jax_cn_guidance, port_mods

torch.set_num_threads(1)

FIELDS = ["xyz", "features_dc", "features_rest", "scaling", "rotation", "opacity"]
ENV_DENSITY = 0.0002      # env 5 x 80 points, floor 60


def tiny_scene_cfg(cfg):
    cfg.log = {"exp_name": "t"}
    for opt in (cfg.sceneOptimizationParams, cfg.reconSceneOptimizationParams,
                cfg.fineSceneOptimizationParams):
        opt.iterations = 4
        opt.densify_from_iter = 1 << 30
    cfg.guidanceParams.C_batch_size = 2
    cfg.sceneGenerateCamParams.image_w = cfg.sceneGenerateCamParams.image_h = 32
    cfg.generateCamParams.image_w = cfg.generateCamParams.image_h = 32
    cfg.mode_args = {}
    cfg.scene_configs = {
        "objects": [],
        "scene": {
            "sh_degree": 1, "cam_pose_method": "indoor", "scene_text": "a room",
            "negative_text": "", "zero_ground": True, "compress_objects": False,
            "floor_init_color": [240, 240, 244], "env_init_color": [255, 80, 80],
            "radius": [3.5, 2.5, 5.0],
            "scene_composition": [
                {"id": "a", "params": [{"center": [-1.0, 1.0, 0.0], "rotation": [0.0, 0.0, 30.0],
                                        "scale": [1.5, 1.5, 1.5]}]},
                {"id": "b", "params": [{"center": [1.5, -0.5, 0.0], "rotation": [0.0, 0.0, 0.0],
                                        "scale": [1.0, 1.0, 1.0]}]},
            ],
        },
    }
    return cfg


def write_objects(ckpt_path, ids=("a", "b")):
    """Two trained-looking objects (varied opacity, colour, rest-SH, scale
    and rotation)
    as final PLYs: object_task would skip them."""
    for i, oid in enumerate(ids):
        rng = np.random.RandomState(10 + i)
        pts = (rng.randn(60, 3) * 0.3).astype(np.float32)
        st = JG.create_from_points(pts, rng.rand(60, 3).astype(np.float32), sh_degree=1,
                                   capacity=60)
        p = st.params
        p = dataclasses.replace(
            p, opacity=jnp.asarray(np.asarray(p.opacity) + rng.randn(60, 1).astype(np.float32)),
            features_rest=jnp.asarray(0.2 * rng.randn(60, 3, 3).astype(np.float32)),
            scaling=jnp.asarray(np.asarray(p.scaling) + 0.3 * rng.randn(60, 3).astype(np.float32)),
            rotation=jnp.asarray(np.asarray(p.rotation)
                                 + 0.3 * rng.randn(60, 4).astype(np.float32)))
        JP.save_splat_ply(str(ckpt_path / f"{oid}_final_model.ply"),
                          dataclasses.replace(st, params=p))


def rel_l2(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def make_trained_looking(tr):
    """Degree 1 active on the JAX trainer's env and floor, with rest-SH and
    varied opacities, scales and rotations."""
    rng = np.random.RandomState(3)
    for name in ("env", "floor"):
        st = getattr(tr.scene, name)
        p = st.params
        p = dataclasses.replace(
            p, features_rest=jnp.asarray(0.2 * rng.randn(*p.features_rest.shape)
                                         .astype(np.float32)),
            opacity=jnp.asarray(np.asarray(p.opacity)
                                + 2.0 * rng.randn(*p.opacity.shape).astype(np.float32)),
            # anisotropic and rotated (isotropic splats get no rotation
            # gradient), and shrunk to the few-pixel footprints the init has at
            # full density: at this density its splats span most of the image,
            # where last-ulp exp differences flip the 1/255 alpha cut on many
            # edge pixels and the scale gradients of the JAX kernel, the golden
            # renderer and the port drift ~1e-2 apart
            scaling=jnp.asarray(np.asarray(p.scaling) + np.log(0.2).astype(np.float32)
                                + 0.4 * rng.randn(*p.scaling.shape).astype(np.float32)),
            rotation=jnp.asarray(np.asarray(p.rotation)
                                 + 0.3 * rng.randn(*p.rotation.shape).astype(np.float32)))
        setattr(tr.scene, name, dataclasses.replace(st, params=p, active_sh_degree=1))


@pytest.fixture(scope="module")
def jax_trainer(tmp_path_factory):
    root = tmp_path_factory.mktemp("jax")
    tr = jst.SceneTrainer(tiny_scene_cfg(JCfg()), exp_root=str(root), interpret=True,
                          env_density=ENV_DENSITY)
    write_objects(tr.ckpt_path)
    tr.prepare_train_scene()
    make_trained_looking(tr)
    return tr


@pytest.fixture(scope="module")
def cn_guidance():
    return jax_cn_guidance()


@pytest.mark.parametrize("stage", ["stage 1: env, guidance", "stage 3: all, recon",
                                   "stage 1: env, guidance, controlnet"])
def test_scene_step_matches_jax(jax_trainer, cn_guidance, stage):
    """The controlnet case conditions the ladder on the ControlNet with the
    flipped disparities in both packages."""
    jtr = jax_trainer
    use_cn = stage.endswith("controlnet")
    guidance = jtr.guidance
    if use_cn:
        jtr.guidance = cn_guidance
    try:
        _scene_step_matches_jax(jtr, stage, use_cn)
    finally:
        jtr.guidance = guidance


def _scene_step_matches_jax(jtr, stage, use_cn):
    guidance_on = stage.startswith("stage 1")
    names = list(jtr.scene.objects)
    trainable = (tuple([False] * len(names) + [False, True]) if guidance_on
                 else tuple([True] * (len(names) + 2)))
    cams = jtr.cams_loader.Stage1_Indoor(size=8)[:2 if guidance_on else 1]
    hold_scene_step(jtr, names, trainable, cams, guidance_on, scene_optim=not guidance_on,
                    ladder=[230, 470], use_cn=use_cn)


def hold_scene_step(jtr, names, trainable, cams, guidance_on, scene_optim, ladder,
                    use_cn=False):
    """One step of the JAX trainer's jitted `_scene_step_fn` on the visible
    objects `names` (then floor, env) against the port's `scene_step` on
    the same state and inputs, held at the tolerances above. The lrs are the
    trainer's: the objects' from fineSceneOptimizationParams with
    `scene_optim`, the rest from the stage's parameters."""
    states = jtr._states(names)
    optp = (jtr.cfg.sceneOptimizationParams if guidance_on
            else jtr.cfg.reconSceneOptimizationParams)
    c_batch = len(cams)
    rng = np.random.default_rng(7)
    text_emb, _ = jot.assemble_text_embeddings(jtr.embeddings, cams)
    ladder = np.asarray(ladder, np.int32)
    lat_shape = jtr.guidance.latent_shape(c_batch, 32, 32)
    noise = rng.standard_normal(lat_shape).astype(np.float32)
    vae_key = jax.random.key(3)
    vae_eps = np.asarray(jax.random.normal(vae_key, lat_shape, jnp.float32))
    bg = np.asarray([[0.2, 0.3, 0.4], [0.0, 0.0, 0.0]][:c_batch], np.float32)
    gt = rng.uniform(0, 1, (c_batch, 3, 32, 32)).astype(np.float32)
    fine = jtr.cfg.fineSceneOptimizationParams
    lrs_list = [j_group_lrs(fine if (i < len(names) and scene_optim) else optp,
                            s.spatial_lr_scale, 1) for i, s in enumerate(states)]
    flip, as_latent = guidance_on, False
    capacities = tuple(s.capacity for s in states)
    degrees = tuple(s.active_sh_degree for s in states)
    step = jtr._scene_step_fn(len(ladder), len(states), capacities, degrees, trainable,
                              guidance_on, c_batch, use_cn, 4)
    j_params, j_opt, j_aux, j_loss, j_nent, j_ndrop = step(
        tuple(s.params for s in states), tuple(s.opt for s in states),
        tuple(s.aux for s in states), jtr._cam_stack(cams), jnp.asarray(bg), text_emb,
        jnp.asarray(ladder), jnp.asarray(noise), vae_key, jnp.asarray(flip),
        jnp.asarray(as_latent),
        [{k: jnp.asarray(v, jnp.float32) for k, v in lrs.items()} for lrs in lrs_list],
        jnp.asarray(gt), jm.mods_params(jtr.guidance.mods))

    tscene = convert.scene_model(jtr.scene)
    tstates = [tscene.objects[n].state for n in names] + [tscene.floor, tscene.env]
    mods = port_mods(jtr.guidance.mods)
    assert (mods.controlnet is not None) == use_cn

    def port_step(cn):
        return tst.scene_step(
            tstates, trainable, mods,
            tot.camera_tensors([TCamera(**dataclasses.asdict(c)) for c in cams], "cpu"),
            bg.tolist(), torch.from_numpy(np.array(text_emb)), [int(t) for t in ladder],
            torch.from_numpy(noise), torch.from_numpy(vae_eps), flip, as_latent, lrs_list,
            torch.from_numpy(gt), width=32, height=32, capacity=4 * sum(capacities) // 2,
            guidance_on=guidance_on, lambda_tv=optp.lambda_tv,
            lambda_tv_depth=optp.lambda_tv_depth, lambda_scale=optp.lambda_scale,
            guidance_scale=jtr.guidance_opt.guidance_scale,
            lambda_guidance=jtr.guidance_opt.lambda_guidance, use_cn=cn)

    res = port_step(use_cn)
    np.testing.assert_allclose(float(res["loss"]), float(j_loss), rtol=1e-4)
    if use_cn:      # the hint moves the loss well beyond the tolerance
        assert abs(float(port_step(False)["loss"]) / float(j_loss) - 1) > 1e-2
    assert int(res["n_entries"]) == int(j_nent) > 0
    assert int(res["n_dropped"]) == int(j_ndrop)
    for m, tr in enumerate(trainable):
        if not tr:
            assert res["grads"][m] is None
            for f in FIELDS:
                assert res["params"][m][f] is tstates[m].params[f]
            continue
        for f in FIELDS:
            jmu = np.asarray(getattr(j_opt[m].mu, f))
            tmu = res["opt"][m].mu[f].numpy()
            assert np.abs(jmu).max() > 0, (m, f)
            assert rel_l2(tmu, jmu) <= 1e-3, (m, f, rel_l2(tmu, jmu))
            np.testing.assert_allclose(res["grads"][m][f].numpy() * 0.1, tmu, rtol=1e-5,
                                       atol=1e-12)
            g = np.abs(jmu)
            big = g > 1e-3 * g.max()
            np.testing.assert_allclose(res["params"][m][f].numpy()[big],
                                       np.asarray(getattr(j_params[m], f))[big], atol=1e-6,
                                       err_msg=f"{m} {f}")
        np.testing.assert_array_equal(res["aux"][m]["denom"].numpy(), np.asarray(j_aux[m].denom))
        np.testing.assert_array_equal(res["aux"][m]["max_radii2d"].numpy(),
                                      np.asarray(j_aux[m].max_radii2d))
        assert float(res["aux"][m]["denom"].sum()) > 0
        assert rel_l2(res["aux"][m]["xyz_gradient_accum"].numpy(),
                      np.asarray(j_aux[m].xyz_gradient_accum)) <= 1e-3


def test_host_sampling_matches_jax_trainer(tmp_path, monkeypatch):
    """Both trainers build the same scene from the same PLYs and seeds;
    two stage-1 steps and one recon step then hand their steps the same
    cameras, background rows, prompt rows, ladders, flips, as_latent, lrs
    and entry capacity (the JAX step is replaced by a recorder, the port's
    `scene_step` likewise)."""
    assert host_sampling_matches(tmp_path, monkeypatch, with_cn=False) == [False] * 3


def test_host_sampling_matches_jax_trainer_controlnet(tmp_path, monkeypatch):
    """The same with a ControlNet loaded and use_control_net_iter passed:
    the gate is drawn only for guidance steps, between the ladder and the
    flip on the guidance's generator, in both trainers."""
    used = host_sampling_matches(tmp_path, monkeypatch, with_cn=True, n_stage1=5)
    assert not used[0] and any(used[1:-1]) and not all(used[1:-1]) and not used[-1], used


def host_sampling_matches(tmp_path, monkeypatch, with_cn: bool, n_stage1: int = 2) -> list:
    """`n_stage1` stage-1 steps and one recon step of both trainers,
    compared step by step; returns the ControlNet gate of each step."""
    from dreamscene_tpu_torch.guidance import mtsd as tm

    jcfg, tcfg = tiny_scene_cfg(JCfg()), tiny_scene_cfg(TCfg())
    jcfg.sceneOptimizationParams.use_control_net_iter = 1
    tcfg.sceneOptimizationParams.use_control_net_iter = 1
    jtr = jst.SceneTrainer(jcfg, exp_root=str(tmp_path / "j"), interpret=True,
                           env_density=ENV_DENSITY, guidance=(
                               jm.make_tiny_guidance(jcfg.guidanceParams, with_controlnet=True)
                               if with_cn else None))
    ttr = tst.SceneTrainer(tcfg, exp_root=str(tmp_path / "t"), device="cpu",
                           env_density=ENV_DENSITY, guidance=(
                               tm.make_tiny_guidance(tcfg.guidanceParams, with_controlnet=True,
                                                     device="cpu") if with_cn else None))
    write_objects(jtr.ckpt_path)
    write_objects(ttr.ckpt_path)
    jtr.prepare_train_scene()
    ttr.prepare_train_scene()
    seen_j, seen_t = [], []
    j_recorder, t_recorder = step_recorders(jtr, ttr, seen_j, seen_t)
    jtr._scene_step_fn = j_recorder
    monkeypatch.setattr(tst, "scene_step", t_recorder)
    for tr in (jtr, ttr):
        tr.iters = 4
        cams = tr._stage1_cams(2 * n_stage1)
        for i in range(n_stage1):
            tr.scene_train_step(cams[2 * i:2 * i + 2], "env")
        gt = (jnp.zeros((3, 32, 32)) if tr is jtr else torch.zeros((3, 32, 32)))
        tr._run_scene_step(cams[:1], "all", False, True, 1.0, guidance_on=False,
                           gt_images=[gt], optp=tr.cfg.reconSceneOptimizationParams)
    assert len(seen_j) == len(seen_t) == n_stage1 + 1
    assert_same_steps(seen_j, seen_t)
    assert seen_t[0]["trainable"] == (False, False, False, True)
    assert seen_t[-1]["trainable"] == (True,) * 4
    return [r["use_cn"] for r in seen_t]


def step_recorders(jtr, ttr, seen_j, seen_t):
    """Stand-ins for the JAX trainer's `_scene_step_fn` and the port's
    `scene_step` that record what each step is handed (views, background
    and prompt rows, ladder, flip, as_latent, trainable mask, lrs, entry
    capacity, ControlNet gate, model count, the guidance's stage and jump
    ranges) into `seen_j` / `seen_t` and return the states unchanged."""
    def j_recorder(n_rungs, n_models, capacities, degrees, trainable, guidance_on, c_batch,
                   use_cn=False, cap_mult=4):
        def step(params_list, opt_list, aux_list, cam_stack, bg_stack, text_emb, ladder_ts,
                 noise, vae_key, flip, as_latent, lrs_list, gt, mod_params):
            seen_j.append(dict(
                view=np.asarray(cam_stack["view"]), bg=np.asarray(bg_stack),
                text=np.asarray(text_emb), ladder=np.asarray(ladder_ts).tolist(),
                flip=bool(flip), as_latent=bool(as_latent), trainable=trainable,
                lrs=[{k: np.float32(v) for k, v in lrs.items()} for lrs in lrs_list],
                capacity=int(cap_mult * sum(capacities)) // 2, use_cn=use_cn,
                n_models=n_models, ranges=(jtr.guidance.stage_range, jtr.guidance.jump_range)))
            z = jnp.zeros((), jnp.int32)
            return params_list, opt_list, aux_list, jnp.zeros(()), z, z
        return step

    def t_recorder(states, trainable, mods, cams, bg_rows, text_emb, ladder, noise, vae_eps,
                   flip, as_latent, lrs_list, gt_images=None, **kw):
        seen_t.append(dict(
            view=np.stack([c["viewmatrix"].numpy() for c in cams]),
            bg=np.asarray(bg_rows, np.float32), text=text_emb.numpy(), ladder=list(ladder),
            flip=bool(flip), as_latent=bool(as_latent), trainable=trainable,
            lrs=[{k: np.float32(v) for k, v in lrs.items()} for lrs in lrs_list],
            capacity=kw["capacity"], use_cn=kw["use_cn"], n_models=len(states),
            ranges=(ttr.guidance.stage_range, ttr.guidance.jump_range)))
        z = torch.zeros((), dtype=torch.int32)
        return dict(params=[s.params for s in states], opt=[s.opt for s in states],
                    aux=[s.aux for s in states], loss=torch.zeros(()), n_entries=z,
                    n_dropped=z, n_rows=sum(s.capacity for s in states))

    return j_recorder, t_recorder


def assert_same_steps(seen_j, seen_t):
    """Every recorded step of the two trainers handed the same inputs."""
    for i, (want, got) in enumerate(zip(seen_j, seen_t, strict=True)):
        np.testing.assert_array_equal(got["view"], want["view"])
        np.testing.assert_array_equal(got["bg"], want["bg"])
        np.testing.assert_array_equal(got["text"], want["text"])
        for k in ("ladder", "use_cn", "flip", "as_latent", "trainable", "lrs", "capacity",
                  "n_models", "ranges"):
            assert got[k] == want[k], (i, k)
