"""The slice as a whole: one object FPS step in the JAX package
(`ObjectTrainer._fps_step_fn`, Pallas kernels in interpret mode) and in the
port (`fps_step`, plain versions on the CPU) on the same tiny config,
state, guidance weights (carried across by `convert.py`), cameras,
ladder, ladder noise and the JAX step's own random draws (VAE posterior
eps and per-camera SH/scale noise, recomputed here with jax.random from
the same key as mtsd.py:106 and object_trainer.py:326-334 draw them).

Tolerances: loss rtol 1e-4; each parameter group's gradient (read from
Adam's first moment, 0.1*g after one step) relative L2 <= 1e-3; params
after Adam on rows with |g| > 1e-3*max|g| at atol 1e-6 (Adam's first
step is lr*sign(g) and flips on noise-level gradients); densification
stats: denom and max radii equal, gradient accumulator relative L2
<= 1e-3.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dreamscene_tpu.cameras import sampling as JS
from dreamscene_tpu.guidance import mtsd as jm
from dreamscene_tpu.models.gaussians import group_lrs as j_group_lrs
from dreamscene_tpu.training import object_trainer as jot
from dreamscene_tpu.utils.config import ObjectsParamsGroups as JCfg
from dreamscene_tpu_torch import convert
from dreamscene_tpu_torch.cameras import Camera as TCamera
from dreamscene_tpu_torch.guidance import sd_modules as sdm
from dreamscene_tpu_torch.training import object_trainer as tot

# One intra-op thread: the suite runs several worker processes at once, and
# one OpenMP team of all cores per worker makes these small tensors wait on
# each other (the six heaviest files of the port took 205 s on 8 cores with
# 6 workers, 66 s with one thread each).
torch.set_num_threads(1)

FIELDS = ["xyz", "features_dc", "features_rest", "scaling", "rotation", "opacity"]


def tiny_cfg(cfg):
    cfg.log = {"exp_name": "t"}
    cfg.objectParams.id = "obj1"
    cfg.objectParams.init_guided = "default"
    cfg.objectParams.num_pts = 40
    cfg.objectParams.sh_degree = 1
    cfg.objectParams.text = "a thing"
    cfg.optimizationParams.iterations = 3
    cfg.optimizationParams.densify_from_iter = 1 << 30
    cfg.optimizationParams.max_point_number = 400
    cfg.guidanceParams.C_batch_size = 2
    cfg.generateCamParams.image_w = 32
    cfg.generateCamParams.image_h = 32
    cfg.mode_args = {}
    return cfg


def np_tree(t):
    return jax.tree.map(np.asarray, t)


def rel_l2(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.fixture(scope="module")
def jax_trainer(tmp_path_factory):
    tr = jot.ObjectTrainer(tiny_cfg(JCfg()), exp_root=str(tmp_path_factory.mktemp("jax")),
                           interpret=True)
    tr.prepare_train()
    # a state with varied opacities, colours and rest-SH, degree 1 active
    rng = np.random.RandomState(1)
    p = np_tree(tr.state.params)
    p = dataclasses.replace(
        tr.state.params,
        opacity=jnp.asarray(p.opacity + rng.randn(*p.opacity.shape).astype(np.float32)),
        features_dc=jnp.asarray(p.features_dc
                                + 0.5 * rng.randn(*p.features_dc.shape).astype(np.float32)),
        features_rest=jnp.asarray(0.2 * rng.randn(*p.features_rest.shape).astype(np.float32)),
        rotation=jnp.asarray(p.rotation + 0.3 * rng.randn(*p.rotation.shape).astype(np.float32)),
        scaling=jnp.asarray(p.scaling + 0.5),
    )
    tr.state = dataclasses.replace(tr.state, params=p, active_sh_degree=1)
    return tr


@pytest.mark.parametrize("flip,as_latent", [(True, False), (False, True)])
def test_fps_step_matches_jax(jax_trainer, flip, as_latent):
    jtr = jax_trainer
    st = jtr.state
    c_batch, n = 2, st.capacity
    rng = np.random.default_rng(7)
    cameras = [JS.load_random_cam(rng, jtr.pose_args, ssaa=True) for _ in range(c_batch)]
    text_emb, _ = jot.assemble_text_embeddings(jtr.embeddings, cameras)
    ladder = np.asarray([230, 470], np.int32)
    lat_shape = jtr.guidance.latent_shape(c_batch, 32, 32)
    noise = rng.standard_normal(lat_shape).astype(np.float32)
    aug = np.asarray([[0.2, 0.3, 0.4, 0.0, 1.0, 1.0],
                      [0.0, 0.0, 0.0, 1.0, 1.0, 1.0]], np.float32)
    vae_key = jax.random.key(3)
    lrs = j_group_lrs(jtr.optim, st.spatial_lr_scale, 1)
    capacity = jtr.cap_ctrl.capacity(max(n, 4096))
    step = jtr._fps_step_fn(len(ladder), capacity, c_batch, st.active_sh_degree)
    j_params, j_opt, j_aux, j_loss, j_nent, j_ndrop = step(
        st.params, st.opt, st.aux, jtr._cam_stack(cameras), jnp.asarray(aug), text_emb,
        jnp.asarray(ladder), jnp.asarray(noise), vae_key, jnp.asarray(flip),
        jnp.asarray(as_latent), {k: jnp.asarray(v, jnp.float32) for k, v in lrs.items()},
        jm.mods_params(jtr.guidance.mods))

    # the JAX step's own draws, recomputed from the same key
    vae_eps = np.asarray(jax.random.normal(vae_key, lat_shape, jnp.float32))
    k = st.params.features_dc.shape[1] + st.params.features_rest.shape[1]
    shs_noise, scale_noise = [], []
    for i in range(c_batch):
        k1, k2 = jax.random.split(jax.random.fold_in(vae_key, i + 1))
        shs_noise.append(np.asarray(jax.random.normal(k1, (n, k, 3))))
        scale_noise.append(np.asarray(jax.random.normal(k2, (n, 3))))

    ucfg, vcfg = sdm.tiny_unet_config(), sdm.tiny_vae_config()
    mods = convert.guidance_modules(
        convert.unet_state_dict(np_tree(jtr.guidance.mods.unet_params), ucfg),
        convert.vae_encoder_state_dict(np_tree(jtr.guidance.mods.vae_encode_params), vcfg),
        convert.vae_decoder_state_dict(np_tree(jtr.guidance.mods.vae_decode_params), vcfg),
        ucfg, vcfg)
    aux_np = {f.name: np.asarray(getattr(st.aux, f.name)) for f in dataclasses.fields(st.aux)}
    params_np = {f.name: np.asarray(getattr(st.params, f.name))
                 for f in dataclasses.fields(st.params)}
    zeros = {k_: np.zeros_like(v) for k_, v in params_np.items()}
    tstate = convert.gaussian_state(params_np, aux_np, zeros, zeros, 0, st.sh_degree,
                                    st.active_sh_degree, st.spatial_lr_scale)
    tcams = tot.camera_tensors([TCamera(**dataclasses.asdict(c)) for c in cameras], "cpu")
    optim = jtr.optim
    res = tot.fps_step(
        tstate, mods, tcams, aug.tolist(), torch.from_numpy(np.asarray(text_emb)),
        [int(t) for t in ladder], torch.from_numpy(noise), torch.from_numpy(vae_eps),
        torch.from_numpy(np.stack(shs_noise)), torch.from_numpy(np.stack(scale_noise)),
        flip, as_latent, lrs, width=32, height=32, capacity=capacity,
        active_deg=st.active_sh_degree, lambda_tv=optim.lambda_tv,
        lambda_scale=optim.lambda_scale, guidance_scale=jtr.guidance_opt.guidance_scale,
        lambda_guidance=jtr.guidance_opt.lambda_guidance)

    np.testing.assert_allclose(float(res["loss"]), float(j_loss), rtol=1e-4)
    assert int(res["n_entries"]) == int(j_nent)
    assert int(res["n_dropped"]) == int(j_ndrop)
    for f in FIELDS:
        jmu = np.asarray(getattr(j_opt.mu, f))
        tmu = res["opt"].mu[f].numpy()
        assert np.abs(jmu).max() > 0, f
        assert rel_l2(tmu, jmu) <= 1e-3, (f, rel_l2(tmu, jmu))
        g = np.abs(jmu)
        big = g > 1e-3 * g.max()
        np.testing.assert_allclose(res["params"][f].numpy()[big],
                                   np.asarray(getattr(j_params, f))[big], atol=1e-6,
                                   err_msg=f)
    np.testing.assert_array_equal(res["aux"]["denom"].numpy(), np.asarray(j_aux.denom))
    np.testing.assert_array_equal(res["aux"]["max_radii2d"].numpy(),
                                  np.asarray(j_aux.max_radii2d))
    assert rel_l2(res["aux"]["xyz_gradient_accum"].numpy(),
                  np.asarray(j_aux.xyz_gradient_accum)) <= 1e-3


def test_host_sampling_matches_jax_trainer(tmp_path):
    """Cameras, augmentation flags, ladders, flips, as_latent, lrs and the
    entry capacity come from the same numpy generators in the same order
    as the JAX trainer's train_step (its jitted step is replaced by a
    recorder here)."""
    from dreamscene_tpu_torch.utils.config import ObjectsParamsGroups as TCfg

    jtr = jot.ObjectTrainer(tiny_cfg(JCfg()), exp_root=str(tmp_path / "j"), interpret=True)
    jtr.prepare_train()
    seen = []

    def recorder(n_rungs, capacity, c_batch, active_deg, use_cn=False):
        def step(params, opt, aux, cam_stack, aug, text_emb, ladder_ts, *rest):
            seen.append(dict(cams=np_tree(cam_stack), aug=np.asarray(aug),
                             text=np.asarray(text_emb), ladder=np.asarray(ladder_ts),
                             flip=bool(rest[2]), as_latent=bool(rest[3]),
                             lrs={k: float(v) for k, v in rest[4].items()},
                             capacity=capacity))
            return params, opt, aux, jnp.zeros(()), jnp.zeros((), jnp.int32), \
                jnp.zeros((), jnp.int32)
        return step

    jtr._fps_step_fn = recorder
    ttr = tot.ObjectTrainer(tiny_cfg(TCfg()), exp_root=str(tmp_path / "t"), device="cpu")
    ttr.prepare_train()
    for _ in range(3):
        jtr.train_step()
        got = ttr.step_inputs()
        want = seen[-1]
        for i, cam in enumerate(got["cams"]):
            for key, jkey in (("viewmatrix", "view"), ("projmatrix", "proj"),
                              ("campos", "campos")):
                np.testing.assert_array_equal(cam[key].numpy(), want["cams"][jkey][i])
            assert np.float32(cam["tanfovx"]) == want["cams"]["tanfovx"][i]
        np.testing.assert_array_equal(np.asarray(got["aug"], np.float32), want["aug"])
        np.testing.assert_array_equal(got["text_emb"].numpy(), want["text"])
        assert got["ladder"] == want["ladder"].tolist()
        assert (got["flip"], got["as_latent"]) == (want["flip"], want["as_latent"])
        assert {k: np.float32(v) for k, v in got["lrs"].items()} == \
            {k: np.float32(v) for k, v in want["lrs"].items()}
        assert got["capacity"] == want["capacity"]


def test_train_step_runs_and_unported_branches_raise(tmp_path):
    """train_step runs, and the branches that raised before object
    generation was ported now run: densify/prune, opacity reset, the
    guidance viz and the step-1500 importance filter."""
    from dreamscene_tpu_torch.models.gaussians import num_active
    from dreamscene_tpu_torch.utils.config import ObjectsParamsGroups as TCfg

    cfg = tiny_cfg(TCfg())
    tr = tot.ObjectTrainer(cfg, exp_root=str(tmp_path), device="cpu")
    tr.prepare_train()
    xyz0 = tr.state.params["xyz"].clone()
    assert np.isfinite(tr.train_step())
    assert not torch.equal(tr.state.params["xyz"], xyz0)
    assert tr.last_stats["n_entries"] > 0
    assert tr.state.aux["denom"].sum() > 0
    cfg.optimizationParams.densify_from_iter = 1
    cfg.optimizationParams.densification_interval = 2
    cfg.optimizationParams.opacity_reset_interval = 2
    cfg.guidanceParams.vis_interval = 2
    assert np.isfinite(tr.train_step())
    assert float(tr.state.aux["denom"].sum()) == 0.0          # densify_and_prune ran
    assert float(tr.state.get_opacity.max()) <= 0.01 + 1e-6    # opacity reset ran
    assert list((tr.vis_path).glob("obj1_iter_2_vd_*"))         # guidance viz ran
    n0 = num_active(tr.state)
    tr.step = 1499
    cfg.optimizationParams.iterations = 1500
    cfg.optimizationParams.densify_from_iter = 1 << 30
    cfg.optimizationParams.opacity_reset_interval = cfg.guidanceParams.vis_interval = 7
    assert np.isfinite(tr.train_step())                         # step 1500: filter
    assert num_active(tr.state) < n0
