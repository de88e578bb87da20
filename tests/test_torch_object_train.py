"""The parts of object generation: the port's densify/prune, camera rigs,
object/score renders, importance filter, refine step and PLY I/O against
the JAX package on the same seeded numpy inputs (Pallas kernels in
interpret mode, the port's plain versions on the CPU). `train()` and the
CLI run end to end in tests/test_torch_object_e2e.py, a file of its own so
that a run that hands whole files to its workers can spread the two.

Tolerances: integer and boolean outputs (active masks, slot allocation,
camera rigs, PLY bytes) and the prune / opacity-reset / resize results
are equal; densified params atol 1e-6 with the same split draws; renders atol 1e-5 / rtol 1e-4 (the rasterizer suite's);
importance scores atol 1e-5 of their max; the refine step's loss rtol 1e-4 and per-group gradients (read from
Adam's first moment after one step) relative L2 <= 1e-3.
"""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dreamscene_tpu import rendering as JR
from dreamscene_tpu.cameras import sampling as JS
from dreamscene_tpu.models import densify as JD
from dreamscene_tpu.models import gaussians as JG
from dreamscene_tpu.models import ply as JP
from dreamscene_tpu.training import object_trainer as JOT
from dreamscene_tpu.training.filtering import importance_filter as j_importance_filter
from dreamscene_tpu.utils.config import ObjectsParamsGroups as JCfg
from dreamscene_tpu_torch import convert
from dreamscene_tpu_torch import rendering as TR
from dreamscene_tpu_torch.cameras import Camera as TCamera
from dreamscene_tpu_torch.cameras import sampling as TS
from dreamscene_tpu_torch.models import densify as TD
from dreamscene_tpu_torch.models import gaussians as TG
from dreamscene_tpu_torch.models import ply as TP
from dreamscene_tpu_torch.training import object_trainer as TOT
from dreamscene_tpu_torch.training.filtering import importance_filter as t_importance_filter
from dreamscene_tpu_torch.utils.config import GenerateCamParams, ObjectsParamsGroups as TCfg

# One intra-op thread: the suite runs several worker processes at once, and
# one OpenMP team of all cores per worker makes these small tensors wait on
# each other (the six heaviest files of the port took 205 s on 8 cores with
# 6 workers, 66 s with one thread each).
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
FIELDS = ["xyz", "features_dc", "features_rest", "scaling", "rotation", "opacity"]


def jax_state(n=60, capacity=100, seed=0, sh_degree=1):
    """A JAX GaussianState with varied params and densification stats."""
    rng = np.random.RandomState(seed)
    pts = (rng.rand(n, 3) - 0.5).astype(np.float32)
    cols = rng.rand(n, 3).astype(np.float32)
    st = JG.create_from_points(pts, cols, sh_degree=sh_degree, capacity=capacity)
    p = st.params
    c = capacity
    small = rng.rand(c) < 0.5
    scaling = np.where(small[:, None], np.log(0.004), np.log(0.05)).astype(np.float32)
    scaling = scaling + 0.1 * rng.randn(c, 3).astype(np.float32)
    p = dataclasses.replace(
        p, scaling=jnp.asarray(scaling),
        opacity=jnp.asarray(rng.randn(c, 1).astype(np.float32) * 2 - 1),
        rotation=jnp.asarray(rng.randn(c, 4).astype(np.float32)),
        features_rest=jnp.asarray(0.2 * rng.randn(*p.features_rest.shape).astype(np.float32)))
    aux = dataclasses.replace(
        st.aux, xyz_gradient_accum=jnp.asarray(rng.rand(c).astype(np.float32) * 4e-3),
        denom=jnp.asarray(rng.randint(0, 4, c).astype(np.float32)),
        max_radii2d=jnp.asarray(rng.rand(c).astype(np.float32) * 40))
    mu = jax.tree.map(lambda x: jnp.asarray(rng.randn(*x.shape).astype(np.float32)), p)
    nu = jax.tree.map(lambda x: jnp.asarray(rng.rand(*x.shape).astype(np.float32)), p)
    return dataclasses.replace(st, params=p, aux=aux, opt=JG.AdamState(jnp.asarray(3), mu, nu),
                               active_sh_degree=sh_degree)


def fields(x):
    return {f.name: np.asarray(getattr(x, f.name)) for f in dataclasses.fields(x)}


def to_port(st):
    return convert.gaussian_state(fields(st.params), fields(st.aux), fields(st.opt.mu),
                                  fields(st.opt.nu), int(st.opt.count), st.sh_degree,
                                  st.active_sh_degree, st.spatial_lr_scale)


def assert_state_equal(t, j, atol=0.0):
    np.testing.assert_array_equal(t.aux["active"].numpy(), np.asarray(j.aux.active))
    for group, jt in (("params", j.params), ("mu", j.opt.mu), ("nu", j.opt.nu)):
        td = {"params": t.params, "mu": t.opt.mu, "nu": t.opt.nu}[group]
        for k, v in fields(jt).items():
            np.testing.assert_allclose(td[k].numpy(), v, atol=atol, rtol=0, err_msg=(group, k))
    for k, v in fields(j.aux).items():
        np.testing.assert_array_equal(t.aux[k].numpy(), v, err_msg=k)
    assert t.capacity == j.capacity and t.opt.count == int(j.opt.count)


@pytest.mark.parametrize("max_screen_size,hot_scale", [(None, 1.0), (20.0, 3.0)])
def test_densify_and_prune_matches_jax(max_screen_size, hot_scale):
    """Clone + split + prune; the second case selects more splats than
    there are free slots, so the allocation drops some."""
    jst = jax_state()
    jst = dataclasses.replace(jst, aux=dataclasses.replace(
        jst.aux, xyz_gradient_accum=jst.aux.xyz_gradient_accum * hot_scale))
    key = jax.random.key(11)
    args = (0.002, 0.005, 1.0, max_screen_size, 0.01)
    jout = JD.densify_and_prune(jst, key, *args)
    eps = np.asarray(jax.random.normal(key, (jst.capacity, 2, 3), jnp.float32))
    tout = TD.densify_and_prune(to_port(jst), torch.from_numpy(eps), *args)
    n0, n1 = int(jst.aux.active.sum()), int(jout.aux.active.sum())
    assert n0 != n1
    assert_state_equal(tout, jout, atol=1e-6)


@pytest.mark.parametrize("op", ["prune_only", "prune_only_screen", "reset_opacity",
                                "prune_by_importance", "resize"])
def test_state_ops_match_jax(op):
    jst = jax_state(seed=1)
    tst = to_port(jst)
    if op == "prune_only":
        jout, tout = JD.prune_only(jst, 0.3, 1.0, None), TD.prune_only(tst, 0.3, 1.0, None)
    elif op == "prune_only_screen":
        jout, tout = JD.prune_only(jst, 0.3, 1.0, 20.0), TD.prune_only(tst, 0.3, 1.0, 20.0)
    elif op == "reset_opacity":
        jout, tout = JD.reset_opacity(jst), TD.reset_opacity(tst)
    elif op == "prune_by_importance":
        score = np.random.RandomState(2).rand(jst.capacity).astype(np.float32)
        jout = JD.prune_by_importance(jst, 0.3, jnp.asarray(score))
        tout = TD.prune_by_importance(tst, 0.3, torch.from_numpy(score))
    else:
        jout, tout = JG.resize(jst, 160), TG.resize(tst, 160)
    assert_state_equal(tout, jout)


def _cams_equal(tcams, jcams):
    assert len(tcams) == len(jcams)
    for t, j in zip(tcams, jcams):
        for k, v in dataclasses.asdict(j).items():
            np.testing.assert_array_equal(np.asarray(getattr(t, k)), np.asarray(v), err_msg=k)


def test_camera_rigs_match_jax():
    opt = GenerateCamParams(image_w=32, image_h=32)
    _cams_equal(TS.load_circle_cam(opt, size=6), JS.load_circle_cam(opt, size=6))
    _cams_equal(TS.load_clip_cam(opt, size=5), JS.load_clip_cam(opt, size=5))
    _cams_equal(TS.load_sphere_cam(np.random.default_rng(3), opt, size=7),
                JS.load_sphere_cam(np.random.default_rng(3), opt, size=7))
    _cams_equal(TS.load_reco_cam(opt, (4, 12, 14, 6), (100, 85, 75, 55), scale=0.9),
                JS.load_reco_cam(opt, (4, 12, 14, 6), (100, 85, 75, 55), scale=0.9))
    for theta in (-80, -50, 0, 30, 70):
        for phi in (-170, -100, -20, 0, 40, 120, 179):
            for radius in (1.0, 3.5):
                assert TS.get_dir_ind(theta, phi, radius) == JS.get_dir_ind(theta, phi, radius)


@pytest.fixture(scope="module")
def render_state():
    jst = jax_state(n=80, capacity=120, seed=4)
    p = jst.params
    # a compact cloud in front of the default cameras
    aniso = 0.3 * np.random.RandomState(5).randn(*p.scaling.shape).astype(np.float32)
    p = dataclasses.replace(p, xyz=p.xyz * 1.5, scaling=jnp.asarray(np.log(0.06) + aniso),
                            opacity=jnp.abs(p.opacity))
    return dataclasses.replace(jst, params=p)


def test_object_and_score_render_match_jax(render_state):
    opt = GenerateCamParams(image_w=32, image_h=32)
    jcam = JS.load_reco_cam(opt, scale=0.9)[5]
    tcam = TCamera(**dataclasses.asdict(jcam))
    tst = to_port(render_state)
    jo = JR.object_render(render_state, jcam, bg_color=(0.2, 0.3, 0.4), test=True,
                          interpret=True)
    to = TR.object_render(tst, tcam, bg_color=(0.2, 0.3, 0.4), test=True)
    for k in ("image", "depth", "raw_depth", "alpha"):
        np.testing.assert_allclose(to[k].detach().numpy(), np.asarray(jo[k]), atol=1e-5,
                                   rtol=1e-4, err_msg=k)
    js = JR.score_render(render_state, jcam, interpret=True)
    ts = TR.score_render(tst, tcam)
    want = np.asarray(js["important_score"])
    assert want.max() > 0
    np.testing.assert_allclose(ts["important_score"].numpy(), want, atol=1e-5 * want.max())
    np.testing.assert_allclose(ts["image"].numpy(), np.asarray(js["image"]), atol=1e-5,
                               rtol=1e-4)


def test_importance_filter_matches_jax(render_state):
    opt = GenerateCamParams(image_w=32, image_h=32)
    jout = j_importance_filter(render_state, np.random.default_rng(5), opt, n_views=3,
                               interpret=True)
    tout = t_importance_filter(to_port(render_state), np.random.default_rng(5), opt, n_views=3)
    assert int(jout.aux.active.sum()) < int(render_state.aux.active.sum())
    np.testing.assert_array_equal(tout.aux["active"].numpy(), np.asarray(jout.aux.active))


def _tiny_cfg(cfg, **over):
    cfg.log = {"exp_name": "t"}
    cfg.objectParams.id = "obj1"
    cfg.objectParams.init_guided = "default"
    cfg.objectParams.num_pts = 40
    cfg.objectParams.sh_degree = 1
    cfg.objectParams.text = "a thing"
    cfg.optimizationParams.iterations = 3
    cfg.optimizationParams.max_point_number = 400
    cfg.guidanceParams.C_batch_size = 2
    cfg.generateCamParams.image_w = 32
    cfg.generateCamParams.image_h = 32
    cfg.mode_args = {}
    for k, v in over.items():
        group, name = k.split("__")
        setattr(getattr(cfg, group), name, v)
    return cfg


def test_recon_step_matches_jax(tmp_path, render_state):
    jtr = JOT.ObjectTrainer(_tiny_cfg(JCfg()), exp_root=str(tmp_path / "j"), interpret=True,
                            state=render_state)
    st = render_state
    jcam = JS.load_reco_cam(jtr.pose_args, scale=0.9)[3]
    gt = np.random.default_rng(8).random((3, 32, 32)).astype(np.float32)
    lrs = JG.group_lrs(jtr.recon_optim, st.spatial_lr_scale, 7)
    zero = jax.tree.map(jnp.zeros_like, st.params)
    opt0 = JG.AdamState(jnp.zeros((), jnp.int32), zero, zero)
    cap = jtr.cap_ctrl.capacity(st.capacity)
    step = jtr._recon_step_fn(cap, st.active_sh_degree)
    jp, jopt, jaux, jloss = step(st.params, opt0, st.aux, jtr._cam_stack([jcam]),
                                 jnp.asarray(gt), {k: jnp.asarray(v, jnp.float32)
                                                   for k, v in lrs.items()})
    tst = to_port(dataclasses.replace(st, opt=opt0))
    tcam = TOT.camera_tensors([TCamera(**dataclasses.asdict(jcam))], "cpu")[0]
    res = TOT.recon_step(tst, tcam, torch.from_numpy(gt), lrs, width=32, height=32,
                         capacity=cap, active_deg=st.active_sh_degree)
    np.testing.assert_allclose(float(res["loss"]), float(jloss), rtol=1e-4)
    for f in FIELDS:
        jmu = np.asarray(getattr(jopt.mu, f))
        tmu = res["opt"].mu[f].numpy()
        assert np.abs(jmu).max() > 0, f
        rel = np.linalg.norm(tmu - jmu) / np.linalg.norm(jmu)
        assert rel <= 1e-3, (f, rel)
    np.testing.assert_array_equal(res["aux"]["denom"].numpy(), np.asarray(jaux.denom))
    np.testing.assert_array_equal(res["aux"]["max_radii2d"].numpy(),
                                  np.asarray(jaux.max_radii2d))


def test_ply_both_ways(tmp_path):
    jst = jax_state(seed=9, sh_degree=2)
    jst = dataclasses.replace(jst, aux=dataclasses.replace(
        jst.aux, active=jst.aux.active & (jnp.arange(jst.capacity) % 7 != 3)))
    tst = to_port(jst)
    jpath, tpath = tmp_path / "jax.ply", tmp_path / "port.ply"
    JP.save_splat_ply(str(jpath), jst)
    TP.save_splat_ply(str(tpath), tst)
    assert jpath.read_bytes() == tpath.read_bytes()
    from_port = JP.load_splat_ply(str(tpath), capacity=90)
    from_jax = TP.load_splat_ply(str(jpath), capacity=90, device="cpu")
    assert from_jax.sh_degree == from_port.sh_degree == 2
    assert from_jax.active_sh_degree == from_port.active_sh_degree == 2
    np.testing.assert_array_equal(from_jax.aux["active"].numpy(), np.asarray(from_port.aux.active))
    for k, v in fields(from_port.params).items():
        np.testing.assert_array_equal(from_jax.params[k].numpy(), v, err_msg=k)
    pts = np.random.RandomState(0).rand(20, 3).astype(np.float32)
    rgb = np.random.RandomState(1).rand(20, 3).astype(np.float32)
    JP.store_point_ply(str(tmp_path / "j_pts.ply"), pts, rgb)
    TP.store_point_ply(str(tmp_path / "t_pts.ply"), pts, rgb)
    assert (tmp_path / "j_pts.ply").read_bytes() == (tmp_path / "t_pts.ply").read_bytes()
    for a, b in zip(TP.fetch_point_ply(str(tmp_path / "j_pts.ply")),
                    JP.fetch_point_ply(str(tmp_path / "t_pts.ply"))):
        np.testing.assert_array_equal(a, b)


def test_unported_options_raise(tmp_path):
    cfg = _tiny_cfg(TCfg())
    cfg.guidanceParams.controlnet_model_key = "some/controlnet"
    with pytest.raises(NotImplementedError, match="ControlNet"):
        TOT.ObjectTrainer(cfg, exp_root=str(tmp_path), device="cpu").prepare_train()
    cfg = _tiny_cfg(TCfg())
    cfg.mode_args = {"export_mesh": True}
    with pytest.raises(NotImplementedError, match="mesh"):
        TOT.ObjectTrainer(cfg, exp_root=str(tmp_path), device="cpu").train()
    from dreamscene_tpu_torch.__main__ import main

    with pytest.raises(NotImplementedError, match="scene"):
        main(["--config", str(ROOT / "configs/objects/sample.yaml"), "--device", "cpu"])
