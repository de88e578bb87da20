"""The outdoor scene (BASELINE.json config #5's `cam_pose_method:
outdoor`) in the port against the JAX package, on the CPU at the tiny
size of tests/test_torch_scene_step.py (32x32, SH 1, two placed 60-splat
objects, env and floor at density 0.0002 made to look trained) inside
config #5's box, radius [15, 15, 4]: an env hemisphere shell and a floor
disk of radius sqrt(466).

- Scene steps against the JAX package's jitted `_scene_step_fn` (Pallas
  in interpret mode): stage 1 with no objects (floor + env, env
  trainable) from `Stage1_Outdoor`; stage 2 (objects visible, floor
  trainable) from `Stage2_Outdoor`, one camera mirrored (scale -1) and
  one not; the stage-3 recon step of the floor-only refine (floor +
  env, floor trainable) from `Stage3_Outdoor("env")`. Tolerances as in
  that file: loss rtol 1e-4, n_entries / n_dropped equal, per-group
  gradient relative L2 <= 1e-3, params on rows with |g| > 1e-3 max|g| at
  atol 1e-6, untrained models returned bit-equal.
- The outdoor prompt bank ("ground of ..." / "sky of ..."), bit-equal.
- Host sampling through `train()` in both packages (scene steps and
  pseudo-GT banks replaced by recorders): the camera pools, background
  rows, prompt rows, ladders, stage and jump ranges, flips, as_latent,
  lrs, trainable masks and entry capacity of every step of stages 1-3, in
  order.
- One iteration of the floor-only refine (`scene_refine_phase(only_env=
  True, scene_optim=False)`) in both packages from the same pseudo-GT
  bank: the floor held at the step tolerances, env and objects bit-equal.
"""

import copy
import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from dreamscene_tpu.training import scene_trainer as jst
from dreamscene_tpu.utils.config import ParamsGroups as JCfg
from dreamscene_tpu_torch import convert
from dreamscene_tpu_torch.cameras import Camera as TCamera
from dreamscene_tpu_torch.training import scene_trainer as tst
from dreamscene_tpu_torch.utils.config import ParamsGroups as TCfg
from tests.test_torch_scene_step import (
    ENV_DENSITY,
    FIELDS,
    assert_same_steps,
    hold_scene_step,
    make_trained_looking,
    rel_l2,
    step_recorders,
    tiny_scene_cfg,
    write_objects,
)

torch.set_num_threads(1)

OUTDOOR_RADIUS = [15, 15, 4]     # configs/scenes/sample_outdoor.yaml


def tiny_outdoor_cfg(cfg):
    cfg = tiny_scene_cfg(cfg)
    cfg.scene_configs["scene"].update(
        cam_pose_method="outdoor", radius=list(OUTDOOR_RADIUS), scene_text="a minecraft world",
        floor_init_color=[64, 222, 90], env_init_color=[200, 160, 160])
    return cfg


@pytest.fixture(scope="module")
def jax_outdoor(tmp_path_factory):
    tr = jst.SceneTrainer(tiny_outdoor_cfg(JCfg()), exp_root=str(tmp_path_factory.mktemp("jax")),
                          interpret=True, env_density=ENV_DENSITY)
    write_objects(tr.ckpt_path)
    tr.prepare_train_scene()
    make_trained_looking(tr)
    return tr


@pytest.mark.parametrize("stage", ["stage 1: env, only_env", "stage 2: floor, objects",
                                   "stage 3: floor recon, only_env"])
def test_outdoor_scene_step_matches_jax(jax_outdoor, stage):
    jtr = jax_outdoor
    objects = list(jtr.scene.objects)
    if stage.startswith("stage 1"):
        names, trainable = [], (False, True)
        cams = jtr.cams_loader.Stage1_Outdoor()[:2]
        guidance_on, ladder = True, [420, 690]
    elif stage.startswith("stage 2"):
        names, trainable = objects, (False,) * len(objects) + (True, False)
        pool = jtr.cams_loader.Stage2_Outdoor()
        cams = [pool[1], pool[2]]
        assert [c.scale for c in cams] == [-1.0, 1.0]
        guidance_on, ladder = True, [380, 560]
    else:
        names, trainable = [], (True, False)
        cams = jtr.cams_loader.Stage3_Outdoor("env")[:1]
        assert cams[0].scale == -1.0
        guidance_on, ladder = False, [150]
    hold_scene_step(jtr, names, trainable, cams, guidance_on, scene_optim=False, ladder=ladder)


def test_outdoor_prompt_bank_matches_jax(jax_outdoor):
    """`calc_scene_text_embeddings` for outdoor: overhead is "ground of
    <text>", bottom "sky of <text>", the rest as indoor; every row
    bit-equal to the JAX package's (the tiny stack's text embeddings are
    crc32-seeded)."""
    from dreamscene_tpu_torch.guidance import mtsd as tm

    jtr = jax_outdoor
    cfg = tiny_outdoor_cfg(TCfg())
    g = tm.make_tiny_guidance(cfg.guidanceParams, device="cpu")
    optp = cfg.sceneOptimizationParams
    bank = tst.calc_scene_text_embeddings(g, "a minecraft world", "", "outdoor", optp)
    for k in ("default", "uncond", "inverse_text"):
        np.testing.assert_array_equal(bank[k].numpy(), np.asarray(jtr.embeddings[k]))
    for k in ("text_embeddings_vd", "uncond_text_embeddings_vd"):
        assert bank[k].keys() == jtr.embeddings[k].keys()
        for d, v in bank[k].items():
            np.testing.assert_array_equal(v.numpy(), np.asarray(jtr.embeddings[k][d]))
    sp = optp.style_prompt
    for d, prompt in (("overhead", "ground of a minecraft world"),
                      ("bottom", "sky of a minecraft world")):
        assert torch.equal(bank["text_embeddings_vd"][d],
                           g.get_text_embeds([f"{prompt}, {sp}"]))
    indoor = tst.calc_scene_text_embeddings(g, "a minecraft world", "", "indoor", optp)
    assert not torch.equal(indoor["text_embeddings_vd"]["overhead"],
                           bank["text_embeddings_vd"]["overhead"])
    assert torch.equal(indoor["text_embeddings_vd"]["front"], bank["text_embeddings_vd"]["front"])


def test_outdoor_train_host_sampling_matches_jax(tmp_path, monkeypatch):
    """Both trainers run `train(n_stage3=1)` on the outdoor scene from the
    same PLYs and seeds, their scene steps replaced by recorders and their
    pseudo-GT banks by the same zero images: 7 stage-1 steps (the pool
    holds a `Stage1_Outdoor` ring and, past 70% of it, `Stage1_Outdoor2`'s
    mirrored positions), 1 stage-2 step and one recon step per pseudo-GT
    camera hand their steps the same inputs, step by step."""
    jcfg, tcfg = tiny_outdoor_cfg(JCfg()), tiny_outdoor_cfg(TCfg())
    for cfg in (jcfg, tcfg):
        cfg.sceneOptimizationParams.iterations = 7
    jtr = jst.SceneTrainer(jcfg, exp_root=str(tmp_path / "j"), interpret=True,
                           env_density=ENV_DENSITY)
    ttr = tst.SceneTrainer(tcfg, exp_root=str(tmp_path / "t"), device="cpu",
                           env_density=ENV_DENSITY)
    write_objects(jtr.ckpt_path)
    write_objects(ttr.ckpt_path)
    seen_j, seen_t, pools, scales = [], [], {"j": [], "t": []}, {}
    j_recorder, t_recorder = step_recorders(jtr, ttr, seen_j, seen_t)

    def bank(tr, tag, zeros):
        def zero_bank(cams, only_env):
            assert only_env
            pools[tag].append([np.asarray(c.world_view_transform) for c in cams])
            return [zeros() for _ in range(tr.gt_size // 4 * 4)]
        return zero_bank

    def stage1_pool(tr, tag):
        orig = tr._stage1_cams

        def pool(n_max):
            cams = orig(n_max)
            pools[tag].append([np.asarray(c.world_view_transform) for c in cams])
            scales[tag] = [c.scale for c in cams]
            return cams
        return pool

    jtr._scene_step_fn = j_recorder
    monkeypatch.setattr(tst, "scene_step", t_recorder)
    jtr._pseudo_gt_bank = bank(jtr, "j", lambda: jnp.zeros((3, 32, 32)))
    ttr._pseudo_gt_bank = bank(ttr, "t", lambda: torch.zeros((3, 32, 32)))
    jtr._stage1_cams = stage1_pool(jtr, "j")
    ttr._stage1_cams = stage1_pool(ttr, "t")
    jtr.train(n_stage3=1)
    ttr.train(n_stage3=1)

    assert ttr.scene.stage_n == jtr.scene.stage_n == 3
    assert ttr.gt_size == jtr.gt_size >= 4
    assert len(seen_j) == len(seen_t) == 7 + 1 + ttr.gt_size
    for pj, pt in zip(*pools.values(), strict=True):
        np.testing.assert_array_equal(np.stack(pt), np.stack(pj))
    # the stage-1 pool: a 12-camera ring, then the 4 translated ones, the
    # first two mirrored; the seventh step takes those two
    assert scales["t"] == scales["j"] == [1.0] * 12 + [-1.0, -1.0, 1.0, 1.0]
    n_obj = len(ttr.scene.objects)
    assert_same_steps(seen_j, seen_t)
    # stage 1 without objects (env trainable), stage 2 with them (floor
    # trainable) at (350, 750) / (150, 200), stage 3 floor + env (floor)
    assert all(r["n_models"] == 2 and r["trainable"] == (False, True) for r in seen_t[:7])
    assert seen_t[7]["n_models"] == n_obj + 2
    assert seen_t[7]["trainable"] == (False,) * n_obj + (True, False)
    assert seen_t[7]["ranges"] == ((350, 750), (150, 200))
    assert all(r["trainable"] == (True, False) and r["ranges"] == ((140, 200), (75, 150))
               for r in seen_t[8:])


def _bank_images(n, seed=5):
    rng = np.random.default_rng(seed)
    return [rng.uniform(0, 1, (3, 32, 32)).astype(np.float32) for _ in range(n)]


def _floor_history(tr, get):
    """Wrap `tr._run_scene_step` to record, after each recon step, its
    loss and the floor's params and Adam first moment (numpy, by group)."""
    hist, run = [], tr._run_scene_step

    def recording(*a, **kw):
        loss = run(*a, **kw)
        st = tr.scene.floor
        hist.append((loss, {f: np.array(get(st.params, f)) for f in FIELDS},
                     {f: np.array(get(st.opt.mu, f)) for f in FIELDS}))
        return loss
    tr._run_scene_step = recording
    return hist


def test_outdoor_refine_matches_jax(jax_outdoor, tmp_path):
    """One floor-only refine iteration (`scene_refine_phase(only_env=True,
    scene_optim=False)`, key "floor") in both packages from the same scene
    state and the same pseudo-GT bank (each package's bank draws its own
    noise): gt_size recon steps of floor + env, each held at the step
    tolerances. Every step: loss rtol 1e-4 and the floor's gradient per
    group (recovered from Adam's first moment, mu_k = 0.9 mu_(k-1) + 0.1
    g_k) at relative L2 <= 1e-3. The floor's params at atol 1e-6 after the
    first step on rows with |g| > 1e-3 max|g|, and after the last on rows
    whose gradient cleared that threshold at every step: Adam normalizes
    each row's step by its own moments, so from the second step on a row
    whose gradient was once near zero moves by lr times that gradient's
    relative rounding error (seen: 2.4e-6 on one scale row of 39 whose
    gradients were 1.8e-3 max|g| and then 0, the whole gradients 5e-6 apart).
    The env and the objects bit-equal to where they started."""
    jtr = jax_outdoor
    saved = (jtr.scene.env, jtr.scene.floor, jtr.step, jtr.guidance.stage_range,
             jtr.guidance.jump_range, copy.deepcopy(jtr.cap_ctrl))
    ttr = tst.SceneTrainer(tiny_outdoor_cfg(TCfg()), exp_root=str(tmp_path), device="cpu",
                           env_density=ENV_DENSITY)
    write_objects(ttr.ckpt_path)
    ttr.prepare_train_scene()
    ttr.scene = convert.scene_model(jtr.scene)
    env0 = {f: v.clone() for f, v in ttr.scene.env.params.items()}
    obj0 = {n: {f: v.clone() for f, v in e.state.params.items()}
            for n, e in ttr.scene.objects.items()}
    cams = jtr.cams_loader.Stage3_Outdoor("env")[:4]
    gts = _bank_images(len(cams))
    for tr, to, cs in ((jtr, jnp.asarray, cams),
                       (ttr, torch.from_numpy, [TCamera(**dataclasses.asdict(c)) for c in cams])):
        tr.scene_cams, tr.gt_size, tr.n_stage3, tr.step = cs, len(cs), 1, 0
        tr._pseudo_gt_bank = lambda c, only_env, to=to: [to(g) for g in gts]
    j_hist = _floor_history(jtr, getattr)
    t_hist = _floor_history(ttr, lambda d, f: d[f])
    try:
        jtr.scene_refine_phase(only_env=True, scene_optim=False)
        ttr.scene_refine_phase(only_env=True, scene_optim=False)
        jfloor = jtr.scene.floor
    finally:
        (jtr.scene.env, jtr.scene.floor, jtr.step, jtr.guidance.stage_range,
         jtr.guidance.jump_range, jtr.cap_ctrl) = saved
        del jtr._pseudo_gt_bank, jtr._run_scene_step
    tfloor = ttr.scene.floor
    assert tfloor.opt.count == int(jfloor.opt.count) == len(cams)
    assert ttr.step == 1 and len(j_hist) == len(t_hist) == len(cams)
    every_step = {f: True for f in FIELDS}
    prev_j = prev_t = {f: 0.0 for f in FIELDS}
    for k, ((jl, jp, jmu), (tl, tp, tmu)) in enumerate(zip(j_hist, t_hist)):
        np.testing.assert_allclose(tl, jl, rtol=1e-4)
        for f in FIELDS:
            gj, gt = (jmu[f] - 0.9 * prev_j[f]) / 0.1, (tmu[f] - 0.9 * prev_t[f]) / 0.1
            assert np.abs(gj).max() > 0, (k, f)
            assert rel_l2(gt, gj) <= 1e-3, (k, f, rel_l2(gt, gj))
            big = np.abs(gj) > 1e-3 * np.abs(gj).max()
            every_step[f] = every_step[f] & big
            if k == 0 or k == len(cams) - 1:
                rows = big if k == 0 else every_step[f]
                assert rows.any(), (k, f)
                np.testing.assert_allclose(tp[f][rows], jp[f][rows], atol=1e-6,
                                           err_msg=f"step {k} {f}")
        prev_j, prev_t = jmu, tmu
    np.testing.assert_array_equal(tfloor.aux["denom"].numpy(), np.asarray(jfloor.aux.denom))
    for f, v in env0.items():
        assert torch.equal(ttr.scene.env.params[f], v), f
    for n, e in ttr.scene.objects.items():
        for f, v in obj0[n].items():
            assert torch.equal(e.state.params[f], v), (n, f)
