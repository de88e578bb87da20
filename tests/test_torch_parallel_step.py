"""The slice on a mesh: the port's FPS step and ObjectTrainer on four CPU
ranks over gloo (dp 2 x tp 2), against the JAX package's
`ObjectTrainer._fps_step_fn` with parallelParams dp 2, tp 2 (its mesh on
the conftest's virtual CPU devices, Pallas in interpret mode) and against
the port's single-process trainer. One spawn of four ranks computes every
case (tests/torch_ranks.py::object_steps).

Tolerances: the mesh step against JAX's, loss rtol 1e-3 and each
parameter group's gradient relative L2 <= 1e-3 (JAX's read from Adam's
first moment, 0.1 * g after one step); the mesh trainer against the
single-process one, loss rtol 1e-3 / atol 1e-4 and xyz atol 1e-4
(test_parallel.py:194-270); parameters bit-equal on every rank holding
them.
"""

import dataclasses
import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dreamscene_tpu.cameras import sampling as JS
from dreamscene_tpu.guidance import mtsd as jm
from dreamscene_tpu.models.gaussians import group_lrs as j_group_lrs
from dreamscene_tpu.parallel import sharded_render as jsr
from dreamscene_tpu.training import object_trainer as jot
from dreamscene_tpu.utils.config import ObjectsParamsGroups as JCfg
from dreamscene_tpu_torch import convert
from dreamscene_tpu_torch.cameras import Camera as TCamera
from dreamscene_tpu_torch.parallel.launch import run_ranks
from dreamscene_tpu_torch.training import object_trainer as tot
from dreamscene_tpu_torch.utils.config import ObjectsParamsGroups as TCfg
from tests import torch_ranks
from tests.test_torch_controlnet import port_mods
from tests.test_torch_object_step import FIELDS, np_tree, rel_l2, tiny_cfg

torch.set_num_threads(1)

C_BATCH = 4


def mesh_cfg(cfg, dp=2, tp=2):
    cfg = tiny_cfg(cfg)
    cfg.objectParams.num_pts = 64
    cfg.guidanceParams.C_batch_size = 2
    cfg.parallelParams.dp = dp
    cfg.parallelParams.tp = tp
    return cfg


def jax_mesh_step(tmp_path):
    """JAX's jitted mesh step on explicit inputs, and the same inputs for
    the port (its state, converted weights, JAX's own random draws)."""
    cfg = tiny_cfg(JCfg())
    cfg.guidanceParams.C_batch_size = C_BATCH
    cfg.parallelParams.dp, cfg.parallelParams.tp = 2, 2
    jtr = jot.ObjectTrainer(cfg, exp_root=str(tmp_path / "jax"), interpret=True)
    jtr.prepare_train()
    rng = np.random.RandomState(1)
    p = np_tree(jtr.state.params)
    p = dataclasses.replace(
        jtr.state.params,
        opacity=jnp.asarray(p.opacity + rng.randn(*p.opacity.shape).astype(np.float32)),
        features_rest=jnp.asarray(0.2 * rng.randn(*p.features_rest.shape).astype(np.float32)),
        rotation=jnp.asarray(p.rotation + 0.3 * rng.randn(*p.rotation.shape).astype(np.float32)),
        # anisotropic, so that rotation has a gradient without scale noise
        scaling=jnp.asarray(p.scaling + 0.5 + 0.3 * rng.randn(*p.scaling.shape).astype(np.float32)))
    st = jtr.state = dataclasses.replace(jtr.state, params=p, active_sh_degree=1)
    n = st.capacity
    g = np.random.default_rng(7)
    cameras = [JS.load_random_cam(g, jtr.pose_args, ssaa=True) for _ in range(C_BATCH)]
    text_emb, _ = jot.assemble_text_embeddings(jtr.embeddings, cameras)
    ladder = np.asarray([230, 470], np.int32)
    lat_shape = jtr.guidance.latent_shape(C_BATCH, 32, 32)
    noise = g.standard_normal(lat_shape).astype(np.float32)
    # no camera on a 0.5 grey background: on a mostly empty view the JAX
    # package's jitted step encodes such an image away from its own
    # `encode_images` (which the port matches), and its gradients move by
    # far more than the tolerance (ROADMAP, queue C)
    aug = np.asarray([[0.2, 0.3, 0.4, 0.0, 1.0, 1.0], [0.0, 0.0, 0.0, 1.0, 1.0, 1.0],
                      [1.0, 1.0, 1.0, 0.0, 0.0, 1.0], [0.6, 0.7, 0.8, 1.0, 1.0, 0.0]],
                     np.float32)
    vae_key = jax.random.key(3)
    lrs = j_group_lrs(jtr.optim, st.spatial_lr_scale, 1)
    capacity = jtr.cap_ctrl.capacity(max(n // 2, 4096))
    step = jtr._fps_step_fn(len(ladder), capacity, C_BATCH, st.active_sh_degree)
    j_params, j_opt, j_aux, j_loss, j_nent, j_ndrop = step(
        st.params, st.opt, st.aux, jtr._cam_stack(cameras), jnp.asarray(aug), text_emb,
        jnp.asarray(ladder), jnp.asarray(noise), vae_key, jnp.asarray(True),
        jnp.asarray(False), {k: jnp.asarray(v, jnp.float32) for k, v in lrs.items()},
        jm.mods_params(jtr.guidance.mods))
    # the JAX package's dry-run step (make_sharded_train_step), replicated
    # and splat-sharded, on the same inputs with black backgrounds
    train = {}
    for shard in (False, True):
        tstep = jsr.make_sharded_train_step(
            jsr.make_mesh(2, 2), jtr.guidance, 32, 32, st.active_sh_degree, capacity=4096,
            n_rungs=len(ladder), guidance_scale=jtr.guidance_opt.guidance_scale,
            shard_splats=shard, interpret=True)
        _, t_opt, t_loss = tstep(
            st.params, st.opt, st.aux.active, jtr._cam_stack(cameras),
            jnp.zeros((C_BATCH, 3), jnp.float32),
            text_emb.reshape(3, C_BATCH, *text_emb.shape[1:]), jnp.asarray(ladder),
            jnp.asarray(noise), vae_key, {k: jnp.asarray(v, jnp.float32) for k, v in lrs.items()})
        train[shard] = dict(loss=float(t_loss),
                            grads={f: np.asarray(getattr(t_opt.mu, f)) / 0.1 for f in FIELDS})
    vae_eps = np.asarray(jax.random.normal(vae_key, lat_shape, jnp.float32))
    k = st.params.features_dc.shape[1] + st.params.features_rest.shape[1]
    shs_noise, scale_noise = [], []
    for i in range(C_BATCH):
        k1, k2 = jax.random.split(jax.random.fold_in(vae_key, i + 1))
        shs_noise.append(np.asarray(jax.random.normal(k1, (n, k, 3))))
        scale_noise.append(np.asarray(jax.random.normal(k2, (n, 3))))

    mods = port_mods(jtr.guidance.mods)
    aux_np = {f.name: np.asarray(getattr(st.aux, f.name)) for f in dataclasses.fields(st.aux)}
    params_np = {f.name: np.asarray(getattr(st.params, f.name))
                 for f in dataclasses.fields(st.params)}
    zeros = {k_: np.zeros_like(v) for k_, v in params_np.items()}
    tstate = convert.gaussian_state(params_np, aux_np, zeros, zeros, 0, st.sh_degree,
                                    st.active_sh_degree, st.spatial_lr_scale)
    optim = jtr.optim
    port = dict(
        state=tstate, mods=mods,
        cams=tot.camera_tensors([TCamera(**dataclasses.asdict(c)) for c in cameras], "cpu"),
        aug=aug.tolist(), text_emb=torch.from_numpy(np.array(text_emb)),
        ladder=[int(t) for t in ladder], noise=torch.from_numpy(noise),
        vae_eps=torch.from_numpy(vae_eps), shs_noise=torch.from_numpy(np.stack(shs_noise)),
        scale_noise=torch.from_numpy(np.stack(scale_noise)), flip=True, as_latent=False,
        lrs=lrs, width=32, height=32, capacity=capacity, active_deg=st.active_sh_degree,
        lambda_tv=optim.lambda_tv, lambda_scale=optim.lambda_scale,
        guidance_scale=jtr.guidance_opt.guidance_scale,
        lambda_guidance=jtr.guidance_opt.lambda_guidance)
    ref = dict(loss=float(j_loss), n_entries=int(j_nent), n_dropped=int(j_ndrop),
               grads={f: np.asarray(getattr(j_opt.mu, f)) / 0.1 for f in FIELDS}, train=train)
    return port, ref, mods


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    d = tmp_path_factory.mktemp("ranks")
    step, ref, mods = jax_mesh_step(d)
    torch.save(dict(step=step, guidance=types.SimpleNamespace(mods=mods), cfg=mesh_cfg(TCfg())),
               d / "inputs.pt")
    run_ranks(torch_ranks.object_steps, 4, (str(d),), device="cpu", store_dir=str(d),
              timeout_s=170)
    outs = [torch.load(d / f"out_{r}.pt", weights_only=False) for r in range(4)]
    return d, step, ref, outs


def test_mesh_fps_step_matches_jax_mesh_step(results):
    """JAX's `_fps_step_fn` on its (2, 2) mesh against the port's ranks."""
    _, _, ref, outs = results
    for o in outs:
        s = o["step"]
        np.testing.assert_allclose(float(s["loss"]), ref["loss"], rtol=1e-3)
        assert int(s["n_entries"]) == ref["n_entries"]
        assert int(s["n_dropped"]) == ref["n_dropped"]
        for f in FIELDS:
            assert np.abs(ref["grads"][f]).max() > 0, f
            assert rel_l2(s["grads"][f].numpy(), ref["grads"][f]) <= 1e-3, f
    for o in outs[1:]:       # every rank takes the same Adam step
        for f, v in o["step"]["params"].items():
            assert torch.equal(v, outs[0]["step"]["params"][f]), f
        for f, v in o["step"]["aux"].items():
            assert torch.equal(v, outs[0]["step"]["aux"][f]), f


def test_mesh_fps_step_matches_single_process(results):
    """The same inputs through the port's single-process step: the
    mesh reorders sums only."""
    _, step, _, outs = results
    res = tot.fps_step(**step)
    np.testing.assert_allclose(float(outs[0]["step"]["loss"]), float(res["loss"]), rtol=1e-3)
    for f in FIELDS:
        assert rel_l2(outs[0]["step"]["grads"][f].numpy(), res["grads"][f].numpy()) <= 1e-3, f


@pytest.mark.parametrize("key", ["train_step", "train_step_shard"])
def test_sharded_train_step_runs(results, key):
    """make_sharded_train_step, replicated and splat-sharded, against the
    JAX package's dry-run step on its (2, 2) mesh: loss rtol 1e-3 and each
    group's gradient within relative L2 1e-3 (both read from Adam's first
    moment); the loss equal on every rank, the parameters moved and equal
    on the ranks that hold them."""
    _, _, ref, outs = results
    shard = key.endswith("shard")
    jref = ref["train"][shard]
    losses = [float(o[key]["loss"]) for o in outs]
    assert np.isfinite(losses[0]) and len(set(losses)) == 1, losses
    np.testing.assert_allclose(losses[0], jref["loss"], rtol=1e-3)
    for f in FIELDS:
        mu = outs[0][key]["mu"][f]
        if shard:                 # ranks (0, 0) and (0, 1) hold the rows
            mu = torch.cat([mu, outs[1][key]["mu"][f]])
        assert np.abs(jref["grads"][f]).max() > 0, f
        assert rel_l2(mu.numpy() / 0.1, jref["grads"][f]) <= 1e-3, f
    whole = (lambda v: torch.cat([outs[0][key][v], outs[1][key][v]])) if shard else \
        (lambda v: outs[0][key][v])
    assert not torch.equal(whole("xyz"), whole("xyz0"))
    for r, o in enumerate(outs):      # the ranks that hold a row agree on it
        twin = outs[r % 2] if shard else outs[0]
        assert torch.equal(o[key]["xyz"], twin[key]["xyz"])


def test_object_trainer_mesh_matches_single_process(results):
    """ObjectTrainer on dp 2 x tp 2 takes the single-process trainer's
    steps (test_parallel.py:194-220)."""
    d, _, _, outs = results
    tr = tot.ObjectTrainer(mesh_cfg(TCfg(), dp=1, tp=1), exp_root=str(d / "single"),
                           device="cpu")
    tr.prepare_train()
    for i in range(2):
        loss = tr.train_step()
        for o in outs:
            np.testing.assert_allclose(o["trainer"]["losses"][i], loss, rtol=1e-3, atol=1e-4)
    for o in outs:
        np.testing.assert_allclose(o["trainer"]["xyz"].numpy(), tr.state.params["xyz"].numpy(),
                                   atol=1e-4)
        assert torch.equal(o["trainer"]["xyz"], outs[0]["trainer"]["xyz"])


def test_object_trainer_shard_splats_and_densify(results):
    """With shard_splats each rank keeps cap / n_tp rows of params, Adam
    moments and aux (background whole) across steps; a densify gathers,
    decides alike on every rank and shards again; the losses are finite,
    equal on every rank, and the parameters move (test_parallel.py:222-270)."""
    _, _, _, outs = results
    for o in outs:
        s = o["shard"]
        assert all(np.isfinite(s["losses"])), s["losses"]
        assert s["losses"] == outs[0]["shard"]["losses"]
        for step in (0, 2):          # step 2 densified: whole, then sharded again
            rows = s["rows"][step]
            cap = rows["global_capacity"]
            assert cap is not None
            assert {k: rows[k] for k in ("xyz", "mu", "nu", "active")} == \
                {k: cap // 2 for k in ("xyz", "mu", "nu", "active")}, rows
            assert rows["background"] == (3,)
        assert s["n1"] != s["n0"], "densify never fired under the sharded step"
        assert s["moved"] > 0
        assert torch.equal(s["xyz"], outs[0]["shard"]["xyz"])
