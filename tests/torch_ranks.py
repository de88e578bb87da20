"""Rank-side cases of the port's multi-rank tests (test_torch_parallel*.py).

Each case is `fn(rank, world, case_dir)`, run on CPU ranks over gloo by
`dreamscene_tpu_torch.parallel.launch.run_ranks`: it reads
`case_dir/inputs.pt`, written by the test, and writes what it computed to
`case_dir/out_<rank>.pt`, which the test holds against the JAX package or
the port's single-process run. This module imports only torch and the
port: the ranks never run JAX.
"""

import logging

import torch

from dreamscene_tpu_torch.parallel import collectives as X
from dreamscene_tpu_torch.parallel import sharded_render as SR


def _load(d):
    return torch.load(f"{d}/inputs.pt", weights_only=False)


def _save(d, rank, out):
    torch.save(out, f"{d}/out_{rank}.pt")


def _rows(mesh, n):
    k = n // mesh.shape["tp"]
    return slice(mesh.coords["tp"] * k, (mesh.coords["tp"] + 1) * k)


def functions(rank, world, d):
    """The sharded render functions on a 2 x 2 mesh (and a 1 x 4 one)."""
    inp = _load(d)
    out = {}
    mesh = SR.make_mesh(2, 2)
    mesh14 = SR.make_mesh(1, 4)
    out["coords"] = (mesh.coords, mesh14.coords)

    # band render: every splat on every rank
    b = inp["band"]
    for key, m in (("band22", mesh), ("band14", mesh14)):
        fn = SR.make_sharded_render(m, 64, 64, 2, capacity=800, chunk=128)
        mine = SR.rank_cameras(m, 2)
        out[key] = fn(b["inputs"], b["cams"][mine], b["bg"][mine])

    # splat shards: forward, and the gradient of sum(image^2)/2 w.r.t. means3d
    p = inp["prim"]
    rows = _rows(mesh, p["inputs"]["means3d"].shape[0])
    local = {k: v[rows] for k, v in p["inputs"].items()}
    local["means3d"] = local["means3d"].clone().requires_grad_(True)
    fn = SR.make_primitive_sharded_render(mesh, 32, 64, 2, capacity=4 * 96, chunk=128)
    mine = SR.rank_cameras(mesh, 2)
    imgs, alphas = fn(local, p["cams"][mine], p["bg"][mine])
    ((imgs ** 2).sum() / 2.0).backward()
    g = X.all_reduce(local["means3d"].grad.clone(), mesh.group("dp"))
    out["prim"] = (imgs.detach(), alphas.detach(), g)

    # the trainers' camera loop, replicated and splat-sharded, with a VJP
    for shard in (False, True):
        f = inp["fps_shard" if shard else "fps"]
        n = f["inputs"]["xyz"].shape[0]
        rows = _rows(mesh, n) if shard else slice(None)
        mine = SR.rank_cameras(mesh, 4)
        x = {k: (v[rows].clone().requires_grad_(v.dtype == torch.float32))
             for k, v in f["inputs"].items()}
        probes = f["probes"][mine][:, rows].clone().requires_grad_(True)
        fn = SR.make_fps_camera_render(mesh, 64, 64, 2, capacity=800, c_batch=4, chunk=128,
                                       shard_splats=shard)
        r = fn(x, f["cams"][mine], f["aug"][mine], probes, f["shs_noise"][mine][:, rows],
               f["scale_noise"][mine][:, rows])
        band = slice(mesh.coords["tp"] * 32, (mesh.coords["tp"] + 1) * 32)
        ct = f["ct"]
        loss = ((r["images"] * ct["images"][mine][:, :, band]).sum()
                + (r["disps"] * ct["disps"][mine][:, :, band]).sum()
                + (r["alphas"] * ct["alphas"][mine][:, :, band]).sum()
                + ct["scales_mean"] * r["scale_share"])
        loss.backward()
        grads = SR.reduce_gradients(
            mesh, {k: v.grad for k, v in x.items() if v.grad is not None}, shard)
        pg = probes.grad.clone()
        if not shard:
            X.all_reduce(pg, mesh.group("tp"))
        out["fps_shard" if shard else "fps"] = dict(
            {k: (v.detach() if torch.is_tensor(v) else v) for k, v in r.items()},
            grads=grads, probe_grad=pg)

    # shard_splat_state / gather_splat_state
    st = inp["state"]
    sh = SR.shard_splat_state(mesh, st)
    back = SR.gather_splat_state(mesh, sh)
    records = []
    handler = logging.Handler()
    handler.emit = records.append
    log = logging.getLogger("shard-test")
    log.addHandler(handler)
    odd = SR.shard_splat_state(mesh, inp["state_odd"], log)
    out["state"] = dict(
        rows={"params.xyz": sh.params["xyz"].shape[0], "opt.mu.xyz": sh.opt.mu["xyz"].shape[0],
              "opt.nu.scaling": sh.opt.nu["scaling"].shape[0],
              "aux.active": sh.aux["active"].shape[0]},
        background=tuple(sh.params["background"].shape), count=sh.opt.count,
        global_capacity=sh.global_capacity, local_xyz=sh.params["xyz"],
        back_equal=all(torch.equal(back.params[k], st.params[k]) for k in st.params)
        and all(torch.equal(back.aux[k], st.aux[k]) for k in st.aux)
        and all(torch.equal(back.opt.mu[k], st.opt.mu[k]) for k in st.opt.mu),
        odd_rows=odd.params["xyz"].shape[0], odd_global=odd.global_capacity,
        warnings=[rec.getMessage() for rec in records])
    _save(d, rank, out)


def object_steps(rank, world, d):
    """On a 2 x 2 mesh: the port's FPS step on explicit inputs;
    make_sharded_train_step, replicated and splat-sharded; ObjectTrainer,
    two replicated steps, then with shard_splats three steps through a
    forced densify."""
    from dreamscene_tpu_torch.models.gaussians import num_active
    from dreamscene_tpu_torch.training import object_trainer as tot

    inp = _load(d)
    mesh = SR.make_mesh(2, 2)
    res = tot.fps_step(**inp["step"], mesh=mesh)
    out = dict(step=dict(loss=res["loss"], grads=res["grads"], params=res["params"],
                         aux=res["aux"], n_entries=res["n_entries"],
                         n_dropped=res["n_dropped"]))

    a = inp["step"]
    st = a["state"]
    for shard in (False, True):
        s = SR.shard_splat_state(mesh, st) if shard else st
        step = SR.make_sharded_train_step(mesh, inp["guidance"], 32, 32, 1, capacity=4096,
                                          guidance_scale=a["guidance_scale"],
                                          shard_splats=shard)
        params, opt, loss = step(s.params, s.opt, s.aux["active"], a["cams"],
                                 torch.zeros(len(a["cams"]), 3), a["text_emb"], a["ladder"],
                                 a["noise"], a["vae_eps"], a["lrs"])
        out["train_step_shard" if shard else "train_step"] = dict(
            loss=loss, xyz=params["xyz"], xyz0=s.params["xyz"], mu=opt.mu)

    tr = tot.ObjectTrainer(inp["cfg"], exp_root=f"{d}/mesh", device="cpu")
    tr.prepare_train()
    out["trainer"] = dict(losses=[tr.train_step() for _ in range(2)],
                          xyz=tr.state.params["xyz"].clone())

    cfg = inp["cfg"]
    cfg.parallelParams.shard_splats = True
    tr = tot.ObjectTrainer(cfg, exp_root=f"{d}/shard", device="cpu")
    tr.prepare_train()
    optim = tr.optim
    optim.densify_from_iter = 1
    optim.densification_interval = 2
    optim.densify_until_iter = 10
    optim.densify_grad_threshold = 1e-9
    optim.opacity_reset_interval = 10**9
    n0 = num_active(tr.state)
    xyz0 = tr.state.params["xyz"].clone()
    losses, rows = [], []
    for _ in range(3):
        losses.append(tr.train_step())
        st = tr.state
        rows.append(dict(global_capacity=st.global_capacity, xyz=st.params["xyz"].shape[0],
                         mu=st.opt.mu["xyz"].shape[0], nu=st.opt.nu["scaling"].shape[0],
                         active=st.aux["active"].shape[0],
                         background=tuple(st.params["background"].shape)))
    whole = tr._whole_state(tr._shard_state(tr.state))
    out["shard"] = dict(losses=losses, rows=rows, n0=n0, n1=num_active(whole),
                        moved=float((whole.params["xyz"][:xyz0.shape[0]] - xyz0).abs().max()),
                        xyz=whole.params["xyz"])
    _save(d, rank, out)


def scene_trainer(rank, world, d):
    """SceneTrainer on a 2 x 2 mesh with shard_splats: one stage-1 step,
    then a one-camera recon step (the fold to 1 x 4 tile bands)."""
    from dreamscene_tpu_torch.training.scene_trainer import SceneTrainer

    inp = _load(d)
    tr = SceneTrainer(inp["cfg"], exp_root=inp["root"], device="cpu",
                      env_density=inp["env_density"])
    tr.prepare_train_scene()
    tr.iters, tr.step = 2, 0
    cams = tr._stage1_cams(tr.guidance_opt.C_batch_size)
    loss1 = tr.scene_train_step(cams, "env", only_env=False)
    rows = {n: (s.capacity, s.global_capacity)
            for n, s in (("env", tr.scene.env), ("floor", tr.scene.floor))}
    env1, floor1 = tr._whole(tr.scene.env), tr._whole(tr.scene.floor)
    loss3 = tr._run_scene_step(cams[:1], "floor", True, False, 1.0, guidance_on=False,
                               gt_images=[inp["gt"]], optp=tr.cfg.reconSceneOptimizationParams)
    out = dict(loss1=loss1, env1=env1.params["xyz"], floor1=floor1.params["xyz"], rows=rows,
               loss3=loss3, floor3=tr._whole(tr.scene.floor).params["xyz"],
               env3=tr._whole(tr.scene.env).params["xyz"],
               flat=dict(tr._flat_mesh.shape) if tr._flat_mesh is not None else None)
    _save(d, rank, out)

