"""The port's sharded render functions (parallel/sharded_render.py) on four
CPU ranks over gloo, against the JAX package's shard_map versions on the
conftest's 8 virtual CPU devices (Pallas in interpret mode) and against
the port's single-process render. One spawn of four ranks computes every
case (tests/torch_ranks.py::functions); the tests read its results.

Sizes as in tests/test_parallel.py: 64x64 (32x64 for the gradient case),
96-200 splats, chunk 128, bands of 32 and 16 rows.

Tolerances: images / disparities / alphas atol 1e-5, rtol 1e-4 (the
band render against the full one, test_parallel.py:57-62); radii,
visibility and n_entries equal; gradients rtol 2e-3 and atol 2e-4 (of
max|g| for the camera loop's VJP, whose parameter gradients reach 134:
the repository's gradient convention, ROADMAP north star; on the same
inputs the JAX package's own single-device and mesh gradients differ by
up to 9.5e-4 in scale, and the port's single-device path by 0.036 from
JAX's).
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dreamscene_tpu.parallel import sharded_render as JSR
from dreamscene_tpu_torch.cameras import Camera as TCamera
from dreamscene_tpu_torch.models.gaussians import create_from_points
from dreamscene_tpu_torch.ops.rasterizer import render as t_render
from dreamscene_tpu_torch.parallel.launch import run_ranks
from dreamscene_tpu_torch.training.object_trainer import camera_tensors
from tests import torch_ranks
from tests.test_rasterizer_parity import make_camera, make_scene

torch.set_num_threads(1)

IMG_TOL = dict(atol=1e-5, rtol=1e-4)
GRAD_TOL = dict(atol=2e-4, rtol=2e-3)
AUG = np.asarray([[0.2, 0.3, 0.4, 0.0, 1.0, 1.0],
                  [0.0, 0.0, 0.0, 1.0, 1.0, 1.0],
                  [1.0, 1.0, 1.0, 0.0, 0.0, 1.0],
                  [0.5, 0.5, 0.5, 1.0, 1.0, 0.0]], np.float32)


def t(x):
    return torch.from_numpy(np.array(x))


def jax_cams(cams):
    return {"view": jnp.stack([jnp.asarray(c.world_view_transform) for c in cams]),
            "proj": jnp.stack([jnp.asarray(c.full_proj_transform) for c in cams]),
            "campos": jnp.stack([jnp.asarray(c.camera_center) for c in cams]),
            "tanfovx": jnp.asarray([c.tanfovx for c in cams], jnp.float32),
            "tanfovy": jnp.asarray([c.tanfovy for c in cams], jnp.float32)}


def port_cams(cams):
    return camera_tensors([TCamera(**dataclasses.asdict(c)) for c in cams], "cpu")


def scene_inputs(scene):
    return {k: scene[k] for k in ("means3d", "scales", "quats", "opacities", "shs")}


def assemble(outs, get, n_dp, n_tp):
    """The global [B, C, H, W] array from each rank's [b_local, C, band, W]
    (`get` picks the array out of a rank's results)."""
    return torch.cat([torch.cat([get(outs[dp * n_tp + tp]) for tp in range(n_tp)], dim=2)
                      for dp in range(n_dp)]).numpy()


def fps_draws(vae_key, n, k, c_batch, n_tp, shard):
    """JAX's per-camera SH / scale noise (make_fps_camera_render's draws:
    per tp shard when the splats are sharded), laid out as [C, N, ...]."""
    shs, scl = [], []
    for g in range(c_batch):
        k1, k2 = jax.random.split(jax.random.fold_in(vae_key, g + 1))
        if not shard:
            shs.append(np.asarray(jax.random.normal(k1, (n, k, 3))))
            scl.append(np.asarray(jax.random.normal(k2, (n, 3))))
            continue
        m = n // n_tp
        shs.append(np.concatenate([np.asarray(jax.random.normal(jax.random.fold_in(k1, i),
                                                                (m, k, 3)))
                                   for i in range(n_tp)]))
        scl.append(np.concatenate([np.asarray(jax.random.normal(jax.random.fold_in(k2, i),
                                                                (m, 3)))
                                   for i in range(n_tp)]))
    return np.stack(shs), np.stack(scl)


def fps_case(shard, rng):
    """Inputs, JAX outputs and JAX VJP of make_fps_camera_render on (2, 2)."""
    scene = make_scene(200, seed=5)
    n, k = 200, 9
    cams = [make_camera(64, 64, azim=0.3 + 0.4 * i, elev=0.2 - 0.1 * i) for i in range(4)]
    active = rng.rand(n) > 0.1
    inputs = dict(xyz=np.asarray(scene["means3d"]), features=np.asarray(scene["shs"]),
                  scaling=np.asarray(scene["scales"]), rotation=np.asarray(scene["quats"]),
                  opacities=np.asarray(scene["opacities"]), active=active)
    vae_key = jax.random.key(11)
    shs_noise, scale_noise = fps_draws(vae_key, n, k, 4, 2, shard)
    ct = dict(images=rng.randn(4, 3, 64, 64).astype(np.float32),
              disps=rng.randn(4, 1, 64, 64).astype(np.float32),
              alphas=rng.randn(4, 1, 64, 64).astype(np.float32),
              scales_mean=np.float32(3.0))
    fn = JSR.make_fps_camera_render(JSR.make_mesh(2, 2), 64, 64, sh_degree=2, capacity=800,
                                    c_batch=4, chunk=128, shard_splats=shard, interpret=True)
    probes = np.zeros((4, n, 2), np.float32)
    floats = {kk: jnp.asarray(v) for kk, v in inputs.items() if kk != "active"}

    def run(fl, pr):
        return fn({**fl, "active": jnp.asarray(active)}, jax_cams(cams), jnp.asarray(AUG),
                  pr, vae_key)

    def loss(fl, pr):
        im, dp, al, _, _, sm, _, _ = run(fl, pr)
        return (jnp.sum(im * ct["images"]) + jnp.sum(dp * ct["disps"])
                + jnp.sum(al * ct["alphas"]) + ct["scales_mean"] * sm[0])

    outs = [np.asarray(o) for o in jax.jit(run)(floats, jnp.asarray(probes))]
    g_in, g_pr = jax.jit(jax.grad(loss, argnums=(0, 1)))(floats, jnp.asarray(probes))
    port = dict(inputs={kk: t(v) for kk, v in inputs.items()}, cams=port_cams(cams),
                aug=AUG.tolist(), probes=t(probes), shs_noise=t(shs_noise),
                scale_noise=t(scale_noise), ct={kk: t(v) for kk, v in ct.items()})
    ref = dict(zip(("images", "disps", "alphas", "radii", "visible", "scales_mean",
                    "n_entries", "n_dropped"), outs))
    ref["grads"] = {kk: np.asarray(v) for kk, v in g_in.items()}
    ref["probe_grad"] = np.asarray(g_pr)
    return port, ref


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    d = tmp_path_factory.mktemp("ranks")
    rng = np.random.RandomState(0)
    inputs, ref = {}, {}

    scene = make_scene(200, seed=0)
    cam = make_camera(64, 64)
    inputs["band"] = dict(inputs={k: t(v) for k, v in scene_inputs(scene).items()},
                          cams=port_cams([cam, cam]), bg=torch.zeros(2, 3))
    fn = JSR.make_sharded_render(JSR.make_mesh(2, 2), 64, 64, 2, capacity=800, chunk=128,
                                 interpret=True)
    ref["band"] = [np.asarray(o) for o in jax.jit(fn)(scene_inputs(scene), jax_cams([cam] * 2),
                                                     jnp.zeros((2, 3)))]

    pscene = make_scene(96, seed=11)
    pcam = make_camera(32, 64)
    inputs["prim"] = dict(inputs={k: t(v) for k, v in scene_inputs(pscene).items()},
                          cams=port_cams([pcam, pcam]), bg=torch.zeros(2, 3))
    pfn = JSR.make_primitive_sharded_render(JSR.make_mesh(2, 2), 32, 64, 2, capacity=4 * 96,
                                            chunk=128, interpret=True)

    def ploss(m3):
        imgs, _ = pfn({**scene_inputs(pscene), "means3d": m3}, jax_cams([pcam] * 2),
                      jnp.zeros((2, 3)))
        return jnp.sum(imgs ** 2) / 2.0

    ref["prim"] = [np.asarray(o) for o in jax.jit(pfn)(scene_inputs(pscene),
                                                       jax_cams([pcam] * 2), jnp.zeros((2, 3)))]
    ref["prim_grad"] = np.asarray(jax.jit(jax.grad(ploss))(pscene["means3d"]))

    for shard in (False, True):
        key = "fps_shard" if shard else "fps"
        inputs[key], ref[key] = fps_case(shard, rng)

    pts = rng.randn(60, 3).astype(np.float32)
    inputs["state"] = create_from_points(pts, rng.rand(60, 3).astype(np.float32), sh_degree=1,
                                         capacity=200, device="cpu")
    inputs["state_odd"] = create_from_points(pts, rng.rand(60, 3).astype(np.float32),
                                             sh_degree=1, capacity=201, device="cpu")
    torch.save(inputs, d / "inputs.pt")
    run_ranks(torch_ranks.functions, 4, (str(d),), device="cpu", store_dir=str(d),
              timeout_s=150)
    outs = [torch.load(d / f"out_{r}.pt", weights_only=False) for r in range(4)]
    return inputs, ref, outs


def test_rank_layout_is_row_major(results):
    _, _, outs = results
    for r, o in enumerate(outs):
        assert o["coords"][0] == {"dp": r // 2, "tp": r % 2}
        assert o["coords"][1] == {"dp": 0, "tp": r}


@pytest.mark.parametrize("mesh", ["2x2", "1x4"])
def test_band_render_matches_jax_and_single_device(results, mesh):
    """Stacked bands equal JAX's shard_map render on (2, 2) and the port's
    single-process render; the dp replicas agree."""
    inputs, ref, outs = results
    n_dp, n_tp = (2, 2) if mesh == "2x2" else (1, 4)
    key = "band22" if mesh == "2x2" else "band14"
    imgs = assemble(outs, lambda o: o[key][0], n_dp, n_tp)
    alphas = assemble(outs, lambda o: o[key][1], n_dp, n_tp)
    np.testing.assert_allclose(imgs, ref["band"][0], **IMG_TOL)
    np.testing.assert_allclose(alphas, ref["band"][1], **IMG_TOL)
    b = inputs["band"]
    single = t_render(**b["inputs"], **b["cams"][0], width=64, height=64, bg=torch.zeros(3),
                      sh_degree=2, capacity=800, chunk=128, device="cpu")
    np.testing.assert_allclose(imgs[0], single["image"].numpy(), **IMG_TOL)
    np.testing.assert_allclose(imgs[1], imgs[0], atol=1e-6)


def test_primitive_sharded_render_forward_and_gradient(results):
    """Splat shards + bands: images against JAX's, and the gradient of
    sum(image^2)/2 w.r.t. means3d through the record all-gather and its
    reduce-scatter."""
    _, ref, outs = results
    imgs = assemble(outs, lambda o: o["prim"][0], 2, 2)
    np.testing.assert_allclose(imgs, ref["prim"][0], **IMG_TOL)
    grad = torch.cat([outs[tp]["prim"][2] for tp in range(2)]).numpy()
    np.testing.assert_allclose(grad, ref["prim_grad"], **GRAD_TOL)
    for tp in range(2):     # the dp ranks of one shard hold the same gradient
        assert torch.equal(outs[tp]["prim"][2], outs[2 + tp]["prim"][2])


@pytest.mark.parametrize("shard", [False, True], ids=["replicated", "shard_splats"])
def test_fps_camera_render_matches_jax(results, shard):
    """All eight outputs of make_fps_camera_render and the VJP of a fixed
    cotangent, with JAX's own noise draws (per shard in shard mode)."""
    _, ref_all, outs = results
    key = "fps_shard" if shard else "fps"
    ref = ref_all[key]
    o = [x[key] for x in outs]
    for name in ("images", "disps", "alphas"):
        np.testing.assert_allclose(assemble(o, lambda x: x[name], 2, 2), ref[name], **IMG_TOL,
                                   err_msg=name)
    rows = (lambda r, v: torch.cat([o[tp][v] for tp in range(2)])) if shard else \
        (lambda r, v: o[r][v])
    for r in range(4):
        np.testing.assert_array_equal(rows(r, "radii").numpy(), ref["radii"])
        np.testing.assert_array_equal(rows(r, "visible").numpy(), ref["visible"])
        assert int(o[r]["n_entries"]) == int(ref["n_entries"][0])
        assert int(o[r]["n_dropped"]) == int(ref["n_dropped"][0])
        np.testing.assert_allclose(float(o[r]["scales_mean"]), ref["scales_mean"][0], rtol=1e-5)
    for name, g in ref["grads"].items():
        got = (torch.cat([o[tp]["grads"][name] for tp in range(2)]) if shard
               else o[0]["grads"][name]).numpy()
        np.testing.assert_allclose(got, g, rtol=2e-3, atol=2e-4 * np.abs(g).max(),
                                   err_msg=name)
    # probe gradients: the rank of each camera (and shard) holds its rows
    pg = torch.cat([torch.cat([o[dp * 2 + tp]["probe_grad"] for tp in range(2)], dim=1)
                    if shard else o[dp * 2]["probe_grad"] for dp in range(2)]).numpy()
    g = ref["probe_grad"]
    np.testing.assert_allclose(pg, g, rtol=2e-3, atol=2e-4 * np.abs(g).max())


def test_shard_and_gather_splat_state(results):
    """The JAX contract (test_parallel.py:223-245): splat-major rows of
    params, Adam moments and aux become cap / n_tp per rank; background and
    the step count stay whole; gathering restores the state; a capacity
    that does not divide stays whole, with a warning."""
    inputs, _, outs = results
    st = inputs["state"]
    for r, o in enumerate(outs):
        s = o["state"]
        assert s["rows"] == {"params.xyz": 100, "opt.mu.xyz": 100, "opt.nu.scaling": 100,
                             "aux.active": 100}, s["rows"]
        assert s["background"] == (3,) and s["count"] == st.opt.count
        assert s["global_capacity"] == 200 and s["back_equal"]
        tp = r % 2
        assert torch.equal(s["local_xyz"], st.params["xyz"][tp * 100:(tp + 1) * 100])
        assert s["odd_rows"] == 201 and s["odd_global"] is None
        assert any("201" in w for w in s["warnings"]), s["warnings"]
