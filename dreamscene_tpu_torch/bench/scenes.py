"""Seeded scenes at the compositing kernels' inputs, for the card checks
and the kernel benches: a perturbed ball of splats seen by one random
camera, the scene path's two configurations (`composition_scene`: config
#3's five placed objects at 800^2; `indoor_scene`: config #4's env, floor
and placed objects seen by a stage-1 camera), projected and binned into
everything K1-K3 take, and the per-tile distribution of the binned work.
Needs one CUDA card.
"""

from __future__ import annotations

import numpy as np
import torch


def make_scene(n_pts, width, height, seed, cache_dir, rng_cam_seed=0):
    """The trainer's first-step inputs: ball init + one random camera.
    `cache_dir` receives the init cloud's cache file."""
    from dreamscene_tpu_torch.cameras import sampling as S
    from dreamscene_tpu_torch.models.gaussians import create_from_points
    from dreamscene_tpu_torch.models.init import init_object_points
    from dreamscene_tpu_torch.utils.config import GenerateCamParams

    pts, cols, sls = init_object_points("default", "", str(cache_dir), num_pts=n_pts,
                                        seed=seed)
    st = create_from_points(pts, cols, sh_degree=2, capacity=min(4 * n_pts, n_pts + 10000),
                            spatial_lr_scale=sls, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(seed)
    # perturb the fresh state so opacities, colours and shapes vary
    st.params["features_rest"].normal_(0.0, 0.2, generator=g)
    st.params["opacity"].normal_(-1.0, 1.5, generator=g)
    st.params["scaling"].add_(torch.randn(st.params["scaling"].shape, device="cuda",
                                          generator=g) * 0.5)
    st.params["rotation"].normal_(0.0, 1.0, generator=g)
    pose = GenerateCamParams(image_w=width, image_h=height)
    cam = S.load_random_cam(np.random.default_rng(rng_cam_seed), pose, ssaa=True)
    return st, cam


# config #3 (scripts/bench_compositional.py): five 60K-splat objects at 800^2
COMP_CENTERS = ((-2.0, -1.5, 0.0), (2.0, -1.5, 0.0), (0.0, 0.5, 0.0), (-1.5, 2.0, 0.0),
                (1.8, 1.8, 0.0))


def orbit_camera(width, height, radius=4.0, theta=80.0, phi=30.0):
    """The camera of scripts/bench_compositional.py (50 deg FoV)."""
    import math

    from dreamscene_tpu_torch.cameras import Camera
    from dreamscene_tpu_torch.cameras.sampling import _pose_to_rt, circle_poses

    R, T = _pose_to_rt(circle_poses(radius, theta, phi))
    return Camera(R=R.astype(np.float32), T=T.astype(np.float32), fovx=math.radians(50),
                  fovy=math.radians(50), width=width, height=height)


def composition_scene(n_pts=60_000, size=800):
    """Config #3's five objects, seeded as scripts/bench_compositional.py
    seeds them, placed with place_object at its centres, rotated 36 deg * i;
    returns the placed states and the camera."""
    from dreamscene_tpu_torch.models.gaussians import create_from_points
    from dreamscene_tpu_torch.models.scene import place_object

    states = []
    for i, center in enumerate(COMP_CENTERS):
        rng = np.random.RandomState(i)
        pts = rng.randn(n_pts, 3).astype(np.float32) * 0.35
        st = create_from_points(pts, rng.rand(n_pts, 3).astype(np.float32), sh_degree=2,
                                capacity=n_pts, device="cuda")
        states.append(place_object(st, center, rotation=[0.0, 0.0, 36.0 * i], scale=1.0)[0])
    return states, orbit_camera(size, size)


def indoor_scene(config_path, obj_pts=30_000, seed=0):
    """Config #4 without the trainer: configs/scenes/sample_indoor.yaml's
    env and floor at full density (capacities as prepare_train_scene sets
    them), its four placed instances as seeded balls of `obj_pts` splats,
    all concatenated (objects, floor, env), and the first stage-1 camera;
    returns (state, camera, the scene step's entry capacity at the
    starting multiplier)."""
    from dreamscene_tpu_torch.cameras.scene_sampling import SceneCameraLoader
    from dreamscene_tpu_torch.models.gaussians import create_from_points
    from dreamscene_tpu_torch.models.init import init_env_points, init_floor_points, sample_ball
    from dreamscene_tpu_torch.models.scene import final_combine_all, place_object
    from dreamscene_tpu_torch.utils.config import load_config

    cfg = load_config(str(config_path), [])
    sc = cfg.scene_configs["scene"]
    box = np.zeros(6, np.float32)
    states, args = [], []
    for j, obj in enumerate(sc["scene_composition"]):
        rng = np.random.RandomState(seed + j)
        base = create_from_points(sample_ball(obj_pts, 0.5, rng).astype(np.float32),
                                  rng.rand(obj_pts, 3).astype(np.float32), sh_degree=1,
                                  capacity=obj_pts, device="cuda")
        for tp in obj["params"]:
            placed, oa, bbox = place_object(base, tp["center"], tp["rotation"], tp["scale"])
            states.append(placed)
            args.append(oa)
            box[:3], box[3:] = np.minimum(box[:3], bbox[:3]), np.maximum(box[3:], bbox[3:])
    cfg_box = np.zeros(6, np.float32)
    cfg_box[3:] = np.asarray(sc["radius"], np.float32)
    cfg_box[:2] = -cfg_box[3:5]
    box[:3], box[3:] = np.minimum(box[:3], cfg_box[:3]), np.maximum(box[3:], cfg_box[3:])
    max_pts = cfg.sceneOptimizationParams.max_point_number
    env = init_env_points("indoor", box, sc["env_init_color"], seed=cfg.seed)
    floor = init_floor_points("indoor", box, sc["floor_init_color"], seed=cfg.seed + 1)
    states.append(create_from_points(*floor, sh_degree=1, device="cuda",
                                     capacity=min(int(floor[0].shape[0] * 1.5), max_pts // 3)))
    states.append(create_from_points(*env, sh_degree=1, device="cuda",
                                     capacity=min(int(env[0].shape[0] * 1.5), max_pts)))
    loader = SceneCameraLoader(np.random.default_rng(cfg.seed), cfg.sceneGenerateCamParams,
                               box, args, "indoor")
    rows = sum(st.capacity for st in states)
    return final_combine_all(states), loader.Stage1_Indoor()[0], 4 * rows // 2


def binned_inputs(st, cam, tile_w, tile_h, chunk=512, sh_degree=2, capacity=None,
                  band=None):
    """Project and bin one view of a GaussianState at `capacity` entries
    (default 4 per splat row); returns everything the kernels take. `band`
    = (first row, rows): the tile band a rank of the mesh path bins (screen
    y shifted by the first row after projecting against the whole image)."""
    return binned_splats(st.get_xyz, st.get_scaling, st.get_rotation, st.get_opacity[:, 0],
                         st.get_features, cam, tile_w, tile_h, chunk=chunk,
                         sh_degree=sh_degree, capacity=capacity, band=band,
                         valid_mask=st.aux["active"])


def binned_splats(means3d, scales, quats, opacities, shs, cam, tile_w, tile_h, chunk=512,
                  sh_degree=2, capacity=None, band=None, valid_mask=None):
    """`binned_inputs` on splat arrays as `render` takes them."""
    from dreamscene_tpu_torch.ops import binning
    from dreamscene_tpu_torch.ops.gather import row_gather
    from dreamscene_tpu_torch.ops.projection import project_gaussians

    dev = torch.device("cuda")
    with torch.no_grad():
        sp = project_gaussians(
            means3d, scales, quats, opacities, shs,
            torch.as_tensor(cam.world_view_transform, device=dev),
            torch.as_tensor(cam.full_proj_transform, device=dev),
            torch.as_tensor(cam.camera_center, device=dev), cam.tanfovx,
            cam.tanfovy, cam.width, cam.height, sh_degree=sh_degree,
            valid_mask=valid_mask)
        n = sp.means2d.shape[0]
        capacity = capacity or 4 * n
        height, means2d = cam.height, sp.means2d
        if band is not None:
            height = band[1]
            means2d = means2d - means2d.new_tensor([0.0, float(band[0])])
        ex = binning.expand_args(means2d, sp.depths, sp.radii, sp.visible,
                                 cam.width, height, capacity, sp.conics,
                                 sp.opacities, None, tile_w, tile_h)
        b = binning.bin_splats(means2d, sp.depths, sp.radii, sp.visible,
                               cam.width, height, capacity=capacity,
                               chunk=chunk, conics=sp.conics,
                               opacities=sp.opacities, tile_w=tile_w, tile_h=tile_h)
        rec_n = torch.cat([means2d, sp.conics, sp.opacities[:, None], sp.colors,
                           sp.depths[:, None], sp.means2d.new_zeros((n, 6))], 1)
        cap_pad = binning.cdiv(capacity, 128) * 128 + chunk
        gid_pad = torch.cat([b.gid_sorted, torch.zeros(cap_pad - capacity, dtype=torch.int32,
                                                        device=dev)])
        records_t = row_gather(rec_n, gid_pad).t().contiguous()
    tiles_x = binning.cdiv(cam.width, tile_w)
    n_tiles = tiles_x * binning.cdiv(height, tile_h)
    meta = (b.chunk_tile, b.chunk_s0, b.chunk_lo, b.chunk_hi, b.chunk_first,
            b.n_chunks_used)
    return dict(ex=ex, binned=b, records_t=records_t, meta=meta, n_tiles=n_tiles,
                tiles_x=tiles_x, chunk=chunk, tile_w=tile_w, tile_h=tile_h)


def tile_stats(inp):
    """How this scene's work spreads over the tiles: chunks and live entries
    per tile (K2's longest serial chain was the busiest tile's entries when
    a CTA owned a tile; it is one chunk now)."""
    ct, _, lo, hi, _, n_used = inp["meta"]
    n_u, n_tiles = int(n_used), inp["n_tiles"]
    tiles = ct[:n_u].long()
    chunks = torch.bincount(tiles, minlength=n_tiles)[:n_tiles]
    live = torch.zeros(n_tiles, dtype=torch.long, device=ct.device)
    live.index_add_(0, tiles, (hi[:n_u] - lo[:n_u]).clamp_min(0).long())
    busy = live[live > 0]
    top = max(1, n_tiles // 100)
    return {"tiles": n_tiles, "chunks_used": n_u, "chunks_allocated": int(ct.shape[0]),
            "empty_tile_share": float((live == 0).float().mean()),
            "chunks_per_tile_max": int(chunks.max()),
            "chunks_per_tile_median": float(chunks.float().median()),
            "entries_per_tile_max": int(live.max()),
            "entries_per_tile_median": float(live.float().median()),
            "entries_per_busy_tile_median": float(busy.float().median()) if busy.numel() else 0.0,
            "entries_per_tile_mean": float(live.float().mean()),
            "entries_share_of_busiest_1pct_tiles":
                float(live.sort(descending=True).values[:top].sum() / live.sum().clamp_min(1))}
