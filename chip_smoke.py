"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py      # needs one CUDA card

Phases (any failure exits non-zero; nothing is caught):
  1. card name and power limit (nvidia-smi), kernel build (with ptxas's
     registers / shared memory per kernel; the six sources in parallel)
     and its time;
  2. each hand-written kernel against its plain PyTorch version on the
     card, on seeded scenes: a small one, a 16x16-tile leg and the main
     path's full width (50K splats, 512^2, 32x16 tiles). K3 bit-equal;
     K1 rows R,G,B,DEPTH,T at atol 1e-5 / rtol 1e-4 and LIVE equal; K2
     within 1e-4 of max|g| and bit-identical across two runs. Times of
     kernel and plain version at full width;
  2b. K4 (flash attention forward, dK/dV, dQ) against its plain versions
     at every shape the main path gives it (bf16) plus one f32 case:
     f32 at atol 2e-6 (forward) / 5e-6 (gradients), bf16 at max|d| <=
     2^-7 max|plain|; times of kernels, plain versions, SDPA (forward and
     forward+backward) and the matmul + f32-softmax module path;
  3. the slice: ObjectTrainer at BASELINE.json config #2 width (50K
     points, sh_degree 2, 512^2, C_batch 4, SD2.1-architecture UNet + full
     VAE with seeded random weights, 77 tokens, densify off), DS_FLASH_ATTN
     unset: prepare_train, 2 warm-up + 5 timed train_step()s, launch counts
     (K1-K3 once per camera, K4 never), one step under torch.profiler
     (device time by phase and kernel); then the same 7 steps with
     DS_FLASH_ATTN=1, timed, with the K4 launches checked against the
     ladder lengths;
  3b. ObjectTrainer.train(make_videos=True) at config #2 width with
     DS_FLASH_ATTN=1 and configs/objects/sample.yaml's cadences, from step
     1496 to 1502 (densify/prune, opacity reset, 48-view filter, SH
     step-up, guidance viz and a video all fire at step 1500), a snapshot
     PLY, the refine phase (9 pseudo-GT chunks, 18 recon steps, one recon
     densify), the final video and PLY; K4 launches checked against the
     UNet passes and VAE calls; wall time of each part;
  4. one small FPS step on the card against the same step on the CPU
     (plain versions), same state, weights and random draws.
The line before the last is the kernel table as JSON; the last line is
{"ok": true, "device": {...}}.
"""

import glob
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

# peak rates of one H100 SXM (NVIDIA data sheet, dense)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
BF16_FLOPS = 989e12
# float operations per evaluated (entry, pixel) pair, counted from the
# kernels' inner loops (csrc/composite_*.cu): K1 evaluates alpha (~16 incl.
# exp) and accumulates (~11); K2 replays alpha and forms the 10 per-entry
# terms (~55) plus its share of the warp sums (~10)
FWD_OPS_PER_PAIR = 27
BWD_OPS_PER_PAIR = 65
N_STEPS_WARM, N_STEPS_TIMED = 2, 5

SOURCES = {
    "expand_entries": ("dreamscene_tpu_torch/csrc/expand.cu",
                       "dreamscene_tpu/ops/expand.py:49"),
    "composite_fwd": ("dreamscene_tpu_torch/csrc/composite_fwd.cu",
                      "dreamscene_tpu/ops/composite.py:354"),
    "composite_bwd": ("dreamscene_tpu_torch/csrc/composite_bwd.cu",
                      "dreamscene_tpu/ops/composite.py:565"),
    # K4: the library kernel behind dreamscene_tpu/guidance/sd_flax.py:120
    "flash_fwd": ("dreamscene_tpu_torch/csrc/flash_fwd.cu",
                  "jax/experimental/pallas/ops/tpu/flash_attention.py:758"),
    "flash_bwd_dkv": ("dreamscene_tpu_torch/csrc/flash_bwd_dkv.cu",
                      "jax/experimental/pallas/ops/tpu/flash_attention.py:1121"),
    "flash_bwd_dq": ("dreamscene_tpu_torch/csrc/flash_bwd_dq.cu",
                     "jax/experimental/pallas/ops/tpu/flash_attention.py:1456"),
}
K1_K3 = ("expand_entries", "composite_fwd", "composite_bwd")
K4 = ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq")
BUILD = Path(__file__).resolve().parent / "build"
# K4's shapes on the main path at config #2 width ([b, h, n, d], bf16),
# plus one float32 case; the row each kernel's table entry reports
K4_SHAPES = (("unet 64x64 self-attn", (12, 5, 4096, 64), torch.bfloat16),
             ("unet 32x32 self-attn", (12, 10, 1024, 64), torch.bfloat16),
             ("vae mid-attn, encode/pseudo-GT batch 4", (4, 1, 4096, 512), torch.bfloat16),
             ("vae mid-attn, viz batch 1", (1, 1, 4096, 512), torch.bfloat16),
             ("f32 check", (2, 5, 4096, 64), torch.float32))
K4_ROW = {"flash_fwd": "unet 64x64 self-attn",
          "flash_bwd_dkv": "vae mid-attn, encode/pseudo-GT batch 4",
          "flash_bwd_dq": "vae mid-attn, encode/pseudo-GT batch 4"}


def log(*a):
    print(*a, flush=True)


def fresh_dir(tag: str) -> str:
    """A new directory under build/ (experiment folders and init-cloud
    caches must not carry over between runs)."""
    BUILD.mkdir(exist_ok=True)
    return tempfile.mkdtemp(prefix=f"chip_smoke_{tag}_", dir=BUILD)


def cuda_time(fn, reps):
    """Mean ms per call over `reps` calls, CUDA events, after one warm call."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def make_scene(n_pts, width, height, seed, rng_cam_seed=0):
    """The trainer's first-step inputs: ball init + one random camera."""
    from dreamscene_tpu_torch.cameras import sampling as S
    from dreamscene_tpu_torch.models.gaussians import create_from_points
    from dreamscene_tpu_torch.models.init import init_object_points
    from dreamscene_tpu_torch.utils.config import GenerateCamParams

    pts, cols, sls = init_object_points("default", "", fresh_dir("init"), num_pts=n_pts,
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


def binned_inputs(st, cam, tile_w, tile_h, chunk=512):
    """Project and bin one view; returns everything the kernels take."""
    from dreamscene_tpu_torch.ops import binning
    from dreamscene_tpu_torch.ops.projection import project_gaussians

    dev = torch.device("cuda")
    with torch.no_grad():
        sp = project_gaussians(
            st.get_xyz, st.get_scaling, st.get_rotation, st.get_opacity[:, 0],
            st.get_features, torch.as_tensor(cam.world_view_transform, device=dev),
            torch.as_tensor(cam.full_proj_transform, device=dev),
            torch.as_tensor(cam.camera_center, device=dev), cam.tanfovx,
            cam.tanfovy, cam.width, cam.height, sh_degree=2,
            valid_mask=st.aux["active"])
        n = sp.means2d.shape[0]
        capacity = 4 * n
        ex = binning.expand_args(sp.means2d, sp.depths, sp.radii, sp.visible,
                                 cam.width, cam.height, capacity, sp.conics,
                                 sp.opacities, None, tile_w, tile_h)
        b = binning.bin_splats(sp.means2d, sp.depths, sp.radii, sp.visible,
                               cam.width, cam.height, capacity=capacity,
                               chunk=chunk, conics=sp.conics,
                               opacities=sp.opacities, tile_w=tile_w, tile_h=tile_h)
        rec_n = torch.cat([sp.means2d, sp.conics, sp.opacities[:, None], sp.colors,
                           sp.depths[:, None], sp.means2d.new_zeros((n, 6))], 1)
        cap_pad = binning.cdiv(capacity, 128) * 128 + chunk
        gid_pad = torch.cat([b.gid_sorted, torch.zeros(cap_pad - capacity, dtype=torch.int32,
                                                        device=dev)])
        records_t = rec_n.index_select(0, gid_pad.long()).t().contiguous()
    tiles_x = binning.cdiv(cam.width, tile_w)
    n_tiles = tiles_x * binning.cdiv(cam.height, tile_h)
    meta = (b.chunk_tile, b.chunk_s0, b.chunk_lo, b.chunk_hi, b.chunk_first,
            b.n_chunks_used)
    return dict(ex=ex, binned=b, records_t=records_t, meta=meta, n_tiles=n_tiles,
                tiles_x=tiles_x, chunk=chunk, tile_w=tile_w, tile_h=tile_h)


def pair_count(inp):
    """Live entries, and the entry-pixel pairs this scene's compositing
    evaluates: in each chunk a pixel evaluates its live entries up to and
    including the one that stops it (the plain version's `applied` mask)."""
    from dreamscene_tpu_torch.ops import composite as C

    b = inp["binned"]
    live = (b.chunk_hi - b.chunk_lo).clamp_min(0).sum().item()
    rt, (ct, s0, lo, hi, _, n_used) = inp["records_t"], inp["meta"]
    tile_pix, chunk = inp["tile_w"] * inp["tile_h"], inp["chunk"]
    t_state = torch.ones((inp["n_tiles"] + 1, tile_pix), device=rt.device)
    lanes = torch.arange(chunk, device=rt.device)
    pairs = 0
    for us in C._slots(ct, n_used):
        for grp in C._groups(us, tile_pix, chunk):
            grp = grp[hi[grp] > lo[grp]]
            if grp.numel() == 0:
                continue
            tiles = ct[grp].long()
            v = C._chunk_block(rt, grp, ct, s0, lo, hi, t_state[tiles], inp["tiles_x"],
                               chunk, inp["tile_w"], inp["tile_h"])
            window = (lanes >= lo[grp, None]) & (lanes < hi[grp, None])
            pairs += int((v["applied"] & window[:, None, :]).sum())
            pairs += int((~v["applied"][:, :, -1]).sum())
            t_state[tiles] = v["t_new"]
    return live, pairs


def check_kernels(label, inp, timing):
    """Phase 2 on one scene. Returns a dict of rows when `timing`."""
    from dreamscene_tpu_torch.ops import composite as C
    from dreamscene_tpu_torch.ops import expand as E

    kw = inp["ex"]["kwargs"]
    key_k, gid_k = E.expand_entries(**kw)
    key_p, gid_p = E.expand_entries_plain(**kw)
    torch.cuda.synchronize()
    n_bad = int((key_k != key_p).sum() + (gid_k != gid_p).sum())
    assert n_bad == 0, f"{label}: expand kernel differs from plain in {n_bad} slots"
    err_k3 = float((key_k.long() - key_p.long()).abs().max())

    geo = dict(n_tiles=inp["n_tiles"], tiles_x=inp["tiles_x"], chunk=inp["chunk"],
               tile_w=inp["tile_w"], tile_h=inp["tile_h"])
    rt, meta = inp["records_t"], inp["meta"]
    out_k = C.composite_forward(rt, *meta, **geo)
    out_p = C.composite_forward_plain(rt, *meta[:4], meta[5], **geo)
    torch.cuda.synchronize()
    a, b = out_k[:, :5], out_p[:, :5]
    err_k1 = float((a - b).abs().max())
    ok = torch.isclose(a, b, atol=1e-5, rtol=1e-4).all().item()
    assert ok, f"{label}: composite_fwd max abs err {err_k1}"
    assert torch.equal(out_k[:, 5], out_p[:, 5]), f"{label}: LIVE rows differ"

    gen = torch.Generator(device="cuda").manual_seed(7)
    g_out = torch.randn(out_p.shape, device="cuda", generator=gen)
    gk1 = C.composite_backward(rt, *meta, out_k, g_out, **geo)
    gk2 = C.composite_backward(rt, *meta, out_k, g_out, **geo)
    gp = C.composite_backward_plain(rt, *meta[:4], meta[5], out_k, g_out, **geo)
    torch.cuda.synchronize()
    assert torch.equal(gk1, gk2), f"{label}: composite_bwd not bit-reproducible"
    err_k2 = float((gk1 - gp).abs().max())
    gmax = float(gp.abs().max())
    assert err_k2 <= 1e-4 * gmax, f"{label}: composite_bwd err {err_k2} vs max|g| {gmax}"
    live, pairs = pair_count(inp)
    log(f"[kernels] {label}: n_entries {int(inp['binned'].n_entries)} live {live} "
        f"pairs {pairs}: expand bit-equal, fwd err {err_k1:.3g}, "
        f"bwd err {err_k2:.3g} (max|g| {gmax:.3g}), bwd bit-reproducible")
    errs = {"expand_entries": err_k3, "composite_fwd": err_k1, "composite_bwd": err_k2}
    if not timing:
        return errs, None

    n = kw["n"]
    cap = kw["capacity"]
    n_chunks = meta[0].shape[0]
    tile_pix = inp["tile_w"] * inp["tile_h"]
    acc_bytes = (inp["n_tiles"] + 1) * 8 * tile_pix * 4
    # kernel times: the launches alone, inputs validated and allocated once
    k3 = E.prepare_expand(block=E.BLOCK, **kw)
    k1 = C.prepare_forward(rt, *meta[:4], inp["n_tiles"], inp["tiles_x"], inp["tile_w"],
                           inp["tile_h"])
    k2 = C.prepare_backward(rt, *meta[:4], meta[5], out_k, g_out, inp["n_tiles"],
                            inp["tiles_x"], inp["chunk"], inp["tile_w"], inp["tile_h"])
    rows = {}
    rows["expand_entries"] = dict(
        ms=cuda_time(lambda: E.launch_expand(*k3), 50),
        plain_ms=cuda_time(lambda: E.expand_entries_plain(**kw), 5),
        bytes=6 * n * 4 + 2 * cap * 4, ops=0)
    rows["composite_fwd"] = dict(
        ms=cuda_time(lambda: C.launch_forward(*k1), 20),
        plain_ms=cuda_time(lambda: C.composite_forward_plain(rt, *meta[:4], meta[5], **geo), 3),
        bytes=live * 10 * 4 + 4 * n_chunks * 4 + acc_bytes,
        ops=pairs * FWD_OPS_PER_PAIR)
    rows["composite_bwd"] = dict(
        ms=cuda_time(lambda: C.launch_backward(*k2), 20),
        plain_ms=cuda_time(lambda: C.composite_backward_plain(
            rt, *meta[:4], meta[5], out_k, g_out, **geo), 3),
        bytes=live * 10 * 4 + 4 * n_chunks * 4 + 2 * acc_bytes + 16 * n_chunks * inp["chunk"] * 4,
        ops=pairs * BWD_OPS_PER_PAIR)
    for r in rows.values():
        t_bytes = r["bytes"] / HBM_BYTES_PER_S * 1e3
        t_ops = r["ops"] / FP32_FLOPS * 1e3
        r["bound_ms"] = max(t_bytes, t_ops)
        r["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    log(f"[kernels] full-width times: " + json.dumps(
        {k: {"ms": v["ms"], "plain_ms": v["plain_ms"], "bound_ms": v["bound_ms"]}
             for k, v in rows.items()}))
    return errs, rows


def k4_flops_bytes(shape, dtype):
    """Work of each K4 kernel on one call: FLOPs counted from the kernels'
    own loops (forward: q.k and p.v, 2d each per (query, key) pair; dK/dV:
    q.k, do.v, p^T.do, ds^T.q; dQ: q.k, do.v, ds.k) and bytes moved (each
    input read once, each output written once)."""
    b, h, n, d = shape
    pairs, e = b * h * n * n, torch.tensor([], dtype=dtype).element_size()
    head, rows = b * h * n * d * e, b * h * n * 4
    return {"flash_fwd": (4 * pairs * d, 4 * head + 2 * rows),
            "flash_bwd_dkv": (8 * pairs * d, 6 * head + 3 * rows),
            "flash_bwd_dq": (6 * pairs * d, 5 * head + 3 * rows)}


def bound(flops, nbytes, dtype):
    t_ops = flops / (BF16_FLOPS if dtype == torch.bfloat16 else FP32_FLOPS) * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def check_flash(label, shape, dtype, timing=True):
    """Phase 2b on one shape: the three K4 kernels against their plain
    versions (the backward kernels on the plain forward's o, l, m, with
    do = cos(o) as the JAX suite's loss gives), then times."""
    import torch.nn.functional as F

    from dreamscene_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(shape[2] + shape[3])
    q, k, v = (torch.randn(shape, device="cuda", generator=gen).to(dtype) for _ in range(3))
    scale = shape[3] ** -0.5
    o_k, l_k, m_k = fa.flash_fwd(q, k, v, scale)
    o_p, l_p, m_p = fa.flash_attention_fwd_plain(q, k, v, scale)
    do = torch.cos(o_p.float()).to(dtype)
    g_k = fa.flash_bwd(q, k, v, o_p, l_p, m_p, do, scale)
    di = (o_p.float() * do.float()).sum(-1)
    g_p = fa.flash_attention_bwd_plain(q, k, v, l_p, m_p, do, di, scale)
    torch.cuda.synchronize()
    errs, ok = {}, True
    for name, a, b in (("o", o_k, o_p), ("dq", g_k[0], g_p[0]), ("dk", g_k[1], g_p[1]),
                       ("dv", g_k[2], g_p[2])):
        err = float((a.float() - b.float()).abs().max())
        scale_ref = float(b.float().abs().max())
        if dtype == torch.float32:
            tol = 2e-6 if name == "o" else 5e-6
        else:
            tol = 2.0**-7 * scale_ref
        errs[name] = err
        ok = ok and err <= tol
        log(f"[k4] {label} {tuple(shape)} {str(dtype)[6:]}: {name} max|d| {err:.3g} "
            f"(tol {tol:.3g}, max|plain| {scale_ref:.3g})")
    assert ok, f"{label}: K4 kernel differs from its plain version: {errs}"
    assert torch.isfinite(l_k).all() and torch.isfinite(m_k).all()
    row = {"errs": {"flash_fwd": errs["o"], "flash_bwd_dkv": max(errs["dk"], errs["dv"]),
                    "flash_bwd_dq": errs["dq"]}}
    if not timing:
        return row
    o, l, m = torch.empty_like(q), torch.empty_like(l_p), torch.empty_like(m_p)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    big = shape[3] > 128 or shape[0] * shape[1] > 20
    reps, preps = (3, 2) if big else (10, 3)
    t = {"flash_fwd": cuda_time(lambda: fa.launch_fwd(q, k, v, o, l, m, scale), reps),
         "flash_bwd_dkv": cuda_time(lambda: fa.launch_bwd_dkv(q, k, v, l_p, m_p, do, di, dk, dv,
                                                               scale), reps),
         "flash_bwd_dq": cuda_time(lambda: fa.launch_bwd_dq(q, k, v, l_p, m_p, do, di, dq,
                                                             scale), reps)}
    plain_fwd = cuda_time(lambda: fa.flash_attention_fwd_plain(q, k, v, scale), preps)
    plain_bwd = cuda_time(lambda: fa.flash_attention_bwd_plain(q, k, v, l_p, m_p, do, di,
                                                               scale), preps)
    qg, kg, vg = (x.detach().clone().requires_grad_(True) for x in (q, k, v))

    def sdpa():
        return F.scaled_dot_product_attention(q, k, v, scale=scale)

    def sdpa_fb():
        F.scaled_dot_product_attention(qg, kg, vg, scale=scale).backward(do)

    def naive():   # today's module path: matmul + f32 softmax (sd_modules.Attention)
        a = torch.softmax(torch.matmul(q * scale, k.transpose(-1, -2)).float(), dim=-1)
        return torch.matmul(a.to(dtype), v)

    def naive_fb():
        a = torch.softmax(torch.matmul(qg * scale, kg.transpose(-1, -2)).float(), dim=-1)
        torch.matmul(a.to(dtype), vg).backward(do)

    lib = {"sdpa_fwd": cuda_time(sdpa, 10), "sdpa_fwd_bwd": cuda_time(sdpa_fb, 10),
           "naive_fwd": cuda_time(naive, reps), "naive_fwd_bwd": cuda_time(naive_fb, reps)}
    work = k4_flops_bytes(shape, dtype)
    row.update(ms=t, plain_ms={"flash_fwd": plain_fwd, "flash_bwd_dkv": plain_bwd,
                               "flash_bwd_dq": plain_bwd},
               library_ms={"flash_fwd": lib["sdpa_fwd"],
                           "flash_bwd_dkv": lib["sdpa_fwd_bwd"] - lib["sdpa_fwd"],
                           "flash_bwd_dq": lib["sdpa_fwd_bwd"] - lib["sdpa_fwd"]},
               module_path_ms={"fwd": lib["naive_fwd"], "fwd_bwd": lib["naive_fwd_bwd"]},
               bound={kk: bound(f, nb, dtype) for kk, (f, nb) in work.items()})
    log(f"[k4] {label} times: " + json.dumps(
        {"kernel_ms": t, "plain_fwd_ms": plain_fwd, "plain_bwd_ms": plain_bwd, **lib,
         "bound_ms": {kk: v[0] for kk, v in row["bound"].items()}}))
    return row


def run_slice():
    """Phase 3: the object FPS step at config #2 width."""
    from dreamscene_tpu_torch import kernels
    from dreamscene_tpu_torch.guidance import mtsd
    from dreamscene_tpu_torch.guidance.sd_modules import VAEConfig, sd21_unet_config
    from dreamscene_tpu_torch.training.object_trainer import ObjectTrainer
    from dreamscene_tpu_torch.utils.config import ObjectsParamsGroups

    cfg = ObjectsParamsGroups()
    cfg.log = {"exp_name": "chip_smoke"}
    cfg.objectParams.id = "smoke"
    cfg.objectParams.init_guided = "default"
    cfg.objectParams.num_pts = 50_000
    cfg.objectParams.sh_degree = 2
    cfg.objectParams.text = "a ceramic vase"
    cfg.optimizationParams.iterations = 10_000
    cfg.optimizationParams.densify_from_iter = 1 << 30
    cfg.optimizationParams.max_point_number = 60_000
    cfg.guidanceParams.C_batch_size = 4
    cfg.generateCamParams.image_w = 512
    cfg.generateCamParams.image_h = 512
    cfg.mode_args = {}

    t0 = time.perf_counter()
    guidance = mtsd.make_tiny_guidance(
        cfg.guidanceParams, unet_config=sd21_unet_config(), vae_config=VAEConfig(),
        token_len=77, device="cuda")
    tr = ObjectTrainer(cfg, guidance=guidance, exp_root=fresh_dir("slice"),
                       device="cuda")
    tr.prepare_train()
    xyz0 = tr.state.params["xyz"].clone()
    log(f"[slice] set-up {time.perf_counter() - t0:.1f}s, state capacity "
        f"{tr.state.capacity}, active {int(tr.state.aux['active'].sum())}")
    torch.cuda.reset_peak_memory_stats()
    os.environ.pop("DS_FLASH_ATTN", None)
    ms, counts, _ = fps_steps(tr, "slice")
    moved = float((tr.state.params["xyz"] - xyz0).abs().max())
    assert moved > 0, "params did not move"
    assert all(torch.isfinite(v).all() for v in tr.state.params.values())
    n_steps = N_STEPS_WARM + N_STEPS_TIMED
    expect = {k: tr.guidance_opt.C_batch_size * n_steps for k in K1_K3}
    expect.update({k: 0 for k in K4})
    assert counts == expect, (counts, expect)
    log(f"[slice] DS_FLASH_ATTN unset: median {ms:.1f} ms/step, xyz moved {moved:.3g}, "
        f"peak mem {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB, launches {counts}, "
        f"card {torch.cuda.get_device_name(0)}")
    profile_step(tr, ms)

    os.environ["DS_FLASH_ATTN"] = "1"
    torch.cuda.reset_peak_memory_stats()
    ms_f, counts_f, rungs = fps_steps(tr, "slice+flash")
    os.environ.pop("DS_FLASH_ATTN")
    # 10 self-attention layers at n >= 1024 per UNet pass (R rungs -> R+1
    # passes), one VAE encode per step, one encoder backward per step
    expect_f = {k: tr.guidance_opt.C_batch_size * n_steps for k in K1_K3}
    expect_f.update(flash_fwd=sum(10 * (r + 1) + 1 for r in rungs),
                    flash_bwd_dkv=n_steps, flash_bwd_dq=n_steps)
    assert counts_f == expect_f, (counts_f, expect_f)
    log(f"[slice] DS_FLASH_ATTN=1: median {ms_f:.1f} ms/step (unset: {ms:.1f}), rungs {rungs}, "
        f"peak mem {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB, launches {counts_f}")
    log(json.dumps({"slice_flash": {"ms_per_step_median": ms_f, "rungs": rungs,
                                    "launches": counts_f}}))
    return counts


def fps_steps(tr, tag):
    """N_STEPS_WARM + N_STEPS_TIMED train_step()s with the launch counts
    set to 0 before and read after. Returns (median ms of the timed
    steps, counts, ladder lengths)."""
    from dreamscene_tpu_torch import kernels

    kernels.reset_counts()
    times, losses, rungs = [], [], []
    for i in range(N_STEPS_WARM + N_STEPS_TIMED):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = tr.train_step()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        losses.append(loss)
        rungs.append(tr.last_stats["n_rungs"])
        if i >= N_STEPS_WARM:
            times.append(dt)
        log(f"[{tag}] step {tr.step}: loss {loss:.6g}, {dt * 1e3:.1f} ms, "
            f"n_entries {tr.last_stats['n_entries']}, n_dropped {tr.last_stats['n_dropped']}, "
            f"ladder {tr.last_stats['n_rungs']} rungs")
    counts = dict(kernels.COUNTS)
    assert all(math.isfinite(x) for x in losses), losses
    ms = float(np.median(times)) * 1e3
    log(json.dumps({tag: {"ms_per_step_median": ms, "ms_per_step": [t * 1e3 for t in times],
                          "n_entries": tr.last_stats["n_entries"],
                          "n_dropped": tr.last_stats["n_dropped"], "launches": counts}}))
    return ms, counts, rungs


def run_train():
    """Phase 3b: ObjectTrainer.train() at config #2 width, DS_FLASH_ATTN=1,
    sample.yaml's cadences, steps 1497-1502, refine, videos, PLYs."""
    from dreamscene_tpu_torch import kernels
    from dreamscene_tpu_torch.guidance import mtsd
    from dreamscene_tpu_torch.guidance.sd_modules import VAEConfig, sd21_unet_config
    from dreamscene_tpu_torch.models.gaussians import num_active
    from dreamscene_tpu_torch.models.ply import load_splat_ply
    from dreamscene_tpu_torch.training import object_trainer as OT
    from dreamscene_tpu_torch.utils.config import load_config

    cfg = load_config(str(Path(__file__).resolve().parent / "configs/objects/sample.yaml"), [
        "objectParams.id=smoke", "objectParams.init_guided=default",
        "objectParams.num_pts=50000", "objectParams.sh_degree=2",
        "optimizationParams.iterations=1502", "optimizationParams.max_point_number=60000",
        "reconOptimizationParams.iterations=1",
        "reconOptimizationParams.densification_interval=10",
        "guidanceParams.C_batch_size=4", "generateCamParams.image_w=512",
        "generateCamParams.image_h=512", "log.exp_name=train"], object_mode=True)
    t0 = time.perf_counter()
    guidance = mtsd.make_tiny_guidance(
        cfg.guidanceParams, unet_config=sd21_unet_config(), vae_config=VAEConfig(),
        token_len=77, device="cuda")
    tr = OT.ObjectTrainer(cfg, guidance=guidance, exp_root=fresh_dir("train"), device="cuda")
    tr.step = 1496
    log(f"[train] set-up {time.perf_counter() - t0:.1f}s, exp {tr.exp_path}")

    # instrumentation: ladder lengths, module calls, wall time per part
    rungs, calls, parts = [], {"unet": 0, "vae_encoder": 0, "vae_decoder": 0}, {}
    sample_ladder = guidance.sample_ladder

    def record_ladder(rate):
        ladder = sample_ladder(rate)
        rungs.append(len(ladder))
        return ladder

    guidance.sample_ladder = record_ladder
    hooks = [getattr(guidance.mods, name).register_forward_hook(
        lambda *_, name=name: calls.__setitem__(name, calls[name] + 1)) for name in calls]

    def timed(name, fn):
        def wrapper(*a, **kw):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            n, sec = parts.get(name, (0, 0.0))
            parts[name] = (n + 1, sec + time.perf_counter() - t1)
            return out
        return wrapper

    losses, actives = [], {}
    train_step = tr.train_step

    def step_and_record():
        losses.append(train_step())
        actives[tr.step] = num_active(tr.state)
        return losses[-1]

    tr.train_step = timed("train_step (FPS step + densify/filter/viz)", step_and_record)
    for name in ("prepare_train", "_densify", "gaussian_filtering", "save_guidance_viz",
                 "refine_phase", "video_inference", "save_model"):
        setattr(tr, name, timed(name, getattr(tr, name)))
    recon_step = OT.recon_step
    OT.recon_step = timed("recon_step", recon_step)
    n0 = num_active(tr.state)
    os.environ["DS_FLASH_ATTN"] = "1"
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_counts()
    t0 = time.perf_counter()
    try:
        tr.train(make_videos=True)
    finally:
        OT.recon_step = recon_step
        os.environ.pop("DS_FLASH_ATTN")
        for h in hooks:
            h.remove()
    wall = time.perf_counter() - t0
    counts = dict(kernels.COUNTS)

    assert len(losses) == 6 and all(math.isfinite(x) for x in losses), losses
    assert actives[1500] != actives[1499], actives
    assert tr.rec_count == 18, tr.rec_count
    assert parts["_densify"][0] == 2, parts["_densify"]   # step 1500 + recon 10
    assert parts["gaussian_filtering"][0] == 1 and parts["save_guidance_viz"][0] == 1, parts
    assert glob.glob(str(tr.vis_path / "smoke_iter_1500_vd_*")), "no guidance viz"
    for tag in ("1500", "final"):
        assert glob.glob(str(tr.vis_path / f"video_rgb_smoke_{tag}.mp4*")), tag
    assert (tr.ckpt_path / "smoke_1502_model.ply").exists()
    final = tr.ckpt_path / "smoke_final_model.ply"
    n_final = num_active(tr.state)
    assert num_active(load_splat_ply(str(final), device="cuda")) == n_final
    assert all(torch.isfinite(v).all() for v in tr.state.params.values())
    assert calls["unet"] == sum(r + 1 for r in rungs), (calls, rungs)
    expect = {"flash_fwd": 10 * calls["unet"] + calls["vae_encoder"] + calls["vae_decoder"],
              "flash_bwd_dkv": len(losses), "flash_bwd_dq": len(losses)}
    assert all(counts[k] == v for k, v in expect.items()), (counts, expect, calls)
    assert all(counts[k] > 0 for k in kernels.KERNEL_NAMES), counts
    log(f"[train] train() {wall:.1f}s wall; losses {losses}; active {n0} -> "
        f"{actives} -> final {n_final}; rungs {rungs}; module calls {calls}; "
        f"peak mem {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB; launches {counts}")
    log(json.dumps({"train": {"wall_s": wall, "parts_s": {k: {"calls": n, "s": sec}
                                                          for k, (n, sec) in parts.items()},
                              "launches": counts, "module_calls": calls, "rungs": rungs,
                              "active": {"start": n0, **actives, "final": n_final},
                              "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}}))
    return counts


KERNEL_BUCKETS = (("composite_bwd_kernel", "K2 composite_bwd"),
                  ("composite_fwd_kernel", "K1 composite_fwd"),
                  ("expand_kernel", "K3 expand"),
                  ("fprop", "convolution"), ("dgrad", "convolution"),
                  ("wgrad", "convolution"),
                  ("gemm", "matmul"), ("xmma", "matmul"), ("cutlass", "matmul"),
                  ("nvjet", "matmul"),
                  ("nchwtonhwc", "layout transpose"), ("nhwctonchw", "layout transpose"),
                  ("conv", "convolution"), ("cudnn", "convolution"),
                  ("copy", "copy/cast"),
                  ("softmax", "softmax"), ("norm", "normalization"),
                  ("moments", "normalization"),
                  ("sort", "sort"), ("radix", "sort"), ("scan", "scan/cumsum"),
                  ("index", "gather/scatter"), ("gather", "gather/scatter"),
                  ("scatter", "gather/scatter"), ("elementwise", "elementwise"),
                  ("reduce", "reduction"))


def profile_step(tr, untraced_ms):
    """One more train_step under torch.profiler: device busy time by phase
    and by kernel family, and the device's idle share of the untraced
    median step (the traced step's own wall time is inflated by the
    profiler). A phase's time is the kernel time that starts inside its
    window on the device timeline. The backward's kernels are launched by
    autograd's device thread, outside every fps.* range, so its window is
    the gap from the ladder's end to the optimizer's start (the loss terms
    and the whole backward)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        tr.train_step()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3

    spans, kern = {}, []
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        start, end = e.time_range.start, e.time_range.end
        if e.name.startswith("fps."):
            spans[e.name] = (start, end)
        else:
            kern.append((start, (end - start) / 1e3, e.name))
    windows = {k: spans[k] for k in ("fps.render", "fps.vae_encode", "fps.ladder", "fps.adam")}
    windows["fps.backward (loss + backward)"] = (spans["fps.ladder"][1], spans["fps.adam"][0])
    phases = {k: sum(ms for s, ms, _ in kern if lo <= s < hi) for k, (lo, hi) in windows.items()}
    busy = sum(ms for _, ms, _ in kern)
    phases["outside the phases (step inputs)"] = busy - sum(phases.values())
    kernels_ms, buckets = {}, {}
    for _, ms, name in kern:
        kernels_ms[name] = kernels_ms.get(name, 0.0) + ms
        b = next((lab for pat, lab in KERNEL_BUCKETS if pat in name.lower()), "other")
        buckets[b] = buckets.get(b, 0.0) + ms
    top = sorted(kernels_ms.items(), key=lambda kv: -kv[1])[:12]
    log(json.dumps({"profile": {
        "traced_step_wall_ms": wall_ms, "device_busy_ms": busy,
        "untraced_step_ms": untraced_ms, "device_idle_share": 1.0 - busy / untraced_ms,
        "phases_device_busy_ms": phases, "kernel_families_ms": buckets,
        "top_kernels_ms": [[k[:90], v] for k, v in top]}}))


def _to(x, dev):
    """Copy a step's inputs to `dev` (tensors, dicts, lists, states, modules)."""
    import copy
    import dataclasses

    from dreamscene_tpu_torch.guidance.mtsd import GuidanceModules
    from dreamscene_tpu_torch.models.gaussians import AdamState, GaussianState
    from dreamscene_tpu_torch.ops.ddim import make_schedule

    if isinstance(x, torch.Tensor):
        return x.to(dev)
    if isinstance(x, dict):
        return {k: _to(v, dev) for k, v in x.items()}
    if isinstance(x, list):
        return [_to(v, dev) for v in x]
    if isinstance(x, GaussianState):
        return dataclasses.replace(x, params=_to(x.params, dev), aux=_to(x.aux, dev),
                                   opt=AdamState(x.opt.count, _to(x.opt.mu, dev),
                                                 _to(x.opt.nu, dev)))
    if isinstance(x, GuidanceModules):
        return dataclasses.replace(
            x, unet=copy.deepcopy(x.unet).to(dev), vae_encoder=copy.deepcopy(x.vae_encoder).to(dev),
            vae_decoder=copy.deepcopy(x.vae_decoder).to(dev), schedule=make_schedule(device=dev))
    return x


def small_step_parity():
    """Phase 4: one small FPS step on the card (kernels) against the same
    step on the CPU (plain versions): same state, weights and draws."""
    from dreamscene_tpu_torch.training.object_trainer import ObjectTrainer, fps_step
    from dreamscene_tpu_torch.utils.config import ObjectsParamsGroups

    cfg = ObjectsParamsGroups()
    cfg.log = {"exp_name": "chip_smoke_small"}
    cfg.objectParams.init_guided = "default"
    cfg.objectParams.num_pts = 500
    cfg.objectParams.sh_degree = 1
    cfg.optimizationParams.densify_from_iter = 1 << 30
    cfg.guidanceParams.C_batch_size = 2
    cfg.generateCamParams.image_w = 64
    cfg.generateCamParams.image_h = 64
    cfg.mode_args = {}
    tr = ObjectTrainer(cfg, exp_root=fresh_dir("parity"), device="cpu")
    tr.prepare_train()
    inp = tr.step_inputs()
    res_cpu = fps_step(**inp)
    res_gpu = fps_step(**_to(inp, torch.device("cuda")))
    torch.cuda.synchronize()
    loss_c, loss_g = float(res_cpu["loss"]), float(res_gpu["loss"])
    rel = {}
    for k, g in res_cpu["grads"].items():
        den = float(g.norm())
        rel[k] = float((res_gpu["grads"][k].cpu() - g).norm()) / den if den > 0 else 0.0
    log(f"[parity] small FPS step (500 pts, 64^2, C_batch 2): loss card {loss_c!r} "
        f"vs cpu {loss_g!r}; gradient relative L2 card vs cpu {json.dumps(rel)}")
    assert math.isclose(loss_g, loss_c, rel_tol=1e-4, abs_tol=1e-6), (loss_g, loss_c)
    assert all(v <= 1e-3 for v in rel.values()), rel
    assert int(res_cpu["n_entries"]) == int(res_gpu["n_entries"])


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from dreamscene_tpu_torch import kernels

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    log(smi)
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, cuda {torch.version.cuda}")
    t_build = kernels.build(force=True, verbose=True)
    kernels.lib()
    log(f"[build] kernels built in {t_build:.1f}s")

    torch.manual_seed(0)
    errs = {k: 0.0 for k in kernels.KERNEL_NAMES}
    k4 = {}
    for label, shape, dtype in K4_SHAPES:
        k4[label] = check_flash(label, shape, dtype)
        errs.update({k: max(errs[k], v) for k, v in k4[label]["errs"].items()})
    legs = [("small 2K 128^2 32x16", 2_000, 128, 128, 32, 16, False),
            ("16x16 tiles 20K 256^2", 20_000, 256, 256, 16, 16, False),
            ("full width 50K 512^2 32x16", 50_000, 512, 512, 32, 16, True)]
    rows = None
    for label, n_pts, w, h, tw, th, timing in legs:
        st, cam = make_scene(n_pts, w, h, seed=n_pts)
        inp = binned_inputs(st, cam, tw, th)
        e, r = check_kernels(label, inp, timing)
        errs.update({k: max(errs[k], v) for k, v in e.items()})
        rows = r or rows
    for k in K4:
        r = k4[K4_ROW[k]]
        rows[k] = dict(ms=r["ms"][k], plain_ms=r["plain_ms"][k], library_ms=r["library_ms"][k],
                       bound_ms=r["bound"][k][0], bound_by=r["bound"][k][1])

    counts = run_slice()
    counts.update({k: v for k, v in run_train().items() if k in K4})
    small_step_parity()

    table = []
    for k in kernels.KERNEL_NAMES:
        src, rep = SOURCES[k]
        r = rows[k]
        table.append({"name": k, "route": "cuda", "source": src, "replaces": rep,
                      "launches": counts[k], "max_abs_err": errs[k], "ms": r["ms"],
                      "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                      "bound_by": r["bound_by"], "library_ms": r.get("library_ms")})
    log(json.dumps({"k4_shapes": {lab: {kk: v for kk, v in r.items() if kk != "bound"}
                                  for lab, r in k4.items()}}))
    log(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
