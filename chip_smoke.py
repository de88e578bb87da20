"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py      # needs one CUDA card

Phases (any failure exits non-zero; nothing is caught):
  1. card name and power limit (nvidia-smi), kernel build (with ptxas's
     registers / shared memory per kernel; the six sources in parallel)
     and its time;
  2. each hand-written kernel against its plain PyTorch version on the
     card, on seeded scenes: a small one, a 16x16-tile leg and the main
     path's full width (50K splats, 512^2, 32x16 tiles). K3 bit-equal;
     K1 rows R,G,B,DEPTH,T at atol 1e-5 / rtol 1e-4 and LIVE equal, its
     per-chunk carry table (T and accumulators at each chunk's start, from
     which K2 walks one chunk per CTA) held to the plain version's the same
     way, both bit-identical across two launches, and the tile order its
     first kernel computes equal to `tile_order`'s; K2 within 1e-4 of max|g|
     and bit-identical across two runs. The per-tile distribution of chunks
     and live entries of each scene. Times of kernel and plain version at
     full width, and for K3 the host time of its launch and of a whole
     expand_entries call;
  2b. K4 (flash attention forward, dK/dV, dQ) against its plain versions
     at every shape the main path gives it (bf16, the tensor-core variant
     of all three kernels) plus one f32 case (the CUDA-core variant), and
     the forward once more on the attention module's
     strided views of [b, n, h*d] projections: f32 at atol 2e-6 (forward)
     / 5e-6 (gradients), bf16 at max|d| <= 2^-7 max|plain|; times of
     kernels, plain versions, SDPA (forward and forward+backward) and the
     matmul + f32-softmax module path;
  3. the slice: ObjectTrainer at BASELINE.json config #2 width (50K
     points, sh_degree 2, 512^2, C_batch 4, SD2.1-architecture UNet + full
     VAE with seeded random weights, 77 tokens, densify off), DS_FLASH_ATTN
     unset: prepare_train, 2 warm-up + 5 timed train_step()s, launch counts
     (K1-K3 once per camera, K4 never), one step under torch.profiler
     (device time by phase and kernel); then the same 7 steps with
     DS_FLASH_ATTN=1, timed, with the K4 launches checked against the
     ladder lengths and every forward, dK/dV and dQ launch counted as the
     tensor-core variant, and one such step under torch.profiler;
  3b. ObjectTrainer.train(make_videos=True) at config #2 width with
     DS_FLASH_ATTN=1 and configs/objects/sample.yaml's cadences, from step
     1496 to 1502 (densify/prune, opacity reset, 48-view filter, SH
     step-up, guidance viz and a video all fire at step 1500), a snapshot
     PLY, the refine phase (9 pseudo-GT chunks, 18 recon steps, one recon
     densify), the final video and PLY; K4 launches checked against the
     UNet passes and VAE calls; wall time of each part;
  4. one small FPS step on the card against the same step on the CPU
     (plain versions), same state, weights and random draws;
  5. config #3 (BASELINE.json; scripts/bench_compositional.py): five
     60K-splat objects placed by place_object, scene_render at 800^2,
     forward + backward timed (2 warm-up, 10 timed); K1-K3 held against
     their plain versions at this scene (32x16 and 16x16 tiles) and timed;
  6. config #4: configs/scenes/sample_indoor.yaml as shipped at env
     density 1.0 (written object PLYs, object_task, prepare_train_scene with
     compress and four placed instances): 2 + 5 stage-1 and 5 stage-2
     scene steps with DS_FLASH_ATTN unset and again set, launch counts
     checked, a profiled step each way (scene.* phases), K1-K3 held and
     timed on a stage-1 view and on its rows 256-511 as a tp-2 rank of
     phase 13c bins them (chunk 256);
  7. SceneTrainer.train(n_stage3=1, make_videos=True) on that scene with
     3 stage-1 and 1 stage-2 steps (gate set): checkpoints, the 80-view
     pseudo-GT bank and recon steps, the final video, scene_final_model.ply
     reloaded; then a second train() that resumes at stage 3 and trains
     nothing;
  8. one small scene step on the card against the CPU (the CPU tests' tiny
     scene; a stage-1 step and a stage-3 recon step);
  9. the depth ControlNet at config #2 width: phase 3's trainer with a
     full-width SD2.1-architecture ControlNet (seeded weights, its zero
     convs filled with small seeded values so the residuals reach the
     UNet; eps with and without it on one UNet call), every step
     conditioned: 2 + 5 train_step()s with DS_FLASH_ATTN unset and set,
     K4 forward launches checked at 10 + 4 per UNet pass, a profiled step
     each way (device time of the `controlnet` range), peak memory; 9b. two config
     #4 stage-1 scene steps with that ControlNet, gate set;
 10. one small ControlNet FPS step on the card against the CPU;
 11. the checkpoint loader without a download: a tiny diffusers directory
     written under build/ (unet/ and controlnet/ as F16 safetensors, vae/
     as a .bin, a tiny CLIP text encoder and tokenizer, scheduler/),
     build_sd_guidance on the card against the same state dicts loaded in
     memory, run_validation on it, and
     `python -m dreamscene_tpu_torch.guidance.validate --tiny --size 512`;
     then a directory at SD 2.1's published widths (UNet, ControlNet, VAE,
     the 23-layer 1024-wide CLIP text encoder, a 49,408-token vocabulary
     with 48,894 merges; seeded weights), build_sd_guidance timed on it and
     every loaded weight held equal to the written one;
 12. mesh export: phase 3b's train() with mode_args.export_mesh (128^3),
     the mesh's counts and extract_fields' wall time, extract_fields at
     64^3 on its state, card against CPU, and at 128^3 with its
     slab-narrowed cull against the JAX package's plain cull (same grid);
 13. the multi-rank path (parallel/), its ranks spawned by
     parallel/launch.run_ranks after the kernels are built, all on cuda:0
     over gloo (NCCL refuses two ranks on one card), DS_FLASH_ATTN=1; their
     times are those of ranks sharing one card, not scaling numbers:
     13a. K1-K3 at the tile bands of phase 2's 50K object (512x256 and
     512x128 from row 256; chunk 256) against their plain versions, and
     the bands of render(pixel_offset_y=, full_height=) stacked against
     the full render (phase 6 checks them on a band of config #4 too);
     13b. phase 3's object on dp 2 x tp 2: one step on explicit inputs
     against the same step in one process (guidance in float32), the same
     step in bf16 against the one-process bf16 step, the dp split taken in
     one process (each dp rank's cameras as one batch) and the float32
     step (bf16's gap, measured on the one-process steps), 2 + 3
     ObjectTrainer steps (launch counts per rank), a profiled step, and
     with shard_splats 3 steps, a forced densify and one more step;
     13c. phase 6's scene on dp 1 x tp 2 with shard_splats: one stage-1 step
     against the same step in one process, two stage-1 steps and a stage-3
     recon step, a profiled step. Per rank: step ms, host seconds inside
     collectives, MB all-gathered, peak memory, and the summed span of its
     kernels (the card time-slices the ranks' contexts, so a span holds
     other ranks' slices: not the rank's work);
 14. the JAX package's last modules on the card; 14b-14d run right after
     the phase whose state they take, 14a and 14e last:
     14a. the KNN library that sets initial log-scales (csrc/host/knn.cpp,
     built with g++ at the start, its time printed) and create_from_points
     timed on phase 2's 50K-point ball;
     14b. (after phase 6) config #4's scene seen by load_single_cam at
     1920x1080 from the scene box's centre towards the first object:
     rendered forward + backward at a capacity the capacity controller
     sizes (drops printed, launches checked), K1-K3 held against their
     plain versions and timed at 32x16 (4,080 tiles) and 16x16 (8,160
     tiles), the live tiles of the partial last tile row;
     14c. (after phase 9) mtsd.denoise_ladder on phase 3's stack (64x64
     latents, batch 1, 3 rungs, DS_FLASH_ATTN=1): K4 forward launches
     checked, the walk timed, K4 at the walk's shapes [3,5,4096,64] and
     [3,10,1024,64]; the tiny stack's walk card against CPU (float32,
     atol 1e-4);
     14d. (after phase 9) one gate-set FPS step of phase 3's trainer inside
     utils/profiling.trace, whose Chrome trace must name every K1-K4
     kernel symbol;
     14e. l1_loss and ssim on a [4,3,512,512] pair, card against CPU
     (atol 1e-5);
 15. config #5 (BASELINE.json): configs/scenes/sample_outdoor.yaml as
     shipped at env density 1.0, on phase 6's guidance stack with
     DS_FLASH_ATTN=1, right after phase 8:
     15a. its two objects written as finished PLYs (point-e never runs),
     object_task, prepare_train_scene (compress, two placements, the env
     hemisphere shell and the floor disk); the census per model (active,
     capacity, bytes), env and floor held to the init formula;
     15b. 2 + 5 stage-1 steps of floor + env alone (only_env) and 5
     stage-2 steps at train()'s outdoor ranges, launch counts checked, a
     profiled stage-1 step, peak memory;
     15c. K1-K3 held against their plain versions and timed on a
     Stage1_Outdoor view (from inside the shell, looking outward; 32x16)
     and on a mirrored (scale -1) Stage2_Outdoor view (the floor near the
     horizon; 32x16 and 16x16), drops printed;
     15d. SceneTrainer.train(n_stage3=1, make_videos=True, video_every=3)
     with 3 stage-1 and 1 stage-2 steps: the only-env videos, checkpoints,
     the 80-camera pseudo-GT bank and the floor-only recon steps (env and
     objects held bit-equal, the floor moving), the final video and PLY;
     15e. the CLI as subprocesses in 15d's experiment root: `python3 -m
     dreamscene_tpu_torch --config configs/scenes/sample_outdoor.yaml
     --exp-root ROOT only_render=true` (the walkthrough's frames counted
     against its cameras, no checkpoint written), then without only_render
     (resumes at stage 3, trains nothing);
     15f. phase 8 on the outdoor tiny scene: a stage-1 only-env step and a
     stage-3 floor recon step, card against CPU;
 16. (right after phase 2) K1 above the tile count one CTA's shared memory
     could rank (19,369): phase 2's 50K-splat scene seen at 3840x2160 and
     2560x2560 with 16x16 tiles (32,400 and 25,600 tiles) at a capacity
     sized to its raw entries, K1-K3 held against their plain versions and
     timed; one render forward + backward at 3840x2160, 16x16, launches
     checked, the image and gradients finite;
 17. (after 16) bench/throughput.py, BASELINE.json's primary metric: its
     300K-splat scene and orbit camera at 512^2, K1-K3 held against their
     plain versions at the headline capacity (32x16, chunk 512), then its
     main() in this process (tracked capacity, 10 timed forward + backward
     steps, device busy ms, the 4N companion at 16x16 / chunk 384), its
     JSON line printed and its launches counted;
 18. (after 17) bench/soak_object.py and bench/soak_scene.py at cut lengths:
     the object run (its config, 360 FPS steps, 2 recon iterations,
     videos) crosses three densifications, an opacity reset and 60 steps
     after the last; the scene run (a 20-step object task, stage 1 of 280
     steps, stage 2 of 1, 1 stage-3 iteration, env density 0.08) crosses
     two stage-1 densifications and 80 steps after the last, then resumes
     at stage 3 and trains nothing; their JSON lines printed and checked
     (events, drops, checkpoints). The full-length runs go through
     `python3 -m dreamscene_tpu_torch.bench.soak_object` / `soak_scene`.
Every phase prints `[time] <phase> done at <s> s` (seconds since start).
The line before the last is the kernel table as JSON (launches by path;
K1-K3 also at the scene, band, single-camera, outdoor, 4K, 2560^2 and
bench shapes, K1 with its order kernel's time); the last
line is
{"ok": true, "device": {...}}.
"""

import dataclasses
import functools
import glob
import json
import math
import os
import shutil
import struct
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

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
# K1's order kernel alone, and K1 in index order
K1_ORDER_KEYS = ("order_kernel_ms", "index_order_ms")
K4 = ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq")
BUILD = Path(__file__).resolve().parent / "build"
# K4's shapes on the main path at config #2 width ([b, h, n, d], bf16):
# one process (C_batch 4), a rank of phase 13b's dp 2 mesh (b_local 2),
# plus one float32 case; the row each kernel's table entry reports
K4_SHAPES = (("unet 64x64 self-attn", (12, 5, 4096, 64), torch.bfloat16),
             ("unet 32x32 self-attn", (12, 10, 1024, 64), torch.bfloat16),
             ("vae mid-attn, encode/pseudo-GT batch 4", (4, 1, 4096, 512), torch.bfloat16),
             ("vae mid-attn, viz batch 1", (1, 1, 4096, 512), torch.bfloat16),
             ("mesh rank unet 64x64 self-attn", (6, 5, 4096, 64), torch.bfloat16),
             ("mesh rank unet 32x32 self-attn", (6, 10, 1024, 64), torch.bfloat16),
             ("mesh rank vae mid-attn, encode batch 2", (2, 1, 4096, 512), torch.bfloat16),
             ("f32 check", (2, 5, 4096, 64), torch.float32))
K4_ROW = {"flash_fwd": "unet 64x64 self-attn",
          "flash_bwd_dkv": "vae mid-attn, encode/pseudo-GT batch 4",
          "flash_bwd_dq": "vae mid-attn, encode/pseudo-GT batch 4"}


def log(*a):
    print(*a, flush=True)


T_START = time.perf_counter()


def mark(phase):
    log(f"[time] {phase} done at {time.perf_counter() - T_START:.1f} s")


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


def host_time(fn, reps):
    """Mean host ms per call over `reps` calls without a sync (what the
    caller's thread spends issuing the work), after one warm call and a
    sync; the queue is drained after."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    ms = (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    return ms


def make_scene(n_pts, width, height, seed):
    """A seeded full-path scene with a fresh init-cloud cache directory."""
    from dreamscene_tpu_torch.bench import scenes

    return scenes.make_scene(n_pts, width, height, seed, fresh_dir("init"))


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
    from dreamscene_tpu_torch import kernels
    from dreamscene_tpu_torch.bench.scenes import tile_stats
    from dreamscene_tpu_torch.ops import composite as C
    from dreamscene_tpu_torch.ops import expand as E

    log(f"[kernels] {label} tiles: " + json.dumps(tile_stats(inp)))

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
    out_k, carry_k = C.composite_forward_carry(rt, *meta, **geo)
    out_p, carry_p = C.composite_forward_plain(rt, *meta[:4], meta[5], **geo, return_carry=True)
    torch.cuda.synchronize()
    a, b = out_k[:, :5], out_p[:, :5]
    err_k1 = float((a - b).abs().max())
    ok = torch.isclose(a, b, atol=1e-5, rtol=1e-4).all().item()
    assert ok, f"{label}: composite_fwd max abs err {err_k1}"
    assert torch.equal(out_k[:, 5], out_p[:, 5]), f"{label}: LIVE rows differ"
    # K1's first kernel: the busiest-first tile order, against its plain version
    k1_args, k1_keep = C.prepare_forward(rt, *meta[:4], inp["n_tiles"], inp["tiles_x"],
                                         inp["tile_w"], inp["tile_h"])
    C.launch_forward(k1_args, k1_keep)
    assert torch.equal(k1_keep[-3], C.tile_order(meta[0], meta[2], meta[3], inp["n_tiles"])), \
        f"{label}: K1 tile order differs from plain"
    # the carry table: only the rows of live chunks are written
    live_u = torch.nonzero((meta[3] > meta[2])[:int(meta[5])]).flatten()
    err_carry = float((carry_k[live_u] - carry_p[live_u]).abs().max()) if live_u.numel() else 0.0
    ok = torch.isclose(carry_k[live_u], carry_p[live_u], atol=1e-5, rtol=1e-4).all().item()
    assert ok, f"{label}: composite_fwd carry table max abs err {err_carry}"
    err_k1 = max(err_k1, err_carry)

    gen = torch.Generator(device="cuda").manual_seed(7)
    g_out = torch.randn(out_p.shape, device="cuda", generator=gen)
    gk1 = C.composite_backward(rt, *meta, out_k, g_out, **geo, carry=carry_k)
    # once more from the table of a second K1 launch
    out_2, carry_2 = C.composite_forward_carry(rt, *meta, **geo)
    gk2 = C.composite_backward(rt, *meta, out_2, g_out, **geo, carry=carry_2)
    gp = C.composite_backward_plain(rt, *meta[:4], meta[5], out_k, g_out, **geo)
    torch.cuda.synchronize()
    assert torch.equal(out_k, out_2) and torch.equal(carry_k[live_u], carry_2[live_u]), \
        f"{label}: composite_fwd not bit-reproducible"
    assert torch.equal(gk1, gk2), f"{label}: composite_bwd not bit-reproducible"
    err_k2 = float((gk1 - gp).abs().max())
    gmax = float(gp.abs().max())
    assert err_k2 <= 1e-4 * gmax, f"{label}: composite_bwd err {err_k2} vs max|g| {gmax}"
    live, pairs = pair_count(inp)
    log(f"[kernels] {label}: n_entries {int(inp['binned'].n_entries)} live {live} "
        f"pairs {pairs}: expand bit-equal, fwd err {err_k1:.3g}, fwd bit-reproducible, "
        f"bwd err {err_k2:.3g} (max|g| {gmax:.3g}), bwd bit-reproducible")
    errs = {"expand_entries": err_k3, "composite_fwd": err_k1, "composite_bwd": err_k2}
    if not timing:
        return errs, None

    n = kw["n"]
    cap = kw["capacity"]
    n_chunks = meta[0].shape[0]
    tile_pix = inp["tile_w"] * inp["tile_h"]
    acc_bytes = (inp["n_tiles"] + 1) * 8 * tile_pix * 4
    carry_bytes = int(live_u.numel()) * C.CARRY_ROWS * tile_pix * 4   # live chunks' rows only
    # kernel times: the launches alone, inputs validated and allocated once
    k3 = E.prepare_expand(block=E.BLOCK, **kw)
    k1 = C.prepare_forward(rt, *meta[:4], inp["n_tiles"], inp["tiles_x"], inp["tile_w"],
                           inp["tile_h"])
    k2 = C.prepare_backward(rt, *meta[:4], meta[5], out_k, g_out, carry_k, inp["n_tiles"],
                            inp["tiles_x"], inp["chunk"], inp["tile_w"], inp["tile_h"])
    rows = {}
    rows["expand_entries"] = dict(
        ms=cuda_time(lambda: E.launch_expand(*k3), 50),
        plain_ms=cuda_time(lambda: E.expand_entries_plain(**kw), 5),
        # host wall time per call, no sync: the launch alone, and a whole
        # expand_entries call (validation, allocation and launch)
        launch_host_ms=host_time(lambda: E.launch_expand(*k3), 200),
        call_host_ms=host_time(lambda: E.expand_entries(**kw), 200),
        bytes=6 * n * 4 + 2 * cap * 4, ops=0)
    rows["composite_fwd"] = dict(
        ms=cuda_time(lambda: C.launch_forward(*k1), 20),
        plain_ms=cuda_time(lambda: C.composite_forward_plain(rt, *meta[:4], meta[5], **geo), 3),
        bytes=live * 10 * 4 + 4 * n_chunks * 4 + acc_bytes + carry_bytes,
        ops=pairs * FWD_OPS_PER_PAIR)
    rows["composite_bwd"] = dict(
        ms=cuda_time(lambda: C.launch_backward(*k2), 20),
        plain_ms=cuda_time(lambda: C.composite_backward_plain(
            rt, *meta[:4], meta[5], out_k, g_out, **geo), 3),
        bytes=(live * 10 * 4 + 4 * n_chunks * 4 + 2 * acc_bytes + carry_bytes
               + 16 * n_chunks * inp["chunk"] * 4),
        ops=pairs * BWD_OPS_PER_PAIR)
    for r in rows.values():
        r["bound_ms"], r["bound_by"] = bound(r["ops"], r["bytes"], torch.float32)
    # K1's first kernel, the tile order, timed alone; and K1 less the same
    # launch with a null tile-order pointer (no order kernel, the tiles
    # dispatched in index order: the launcher's bench mode), which also holds
    # what the dispatch order changes in the compositing kernel's time
    lib, no_order = kernels.lib(), k1[0][:13] + (None,) + k1[0][14:]
    order_args = (meta[0].data_ptr(), meta[2].data_ptr(), meta[3].data_ptr(), n_chunks,
                  inp["n_tiles"], k1[1][-3].data_ptr(), kernels.stream_ptr(rt.device))
    kernels.check(lib.ds_tile_order(*order_args), "tile_order")
    kernels.check(lib.ds_composite_fwd(*no_order), "composite_fwd")
    r1 = rows["composite_fwd"]
    r1["order_kernel_ms"] = cuda_time(lambda: lib.ds_tile_order(*order_args), 20)
    r1["index_order_ms"] = cuda_time(lambda: lib.ds_composite_fwd(*no_order), 20)
    log(f"[kernels] {label} times: " + json.dumps(
        {k: {kk: v[kk] for kk in ("ms", "plain_ms", "bound_ms", "launch_host_ms",
                                  "call_host_ms", *K1_ORDER_KEYS) if kk in v}
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
    """The least time one H100 could take (ms) and what bounds it: the
    operations over the peak rate of their type, or the bytes over HBM's
    rate (the peaks of utils/profiling.py)."""
    from dreamscene_tpu_torch.utils import profiling as P

    peak = P.H100_BF16_FLOPS if dtype == torch.bfloat16 else P.H100_FP32_FLOPS
    t_ops = flops / peak * 1e3
    t_bytes = nbytes / P.H100_HBM_BYTES_PER_S * 1e3
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
    # the forward on strided views, as sd_modules.Attention passes them:
    # [b, h, n, d] views of [b, n, h*d] projections; o comes back so that
    # transpose(1, 2).reshape(b, n, h*d) is a view
    b_, h_, n_, d_ = shape
    q_s, k_s, v_s = (x.transpose(1, 2).contiguous().transpose(1, 2) for x in (q, k, v))
    assert h_ == 1 or not q_s.is_contiguous()
    o_s = fa.flash_fwd(q_s, k_s, v_s, scale)[0]
    assert o_s.transpose(1, 2).reshape(b_, n_, h_ * d_).data_ptr() == o_s.data_ptr()
    torch.cuda.synchronize()
    errs, ok = {}, True
    for name, a, b in (("o", o_k, o_p), ("o_strided", o_s, o_p), ("dq", g_k[0], g_p[0]),
                       ("dk", g_k[1], g_p[1]), ("dv", g_k[2], g_p[2])):
        err = float((a.float() - b.float()).abs().max())
        scale_ref = float(b.float().abs().max())
        if dtype == torch.float32:
            tol = 2e-6 if name.startswith("o") else 5e-6
        else:
            tol = 2.0**-7 * scale_ref
        errs[name] = err
        ok = ok and err <= tol
        log(f"[k4] {label} {tuple(shape)} {str(dtype)[6:]}: {name} max|d| {err:.3g} "
            f"(tol {tol:.3g}, max|plain| {scale_ref:.3g})")
    assert ok, f"{label}: K4 kernel differs from its plain version: {errs}"
    assert torch.isfinite(l_k).all() and torch.isfinite(m_k).all()
    variant = {"flash_fwd": fa.fwd_config(dtype, shape[3])["design"],
               "flash_bwd_dkv": fa.dkv_config(dtype, shape[3])["design"],
               "flash_bwd_dq": fa.dq_config(dtype, shape[3])["design"]}
    row = {"errs": {"flash_fwd": max(errs["o"], errs["o_strided"]),
                    "flash_bwd_dkv": max(errs["dk"], errs["dv"]), "flash_bwd_dq": errs["dq"]},
           "variant": variant}
    if not timing:
        return row
    o, l, m = torch.empty_like(q), torch.empty_like(l_p), torch.empty_like(m_p)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    big = shape[3] > 128 or shape[0] * shape[1] > 20
    reps, preps = (5, 2) if big else (10, 3)
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
    tflops = {kk: work[kk][0] / (ms * 1e-3) / 1e12 for kk, ms in t.items()}
    row.update(ms=t, plain_ms={"flash_fwd": plain_fwd, "flash_bwd_dkv": plain_bwd,
                               "flash_bwd_dq": plain_bwd},
               library_ms={"flash_fwd": lib["sdpa_fwd"],
                           "flash_bwd_dkv": lib["sdpa_fwd_bwd"] - lib["sdpa_fwd"],
                           "flash_bwd_dq": lib["sdpa_fwd_bwd"] - lib["sdpa_fwd"]},
               module_path_ms={"fwd": lib["naive_fwd"], "fwd_bwd": lib["naive_fwd_bwd"]},
               achieved_tflops=tflops,
               bound={kk: bound(f, nb, dtype) for kk, (f, nb) in work.items()})
    log(f"[k4] {label} times: " + json.dumps(
        {"kernel_ms": t, "variant": variant, "achieved_tflops": tflops,
         "plain_fwd_ms": plain_fwd, "plain_bwd_ms": plain_bwd, **lib,
         "bound_ms": {kk: v[0] for kk, v in row["bound"].items()}}))
    return row


def slice_cfg(dp=1, tp=1, shard_splats=False):
    """Phase 3's configuration (BASELINE.json config #2 width), on a dp x tp
    mesh when dp * tp > 1."""
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
    cfg.parallelParams.dp, cfg.parallelParams.tp = dp, tp
    cfg.parallelParams.shard_splats = shard_splats
    return cfg


def sd21_guidance(guidance_params, device="cuda", dtype=torch.bfloat16):
    """The seeded full-width SD2.1-architecture UNet + VAE (77 tokens),
    computing in `dtype` (bf16, as the path runs it; f32 for the mesh
    parity steps)."""
    from dreamscene_tpu_torch.guidance import mtsd
    from dreamscene_tpu_torch.guidance.sd_modules import VAEConfig, sd21_unet_config

    return mtsd.make_tiny_guidance(
        guidance_params, unet_config=dataclasses.replace(sd21_unet_config(), dtype=dtype),
        vae_config=dataclasses.replace(VAEConfig(), dtype=dtype), token_len=77, device=device)


def run_slice():
    """Phase 3: the object FPS step at config #2 width."""
    from dreamscene_tpu_torch import kernels
    from dreamscene_tpu_torch.training.object_trainer import ObjectTrainer

    cfg = slice_cfg()
    t0 = time.perf_counter()
    guidance = sd21_guidance(cfg.guidanceParams)
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
    expect.update({k: 0 for k in K4 + kernels.VARIANT_NAMES})
    assert counts == expect, (counts, expect)
    log(f"[slice] DS_FLASH_ATTN unset: median {ms:.1f} ms/step, xyz moved {moved:.3g}, "
        f"peak mem {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB, launches {counts}, "
        f"card {torch.cuda.get_device_name(0)}")
    profile_step(tr.train_step, ms, "profile")

    os.environ["DS_FLASH_ATTN"] = "1"
    torch.cuda.reset_peak_memory_stats()
    ms_f, counts_f, rungs = fps_steps(tr, "slice+flash")
    peak_f = torch.cuda.max_memory_allocated() / 2**30
    profile_step(tr.train_step, ms_f, "profile_flash")
    os.environ.pop("DS_FLASH_ATTN")
    # 10 self-attention layers at n >= 1024 per UNet pass
    expect_f = {k: tr.guidance_opt.C_batch_size * n_steps for k in K1_K3}
    expect_f.update(k4_expect(rungs, 10, n_steps))
    assert counts_f == expect_f, (counts_f, expect_f)
    log(f"[slice] DS_FLASH_ATTN=1: median {ms_f:.1f} ms/step (unset: {ms:.1f}), rungs {rungs}, "
        f"peak mem {peak_f:.1f} GiB, launches {counts_f}")
    log(json.dumps({"slice_flash": {"ms_per_step_median": ms_f, "rungs": rungs,
                                    "launches": counts_f}}))
    return counts, tr


@torch.no_grad()
def fill_zero_convs(cn, gen, scale):
    """Seeded N(0, scale^2) weights for the ControlNet's zero-initialised
    layers (zero convs, the hint embedding's conv_out): at zero its
    residuals would be zero and the phase would prove nothing."""
    n = 0
    for m in cn.modules():
        if getattr(m, "zero_init", False):
            m.weight.normal_(0.0, scale, generator=gen)
            m.bias.normal_(0.0, scale, generator=gen)
            n += 1
    return n


def k4_expect(rungs, per_pass, n_steps):
    """K4 launch counts of `n_steps` gate-set guidance steps with ladders of
    `rungs` rungs: `per_pass` forwards per UNet pass (R rungs -> R+1
    passes) plus one per VAE encode, one dK/dV and one dQ per step (the
    encoder's backward); the whole path computes in bf16, so every
    forward, dK/dV and dQ launch must have taken the tensor-core variant."""
    n_fwd = sum(per_pass * (r + 1) + 1 for r in rungs)
    return {"flash_fwd": n_fwd, "flash_bwd_dkv": n_steps, "flash_bwd_dq": n_steps,
            "flash_fwd.tc": n_fwd, "flash_bwd_dkv.tc": n_steps, "flash_bwd_dq.tc": n_steps}


def run_controlnet_steps(tr):
    """Phase 9: phase 3's trainer with a full-width ControlNet conditioning
    every step (use_control_net_iter 0, controlnet_ratio 1), gate unset and
    set. Returns the launch counts of both legs and the ControlNet."""
    from dreamscene_tpu_torch import kernels
    from dreamscene_tpu_torch.guidance import sd_modules as sdm

    g = tr.guidance
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(9)
    with torch.device("cuda"):
        cn = sdm.init_random_(sdm.ControlNet(g.mods.unet.cfg, downscale=g.mods.downscale), gen)
    n_zero = fill_zero_convs(cn, gen, 0.02)
    cn.requires_grad_(False).eval()
    # one UNet call with and without the residuals
    f = g.mods.downscale
    lat = torch.randn((3, 4, 64, 64), generator=gen, device="cuda")
    t = torch.full((3,), 500, dtype=torch.int32, device="cuda")
    ctx = g.get_text_embeds(["a ceramic vase", "", ""])
    hint = torch.rand((3, 64 * f, 64 * f, 3), generator=gen, device="cuda")
    with torch.no_grad():
        eps0 = g.mods.unet(lat, t, ctx)
        eps1 = g.mods.unet(lat, t, ctx, control_res=cn(lat, t, ctx, hint))
    rel = float((eps1 - eps0).norm() / eps0.norm())
    assert math.isfinite(rel) and rel > 1e-3, rel
    log(f"[controlnet] set-up {time.perf_counter() - t0:.1f}s, {n_zero} zero-init layers filled; "
        f"one UNet call: eps with vs without the ControlNet, relative L2 {rel:.4g}")

    g.mods.controlnet = cn
    tr.optim.use_control_net_iter = 0
    g.guidance_opt.controlnet_ratio = 1.0
    calls = {"n": 0}
    hook = cn.register_forward_hook(lambda *_: calls.__setitem__("n", calls["n"] + 1))
    n_steps = N_STEPS_WARM + N_STEPS_TIMED
    by_gate, summary = {}, {"eps_rel_l2_with_vs_without": rel}
    try:
        for gate in ("unset", "set"):
            if gate == "set":
                os.environ["DS_FLASH_ATTN"] = "1"
            torch.cuda.reset_peak_memory_stats()
            calls["n"] = 0
            ms, counts, rungs = fps_steps(tr, f"controlnet {gate}")
            peak = torch.cuda.max_memory_allocated() / 2**30
            # every step conditioned: one ControlNet pass per UNet pass
            assert calls["n"] == sum(r + 1 for r in rungs), (calls, rungs)
            expect = {k: tr.guidance_opt.C_batch_size * n_steps for k in K1_K3}
            if gate == "unset":
                expect.update({k: 0 for k in K4 + kernels.VARIANT_NAMES})
            else:
                expect.update(k4_expect(rungs, 10 + 4, n_steps))
            assert counts == expect, (gate, counts, expect)
            by_gate[gate] = counts
            summary[gate] = {"ms_per_step_median": ms, "rungs": rungs, "peak_mem_gib": peak,
                             "launches": counts}
            log(f"[controlnet] DS_FLASH_ATTN {gate}: median {ms:.1f} ms/step, rungs {rungs}, "
                f"peak mem {peak:.1f} GiB, launches {counts}")
            summary[gate]["profile"] = profile_step(
                tr.train_step, ms, "controlnet_profile" + ("_flash" if gate == "set" else ""),
                ranges=("controlnet",))
    finally:
        hook.remove()
        os.environ.pop("DS_FLASH_ATTN", None)
        g.mods.controlnet = None
    log(json.dumps({"controlnet_steps": summary}))
    return {k: by_gate["unset"][k] + by_gate["set"][k] for k in kernels.KERNEL_NAMES}, cn


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


def timed_call(parts, name, fn):
    """`fn` wrapped to add its calls and synchronized wall seconds to
    parts[name]."""
    def wrapper(*a, **kw):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = fn(*a, **kw)
        torch.cuda.synchronize()
        n, sec = parts.get(name, (0, 0.0))
        parts[name] = (n + 1, sec + time.perf_counter() - t1)
        return out
    return wrapper


def run_train():
    """Phase 3b: ObjectTrainer.train() at config #2 width, DS_FLASH_ATTN=1,
    sample.yaml's cadences, steps 1497-1502, refine, videos, PLYs; and
    phase 12: the same train() ends with the mesh export
    (mode_args.export_mesh, 128^3), then extract_fields at 64^3 on its
    state, card against CPU, and at 128^3 timed with both culls."""
    from dreamscene_tpu_torch import kernels
    from dreamscene_tpu_torch.models import fields, mesh
    from dreamscene_tpu_torch.models.gaussians import num_active
    from dreamscene_tpu_torch.models.ply import load_splat_ply
    from dreamscene_tpu_torch.ops import flash_attention as fa
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
    # the opacity reset at step 1500 leaves every opacity at 0.01: the
    # occupancy then peaks near 0.24 (not 1.0; the `[mesh]` line's max|occ|
    # 0.243 in PR 7's runs), so the mesh is cut at 0.05
    cfg.mode_args = dict(cfg.mode_args or {}, export_mesh=True, mesh_resolution=128,
                         mesh_thresh=0.05)
    t0 = time.perf_counter()
    guidance = sd21_guidance(cfg.guidanceParams)
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

    timed = functools.partial(timed_call, parts)
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
    recon_step, extract_fields = OT.recon_step, mesh.extract_fields
    slab_culls = fields.block_culls
    OT.recon_step = timed("recon_step", recon_step)
    mesh.extract_fields = timed("extract_fields (128^3)", extract_fields)
    fwd_shapes, launch_fwd = {}, fa.launch_fwd

    def count_fwd_shape(q, *a):
        key = str(list(q.shape))
        fwd_shapes[key] = fwd_shapes.get(key, 0) + 1
        return launch_fwd(q, *a)

    fa.launch_fwd = count_fwd_shape
    n0 = num_active(tr.state)
    os.environ["DS_FLASH_ATTN"] = "1"
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_counts()
    t0 = time.perf_counter()
    try:
        tr.train(make_videos=True)
    finally:
        OT.recon_step, mesh.extract_fields = recon_step, extract_fields
        fa.launch_fwd = launch_fwd
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
    expect.update({"flash_fwd.tc": expect["flash_fwd"], "flash_bwd_dkv.tc": len(losses),
                   "flash_bwd_dq.tc": len(losses)})
    assert all(counts[k] == v for k, v in expect.items()), (counts, expect, calls)
    assert all(counts[k] > 0 for k in kernels.KERNEL_NAMES), counts
    assert sum(fwd_shapes.values()) == counts["flash_fwd"], fwd_shapes
    mesh_path = tr.ckpt_path / "smoke_mesh.ply"
    header = mesh_path.read_bytes().split(b"end_header\n")[0].decode()
    n_verts = int(header.split("element vertex ")[1].split()[0])
    n_faces = int(header.split("element face ")[1].split()[0])
    assert parts["extract_fields (128^3)"][0] == 1 and n_verts > 0 and n_faces > 0, header
    # extract_fields at 64^3 on the trained state, card against CPU
    t1 = time.perf_counter()
    occ = extract_fields(tr.state, resolution=64)
    card_s = time.perf_counter() - t1
    t1 = time.perf_counter()
    occ_cpu = extract_fields(_to(tr.state, torch.device("cpu")), resolution=64)
    cpu_s = time.perf_counter() - t1
    occ_err = float(np.abs(occ - occ_cpu).max())
    occ_max = float(np.abs(occ_cpu).max())
    assert occ_max > 0 and occ_err <= 1e-4 * occ_max, (occ_err, occ_max)
    # extract_fields at 128^3 with its slab-narrowed cull and with the JAX
    # package's plain one (every splat tested for every block): same grid
    cull_s = {"slab": [], "plain": []}
    grids = {}
    for kind in ("slab", "plain", "slab"):
        fields.block_culls = plain_block_culls if kind == "plain" else slab_culls
        try:
            t1 = time.perf_counter()
            grids[kind] = extract_fields(tr.state, resolution=128)
            cull_s[kind].append(time.perf_counter() - t1)
        finally:
            fields.block_culls = slab_culls
    assert np.array_equal(grids["slab"], grids["plain"])
    log(f"[mesh] {mesh_path.name}: {n_verts} vertices, {n_faces} faces; extract_fields 128^3 "
        f"{parts['extract_fields (128^3)'][1]:.2f}s in train(); again {cull_s['slab']} s, with "
        f"the plain cull {cull_s['plain']} s (grids equal); 64^3 card {card_s:.2f}s vs cpu "
        f"{cpu_s:.2f}s, max|d| {occ_err:.3g} (max|occ| {occ_max:.3g})")
    log(f"[train] train() {wall:.1f}s wall; losses {losses}; active {n0} -> "
        f"{actives} -> final {n_final}; rungs {rungs}; module calls {calls}; "
        f"peak mem {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB; launches {counts}")
    log(json.dumps({"train": {"wall_s": wall, "parts_s": {k: {"calls": n, "s": sec}
                                                          for k, (n, sec) in parts.items()},
                              "launches": counts, "flash_fwd_by_shape": fwd_shapes,
                              "module_calls": calls, "rungs": rungs,
                              "active": {"start": n0, **actives, "final": n_final},
                              "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
                              "mesh": {"n_verts": n_verts, "n_faces": n_faces,
                                       "extract_fields_64_card_s": card_s,
                                       "extract_fields_64_cpu_s": cpu_s,
                                       "extract_fields_64_max_abs_err": occ_err,
                                       "extract_fields_128_s": cull_s}}}))
    return counts


def plain_block_culls(xyz, max_scale, opac, num_blocks, relax_ratio):
    """The JAX package's per-block cull (dreamscene_tpu/models/fields.py:
    69-79): every splat's distance to every block's center."""
    block_size = 2.0 / num_blocks
    for xi in range(num_blocks):
        for yi in range(num_blocks):
            for zi in range(num_blocks):
                center = np.array([xi, yi, zi]) * block_size - 1.0 + block_size / 2
                d = np.linalg.norm(xyz - center, axis=-1)
                keep = (d <= block_size * 0.87 + relax_ratio * max_scale) & (opac > 0)
                idx = np.nonzero(keep)[0]
                if idx.size:
                    yield (xi, yi, zi), idx


KERNEL_BUCKETS = (("flash_fwd", "K4 flash_fwd"), ("flash_bwd_dkv", "K4 flash_bwd_dkv"),
                  ("flash_bwd_dq", "K4 flash_bwd_dq"),
                  ("composite_bwd_kernel", "K2 composite_bwd"),
                  ("composite_fwd_kernel", "K1 composite_fwd"),
                  ("tile_order_kernel", "K1 composite_fwd"),
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


def profile_step(step_fn, untraced_ms, tag, prefix="fps", ranges=()):
    """One more step (`step_fn()`) under torch.profiler (printed as the
    JSON line `tag`; DS_FLASH_ATTN as the caller left it): device busy time
    by phase and by kernel family, and the device's idle share of the
    untraced median step (the traced step's own wall time is inflated by
    the profiler). A phase's time is the kernel time that starts inside its
    `prefix`.* window on the device timeline. The backward's kernels are
    launched by autograd's device thread, outside every range, so its
    window is the gap from the ladder's end to the optimizer's start (the
    loss terms and the whole backward). Each of `ranges` (a profiler range
    that may open many times in the step, as `controlnet` does once per UNet
    pass) gets the kernel time that starts inside any of its windows."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        step_fn()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3

    spans, kern, opened = {}, [], {r: [] for r in ranges}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        start, end = e.time_range.start, e.time_range.end
        if e.name.startswith(prefix + "."):
            spans[e.name] = (start, end)
        elif e.name in opened:
            opened[e.name].append((start, end))
        else:
            kern.append((start, (end - start) / 1e3, e.name))
    p = prefix
    windows = {k: spans[k] for k in (f"{p}.render", f"{p}.vae_encode", f"{p}.ladder",
                                     f"{p}.adam")}
    windows[f"{p}.backward (loss + backward)"] = (spans[f"{p}.ladder"][1], spans[f"{p}.adam"][0])
    phases = {k: sum(ms for s, ms, _ in kern if lo <= s < hi) for k, (lo, hi) in windows.items()}
    busy = sum(ms for _, ms, _ in kern)
    phases["outside the phases (step inputs)"] = busy - sum(phases.values())
    kernels_ms, buckets = {}, {}
    for _, ms, name in kern:
        kernels_ms[name] = kernels_ms.get(name, 0.0) + ms
        b = next((lab for pat, lab in KERNEL_BUCKETS if pat in name.lower()), "other")
        buckets[b] = buckets.get(b, 0.0) + ms
    top = sorted(kernels_ms.items(), key=lambda kv: -kv[1])[:12]
    in_ranges = {r: {"windows": len(w), "device_busy_ms": sum(
        ms for s, ms, _ in kern if any(lo <= s < hi for lo, hi in w))}
        for r, w in opened.items()}
    log(json.dumps({tag: {
        "traced_step_wall_ms": wall_ms, "device_busy_ms": busy,
        "untraced_step_ms": untraced_ms, "device_idle_share": 1.0 - busy / untraced_ms,
        "phases_device_busy_ms": phases, "kernel_families_ms": buckets,
        **({"ranges": in_ranges} if ranges else {}),
        "top_kernels_ms": [[k[:90], v] for k, v in top]}}))
    return in_ranges


def _to(x, dev):
    """Copy a step's inputs to `dev` (tensors, dicts, lists, states, modules)."""
    import copy
    import dataclasses

    from dreamscene_tpu_torch.guidance.mtsd import GuidanceModules
    from dreamscene_tpu_torch.models.gaussians import AdamState, GaussianState
    from dreamscene_tpu_torch.ops.ddim import make_schedule

    def module(m):
        return None if m is None else copy.deepcopy(m).to(dev)

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
            x, unet=module(x.unet), vae_encoder=module(x.vae_encoder),
            vae_decoder=module(x.vae_decoder), controlnet=module(x.controlnet),
            schedule=make_schedule(device=dev))
    return x


def small_step_parity(controlnet=False):
    """Phase 4 (and, with `controlnet`, phase 10): one small FPS step on the
    card (kernels) against the same step on the CPU (plain versions): same
    state, weights and draws. With `controlnet` the tiny stack has a
    ControlNet whose zero convs carry seeded non-zero weights, and the step
    is conditioned on it (use_control_net_iter 0, controlnet_ratio 1)."""
    from dreamscene_tpu_torch.guidance import mtsd
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
    guidance = None
    if controlnet:
        cfg.optimizationParams.use_control_net_iter = 0
        cfg.guidanceParams.controlnet_ratio = 1.0
        guidance = mtsd.make_tiny_guidance(cfg.guidanceParams, with_controlnet=True, device="cpu")
        fill_zero_convs(guidance.mods.controlnet, torch.Generator().manual_seed(10), 0.2)
    tr = ObjectTrainer(cfg, guidance=guidance, exp_root=fresh_dir("parity"), device="cpu")
    tr.prepare_train()
    inp = tr.step_inputs()
    assert inp["use_cn"] == controlnet
    res_cpu = fps_step(**inp)
    res_gpu = fps_step(**_to(inp, torch.device("cuda")))
    torch.cuda.synchronize()
    loss_c, loss_g = float(res_cpu["loss"]), float(res_gpu["loss"])
    rel = {}
    for k, g in res_cpu["grads"].items():
        den = float(g.norm())
        rel[k] = float((res_gpu["grads"][k].cpu() - g).norm()) / den if den > 0 else 0.0
    label = "small ControlNet FPS step" if controlnet else "small FPS step"
    hint = ""
    if controlnet:      # the hint moves the loss well beyond the tolerance
        loss_plain = float(fps_step(**dict(inp, use_cn=False))["loss"])
        assert abs(loss_plain / loss_c - 1) > 1e-2, (loss_plain, loss_c)
        hint = f"; cpu loss without the hint {loss_plain!r}"
    log(f"[parity] {label} (500 pts, 64^2, C_batch 2): loss card {loss_g!r} "
        f"vs cpu {loss_c!r}{hint}; gradient relative L2 card vs cpu {json.dumps(rel)}")
    assert math.isclose(loss_g, loss_c, rel_tol=1e-4, abs_tol=1e-6), (loss_g, loss_c)
    assert all(v <= 1e-3 for v in rel.values()), rel
    assert int(res_cpu["n_entries"]) == int(res_gpu["n_entries"])

# ------------------------------------------------------------ checkpoint loader
SAFETENSORS_DTYPES = {torch.float32: "F32", torch.float16: "F16"}
TINY_UNET = {"block_out_channels": [32, 32, 64, 64], "cross_attention_dim": 32,
             "attention_head_dim": 8}
TINY_CLIP = {"vocab_size": 514, "hidden_size": 32, "intermediate_size": 64,
             "num_hidden_layers": 2, "num_attention_heads": 4, "max_position_embeddings": 77,
             "hidden_act": "gelu", "layer_norm_eps": 1e-5}
# stabilityai/stable-diffusion-2-1: unet/config.json's widths and heads, and
# text_encoder/config.json (OpenCLIP ViT-H/14's text tower less its last layer)
SD21_UNET = {"block_out_channels": [320, 640, 1280, 1280], "cross_attention_dim": 1024,
             "attention_head_dim": [5, 10, 20, 20]}
SD21_CLIP = {"vocab_size": 49408, "hidden_size": 1024, "intermediate_size": 4096,
             "num_hidden_layers": 23, "num_attention_heads": 16, "max_position_embeddings": 77,
             "hidden_act": "gelu", "layer_norm_eps": 1e-5}
SD21_MERGES = 49408 - 2 * 256 - 2


def save_safetensors(path, tensors: dict):
    """A .safetensors file: 8-byte little-endian header length, the JSON
    header (dtype, shape, data offsets), the tensors' bytes."""
    header, off = {}, 0
    for k, t in tensors.items():
        n = t.numel() * t.element_size()
        header[k] = {"dtype": SAFETENSORS_DTYPES[t.dtype], "shape": list(t.shape),
                     "data_offsets": [off, off + n]}
        off += n
    h = json.dumps(header).encode()
    h += b" " * (-len(h) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(h)) + h)
        for t in tensors.values():
            f.write(t.detach().contiguous().cpu().numpy().tobytes())


def bpe_vocab(n_merges: int, seed: int):
    """CLIP's vocabulary layout: the 256 byte symbols, the same with
    `</w>`, one token per merge, then the two special tokens. The merges
    are seeded pairs of earlier tokens (a left part never ends a word)."""
    from dreamscene_tpu_torch.guidance.clip_text import BOS, EOS, bytes_to_unicode

    chars = list(bytes_to_unicode().values())
    vocab = chars + [c + "</w>" for c in chars]
    known, left, merges = set(vocab), list(chars), []
    rng = np.random.default_rng(seed)
    while len(merges) < n_merges:
        a, b = left[rng.integers(len(left))], vocab[rng.integers(len(vocab))]
        if a + b in known:
            continue
        known.add(a + b)
        vocab.append(a + b)
        merges.append(f"{a} {b}")
        if not b.endswith("</w>"):
            left.append(a + b)
    return vocab + [BOS, EOS], merges


def write_checkpoint(d: Path, unet_json: dict, clip_cfg: dict, n_merges: int,
                     seed: int) -> dict:
    """A diffusers-layout directory of seeded random weights: unet/ and
    controlnet/ (zero convs filled) as F16 safetensors, vae/ (the full-size
    VAE) as a float32 .bin, text_encoder/ as F32 safetensors, tokenizer/
    (`bpe_vocab`), scheduler/. Returns the state dicts as the files hold
    them."""
    from dreamscene_tpu_torch.guidance import sd_modules as sdm
    from dreamscene_tpu_torch.guidance.clip_text import CLIPTextModel
    from dreamscene_tpu_torch.guidance.sd_loader import unet_config

    gen = torch.Generator(device="cuda").manual_seed(seed)
    ucfg = unet_config(unet_json)
    vcfg = sdm.VAEConfig()
    torch.manual_seed(seed)
    with torch.device("cuda"), torch.no_grad():
        unet = sdm.init_random_(sdm.UNet2DCondition(ucfg), gen)
        enc = sdm.init_random_(sdm.VAEEncoder(vcfg), gen)
        dec = sdm.init_random_(sdm.VAEDecoder(vcfg), gen)
        cn = sdm.init_random_(sdm.ControlNet(ucfg), gen)
        fill_zero_convs(cn, gen, 0.05)
        clip = CLIPTextModel(clip_cfg)
    sds = {"unet": {k: v.half().cpu() for k, v in unet.state_dict().items()},
           "vae": {k: v.cpu() for m in (enc, dec) for k, v in m.state_dict().items()},
           "controlnet": {k: v.half().cpu() for k, v in cn.state_dict().items()},
           "text_encoder": {k: v.cpu() for k, v in clip.state_dict().items()}}
    del unet, enc, dec, cn, clip
    torch.cuda.empty_cache()
    for sub in ("unet", "vae", "controlnet", "text_encoder", "tokenizer", "scheduler"):
        (d / sub).mkdir(parents=True)
    (d / "unet" / "config.json").write_text(json.dumps(unet_json))
    save_safetensors(d / "unet" / "diffusion_pytorch_model.safetensors", sds["unet"])
    torch.save(sds["vae"], d / "vae" / "diffusion_pytorch_model.bin")
    save_safetensors(d / "controlnet" / "diffusion_pytorch_model.safetensors", sds["controlnet"])
    (d / "text_encoder" / "config.json").write_text(json.dumps(clip_cfg))
    save_safetensors(d / "text_encoder" / "model.safetensors", sds["text_encoder"])
    vocab, merges = bpe_vocab(n_merges, seed)
    assert len(vocab) == clip_cfg["vocab_size"]
    (d / "tokenizer" / "vocab.json").write_text(json.dumps({t: i for i, t in enumerate(vocab)}))
    (d / "tokenizer" / "merges.txt").write_text("\n".join(["#version: 0.2", *merges]) + "\n")
    (d / "tokenizer" / "tokenizer_config.json").write_text(json.dumps({"model_max_length": 77}))
    (d / "tokenizer" / "special_tokens_map.json").write_text(json.dumps({"pad_token": "!"}))
    (d / "scheduler" / "scheduler_config.json").write_text(json.dumps(
        {"beta_schedule": "scaled_linear", "beta_start": 0.00085, "beta_end": 0.012,
         "prediction_type": "epsilon", "set_alpha_to_one": False}))
    return sds


def timed_load(d: Path, gp):
    """build_sd_guidance(d) on the card and its seconds."""
    from dreamscene_tpu_torch.guidance.sd_loader import build_sd_guidance

    gp.controlnet_model_key = str(d / "controlnet")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    guidance = build_sd_guidance(str(d), gp, device="cuda")
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    assert guidance.mods.controlnet is not None
    return guidance, load_s


def run_loader():
    """Phase 11: build_sd_guidance on the card from a tiny diffusers
    directory written here, held against the same state dicts loaded in
    memory (eps with the ControlNet's residuals, text embeddings); then
    run_validation on it and the validate CLI's --tiny mode at 512^2; then
    the load time of a directory at SD 2.1's widths, every loaded weight
    held equal to the written one."""
    from dreamscene_tpu_torch.guidance import sd_modules as sdm
    from dreamscene_tpu_torch.guidance.clip_text import CLIPTextModel, CLIPTokenizer
    from dreamscene_tpu_torch.guidance.sd_loader import load_torch_state, unet_config
    from dreamscene_tpu_torch.guidance.validate import run_validation
    from dreamscene_tpu_torch.utils.config import GuidanceParams

    d = Path(fresh_dir("sd_checkpoint"))
    t0 = time.perf_counter()
    sds = write_checkpoint(d, TINY_UNET, TINY_CLIP, 0, seed=11)
    write_s = time.perf_counter() - t0
    guidance, load_s = timed_load(d, GuidanceParams())

    # the same state dicts loaded in memory
    ucfg = unet_config(TINY_UNET)
    with torch.device("cuda"):
        unet, cn = sdm.UNet2DCondition(ucfg), sdm.ControlNet(ucfg)
        clip = CLIPTextModel(TINY_CLIP)
    for m, sd in ((unet, sds["unet"]), (cn, sds["controlnet"]), (clip, sds["text_encoder"])):
        m.load_state_dict(sd, strict=True)
        m.requires_grad_(False).eval()
    gen = torch.Generator(device="cuda").manual_seed(12)
    lat = torch.randn((3, 4, 64, 64), generator=gen, device="cuda")
    t = torch.tensor([10, 400, 900], dtype=torch.int32, device="cuda")
    hint = torch.rand((3, 512, 512, 3), generator=gen, device="cuda")
    prompts = ["a photo of a red apple on a table", "", "a DSLR photo, 4k!"]
    with torch.no_grad():
        ctx = guidance.get_text_embeds(prompts)
        ctx_mem = clip(CLIPTokenizer(str(d / "tokenizer"))(prompts).cuda())
        eps = guidance.mods.unet(lat, t, ctx, control_res=guidance.mods.controlnet(lat, t, ctx,
                                                                                   hint))
        eps_mem = unet(lat, t, ctx_mem, control_res=cn(lat, t, ctx_mem, hint))
    err = {"text": float((ctx - ctx_mem).abs().max()), "eps": float((eps - eps_mem).abs().max())}
    assert all(v <= 1e-5 for v in err.values()) and bool(torch.isfinite(eps).all()), err

    out = Path(fresh_dir("sd_validation"))
    report = run_validation(guidance, str(out / "loaded"), size=512)
    cli = subprocess.run([sys.executable, "-m", "dreamscene_tpu_torch.guidance.validate",
                          "--tiny", "--size", "512", "--out", str(out / "tiny")],
                         cwd=Path(__file__).resolve().parent, capture_output=True, text=True,
                         timeout=600)
    assert cli.returncode == 0, cli.stderr[-4000:]
    tiny = json.loads(cli.stdout[cli.stdout.index("{"):])
    files = {}
    for name, rep in (("loaded", report), ("tiny", tiny)):
        assert all(math.isfinite(v) for v in rep.values()) and rep["csd_grad_nan"] == 0, rep
        assert rep["decode_finite"], rep
        files[name] = sorted(p.name for p in (out / name).iterdir())
        assert {f.removesuffix(".npy") for f in files[name]} == {
            "decode_probe.jpg", "roundtrip.jpg", "ladder_grid.jpg", "report.json"}, files
    del guidance, unet, cn, clip
    shutil.rmtree(d)

    # SD 2.1's widths: the load time of a real checkpoint's sizes (the
    # files are read from the page cache, just written)
    d = Path(fresh_dir("sd21_checkpoint"))
    t0 = time.perf_counter()
    sds = write_checkpoint(d, SD21_UNET, SD21_CLIP, SD21_MERGES, seed=21)
    full_write_s = time.perf_counter() - t0
    sizes = {sub: sum(f.stat().st_size for f in (d / sub).iterdir()) / 1e9 for sub in sds}
    guidance, full_load_s = timed_load(d, GuidanceParams())
    t0 = time.perf_counter()
    for sub in sds:
        load_torch_state(str(d / sub))
    read_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    CLIPTokenizer(str(d / "tokenizer"))
    tokenizer_s = time.perf_counter() - t0
    mods = guidance.mods
    loaded = {"unet": mods.unet.state_dict(), "controlnet": mods.controlnet.state_dict(),
              "vae": {**mods.vae_encoder.state_dict(), **mods.vae_decoder.state_dict()}}
    for sub, sd in loaded.items():
        assert sd.keys() == sds[sub].keys(), sub
        bad = [k for k, v in sd.items() if not torch.equal(v.cpu(), sds[sub][k].to(v.dtype))]
        assert not bad, (sub, bad[:5])
    clip = CLIPTextModel(SD21_CLIP)
    clip.load_state_dict(sds["text_encoder"], strict=True)
    clip = clip.cuda().requires_grad_(False).eval()
    with torch.no_grad():
        ctx = guidance.get_text_embeds(prompts)
        text_err = float((ctx - clip(CLIPTokenizer(str(d / "tokenizer"))(prompts).cuda()))
                         .abs().max())
        lat = torch.randn((3, 4, 64, 64), generator=gen, device="cuda")
        eps = mods.unet(lat, t, ctx, control_res=mods.controlnet(lat, t, ctx, hint))
    assert text_err <= 1e-5 and ctx.shape == (3, 77, 1024), (text_err, ctx.shape)
    assert eps.shape == lat.shape and bool(torch.isfinite(eps).all())
    del guidance, mods, loaded, clip, sds
    shutil.rmtree(d)
    torch.cuda.empty_cache()
    log(f"[loader] SD 2.1 widths: {sum(sizes.values()):.2f} GB ({sizes}); build_sd_guidance "
        f"{full_load_s:.2f}s (files read again alone {read_s:.2f}s, tokenizer "
        f"{tokenizer_s:.2f}s); written in {full_write_s:.1f}s; every weight equal")
    log(json.dumps({"loader": {"write_s": write_s, "build_sd_guidance_s": load_s,
                               "max_abs_err_vs_in_memory": err, "validate_loaded": report,
                               "validate_tiny_cli": tiny, "files": files,
                               "sd21_widths": {"gb": sizes, "write_s": full_write_s,
                                               "build_sd_guidance_s": full_load_s,
                                               "read_files_s": read_s,
                                               "tokenizer_s": tokenizer_s,
                                               "text_max_abs_err": text_err}}}))


# ------------------------------------------------------------------ scene path
SCENE_CFG = Path(__file__).resolve().parent / "configs" / "scenes" / "sample_indoor.yaml"
COMP_PTS, COMP_SIZE, COMP_WARM, COMP_TIMED = 60_000, 800, 2, 10
N_SCENE_WARM, N_SCENE_TIMED = 2, 5


def run_composition():
    """Phase 5: config #3's compositional render, forward + backward of
    mean(image) + 0.1 * mean(depth) w.r.t. every object's xyz; K1-K3 held
    against their plain versions at this scene and timed. Returns (launch
    counts of the timed reps, kernel rows, errors)."""
    from dreamscene_tpu_torch import kernels
    from dreamscene_tpu_torch.bench.scenes import binned_inputs, composition_scene
    from dreamscene_tpu_torch.models.scene import final_combine_all
    from dreamscene_tpu_torch.rendering import scene_render

    t0 = time.perf_counter()
    states, cam = composition_scene(COMP_PTS, COMP_SIZE)
    log(f"[comp] set-up {time.perf_counter() - t0:.1f}s: {len(states)} x {COMP_PTS} splats, "
        f"{COMP_SIZE}^2")

    def step():
        xyzs = [st.params["xyz"].detach().requires_grad_(True) for st in states]
        sts = [dataclasses.replace(st, params=dict(st.params, xyz=x))
               for st, x in zip(states, xyzs)]
        out = scene_render(sts, cam, bg_color=(0.0, 0.0, 0.0), test=True)
        loss = out["image"].mean() + 0.1 * out["depth"].mean()
        loss.backward()
        return loss, [x.grad for x in xyzs], out

    torch.cuda.reset_peak_memory_stats()
    for _ in range(COMP_WARM):
        step()
    torch.cuda.synchronize()
    kernels.reset_counts()
    t0 = time.perf_counter()
    for _ in range(COMP_TIMED):
        loss, grads, out = step()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / COMP_TIMED
    counts = dict(kernels.COUNTS)
    assert all(counts[k] == COMP_TIMED for k in K1_K3), counts
    assert math.isfinite(float(loss.detach())) and all(torch.isfinite(g).all() for g in grads)
    assert all(float(g.abs().max()) > 0 for g in grads)
    assert tuple(out["image"].shape) == (3, COMP_SIZE, COMP_SIZE)
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(json.dumps({"composition": {
        "ms_per_fwd_bwd": ms, "mpix_per_s": COMP_SIZE**2 / ms / 1e3, "loss": float(loss),
        "n_entries": int(out["n_entries"]), "n_dropped": int(out["n_dropped"]),
        "n_splats": len(states) * COMP_PTS, "peak_mem_gib": peak, "launches": counts}}))

    combined = final_combine_all(states)
    inp = binned_inputs(combined, cam, 32, 16, sh_degree=0)
    errs, rows = check_kernels("config #3 5x60K 800^2 32x16", inp, timing=True)
    e16, _ = check_kernels("config #3 5x60K 800^2 16x16",
                           binned_inputs(combined, cam, 16, 16, sh_degree=0), timing=False)
    errs = {k: max(v, e16[k]) for k, v in errs.items()}
    return counts, rows, errs


def write_scene_objects(tr, n_pts=50_000):
    """Each scene object's final PLY, as ObjectTrainer.train would leave it
    (and as point-e's init never runs here): a seeded ball of `n_pts`
    splats at the object's sh_degree with varied opacities, shapes and
    colours. object_task then loads it."""
    from dreamscene_tpu_torch.models.gaussians import create_from_points
    from dreamscene_tpu_torch.models.init import init_object_points
    from dreamscene_tpu_torch.models.ply import save_splat_ply

    for i, obj in enumerate(tr.scene_objects):
        pts, cols, _ = init_object_points("default", obj["id"], fresh_dir("init"),
                                          num_pts=n_pts, seed=100 + i)
        st = create_from_points(pts, cols, sh_degree=obj.get("sh_degree", 1), capacity=n_pts,
                                device="cuda")
        g = torch.Generator(device="cuda").manual_seed(100 + i)
        st.params["features_rest"].normal_(0.0, 0.2, generator=g)
        st.params["opacity"].normal_(0.5, 1.5, generator=g)
        st.params["scaling"].add_(torch.randn(st.params["scaling"].shape, device="cuda",
                                              generator=g) * 0.3)
        st.params["rotation"].normal_(0.0, 1.0, generator=g)
        save_splat_ply(str(tr.ckpt_path / f"{obj['id']}_final_model.ply"), st)


def scene_census(tr) -> dict:
    from dreamscene_tpu_torch.models.gaussians import num_active

    names = list(tr.scene.objects)
    return {n: {"active": num_active(st), "capacity": st.capacity}
            for n, st in zip(names + ["floor", "env"], tr._states(names))}


def scene_steps(tr, cams, key, n, tag, only_env=False) -> list:
    """`n` scene_train_step()s over consecutive C_batch slices of `cams`,
    each synchronized and timed; returns the per-step records."""
    c = tr.guidance_opt.C_batch_size
    recs = []
    for i in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = tr.scene_train_step(cams[i * c:(i + 1) * c], key, only_env=only_env)
        torch.cuda.synchronize()
        recs.append(dict(step=tr.step, loss=loss, ms=(time.perf_counter() - t0) * 1e3,
                         n_rungs=tr.last_stats["n_rungs"], n_entries=tr.last_stats["n_entries"],
                         n_dropped=tr.last_stats["n_dropped"],
                         capacity=tr.last_stats["capacity"]))
        log(f"[{tag}] {key} step {tr.step}: loss {loss:.6g}, {recs[-1]['ms']:.1f} ms, "
            f"n_entries {recs[-1]['n_entries']}, n_dropped {recs[-1]['n_dropped']}, "
            f"entry capacity {recs[-1]['capacity']}, ladder {recs[-1]['n_rungs']} rungs")
    assert all(math.isfinite(r["loss"]) for r in recs), recs
    return recs


def run_scene_steps(cn):
    """Phase 6: config #4 (sample_indoor.yaml as shipped, env_density 1.0):
    object_task on the written object PLYs, prepare_train_scene (compress,
    four placed instances, env and floor), then 2 + 5 stage-1 and 5 stage-2
    steps with DS_FLASH_ATTN unset and again with it set, a profiled
    stage-1 step each way, and K1-K3 held against their plain versions on
    a stage-1 view of this scene and on the band of that view a rank of
    phase 13c bins; then phase 9b, two stage-1 steps with the ControlNet
    `cn` conditioning both, gate set. Returns the trainer, launch counts
    by gate (and of phase 9b), kernel rows of the view and of the band,
    and errors."""
    from dreamscene_tpu_torch import kernels
    from dreamscene_tpu_torch.bench.scenes import binned_inputs
    from dreamscene_tpu_torch.models.scene import final_combine_all
    from dreamscene_tpu_torch.training.scene_trainer import SceneTrainer
    from dreamscene_tpu_torch.utils.config import load_config

    cfg = load_config(str(SCENE_CFG), ["log.exp_name=scene"])
    t0 = time.perf_counter()
    guidance = sd21_guidance(cfg.guidanceParams)
    tr = SceneTrainer(cfg, guidance=guidance, exp_root=fresh_dir("scene"), device="cuda",
                      env_density=1.0)
    write_scene_objects(tr)
    parts = {}
    for obj_cfg in tr.scene_objects:
        timed_call(parts, "object_task (load)", tr.object_task)(obj_cfg)
    timed_call(parts, "prepare_train_scene", tr.prepare_train_scene)()
    census = scene_census(tr)
    log(json.dumps({"scene_setup": {"wall_s": time.perf_counter() - t0,
                                    "parts_s": {k: v[1] for k, v in parts.items()},
                                    "models": census,
                                    "total_rows": sum(m["capacity"] for m in census.values())}}))
    assert len(tr.scene.objects) == 4 and census["env"]["active"] == 2_000_000

    c = tr.guidance_opt.C_batch_size
    results, counts_by_gate = {}, {}
    for gate in ("unset", "set"):
        if gate == "set":
            os.environ["DS_FLASH_ATTN"] = "1"
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_counts()
        tr.step, tr.iters = 0, cfg.sceneOptimizationParams.iterations
        tr.guidance.stage_range, tr.guidance.jump_range = (400, 850), (175, 225)
        cams1 = tr._stage1_cams((N_SCENE_WARM + N_SCENE_TIMED) * c)
        rec1 = scene_steps(tr, cams1, "env", N_SCENE_WARM + N_SCENE_TIMED, f"scene {gate}")
        tr.step, tr.iters = 0, max(cfg.sceneOptimizationParams.iterations - 300, 1)
        tr.guidance.stage_range, tr.guidance.jump_range = (350, 750), (150, 200)
        rec2 = scene_steps(tr, tr._stage2_cams(N_SCENE_TIMED * c), "floor", N_SCENE_TIMED,
                           f"scene {gate}")
        counts = dict(kernels.COUNTS)
        n_steps = len(rec1) + len(rec2)
        expect = {k: c * n_steps for k in K1_K3}
        if gate == "unset":
            expect.update({k: 0 for k in K4 + kernels.VARIANT_NAMES})
        else:
            expect.update(k4_expect([r["n_rungs"] for r in rec1 + rec2], 10, n_steps))
        assert counts == expect, (gate, counts, expect)
        counts_by_gate[gate] = counts
        ms1 = float(np.median([r["ms"] for r in rec1[N_SCENE_WARM:]]))
        ms2 = float(np.median([r["ms"] for r in rec2]))
        results[gate] = {"stage1_ms_median": ms1, "stage2_ms_median": ms2,
                         "stage1": rec1, "stage2": rec2, "launches": counts,
                         "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
                         "models": scene_census(tr)}
        log(json.dumps({f"scene_steps_{gate}": results[gate]}))
        cams_p = tr._stage1_cams(c)
        tr.step, tr.iters = 1, cfg.sceneOptimizationParams.iterations
        profile_step(lambda: tr.scene_train_step(cams_p[:c], "env"), ms1,
                     "scene_profile" if gate == "unset" else "scene_profile_flash", "scene")
        os.environ.pop("DS_FLASH_ATTN", None)

    names = list(tr.scene.objects)
    sts = tr._states(names)
    combined = final_combine_all(sts)
    capacity = int(tr.cap_ctrl.mult * sum(st.capacity for st in sts)) // 2
    inp = binned_inputs(combined, cams1[0], 32, 16, capacity=capacity,
                        sh_degree=min(st.active_sh_degree for st in sts))
    errs, rows = check_kernels("config #4 scene 512^2 32x16 (stage-1 view)", inp, timing=True)
    # the tile band a tp-2 rank of phase 13c bins: rows 256-511 of the same
    # view, every record (a shard's are gathered), chunk 256, the per-band
    # entry capacity of SceneTrainer.step_inputs
    inp = binned_inputs(combined, cams1[0], 32, 16, capacity=max(capacity // 2, 4096),
                        chunk=256, sh_degree=min(st.active_sh_degree for st in sts),
                        band=(256, 256))
    e, band_rows = check_kernels("config #4 mesh band 512x256 from row 256 (chunk 256)", inp,
                                 timing=True)
    errs = {k: max(errs[k], e[k]) for k in K1_K3}
    del combined, inp
    counts_by_gate["controlnet"] = scene_controlnet_steps(tr, cn)
    return tr, counts_by_gate, rows, band_rows, errs


def scene_controlnet_steps(tr, cn, n=2):
    """Phase 9b: `n` config #4 stage-1 steps with the ControlNet `cn`
    conditioning each (use_control_net_iter 0, controlnet_ratio 1), gate
    set; the guidance is left as it was found."""
    from dreamscene_tpu_torch import kernels

    g, optp = tr.guidance, tr.cfg.sceneOptimizationParams
    saved = optp.use_control_net_iter, g.guidance_opt.controlnet_ratio
    g.mods.controlnet = cn
    optp.use_control_net_iter, g.guidance_opt.controlnet_ratio = 0, 1.0
    calls = {"n": 0}
    hook = cn.register_forward_hook(lambda *_: calls.__setitem__("n", calls["n"] + 1))
    os.environ["DS_FLASH_ATTN"] = "1"
    try:
        c = tr.guidance_opt.C_batch_size
        tr.step, tr.iters = 0, optp.iterations
        g.stage_range, g.jump_range = (400, 850), (175, 225)
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_counts()
        recs = scene_steps(tr, tr._stage1_cams(n * c), "env", n, "scene controlnet")
        counts = dict(kernels.COUNTS)
    finally:
        hook.remove()
        os.environ.pop("DS_FLASH_ATTN")
        g.mods.controlnet = None
        optp.use_control_net_iter, g.guidance_opt.controlnet_ratio = saved
    rungs = [r["n_rungs"] for r in recs]
    assert calls["n"] == sum(r + 1 for r in rungs), (calls, rungs)
    expect = {k: c * n for k in K1_K3}
    expect.update(k4_expect(rungs, 10 + 4, n))
    assert counts == expect, (counts, expect)
    log(json.dumps({"scene_controlnet_steps": {
        "steps": recs, "launches": counts,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}}))
    return counts


def run_scene_train(guidance, exp_root):
    """Phase 7: SceneTrainer.train(n_stage3=1, make_videos=True) at config
    #4 width with DS_FLASH_ATTN=1: sceneOptimizationParams.iterations=3
    (3 stage-1 steps, 1 stage-2 step), one 80-camera pseudo-GT bank and its
    recon steps, the final videos and scene_final_model.ply; then a second
    train() that resumes at stage 3 and trains nothing. Returns the
    launch counts of the first train()."""
    from dreamscene_tpu_torch import kernels
    from dreamscene_tpu_torch.models.gaussians import num_active
    from dreamscene_tpu_torch.models.ply import load_splat_ply
    from dreamscene_tpu_torch.training import scene_trainer as ST
    from dreamscene_tpu_torch.utils.config import load_config

    cfg = load_config(str(SCENE_CFG), ["log.exp_name=scene",
                                       "sceneOptimizationParams.iterations=3"])
    tr = ST.SceneTrainer(cfg, guidance=guidance, exp_root=exp_root, device="cuda",
                         env_density=1.0)
    parts = {}
    timed = functools.partial(timed_call, parts)
    for name in ("object_task", "prepare_train_scene", "scene_train_step", "_pseudo_gt_bank",
                 "scene_refine_phase", "save_ckpt", "scene_video_inference"):
        setattr(tr, name, timed(name, getattr(tr, name)))
    save_ply, scene_step = ST.save_splat_ply, ST.scene_step
    ST.save_splat_ply = timed("final PLY", save_ply)
    ST.scene_step = timed("scene_step (all stages)", scene_step)
    os.environ["DS_FLASH_ATTN"] = "1"
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_counts()
    t0 = time.perf_counter()
    try:
        combined = tr.train(n_stage3=1, make_videos=True)
    finally:
        ST.save_splat_ply, ST.scene_step = save_ply, scene_step
        os.environ.pop("DS_FLASH_ATTN")
    wall = time.perf_counter() - t0
    counts = dict(kernels.COUNTS)
    peak = torch.cuda.max_memory_allocated() / 2**30

    c = tr.guidance_opt.C_batch_size
    n_stage_steps = parts["scene_train_step"][0]
    n_recon = parts["scene_step (all stages)"][0] - n_stage_steps
    assert tr.scene.stage_n == 3 and n_stage_steps == 4, (tr.scene.stage_n, parts)
    assert tr.gt_size >= 80 and n_recon == tr.gt_size, (tr.gt_size, n_recon)
    for n in (1, 2, 3):
        assert (tr.scene_ckpt_path / f"scene_{n}_stage.ckpt.npz").exists()
    assert glob.glob(str(tr.vis_path / "video_rgb_scene_final.mp4*"))
    n_frames = len(tr.scene_cams_inference)
    trained_renders = c * n_stage_steps + n_recon
    assert counts["composite_bwd"] == trained_renders, (counts, trained_renders)
    assert counts["composite_fwd"] == counts["expand_entries"] == \
        trained_renders + tr.gt_size + n_frames, (counts, n_frames)
    assert all(counts[k] > 0 for k in kernels.KERNEL_NAMES), counts
    final = tr.scene_ckpt_path / "scene_final_model.ply"
    n_final = num_active(combined)
    assert num_active(load_splat_ply(str(final), device="cuda")) == n_final
    assert all(torch.isfinite(v).all() for v in combined.params.values())

    # a second train() resumes at stage 3 and trains nothing
    calls = {"scene_step": 0}

    def no_train(*a, **kw):
        calls["scene_step"] += 1
        return scene_step(*a, **kw)

    ST.scene_step = no_train
    try:
        t1 = time.perf_counter()
        tr2 = ST.SceneTrainer(cfg, guidance=guidance, exp_root=exp_root, device="cuda",
                              env_density=1.0)
        combined2 = tr2.train(n_stage3=1)
        resume_s = time.perf_counter() - t1
    finally:
        ST.scene_step = scene_step
    assert calls["scene_step"] == 0 and tr2.scene.stage_n == 3, calls
    assert num_active(combined2) == n_final
    log(json.dumps({"scene_train": {
        "wall_s": wall, "parts_s": {k: {"calls": n, "s": sec} for k, (n, sec) in parts.items()},
        "stage_steps": n_stage_steps, "recon_steps": n_recon, "video_frames": n_frames,
        "final_active": n_final, "peak_mem_gib": peak, "launches": counts,
        "resume_train_s": resume_s}}))
    return counts


def small_scene_parity(outdoor=False):
    """Phase 8 (and, with `outdoor`, phase 15f): one small scene step on
    the card (kernels) against the same step on the CPU (plain versions):
    the tiny scene of tests/test_torch_scene_step.py (32^2, two placed
    60-splat objects, env and floor at density 0.0002 as after some
    training: rest-SH, varied opacities, anisotropic and rotated, at
    full-density footprints), same weights, inputs and draws; a stage-1
    guidance step (env trainable) and a stage-3 recon step (every model
    trainable, against the refine's own pseudo-GT). Outdoor (config #5's
    method and box, tests/test_torch_scene_outdoor.py): the stage-1 step
    renders floor + env alone, and the recon step is the floor-only
    refine's (floor + env from a mirrored Stage3_Outdoor camera, the floor
    trainable). A fresh env at a larger size is no test: its scale
    gradient is a residual that a 1e-7 relative nudge of xyz moves by
    2-5e-3 on the CPU alone (PERF.md, Findings)."""
    from dreamscene_tpu_torch.models.gaussians import create_from_points
    from dreamscene_tpu_torch.models.ply import save_splat_ply
    from dreamscene_tpu_torch.training.scene_trainer import SceneTrainer, scene_step
    from dreamscene_tpu_torch.utils.config import ParamsGroups

    size = 32
    cfg = ParamsGroups()
    cfg.log = {"exp_name": "chip_smoke_scene_small"}
    cfg.guidanceParams.C_batch_size = 2
    cfg.sceneGenerateCamParams.image_w = cfg.sceneGenerateCamParams.image_h = size
    cfg.mode_args = {}
    comp = [{"id": "a", "params": [{"center": [-1.0, 1.0, 0.0], "rotation": [0.0, 0.0, 30.0],
                                    "scale": [1.5] * 3}]},
            {"id": "b", "params": [{"center": [1.5, -0.5, 0.0], "rotation": [0.0, 0.0, 0.0],
                                    "scale": [1.0] * 3}]}]
    cfg.scene_configs = {"objects": [], "scene": {
        "sh_degree": 1, "cam_pose_method": "outdoor" if outdoor else "indoor",
        "scene_text": "a minecraft world" if outdoor else "a room", "compress_objects": False,
        "radius": [15, 15, 4] if outdoor else [3.5, 2.5, 5.0], "scene_composition": comp}}
    tr = SceneTrainer(cfg, exp_root=fresh_dir("scene_parity"), device="cpu", env_density=0.0002)

    def perturb(p, rng, sd):
        for f, s in sd.items():
            p[f] = p[f] + torch.from_numpy(s * rng.randn(*p[f].shape).astype(np.float32))

    for i, oid in enumerate(("a", "b")):
        rng = np.random.RandomState(10 + i)
        st = create_from_points((rng.randn(60, 3) * 0.3).astype(np.float32),
                                rng.rand(60, 3).astype(np.float32), sh_degree=1, capacity=60)
        perturb(st.params, rng, {"opacity": 1.0, "features_rest": 0.2, "scaling": 0.3,
                                 "rotation": 0.3})
        save_splat_ply(str(tr.ckpt_path / f"{oid}_final_model.ply"), st)
    tr.prepare_train_scene()
    rng = np.random.RandomState(3)
    for st in (tr.scene.env, tr.scene.floor):
        st.params["scaling"] += math.log(0.2)
        perturb(st.params, rng, {"features_rest": 0.2, "opacity": 2.0, "scaling": 0.4,
                                 "rotation": 0.3})
        st.active_sh_degree = 1
    cams = tr._stage1_cams(4)
    # the recon step's camera and the refine's own target
    cams3 = tr.cams_loader.Stage3_Outdoor("env") if outdoor else cams
    tr.gt_size = 4
    gt = tr._pseudo_gt_bank(cams3[:4], only_env=outdoor)[0]

    def grad_rel(res, ref):
        """Per trained model and group: relative L2 and max|d| / max|g|."""
        rel = {}
        for m, g in enumerate(ref["grads"]):
            for k, v in (g or {}).items():
                d, den = res["grads"][m][k].cpu() - v, float(v.norm())
                rel[f"{m}.{k}"] = ((float(d.norm()) / den, float(d.abs().max() / v.abs().max()))
                                   if den > 0 else (0.0, 0.0))
        return rel

    def nudged(args):
        """The inputs with every xyz moved by a 1e-7 relative amount."""
        g = torch.Generator().manual_seed(11)
        states = [dataclasses.replace(st, params=dict(st.params, xyz=st.params["xyz"] * (
            1 + 1e-7 * torch.randn(st.params["xyz"].shape, generator=g))))
            for st in args["states"]]
        return dict(args, states=states)

    # the stage-1 step is held in every group; the recon step (every model
    # trained) only in the groups that a 1e-7 nudge of xyz moves by less
    # than 1e-4 on the CPU itself: its floor and env rotation and scale
    # gradients are residuals of cancelling edge terms that the nudge moves
    # by 1e-3 and more (PERF.md, Findings), so no two devices can agree on them
    recon = ("floor", True, False) if outdoor else ("all", False, True)
    tag = "outdoor " if outdoor else ""
    for label, args, every_group in (
            (f"{tag}stage-1 env", tr.step_inputs(cams[:2], "env", outdoor, False, 0.5)["args"],
             True),
            (f"{tag}stage-3 recon {recon[0]}",
             tr.step_inputs(cams3[:1], *recon, 1.0, guidance_on=False, gt_images=[gt])["args"],
             False)):
        res_cpu = scene_step(**args)
        res_gpu = scene_step(**_to(args, torch.device("cuda")))
        torch.cuda.synchronize()
        loss_c, loss_g = float(res_cpu["loss"]), float(res_gpu["loss"])
        rel = grad_rel(res_gpu, res_cpu)
        sens = grad_rel(scene_step(**nudged(args)), res_cpu)
        held = {k: v[0] for k, v in rel.items() if every_group or sens[k][0] <= 1e-4}
        log(f"[scene parity] {label} (the CPU tests' tiny scene, {size}^2): loss card "
            f"{loss_g!r} vs cpu {loss_c!r}; gradient relative L2 and max|d|/max|g| card vs "
            f"cpu, beside the CPU's own under a 1e-7 xyz nudge: " + json.dumps(
                {k: {"card_vs_cpu": rel[k], "cpu_nudge": sens[k]} for k in rel})
            + f"; held at 1e-3: {len(held)} of {len(rel)} groups, worst "
            f"{max(held.values()):.3g}")
        assert math.isclose(loss_g, loss_c, rel_tol=1e-4, abs_tol=1e-6), (loss_g, loss_c)
        assert all(v <= 1e-3 for v in held.values()), held
        assert int(res_cpu["n_entries"]) == int(res_gpu["n_entries"])


# --------------------------------------------------- outdoor scene (config #5)
OUTDOOR_CFG = Path(__file__).resolve().parent / "configs" / "scenes" / "sample_outdoor.yaml"
OUTDOOR_EXP = "scene_outdoor_generation"        # the config's log.exp_name


def outdoor_init_counts(scene_box):
    """init_env_points / init_floor_points' outdoor point counts at env
    density 1: ceil(r * 50,000) on the shell, ceil(r * 20,000) on the
    disk, r the distance from the origin to the scene box's far corner."""
    sb = np.abs(np.asarray(scene_box, np.float64))
    r = float(np.sqrt(np.sum(np.maximum(sb[:3], sb[3:]) ** 2)))
    return r, math.ceil(r * 50000), math.ceil(r * 20000)


def state_bytes(st) -> int:
    """Device bytes of a model: params, Adam moments, aux."""
    ts = [*st.params.values(), *st.opt.mu.values(), *st.opt.nu.values(), *st.aux.values()]
    return sum(t.numel() * t.element_size() for t in ts)


def outdoor_trainer(guidance, exp_root, overrides=()):
    from dreamscene_tpu_torch.training.scene_trainer import SceneTrainer
    from dreamscene_tpu_torch.utils.config import load_config

    cfg = load_config(str(OUTDOOR_CFG), list(overrides))
    return cfg, SceneTrainer(cfg, guidance=guidance, exp_root=exp_root, device="cuda",
                             env_density=1.0)


def run_outdoor_steps(guidance):
    """Phases 15a-15c: config #5 (sample_outdoor.yaml as shipped, env
    density 1.0, DS_FLASH_ATTN=1). 15a: the two objects written as finished
    PLYs (20K splats each; point-e never runs), object_task, then
    prepare_train_scene (compress, the two placements, the env shell and
    floor disk), the census held to the init formula. 15b: 2 + 5 stage-1
    steps rendering floor + env alone (only_env, as train() runs outdoor
    stage 1) from _stage1_cams, and 5 stage-2 steps (objects visible,
    floor trainable) from _stage2_cams at train()'s outdoor ranges; launch
    counts checked, a profiled stage-1 step, peak memory. 15c: K1-K3 held
    against their plain versions and timed on a Stage1_Outdoor view (floor
    + env, from inside the shell looking outward) at 32x16, and on a
    mirrored (scale -1) Stage2_Outdoor view (every model, the floor near
    the horizon) at 32x16 and 16x16. Returns the trainer, launch counts,
    kernel rows by view and errors."""
    from dreamscene_tpu_torch import kernels
    from dreamscene_tpu_torch.bench.scenes import binned_inputs
    from dreamscene_tpu_torch.models.scene import final_combine_all

    t0 = time.perf_counter()
    cfg, tr = outdoor_trainer(guidance, fresh_dir("outdoor"))
    write_scene_objects(tr, n_pts=20_000)
    parts = {}
    for obj_cfg in tr.scene_objects:
        timed_call(parts, "object_task (load)", tr.object_task)(obj_cfg)
    timed_call(parts, "prepare_train_scene", tr.prepare_train_scene)()
    census = scene_census(tr)
    for name, st in zip(list(tr.scene.objects) + ["floor", "env"],
                        tr._states(list(tr.scene.objects))):
        census[name]["bytes"] = state_bytes(st)
    r, n_env, n_floor = outdoor_init_counts(tr.scene.scene_box)
    log(json.dumps({"outdoor_setup": {
        "wall_s": time.perf_counter() - t0, "parts_s": {k: v[1] for k, v in parts.items()},
        "scene_box": [float(x) for x in tr.scene.scene_box], "radius_base": r,
        "init_formula": {"env": n_env, "floor": n_floor}, "models": census,
        "total_rows": sum(m["capacity"] for m in census.values()),
        "total_gb": sum(m["bytes"] for m in census.values()) / 1e9}}))
    assert len(tr.scene.objects) == 2 and tr.cam_pose_method == "outdoor"
    assert census["env"]["active"] == n_env and census["floor"]["active"] == n_floor, census
    assert census["env"]["capacity"] == int(n_env * 1.5)
    assert census["floor"]["capacity"] == int(n_floor * 1.5)

    c, g = tr.guidance_opt.C_batch_size, tr.guidance
    os.environ["DS_FLASH_ATTN"] = "1"
    try:
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_counts()
        tr.step, tr.iters = 0, cfg.sceneOptimizationParams.iterations
        g.stage_range, g.jump_range = (400, 850), (175, 225)      # MTSD's, as train() finds them
        cams1 = tr._stage1_cams((N_SCENE_WARM + N_SCENE_TIMED) * c)
        rec1 = scene_steps(tr, cams1, "env", N_SCENE_WARM + N_SCENE_TIMED, "outdoor",
                           only_env=True)
        # train()'s outdoor stage 2: the pool drawn at (350, 800), the steps
        # run at (350, 750) (the JAX package's train() sets both, in that order)
        tr.step, tr.iters = 0, max(cfg.sceneOptimizationParams.iterations - 300, 1)
        g.stage_range, g.jump_range = (350, 800), (150, 200)
        cams2 = tr._stage2_cams(N_SCENE_TIMED * c)
        g.stage_range = (350, 750)
        rec2 = scene_steps(tr, cams2, "floor", N_SCENE_TIMED, "outdoor")
        counts = dict(kernels.COUNTS)
        n_steps = len(rec1) + len(rec2)
        expect = {k: c * n_steps for k in K1_K3}
        expect.update(k4_expect([x["n_rungs"] for x in rec1 + rec2], 10, n_steps))
        assert counts == expect, (counts, expect)
        ms1 = float(np.median([x["ms"] for x in rec1[N_SCENE_WARM:]]))
        ms2 = float(np.median([x["ms"] for x in rec2]))
        log(json.dumps({"outdoor_steps": {
            "stage1_ms_median": ms1, "stage2_ms_median": ms2, "stage1": rec1, "stage2": rec2,
            "launches": counts, "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
            "models": scene_census(tr)}}))
        assert all(x["n_entries"] > 0 for x in rec1 + rec2)
        cams_p = tr._stage1_cams(c)
        tr.step, tr.iters = 1, cfg.sceneOptimizationParams.iterations
        g.stage_range, g.jump_range = (400, 850), (175, 225)
        profile_step(lambda: tr.scene_train_step(cams_p[:c], "env", only_env=True), ms1,
                     "outdoor_profile_flash", "scene")
    finally:
        os.environ.pop("DS_FLASH_ATTN", None)

    names = list(tr.scene.objects)
    view1 = cams1[0]
    view2 = next(cam for cam in cams2 if cam.scale < 0)
    rows, errs = {}, {k: 0.0 for k in K1_K3}
    for label, sts, cam, tiles in (
            ("config #5 stage-1 view (floor + env) 512^2 32x16", tr._states([]), view1,
             (32, 16)),
            ("config #5 stage-2 mirrored view 512^2 32x16", tr._states(names), view2, (32, 16)),
            ("config #5 stage-2 mirrored view 512^2 16x16", tr._states(names), view2, (16, 16))):
        combined = final_combine_all(sts)
        capacity = int(tr.cap_ctrl.mult * sum(st.capacity for st in sts)) // 2
        inp = binned_inputs(combined, cam, *tiles, capacity=capacity,
                            sh_degree=min(st.active_sh_degree for st in sts))
        log(f"[kernels] {label}: camera scale {cam.scale}, delta polar {cam.delta_polar:.1f}, "
            f"{combined.capacity} rows, entry capacity {capacity}, n_dropped "
            f"{int(inp['binned'].n_dropped)}")
        assert int(inp["binned"].n_dropped) == 0, label
        e, rows[label] = check_kernels(label, inp, timing=True)
        errs = {k: max(errs[k], e[k]) for k in K1_K3}
        del combined, inp
    return tr, counts, rows, errs


def run_outdoor_train(guidance, exp_root):
    """Phase 15d: SceneTrainer.train(n_stage3=1, make_videos=True,
    video_every=3) on phase 15a's scene (config #5), cut as phase 7 cuts
    config #4: sceneOptimizationParams.iterations=3 (3 stage-1 steps of
    floor + env, 1 stage-2 step), DS_FLASH_ATTN=1. Covers the only-env
    videos (after the third stage-1 step and after the stage-2 step), the
    stage checkpoints, the 80-camera Stage3_Outdoor("env") + Stage2_Outdoor
    pseudo-GT bank of floor + env and its floor-only recon steps (env and
    objects bit-equal across stage 3, the floor moving), the final video of
    every model and scene_final_model.ply reloaded. Returns the trainer and
    the launch counts."""
    from dreamscene_tpu_torch import kernels
    from dreamscene_tpu_torch.models.gaussians import num_active
    from dreamscene_tpu_torch.models.ply import load_splat_ply
    from dreamscene_tpu_torch.training import scene_trainer as ST

    cfg, tr = outdoor_trainer(guidance, exp_root, ["sceneOptimizationParams.iterations=3"])
    parts = {}
    timed = functools.partial(timed_call, parts)
    refine = tr.scene_refine_phase
    moved = {}

    def untrained():
        return {"env": tr.scene.env, **{n: e.state for n, e in tr.scene.objects.items()}}

    def held_refine(only_env, scene_optim):
        """The outdoor refine, holding the env and the objects bit-equal."""
        assert only_env and not scene_optim
        keep = {n: {f: v.clone() for f, v in st.params.items()} for n, st in untrained().items()}
        floor0 = tr.scene.floor.params["xyz"].clone()
        refine(only_env, scene_optim)
        for n, st in untrained().items():
            assert all(torch.equal(st.params[f], v) for f, v in keep[n].items()), n
        moved["floor_xyz_max_abs"] = float((tr.scene.floor.params["xyz"] - floor0).abs().max())
        assert moved["floor_xyz_max_abs"] > 0

    tr.scene_refine_phase = held_refine
    for name in ("object_task", "prepare_train_scene", "scene_train_step", "_pseudo_gt_bank",
                 "scene_refine_phase", "save_ckpt", "scene_video_inference"):
        setattr(tr, name, timed(name, getattr(tr, name)))
    save_ply, scene_step = ST.save_splat_ply, ST.scene_step
    ST.save_splat_ply = timed("final PLY", save_ply)
    ST.scene_step = timed("scene_step (all stages)", scene_step)
    os.environ["DS_FLASH_ATTN"] = "1"
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_counts()
    t0 = time.perf_counter()
    try:
        combined = tr.train(n_stage3=1, make_videos=True, video_every=3)
    finally:
        ST.save_splat_ply, ST.scene_step = save_ply, scene_step
        os.environ.pop("DS_FLASH_ATTN")
    wall = time.perf_counter() - t0
    counts = dict(kernels.COUNTS)

    c = tr.guidance_opt.C_batch_size
    n_stage_steps = parts["scene_train_step"][0]
    n_recon = parts["scene_step (all stages)"][0] - n_stage_steps
    n_frames = len(tr.scene_cams_inference)
    assert tr.scene.stage_n == 3 and n_stage_steps == 4, (tr.scene.stage_n, parts)
    assert tr.gt_size >= 20 * c and n_recon == tr.gt_size, (tr.gt_size, n_recon)
    assert parts["_pseudo_gt_bank"][0] == 1 and parts["scene_video_inference"][0] == 3, parts
    for n in (1, 2, 3):
        assert (tr.scene_ckpt_path / f"scene_{n}_stage.ckpt.npz").exists()
    for tag in ("3", "4", "final"):          # the only-env videos after steps 3 and 3 + 1
        assert glob.glob(str(tr.vis_path / f"video_rgb_scene_{tag}.mp4*")), tag
    trained_renders = c * n_stage_steps + n_recon
    assert counts["composite_bwd"] == trained_renders, (counts, trained_renders)
    assert counts["composite_fwd"] == counts["expand_entries"] == \
        trained_renders + tr.gt_size + 3 * n_frames, (counts, n_frames)
    assert all(counts[k] > 0 for k in kernels.KERNEL_NAMES), counts
    final = tr.scene_ckpt_path / "scene_final_model.ply"
    n_final = num_active(combined)
    assert num_active(load_splat_ply(str(final), device="cuda")) == n_final
    assert all(torch.isfinite(v).all() for v in combined.params.values())
    log(json.dumps({"outdoor_train": {
        "wall_s": wall, "parts_s": {k: {"calls": n, "s": sec} for k, (n, sec) in parts.items()},
        "stage_steps": n_stage_steps, "recon_steps": n_recon, "video_frames": n_frames,
        "stage3_env_and_objects_bit_equal": True, **moved, "final_active": n_final,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30, "launches": counts}}))
    return tr, counts


def video_frames(path: Path) -> int:
    """Frames in a video that utils/media.write_video wrote (its .npz
    stand-in without imageio)."""
    npz = Path(str(path) + ".npz")
    if npz.exists():
        with np.load(npz) as z:
            return int(z["frames"].shape[0])
    import imageio

    return imageio.v2.get_reader(str(path)).count_frames()


def run_outdoor_cli(tr):
    """Phase 15e: the CLI on the card, as a user runs it, in phase 15d's
    experiment root: `python3 -m dreamscene_tpu_torch --config
    configs/scenes/sample_outdoor.yaml --exp-root ROOT only_render=true`
    renders the walkthrough from the stage-3 checkpoint (as many frames as
    scene_cams_inference holds, counted here on a camera loader seeded as
    the CLI's is) and writes no checkpoint; then the same command without
    only_render resumes at stage 3, trains nothing and rewrites
    scene_final_model.ply."""
    import types

    from dreamscene_tpu_torch.cameras.scene_sampling import SceneCameraLoader
    from dreamscene_tpu_torch.training.scene_trainer import SceneTrainer
    from dreamscene_tpu_torch.utils.config import load_config

    cfg = load_config(str(OUTDOOR_CFG), [])
    loader = SceneCameraLoader(np.random.default_rng(cfg.seed), cfg.sceneGenerateCamParams,
                               tr.scene.scene_box, tr.scene.objects_args, "outdoor")
    for oa in tr.scene.objects_args:             # train()'s draws before the walkthrough
        loader.Circle(affine_params=oa.affine, circle_size=24)
    loader.Circle(circle_size=24)
    walk = SceneTrainer.scene_only_render(types.SimpleNamespace(
        cams_loader=loader, cam_pose_method="outdoor", scene_video_inference=lambda tag: None))
    exp_root = tr.exp_path.parent
    ckpts, vis = tr.scene_ckpt_path, tr.vis_path
    final = ckpts / "scene_final_model.ply"
    stages = sorted(ckpts.glob("scene_*_stage.ckpt.npz"))
    assert len(stages) == 3

    def stamps():
        return {p.name: p.stat().st_mtime_ns for p in stages}

    before, final_t = stamps(), final.stat().st_mtime_ns
    cmd = [sys.executable, "-m", "dreamscene_tpu_torch", "--config",
           str(OUTDOOR_CFG.relative_to(OUTDOOR_CFG.parents[2])), "--exp-root", str(exp_root)]
    out = {}
    for label, extra in (("only_render", ["only_render=true"]), ("resume", [])):
        t0 = time.perf_counter()
        run = subprocess.run(cmd + extra, cwd=OUTDOOR_CFG.parents[2], capture_output=True,
                             text=True, timeout=900)
        out[label] = {"wall_s": time.perf_counter() - t0, "returncode": run.returncode}
        assert run.returncode == 0, (label, run.stderr[-4000:])
        assert "resumed scene at stage 3" in run.stderr, (label, run.stderr[-4000:])
        assert not any(f"Stage-{n}" in run.stderr for n in (1, 2, 3)), (label, run.stderr[-4000:])
        assert stamps() == before, label
    frames = {kind: video_frames(vis / f"video_{kind}_scene_render.mp4")
              for kind in ("rgb", "depth")}
    assert frames == {"rgb": len(walk), "depth": len(walk)}, (frames, len(walk))
    assert final.stat().st_mtime_ns > final_t
    out["only_render"]["walkthrough_frames"] = frames["rgb"]
    log(json.dumps({"outdoor_cli": out}))


# ------------------------------------------------------------ mesh (parallel/)
MESH_TIMEOUT_S = 600          # bounds each collective and each phase's ranks
LABEL = "ranks sharing one H100 over gloo, not a scaling number"


def run_band_kernels():
    """Phase 13a: the mesh path's tile bands of phase 2's 50K-splat object
    (512 wide, 32x16 tiles, chunk 256 as parallel/sharded_render renders
    them): K1-K3 held against their plain versions at 512x256 from row 256
    (tp 2; timed) and at 512x128 from row 256 (a tp-4 band; the one from
    row 384 holds no entry of this object); then the bands of the
    rasterizer's `render(pixel_offset_y=, full_height=)` stacked against
    the full render, for tp 2 and tp 4, on the card (kernels) and on the
    CPU (plain versions). Returns (kernel rows of the tp-2 band, errors)."""
    from dreamscene_tpu_torch.bench.scenes import binned_inputs
    from dreamscene_tpu_torch.ops.rasterizer import render
    from dreamscene_tpu_torch.training.object_trainer import camera_tensors

    st, cam = make_scene(50_000, 512, 512, seed=50_000)
    errs, rows = {k: 0.0 for k in K1_K3}, None
    for band_h, first, timing in ((256, 256, True), (128, 256, False)):
        inp = binned_inputs(st, cam, 32, 16, chunk=256, band=(first, band_h))
        assert int(inp["binned"].n_entries) > 0
        e, r = check_kernels(f"band 512x{band_h} from row {first} (50K, 32x16, chunk 256)",
                             inp, timing)
        errs = {k: max(errs[k], e[k]) for k in K1_K3}
        rows = r or rows
    stats = {}
    for dev in ("cuda", "cpu"):
        kw = dict(means3d=st.get_xyz, scales=st.get_scaling, quats=st.get_rotation,
                  opacities=st.get_opacity[:, 0], shs=st.get_features,
                  valid_mask=st.aux["active"], **camera_tensors([cam], "cuda")[0])
        kw = {k: (v.to(dev) if torch.is_tensor(v) else v) for k, v in kw.items()}
        kw.update(width=512, bg=torch.zeros(3, device=dev), sh_degree=2, capacity=1 << 20,
                  chunk=256, device=dev)
        with torch.no_grad():
            full = render(**kw, height=512)
            assert int(full["n_dropped"]) == 0
            for n_tp in (2, 4):
                h = 512 // n_tp
                bands = [render(**kw, height=h, pixel_offset_y=t * h, full_height=512)
                         for t in range(n_tp)]
                assert all(torch.equal(b["radii"], full["radii"]) for b in bands)
                assert all(int(b["n_dropped"]) == 0 for b in bands)
                for key, dim in (("image", 1), ("alpha", 0), ("depth", 0)):
                    got = torch.cat([b[key] for b in bands], dim=dim)
                    bad = ~torch.isclose(got, full[key], atol=1e-5, rtol=1e-4)
                    stats[f"{dev} tp {n_tp} {key}"] = {
                        "max_abs_diff": float((got - full[key]).abs().max()),
                        "values_beyond_tol": int(bad.sum()), "values": bad.numel()}
    log("[mesh] bands stacked against the full 512^2 render (atol 1e-5, rtol 1e-4): "
        + json.dumps(stats))
    # the band shift rounds the shifted screen y of splats far from the band
    # and so moves a few values across the 1/255 alpha cut; the kernels must
    # add nothing to what the plain versions show
    for key, v in stats.items():
        if key.startswith("cuda"):
            ref = stats["cpu" + key[4:]]
            assert v["values_beyond_tol"] == ref["values_beyond_tol"], (key, v, ref)
            assert abs(v["max_abs_diff"] - ref["max_abs_diff"]) <= 1e-5, (key, v, ref)
            assert v["values_beyond_tol"] <= 1e-4 * v["values"], (key, v)
    return rows, errs


def weight_gib(mods) -> float:
    return sum(p.numel() * p.element_size() for m in (mods.unet, mods.vae_encoder,
                                                       mods.vae_decoder)
               for p in m.parameters()) / 2**30


def weight_sum(mods) -> float:
    """float64 sum of every UNet and VAE weight: ranks that build the same
    seeded stack hold the same number."""
    return float(sum(p.double().sum() for m in (mods.unet, mods.vae_encoder, mods.vae_decoder)
                     for p in m.parameters()))


def busy_ms(step_fn) -> float:
    """Summed spans of the kernels one `step_fn()` launches (torch.profiler):
    the device busy time of a process alone on the card; for a rank
    sharing it, spans that include the other ranks' time slices."""
    from dreamscene_tpu_torch.utils.profiling import device_busy_ms

    return device_busy_ms(step_fn, skip=("fps.", "scene.", "controlnet"))


def mesh_step(fn, rungs=None) -> dict:
    """One synchronized step, with the collectives' counters zeroed first."""
    from dreamscene_tpu_torch.parallel import collectives as X

    X.reset_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss = fn()
    torch.cuda.synchronize()
    rec = dict(ms=(time.perf_counter() - t0) * 1e3, loss=float(loss),
               collective_s=X.STATS["seconds"], collective_calls=X.STATS["calls"],
               gathered_mb=X.STATS["bytes_gathered"] / 2**20)
    if rungs is not None:
        rec["n_rungs"] = rungs()
    return rec


class DpShare:
    """Coordinate (dp_i, 0) of a dp x 1 mesh, taken in this process with no
    group: fps_step(mesh=DpShare(n, i)) computes what dp rank i of the
    mesh computes, its cameras as one batch, and the shares' losses and
    gradients sum to the mesh step's."""

    def __init__(self, n_dp: int, dp_i: int):
        self.shape, self.coords = {"dp": n_dp, "tp": 1}, {"dp": dp_i, "tp": 0}
        self.size, self.ranks, self.world_group = n_dp, list(range(n_dp)), None

    def group(self, axis):
        return None

    def ranks_of(self, axis):
        return self.ranks if axis == "dp" else [self.coords["dp"]]


def rel_l2(a, b) -> float:
    den = float(b.double().norm())
    return float((a.double() - b.double()).norm()) / den if den > 0 else float(a.abs().max())


def mesh_object_rank(rank, world, d):
    """Phase 13b on one of four ranks (dp 2 x tp 2) sharing cuda:0 over gloo:
    the explicit step the parent took alone, then ObjectTrainer's steps,
    replicated and with shard_splats."""
    from dreamscene_tpu_torch import kernels
    from dreamscene_tpu_torch.models.gaussians import num_active
    from dreamscene_tpu_torch.parallel import sharded_render as SR
    from dreamscene_tpu_torch.training.object_trainer import ObjectTrainer, fps_step

    d = Path(d)
    inp = torch.load(d / "inputs.pt", map_location="cuda:0", weights_only=False)
    cfg = slice_cfg(2, 2)
    guidance = sd21_guidance(cfg.guidanceParams, device="cuda:0", dtype=torch.float32)
    assert weight_sum(guidance.mods) == inp["weight_sum"], "ranks built other weights"
    mesh = SR.make_mesh(2, 2)
    out = {"coords": mesh.coords}

    res = fps_step(**inp["step"], mods=guidance.mods, mesh=mesh)
    torch.cuda.synchronize()
    out["parity"] = dict(loss=float(res["loss"]),
                         grads={k: v.cpu() for k, v in res["grads"].items()},
                         params={k: v.cpu() for k, v in res["params"].items()},
                         n_entries=int(res["n_entries"]), n_dropped=int(res["n_dropped"]))
    del res, guidance
    torch.cuda.empty_cache()
    guidance = sd21_guidance(cfg.guidanceParams, device="cuda:0")
    res = fps_step(**inp["step"], mods=guidance.mods, mesh=mesh)
    out["parity_bf16"] = dict(loss=float(res["loss"]),
                              grads={k: v.cpu() for k, v in res["grads"].items()})
    del res, inp

    tr = ObjectTrainer(cfg, guidance=guidance, exp_root=str(d / "replicated"), device="cuda:0")
    tr.prepare_train()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_counts()
    recs = [mesh_step(tr.train_step, lambda: tr.last_stats["n_rungs"])
            for _ in range(N_STEPS_WARM + 3)]
    counts = dict(kernels.COUNTS)
    peak = torch.cuda.max_memory_allocated() / 2**30
    busy = busy_ms(tr.train_step)
    out["steps"] = dict(recs=recs, counts=counts, peak_gib=peak, busy_ms=busy,
                        xyz=tr.state.params["xyz"].cpu())
    del tr

    cfg = slice_cfg(2, 2, shard_splats=True)
    tr = ObjectTrainer(cfg, guidance=guidance, exp_root=str(d / "shard"), device="cuda:0")
    tr.prepare_train()
    xyz0 = tr.state.params["xyz"].clone()
    torch.cuda.reset_peak_memory_stats()
    recs = [mesh_step(tr.train_step) for _ in range(3)]
    st = tr.state
    rows = {"params": st.params["xyz"].shape[0], "mu": st.opt.mu["xyz"].shape[0],
            "nu": st.opt.nu["scaling"].shape[0], "aux": st.aux["active"].shape[0],
            "global": st.global_capacity, "background": tuple(st.params["background"].shape)}
    whole = tr._whole_state(st)
    moved = float((whole.params["xyz"] - xyz0).abs().max())
    # one forced densify (test_parallel.py:254-260) at the next step
    optim = tr.optim
    optim.densify_from_iter, optim.densification_interval = 1, 4
    optim.densify_until_iter, optim.densify_grad_threshold = 10, 1e-9
    optim.opacity_reset_interval = 1 << 30
    n0 = num_active(whole)
    recs.append(mesh_step(tr.train_step))
    n1 = num_active(tr.state)
    recs.append(mesh_step(tr.train_step))           # sharded again after the densify
    out["shard"] = dict(recs=recs, rows=rows, moved=moved, n0=n0, n1=n1,
                        rows_after=tr.state.params["xyz"].shape[0],
                        peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    torch.save(out, d / f"out_{rank}.pt")


def reckon_peak(label, single_peak, weights_gib, share):
    """The per-rank peak reckoned before the ranks run: the weights whole,
    the rest of the single-process peak at the rank's share."""
    est = weights_gib + (single_peak - weights_gib) * share
    log(f"[mesh] {label}: single-process peak {single_peak:.1f} GiB, weights "
        f"{weights_gib:.1f} GiB; per-rank peak reckoned {est:.1f} GiB")
    return est


def run_mesh_objects():
    """Phase 13b: phase 3's object (config #2 width, DS_FLASH_ATTN=1) on
    four ranks, dp 2 x tp 2, sharing cuda:0 over gloo. The parent takes
    one step alone on explicit inputs and frees the card; each rank then
    takes the same step on the mesh (held against it: loss rtol 1e-3 /
    atol 1e-4, every group's gradient within relative L2 1e-3, parameters
    bit-equal on every rank), 2 + 3 ObjectTrainer steps (timed; launch
    counts), a profiled step, and with shard_splats 3 steps, a forced
    densify and one more step. The step held at 1e-3 computes the guidance
    in float32. In bf16 the step's gradient moves by ~8% (relative L2)
    under any perturbation of its inputs or batching: the one-process
    step, the dp split taken in one process (`DpShare`: each dp rank's two
    cameras as one batch, the shares summed) and the mesh are each that
    far from one another. So the mesh's bf16 step is held to that noise,
    measured in this run: per group, its gaps to the one-process bf16 step
    and to the split at most twice the split's gap to the one-process
    step, and its gap to the float32 step at most twice the larger of the
    one-process bf16 steps' gaps to it. Returns the launches of the timed
    steps, summed over the ranks."""
    from dreamscene_tpu_torch import kernels
    from dreamscene_tpu_torch.parallel.launch import run_ranks
    from dreamscene_tpu_torch.training.object_trainer import ObjectTrainer, fps_step

    d = Path(fresh_dir("mesh_objects"))
    os.environ["DS_FLASH_ATTN"] = "1"
    try:
        cfg = slice_cfg()
        guidance = sd21_guidance(cfg.guidanceParams, dtype=torch.float32)
        weights_gib = weight_gib(guidance.mods)
        tr = ObjectTrainer(cfg, guidance=guidance, exp_root=str(d / "single"), device="cuda")
        tr.prepare_train()
        inp = tr.step_inputs()
        torch.cuda.reset_peak_memory_stats()
        res = fps_step(**inp)
        single_peak = torch.cuda.max_memory_allocated() / 2**30
        ref = dict(loss=float(res["loss"]), grads={k: v.cpu() for k, v in res["grads"].items()})
        step = {k: v for k, v in inp.items() if k not in ("mods", "mesh")}
        torch.save(dict(step=step, weight_sum=weight_sum(guidance.mods)), d / "inputs.pt")
        del tr, guidance, res
        torch.cuda.empty_cache()
        # the same step in bf16, as the ranks' timed steps run it
        mods = sd21_guidance(cfg.guidanceParams).mods
        res = fps_step(**dict(inp, mods=mods))
        ref_bf16 = dict(loss=float(res["loss"]),
                        grads={k: v.cpu() for k, v in res["grads"].items()})
        del res
        # the dp split taken in this process: the batching alone
        split = [fps_step(**dict(inp, mods=mods, mesh=DpShare(2, i))) for i in range(2)]
        split_bf16 = dict(loss=sum(float(r["loss"]) for r in split),
                          grads={k: sum(r["grads"][k].cpu() for r in split)
                                 for k in ref_bf16["grads"]})
        del split
        single = mesh_step(lambda: fps_step(**dict(inp, mods=mods))["loss"])
        single["busy_ms"] = busy_ms(lambda: fps_step(**dict(inp, mods=mods)))
        del mods, inp, step
        torch.cuda.empty_cache()
        est = reckon_peak("object mesh, float32 step (b_local 2 of C_batch 4)", single_peak,
                          weights_gib, 0.5)
        t0 = time.perf_counter()
        run_ranks(mesh_object_rank, 4, (str(d),), store_dir=str(d), device="cuda:0",
                  timeout_s=MESH_TIMEOUT_S)
        wall = time.perf_counter() - t0
    finally:
        os.environ.pop("DS_FLASH_ATTN", None)
    outs = [torch.load(d / f"out_{r}.pt", weights_only=False) for r in range(4)]

    par = [o["parity"] for o in outs]
    rel = {k: max(rel_l2(p["grads"][k], g) for p in par) for k, g in ref["grads"].items()
           if k != "background"}
    log(f"[mesh] object step, dp 2 x tp 2 against the single process: loss "
        f"{[p['loss'] for p in par]} vs {ref['loss']!r}; gradient relative L2 {json.dumps(rel)}")
    for p in par:
        assert math.isclose(p["loss"], ref["loss"], rel_tol=1e-3, abs_tol=1e-4), (p["loss"], ref)
        assert all(torch.equal(p["params"][k], par[0]["params"][k]) for k in p["params"])
    assert all(v <= 1e-3 for v in rel.values()), rel
    # the same step with the guidance in bf16, as the path runs it, against
    # the one-process bf16 step (a batch of 4), the dp split in one process
    # (two batches of 2, as the ranks take them) and the float32 step
    groups = [k for k in ref_bf16["grads"] if k != "background"]
    par16 = [o["parity_bf16"] for o in outs]

    def gaps(grads, to):
        return {k: max(rel_l2(g[k], to[k]) for g in grads) for k in groups}

    bf16 = {"mesh_to_batch_of_4": gaps([p["grads"] for p in par16], ref_bf16["grads"]),
            "mesh_to_dp_split": gaps([p["grads"] for p in par16], split_bf16["grads"]),
            "dp_split_to_batch_of_4": gaps([split_bf16["grads"]], ref_bf16["grads"]),
            "mesh_to_f32": gaps([p["grads"] for p in par16], ref["grads"]),
            "batch_of_4_to_f32": gaps([ref_bf16["grads"]], ref["grads"]),
            "dp_split_to_f32": gaps([split_bf16["grads"]], ref["grads"])}
    log(f"[mesh] the same step in bf16: loss {[p['loss'] for p in par16]} vs "
        f"{ref_bf16['loss']!r} (batch of 4), {split_bf16['loss']!r} (dp split in one "
        f"process), {ref['loss']!r} (float32); gradient relative L2 {json.dumps(bf16)}")
    for k in groups:
        noise = bf16["dp_split_to_batch_of_4"][k]
        assert bf16["mesh_to_batch_of_4"][k] <= 2.0 * noise, (k, bf16)
        assert bf16["mesh_to_dp_split"][k] <= 2.0 * noise, (k, bf16)
        assert bf16["mesh_to_f32"][k] <= 2.0 * max(bf16["batch_of_4_to_f32"][k],
                                                   bf16["dp_split_to_f32"][k]), (k, bf16)
    c = 4
    b_local = 2
    for o in outs:
        s = o["steps"]
        n = len(s["recs"])
        expect = {k: b_local * n for k in K1_K3}
        expect.update(k4_expect([r["n_rungs"] for r in s["recs"]], 10, n))
        assert s["counts"] == expect, (s["counts"], expect)
        assert all(math.isfinite(r["loss"]) for r in s["recs"])
        assert torch.equal(s["xyz"], outs[0]["steps"]["xyz"])
        sh = o["shard"]
        half = sh["rows"]["global"] // 2
        assert {k: sh["rows"][k] for k in ("params", "mu", "nu", "aux")} == \
            {k: half for k in ("params", "mu", "nu", "aux")}, sh["rows"]
        assert sh["rows"]["background"] == (3,) and sh["rows_after"] == half
        assert sh["moved"] > 0 and sh["n1"] != sh["n0"], sh
        assert all(math.isfinite(r["loss"]) for r in sh["recs"])
    per_rank = []
    for r, o in enumerate(outs):
        timed = o["steps"]["recs"][N_STEPS_WARM:]
        per_rank.append({
            "rank": r, "coords": o["coords"],
            "step_ms": [x["ms"] for x in timed],
            "step_ms_median": float(np.median([x["ms"] for x in timed])),
            "collective_s_per_step": float(np.mean([x["collective_s"] for x in timed])),
            "collective_calls_per_step": float(np.mean([x["collective_calls"] for x in timed])),
            "gathered_mb_per_step": float(np.mean([x["gathered_mb"] for x in timed])),
            "kernel_span_ms_time_sliced": o["steps"]["busy_ms"],
            "peak_gib": o["steps"]["peak_gib"],
            "shard_step_ms": [x["ms"] for x in o["shard"]["recs"]],
            "shard_gathered_mb_per_step": float(np.mean(
                [x["gathered_mb"] for x in o["shard"]["recs"]])),
            "shard_collective_s_per_step": float(np.mean(
                [x["collective_s"] for x in o["shard"]["recs"]])),
            "shard_peak_gib": o["shard"]["peak_gib"]})
    counts = {k: sum(o["steps"]["counts"][k] for o in outs) for k in kernels.KERNEL_NAMES}
    log(json.dumps({"mesh_object_steps": {
        "label": LABEL, "ranks": per_rank, "ranks_wall_s": wall,
        "single_process": {"step_ms": single["ms"], "device_busy_ms": single["busy_ms"]},
        "single_process_peak_gib_f32": single_peak, "peak_reckoned_gib_f32": est,
        "densify": {"before": outs[0]["shard"]["n0"], "after": outs[0]["shard"]["n1"]},
        "launches_summed": counts, "gradient_rel_l2": rel,
        "bf16_gradient_rel_l2": bf16}}))
    return counts


def mesh_scene_cfg(dp=1, tp=1):
    from dreamscene_tpu_torch.utils.config import load_config

    cfg = load_config(str(SCENE_CFG), ["log.exp_name=scene"])
    cfg.parallelParams.dp, cfg.parallelParams.tp = dp, tp
    cfg.parallelParams.shard_splats = dp * tp > 1
    return cfg


def mesh_scene_trainer(root, dp, tp, device):
    """Phase 6's scene (config #4) from the object PLYs under `root`, with
    the guidance in float32, and the inputs of one stage-1 step."""
    from dreamscene_tpu_torch.training.scene_trainer import SceneTrainer

    cfg = mesh_scene_cfg(dp, tp)
    tr = SceneTrainer(cfg, guidance=sd21_guidance(cfg.guidanceParams, device=device,
                                                  dtype=torch.float32),
                      exp_root=str(root), device=device, env_density=1.0)
    for obj_cfg in tr.scene_objects:
        tr.object_task(obj_cfg)
    tr.prepare_train_scene()
    tr.step, tr.iters = 1, cfg.sceneOptimizationParams.iterations
    c = tr.guidance_opt.C_batch_size
    cams = tr._stage1_cams(4 * c)
    inp = tr.step_inputs(cams[:c], "env", False, False, 1.0 / tr.iters)
    return tr, cams, inp


def mesh_scene_rank(rank, world, d):
    """Phase 13c on one of two ranks (dp 1 x tp 2, shard_splats) sharing
    cuda:0 over gloo: the stage-1 step the parent took alone, then two
    stage-1 steps and one stage-3 recon step (one camera on two bands)."""
    from dreamscene_tpu_torch import kernels
    from dreamscene_tpu_torch.parallel import collectives as X
    from dreamscene_tpu_torch.training.scene_trainer import scene_step

    d = Path(d)
    ref = torch.load(d / "fingerprint.pt", weights_only=False)
    tr, cams, inp = mesh_scene_trainer(d / "mesh", 1, 2, "cuda:0")
    assert weight_sum(tr.guidance.mods) == ref["weight_sum"]
    assert float(inp["args"]["noise"].double().sum()) == ref["noise_sum"]
    args = inp["args"]
    out = {"rows": {n: (s.capacity, s.global_capacity)
                    for n, s in zip(inp["names"] + ["floor", "env"], args["states"])},
           "total_rows": sum(s.global_capacity or s.capacity for s in args["states"])}
    res = scene_step(**args)
    env = args["states"][-1]
    grads = {k: (X.all_gather_cat(v, tr.mesh.group("tp")) if env.global_capacity else v).cpu()
             for k, v in res["grads"][-1].items()}
    out["parity"] = dict(loss=float(res["loss"]), env_grads=grads)
    del res, args, inp
    # the timed steps compute the guidance in bf16, as the path does
    tr.guidance = None
    torch.cuda.empty_cache()
    tr.guidance = sd21_guidance(tr.guidance_opt, device="cuda:0")
    c = tr.guidance_opt.C_batch_size
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_counts()
    tr.step = 0
    recs = [mesh_step(lambda i=i: tr.scene_train_step(cams[(i + 1) * c:(i + 2) * c], "env"),
                      lambda: tr.last_stats["n_rungs"]) for i in range(2)]
    gt = torch.rand((3, 512, 512), device="cuda:0",
                    generator=torch.Generator(device="cuda:0").manual_seed(3))
    recs.append(mesh_step(lambda: tr._run_scene_step(
        cams[:1], "all", False, True, 1.0, guidance_on=False, gt_images=[gt],
        optp=tr.cfg.reconSceneOptimizationParams)))
    out["steps"] = dict(recs=recs, counts=dict(kernels.COUNTS),
                        peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                        flat=None if tr._flat_mesh is None else dict(tr._flat_mesh.shape))
    out["busy_ms"] = busy_ms(lambda: tr.scene_train_step(cams[:c], "env"))
    torch.save(out, d / f"out_{rank}.pt")


def run_mesh_scene():
    """Phase 13c: config #4 (phase 6's scene, DS_FLASH_ATTN=1) on two ranks,
    dp 1 x tp 2 with shard_splats, sharing cuda:0 over gloo. The parent
    takes one stage-1 step alone and frees the card; each rank takes the
    same step (held against it: loss rtol 1e-3, the env's gradient within
    relative L2 1e-3 per group; the guidance in float32 for it, as in
    phase 13b), two stage-1 steps and a stage-3 recon step (bf16; timed,
    launch counts), and a profiled stage-1 step. Returns the launches of
    those three steps, summed over the ranks."""
    from dreamscene_tpu_torch import kernels
    from dreamscene_tpu_torch.parallel.launch import run_ranks
    from dreamscene_tpu_torch.training.scene_trainer import SceneTrainer, scene_step

    d = Path(fresh_dir("mesh_scene"))
    os.environ["DS_FLASH_ATTN"] = "1"
    try:
        writer = SceneTrainer(mesh_scene_cfg(), exp_root=str(d / "single"), device="cuda",
                              guidance=None, env_density=1.0)
        write_scene_objects(writer)
        (d / "mesh" / "scene" / "checkpoints").mkdir(parents=True)
        for f in writer.ckpt_path.glob("*_final_model.ply"):
            shutil.copy(f, d / "mesh" / "scene" / "checkpoints" / f.name)
        del writer
        tr, cams, inp = mesh_scene_trainer(d / "single", 1, 1, "cuda")
        weights_gib = weight_gib(tr.guidance.mods)
        torch.cuda.reset_peak_memory_stats()
        res = scene_step(**inp["args"])
        single_peak = torch.cuda.max_memory_allocated() / 2**30
        ref = dict(loss=float(res["loss"]), env_grads={k: v.cpu()
                                                       for k, v in res["grads"][-1].items()})
        torch.save(dict(weight_sum=weight_sum(tr.guidance.mods),
                        noise_sum=float(inp["args"]["noise"].double().sum())),
                   d / "fingerprint.pt")
        tr.guidance = res = None
        torch.cuda.empty_cache()
        # the same step in bf16, as the ranks' timed steps run it
        args = dict(inp["args"], mods=sd21_guidance(tr.guidance_opt).mods)
        scene_step(**args)                              # warm-up
        single = mesh_step(lambda: scene_step(**args)["loss"])
        single["busy_ms"] = busy_ms(lambda: scene_step(**args))
        del tr, cams, inp, args
        torch.cuda.empty_cache()
        est = reckon_peak("scene mesh, float32 step (tp 2, state and band tables halved)",
                          single_peak, weights_gib, 0.5)
        t0 = time.perf_counter()
        run_ranks(mesh_scene_rank, 2, (str(d),), store_dir=str(d), device="cuda:0",
                  timeout_s=MESH_TIMEOUT_S)
        wall = time.perf_counter() - t0
    finally:
        os.environ.pop("DS_FLASH_ATTN", None)
    outs = [torch.load(d / f"out_{r}.pt", weights_only=False) for r in range(2)]
    rel = {k: max(rel_l2(o["parity"]["env_grads"][k], g) for o in outs)
           for k, g in ref["env_grads"].items() if k != "background"}
    log(f"[mesh] scene stage-1 step, tp 2 shard_splats against the single process: loss "
        f"{[o['parity']['loss'] for o in outs]} vs {ref['loss']!r}; env gradient relative L2 "
        f"{json.dumps(rel)}")
    for o in outs:
        assert math.isclose(o["parity"]["loss"], ref["loss"], rel_tol=1e-3), (o["parity"], ref)
        assert all(math.isfinite(r["loss"]) for r in o["steps"]["recs"])
        # every model whose capacity divides keeps half its rows on each rank
        assert all(cap is None or 2 * rows == cap for rows, cap in o["rows"].values()), o["rows"]
    assert all(v <= 1e-3 for v in rel.values()), rel
    c = 4
    for o in outs:
        recs = o["steps"]["recs"]
        expect = {k: 2 * c + 1 for k in K1_K3}
        expect.update(k4_expect([r["n_rungs"] for r in recs[:2]], 10, 2))
        assert o["steps"]["counts"] == expect, (o["steps"]["counts"], expect)
    per_rank = [{"rank": r, "rows": o["rows"], "step_ms": [x["ms"] for x in o["steps"]["recs"]],
                 "collective_s": [x["collective_s"] for x in o["steps"]["recs"]],
                 "gathered_mb": [x["gathered_mb"] for x in o["steps"]["recs"]],
                 "kernel_span_ms_time_sliced": o["busy_ms"], "peak_gib": o["steps"]["peak_gib"]}
                for r, o in enumerate(outs)]
    counts = {k: sum(o["steps"]["counts"][k] for o in outs) for k in kernels.KERNEL_NAMES}
    log(json.dumps({"mesh_scene_steps": {
        "label": LABEL, "ranks": per_rank, "ranks_wall_s": wall,
        "total_rows": outs[0]["total_rows"], "pad_rows": outs[0]["total_rows"] % 2,
        "single_process": {"step_ms": single["ms"], "device_busy_ms": single["busy_ms"]},
        "single_process_peak_gib_f32": single_peak, "peak_reckoned_gib_f32": est,
        "launches_summed": counts, "env_gradient_rel_l2": rel}}))
    return counts


# ------------------------------------------------------------------- phase 14
SINGLE_CAM_TILES = ((32, 16), (16, 16))


def run_single_cam(tr):
    """Phase 14b: config #4's scene (phase 6's trainer) seen by
    load_single_cam at 1920x1080 from the scene box's centre towards the
    first object's placement: the frame rendered forward + backward through
    scene_render at an entry capacity the capacity controller sizes (launch
    counts checked), then K1-K3 held against their plain versions and
    timed at 32x16 and 16x16 tiles (chunk 512, the order kernel's time
    among K1's), and the live tiles of the partial last tile row (1080 =
    67 x 16 + 8). Returns (launch counts of the render, rows by tiling,
    errors)."""
    from dreamscene_tpu_torch import kernels
    from dreamscene_tpu_torch.bench.scenes import binned_inputs
    from dreamscene_tpu_torch.cameras.sampling import load_single_cam
    from dreamscene_tpu_torch.models.scene import final_combine_all
    from dreamscene_tpu_torch.rendering import scene_render
    from dreamscene_tpu_torch.training.capacity import CapacityController

    box = tr.scene.scene_box
    centre = (box[:3].astype(np.float64) + box[3:]) / 2
    target = np.asarray(tr.scene.objects_args[0].affine["T"], np.float64)
    cam = load_single_cam(tr.scene_pose_args, camera_center=tuple(centre),
                          object_center=tuple(target))
    sts = tr._states(list(tr.scene.objects))
    cap_base = sum(st.capacity for st in sts) // 2
    ctrl = CapacityController(mult=4, min_mult=2, max_mult=16)    # the scene trainer's

    def render():
        env = sts[-1]
        xyz = env.params["xyz"].detach().requires_grad_(True)
        states = sts[:-1] + [dataclasses.replace(env, params=dict(env.params, xyz=xyz))]
        out = scene_render(states, cam, bg_color=(0.0, 0.0, 0.0), test=True,
                           capacity=ctrl.capacity(cap_base))
        (out["image"].mean() + 0.1 * out["depth"].mean()).backward()
        return out, xyz.grad

    sizing = []
    while True:       # grow until nothing drops, as the controller does over steps
        out, grad = render()
        n_entries, n_dropped = int(out["n_entries"]), int(out["n_dropped"])
        sizing.append({"capacity": ctrl.capacity(cap_base), "n_entries": n_entries,
                       "n_dropped": n_dropped})
        if not ctrl.update(cap_base, n_entries, n_dropped):
            break
    capacity = ctrl.capacity(cap_base)
    torch.cuda.synchronize()
    kernels.reset_counts()
    t0 = time.perf_counter()
    out, grad = render()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    counts = dict(kernels.COUNTS)
    assert all(counts[k] == 1 for k in K1_K3), counts
    assert tuple(out["image"].shape) == (3, 1080, 1920) and torch.isfinite(out["image"]).all()
    assert torch.isfinite(grad).all() and float(grad.abs().max()) > 0
    log(json.dumps({"single_cam_render": {
        "camera_center": centre.tolist(), "object_center": target.tolist(),
        "delta_azimuth": cam.delta_azimuth, "fovx": cam.fovx, "fovy": cam.fovy,
        "capacity_sizing": sizing, "ms_fwd_bwd": ms, "launches": counts}}))

    combined = final_combine_all(sts)
    sh = min(st.active_sh_degree for st in sts)
    rows, errs = {}, {k: 0.0 for k in K1_K3}
    for tw, th in SINGLE_CAM_TILES:
        inp = binned_inputs(combined, cam, tw, th, capacity=capacity, sh_degree=sh)
        b = inp["binned"]
        label = f"config #4 single cam 1920x1080 {tw}x{th}"
        e, r = check_kernels(label, inp, timing=True)
        errs = {k: max(errs[k], e[k]) for k in K1_K3}
        # live entries of each tile of the partial last tile row
        ct, _, lo, hi, _, n_used = inp["meta"]
        n_u, n_tiles, tiles_x = int(n_used), inp["n_tiles"], inp["tiles_x"]
        live = torch.zeros(n_tiles + 1, dtype=torch.long, device=ct.device)
        live.index_add_(0, ct[:n_u].long(), (hi[:n_u] - lo[:n_u]).clamp_min(0).long())
        last = live[n_tiles - tiles_x:n_tiles]
        summary = {"tiles": n_tiles, "tiles_y": n_tiles // tiles_x, "capacity": capacity,
                   "n_entries": int(b.n_entries), "n_dropped": int(b.n_dropped),
                   "last_row_pixel_rows": 1080 - (n_tiles // tiles_x - 1) * th,
                   "last_row_live_tiles": int((last > 0).sum()), "last_row_tiles": tiles_x,
                   "last_row_entries": int(last.sum()),
                   "k1_ms": r["composite_fwd"]["ms"],
                   **{k: r["composite_fwd"][k] for k in K1_ORDER_KEYS}}
        log(f"[kernels] {label}: " + json.dumps(summary))
        assert summary["last_row_live_tiles"] > 0, summary
        rows[f"{tw}x{th}"] = r
        del inp
    return counts, rows, errs


def run_denoise(guidance):
    """Phase 14c: mtsd.denoise_ladder at full width on phase 3's
    SD2.1-architecture stack (bf16, seeded weights): 64x64 latents, batch
    1, 3 rungs, DS_FLASH_ATTN=1; K4 forward launches checked (10 per UNet
    pass, every one the tensor-core variant), the walk timed; K4 held
    against its plain versions at the walk's shapes; then the tiny stack's
    walk, card against CPU in float32 (atol 1e-4). Returns (launch counts
    of the timed walk, the K4 rows by label)."""
    from dreamscene_tpu_torch import kernels
    from dreamscene_tpu_torch.guidance import mtsd
    from dreamscene_tpu_torch.utils.config import GuidanceParams

    g = torch.Generator(device="cuda").manual_seed(14)
    lat = torch.randn((1, 64, 64, 4), device="cuda", generator=g)
    noise = torch.randn((1, 64, 64, 4), device="cuda", generator=g)
    emb = guidance.get_text_embeds(["a ceramic vase", "blurry", "a photo"])
    ts = [700, 480, 230]

    def walk():
        return mtsd.denoise_ladder(guidance.mods, lat, noise, ts, emb, n_rungs=len(ts), cfg=7.5)

    os.environ["DS_FLASH_ATTN"] = "1"
    try:
        walk()
        torch.cuda.synchronize()
        kernels.reset_counts()
        t0 = time.perf_counter()
        scores = walk()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        counts = dict(kernels.COUNTS)
    finally:
        os.environ.pop("DS_FLASH_ATTN", None)
    n_fwd = 10 * len(ts)
    expect = {k: 0 for k in kernels.KERNEL_NAMES + kernels.VARIANT_NAMES}
    expect.update({"flash_fwd": n_fwd, "flash_fwd.tc": n_fwd})
    assert counts == expect, (counts, expect)
    final = scores[-1][2]
    assert tuple(final.shape) == (1, 64, 64, 4) and torch.isfinite(final.float()).all()
    assert float((final.float() - scores[0][2].float()).abs().max()) > 1e-2
    log(json.dumps({"denoise_walk": {"ms": ms, "rungs": ts, "cfg": 7.5, "launches": counts}}))

    k4 = {label: check_flash(label, shape, torch.bfloat16)
          for label, shape in (("denoise walk unet 64x64 self-attn", (3, 5, 4096, 64)),
                               ("denoise walk unet 32x32 self-attn", (3, 10, 1024, 64)))}

    # the tiny stack's walk, card against CPU, float32, with a depth hint
    tiny = mtsd.make_tiny_guidance(GuidanceParams(), with_controlnet=True, device="cpu")
    fill_zero_convs(tiny.mods.controlnet, torch.Generator().manual_seed(10), 0.2)
    rng = np.random.RandomState(14)
    args = [torch.from_numpy(rng.randn(*s).astype(np.float32))
            for s in ((2, 8, 8, 4), (2, 8, 8, 4), (6, 4, 32))]
    hint = torch.from_numpy(rng.rand(2, 16, 16, 3).astype(np.float32))
    ref = mtsd.denoise_ladder(tiny.mods, *args[:2], ts, args[2], n_rungs=3, cfg=7.5,
                              cond_image=hint)
    got = mtsd.denoise_ladder(_to(tiny.mods, torch.device("cuda")),
                              *[a.cuda() for a in args[:2]], ts, args[2].cuda(), n_rungs=3,
                              cfg=7.5, cond_image=hint.cuda())
    err = max(float((b.cpu() - a).abs().max())
              for (_, ra, la), (_, ga, lg) in zip(ref, got)
              for a, b in zip(ra + (la,), ga + (lg,)))
    log(f"[denoise] tiny walk (3 rungs, depth hint) card against CPU, float32: "
        f"max|d| {err:.3g} (atol 1e-4)")
    assert err <= 1e-4, err
    return counts, k4


def run_trace(tr):
    """Phase 14d: one gate-set FPS step of phase 3's trainer inside
    utils/profiling.trace; the Chrome trace it writes must name every K1-K4
    kernel symbol the step launches. Returns the step's launch counts."""
    from dreamscene_tpu_torch import kernels
    from dreamscene_tpu_torch.utils import profiling

    d = fresh_dir("trace")
    os.environ["DS_FLASH_ATTN"] = "1"
    try:
        kernels.reset_counts()
        with profiling.trace(d):
            loss = tr.train_step()
            torch.cuda.synchronize()
        counts = dict(kernels.COUNTS)
    finally:
        os.environ.pop("DS_FLASH_ATTN", None)
    assert math.isfinite(loss)
    (path,) = glob.glob(os.path.join(d, "*.json"))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name", "") for e in events if e.get("cat") == "kernel"}
    symbols = ("expand_kernel", "tile_order_kernel", "composite_fwd_kernel",
               "composite_bwd_kernel", "flash_fwd_wgmma_kernel", "flash_bwd_dkv_tc_kernel",
               "flash_bwd_dq_tc_kernel")
    found = {s: sum(s in n for n in names) for s in symbols}
    log(json.dumps({"trace": {"file_mb": os.path.getsize(path) / 2**20,
                              "kernel_names": len(names), "symbols": found,
                              "launches": counts}}))
    assert all(found.values()), found
    assert all(counts[k] > 0 for k in kernels.KERNEL_NAMES), counts
    shutil.rmtree(d)
    return counts


def run_knn_init(build_s):
    """Phase 14a: the KNN library (csrc/host/knn.cpp, built with g++ on this
    machine at the start of the run) and the time create_from_points takes
    on phase 2's 50K-point ball, its log-scales checked against the
    distances."""
    from dreamscene_tpu_torch.models import gaussians as G
    from dreamscene_tpu_torch.models.init import init_object_points

    pts, cols, sls = init_object_points("default", "", fresh_dir("init"), num_pts=50_000,
                                        seed=50_000)
    t0 = time.perf_counter()
    dist = G.mean_sq_dist_to_3nn(pts)
    knn_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st = G.create_from_points(pts, cols, sh_degree=2, capacity=60_000, spatial_lr_scale=sls,
                              device="cuda")
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    want = np.log(np.sqrt(np.maximum(dist, 1e-7))).astype(np.float32)
    assert np.array_equal(st.params["scaling"][:50_000, 0].cpu().numpy(), want)
    log(json.dumps({"init_knn": {"library": G.knn_library_path().name, "build_s": build_s,
                                 "flags": G.KNN_FLAGS, "n_points": 50_000,
                                 "mean_sq_dist_ms": knn_ms, "create_from_points_ms": ms,
                                 "host_cpus": os.cpu_count()}}))


def run_losses():
    """Phase 14e: l1_loss and ssim (both reductions) on a seeded
    [4,3,512,512] pair, card against CPU (atol 1e-5), and their card times."""
    from dreamscene_tpu_torch.ops import losses as L

    rng = np.random.RandomState(15)
    a = torch.from_numpy(rng.rand(4, 3, 512, 512).astype(np.float32))
    b = (a + 0.1 * torch.from_numpy(rng.randn(4, 3, 512, 512).astype(np.float32))).clamp(0, 1)
    ac, bc = a.cuda(), b.cuda()
    fns = {"l1_loss": L.l1_loss, "ssim": L.ssim,
           "ssim per image": functools.partial(L.ssim, size_average=False)}
    errs, times = {}, {}
    for name, fn in fns.items():
        ref, got = fn(a, b), fn(ac, bc)
        errs[name] = float((got.cpu() - ref).abs().max())
        times[name] = cuda_time(lambda: fn(ac, bc), 10)
    log(json.dumps({"losses": {"shape": [4, 3, 512, 512], "max_abs_err": errs,
                               "card_ms": times}}))
    assert all(e <= 1e-5 for e in errs.values()), errs


# ------------------------------------------------------------ phases 16-18
LARGE_VIEWS = ((3840, 2160), (2560, 2560))
# the most tiles whose (n + 1) x 12-byte order table fits one CTA's 232,448
# bytes of shared memory: phase 16's views lie past it
ONE_CTA_ORDER_TILES = 19_369
SOAK_OBJECT_CUT = dict(iters=360, recon_iters=2)
SOAK_SCENE_CUT = dict(stage1=280, obj_iters=20)


def run_large_views():
    """Phase 16: phase 2's 50K-splat scene (make_scene) seen at 3840x2160
    and 2560x2560 with 16x16 tiles, at an entry capacity of the view's raw
    entries times the capacity controller's pad (no drops):
    K1-K3 held against their plain versions and timed; then one render
    forward + backward at 3840x2160, 16x16 (launches checked, image and
    xyz gradient finite). Returns (launch counts of the render, rows by
    view, errors)."""
    from dreamscene_tpu_torch import kernels
    from dreamscene_tpu_torch.bench.scenes import binned_inputs
    from dreamscene_tpu_torch.bench.throughput import camera_tensors
    from dreamscene_tpu_torch.ops.rasterizer import render
    from dreamscene_tpu_torch.training.capacity import CapacityController

    rows, errs, counts = {}, {k: 0.0 for k in K1_K3}, None
    for w, h in LARGE_VIEWS:
        st, cam = make_scene(50_000, w, h, seed=50_000)
        probe = binned_inputs(st, cam, 16, 16, capacity=CapacityController.HARD_CAP)
        raw = int(probe["binned"].n_entries) + int(probe["binned"].n_dropped)
        del probe
        # raw x the controller's pad, above its 16x cap at this view
        capacity = min(-(-int(raw * CapacityController.pad) // 1024) * 1024,
                       CapacityController.HARD_CAP)
        inp = binned_inputs(st, cam, 16, 16, capacity=capacity)
        label = f"50K object {w}x{h} 16x16"
        assert inp["n_tiles"] > ONE_CTA_ORDER_TILES, (label, inp["n_tiles"])
        assert int(inp["binned"].n_dropped) == 0, label
        e, r = check_kernels(label, inp, timing=True)
        errs = {k: max(errs[k], e[k]) for k in K1_K3}
        log(f"[kernels] {label}: " + json.dumps({
            "tiles": inp["n_tiles"], "raw_entries": raw, "capacity": capacity,
            "n_entries": int(inp["binned"].n_entries),
            "k1_ms": r["composite_fwd"]["ms"],
            **{k: r["composite_fwd"][k] for k in K1_ORDER_KEYS}}))
        rows[f"{w}x{h}"] = r
        del inp
        if (w, h) != LARGE_VIEWS[0]:
            continue

        def fwd_bwd():
            xyz = st.get_xyz.detach().requires_grad_(True)
            out = render(xyz, st.get_scaling, st.get_rotation, st.get_opacity[:, 0],
                         st.get_features, **camera_tensors(cam, "cuda"),
                         bg=torch.zeros(3, device="cuda"), sh_degree=2, capacity=capacity,
                         valid_mask=st.aux["active"], tile_w=16, tile_h=16)
            (out["image"].mean() + 0.1 * out["depth"].mean()).backward()
            return out, xyz.grad

        fwd_bwd()
        torch.cuda.synchronize()
        kernels.reset_counts()
        t0 = time.perf_counter()
        out, grad = fwd_bwd()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        counts = dict(kernels.COUNTS)
        assert all(counts[k] == 1 for k in K1_K3), counts
        assert tuple(out["image"].shape) == (3, h, w) and torch.isfinite(out["image"]).all()
        assert int(out["n_dropped"]) == 0
        assert torch.isfinite(grad).all() and float(grad.abs().max()) > 0
        log(json.dumps({"large_view_render": {
            "view": [w, h], "tile": [16, 16], "capacity": capacity,
            "n_entries": int(out["n_entries"]), "ms_fwd_bwd": ms, "launches": counts}}))
    return counts, rows, errs


def run_bench():
    """Phase 17: K1-K3 at bench/throughput.py's scene, view and headline
    capacity against their plain versions, then its main() (the JSON line).
    Returns (its launch counts, kernel rows, errors, its result)."""
    from dreamscene_tpu_torch import kernels
    from dreamscene_tpu_torch.bench import throughput as B
    from dreamscene_tpu_torch.bench.scenes import binned_splats
    from dreamscene_tpu_torch.ops.binning import DEFAULT_TILE_H, DEFAULT_TILE_W

    params = {k: torch.as_tensor(v, device="cuda")
              for k, v in B.build_scene(B.N_GAUSSIANS).items()}
    cam = B.camera()
    cap, raw = B.tracked_capacity(params, B.camera_tensors(cam, "cuda"))
    inp = binned_splats(*(params[k] for k in B.PARAMS), cam, DEFAULT_TILE_W, DEFAULT_TILE_H,
                        chunk=B.CHUNK, sh_degree=B.SH_DEGREE, capacity=cap)
    assert int(inp["binned"].n_dropped) == 0
    label = f"bench 300K 512^2 {DEFAULT_TILE_W}x{DEFAULT_TILE_H}"
    errs, rows = check_kernels(label, inp, timing=True)
    del inp, params
    torch.cuda.empty_cache()
    kernels.reset_counts()
    result = B.main()
    counts = dict(kernels.COUNTS)
    assert result["entries_dropped"] == 0, result
    assert (result["capacity"], result["raw_entries"]) == (cap, raw), (result, cap, raw)
    # the probe forward, then warm-up + ITERS + the profiled step, twice
    # with the companion; K2 runs in the backward only
    legs = 2 if "cap4_pixels_per_s" in result else 1
    fwd = 1 + (1 + B.ITERS) * legs + 1
    assert (counts["expand_entries"], counts["composite_fwd"], counts["composite_bwd"]) == \
        (fwd, fwd, fwd - 1), counts
    return counts, rows, errs, result


def run_soaks():
    """Phase 18: the two soak twins at cut lengths (SOAK_OBJECT_CUT,
    SOAK_SCENE_CUT), each in a fresh directory under build/; their JSON
    lines printed and held to what their configs imply. Returns their
    launch counts."""
    from dreamscene_tpu_torch import kernels
    from dreamscene_tpu_torch.bench import soak_object, soak_scene

    by_path = {}
    kernels.reset_counts()
    obj = soak_object.run(soak_object.build_cfg(**SOAK_OBJECT_CUT),
                          exp_root=fresh_dir("soak_object"))
    by_path["object_soak"] = dict(kernels.COUNTS)
    log(json.dumps({"soak_object_cut": obj}))
    iters = SOAK_OBJECT_CUT["iters"]
    assert obj["event_steps"]["densify"] == list(range(100, iters, 100)), obj["event_steps"]
    assert obj["event_steps"]["opacity_reset"] == list(range(300, iters, 300)), \
        obj["event_steps"]
    assert obj["steps_reported"] == iters and obj["recon_steps"] > 0
    assert obj["n_splats_final"] > 0 and all(np.isfinite(obj["xyz_extent"]))
    assert len(obj["videos"]) == 2, obj["videos"]

    kernels.reset_counts()
    scene = soak_scene.run(soak_scene.build_cfg(**SOAK_SCENE_CUT), n_stage3=1,
                           exp_root=fresh_dir("soak_scene"))
    by_path["scene_soak"] = dict(kernels.COUNTS)
    log(json.dumps({"soak_scene_cut": scene}))
    stage1 = SOAK_SCENE_CUT["stage1"]
    stage1_densify = [e for e in scene["event_steps"]["densify"] if str(e).startswith("stage1")]
    assert stage1_densify == [f"stage1:{s}" for s in range(100, stage1, 100)], scene["event_steps"]
    assert scene["resume_stage_n"] == 3 and scene["resume_scene_steps"] == 0, scene
    assert scene["ckpts"] == ["scene_1_stage.ckpt.npz", "scene_2_stage.ckpt.npz",
                              "scene_3_stage.ckpt.npz", "scene_final_model.ply"], scene["ckpts"]
    assert scene["n_combined"] > 0
    for path, c in by_path.items():
        assert all(c[k] > 0 for k in K1_K3), (path, c)
    return by_path


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from dreamscene_tpu_torch import kernels
    from dreamscene_tpu_torch.bench.scenes import binned_inputs
    from dreamscene_tpu_torch.bench.throughput import smi_line
    from dreamscene_tpu_torch.models.gaussians import KNN_FLAGS, build_knn

    log(smi_line())
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, cuda {torch.version.cuda}")
    t_build = kernels.build(force=True, verbose=True)
    kernels.lib()
    log(f"[build] kernels built in {t_build:.1f}s")
    t_knn = build_knn(force=True)
    log(f"[build] KNN library (csrc/host/knn.cpp, g++ {' '.join(KNN_FLAGS)}) built in "
        f"{t_knn:.2f}s")

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
    del st, inp
    mark("phase 2")
    by_path = {}
    by_path["large_view_render"], large_rows, e = run_large_views()
    errs.update({k: max(errs[k], v) for k, v in e.items()})
    mark("phase 16")
    by_path["bench_throughput"], bench_rows, e, _ = run_bench()
    errs.update({k: max(errs[k], v) for k, v in e.items()})
    torch.cuda.empty_cache()
    mark("phase 17")
    by_path.update(run_soaks())
    torch.cuda.empty_cache()
    mark("phase 18")
    for k in K4:
        r = k4[K4_ROW[k]]
        rows[k] = dict(ms=r["ms"][k], variant=r["variant"][k], plain_ms=r["plain_ms"][k],
                       library_ms=r["library_ms"][k],
                       bound_ms=r["bound"][k][0], bound_by=r["bound"][k][1])

    by_path["object_steps"], tr = run_slice()
    mark("phase 3")
    by_path["controlnet_steps"], cn = run_controlnet_steps(tr)
    mark("phase 9")
    by_path["traced_fps_step"] = run_trace(tr)
    by_path["denoise_walk"], k4_walk = run_denoise(tr.guidance)
    for label, r in k4_walk.items():
        k4[label] = r
        errs.update({k: max(errs[k], v) for k, v in r["errs"].items()})
    del tr
    torch.cuda.empty_cache()
    mark("phases 14c-14d")
    by_path["object_train"] = run_train()
    mark("phases 3b and 12")
    small_step_parity()
    small_step_parity(controlnet=True)
    mark("phases 4 and 10")
    by_path["composition_render"], comp_rows, e = run_composition()
    errs.update({k: max(errs[k], v) for k, v in e.items()})
    mark("phase 5")
    tr, gates, scene_rows, scene_band_rows, e = run_scene_steps(cn)
    errs.update({k: max(errs[k], v) for k, v in e.items()})
    by_path["scene_steps"] = {k: gates["unset"][k] + gates["set"][k] for k in kernels.KERNEL_NAMES}
    by_path["controlnet_scene_steps"] = {k: gates["controlnet"][k] for k in kernels.KERNEL_NAMES}
    mark("phases 6 and 9b")
    by_path["single_cam_render"], single_rows, e = run_single_cam(tr)
    errs.update({k: max(errs[k], v) for k, v in e.items()})
    mark("phase 14b")
    guidance, exp_root = tr.guidance, str(tr.exp_path.parent)
    del tr, cn
    torch.cuda.empty_cache()
    by_path["scene_train"] = run_scene_train(guidance, exp_root)
    mark("phase 7")
    small_scene_parity()
    mark("phase 8")
    # phase 15: config #5 on phase 6's guidance stack
    tr, by_path["outdoor_steps"], outdoor_rows, e = run_outdoor_steps(guidance)
    errs.update({k: max(errs[k], v) for k, v in e.items()})
    exp_root = str(tr.exp_path.parent)
    del tr
    torch.cuda.empty_cache()
    mark("phases 15a-15c")
    tr, by_path["outdoor_train"] = run_outdoor_train(guidance, exp_root)
    del guidance
    torch.cuda.empty_cache()
    mark("phase 15d")
    run_outdoor_cli(tr)
    del tr
    torch.cuda.empty_cache()
    mark("phase 15e")
    small_scene_parity(outdoor=True)
    mark("phase 15f")
    run_loader()
    mark("phase 11")
    band_rows, e = run_band_kernels()
    errs.update({k: max(errs[k], v) for k, v in e.items()})
    mark("phase 13a")
    by_path["mesh_object_steps"] = run_mesh_objects()
    mark("phase 13b")
    by_path["mesh_scene_steps"] = run_mesh_scene()
    mark("phase 13c")
    run_knn_init(t_knn)
    run_losses()
    mark("phases 14a and 14e")

    table = []
    for k in kernels.KERNEL_NAMES:
        src, rep = SOURCES[k]
        r = rows[k]
        launches = {path: c.get(k, 0) for path, c in by_path.items()}
        scenes = {}
        if k in K1_K3:
            scenes = {lab: {kk: rr[k][kk] for kk in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                       *K1_ORDER_KEYS) if kk in rr[k]}
                      for lab, rr in (("config #3 5x60K 800^2", comp_rows),
                                      ("config #4 scene 512^2", scene_rows),
                                      ("mesh band 512x256 from row 256, chunk 256", band_rows),
                                      ("config #4 mesh band 512x256 from row 256, chunk 256",
                                       scene_band_rows),
                                      ("config #4 single cam 1920x1080 32x16",
                                       single_rows["32x16"]),
                                      ("config #4 single cam 1920x1080 16x16",
                                       single_rows["16x16"]),
                                      *outdoor_rows.items(),
                                      *((f"50K object {v} 16x16", rr)
                                        for v, rr in large_rows.items()),
                                      ("bench 300K 512^2", bench_rows))}
        table.append({"name": k, "route": "cuda", "variant": r.get("variant", "scalar"),
                      "source": src, "replaces": rep,
                      "launches": sum(launches.values()), "launches_by_path": launches,
                      "max_abs_err": errs[k], "ms": r["ms"],
                      "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                      "bound_by": r["bound_by"], "library_ms": r.get("library_ms"),
                      **({"scene_shapes": scenes} if scenes else {}),
                      **{kk: r[kk] for kk in ("launch_host_ms", "call_host_ms",
                                              *K1_ORDER_KEYS) if kk in r}})
    log(json.dumps({"k4_shapes": {lab: {kk: v for kk, v in r.items() if kk != "bound"}
                                  for lab, r in k4.items()}}))
    log(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
