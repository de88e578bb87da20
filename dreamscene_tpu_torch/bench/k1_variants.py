"""What sets K1's time: the one-CTA-per-tile form beside the
one-warp-per-32-pixels form of csrc/composite_fwd.cu, on seeded scenes
(bench/scenes.py; the full-width one and the 16x16-tile one of chip_smoke.py).

    python -m dreamscene_tpu_torch.bench.k1_variants

Builds the kernel library and, beside it, csrc/composite_fwd.cu with
-DDS_K1_PER_TILE (the per-tile body) and with -DDS_K1_NO_BOX. For each
scene it prints, one JSON line each:
  * the per-tile distribution of chunks and live entries
    (scenes.tile_stats);
  * each form (per tile; per warp with the launcher's 8 x 4 pixel blocks;
    per warp in plain tile order instead of the busiest-first order its
    first kernel computes (the order is held against `tile_order`, its plain
    version); per warp with one-row blocks, 32 x 1 or 16 x 2; per warp
    without the box test, a build with -DDS_K1_NO_BOX): ms per launch (CUDA
    events, the library's plain launch for the per-warp form beside the
    timed one), from the nanosecond timer each CTA or warp reads at its
    start and end the longest one, the sum over all and the launch's span,
    the longest one's tile and that tile's live entries (so ns per entry of
    the busiest walk), for a warp the entries it walked and the batches it
    staged, the time when tiles with more than N chunks return at once, for
    a few N, and the longest one's tile alone (the other tiles' chunks
    emptied: its walk without other busy warps on the SM);
  * whether each per-warp form's `out` and live carry rows are bit-equal to
    the per-tile form's.
Needs one CUDA card and nvcc.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import tempfile

import torch

from dreamscene_tpu_torch import kernels
from dreamscene_tpu_torch.bench import scenes
from dreamscene_tpu_torch.bench.k2_variants import SCENES
from dreamscene_tpu_torch.bench.k4_fwd_variants import cuda_time
from dreamscene_tpu_torch.ops import composite as C


def build_variant(tag: str, defines) -> ctypes.CDLL:
    """csrc/composite_fwd.cu alone, with extra -D flags."""
    so = kernels.BUILD_DIR / f"composite_fwd_{tag}.so"
    cmd = [kernels.nvcc_path(), *kernels.NVCC_FLAGS, "-I", str(kernels.CSRC), "-shared",
           *defines, "-Xptxas", "-v", str(kernels.CSRC / "composite_fwd.cu"), "-o", str(so)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(res.stdout + res.stderr)
    print(f"composite_fwd.cu {' '.join(defines)}:\n" + res.stdout + res.stderr)
    lib = ctypes.CDLL(str(so))
    lib.ds_composite_fwd_timed.argtypes = kernels._SIGNATURES["ds_composite_fwd_timed"]
    lib.ds_composite_fwd_timed.restype = ctypes.c_int
    return lib


def unit_tile(form: str, unit: int, tile_pix: int, order) -> int:
    """The tile a CTA (per-tile form) or warp works on: a tile's warps are
    consecutive, tiles in `order` (None: 0, 1, 2, ...)."""
    if form == "per tile":
        return unit
    rank = unit // (tile_pix // 32)
    return int(order[rank]) if order is not None else rank


def main() -> int:
    if not torch.cuda.is_available():
        print("k1_variants: CUDA is not available", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    kernels.build(force=True, verbose=True)
    libs = {"per tile": build_variant("per_tile", ["-DDS_K1_PER_TILE"]),
            "per warp": kernels.lib(),
            "per warp no box": build_variant("no_box", ["-DDS_K1_NO_BOX"])}
    for label, n_pts, w, h, tw, th in SCENES:
        kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        cache = tempfile.mkdtemp(prefix="k1_variants_init_", dir=kernels.BUILD_DIR)
        st, cam = scenes.make_scene(n_pts, w, h, n_pts, cache)
        inp = scenes.binned_inputs(st, cam, tw, th)
        stats = scenes.tile_stats(inp)
        print(json.dumps({"scene": label, "tiles": stats}), flush=True)
        rt, meta = inp["records_t"], inp["meta"]
        n_tiles, tiles_x, tile_pix = inp["n_tiles"], inp["tiles_x"], tw * th
        ct, _, lo, hi, _, n_used = meta
        live_u = torch.nonzero((hi > lo)[:int(n_used)]).flatten()
        entries = torch.zeros(n_tiles + 1, dtype=torch.long, device="cuda")
        entries.index_add_(0, ct[:int(n_used)].long(), (hi - lo)[:int(n_used)].clamp_min(0).long())

        k1_args, k1_keep = C.prepare_forward(rt, *meta[:4], n_tiles, tiles_x, tw, th)
        ms_library = cuda_time(lambda: C.launch_forward(k1_args, k1_keep), 20)
        geo = dict(n_tiles=n_tiles, tiles_x=tiles_x, chunk=inp["chunk"], tile_w=tw, tile_h=th)
        # the whole call: validation, the tile order's torch ops, allocation, launch
        ms_call = cuda_time(lambda: C.composite_forward_carry(rt, *meta, **geo), 20)
        n_warps = (n_tiles + 1) * tile_pix // 32
        order = C.tile_order(ct, lo, hi, n_tiles)
        forms = (("per tile", "per tile", 0, n_tiles + 1, False),
                 ("per warp 8x4", "per warp", 8, n_warps, True),
                 ("per warp 8x4, tile order", "per warp", 8, n_warps, False),
                 ("per warp rows", "per warp", min(tw, 32), n_warps, True),
                 ("per warp 8x4 no box", "per warp no box", 8, n_warps, True))
        results = {}
        for form, lib_name, warp_w, n_units, lpt in forms:
            lib = libs[lib_name]
            order_buf = torch.full_like(order, -1)
            order_ptr = order_buf.data_ptr() if lpt else None
            out = torch.empty_like(k1_keep[-1])
            carry = torch.zeros_like(k1_keep[-2])
            unit_ns = torch.zeros((n_units, 4), dtype=torch.int64, device="cuda")

            def run(skip):
                code = lib.ds_composite_fwd_timed(
                    rt.data_ptr(), rt.shape[1], *(t.data_ptr() for t in meta[:4]),
                    ct.shape[0], out.data_ptr(), carry.data_ptr(), n_tiles, tiles_x, tw, th,
                    warp_w, order_ptr, unit_ns.data_ptr(), skip, kernels.stream_ptr(rt.device))
                kernels.check(code, f"composite_fwd ({form})")

            ms = cuda_time(lambda: run(1 << 30), 20)
            if lpt:
                assert torch.equal(order_buf, order), f"{form}: tile order differs from plain"
            ns = unit_ns.cpu()
            dur = (ns[:, 1] - ns[:, 0]).double() / 1e6
            longest = int(dur.argmax())
            tile = unit_tile(form, longest, tile_pix, order if lpt else None)
            row = {"scene": label, "form": form, "ms": ms, "longest_unit_ms": float(dur.max()),
                   "sum_units_ms": float(dur.sum()),
                   "span_first_start_to_last_end_ms": float((ns[:, 1].max() - ns[:, 0].min()) / 1e6),
                   "units": n_units, "longest_unit_tile": tile,
                   "longest_unit_tile_entries": int(entries[tile]),
                   "longest_unit_ns_per_tile_entry":
                       float(dur.max()) * 1e6 / max(1, int(entries[tile])),
                   "units_over_half_longest": int((dur > dur.max() / 2).sum())}
            if form != "per tile":
                # entries the longest warp walked (past the box test) and
                # batches it staged, and the ten longest warps' ms and tiles
                row["longest_unit_walked"] = int(ns[longest, 2])
                row["longest_unit_batches"] = int(ns[longest, 3])
                top = dur.argsort(descending=True)[:10]
                row["top10_units_ms_tile_walked"] = [
                    [round(float(dur[u]), 4), unit_tile(form, int(u), tile_pix,
                                                        order if lpt else None),
                     int(ns[u, 2])] for u in top]
            if form != "per tile":
                row["ms_library_launch"] = ms_library
                row["ms_library_call"] = ms_call
            results[form] = (out.clone(), carry[live_u].clone())
            cmax = stats["chunks_per_tile_max"]
            row["ms_when_tiles_over_n_chunks_return"] = {
                str(n): cuda_time(lambda: run(n), 20)
                for n in sorted({max(1, cmax // 2), max(1, cmax // 4), 1, 0})}
            # the longest unit's tile alone (every other tile's chunks emptied):
            # its walk without other busy warps beside it on the SM
            alone = (ct < tile) | (ct > tile)
            lo_a, hi_a = torch.where(alone, hi, lo).contiguous(), hi
            code_args = (rt.data_ptr(), rt.shape[1], ct.data_ptr(), meta[1].data_ptr(),
                         lo_a.data_ptr(), hi_a.data_ptr(), ct.shape[0])
            out_a = torch.empty_like(out)
            carry_a = torch.empty_like(carry)

            def run_alone():
                kernels.check(lib.ds_composite_fwd_timed(
                    *code_args, out_a.data_ptr(), carry_a.data_ptr(), n_tiles, tiles_x, tw, th,
                    warp_w, None, unit_ns.data_ptr(), 1 << 30, kernels.stream_ptr(rt.device)),
                    f"composite_fwd ({form}, one tile)")

            row["ms_longest_unit_tile_alone"] = cuda_time(run_alone, 20)
            ns = unit_ns.cpu()
            row["longest_unit_alone_ms"] = float((ns[:, 1] - ns[:, 0]).max()) / 1e6
            print(json.dumps(row), flush=True)
        ref_out, ref_carry = results["per tile"]
        for form in [f[0] for f in forms[1:]]:
            o, c = results[form]
            print(json.dumps({"scene": label, "form": form, "vs": "per tile",
                              "out_bit_equal": bool(torch.equal(o, ref_out)),
                              "live_carry_rows_bit_equal": bool(torch.equal(c, ref_carry)),
                              "out_max_abs_diff": float((o - ref_out).abs().max()),
                              "carry_max_abs_diff": float((c - ref_carry).abs().max())
                              if c.numel() else 0.0}), flush=True)
        lib_out = C.launch_forward(k1_args, k1_keep)
        torch.cuda.synchronize()
        print(json.dumps({"scene": label, "form": "library launch", "vs": "per tile",
                          "out_bit_equal": bool(torch.equal(lib_out, ref_out)),
                          "live_carry_rows_bit_equal":
                              bool(torch.equal(k1_keep[-2][live_u], ref_carry))}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
