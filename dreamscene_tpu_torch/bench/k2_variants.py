"""What sets K2's time: the old one-CTA-per-tile kernel beside the
one-CTA-per-chunk kernel of csrc/composite_bwd.cu, on seeded scenes
(bench/scenes.py; the full-width one and the 16x16-tile one of chip_smoke.py).

    python -m dreamscene_tpu_torch.bench.k2_variants

For each scene it prints, one JSON line each:
  * the per-tile distribution of chunks and live entries
    (scenes.tile_stats);
  * the per-tile kernel (k2_variants.cu, the design before the redesign): ms
    per launch; from the nanosecond timer each tile's CTA reads at its start
    and end, the longest CTA, the sum over CTAs and the launch's span; and
    its time when tiles with more than N chunks return at once, for a few N;
  * K1, which writes the carry table the per-chunk kernel starts from;
  * the per-chunk kernel, twice: ms, error against the plain version,
    bit-identical across two launches.
Needs one CUDA card and nvcc.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

from dreamscene_tpu_torch import kernels
from dreamscene_tpu_torch.bench import scenes
from dreamscene_tpu_torch.bench.k4_fwd_variants import cuda_time
from dreamscene_tpu_torch.ops import composite as C

SRC = Path(__file__).with_suffix(".cu")
SCENES = (("full width 50K 512^2 32x16", 50_000, 512, 512, 32, 16),
          ("16x16 tiles 20K 256^2", 20_000, 256, 256, 16, 16))


def build() -> ctypes.CDLL:
    kernels.build(force=True, verbose=True)
    so = kernels.BUILD_DIR / "k2_variants.so"
    cmd = [kernels.nvcc_path(), *kernels.NVCC_FLAGS, "-I", str(kernels.CSRC), "-shared",
           "-Xptxas", "-v", str(SRC), "-o", str(so)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(res.stdout + res.stderr)
    for line in (res.stdout + res.stderr).splitlines():
        if "Used" in line:
            print("k2_variants.cu:", line)
    lib = ctypes.CDLL(str(so))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.k2_per_tile.argtypes = [p, i, p, p, p, p, i, p, p, p, p, i, i, i, i, i, p, i, p]
    lib.k2_per_tile.restype = i
    return lib


def main() -> int:
    if not torch.cuda.is_available():
        print("k2_variants: CUDA is not available", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    lib = build()
    for label, n_pts, w, h, tw, th in SCENES:
        kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        cache = tempfile.mkdtemp(prefix="k2_variants_init_", dir=kernels.BUILD_DIR)
        st, cam = scenes.make_scene(n_pts, w, h, n_pts, cache)
        inp = scenes.binned_inputs(st, cam, tw, th)
        stats = scenes.tile_stats(inp)
        print(json.dumps({"scene": label, "tiles": stats}), flush=True)
        rt, meta = inp["records_t"], inp["meta"]
        geo = dict(n_tiles=inp["n_tiles"], tiles_x=inp["tiles_x"], chunk=inp["chunk"],
                   tile_w=tw, tile_h=th)
        out, carry = C.composite_forward_carry(rt, *meta, **geo)
        g_out = torch.randn(out.shape, device="cuda",
                            generator=torch.Generator(device="cuda").manual_seed(7))
        gp = C.composite_backward_plain(rt, *meta[:4], meta[5], out, g_out, **geo)
        gmax = float(gp.abs().max())

        new_args, keep = C.prepare_backward(rt, *meta[:4], meta[5], out, g_out, carry,
                                            inp["n_tiles"], inp["tiles_x"], inp["chunk"], tw, th)
        # the per-tile kernel writes into the same grad table
        n_used, grec = meta[5].reshape(1).to(torch.int32), keep[-1]
        cta_ns = torch.zeros((inp["n_tiles"], 2), dtype=torch.int64, device="cuda")

        def per_tile(skip_chunks):
            code = lib.k2_per_tile(
                rt.data_ptr(), rt.shape[1], *(t.data_ptr() for t in meta[:4]), meta[0].shape[0],
                n_used.data_ptr(), out.data_ptr(), g_out.data_ptr(), grec.data_ptr(),
                inp["n_tiles"], inp["tiles_x"], tw, th, inp["chunk"], cta_ns.data_ptr(),
                skip_chunks, kernels.stream_ptr(rt.device))
            kernels.check(code, "k2_per_tile")

        ms_all = cuda_time(lambda: per_tile(1 << 30), 20)
        err_old = float((grec - gp).abs().max())
        ns = cta_ns.cpu()
        dur = (ns[:, 1] - ns[:, 0]).double() / 1e6
        row = {"scene": label, "kernel": "per tile (before)", "ms": ms_all,
               "max_abs_err": err_old, "max_abs_plain": gmax,
               "longest_cta_ms": float(dur.max()), "sum_cta_ms": float(dur.sum()),
               "span_first_start_to_last_end_ms": float((ns[:, 1].max() - ns[:, 0].min()) / 1e6),
               "ctas_over_half_longest": int((dur > dur.max() / 2).sum())}
        cmax = stats["chunks_per_tile_max"]
        row["ms_when_tiles_over_n_chunks_return"] = {
            str(n): cuda_time(lambda: per_tile(n), 20)
            for n in sorted({max(1, cmax // 2), max(1, cmax // 4), 1, 0})}
        print(json.dumps(row), flush=True)

        k1_args, k1_keep = C.prepare_forward(rt, *meta[:4], inp["n_tiles"], inp["tiles_x"], tw, th)
        print(json.dumps({"scene": label, "kernel": "K1", "ms": cuda_time(
            lambda: C.launch_forward(k1_args, k1_keep), 20)}), flush=True)

        for _ in range(2):
            g1 = C.launch_backward(new_args, keep).clone()
            g2 = C.launch_backward(new_args, keep)
            torch.cuda.synchronize()
            print(json.dumps({"scene": label, "kernel": "per chunk",
                              "ms": cuda_time(lambda: C.launch_backward(new_args, keep), 20),
                              "max_abs_err": float((g1 - gp).abs().max()), "max_abs_plain": gmax,
                              "bit_identical": bool(torch.equal(g1, g2))}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
