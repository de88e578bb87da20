"""Time variants of the K4 forward kernel at d = 64 on the card.

    python -m dreamscene_tpu_torch.bench.k4_fwd_variants

Builds k4_fwd_variants.cu (the forward loop of csrc/flash_fwd.cu with
ldmatrix + mma.sync products in several tilings, and with the wgmma
products the library ships) into build/kernels/ and prints one JSON line
per variant and shape: ms per launch (CUDA events, 10 launches after a
warm one), achieved TFLOP/s and the error against the plain version.
Variants 2, 3, 5 and 10 leave out the exp or the whole softmax: their
values are wrong on purpose, their times say what those parts cost. Needs
one CUDA card and nvcc.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

from dreamscene_tpu_torch import kernels
from dreamscene_tpu_torch.ops import flash_attention as fa

SRC = Path(__file__).with_suffix(".cu")
VARIANTS = {0: "mma.sync, 8 warps x 16 rows, 64 keys, exp2f",
            1: "mma.sync, 8 warps x 16 rows, 64 keys, ex2.approx",
            2: "as 1, no exp (wrong values)",
            3: "as 1, no softmax (wrong values)",
            4: "mma.sync, 4 warps x 32 rows, 64 keys, ex2.approx",
            5: "as 4, no softmax (wrong values)",
            6: "mma.sync, 8 warps x 16 rows, 128 keys, 1 CTA per SM",
            7: "mma.sync, 4 warps x 16 rows, 64 keys, 4 CTAs per SM",
            8: "mma.sync, 8 warps x 16 rows, 32 keys",
            9: "wgmma, 2 warpgroups x 64 rows, 64 keys, ex2.approx (as shipped)",
            10: "as 9, no softmax (wrong values)"}
SHAPES = ((12, 5, 4096, 64), (12, 10, 1024, 64))


def build() -> ctypes.CDLL:
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so = kernels.BUILD_DIR / "k4_fwd_variants.so"
    cmd = [kernels.nvcc_path(), *kernels.NVCC_FLAGS, "-I", str(kernels.CSRC), "-shared",
           "-Xptxas", "-v", str(SRC), "-o", str(so)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(res.stdout + res.stderr)
    for line in (res.stdout + res.stderr).splitlines():
        if "Used" in line:
            print(line)
    lib = ctypes.CDLL(str(so))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.k4_fwd_variant.argtypes = [p] * 6 + [i, i, ctypes.c_float, i, p]
    lib.k4_fwd_variant.restype = i
    return lib


def cuda_time(fn, reps=10) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    if not torch.cuda.is_available():
        print("k4_fwd_variants: CUDA is not available", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    lib = build()
    for shape in SHAPES:
        gen = torch.Generator(device="cuda").manual_seed(1)
        q, k, v = (torch.randn(shape, device="cuda", generator=gen).bfloat16() for _ in range(3))
        scale = shape[3] ** -0.5
        o_p, l_p, m_p = fa.flash_attention_fwd_plain(q, k, v, scale)
        o, l, m = torch.empty_like(q), torch.empty_like(l_p), torch.empty_like(m_p)
        stream = kernels.stream_ptr(q.device)
        flops = 4 * shape[0] * shape[1] * shape[2] ** 2 * shape[3]
        # the shipped variant first and last: the spread of one variant in this run
        for var in [9, *VARIANTS, 9]:
            def run():
                code = lib.k4_fwd_variant(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                                          l.data_ptr(), m.data_ptr(), shape[0] * shape[1],
                                          shape[2], scale, var, stream)
                kernels.check(code, f"k4_fwd_variant {var}")
            ms = cuda_time(run)
            print(json.dumps({"shape": shape, "variant": var, "what": VARIANTS[var], "ms": ms,
                              "tflops": flops / ms / 1e9,
                              "max_abs_err": float((o.float() - o_p.float()).abs().max())}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
