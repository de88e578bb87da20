"""Time the K4 dQ kernel's tilings on the card.

    python -m dreamscene_tpu_torch.bench.k4_dq_variants

Builds the kernel library (ptxas's registers and shared memory of the dQ
kernels are printed) and, beside it, csrc/flash_bwd_dq.cu once more with
-DDS_DQ512_ROWS32, which gives the d = 512 bucket the other tiling that
fits its shared memory (32 query rows x 32-key blocks where the library has
64 rows x 16-key blocks). For each shape it runs the tensor-core dQ kernel
of the library and, at d = 512, of the second build, in the order library,
second, second, library so that the spread of one tiling shows in the same
run. The dK/dV kernel is timed beside them. One JSON line per launch
series: ms per launch (CUDA events, 10 launches after a warm one), achieved
TFLOP/s and the error against the plain version. Needs one CUDA card and
nvcc.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys

import torch

from dreamscene_tpu_torch import kernels
from dreamscene_tpu_torch.bench.k4_fwd_variants import cuda_time
from dreamscene_tpu_torch.ops import flash_attention as fa

SHAPES = ((4, 1, 4096, 512), (1, 1, 4096, 512), (2, 2, 4096, 256), (4, 4, 4096, 128),
          (12, 5, 4096, 64))


def build_rows32() -> ctypes.CDLL:
    """csrc/flash_bwd_dq.cu alone, with the 32-row tiling at d = 512."""
    so = kernels.BUILD_DIR / "flash_bwd_dq_rows32.so"
    cmd = [kernels.nvcc_path(), *kernels.NVCC_FLAGS, "-I", str(kernels.CSRC), "-shared",
           "-DDS_DQ512_ROWS32", "-Xptxas", "-v", str(kernels.CSRC / "flash_bwd_dq.cu"),
           "-o", str(so)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(res.stdout + res.stderr)
    print("flash_bwd_dq.cu -DDS_DQ512_ROWS32:\n" + res.stdout + res.stderr)
    lib = ctypes.CDLL(str(so))
    lib.ds_flash_bwd_dq.argtypes = kernels._SIGNATURES["ds_flash_bwd_dq"]
    lib.ds_flash_bwd_dq.restype = ctypes.c_int
    return lib


def main() -> int:
    if not torch.cuda.is_available():
        print("k4_dq_variants: CUDA is not available", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    kernels.build(force=True, verbose=True)
    tilings = {"library": kernels.lib(), "rows32": build_rows32()}
    for shape in SHAPES:
        gen = torch.Generator(device="cuda").manual_seed(1)
        q, k, v = (torch.randn(shape, device="cuda", generator=gen).bfloat16() for _ in range(3))
        scale = shape[3] ** -0.5
        o, l, m = fa.flash_attention_fwd_plain(q, k, v, scale)
        do = torch.cos(o.float()).bfloat16()
        di = (o.float() * do.float()).sum(-1)
        dq_p = fa.flash_attention_bwd_plain(q, k, v, l, m, do, di, scale)[0]
        dq, dk, dv = torch.empty_like(q), torch.empty_like(q), torch.empty_like(q)
        pairs = shape[0] * shape[1] * shape[2] ** 2
        wide = shape[3] > 256
        for tiling in ("library", "rows32", "rows32", "library") if wide else ("library",) * 2:
            def run():
                code = tilings[tiling].ds_flash_bwd_dq(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), l.data_ptr(), m.data_ptr(),
                    do.data_ptr(), di.data_ptr(), dq.data_ptr(), shape[0] * shape[1], shape[2],
                    shape[3], scale, 1, 1, kernels.stream_ptr(q.device))
                kernels.check(code, "flash_bwd_dq")
            ms = cuda_time(run)
            print(json.dumps({"shape": shape, "kernel": "dq", "tiling": tiling, "ms": ms,
                              "tflops": 6 * pairs * shape[3] / ms / 1e9,
                              "max_abs_err": float((dq.float() - dq_p.float()).abs().max()),
                              "max_abs_plain": float(dq_p.float().abs().max())}), flush=True)
        ms = cuda_time(lambda: fa.launch_bwd_dkv(q, k, v, l, m, do, di, dk, dv, scale))
        print(json.dumps({"shape": shape, "kernel": "dkv", "ms": ms,
                          "tflops": 8 * pairs * shape[3] / ms / 1e9}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
