"""Build, load and count the hand-written CUDA kernels.

The sources live in csrc/*.cu. At first use each source is compiled by
its own `nvcc` process (all started together) for sm_90a, without
--use_fast_math and with -fmad=false (the binning cull compares f32
values against thresholds, so one contracted multiply-add can flip an
integer key), and the objects are linked into build/kernels/libdstorch.so
at the repository root. The library has a plain C interface loaded with
ctypes: every pointer and the stream pass as c_void_p, every launcher
returns cudaGetLastError() and `check` raises on a non-zero code. The
sources hold only the kernels the program launches, and the library exports
only their launchers (`_SIGNATURES`, held to csrc/ by
tests/test_torch_isolation.py). Designs that lost a measurement are in
PERF.md; the scripts and sources that timed them last lived in commit e119691.

`COUNTS` holds one launch counter per kernel; each wrapper adds one
where it launches its kernel and nowhere else. The kernels that have a
tensor-core and a CUDA-core variant also count the launches that took the
tensor-core variant (`VARIANT_NAMES`). A UNet pass replayed from a CUDA
graph adds the counts its capture recorded, and counts itself in the same
Counter (`unet_graph.capture`, `.replay`, `.eager`: guidance/unet_graph.py).
The norms also count elements (ops/norms.py): `norm.kernel_elems`, read by
their kernels; `norm.torch_elems`, taken by a norm's backward, which runs
as PyTorch ops.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import fcntl
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
LIB_PATH = BUILD_DIR / "libdstorch.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-fmad=false", "-lineinfo"]

COUNTS: collections.Counter = collections.Counter()
KERNEL_NAMES = ("expand_entries", "composite_fwd", "composite_bwd", "flash_fwd",
                "flash_bwd_dkv", "flash_bwd_dq", "group_norm_fwd", "layer_norm_fwd")
VARIANT_NAMES = ("flash_fwd.tc", "flash_bwd_dkv.tc", "flash_bwd_dq.tc")

_LIB = None
_LOCK = threading.Lock()
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_S = ctypes.POINTER(ctypes.c_longlong)   # three element strides: batch, head, row

# launcher name -> ctypes argument types (must match csrc/*.cu)
_SIGNATURES = {
    "ds_expand_entries": [
        _P, _P, _P, _P, _P, _P, _P,            # offsets basenx perm caps0-2 n_entries
        _P, _P,                                # key gid
        _P,                                    # geometry (ops/expand.py::ExpandGeo)
        _P,                                    # stream
    ],
    "ds_composite_fwd": [
        _P, _I, _P, _P, _P, _P, _I,            # rec cap_pad chunk_tile s0 lo hi n_chunks
        _P, _P,                                # out carry
        _I, _I, _I, _I,                        # n_tiles tiles_x tile_w tile_h
        _P,                                    # tile-order scratch
        _P,                                    # stream
    ],
    "ds_tile_order": [                         # K1's first kernel alone; chip_smoke.py, card tests
        _P, _P, _P, _I, _I,                    # chunk_tile lo hi n_chunks n_tiles
        _P,                                    # order
        _P,                                    # stream
    ],
    "ds_composite_bwd": [
        _P, _I, _P, _P, _P, _P, _I, _P,        # rec cap_pad chunk_tile s0 lo hi n_chunks n_used
        _P, _P, _P,                            # carry final grad_out
        _P,                                    # grec
        _I, _I, _I, _I, _I,                    # n_tiles tiles_x tile_w tile_h chunk
        _P,                                    # stream
    ],
    "ds_flash_fwd": [
        _P, _P, _P, _P, _P, _P,                # q k v o l m
        _I, _I, _I, _I,                        # b h n d
        _S, _S, _S, _S,                        # strides of q k v o
        _F, _I, _I,                            # scale bf16 tc
        _P,                                    # stream
    ],
    "ds_flash_bwd_dkv": [
        _P, _P, _P, _P, _P, _P, _P,            # q k v l m dout di
        _P, _P,                                # dk dv
        _I, _I, _I, _F, _I, _I,                # bh n d scale bf16 tc
        _P,                                    # stream
    ],
    "ds_flash_bwd_dq": [
        _P, _P, _P, _P, _P, _P, _P,            # q k v l m dout di
        _P,                                    # dq
        _I, _I, _I, _F, _I, _I,                # bh n d scale bf16 tc
        _P,                                    # stream
    ],
    "ds_group_norm_fwd": [
        _P, _P, _P, _P, _P, _P,                # x gamma beta y mean rstd
        _I, _I, _I, _I, _F,                    # n c hw groups eps
        _I, _I, _I, _I, _I,                    # silu in_cl out_tok in_bf16 out_bf16
        _P,                                    # stream
    ],
    "ds_layer_norm_fwd": [
        _P, _P, _P, _P, _P, _P,                # x gamma beta y mean rstd
        _I, _I, _F, _I, _I,                    # rows c eps in_bf16 out_bf16
        _P,                                    # stream
    ],
}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return str(Path(cuda_home) / "bin" / "nvcc")


def _stale() -> bool:
    if not LIB_PATH.exists():
        return True
    built = LIB_PATH.stat().st_mtime
    return any(p.stat().st_mtime > built for p in CSRC.iterdir())


def build(force: bool = False, verbose: bool = False) -> float:
    """Compile every csrc/*.cu in parallel and link libdstorch.so.
    Returns the seconds spent (0.0 when the library was up to date).

    Processes that start together (the ranks of a multi-process run) take
    an exclusive `flock` on build/kernels/.lock and check staleness again
    once they hold it: the first builds, the others load its result. The
    objects have fixed paths, so two builds at once would write the same
    files."""
    if not force and not _stale():
        return 0.0
    with build_lock(BUILD_DIR):
        if not force and not _stale():
            return 0.0
        return _compile(verbose)


@contextlib.contextmanager
def build_lock(directory: Path):
    """Hold an exclusive `flock` on `directory`/.lock (made if missing)."""
    directory.mkdir(parents=True, exist_ok=True)
    with open(directory / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        yield


def _compile(verbose: bool) -> float:
    t0 = time.perf_counter()
    nvcc = nvcc_path()
    sources = sorted(CSRC.glob("*.cu"))
    procs = []
    for src in sources:
        obj = BUILD_DIR / (src.stem + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src), "-o", str(obj)]
        if verbose:
            cmd += ["-Xptxas", "-v"]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    errors = []
    for src, _, p in procs:
        out, _ = p.communicate()
        if p.returncode != 0:
            errors.append(f"nvcc failed on {src.name}:\n{out}")
        elif verbose and out:
            print(out)
    if errors:
        raise RuntimeError("\n".join(errors))
    tmp = LIB_PATH.with_suffix(f".{os.getpid()}.tmp.so")
    link = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
            "-o", str(tmp), *[str(o) for _, o, _ in procs]]
    res = subprocess.run(link, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{res.stdout}\n{res.stderr}")
    os.replace(tmp, LIB_PATH)
    return time.perf_counter() - t0


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            build()
            handle = ctypes.CDLL(str(LIB_PATH))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _LIB = handle
    return _LIB


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def check(code: int, name: str) -> None:
    if code != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: error {code}")


def reset_counts() -> None:
    COUNTS.clear()
    for k in KERNEL_NAMES + VARIANT_NAMES:
        COUNTS[k] = 0


def require(t: torch.Tensor, name: str, dtype: torch.dtype, shape=None) -> None:
    """Raise on anything a kernel does not take."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
