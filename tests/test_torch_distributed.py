"""The port's multi-process runtime (parallel/distributed.py) and the
kernel build across processes (kernels.build), on the CPU: the
counterparts of tests/test_distributed.py (single-process no-op, a real
two-process collective, the hybrid mesh's layout) plus the NCCL guard
against ranks that share a card, and the build lock with a stub compiler.
"""

import os
import socket
import subprocess
import sys
import textwrap

import pytest
import torch
import torch.distributed as dist

from dreamscene_tpu_torch.parallel import distributed as PD

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TORCHRUN_ENV = ("WORLD_SIZE", "RANK", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "MASTER_ADDR",
                "MASTER_PORT")


def test_initialize_runtime_noop_single_process(monkeypatch):
    for k in TORCHRUN_ENV:
        monkeypatch.delenv(k, raising=False)
    assert PD.initialize_runtime("cpu") == torch.device("cpu")
    assert not dist.is_initialized()
    assert PD.world_size() == 1 and PD.rank() == 0
    mesh = PD.make_hybrid_mesh(1, 1)
    assert mesh.shape == {"ddp": 1, "dp": 1, "tp": 1}
    assert mesh.coords == {"ddp": 0, "dp": 0, "tp": 0} and mesh.world_group is None


def test_single_mesh_makes_no_group(monkeypatch):
    """The trainers' one-process step runs on `single_mesh()`: a 1 x 1 mesh
    of this rank with no group, so every collective is the identity."""
    from dreamscene_tpu_torch.parallel import collectives as X
    from dreamscene_tpu_torch.parallel import sharded_render as SR

    for k in TORCHRUN_ENV:
        monkeypatch.delenv(k, raising=False)
    mesh = SR.single_mesh()
    assert mesh.shape == {"dp": 1, "tp": 1} and mesh.coords == {"dp": 0, "tp": 0}
    assert mesh.group("dp") is None and mesh.group("tp") is None and mesh.world_group is None
    x = torch.arange(6.0).reshape(2, 3).requires_grad_(True)
    X.reset_stats()
    y = X.gather_replicated(X.all_gather(x, mesh.group("tp")), mesh.group("tp"), dim=1)
    assert y is x and X.STATS["calls"] == 0
    assert SR.rank_cameras(mesh, 4) == slice(0, 4)


def test_run_ranks_needs_its_device_named(tmp_path):
    """run_ranks has no default device, and a CUDA device without CUDA
    raises before any rank starts."""
    from dreamscene_tpu_torch.parallel.launch import run_ranks

    with pytest.raises(TypeError):
        run_ranks(print, 2, store_dir=str(tmp_path))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            run_ranks(print, 2, device="cuda:0", store_dir=str(tmp_path))
    assert not list(tmp_path.iterdir())


def test_nccl_refuses_two_local_ranks_on_one_card(monkeypatch):
    """torchrun with two local ranks on a one-card machine: the nccl
    default raises before any process group forms (gloo shares the card
    only when asked for)."""
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("LOCAL_RANK", "0")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="nccl: 2 local ranks but 1 card"):
        PD.initialize_runtime("cuda")
    assert not dist.is_initialized()


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


_WORKER = textwrap.dedent("""
    import sys
    sys.path.insert(0, %(repo)r)
    import torch, torch.distributed as dist
    from dreamscene_tpu_torch.parallel import distributed as PD
    torch.set_num_threads(1)
    dev = PD.initialize_runtime("cpu")          # reads torchrun's environment
    assert dev == torch.device("cpu") and dist.get_backend() == "gloo"
    x = torch.tensor([float(dist.get_rank() + 1)])
    dist.all_reduce(x)
    outer = PD.make_hybrid_mesh(1, 1)           # one rank a node: ddp spans them
    inner = PD.make_hybrid_mesh(1, 2)
    print("RESULT", x.item(), dist.get_rank(), dist.get_world_size(), outer.shape["ddp"],
          outer.coords["ddp"], inner.shape["ddp"], inner.coords["tp"], flush=True)
    dist.destroy_process_group()
""")


def test_two_process_all_reduce_over_torchrun_env(tmp_path):
    """Two processes with torchrun's variables (one rank per node): the
    runtime joins them over gloo, an all-reduce crosses processes, and the
    hybrid mesh puts the nodes on its outer axis."""
    port = _free_port()
    procs = []
    for r in range(2):
        env = dict(os.environ, WORLD_SIZE="2", RANK=str(r), LOCAL_RANK="0",
                   LOCAL_WORLD_SIZE="1", MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        procs.append(subprocess.Popen([sys.executable, "-c", _WORKER % {"repo": REPO}],
                                      env=env, stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True))
    outs = [p.communicate(timeout=120) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{out}\n{err}"
    got = sorted(tuple(line.split()[1:]) for out, _ in outs
                 for line in out.splitlines() if line.startswith("RESULT"))
    # 1 + 2 on every rank; ddp = 2 nodes (rank r at ddp r); a 1 x 2 inner
    # mesh over the 2 ranks leaves ddp 1, rank r at tp r
    assert got == [("3.0", "0", "2", "2", "0", "1", "0"),
                   ("3.0", "1", "2", "2", "1", "1", "1")], got


_STUB_NVCC = textwrap.dedent("""\
    #!%(python)s
    import os, sys, time
    args = sys.argv[1:]
    out = args[args.index("-o") + 1]
    src = args[args.index("-c") + 1] if "-c" in args else "link"
    with open(%(log)r, "a") as f:
        f.write(os.path.basename(src) + "\\n")
    time.sleep(0.3)                 # widen the window two builds could share
    with open(out, "wb") as f:
        f.write(b"stub")
""")

_BUILD_SCRIPT = textwrap.dedent("""
    import sys
    from pathlib import Path
    sys.path.insert(0, %(repo)r)
    from dreamscene_tpu_torch import kernels
    kernels.CSRC = Path(%(csrc)r)
    kernels.BUILD_DIR = Path(%(build)r)
    kernels.LIB_PATH = kernels.BUILD_DIR / "libdstorch.so"
    print("SECONDS", kernels.build(), flush=True)
""")


def test_kernel_build_once_across_processes(tmp_path):
    """Four processes that start on a stale tree take the build lock in
    turn: the first compiles each source once and links, the others find
    the library up to date and build nothing."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for name in ("a.cu", "b.cu", "c.cu"):
        (csrc / name).write_text("// stub\n")
    log = tmp_path / "nvcc.log"
    bindir = tmp_path / "bin"
    bindir.mkdir()
    nvcc = bindir / "nvcc"
    nvcc.write_text(_STUB_NVCC % {"python": sys.executable, "log": str(log)})
    nvcc.chmod(0o755)
    env = dict(os.environ, PATH=f"{bindir}{os.pathsep}{os.environ['PATH']}")
    code = _BUILD_SCRIPT % {"repo": REPO, "csrc": str(csrc), "build": str(tmp_path / "build")}
    procs = [subprocess.Popen([sys.executable, "-c", code], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for _ in range(4)]
    outs = [p.communicate(timeout=120) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, f"build process failed:\n{out}\n{err}"
    calls = sorted(log.read_text().split())
    assert calls == ["a.cu", "b.cu", "c.cu", "link"], calls
    secs = sorted(float(line.split()[1]) for out, _ in outs for line in out.splitlines()
                  if line.startswith("SECONDS"))
    assert secs[:3] == [0.0, 0.0, 0.0] and secs[3] > 0, secs
    assert (tmp_path / "build" / "libdstorch.so").read_bytes() == b"stub"
    assert not list((tmp_path / "build").glob("*.tmp.so"))
