"""Run one cell of BENCHMARK.json on the card and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up builds the cell's program objects from the seed and warms every shape
the cell uses (its kernels build once into build/kernels/ in the checkout),
then the window drives the cell's entry in a closed loop for `--seconds`
seconds. With `--trace 1` a torch.profiler window of a few more steps
follows, and the per-layer metrics are read from it; with `--trace 0` the
end-to-end metrics are printed. Last, with the program's state freed, the
outputs of the timed path are compared with the plain reference
(`reference/`), each number beside its limit (`limits/<cell>.json`).

The last line of standard output is one JSON object: `correct`,
`attempted`, `failed`, `metrics`, `device`, with `--trace 1` `breakdown`,
and last `checks` (each number compared, with its limit). The same numbers
end standard error. Exit codes: 0 a result was printed; 2 no CUDA card, or
fewer than the cell asks for; 3 `jax`, `jaxlib`, `flax` or `dreamscene_tpu`
was loaded in this process.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import manifest  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "dreamscene_tpu")
# the program's knobs read at import; a configuration sets them under
# "program_env", every other value is cleared
PROGRAM_KNOBS = ("DS_FLASH_ATTN", "DS_TILE_W", "DS_TILE_H", "DS_EXPAND_BLOCK")


def forbidden_modules() -> list[str]:
    """Top-level names in sys.modules that the benchmark must not load,
    compared whole: `dreamscene_tpu_torch` is not `dreamscene_tpu`."""
    return sorted({k.split(".")[0] for k in list(sys.modules)} & set(FORBIDDEN))


def set_environment(cfg: dict):
    """Caches inside the checkout at fixed paths, no JAX or Flax through a
    library, and the program's knobs as the configuration states them."""
    cache = ROOT / "build" / "bench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    for k in PROGRAM_KNOBS:
        os.environ.pop(k, None)
    for k, v in cfg.get("program_env", {}).items():
        os.environ[k] = str(v)


def load_reader(name: str):
    """The `read(ctx)` of metrics/<name>.py (names may hold dots)."""
    path = manifest.metric_file(name)
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class Context:
    """What a metric reader reads: the run's timings and counters, the
    driver's counts, and the trace of a `--trace 1` run (else None)."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def power_limit() -> str | None:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else None


def run_cell(m: dict, cell: dict, seed: int, seconds: float, trace: bool,
             device: str = "cuda", cfg: dict | None = None, traffic: dict | None = None,
             t_start: float | None = None) -> dict:
    """Set-up, window, optional trace, metrics, release, then the check.
    Returns the result dict (without the `device` key's card fields)."""
    import torch

    from benchmark import trace as T

    t_start = time.perf_counter() if t_start is None else t_start
    cfg = cfg or json.loads(manifest.config_file(m, cell["config"]).read_text())
    traffic = traffic or json.loads(manifest.traffic_file(cell["traffic"]).read_text())
    driver = importlib.import_module(f"benchmark.drivers.{traffic['driver']}")
    cuda = torch.device(device).type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    workdir = tempfile.mkdtemp(prefix="dsbench_")
    try:
        run = driver.Cell(cfg, traffic, seed, device, workdir)
        run.setup()
        sync()
        setup_s = time.perf_counter() - t_start
        peak_setup = torch.cuda.max_memory_allocated() if cuda else 0
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        window = run.window(seconds)
        sync()
        peak_window = torch.cuda.max_memory_allocated() if cuda else 0
        tr = None
        if trace:
            n = int(traffic.get("trace_steps", 6))
            tr = T.capture(lambda: run.traced(n), n, sync)
        if tr is not None and hasattr(run, "view_counts"):
            print(json.dumps({"view_counts": run.view_counts()}), file=sys.stderr)
        names = manifest.metrics_of(m, cell["name"])["per_layer" if trace else "end_to_end"]
        ctx = Context(setup_s=setup_s, window=window, trace=tr, run=run, cfg=cfg,
                      traffic=traffic, peak_window_bytes=peak_window)
        metrics = {}
        for name in names:
            value = load_reader(name)(ctx)
            if value is not None:
                metrics[name] = {"value": float(value),
                                 "unit": manifest.metric_entry(m, name)["unit"]}
        run.release()
        if cuda:
            torch.cuda.empty_cache()
        checks = run.check(json.loads(manifest.limits_file(cell["name"]).read_text()))
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    result = {
        "correct": all(c["value"] <= c["limit"] for c in checks.values()),
        "attempted": window["attempted"],
        "failed": window["failed"],
        "metrics": metrics,
        "device": {"memory_peak_bytes": int(max(peak_setup, peak_window))},
    }
    if tr is not None:
        result["device"].update(busy_s=tr.busy_s, window_s=tr.wall_s)
        result["breakdown"] = tr.breakdown()
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    m = manifest.load()
    cell = manifest.cell(m, args.workload)
    cfg = json.loads(manifest.config_file(m, cell["config"]).read_text())
    set_environment(cfg)
    import torch

    # one host thread for torch's CPU work: the cells' host paths are
    # Python, and a pool of spinning threads on a shared host only adds noise
    torch.set_num_threads(1)

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"benchmark: cell {cell['name']} needs {cell['chips']} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = run_cell(m, cell, args.seed, args.seconds, bool(args.trace), cfg=cfg,
                      t_start=T_START)
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    checks = result.pop("checks")
    result["device"] = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                        "count": cell["chips"], **result["device"],
                        "card": power_limit()}
    result["checks"] = checks
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
