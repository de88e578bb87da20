"""The readings that a cell's limits are set from: for each seed, the
program's compared numbers and the control's (the reference computed in the
precision below the configuration's), in one process.

    python3 benchmark/readings.py --workload <cell> --seeds 11,12,13 [--control-seeds 11,12,13]
                                  [--seconds 2]

Each seed runs the cell's set-up and a short window at its own size and
load, then the check, then (for the control seeds) the control put in the
program's place against the same reference, and each fault the traffic file
names (`"faults"`) planted in the reference put in the program's place. One JSON line per seed:
{"seed", "program": {number: value}, "control": {number: value}}; a control
that raises reads {"error": ...} (it has failed, and sets no upper reading).
"""

from __future__ import annotations

import argparse
import gc
import importlib
import json
import shutil
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import compare, manifest, run  # noqa: E402


def readings(m: dict, cell: dict, seed: int, seconds: float, control: bool,
             device: str = "cuda", cfg: dict | None = None, traffic: dict | None = None):
    import torch

    cfg = cfg or json.loads(manifest.config_file(m, cell["config"]).read_text())
    traffic = traffic or json.loads(manifest.traffic_file(cell["traffic"]).read_text())
    limits = json.loads(manifest.limits_file(cell["name"]).read_text())
    driver = importlib.import_module(f"benchmark.drivers.{traffic['driver']}")
    workdir = tempfile.mkdtemp(prefix="dsbench_readings_")
    try:
        c = driver.Cell(cfg, traffic, seed, device, workdir)
        c.setup()
        c.window(seconds)
        c.release()
        gc.collect()
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
        ref = c.reference_readings()
        cands = {"program": c.program if hasattr(c, "program") else c.last}
        if control:
            cands["control"] = {"lower": True}
            cands.update({f"fault.{f}": {"fault": f} for f in traffic.get("faults", [])})
        out = {"seed": seed}
        for name, cand in cands.items():
            try:
                if name != "program":
                    cand = c.reference_readings(**cand)
                out[name] = {k: v["value"] for k, v in c.judge(cand, ref, limits).items()}
                if "grad1" in cand:
                    out[name]["detail"] = compare.training_detail(cand, ref)
            except (RuntimeError, ValueError) as e:
                out[name] = {"error": repr(e)[:300]}
        return out
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=2.0)
    args = p.parse_args(argv)
    m = manifest.load()
    cell = manifest.cell(m, args.workload)
    run.set_environment(json.loads(manifest.config_file(m, cell["config"]).read_text()))
    control = {int(s) for s in args.control_seeds.split(",") if s}
    for s in [int(s) for s in args.seeds.split(",")]:
        print(json.dumps(readings(m, cell, s, args.seconds, s in control)), flush=True)
    bad = run.forbidden_modules()
    if bad:
        print(f"forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
