"""BENCHMARK.json against the character and shape rules, every cell's files
found by name, what the harness imports, and that a configuration, a cell
and a metric are added by new files and entries alone."""

from __future__ import annotations

import ast
import hashlib
import json
import shutil
import subprocess
import sys
from pathlib import Path

from benchmark import manifest

FORBIDDEN = {"jax", "jaxlib", "flax", "dreamscene_tpu"}


def test_manifest_keeps_the_rules():
    m = manifest.load()
    assert manifest.problems(m) == []
    assert len(json.dumps(m)) <= 64 * 1024
    assert m["command"][1:2] == ["benchmark/run.py"] and m["paths"] == ["benchmark"]


def test_every_cell_finds_its_files_by_name():
    m = manifest.load()
    for cell in m["workloads"]:
        cfg_path = manifest.config_file(m, cell["config"])
        assert cfg_path.is_file()
        assert json.loads(cfg_path.read_text())["name"] == cell["config"]
        traffic = json.loads(manifest.traffic_file(cell["traffic"]).read_text())
        assert manifest.driver_file(traffic["driver"]).is_file()
        limits = json.loads(manifest.limits_file(cell["name"]).read_text())
        for name, entry in limits.items():
            if name != "about":
                assert entry["limit"] > 0
        reported = manifest.metrics_of(m, cell["name"])
        for name in reported["end_to_end"] + reported["per_layer"]:
            assert manifest.metric_file(name).is_file(), name


def _imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_no_file_imports_jax_or_the_jax_package():
    for path in manifest.HERE.rglob("*.py"):
        assert not (_imports(path) & FORBIDDEN), path


def test_reference_imports_nothing_of_the_program():
    for path in (manifest.HERE / "reference").rglob("*.py"):
        bad = _imports(path) & (FORBIDDEN | {"dreamscene_tpu_torch"})
        assert not bad, (path, bad)


def test_top_level_names_are_compared_whole(monkeypatch):
    from benchmark import run

    monkeypatch.setitem(sys.modules, "dreamscene_tpu_torchlike", sys)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "dreamscene_tpu.ops", sys)
    assert run.forbidden_modules() == ["dreamscene_tpu"]


_ADDED_CELL = r'''
import json, sys
sys.path.insert(0, sys.argv[1]); sys.path.insert(2, sys.argv[2])
import torch
torch.set_num_threads(2)
from benchmark import manifest, run
from benchmark.tests import tiny
m = manifest.load()
assert manifest.problems(m) == [], manifest.problems(m)
cell = manifest.cell(m, "bench_tiny.render_fwd_bwd")
cfg = json.loads(manifest.config_file(m, "bench_tiny").read_text())
res = run.run_cell(m, cell, 12345, 0.2, True, device="cpu", cfg=cfg)
assert res["correct"] and "steps_seen" in res["metrics"], res
assert run.forbidden_modules() == [], run.forbidden_modules()
print("ok", manifest.HERE)
'''


def _digests(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_adding_a_config_cell_and_metric_needs_only_new_files(tmp_path):
    """In a copy, a new configuration, cell and metric go in as new files and
    new entries; every file already there stays byte for byte, and the new
    cell runs (on the CPU, tiny) with its new metric."""
    from benchmark.tests import tiny

    root = tmp_path / "checkout"
    shutil.copytree(manifest.HERE, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(manifest.MANIFEST, root / "BENCHMARK.json")
    before = _digests(root / "benchmark")
    m = manifest.load(root / "BENCHMARK.json")
    cfg = tiny.bench_cfg()
    cfg["name"] = "bench_tiny"
    (root / "benchmark/configs/bench_tiny.json").write_text(json.dumps(cfg))
    (root / "benchmark/metrics/steps_seen.py").write_text(
        '"""steps_seen: steps in the window."""\n\n\ndef read(ctx):\n'
        '    return ctx.window["steps"]\n')
    (root / "benchmark/limits/bench_tiny.render_fwd_bwd.json").write_text(json.dumps(
        {"out_gap": {"limit": 1e-3}, "grad_gap": {"limit": 1e-3}}))
    m["configs"].append({"name": "bench_tiny", "source": "https://example.org/tiny",
                         "file": "benchmark/configs/bench_tiny.json", "reduced": [],
                         "why": "a test's tiny copy"})
    m["workloads"].append({"name": "bench_tiny.render_fwd_bwd", "config": "bench_tiny",
                           "traffic": "render_fwd_bwd", "chips": 1, "why": "test"})
    m["per_layer"].append({"name": "steps_seen", "unit": "steps", "better": "higher",
                           "source": "host_clock", "layer": "harness", "moves": "peak_mem_gib",
                           "workloads": ["bench_tiny.render_fwd_bwd"]})
    (root / "BENCHMARK.json").write_text(json.dumps(m))
    out = subprocess.run([sys.executable, "-c", _ADDED_CELL, str(root),
                          str(manifest.ROOT)], capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert f"ok {root / 'benchmark'}" in out.stdout
    after = _digests(root / "benchmark")
    assert {k: v for k, v in after.items() if k in before} == before
    assert set(after) - set(before) == {"configs/bench_tiny.json", "metrics/steps_seen.py",
                                        "limits/bench_tiny.render_fwd_bwd.json"}
