"""BENCHMARK.json: loading, the character rules of its names, and where the
file of each configuration, traffic mix, metric and limit lies.

The harness finds everything by name, so a new configuration, cell or metric
is a new file and a new entry, never an edit of a file that is here.
"""

from __future__ import annotations

import json
import re
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
MANIFEST = ROOT / "BENCHMARK.json"

NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH_RE = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
            "per_layer"}
CONFIG_KEYS = {"name", "source", "file", "reduced", "why"}
CELL_KEYS = {"name", "config", "traffic", "chips", "why"}
E2E_KEYS = {"name", "unit", "better", "bound", "source"}
LAYER_KEYS = {"name", "unit", "better", "source", "layer", "moves"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def load(path: Path = MANIFEST) -> dict:
    return json.loads(Path(path).read_text())


def _line(s) -> bool:
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def problems(m: dict) -> list[str]:
    """Every breach of the manifest's shape and character rules (empty when
    it keeps them)."""
    out = []
    if set(m) != TOP_KEYS:
        out.append(f"top-level keys {sorted(m)}")
    if not (isinstance(m.get("run_seconds"), int) and 1 <= m["run_seconds"] <= 51):
        out.append("run_seconds")
    cmd = m.get("command", [])
    if not (1 <= len(cmd) <= 32 and all(_line(w) for w in cmd)):
        out.append("command")
    paths = m.get("paths", [])
    if not (1 <= len(paths) <= 16) or any(
            not PATH_RE.match(p) or p.startswith("/") or ".." in p.split("/") for p in paths):
        out.append("paths")
    names = set()
    for group, keys in (("configs", CONFIG_KEYS), ("workloads", CELL_KEYS),
                        ("end_to_end", E2E_KEYS), ("per_layer", LAYER_KEYS)):
        for e in m.get(group, []):
            extra = set(e) - keys - ({"workloads"} if group in ("end_to_end", "per_layer")
                                     else set())
            if set(keys) - set(e) or extra:
                out.append(f"{group} entry {e.get('name')}: keys {sorted(e)}")
            name = e.get("name", "")
            if not NAME_RE.match(name):
                out.append(f"{group} name {name!r}")
            key = (group if group in ("configs", "workloads") else "metrics", name)
            if key in names:
                out.append(f"duplicate {key}")
            names.add(key)
    for c in m.get("configs", []):
        if not (_line(c.get("source")) and _line(c.get("why"))):
            out.append(f"config {c.get('name')}: source / why")
        if not (isinstance(c.get("reduced"), list) and len(c["reduced"]) <= 16
                and all(NAME_RE.match(k) for k in c["reduced"])):
            out.append(f"config {c.get('name')}: reduced")
        if not str(c.get("file", "")).startswith(tuple(p.rstrip("/") + "/" for p in paths)):
            out.append(f"config {c.get('name')}: file outside paths")
    config_names = {c["name"] for c in m.get("configs", [])}
    pairs = set()
    for w in m.get("workloads", []):
        if w.get("config") not in config_names:
            out.append(f"cell {w.get('name')}: config {w.get('config')}")
        if not NAME_RE.match(str(w.get("traffic", ""))):
            out.append(f"cell {w.get('name')}: traffic")
        if w.get("chips") not in (1, 4):
            out.append(f"cell {w.get('name')}: chips")
        if not _line(w.get("why")):
            out.append(f"cell {w.get('name')}: why")
        pair = (w.get("config"), w.get("traffic"))
        if pair in pairs:
            out.append(f"cell {w.get('name')}: pair {pair} twice")
        pairs.add(pair)
    used = {w.get("config") for w in m.get("workloads", [])}
    if config_names - used:
        out.append(f"configs without a cell: {sorted(config_names - used)}")
    cells = {w["name"] for w in m.get("workloads", [])}
    e2e = {e["name"]: e for e in m.get("end_to_end", [])}
    if "setup_s" not in e2e:
        out.append("no setup_s")
    for e in m.get("end_to_end", []) + m.get("per_layer", []):
        if not UNIT_RE.match(str(e.get("unit", ""))):
            out.append(f"metric {e.get('name')}: unit")
        if e.get("better") not in ("lower", "higher"):
            out.append(f"metric {e.get('name')}: better")
        if e.get("source") not in SOURCES:
            out.append(f"metric {e.get('name')}: source")
        if set(e.get("workloads", cells)) - cells:
            out.append(f"metric {e.get('name')}: workloads")
    for e in m.get("end_to_end", []):
        if e.get("source") not in ("host_clock", "device_trace"):
            out.append(f"metric {e['name']}: end-to-end source")
        if not (isinstance(e.get("bound"), (int, float)) and 0.01 <= e["bound"] <= 0.25):
            out.append(f"metric {e['name']}: bound")
    for e in m.get("per_layer", []):
        if not _line(e.get("layer")):
            out.append(f"metric {e['name']}: layer")
        if e.get("moves") not in e2e:
            out.append(f"metric {e['name']}: moves {e.get('moves')}")
    for cell in cells:
        reported = metrics_of(m, cell)
        if "setup_s" not in reported["end_to_end"] or len(reported["end_to_end"]) < 2:
            out.append(f"cell {cell}: end-to-end metrics {reported['end_to_end']}")
        if not reported["per_layer"]:
            out.append(f"cell {cell}: no per-layer metric")
    return out


def cell(m: dict, name: str) -> dict:
    for w in m["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload named {name!r} in BENCHMARK.json")


def config_entry(m: dict, name: str) -> dict:
    for c in m["configs"]:
        if c["name"] == name:
            return c
    raise KeyError(f"no configuration named {name!r} in BENCHMARK.json")


def metrics_of(m: dict, cell_name: str) -> dict:
    """The end-to-end and per-layer metric names a cell reports: those that
    list it under `workloads`, or that list no cells. A per-layer metric
    without `workloads` goes with every cell that reports the metric it
    moves."""
    def listed(e):
        return cell_name in e.get("workloads", [cell_name])

    e2e = [e["name"] for e in m["end_to_end"] if listed(e)]
    layer = [e["name"] for e in m["per_layer"]
             if listed(e) and ("workloads" in e or e["moves"] in e2e)]
    return {"end_to_end": e2e, "per_layer": layer}


def metric_entry(m: dict, name: str) -> dict:
    for e in m["end_to_end"] + m["per_layer"]:
        if e["name"] == name:
            return e
    raise KeyError(name)


def config_file(m: dict, name: str) -> Path:
    return ROOT / config_entry(m, name)["file"]


def traffic_file(name: str) -> Path:
    return HERE / "traffic" / f"{name}.json"


def metric_file(name: str) -> Path:
    return HERE / "metrics" / f"{name}.py"


def limits_file(cell_name: str) -> Path:
    return HERE / "limits" / f"{cell_name}.json"


def driver_file(name: str) -> Path:
    return HERE / "drivers" / f"{name}.py"
