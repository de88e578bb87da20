"""Tiny versions of the cells' configurations, for CPU tests: the same code
paths at sizes a test run holds (the plain versions run on the CPU)."""

from __future__ import annotations

import copy
import json

from benchmark import manifest


def object_cfg(m: dict | None = None) -> dict:
    m = m or manifest.load()
    cfg = copy.deepcopy(json.loads(manifest.config_file(m, "object_sd21").read_text()))
    p = cfg["program"]
    p["objectParams"]["num_pts"] = 300
    p["generateCamParams"]["image_w"] = p["generateCamParams"]["image_h"] = 32
    p["guidanceParams"]["C_batch_size"] = 2
    p["optimizationParams"]["max_point_number"] = 4096
    cfg["unet"].update(block_out_channels=[32, 64], layers_per_block=1,
                       cross_attention_dim=32, attention_head_dim=16, num_groups=8,
                       with_cross_attn=[True, False], dtype="float32")
    cfg["vae"].update(block_out_channels=[32, 32], layers_per_block=1, num_groups=8,
                      dtype="float32")
    cfg["token_len"] = 4
    return cfg


# the render cell, measured but kept out of BENCHMARK.json (PERF.md, Open
# questions): its files are here, ready for a manifest entry
BENCH_CELL = {"name": "bench_300k.render_fwd_bwd", "config": "bench_300k",
              "traffic": "render_fwd_bwd", "chips": 1}


def config(name: str) -> dict:
    """A configuration file by name, in the manifest or not."""
    return json.loads((manifest.HERE / "configs" / f"{name}.json").read_text())


def bench_cfg(m: dict | None = None) -> dict:
    cfg = config("bench_300k")
    cfg["scene"]["n_splats"] = 2000
    cfg["camera"].update(width=64, height=48)
    cfg["render"].update(chunk=128, capacity=20000)
    return cfg


def traffic(name: str, **over) -> dict:
    t = json.loads(manifest.traffic_file(name).read_text())
    t.update(over)
    return t


def outdoor_cfg(m: dict | None = None) -> dict:
    """BASELINE config #5 (the outdoor scene) at a CPU test's size: the
    repository's sample_outdoor.yaml with two 40-point objects, 32x32
    renders, C_batch 2, env density 0.0005, the tiny guidance stack."""
    import yaml

    base = object_cfg(m)
    program = yaml.safe_load((manifest.ROOT / "configs" / "scenes" /
                              "sample_outdoor.yaml").read_text())
    program["scene_configs"]["objects"] = [
        {"id": "steve", "init_guided": "default", "num_pts": 40},
        {"id": "creeper", "init_guided": "default", "num_pts": 40}]
    program["scene_configs"]["scene"]["compress_n_views"] = 4
    for sec, kv in (("sceneOptimizationParams", {"iterations": 2}),
                    ("optimizationParams", {"iterations": 2}),
                    ("reconOptimizationParams", {"iterations": 1}),
                    ("guidanceParams", {"C_batch_size": 2}),
                    ("generateCamParams", {"image_w": 32, "image_h": 32}),
                    ("sceneGenerateCamParams", {"image_w": 32, "image_h": 32})):
        program.setdefault(sec, {}).update(kv)
    return {"name": "outdoor_tiny", "program": program, "env_density": 0.0005,
            "unet": base["unet"], "vae": base["vae"], "token_len": base["token_len"],
            "program_env": {}}
