"""Per-experiment observability: log-file sink + config snapshot.

Matches the reference's startup bookkeeping (reference:
training/scene_trainer.py:56-65, 254-259 — loguru sinks to
experiments/<exp>/log.txt at DEBUG plus a config snapshot saved at init)
so a failed overnight run leaves an on-disk record of what configuration
produced it.
"""

from __future__ import annotations

import dataclasses
import logging
from pathlib import Path

import yaml

logger = logging.getLogger("dreamscene_tpu_torch")


def _to_plain(obj):
    """Recursively convert the dataclass config tree to YAML-able plain
    python (dicts/lists/scalars)."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {
            f.name: _to_plain(getattr(obj, f.name))
            for f in dataclasses.fields(obj)
        }
    if isinstance(obj, dict):
        return {k: _to_plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_to_plain(v) for v in obj]
    if isinstance(obj, Path):
        return str(obj)
    return obj


def setup_experiment_logging(exp_path: str | Path, cfg=None) -> Path:
    """Attach a DEBUG file sink at <exp_path>/log.txt (idempotent per
    path) and snapshot `cfg` to <exp_path>/config_snapshot.yaml."""
    exp_path = Path(exp_path)
    exp_path.mkdir(parents=True, exist_ok=True)
    log_file = exp_path / "log.txt"

    target = str(log_file.resolve())
    have = False
    for h in list(logger.handlers):
        if not getattr(h, "_dreamscene_exp_sink", False):
            continue
        if getattr(h, "baseFilename", None) == target:
            have = True
        else:
            # one live experiment sink per process: drop stale ones so
            # repeated trainer construction (tests) doesn't leak handles
            logger.removeHandler(h)
            h.close()
    if not have:
        fh = logging.FileHandler(log_file)
        fh._dreamscene_exp_sink = True
        fh.setLevel(logging.DEBUG)
        fh.setFormatter(logging.Formatter(
            "%(asctime)s | %(levelname)s | %(name)s | %(message)s"
        ))
        logger.addHandler(fh)
        if logger.level in (logging.NOTSET, logging.WARNING):
            # the file sink needs the logger to pass DEBUG records, but
            # lowering the logger level must not flood OTHER handlers:
            # pin any level-less root handlers to their current
            # effective threshold first
            eff = logger.getEffectiveLevel()
            for rh in logging.getLogger().handlers:
                if rh.level == logging.NOTSET:
                    rh.setLevel(eff if eff != logging.NOTSET
                                else logging.WARNING)
            logger.setLevel(logging.DEBUG)

    if cfg is not None:
        # write-once per PROCESS and experiment: a scene run constructs
        # one ObjectTrainer per object with per-object cfg mutations —
        # the snapshot must keep recording the config that STARTED this
        # run (a fresh process re-records over a stale snapshot)
        snap = exp_path / "config_snapshot.yaml"
        if str(snap) not in _SNAPSHOTTED:
            _SNAPSHOTTED.add(str(snap))
            with open(snap, "w") as f:
                yaml.safe_dump(_to_plain(cfg), f, sort_keys=False)
            logger.debug("config snapshot written to %s", snap)
    return log_file


_SNAPSHOTTED: set[str] = set()
