"""The port's own copies of the JAX package's host code (config loading,
the entry-capacity controller) give the same results as the originals.
Exact equality: both are plain Python/numpy with the same arithmetic."""

import dataclasses
from pathlib import Path

import numpy as np
import pytest

from dreamscene_tpu.training.capacity import CapacityController as JCap
from dreamscene_tpu.utils.config import load_config as j_load_config
from dreamscene_tpu_torch.training.capacity import CapacityController as TCap
from dreamscene_tpu_torch.utils.config import load_config as t_load_config

CONFIGS = sorted((Path(__file__).resolve().parent.parent / "configs").rglob("*.yaml"))


@pytest.mark.parametrize("path", CONFIGS, ids=[p.name for p in CONFIGS])
def test_load_config_matches_jax(path):
    object_mode = path.parent.name == "objects"
    dotlist = ["seed=7", "guidanceParams.C_batch_size=2"]
    got = t_load_config(str(path), dotlist, object_mode=object_mode)
    want = j_load_config(str(path), dotlist, object_mode=object_mode)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_capacity_controller_matches_jax():
    rng = np.random.default_rng(0)
    t, j = TCap(), JCap()
    assert t.HARD_CAP == j.HARD_CAP
    n = 60_000
    mults = set()
    for _ in range(300):
        # demand around the current capacity: some steps overflow (grow),
        # runs of light steps shrink
        demand = int(j.capacity(n) * rng.uniform(0.1, 1.3))
        n_entries = min(demand, j.capacity(n))
        n_dropped = demand - n_entries
        assert t.update(n, n_entries, n_dropped) == j.update(n, n_entries, n_dropped)
        assert (t.mult, t.capacity(n)) == (j.mult, j.capacity(n))
        mults.add(j.mult)
    assert len(mults) > 3
    assert t.capacity(2_000_000) == j.capacity(2_000_000)
