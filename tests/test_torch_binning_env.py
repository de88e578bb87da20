"""The binning knobs: DS_TILE_W / DS_TILE_H (tile shape) and
DS_EXPAND_BLOCK (K3's window block), read at import by both packages.

Each case runs in a subprocess with the variables set before either
package is imported, then bins the same numpy splats through the JAX
package's `bin_splats` (Pallas K3 in interpret mode) and the port's (plain
versions), both with no tile arguments so that the variables decide.

Tolerance: every integer output bit-equal (keys, gids, `pos_of_entry`,
chunk metadata, `n_entries`, `n_dropped`).
"""

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent

CHILD = r"""
import sys
import numpy as np
import jax.numpy as jnp
import torch

torch.set_num_threads(1)
from dreamscene_tpu.ops import binning as jbin
from dreamscene_tpu_torch.ops import binning as tbin
from dreamscene_tpu_torch.ops import expand as texp
from tests.test_torch_binning import INT_FIELDS, projected

tw, th, block = (int(a) for a in sys.argv[1:4])
assert (tbin.DEFAULT_TILE_W, tbin.DEFAULT_TILE_H) == (jbin.DEFAULT_TILE_W, jbin.DEFAULT_TILE_H)
assert (tbin.DEFAULT_TILE_W, tbin.DEFAULT_TILE_H, texp.BLOCK) == (tw, th, block)
assert jbin._EXPAND_BLOCK == block
width, height, n = 96, 64, 200
means, depths, radii, vis, conics, opac = projected(n, width, height, seed=4)
# slots well past the last entry: their owners depend on the window block
kw = dict(width=width, height=height, capacity=3000, chunk=128)
jb = jbin.bin_splats(jnp.asarray(means), jnp.asarray(depths), jnp.asarray(radii),
                     jnp.asarray(vis), conics=jnp.asarray(conics),
                     opacities=jnp.asarray(opac), interpret=True, **kw)
tb = tbin.bin_splats(torch.from_numpy(means), torch.from_numpy(depths),
                     torch.from_numpy(radii), torch.from_numpy(vis),
                     conics=torch.from_numpy(conics), opacities=torch.from_numpy(opac), **kw)
assert int(tb.n_entries) < 3000 // 2
for f in INT_FIELDS:
    np.testing.assert_array_equal(getattr(tb, f).numpy(), np.asarray(getattr(jb, f)),
                                  err_msg=f)
n_tiles = -(-width // tw) * -(-height // th)
assert int(tb.chunk_tile.max()) == n_tiles
print("ok", int(tb.n_entries), int(tb.n_chunks_used))
"""


@pytest.mark.parametrize("env", [
    {"DS_TILE_W": "16", "DS_TILE_H": "16", "DS_EXPAND_BLOCK": "1024"},
    {"DS_EXPAND_BLOCK": "384"},
], ids=["16x16 block 1024", "32x16 block 384"])
def test_bin_splats_follows_the_knobs_like_jax(env):
    child_env = {k: v for k, v in os.environ.items()
                 if k not in ("DS_TILE_W", "DS_TILE_H", "DS_EXPAND_BLOCK")}
    child_env.update(env)
    child_env["PYTHONPATH"] = os.pathsep.join([str(ROOT), child_env.get("PYTHONPATH", "")])
    tw, th = int(env.get("DS_TILE_W", 32)), int(env.get("DS_TILE_H", 16))
    block = int(env.get("DS_EXPAND_BLOCK", 2048))
    res = subprocess.run([sys.executable, "-c", CHILD, str(tw), str(th), str(block)],
                         cwd=ROOT, env=child_env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.startswith("ok"), res.stdout


def test_expand_geometry_names_the_knob():
    """K3 takes any positive multiple of 128 slots; anything else raises
    with the variable's name."""
    from dreamscene_tpu_torch.ops import expand as E

    args = dict(capacity=4096, n=100, n_tiles=16, tiles_x=4, shift=7, rank_drop=0,
                use_cull=True, tile_w=32, tile_h=16)
    for block in (128, 384, 1024, 2048):
        assert E.expand_geometry(block=block, **args).block == block
    for block in (64, 200, 0):
        with pytest.raises(ValueError, match="DS_EXPAND_BLOCK"):
            E.expand_geometry(block=block, **args)
