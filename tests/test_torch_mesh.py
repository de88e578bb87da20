"""Mesh export: the port's occupancy field (`models/fields.py`) and its
own copy of marching tetrahedra and the mesh writers (`models/mesh.py`)
against the JAX package on a seeded splat state.

Tolerances: gaussian_3d_coeff atol 1e-6; the occupancy grid atol
1e-5 * max|occ| (the same splats are culled on the host in both; the
per-block sums run in a different order); marching tetrahedra bit-equal on
the same grid; the written meshes parse back to the counts returned.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from dreamscene_tpu.models import fields as JF
from dreamscene_tpu.models import gaussians as JG
from dreamscene_tpu.models import mesh as JM
from dreamscene_tpu_torch import convert
from dreamscene_tpu_torch.models import fields as TF
from dreamscene_tpu_torch.models import mesh as TM

torch.set_num_threads(1)


def seeded_states(n=300, capacity=320):
    """A JAX state of `n` splats in a ball of radius 0.6 (varied scales,
    rotations, opacities, colours; a few inactive rows) and its port copy."""
    rng = np.random.RandomState(0)
    pts = (rng.randn(n, 3) * 0.3).astype(np.float32)
    st = JG.create_from_points(pts, rng.rand(n, 3).astype(np.float32), sh_degree=1,
                               capacity=capacity)
    p = st.params
    p = dataclasses.replace(
        p, opacity=jnp.asarray(np.asarray(p.opacity) + 2 * rng.randn(capacity, 1).astype(np.float32)),
        scaling=jnp.asarray(np.log(0.05) + 0.5 * rng.randn(capacity, 3).astype(np.float32)),
        rotation=jnp.asarray(rng.randn(capacity, 4).astype(np.float32)))
    active = np.asarray(st.aux.active) & (np.arange(capacity) % 17 != 5)
    st = dataclasses.replace(st, params=p,
                             aux=dataclasses.replace(st.aux, active=jnp.asarray(active)))
    return st, convert.state_from(st)


@pytest.fixture(scope="module")
def states():
    return seeded_states()


@pytest.fixture(scope="module")
def grids(states):
    jst, tst = states
    return (np.asarray(JF.extract_fields(jst, resolution=24, num_blocks=4)),
            TF.extract_fields(tst, resolution=24, num_blocks=4))


def test_gaussian_3d_coeff_matches_jax():
    rng = np.random.RandomState(1)
    xyz = rng.randn(500, 3).astype(np.float32) * 0.2
    a = rng.randn(500, 3, 3).astype(np.float32) * 0.2
    cov = np.einsum("nij,nkj->nik", a, a) + 1e-3 * np.eye(3, dtype=np.float32)
    cov6 = cov[:, [0, 0, 0, 1, 1, 2], [0, 1, 2, 1, 2, 2]]
    ref = np.asarray(JF.gaussian_3d_coeff(jnp.asarray(xyz), jnp.asarray(cov6)))
    got = TF.gaussian_3d_coeff(torch.from_numpy(xyz), torch.from_numpy(cov6)).numpy()
    assert (ref > 1e-3).sum() > 50
    np.testing.assert_allclose(got, ref, atol=1e-6)


def test_block_culls_select_the_jax_loops_splats(states):
    """The slab-narrowed cull keeps, block for block, exactly the splats
    that the JAX package's per-block test (models/fields.py:72-80) keeps,
    also with a few splats large enough to reach many blocks."""
    _, tst = states
    xyz = tst.get_xyz.numpy()
    max_scale = tst.get_scaling.amax(-1).numpy()
    max_scale[::37] *= 8.0
    opac = (tst.get_opacity[:, 0] * tst.aux["active"]).numpy()
    got = dict(TF.block_culls(xyz, max_scale, opac, 8, 1.5))
    block_size, want = 2.0 / 8, {}
    for xi in range(8):
        for yi in range(8):
            for zi in range(8):
                center = np.array([xi, yi, zi]) * block_size - 1.0 + block_size / 2
                d = np.linalg.norm(xyz - center, axis=-1)
                idx = np.nonzero((d <= block_size * 0.87 + 1.5 * max_scale) & (opac > 0))[0]
                if idx.size:
                    want[(xi, yi, zi)] = idx
    assert list(got) == list(want)
    sizes = [len(v) for v in want.values()]
    assert 0 < min(sizes) < max(sizes) < len(xyz)
    for k, idx in want.items():
        np.testing.assert_array_equal(got[k], idx, err_msg=str(k))


def test_extract_fields_matches_jax(grids):
    ref, got = grids
    assert got.shape == ref.shape == (24, 24, 24) and got.dtype == np.float32
    top = float(np.abs(ref).max())
    assert top > 1.0 and (ref == 0).any()     # splats reach the threshold; culled blocks
    np.testing.assert_allclose(got, ref, atol=1e-5 * top, rtol=0)


def test_marching_tetrahedra_bit_equal(grids):
    ref, _ = grids
    for thresh in (0.5, 1.0):
        jv, jf = JM.marching_tetrahedra(ref, thresh)
        tv, tf = TM.marching_tetrahedra(ref, thresh)
        assert len(jf) > 100
        np.testing.assert_array_equal(tv, jv)
        np.testing.assert_array_equal(tf, jf)


@pytest.mark.parametrize("suffix", [".ply", ".obj"])
def test_export_mesh_writes_files_that_parse(tmp_path, states, suffix):
    jst, tst = states
    path = tmp_path / f"mesh{suffix}"
    info = TM.export_mesh(tst, str(path), resolution=24, thresh=0.5, num_blocks=4)
    jinfo = JM.export_mesh(jst, str(tmp_path / f"jax{suffix}"), resolution=24, thresh=0.5,
                           num_blocks=4)
    assert info["n_faces"] > 100 and abs(info["n_faces"] - jinfo["n_faces"]) <= 8
    if suffix == ".ply":
        data = path.read_bytes()
        header, body = data.split(b"end_header\n", 1)
        lines = header.decode().split("\n")
        assert lines[:2] == ["ply", "format binary_little_endian 1.0"]
        nv = int(lines[2].split()[-1])
        nf = int(next(l for l in lines if l.startswith("element face")).split()[-1])
        vrec = np.frombuffer(body[:nv * 15], dtype=[("xyz", "<f4", 3), ("rgb", "u1", 3)])
        frec = np.frombuffer(body[nv * 15:], dtype=[("n", "u1"), ("idx", "<i4", 3)])
        assert len(frec) == nf and (frec["n"] == 3).all()
        faces, verts = frec["idx"], vrec["xyz"]
    else:
        rows = [l.split() for l in path.read_text().splitlines()]
        verts = np.array([[float(x) for x in r[1:4]] for r in rows if r[0] == "v"])
        faces = np.array([[int(x) - 1 for x in r[1:]] for r in rows if r[0] == "f"])
        nv, nf = len(verts), len(faces)
    assert (nv, nf) == (info["n_verts"], info["n_faces"])
    assert faces.min() >= 0 and faces.max() < nv
    assert np.all(np.abs(verts) <= 1.0 + 1e-6)
