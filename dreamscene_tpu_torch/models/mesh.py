"""Mesh extraction from the splat occupancy field (marching tetrahedra).

The port's own copy of dreamscene_tpu/models/mesh.py (numpy, line for
line; the nearest-splat colours read a torch GaussianState). The
reference stops at the occupancy grid (gs_renderer.py:491-573
extract_fields); this module turns `models.fields.extract_fields` output
into a watertight triangle mesh with per-vertex colors, exportable to
OBJ/PLY, so a trained object or scene can leave the splat ecosystem.

Marching TETRAHEDRA rather than marching cubes: each grid cell splits
into 6 tetrahedra around the main diagonal; per-tet surface extraction
needs only a 16-case table (vs 256) and produces no ambiguous/holed
configurations. Fully vectorized numpy: host-side post-processing.
"""

from __future__ import annotations

import numpy as np

from dreamscene_tpu_torch.models.fields import extract_fields
from dreamscene_tpu_torch.ops.sh import SH2RGB

# 6 tetrahedra covering the unit cube, all sharing the 0-6 diagonal.
# Cube corner order: (x,y,z) bits -> index x + 2y + 4z.
_TETS = np.array([
    [0, 5, 1, 6],
    [0, 1, 2, 6],
    [0, 2, 3, 6],
    [0, 3, 7, 6],
    [0, 7, 4, 6],
    [0, 4, 5, 6],
], np.int32)
_CORNER = np.array([
    [0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
    [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1],
], np.int32)
# tet edges (local vertex pairs), referenced by the case table
_EDGES = np.array(
    [[0, 1], [0, 2], [0, 3], [1, 2], [1, 3], [2, 3]], np.int32)
# case -> triangles as edge-index triples (-1 padded); bit i set = vertex
# i inside. Orientation keeps outward normals for "inside > thresh".
_CASES = [
    [],                                   # 0000
    [[0, 2, 1]],                          # 0001  v0
    [[0, 3, 4]],                          # 0010  v1
    [[1, 3, 4], [1, 4, 2]],               # 0011  v0 v1
    [[1, 5, 3]],                          # 0100  v2
    [[0, 2, 5], [0, 5, 3]],               # 0101  v0 v2
    [[0, 1, 5], [0, 5, 4]],               # 0110  v1 v2
    [[2, 5, 4]],                          # 0111  v0 v1 v2
    [[2, 4, 5]],                          # 1000  v3
    [[0, 4, 5], [0, 5, 1]],               # 1001  v0 v3
    [[0, 5, 3], [0, 2, 5]],               # 1010  v1 v3  (quad 0-2-5-3)
    [[1, 5, 3]],                          # 1011  v0 v1 v3  (missing v2)
    [[1, 4, 2], [1, 3, 4]],               # 1100  v2 v3
    [[0, 3, 4]],                          # 1101  v0 v2 v3
    [[0, 1, 2]],                          # 1110  v1 v2 v3
    [],                                   # 1111
]
# NOTE: complements reuse the same cut edges with flipped winding; the
# tables above were written pairwise (case c and 15-c share edges).


def marching_tetrahedra(grid: np.ndarray, thresh: float,
                        origin=(-1.0, -1.0, -1.0), spacing=None):
    """grid [R,R,R] scalar field -> (verts [V,3] float32, faces [F,3]
    int32). Vertices are interpolated to the iso-surface crossing and
    deduplicated exactly (edge-keyed)."""
    r = grid.shape[0]
    assert grid.shape == (r, r, r)
    if spacing is None:
        spacing = 2.0 / (r - 1)
    origin = np.asarray(origin, np.float64)

    cells = r - 1
    base = np.stack(np.meshgrid(
        np.arange(cells), np.arange(cells), np.arange(cells),
        indexing="ij"), -1).reshape(-1, 3)          # [C,3] cell coords

    # global grid-vertex id of each cube corner for each cell: [C, 8]
    cid = base[:, None, :] + _CORNER[None, :, :]    # [C,8,3]
    gid = (cid[..., 0] * r + cid[..., 1]) * r + cid[..., 2]
    vals = grid.reshape(-1)[gid]                    # [C,8]

    flat = grid.reshape(-1)
    all_keys = []
    for t in range(6):
        tl = _TETS[t]
        tv = vals[:, tl]                            # [C,4]
        tg = gid[:, tl]                             # [C,4] global ids
        inside = (tv > thresh).astype(np.int32)
        case = (inside * np.array([1, 2, 4, 8])).sum(1)   # [C]
        for c in range(1, 15):
            tris = _CASES[c]
            if not tris:
                continue
            sel = np.nonzero(case == c)[0]
            if sel.size == 0:
                continue
            for tri in tris:
                # three edges -> three interpolated vertices
                e = _EDGES[np.asarray(tri)]          # [3,2] local verts
                ga = tg[sel][:, e[:, 0]]             # [S,3] global id a
                gb = tg[sel][:, e[:, 1]]
                # canonical edge key (sorted pair)
                lo = np.minimum(ga, gb)
                hi = np.maximum(ga, gb)
                key = lo.astype(np.int64) * (r * r * r) + hi
                all_keys.append(key)          # [S,3] per-face edge keys

    if not all_keys:
        return (np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32))

    keys = np.concatenate([k.reshape(-1, 3) for k in all_keys]).reshape(-1)
    uniq, inv = np.unique(keys, return_inverse=True)

    # interpolate unique edge vertices
    n3 = r * r * r
    a = (uniq // n3).astype(np.int64)
    b = (uniq % n3).astype(np.int64)
    va, vb = flat[a], flat[b]
    tpar = np.clip((thresh - va) / np.where(vb == va, 1.0, vb - va), 0, 1)
    pa = np.stack([a // (r * r), (a // r) % r, a % r], -1).astype(np.float64)
    pb = np.stack([b // (r * r), (b // r) % r, b % r], -1).astype(np.float64)
    verts = (origin + (pa + (pb - pa) * tpar[:, None]) * spacing).astype(
        np.float32)

    faces = inv.reshape(-1, 3).astype(np.int32)
    # drop degenerate faces (two corners collapsed to the same vertex)
    good = ((faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2])
            & (faces[:, 0] != faces[:, 2]))
    faces = faces[good]

    # orient every face outward (normal opposing the field gradient —
    # inside is field > thresh) instead of trusting per-case windings
    gx, gy, gz = np.gradient(grid.astype(np.float64))
    cent = verts[faces].mean(axis=1)                 # [F,3] world coords
    gidx = np.clip(np.rint((cent - origin) / spacing), 0, r - 1).astype(int)
    gvec = np.stack([g[gidx[:, 0], gidx[:, 1], gidx[:, 2]]
                     for g in (gx, gy, gz)], -1)
    e1 = verts[faces[:, 1]] - verts[faces[:, 0]]
    e2 = verts[faces[:, 2]] - verts[faces[:, 0]]
    nrm = np.cross(e1, e2)
    flip = (nrm * gvec).sum(1) > 0
    faces[flip] = faces[flip][:, [0, 2, 1]]
    return verts, faces


def color_vertices(state, verts: np.ndarray) -> np.ndarray:
    """Per-vertex RGB from the nearest active splat's DC color."""
    from scipy.spatial import cKDTree

    active = state.aux["active"].cpu().numpy()
    xyz = state.get_xyz.detach().cpu().numpy()[active]
    dc = state.params["features_dc"].detach().cpu().numpy()[active][:, 0]
    if xyz.shape[0] == 0 or verts.shape[0] == 0:
        return np.full((verts.shape[0], 3), 0.5, np.float32)
    _, idx = cKDTree(xyz).query(verts, k=1)
    rgb = np.asarray(SH2RGB(dc[idx]))
    return np.clip(rgb, 0.0, 1.0).astype(np.float32)


def export_mesh(state, path: str, resolution: int = 128,
                thresh: float = 1.0, num_blocks: int = 16) -> dict:
    """Occupancy -> colored mesh file (.obj or .ply by extension).
    Returns {"n_verts", "n_faces"}."""
    grid = extract_fields(state, resolution=resolution, num_blocks=num_blocks)
    verts, faces = marching_tetrahedra(grid, thresh)
    cols = color_vertices(state, verts)
    if path.endswith(".ply"):
        _write_ply(path, verts, faces, cols)
    else:
        _write_obj(path, verts, faces, cols)
    return {"n_verts": int(verts.shape[0]), "n_faces": int(faces.shape[0])}


def _write_obj(path, verts, faces, cols):
    with open(path, "w") as f:
        for v, c in zip(verts, cols):
            f.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f} "
                    f"{c[0]:.4f} {c[1]:.4f} {c[2]:.4f}\n")
        for a, b, c3 in faces + 1:
            f.write(f"f {a} {b} {c3}\n")


def _write_ply(path, verts, faces, cols):
    with open(path, "wb") as f:
        hdr = (
            "ply\nformat binary_little_endian 1.0\n"
            f"element vertex {len(verts)}\n"
            "property float x\nproperty float y\nproperty float z\n"
            "property uchar red\nproperty uchar green\nproperty uchar blue\n"
            f"element face {len(faces)}\n"
            "property list uchar int vertex_indices\nend_header\n"
        )
        f.write(hdr.encode())
        vrec = np.zeros(len(verts), dtype=[
            ("xyz", np.float32, 3), ("rgb", np.uint8, 3)])
        vrec["xyz"] = verts
        vrec["rgb"] = (cols * 255).astype(np.uint8)
        f.write(vrec.tobytes())
        frec = np.zeros(len(faces), dtype=[
            ("n", np.uint8), ("idx", np.int32, 3)])
        frec["n"] = 3
        frec["idx"] = faces
        f.write(frec.tobytes())
