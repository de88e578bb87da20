"""PLY import/export of splat models and point clouds, torch.

Port of dreamscene_tpu/models/ply.py: the same attribute list and
channel-major f_dc/f_rest order (reference gs_renderer.py:727-760), so a
file written here is byte-for-byte the file the JAX package writes for
the same state, and either package loads the other's. Hand-rolled
binary-little-endian writer/reader (ascii read supported too).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from dreamscene_tpu_torch.device import resolve_device
from dreamscene_tpu_torch.models.gaussians import GaussianState, adam_init

_TYPE_MAP = {
    "float": "<f4", "float32": "<f4", "double": "<f8", "uchar": "u1", "uint8": "u1",
    "int": "<i4", "uint": "<u4", "short": "<i2", "ushort": "<u2", "char": "i1",
}


def _ply_header(n: int, props: list[str]) -> bytes:
    lines = ["ply", "format binary_little_endian 1.0", f"element vertex {n}"]
    lines += [f"property float {p}" for p in props]
    lines.append("end_header")
    return ("\n".join(lines) + "\n").encode("ascii")


def splat_property_names(sh_degree: int) -> list[str]:
    k = (sh_degree + 1) ** 2
    return (["x", "y", "z", "nx", "ny", "nz"] + [f"f_dc_{i}" for i in range(3)]
            + [f"f_rest_{i}" for i in range(3 * (k - 1))] + ["opacity"]
            + [f"scale_{i}" for i in range(3)] + [f"rot_{i}" for i in range(4)])


def save_splat_ply(path: str, state: GaussianState) -> None:
    """Write the active splats' raw (pre-activation) values (reference
    save_ply, gs_renderer.py:727-752)."""
    idx = np.nonzero(state.aux["active"].cpu().numpy())[0]

    def rows(name):
        return state.params[name].detach().cpu().numpy()[idx]

    xyz = rows("xyz")
    n = xyz.shape[0]
    # channel-major flatten: [N, K, 3] -> [N, 3, K] -> [N, 3K]
    f_dc = rows("features_dc").transpose(0, 2, 1).reshape(n, -1)
    f_rest = rows("features_rest").transpose(0, 2, 1).reshape(n, -1)
    data = np.concatenate([xyz, np.zeros_like(xyz), f_dc, f_rest, rows("opacity"),
                           rows("scaling"), rows("rotation")], axis=1).astype("<f4")
    props = splat_property_names(state.sh_degree)
    assert data.shape[1] == len(props), (data.shape, len(props))
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(_ply_header(n, props))
        f.write(data.tobytes())


def _parse_ply(path: str):
    """Minimal PLY reader: returns (names, [N, P] float32 data). Supports
    binary_little_endian and ascii, scalar properties of the vertex
    element."""
    with open(path, "rb") as f:
        header = b""
        while not header.endswith(b"end_header\n"):
            line = f.readline()
            if not line:
                raise ValueError(f"bad PLY header in {path}")
            header += line
        fmt, n, names, types, in_vertex = None, 0, [], [], False
        for ln in header.decode("ascii").strip().split("\n"):
            parts = ln.split()
            if not parts:
                continue
            if parts[0] == "format":
                fmt = parts[1]
            elif parts[0] == "element":
                in_vertex = parts[1] == "vertex"
                if in_vertex:
                    n = int(parts[2])
            elif parts[0] == "property" and in_vertex:
                if parts[1] == "list":
                    raise ValueError("list properties unsupported")
                types.append(_TYPE_MAP[parts[1]])
                names.append(parts[2])
        dtype = np.dtype(list(zip(names, types)))
        if fmt == "binary_little_endian":
            raw = np.frombuffer(f.read(n * dtype.itemsize), dtype=dtype, count=n)
        elif fmt == "ascii":
            raw = np.loadtxt(f, dtype=dtype, max_rows=n)
        else:
            raise ValueError(f"unsupported PLY format {fmt}")
    return names, np.stack([raw[nm].astype(np.float32) for nm in names], axis=1)


def load_splat_ply(path: str, sh_degree: int | None = None, capacity: int | None = None,
                   spatial_lr_scale: float = 1.0, device="cuda") -> GaussianState:
    """Read a splat PLY (either package's, or the reference's) into a
    GaussianState of `capacity` rows on `device` (reference load_ply,
    gs_renderer.py:762-852). Loaded models render at full SH degree."""
    device = resolve_device(device)
    names, data = _parse_ply(path)
    col = {nm: i for i, nm in enumerate(names)}
    n = data.shape[0]
    k = sum(1 for nm in names if nm.startswith("f_rest_")) // 3 + 1
    if sh_degree is None:
        sh_degree = int(round(np.sqrt(k))) - 1
    assert (sh_degree + 1) ** 2 == k, (sh_degree, k)
    cap = max(capacity or n, n)

    def take(prefix, count):
        return np.stack([data[:, col[f"{prefix}_{i}"]] for i in range(count)], axis=1)

    def padded(rows, shape, fill=0.0):
        out = np.full((cap,) + shape, fill, np.float32)
        out[:n] = rows
        return out

    rotation = padded(take("rot", 4), (4,))
    rotation[n:, 0] = 1.0
    params = dict(
        xyz=padded(np.stack([data[:, col[c]] for c in "xyz"], axis=1), (3,)),
        features_dc=padded(take("f_dc", 3).reshape(n, 3, 1).transpose(0, 2, 1), (1, 3)),
        features_rest=padded(take("f_rest", 3 * (k - 1)).reshape(n, 3, k - 1)
                             .transpose(0, 2, 1), (k - 1, 3)),
        scaling=padded(take("scale", 3), (3,)),
        rotation=rotation,
        opacity=padded(data[:, col["opacity"]][:, None], (1,)),
        background=np.zeros((3,), np.float32))
    params = {key: torch.as_tensor(v, device=device) for key, v in params.items()}
    aux = dict(active=torch.arange(cap, device=device) < n,
               max_radii2d=torch.zeros((cap,), device=device),
               xyz_gradient_accum=torch.zeros((cap,), device=device),
               denom=torch.zeros((cap,), device=device))
    return GaussianState(params=params, aux=aux, opt=adam_init(params), sh_degree=sh_degree,
                         active_sh_degree=sh_degree, spatial_lr_scale=spatial_lr_scale)


def store_point_ply(path: str, xyz: np.ndarray, rgb: np.ndarray) -> None:
    """Plain coloured point cloud (reference storePly,
    gs_renderer.py:26-47); rgb in [0,1] or [0,255]."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    n = xyz.shape[0]
    header = ["ply", "format binary_little_endian 1.0", f"element vertex {n}",
              "property float x", "property float y", "property float z",
              "property float nx", "property float ny", "property float nz",
              "property uchar red", "property uchar green", "property uchar blue",
              "end_header"]
    dtype = np.dtype([(c, "<f4") for c in ["x", "y", "z", "nx", "ny", "nz"]]
                     + [(c, "u1") for c in ["red", "green", "blue"]])
    rec = np.empty(n, dtype)
    for i, c in enumerate("xyz"):
        rec[c] = xyz[:, i].astype(np.float32)
    for c in ["nx", "ny", "nz"]:
        rec[c] = 0.0
    if rgb.max() > 1.5:
        rgb_u8 = np.clip(rgb, 0, 255).astype(np.uint8)
    else:
        rgb_u8 = np.clip(rgb * 255, 0, 255).astype(np.uint8)
    for i, c in enumerate(["red", "green", "blue"]):
        rec[c] = rgb_u8[:, i]
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        f.write(rec.tobytes())


def fetch_point_ply(path: str):
    """Read a coloured point cloud: (points [N,3], colours [N,3] in [0,1])
    (reference fetchPly, gs_renderer.py:17-23)."""
    names, data = _parse_ply(path)
    col = {nm: i for i, nm in enumerate(names)}
    pts = np.stack([data[:, col[c]] for c in "xyz"], axis=1)
    rgb = np.stack([data[:, col[c]] for c in ["red", "green", "blue"]], axis=1)
    if rgb.max() > 1.5:
        rgb = rgb / 255.0
    return pts.astype(np.float32), rgb.astype(np.float32)
