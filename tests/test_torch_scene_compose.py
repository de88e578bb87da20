"""Scene composition in the port against the JAX package, case for case
after tests/test_scene_compose.py: placement (identity, z-snap, scale,
rotation equivariance of a render), the joint scene render against the
JAX package's and the golden renderer, `final_combine_all`, the scene box,
the importance-filter compress (port only: the filter is held against
the JAX package in test_torch_object_train.py), the exactly-empty-region
disparity; plus
the SH band rotation, the env/floor inits and the `shapes` init.

Same numpy inputs through both packages (the port's states carried across
by `convert.state_from`); JAX's Pallas kernels in interpret mode, the
port's plain versions.

Tolerances: integer and init outputs bit-equal; placed parameters and SH
rotation matrices atol 1e-5 (float32 products in another order); images,
depths and alphas atol 1e-5 / rtol 1e-4; init colours (the JAX package
rounds SH2RGB through float32) atol 1e-6.
"""

import dataclasses
import math

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from dreamscene_tpu import rendering as JR
from dreamscene_tpu.models import gaussians as JG
from dreamscene_tpu.models import init as JI
from dreamscene_tpu.models import scene as JSc
from dreamscene_tpu.ops import transforms as JT
from dreamscene_tpu_torch import convert
from dreamscene_tpu_torch import rendering as TR
from dreamscene_tpu_torch.cameras import Camera as TCamera
from dreamscene_tpu_torch.cameras.sampling import _pose_to_rt, circle_poses
from dreamscene_tpu_torch.models import gaussians as TG
from dreamscene_tpu_torch.models import init as TI
from dreamscene_tpu_torch.models import scene as TSc
from dreamscene_tpu_torch.ops import transforms as TT
from dreamscene_tpu_torch.ops.reference import render_reference
from tests.test_rasterizer_parity import make_camera

torch.set_num_threads(1)

FIELDS = ["xyz", "features_dc", "features_rest", "scaling", "rotation", "opacity"]


def make_obj(n=60, seed=0, offset=(0, 0, 0), sh_degree=2):
    """A JAX object state with varied rest-SH and opacities."""
    rng = np.random.RandomState(seed)
    pts = rng.randn(n, 3).astype(np.float32) * 0.3 + np.asarray(offset, np.float32)
    st = JG.create_from_points(pts, rng.rand(n, 3).astype(np.float32), sh_degree=sh_degree,
                               capacity=n)
    p = st.params
    p = dataclasses.replace(
        p, features_rest=jnp.asarray(0.3 * rng.randn(*p.features_rest.shape).astype(np.float32)),
        opacity=jnp.asarray(np.asarray(p.opacity) + rng.randn(n, 1).astype(np.float32)))
    return dataclasses.replace(st, params=p, active_sh_degree=sh_degree)


def tcam(jcam):
    return TCamera(**dataclasses.asdict(jcam))


def cam_at_phi(phi, size=32):
    R, T = _pose_to_rt(circle_poses(3.0, 75.0, phi))
    return TCamera(R=R.astype(np.float32), T=T.astype(np.float32), fovx=0.7, fovy=0.7,
                   width=size, height=size)


def assert_images(t, j):
    for k in ("image", "depth", "alpha"):
        np.testing.assert_allclose(t[k].detach().numpy(), np.asarray(j[k]), atol=1e-5,
                                   rtol=1e-4, err_msg=k)


# ---------------------------------------------------------------- placement
PLACEMENTS = {
    "identity": dict(center=[0, 0, 0], rotation=[0, 0, 0], scale=[1, 1, 1], snap_floor=False),
    "z-snap": dict(center=[1.0, 2.0, 0.5], rotation=[0, 0, 0], scale=[1, 1, 1]),
    "scale": dict(center=[0, 0, 0], rotation=[0, 0, 0], scale=[2.0, 2.0, 2.0],
                  snap_floor=False),
    "rotated, scaled, snapped": dict(center=[-3, 2, 0.0], rotation=[10.0, -20.0, 180.0],
                                     scale=[1.2, 0.8, 1.5]),
    "quaternion": dict(center=[0.5, 0, 0], rotation=[0.9, 0.1, 0.3, -0.2], scale=2.0),
}


@pytest.mark.parametrize("case", list(PLACEMENTS))
def test_place_object_matches_jax(case):
    kw = PLACEMENTS[case]
    st = make_obj(seed=1)
    # a few inactive rows far below: the z-snap must ignore them
    act = np.ones(60, bool)
    act[-5:] = False
    xyz = np.asarray(st.params.xyz).copy()
    xyz[-5:, 2] = -50.0
    st = dataclasses.replace(st, params=dataclasses.replace(st.params, xyz=jnp.asarray(xyz)),
                             aux=dataclasses.replace(st.aux, active=jnp.asarray(act)))
    jp, jargs, jbbox = JSc.place_object(st, **kw)
    tp, targs, tbbox = TSc.place_object(convert.state_from(st), **kw)
    for f in FIELDS:
        np.testing.assert_allclose(tp.params[f].numpy(), np.asarray(getattr(jp.params, f)),
                                   atol=1e-5, err_msg=f)
    np.testing.assert_allclose(tbbox, jbbox, atol=1e-5)
    np.testing.assert_allclose(targs.affine["T"], np.asarray(jargs.affine["T"]), atol=1e-5)
    assert tp.opt.count == 0 and float(tp.aux["denom"].abs().sum()) == 0.0
    if case == "identity":
        np.testing.assert_allclose(tp.params["xyz"].numpy(), np.asarray(st.params.xyz), atol=1e-5)
        np.testing.assert_allclose(tp.params["features_rest"].numpy(),
                                   np.asarray(st.params.features_rest), atol=1e-4)
    if case == "z-snap":
        z = tp.params["xyz"][tp.aux["active"]][:, 2]
        assert abs(float(z.min()) - 0.5) < 1e-5
    if case == "scale":
        np.testing.assert_allclose(tp.params["scaling"].numpy(),
                                   np.asarray(st.params.scaling) + math.log(2.0), atol=1e-5)


def test_rotation_equivariance_render():
    """The object rotated by Rz(90) seen from azimuth a renders as the
    original seen from a -/+ 90 (xyz, quaternion and SH rotation
    together), and the port's render of the placed object equals the JAX
    package's."""
    st = make_obj(seed=3)
    kw = dict(center=[0, 0, 0], rotation=[0, 0, 90], scale=[1, 1, 1], snap_floor=False)
    jplaced, _, _ = JSc.place_object(st, **kw)
    tplaced, _, _ = TSc.place_object(convert.state_from(st), **kw)
    base = convert.state_from(st)
    bg = (0.0, 0.0, 0.0)
    out_rot = TR.object_render(tplaced, cam_at_phi(30.0), bg_color=bg)
    diffs = [float((out_rot["image"] - TR.object_render(base, cam_at_phi(30.0 + d),
                                                        bg_color=bg)["image"]).abs().mean())
             for d in (-90.0, 90.0)]
    assert min(diffs) < 2e-3, diffs
    jcam = cam_at_phi(30.0)
    j_out = JR.object_render(jplaced, jcam, bg_color=jnp.zeros(3), test=True, interpret=True)
    assert_images(out_rot, j_out)


# ------------------------------------------------------------- scene render
def test_scene_render_matches_jax_and_golden():
    """Two objects rendered jointly: the port's scene_render against the
    JAX package's and against the golden renderer on the concatenated set."""
    a = make_obj(50, seed=1, offset=(-0.8, 0, 0))
    b = make_obj(50, seed=2, offset=(0.8, 0, 0))
    jcam = make_camera(32, 32)
    bg = (0.2, 0.2, 0.2)
    j_out = JR.scene_render([a, b], jcam, bg_color=jnp.asarray(bg), test=True, interpret=True)
    ta, tb = convert.state_from(a), convert.state_from(b)
    t_out = TR.scene_render([ta, tb], tcam(jcam), bg_color=bg)
    assert_images(t_out, j_out)
    assert list(t_out["segments"]) == list(j_out["segments"]) == [0, 50, 100]
    inputs, offsets = TR.concat_states([ta, tb])
    ref = render_reference(**inputs, **TR.camera_arrays(tcam(jcam), "cpu"),
                           bg=torch.tensor(bg), sh_degree=2)
    np.testing.assert_allclose(t_out["image"].numpy(), ref["image"].numpy(), atol=1e-5,
                               rtol=1e-4)
    parts = TR.split_by_segments(t_out["radii"], offsets)
    assert [p.shape[0] for p in parts] == [50, 50]


def test_exactly_empty_region_yields_finite_disparity():
    """0/0 guard: with every splat inactive each pixel is exactly empty,
    max(disp) == min_d, and the disparity must come out finite and zero,
    as in the JAX package."""
    st = make_obj(40)
    st = dataclasses.replace(st, aux=dataclasses.replace(
        st.aux, active=jnp.zeros_like(st.aux.active)))
    jcam = make_camera(32, 32)
    j_out = JR.scene_render([st], jcam, bg_color=jnp.zeros(3), test=True, interpret=True)
    t_out = TR.scene_render([convert.state_from(st)], tcam(jcam), bg_color=(0, 0, 0))
    assert torch.isfinite(t_out["depth"]).all() and torch.isfinite(t_out["alpha"]).all()
    np.testing.assert_allclose(t_out["depth"].numpy(), 0.0, atol=1e-6)
    assert_images(t_out, j_out)


# ------------------------------------------------------------------ combine
def test_final_combine_all_and_scene_box(tmp_path):
    a = make_obj(40, seed=4)
    b = make_obj(30, seed=5, sh_degree=1)
    for parts in ([a, make_obj(30, seed=5)], [a, b]):     # equal and mixed SH degrees
        j = JSc.final_combine_all(parts)
        t = TSc.final_combine_all([convert.state_from(p) for p in parts])
        assert t.capacity == 70 and TG.num_active(t) == 70 and t.sh_degree == j.sh_degree == 2
        for f in FIELDS:
            np.testing.assert_array_equal(t.params[f].numpy(), np.asarray(getattr(j.params, f)))
        np.testing.assert_array_equal(t.aux["active"].numpy(), np.asarray(j.aux.active))
    assert float(t.params["features_rest"][40:, 3:].abs().max()) == 0.0
    np.testing.assert_array_equal(t.params["xyz"][40:].numpy(), np.asarray(b.params.xyz))

    sm, jsm = TSc.SceneModel(), JSc.SceneModel()
    for box in (np.array([-1, -1, 0, 2, 2, 1], np.float32),
                np.array([-3, 0.5, -0.2, 1, 4, 0.5], np.float32)):
        sm.grow_box(box)
        jsm.grow_box(box)
    np.testing.assert_array_equal(sm.scene_box, jsm.scene_box)
    np.testing.assert_allclose(sm.scene_box, [-3, -1, -0.2, 2, 4, 1])
    args = [TSc.ObjectArgs("o", 0, {}, np.array([-2, 0, 0, 1, 3, 1], np.float32))]
    TSc.export_layout(sm.scene_box, args, str(tmp_path / "layout.jpg"))
    assert list(tmp_path.glob("layout.jpg*"))


def test_compress_reduces_points_and_preserves_render():
    """The importance filter that compress_objects runs drops the
    low-importance half of a blob and leaves its render close (the JAX
    suite's case; the filter itself is held against the JAX package's in
    test_torch_object_train.py)."""
    from dreamscene_tpu_torch.training.filtering import importance_filter
    from dreamscene_tpu_torch.utils.config import GenerateCamParams

    n = 120
    st = make_obj(n=n, seed=1)
    op = np.array(st.params.opacity)
    op[n // 2:] = -6.0            # sigmoid ~ 0.0025: negligible
    t0 = convert.state_from(dataclasses.replace(
        st, params=dataclasses.replace(st.params, opacity=jnp.asarray(op))))
    pose = GenerateCamParams()
    pose.image_w = pose.image_h = 32
    t2 = importance_filter(t0, np.random.default_rng(0), pose, prune_percent=0.5, n_views=8)
    assert TG.num_active(t2) < TG.num_active(t0)
    cam = tcam(make_camera(32, 32))
    img_a = TR.object_render(t0, cam)["image"]
    img_b = TR.object_render(t2, cam)["image"]
    assert float((img_a - img_b).abs().mean()) < 0.02


# --------------------------------------------------------------- transforms
@pytest.mark.parametrize("deg", [1, 2, 3])
def test_rotate_sh_matches_jax(deg):
    rng = np.random.RandomState(deg)
    angles = rng.uniform(-np.pi, np.pi, (4, 3)).astype(np.float32)
    j_rot = np.asarray(JT.euler_angles_to_matrix(jnp.asarray(angles)))
    t_rot = TT.euler_angles_to_matrix(torch.from_numpy(angles))
    np.testing.assert_allclose(t_rot.numpy(), j_rot, atol=1e-6)
    np.testing.assert_array_equal(TT._band_sample_dirs(deg), JT._band_sample_dirs(deg))
    np.testing.assert_allclose(TT._band_basis_inv(deg), JT._band_basis_inv(deg), rtol=1e-5,
                               atol=1e-5)
    for l in range(deg + 1):
        d_t = TT.sh_band_rotation_matrix(l, t_rot)
        np.testing.assert_allclose(d_t.numpy(),
                                   np.asarray(JT.sh_band_rotation_matrix(l, jnp.asarray(j_rot))),
                                   atol=1e-5)
        eye = torch.eye(2 * l + 1).expand(4, -1, -1)        # orthogonal per band
        np.testing.assert_allclose((d_t @ d_t.transpose(-1, -2)).numpy(), eye.numpy(), atol=1e-4)
    sh = rng.randn(30, (deg + 1) ** 2, 3).astype(np.float32)
    np.testing.assert_allclose(
        TT.rotate_sh(torch.from_numpy(sh), t_rot[0], deg).numpy(),
        np.asarray(JT.rotate_sh(jnp.asarray(sh), jnp.asarray(j_rot[0]), deg)), atol=1e-5)


# -------------------------------------------------------------------- inits
BOX = np.array([-3.5, -2.5, 0.0, 3.5, 2.5, 5.0], np.float32)


@pytest.mark.parametrize("method", ["indoor", "outdoor"])
@pytest.mark.parametrize("zero_ground", [True, False])
def test_env_and_floor_inits_bit_equal(method, zero_ground):
    kw = dict(zero_ground=zero_ground, seed=3, density=0.002)
    for t_fn, j_fn, color in ((TI.init_env_points, JI.init_env_points, (255, 80, 80)),
                              (TI.init_floor_points, JI.init_floor_points, (240, 240, 244))):
        t_xyz, t_col = t_fn(method, BOX, color, **kw)
        j_xyz, j_col = j_fn(method, BOX, color, **kw)
        assert t_xyz.dtype == np.float32 and t_xyz.shape[0] > 100
        np.testing.assert_array_equal(t_xyz, j_xyz)
        np.testing.assert_array_equal(t_col, j_col)
    with pytest.raises(ValueError):
        TI.init_env_points("orbit", BOX)


def test_shapes_init_from_obj_matches_jax(tmp_path):
    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    obj = tmp_path / "tet.obj"
    obj.write_text("# a tetrahedron and a quad\n"
                   "v 0 0 0\nv 1 0 0\nv 0 1 0\nv 0 0 1\nv 1 1 1\n"
                   "f 1 2 3\nf 1 2 4\nf 1/1 3/1 4/1\nf 2 3 5 4\n")
    t_xyz, t_rgb, t_sls = TI.init_object_points("shapes", str(obj), str(tmp_path / "t"), seed=2)
    j_xyz, j_rgb, j_sls = JI.init_object_points("shapes", str(obj), str(tmp_path / "j"), seed=2)
    assert t_xyz.shape == (50000, 3) and t_sls == j_sls == 1.0
    np.testing.assert_array_equal(t_xyz, j_xyz)
    np.testing.assert_allclose(t_rgb, j_rgb, atol=1e-6)
    # the cached cloud is read back on the next call
    again = TI.init_object_points("shapes", str(obj), str(tmp_path / "t"), seed=9)
    assert again[0].shape == (50000, 3)
