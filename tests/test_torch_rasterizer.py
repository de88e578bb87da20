"""Rasterizer parity: the port's `render` (plain versions of K1/K2 on the
CPU) and its golden `render_reference` against the JAX package's
`render(interpret=True)` and `render_reference`, on the same numpy scene.

Tolerances: image/depth/alpha atol 1e-5, rtol 1e-4 (the JAX suite's own,
tests/test_rasterizer_parity.py); parameter gradients atol 2e-4 after
scaling by the reference's max |g| (the JAX suite's gradient tolerance).
"""

import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dreamscene_tpu.cameras import Camera as JCamera
from dreamscene_tpu.cameras.sampling import _pose_to_rt, circle_poses
from dreamscene_tpu.ops.rasterizer import render as j_render
from dreamscene_tpu.ops.reference import render_reference as j_reference
from dreamscene_tpu_torch.ops.rasterizer import render as t_render
from dreamscene_tpu_torch.ops.reference import render_reference as t_reference

# One intra-op thread: the suite runs several worker processes at once, and
# one OpenMP team of all cores per worker makes these small tensors wait on
# each other (the six heaviest files of the port took 205 s on 8 cores with
# 6 workers, 66 s with one thread each).
torch.set_num_threads(1)

BG = np.asarray([0.1, 0.2, 0.3], np.float32)
KEYS = ["means3d", "scales", "quats", "opacities", "shs"]


def make_camera(width, height, radius=4.0, azim=0.3, elev=0.2):
    pose = circle_poses(radius, 90.0 - math.degrees(elev), math.degrees(azim))
    R, T = _pose_to_rt(pose)
    return JCamera(R=R.astype(np.float32), T=T.astype(np.float32),
                   fovx=math.radians(50), fovy=math.radians(50),
                   width=width, height=height)


def make_scene(n, seed, sh_degree=2):
    rng = np.random.RandomState(seed)
    k = (sh_degree + 1) ** 2
    means = rng.randn(n, 3).astype(np.float32) * 0.8
    scales = np.exp(rng.randn(n, 3).astype(np.float32) * 0.5 - 2.5)
    quats = rng.randn(n, 4).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    opac = (1.0 / (1.0 + np.exp(-rng.randn(n)))).astype(np.float32)
    shs = rng.randn(n, k, 3).astype(np.float32) * 0.3
    shs[:, 0, :] += 0.8
    return dict(means3d=means, scales=scales, quats=quats, opacities=opac, shs=shs)


def cam_np(cam):
    return dict(viewmatrix=cam.world_view_transform,
                projmatrix=cam.full_proj_transform, campos=cam.camera_center,
                tanfovx=cam.tanfovx, tanfovy=cam.tanfovy,
                width=cam.width, height=cam.height)


def to_jax(d):
    return {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in d.items()}


def to_torch(d, requires_grad=False):
    out = {}
    for k, v in d.items():
        if isinstance(v, np.ndarray):
            t = torch.from_numpy(v.copy())
            out[k] = t.requires_grad_(True) if requires_grad and k in KEYS else t
        else:
            out[k] = v
    return out


def close(a, b, err):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-5, rtol=1e-4,
                               err_msg=err)


@pytest.mark.parametrize("tw,th,w,h,seed", [(16, 16, 64, 64, 0), (32, 16, 96, 64, 1),
                                            (32, 16, 72, 40, 2)])
def test_forward_matches_jax(tw, th, w, h, seed):
    scene = make_scene(300, seed)
    cam = make_camera(w, h)
    kw = dict(bg=BG, sh_degree=2, tile_w=tw, tile_h=th)
    jo = j_render(**to_jax(scene), **to_jax(cam_np(cam)), **to_jax(kw),
                  interpret=True, chunk=128)
    jr = j_reference(**to_jax(scene), **to_jax(cam_np(cam)), **to_jax(kw))
    with torch.no_grad():
        to = t_render(**to_torch(scene), **to_torch(cam_np(cam)), **to_torch(kw),
                      chunk=128, device="cpu")
        tr = t_reference(**to_torch(scene), **to_torch(cam_np(cam)), **to_torch(kw))
    assert int(to["n_entries"]) == int(jo["n_entries"])
    assert int(to["n_dropped"]) == int(jo["n_dropped"]) == 0
    for key in ["image", "depth", "alpha"]:
        close(to[key], jo[key], f"render {key}")
        close(tr[key], jr[key], f"reference {key}")
        close(to[key], jr[key], f"render vs JAX golden {key}")
    np.testing.assert_array_equal(to["radii"].numpy(), np.asarray(jo["radii"]))


def test_valid_mask_matches_jax():
    scene = make_scene(100, 4)
    cam = make_camera(32, 32)
    mask = np.arange(100) < 50
    jo = j_render(**to_jax(scene), **to_jax(cam_np(cam)), bg=jnp.asarray(BG),
                  sh_degree=2, valid_mask=jnp.asarray(mask), interpret=True)
    with torch.no_grad():
        to = t_render(**to_torch(scene), **to_torch(cam_np(cam)), bg=torch.from_numpy(BG),
                      sh_degree=2, valid_mask=torch.from_numpy(mask), device="cpu")
    close(to["image"], jo["image"], "masked image")
    assert np.all(to["radii"][50:].numpy() == 0)


def _loss_terms(out, target):
    return ((out["image"] - target) ** 2).mean() + 0.1 * out["depth"].mean() \
        + 0.05 * out["alpha"].mean()


@pytest.mark.parametrize("tw,th,w,h", [(16, 16, 48, 48), (32, 16, 64, 48)])
def test_gradients_match_jax(tw, th, w, h):
    scene = make_scene(250, 5)
    cam = make_camera(w, h)
    target = np.random.RandomState(9).rand(3, h, w).astype(np.float32)
    n = scene["means3d"].shape[0]
    probe = np.zeros((n, 2), np.float32)

    def jloss(s, p):
        out = j_render(**s, **to_jax(cam_np(cam)), bg=jnp.asarray(BG), sh_degree=2,
                       interpret=True, tile_w=tw, tile_h=th, means2d_probe=p)
        return _loss_terms(out, jnp.asarray(target))

    g_j, gp_j = jax.grad(jloss, argnums=(0, 1))(
        {k: jnp.asarray(scene[k]) for k in KEYS}, jnp.asarray(probe))

    ts = to_torch(scene, requires_grad=True)
    tp = torch.zeros((n, 2), requires_grad=True)
    out = t_render(**ts, **to_torch(cam_np(cam)), bg=torch.from_numpy(BG), sh_degree=2,
                   tile_w=tw, tile_h=th, means2d_probe=tp, device="cpu")
    _loss_terms(out, torch.from_numpy(target)).backward()
    for key in KEYS:
        ref = np.asarray(g_j[key])
        scale = np.abs(ref).max() + 1e-8
        np.testing.assert_allclose(ts[key].grad.numpy() / scale, ref / scale, atol=2e-4,
                                   err_msg=f"gradient mismatch for {key}")
    ref = np.asarray(gp_j)
    scale = np.abs(ref).max() + 1e-8
    np.testing.assert_allclose(tp.grad.numpy() / scale, ref / scale, atol=2e-4,
                               err_msg="means2d probe gradient")


def test_blocked_cumsum_matches_float64():
    from dreamscene_tpu_torch.ops.rasterizer import blocked_cumsum

    x = torch.from_numpy(np.random.RandomState(3).randn(70000, 3).astype(np.float32))
    ref = np.cumsum(x.numpy().astype(np.float64), axis=0)
    np.testing.assert_allclose(blocked_cumsum(x).numpy(), ref, atol=2e-3, rtol=1e-5)


def _binned_cpu(n, seed, w, h, tw, th, chunk):
    """Project and bin one seeded scene on the CPU: what K1/K2 take."""
    from dreamscene_tpu_torch.ops import binning
    from dreamscene_tpu_torch.ops.projection import project_gaussians

    scene, cam = to_torch(make_scene(n, seed)), to_torch(cam_np(make_camera(w, h)))
    with torch.no_grad():
        sp = project_gaussians(scene["means3d"], scene["scales"], scene["quats"],
                               scene["opacities"], scene["shs"], cam["viewmatrix"],
                               cam["projmatrix"], cam["campos"], cam["tanfovx"], cam["tanfovy"],
                               w, h, sh_degree=2)
        capacity = 8 * n
        b = binning.bin_splats(sp.means2d, sp.depths, sp.radii, sp.visible, w, h,
                               capacity=capacity, chunk=chunk, conics=sp.conics,
                               opacities=sp.opacities, tile_w=tw, tile_h=th)
        rec_n = torch.cat([sp.means2d, sp.conics, sp.opacities[:, None], sp.colors,
                           sp.depths[:, None], sp.means2d.new_zeros((n, 6))], 1)
        cap_pad = binning.cdiv(capacity, 128) * 128 + chunk
        gid_pad = torch.cat([b.gid_sorted, torch.zeros(cap_pad - capacity, dtype=torch.int32)])
        records_t = rec_n.index_select(0, gid_pad.long()).t().contiguous()
    tiles_x = binning.cdiv(w, tw)
    geo = dict(n_tiles=tiles_x * binning.cdiv(h, th), tiles_x=tiles_x, chunk=chunk,
               tile_w=tw, tile_h=th)
    meta = (b.chunk_tile, b.chunk_s0, b.chunk_lo, b.chunk_hi, b.n_chunks_used)
    return records_t, meta, b.chunk_first, geo


@pytest.mark.parametrize("tw,th,w,h", [(16, 16, 48, 48), (32, 16, 64, 48)])
def test_carry_table_restarts_each_chunk(tw, th, w, h):
    """K2 walks one chunk per CTA from the carry table K1 leaves (T and the
    accumulators at each chunk's start). The plain versions hold that
    bookkeeping: the table's rows are the sequential walk's states, and a
    backward that restarts every chunk from its row gives the gradients of
    the walk in order. Both are also held against the JAX kernels in
    interpret mode, which keep a per-chunk T table of their own (emit_tcar):
    T at each chunk's start, and the grad table of the backward that starts
    every chunk from it, at this file's gradient tolerance."""
    from dreamscene_tpu.ops import composite as JC
    from dreamscene_tpu_torch.ops import composite as C

    rt, meta, chunk_first, geo = _binned_cpu(600, 11, w, h, tw, th, chunk=128)
    ct, _, lo, hi, n_used = meta
    out = C.composite_forward_plain(rt, *meta, **geo)
    out_c, carry = C.composite_forward_plain(rt, *meta, **geo, return_carry=True)
    assert torch.equal(out, out_c)
    assert carry.shape == (ct.shape[0], C.CARRY_ROWS, tw * th)
    n_u = int(n_used)
    live = [u for u in range(n_u) if int(hi[u]) > int(lo[u])]
    per_tile = torch.bincount(ct[live].long())
    assert int(per_tile.max()) >= 3, "the scene must give some tile several chunks"
    first = {}
    for u in live:
        first.setdefault(int(ct[u]), u)
    for t, u in first.items():      # a tile's first chunk starts from the background state
        assert torch.equal(carry[u, :4], torch.zeros_like(carry[u, :4]))
        assert torch.equal(carry[u, 4], torch.ones_like(carry[u, 4]))
    for u0, u1 in zip(live, live[1:]):
        if int(ct[u0]) == int(ct[u1]):     # T only falls along a tile, never under the stop rule
            assert (carry[u1, 4] <= carry[u0, 4]).all()
    assert (carry[live, 4] >= C.TRANSMITTANCE_EPS).all()
    last = {int(ct[u]): u for u in live}
    for t, u in last.items():       # the last chunk's T is at least the final T
        assert (carry[u, 4] >= out[t, C.A_T]).all()

    g_out = torch.from_numpy(np.random.RandomState(3).randn(*out.shape).astype(np.float32))
    g_seq = C.composite_backward_plain(rt, *meta, out, g_out, **geo)
    g_car = C.composite_backward_plain(rt, *meta, out, g_out, **geo, carry=carry)
    scale = float(g_seq.abs().max())
    assert scale > 0
    # the prefix at a chunk's start is formed as g . accumulators instead of
    # being summed entry by entry: same value up to float32 rounding
    np.testing.assert_allclose(g_car.numpy() / scale, g_seq.numpy() / scale, atol=2e-6)
    # the public wrapper ignores the table on the CPU (the plain walk needs none)
    g_pub = C.composite_backward(rt, *meta[:4], None, n_used, out, g_out, **geo, carry=carry)
    assert torch.equal(g_pub, g_seq)

    jmeta = [jnp.asarray(x.numpy()) for x in (*meta[:4], chunk_first, n_used)]
    j_out, tcar = JC.composite_forward(jnp.asarray(rt.numpy()), *jmeta, **geo, interpret=True,
                                       emit_tcar=True)
    close(out[:, :6], j_out[:, :6], "accumulators")
    close(carry[live, 4], np.asarray(tcar)[live], "T at each live chunk's start")
    j_g = JC.composite_backward(jnp.asarray(rt.numpy()), *jmeta, j_out, jnp.asarray(g_out.numpy()),
                                **geo, interpret=True, tcar=tcar)
    used = n_u * geo["chunk"]      # the JAX kernel writes the live chunks' columns only
    np.testing.assert_allclose(g_car.numpy()[:, :used] / scale,
                               np.asarray(j_g)[:, :used] / scale, atol=2e-4)
    assert not g_car[:, used:].any()


@pytest.mark.parametrize("tw,th", [(16, 16), (32, 16)])
def test_tile_order_busiest_first(tw, th):
    """K1 dispatches its tiles in `tile_order`: a permutation of the
    n_tiles + 1 tiles (the trash tile included) by live entries, most first,
    ties in tile order; the live entries are those of the binned chunks."""
    from dreamscene_tpu_torch.ops import binning as tbin
    from dreamscene_tpu_torch.ops.composite import tile_order

    rng = np.random.RandomState(tw + th)
    n, width, height = 400, 96, 64
    means = np.stack([rng.uniform(-10, width + 10, n),
                      rng.uniform(-10, height + 10, n)], 1).astype(np.float32)
    means[: n // 2] = (means[: n // 2] * 0.2 + [40.0, 30.0]).astype(np.float32)  # a busy spot
    radii = rng.randint(0, 12, n).astype(np.int32)
    b = tbin.bin_splats(torch.from_numpy(means), torch.from_numpy(rng.uniform(1, 5, n).astype(
        np.float32)), torch.from_numpy(radii), torch.from_numpy(radii > 0), width, height,
        capacity=5000, chunk=128, tile_w=tw, tile_h=th)
    n_tiles = -(-width // tw) * -(-height // th)
    order = tile_order(b.chunk_tile, b.chunk_lo, b.chunk_hi, n_tiles)
    assert order.dtype == torch.int32 and sorted(order.tolist()) == list(range(n_tiles + 1))
    live = [0] * (n_tiles + 1)
    for u in range(int(b.n_chunks_used)):
        live[int(b.chunk_tile[u])] += int(b.chunk_hi[u] - b.chunk_lo[u])
    keys = [(-live[t], t) for t in order.tolist()]
    assert keys == sorted(keys)
    assert live[int(order[0])] == max(live) > live[int(order[-1])] == 0


def test_plain_transmittance_is_the_sequential_product():
    """The plain compositing version multiplies T entry by entry,
    t <- t * (1 - alpha), as K1 does: a scan associates the product
    otherwise, and on the card its last ulp once carried T across the 1e-4
    stop on one side only (config #4 at 1920x1080). Bit-equal to a float32
    loop, the stop included."""
    from dreamscene_tpu_torch.ops import composite as C

    rng = np.random.RandomState(9)
    chunk, tile_w, tile_h = 128, 8, 4
    rec = np.zeros((C.REC_WIDTH, chunk), np.float32)
    rec[C.F_MX] = rng.uniform(0, tile_w, chunk)
    rec[C.F_MY] = rng.uniform(0, tile_h, chunk)
    rec[C.F_CA] = rec[C.F_CC] = rng.uniform(0.01, 0.3, chunk)
    rec[C.F_OPA] = rng.uniform(0.05, 0.25, chunk)
    i32 = lambda *v: torch.tensor(v, dtype=torch.int32)
    t_carry = torch.from_numpy(rng.uniform(0.5, 1.0, (1, tile_w * tile_h)).astype(np.float32))
    v = C._chunk_block(torch.from_numpy(rec), i32(0), i32(0), i32(0), i32(3), i32(chunk - 5),
                       t_carry, 1, chunk, tile_w, tile_h)
    alpha = v["alpha"][0].numpy()
    stops = 0
    for p in range(tile_w * tile_h):
        t = np.float32(t_carry[0, p])
        for l in range(chunk):
            assert v["t_excl"][0, p, l].item() == t
            t_next = np.float32(t * (np.float32(1) - alpha[p, l]))
            if t_next < np.float32(C.TRANSMITTANCE_EPS):
                stops += 1
                assert not v["applied"][0, p, l:].any()
                break
            assert v["applied"][0, p, l]
            t = t_next
        assert v["t_new"][0, p].item() == t
    assert stops > 0
