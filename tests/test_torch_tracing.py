"""The port's profiler ranges over a whole training step, its backward
included (`utils/profiling.BackwardSpans`), on the CPU at a tiny size.

Under torch.profiler one `ObjectTrainer.train_step`, one scene step and one
`recon_step` record each of their ranges once; the render's backward range
lies inside the step's backward and holds the rasterizer's autograd node,
the VAE encoder's holds its convolutions' backward; the scene step's
`scene.rows` lies inside its `scene.render`. A step gives the same
bits with and without a profiler, adds no node to the graph without one,
and leaves no range open when its backward stops between the two marks of
a range. `device_busy_ms` counts overlapping kernels once.
"""

from __future__ import annotations

import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from dreamscene_tpu_torch.cameras import sampling as S
from dreamscene_tpu_torch.models.gaussians import create_from_points, group_lrs
from dreamscene_tpu_torch.models.ply import save_splat_ply
from dreamscene_tpu_torch.training import object_trainer as tot
from dreamscene_tpu_torch.training import scene_trainer as tst
from dreamscene_tpu_torch.utils import profiling as P
from dreamscene_tpu_torch.utils.config import ObjectsParamsGroups, ParamsGroups

torch.set_num_threads(1)

RASTER_NODE = "GatherCompositeBackward"
CONV_BWD = "ConvolutionBackward0"


def object_trainer(root, as_latent: bool = True, viz: bool = False) -> tot.ObjectTrainer:
    cfg = ObjectsParamsGroups()
    cfg.log = {"exp_name": "t"}
    cfg.objectParams.id = "obj1"
    cfg.objectParams.init_guided = "default"
    cfg.objectParams.num_pts = 40
    cfg.objectParams.sh_degree = 1
    cfg.objectParams.text = "a thing"
    o = cfg.optimizationParams
    o.iterations = 3
    o.densify_from_iter = 1 << 30
    o.max_point_number = 400
    o.geo_iter, o.as_latent_ratio = (1 << 30, 0.2) if as_latent else (0, 0.0)
    cfg.guidanceParams.C_batch_size = 2
    cfg.guidanceParams.vis_interval = 1 if viz else 100
    cfg.generateCamParams.image_w = cfg.generateCamParams.image_h = 32
    cfg.mode_args = {}
    tr = tot.ObjectTrainer(cfg, exp_root=str(root), device="cpu")
    tr.prepare_train()
    return tr


def scene_trainer(root, as_latent: bool = True) -> tst.SceneTrainer:
    """A room around one placed 60-point object (written as its final PLY,
    so no object is trained), env and floor at a tiny density."""
    cfg = ParamsGroups()
    cfg.log = {"exp_name": "t"}
    for opt in (cfg.sceneOptimizationParams, cfg.reconSceneOptimizationParams,
                cfg.fineSceneOptimizationParams):
        opt.iterations = 4
        opt.densify_from_iter = 1 << 30
    so = cfg.sceneOptimizationParams
    so.geo_iter, so.as_latent_ratio = (1 << 30, 0.2) if as_latent else (0, 0.0)
    cfg.guidanceParams.C_batch_size = 2
    cfg.sceneGenerateCamParams.image_w = cfg.sceneGenerateCamParams.image_h = 32
    cfg.generateCamParams.image_w = cfg.generateCamParams.image_h = 32
    cfg.mode_args = {}
    cfg.scene_configs = {"objects": [], "scene": {
        "sh_degree": 1, "cam_pose_method": "indoor", "scene_text": "a room",
        "negative_text": "", "zero_ground": True, "compress_objects": False,
        "floor_init_color": [240, 240, 244], "env_init_color": [255, 80, 80],
        "radius": [3.5, 2.5, 5.0],
        "scene_composition": [{"id": "a", "params": [
            {"center": [-1.0, 1.0, 0.0], "rotation": [0.0, 0.0, 30.0],
             "scale": [1.5, 1.5, 1.5]}]}]}}
    ckpt = root / "t" / "checkpoints"
    ckpt.mkdir(parents=True)
    rng = np.random.RandomState(10)
    obj = create_from_points((rng.randn(60, 3) * 0.3).astype(np.float32),
                             rng.rand(60, 3).astype(np.float32), sh_degree=1, capacity=60,
                             device="cpu")
    save_splat_ply(str(ckpt / "a_final_model.ply"), obj)
    tr = tst.SceneTrainer(cfg, exp_root=str(root), device="cpu", env_density=0.0002)
    tr.prepare_train_scene()
    tr.iters, tr.step = 2, 0
    return tr


def recon_args(tr: tot.ObjectTrainer) -> dict:
    st = tr.state
    cam = S.load_reco_cam(tr.pose_args, (4, 12, 14, 6), (100, 85, 75, 55), scale=0.9)[3]
    gen = torch.Generator().manual_seed(8)
    return dict(state=st, cam=tot.camera_tensors([cam], "cpu")[0],
                gt_image=torch.rand((3, 32, 32), generator=gen),
                lrs=group_lrs(tr.recon_optim, st.spatial_lr_scale, 7), width=32, height=32,
                capacity=tr.cap_ctrl.capacity(st.capacity), active_deg=st.active_sh_degree)


def run_step(kind: str, tr):
    """One step of `kind` on the trainer `tr`; returns (loss, state leaves)
    and the step's `as_latent` where it has one."""
    if kind == "recon":
        res = tot.recon_step(**recon_args(tr))
        leaves = [res["params"], res["opt"].mu, res["opt"].nu, res["aux"]]
        return float(res["loss"]), leaves, None
    seen = {}
    inner = tr.step_inputs

    def recording(*a, **kw):
        inp = inner(*a, **kw)
        seen["as_latent"] = (inp["args"] if kind == "scene" else inp)["as_latent"]
        return inp

    tr.step_inputs = recording
    try:
        if kind == "fps":
            loss = tr.train_step()
            states = [tr.state]
        else:
            loss = tr.scene_train_step(tr._stage1_cams(2), "env", only_env=False)
            states = [tr.scene.env, tr.scene.floor]
    finally:
        del tr.step_inputs
    leaves = []
    for st in states:
        leaves += [st.params, st.opt.mu, st.opt.nu, st.aux,
                   {"count": torch.as_tensor(st.opt.count)}]
    return loss, leaves, seen["as_latent"]


def make(kind: str, root, as_latent: bool = True, viz: bool = False):
    if kind == "scene":
        return scene_trainer(root, as_latent)
    return object_trainer(root, as_latent, viz)


def by_name(prof, prefix: str) -> dict:
    out = {}
    for e in prof.events():
        if e.is_user_annotation and e.name.startswith(prefix):
            out.setdefault(e.name, []).append(e)
    return out


def inside(e, span) -> bool:
    return (span.time_range.start <= e.time_range.start
            and e.time_range.end <= span.time_range.end)


STEP_SPANS = {
    "fps": ["fps.step", "fps.step_inputs", "fps.render", "fps.render.bwd", "fps.vae_encode",
            "fps.vae_encode.bwd", "fps.ladder", "fps.backward", "fps.allreduce", "fps.adam",
            "fps.sync"],
    "scene": ["scene.step", "scene.step_inputs", "scene.render", "scene.rows",
              "scene.render.bwd", "scene.vae_encode", "scene.vae_encode.bwd", "scene.ladder",
              "scene.backward", "scene.allreduce", "scene.adam", "scene.sync"],
    "recon": ["recon.render", "recon.render.bwd", "recon.adam"],
}


@pytest.mark.parametrize("kind,as_latent,viz", [
    ("fps", True, False), ("fps", False, True), ("scene", True, False), ("scene", False, False),
    ("recon", None, False)])
def test_step_records_each_range_once(kind, as_latent, viz, tmp_path):
    """With `viz`, the step is one of the guidance visualization's
    (`vis_interval`), and its `fps.viz` range follows the host's read."""
    tr = make(kind, tmp_path, bool(as_latent), viz)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _, _, seen = run_step(kind, tr)
    assert seen == as_latent
    spans = by_name(prof, kind + ".")
    assert sorted(spans) == sorted(STEP_SPANS[kind] + ["fps.viz"] * viz)
    assert all(len(v) == 1 for v in spans.values()), {k: len(v) for k, v in spans.items()}
    spans = {k: v[0] for k, v in spans.items()}
    events = list(prof.events())
    raster = [e for e in events if RASTER_NODE in e.name]
    assert raster and all(inside(e, spans[f"{kind}.render.bwd"]) for e in raster)
    if kind == "recon":
        order = [spans[f"recon.{n}"].time_range for n in ("render", "render.bwd", "adam")]
        assert order[0].end <= order[1].start and order[1].end <= order[2].start
        return
    for part in ("render.bwd", "vae_encode.bwd"):
        assert inside(spans[f"{kind}.{part}"], spans[f"{kind}.backward"]), part
    if kind == "scene":
        assert inside(spans["scene.rows"], spans["scene.render"])
    convs = [e for e in events if e.name == CONV_BWD]
    assert convs and all(inside(e, spans[f"{kind}.vae_encode.bwd"]) for e in convs)
    for name, e in spans.items():
        assert name == f"{kind}.step" or inside(e, spans[f"{kind}.step"]), name
    if viz:
        assert spans["fps.sync"].time_range.end <= spans["fps.viz"].time_range.start
        assert any(inside(e, spans["fps.viz"]) for e in events if e.name == "aten::convolution")


def leaves_equal(a, b):
    for x, y in zip(a, b):
        assert sorted(x) == sorted(y)
        for k in x:
            assert torch.equal(x[k], y[k]), k


@pytest.mark.parametrize("kind", ["fps", "scene", "recon"])
def test_step_is_the_same_with_and_without_a_profiler(kind, tmp_path):
    plain = run_step(kind, make(kind, tmp_path / "plain"))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        traced = run_step(kind, make(kind, tmp_path / "traced"))
    assert by_name(prof, f"{kind}.render.bwd")
    assert plain[0] == traced[0]
    leaves_equal(plain[1], traced[1])


def test_no_span_node_without_a_profiler(tmp_path, monkeypatch):
    spans = P.BackwardSpans()
    x = torch.ones(3, requires_grad=True)
    assert not spans.on and spans.end("t.bwd", {"x": x})["x"] is x
    assert spans.begin("t.bwd", (x,))[0] is x

    def refuse(*a):
        raise AssertionError("a span node entered the graph without a profiler")

    monkeypatch.setattr(P._OnBackward, "apply", refuse)
    tr = object_trainer(tmp_path)
    assert np.isfinite(tr.train_step())


class _Raise(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        raise RuntimeError("backward stops here")


@pytest.mark.parametrize("how", ["stops", "raises"])
def test_no_range_left_open_when_a_backward_skips_the_close(how):
    """The backward opens `t.bwd` at the gradient of `y` and never reaches
    the node on `x` that closes it: it is asked for `y`'s gradient alone,
    or a node between the two raises. `close()`, the step's end, ends the
    range: a range opened after it is not inside it."""
    x = torch.randn(8, requires_grad=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        spans = P.BackwardSpans()
        (xa,) = spans.end("t.bwd", (x,))
        y = xa * 2.0
        if how == "raises":
            y = _Raise.apply(y)
        (yb,) = spans.begin("t.bwd", (y,))
        loss = (yb ** 2).sum()
        try:
            if how == "stops":
                loss.backward(inputs=[y])
                assert y.grad is not None and x.grad is None
            else:
                with pytest.raises(RuntimeError, match="backward stops here"):
                    loss.backward()
        finally:
            spans.close()
        assert not spans._held
        with record_function("t.after"):
            torch.ones(2).sum()
    names = by_name(prof, "t.")
    (after,) = names["t.after"]
    assert after.cpu_parent is None
    assert all(e.time_range.end <= after.time_range.start for e in names.get("t.bwd", []))


def test_device_busy_counts_overlapping_kernels_once():
    cuda = torch.autograd.DeviceType.CUDA

    def ev(s, e, name="k", dev=cuda, note=False):
        return types.SimpleNamespace(time_range=types.SimpleNamespace(start=s, end=e),
                                     device_type=dev, name=name, is_user_annotation=note)

    events = [ev(0, 100), ev(50, 150), ev(60, 80), ev(200, 300), ev(300, 310),
              ev(0, 1000, "fps.step", note=True), ev(400, 900, "fps.render"),
              ev(0, 5000, "aten::mm", dev=torch.autograd.DeviceType.CPU)]
    # [0, 150] and [200, 310] once each; the range and the host op left out
    assert P.busy_ms_of(events, skip=("fps.",)) == pytest.approx(0.26)
    # a device event named like no range counts, also under a range's name
    assert P.busy_ms_of(events) == pytest.approx(0.76)
    assert P.busy_ms_of(events[:3]) == pytest.approx(0.15)
    assert P.busy_ms_of([]) == 0.0


def test_every_attention_call_opens_one_attention_range():
    """Each `Attention` / `VAEAttention` call of a tiny UNet pass and VAE
    encode records one `sd.attention` range around its core: the scores'
    softmax lies inside it, the q/k/v and output projections outside."""
    from dreamscene_tpu_torch.guidance import sd_modules as sdm

    gen = torch.Generator().manual_seed(0)
    unet = sdm.init_random_(sdm.UNet2DCondition(sdm.tiny_unet_config()), gen).eval()
    enc = sdm.init_random_(sdm.VAEEncoder(sdm.tiny_vae_config()), gen).eval()
    calls = []
    for mod in [*unet.modules(), *enc.modules()]:
        if isinstance(mod, (sdm.Attention, sdm.VAEAttention)):
            mod.register_forward_hook(lambda m, *_: calls.append(type(m).__name__))
    lat = torch.randn((2, 4, 8, 8), generator=gen)
    ctx = torch.randn((2, 4, 32), generator=gen)
    img = torch.rand((2, 3, 16, 16), generator=gen)
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU]) as prof:
        unet(lat, torch.full((2,), 500), ctx)
        enc(img)
    ranges = by_name(prof, "sd.")
    assert list(ranges) == ["sd.attention"]
    assert len(ranges["sd.attention"]) == len(calls)
    assert sorted(set(calls)) == ["Attention", "VAEAttention"]
    events = list(prof.events())
    for r in ranges["sd.attention"]:
        held = {e.name for e in events if e is not r and inside(e, r)}
        assert "aten::softmax" in held, held
        assert "aten::linear" not in held, held
