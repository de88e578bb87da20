"""UNet passes replayed from CUDA graphs (guidance/unet_graph.py) on the
card: a replayed pass at SD 2.1 width against the eager pass, with and
without the ControlNet's hint; two ladders through the cache (the first
all eager, the second captured and replayed) against the eager ladder rung
by rung; K4's launch count per pass, replayed or eager;
weights replaced after the capture; and the pool an evicted graph frees.

CUDA graphs exist only on the card, so these tests skip elsewhere. On the
card (`-s` prints the largest gaps):

    python -m pytest tests/test_torch_unet_graph_cuda.py -m cuda -s
"""

import dataclasses
import weakref

import pytest
import torch

pytestmark = pytest.mark.cuda


def eager_passes(fn, modules, args):
    """A stack's `passes` that always runs the pass eagerly."""
    return fn(*args)


def stack(unet, controlnet=None, passes=None):
    """GuidanceModules over these modules, with an empty pass cache (or
    `passes` in its place)."""
    from dreamscene_tpu_torch.guidance import mtsd
    from dreamscene_tpu_torch.ops.ddim import make_schedule

    mods = mtsd.GuidanceModules(unet=unet, vae_encoder=None, vae_decoder=None,
                                scaling_factor=0.18215, schedule=make_schedule(device="cuda"),
                                controlnet=controlnet)
    if passes is not None:
        mods.passes = passes
    return mods


@pytest.fixture(scope="module")
def sd21():
    """The SD 2.1-width UNet and a ControlNet with seeded non-zero zero
    convs, bf16 compute, frozen."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs have no CPU mode")
    import chip_smoke as cs
    from dreamscene_tpu_torch.guidance import sd_modules as sdm

    gen = torch.Generator(device="cuda").manual_seed(20)
    cfg = sdm.sd21_unet_config()
    with torch.device("cuda"):
        unet = sdm.init_random_(sdm.UNet2DCondition(cfg), gen)
        cn = sdm.init_random_(sdm.ControlNet(cfg, downscale=8), gen)
    cs.fill_zero_convs(cn, gen, 0.02)
    for m in (unet, cn):
        m.requires_grad_(False).eval()
    return unet, cn


@pytest.fixture
def tiny():
    """The tiny UNet computing in bf16: K4 runs at its 32x32 level."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs have no CPU mode")
    from dreamscene_tpu_torch.guidance import sd_modules as sdm

    gen = torch.Generator(device="cuda").manual_seed(21)
    cfg = dataclasses.replace(sdm.tiny_unet_config(), dtype=torch.bfloat16)
    with torch.device("cuda"):
        unet = sdm.init_random_(sdm.UNet2DCondition(cfg), gen)
    return unet.requires_grad_(False).eval()


@pytest.fixture
def at_once(monkeypatch):
    """Every key captured on its first pass."""
    from dreamscene_tpu_torch.guidance import unet_graph as ug

    monkeypatch.setattr(ug, "CAPTURE_AT", 1)


def pass_inputs(gen, batch, size, ctx_shape, hint):
    """A pass's inputs as the ladder hands them over: NCHW views of NHWC
    latents, int32 timesteps, float32 text embeddings, the NHWC hint."""
    inp = torch.randn((batch, size, size, 4), generator=gen, device="cuda").permute(0, 3, 1, 2)
    t = torch.randint(0, 1000, (1,), generator=gen, device="cuda").int().expand(batch).clone()
    ctx = torch.randn((batch, *ctx_shape), generator=gen, device="cuda")
    cond3 = (torch.rand((batch, 8 * size, 8 * size, 3), generator=gen, device="cuda")
             if hint else None)
    return inp, t, ctx, cond3


def gap(a, b) -> float:
    return (a - b).abs().max().item()


@pytest.mark.parametrize("hint", [False, True])
def test_replayed_sd21_pass_equals_the_eager_pass(sd21, at_once, hint):
    from dreamscene_tpu_torch import kernels
    from dreamscene_tpu_torch.guidance import mtsd

    unet, cn = sd21
    mods = stack(unet, cn)
    gen = torch.Generator(device="cuda").manual_seed(22)
    kernels.reset_counts()
    with torch.no_grad():
        first = pass_inputs(gen, 12, 64, (77, 1024), hint)
        got_first = mtsd._apply_unet(mods, *first)
        calls = [pass_inputs(gen, 12, 64, (77, 1024), hint) for _ in range(2)]
        got = [mtsd._apply_unet(mods, *a) for a in calls]
        want = [mtsd._unet_pass(unet, cn, *a) for a in [first, *calls]]
    assert kernels.COUNTS["unet_graph.capture"] == 1
    assert kernels.COUNTS["unet_graph.replay"] == 2
    gaps = [gap(g, w) for g, w in zip([got_first, *got], want)]
    print(f"[unet_graph] SD 2.1 pass [12,4,64,64] hint={hint}: capture / replay max|d| vs "
          f"eager {gaps}, max|eps| {want[0].abs().max().item():.4g}")
    assert all(torch.equal(g, w) for g, w in zip([got_first, *got], want)), gaps


def test_ladder_through_the_cache_equals_the_eager_ladder(sd21):
    """Two 3-rung ladders (4 passes each) on one key: the first runs eager
    (a key is captured on its sixth pass), the second runs its first rung
    eager, captures at its second and replays its last two. Every rung's
    (cond, uncond, blank) and latent equal the eager ladder's (a replay
    that returned its static output would leave rung 2 reading rung 3's)."""
    from dreamscene_tpu_torch import kernels
    from dreamscene_tpu_torch.guidance import mtsd
    from dreamscene_tpu_torch.guidance import unet_graph as ug

    assert ug.CAPTURE_AT == 6
    unet, _ = sd21
    gen = torch.Generator(device="cuda").manual_seed(23)
    lat = torch.randn((4, 64, 64, 4), generator=gen, device="cuda")
    noise = torch.randn((4, 64, 64, 4), generator=gen, device="cuda")
    emb = torch.randn((12, 77, 1024), generator=gen, device="cuda")
    mods = stack(unet)
    want = mtsd.ladder_scores(stack(unet, passes=eager_passes), lat, noise, [200, 400, 600],
                              emb)
    kernels.reset_counts()
    first = mtsd.ladder_scores(mods, lat, noise, [200, 400, 600], emb)
    assert kernels.COUNTS[ug.EAGER] == 4 and not mods.passes.entries
    got = mtsd.ladder_scores(mods, lat, noise, [200, 400, 600], emb)
    assert kernels.COUNTS[ug.EAGER] == 5
    assert kernels.COUNTS[ug.CAPTURE] == 1 and kernels.COUNTS[ug.REPLAY] == 2
    gaps = []
    for ladder in (first, got):
        for (t_g, eps_g, lat_g), (t_w, eps_w, lat_w) in zip(ladder, want, strict=True):
            assert t_g == t_w
            gaps.append(max(gap(a, b) for a, b in zip((*eps_g, lat_g), (*eps_w, lat_w))))
            assert all(torch.equal(a, b) for a, b in zip((*eps_g, lat_g), (*eps_w, lat_w)))
    # the rungs differ from each other, so equality above pins the clone
    assert all(not torch.equal(got[i][1][2], got[-1][1][2]) for i in range(len(got) - 1))
    print(f"[unet_graph] two 3-rung ladders, max|d| vs eager by rung: {gaps}")


@pytest.mark.parametrize("hint, per_pass", [(False, 10), (True, 14)])
def test_k4_counts_the_same_per_pass_replayed_or_eager(sd21, at_once, hint, per_pass):
    from dreamscene_tpu_torch import kernels
    from dreamscene_tpu_torch.guidance import mtsd

    unet, cn = sd21
    gen = torch.Generator(device="cuda").manual_seed(24)
    args = pass_inputs(gen, 12, 64, (77, 1024), hint)
    eager, graphed = stack(unet, cn, passes=eager_passes), stack(unet, cn)
    deltas = []
    with torch.no_grad():
        for mods in (eager, graphed, graphed, graphed):     # eager, capture, 2 replays
            before = kernels.COUNTS.copy()
            mtsd._apply_unet(mods, *args)
            deltas.append({k: kernels.COUNTS[k] - before[k] for k in ("flash_fwd",
                                                                      "flash_fwd.tc")})
    assert deltas == [{"flash_fwd": per_pass, "flash_fwd.tc": per_pass}] * 4, deltas


@pytest.mark.parametrize("change", ["parameter", "data", "module", "in_place"])
def test_a_weight_changed_after_the_capture_is_never_replayed_stale(tiny, at_once, change):
    from dreamscene_tpu_torch import kernels
    from dreamscene_tpu_torch.guidance import mtsd
    from dreamscene_tpu_torch.guidance import sd_modules as sdm

    unet = tiny
    mods = stack(unet)
    gen = torch.Generator(device="cuda").manual_seed(25)
    args = pass_inputs(gen, 6, 32, (4, 32), False)
    kernels.reset_counts()
    with torch.no_grad():
        before = [mtsd._apply_unet(mods, *args) for _ in range(2)]
        w = unet.conv_in.weight
        new = torch.randn(w.shape, generator=gen, device="cuda") * w.std()
        if change == "parameter":
            unet.conv_in.weight = torch.nn.Parameter(new, requires_grad=False)
        elif change == "data":
            w.data = new
        elif change == "module":
            conv = sdm.Conv(w.shape[1], w.shape[0], 3, unet.cfg.dtype, padding=1).cuda()
            conv.weight.copy_(new)
            conv.bias.copy_(unet.conv_in.bias)
            unet.conv_in = conv.requires_grad_(False)
        else:
            w.copy_(new)
        got = mtsd._apply_unet(mods, *args)
        want = mtsd._unet_pass(unet, None, *args)
    assert torch.equal(before[0], before[1])
    assert not torch.equal(want, before[0])
    assert torch.equal(got, want), gap(got, want)
    recaptured = change != "in_place"
    assert kernels.COUNTS["unet_graph.capture"] == 1 + recaptured
    assert kernels.COUNTS["unet_graph.replay"] == 2 - recaptured


def test_eviction_releases_the_pool(tiny, at_once, monkeypatch):
    """Capacity 1 over two batch sizes: capturing the second evicts the
    first, whose graph is freed; its pool's segments are gone once the
    cache returns free memory, and so are the second's when the cache is
    dropped."""
    from dreamscene_tpu_torch import kernels
    from dreamscene_tpu_torch.guidance import mtsd
    from dreamscene_tpu_torch.guidance import unet_graph as ug

    def pools():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        return {tuple(s["segment_pool_id"]) for s in torch.cuda.memory_snapshot()}

    monkeypatch.setattr(ug, "CAPACITY", 1)
    mods = stack(tiny)
    gen = torch.Generator(device="cuda").manual_seed(26)
    a = pass_inputs(gen, 6, 32, (4, 32), False)
    b = pass_inputs(gen, 12, 32, (4, 32), False)
    kernels.reset_counts()
    with torch.no_grad():
        mtsd._apply_unet(mods, *a)
        (entry_a,) = mods.passes.entries.values()
        graph_a, pool_a = weakref.ref(entry_a.graph), tuple(mods.passes.shared[a[0].device][1])
        del entry_a
        assert pool_a in pools()
        mtsd._apply_unet(mods, *b)
        pool_b = tuple(mods.passes.shared[b[0].device][1])
        assert graph_a() is None and len(mods.passes.entries) == 1
        live = pools()
        assert pool_a not in live and pool_b in live
        for x in (a, b, a):
            mtsd._apply_unet(mods, *x)
    assert kernels.COUNTS["unet_graph.capture"] == 5
    mods.passes = ug.UNetPasses()
    assert not {pool_a, pool_b} & pools()
