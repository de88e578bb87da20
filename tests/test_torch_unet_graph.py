"""The UNet pass cache (guidance/unet_graph.py) on the CPU: the dispatcher
stays eager on CPU tensors and with autograd recording, counting each pass
once; the cache's keys, its least-recently-used bound and the pass of a
key that captures it, with the capture stubbed out; the weights' change
detection; and the CPU ladders' outputs,
bit for bit those of passes run straight through.

The graphs themselves run only on the card:
tests/test_torch_unet_graph_cuda.py.
"""

import types

import pytest
import torch

from dreamscene_tpu_torch import kernels
from dreamscene_tpu_torch.guidance import mtsd
from dreamscene_tpu_torch.guidance import sd_modules as sdm
from dreamscene_tpu_torch.guidance import unet_graph as ug

torch.set_num_threads(1)

GOPT = types.SimpleNamespace(noise_seed=0, fix_noise=False)


def eager_passes(fn, modules, args):
    return fn(*args)


@pytest.fixture(scope="module")
def tiny():
    return mtsd.make_tiny_guidance(GOPT, device="cpu", with_controlnet=True)


def ladder_inputs(g, b=2, size=8, seed=0):
    gen = torch.Generator().manual_seed(seed)
    lat = torch.randn((b, size, size, 4), generator=gen)
    noise = torch.randn((b, size, size, 4), generator=gen)
    emb = g.get_text_embeds([f"p{i}" for i in range(3 * b)])
    hint = torch.rand((b, size * g.mods.downscale, size * g.mods.downscale, 3), generator=gen)
    return lat, noise, emb, hint


@pytest.mark.parametrize("hint", [False, True])
def test_cpu_passes_stay_eager_and_count_once_each(tiny, hint):
    lat, noise, emb, h = ladder_inputs(tiny)
    kernels.reset_counts()
    mtsd.ladder_scores(tiny.mods, lat, noise, [200, 400, 600], emb,
                       cond_image=h if hint else None)
    assert kernels.COUNTS[ug.EAGER] == 4
    assert kernels.COUNTS[ug.CAPTURE] == kernels.COUNTS[ug.REPLAY] == 0
    assert not tiny.mods.passes.entries


def test_grad_enabled_pass_stays_eager(tiny):
    lat, _, emb, _ = ladder_inputs(tiny)
    inp = lat.repeat(3, 1, 1, 1).permute(0, 3, 1, 2).clone().requires_grad_(True)
    t = torch.full((inp.shape[0],), 300, dtype=torch.int32)
    kernels.reset_counts()
    with torch.enable_grad():
        eps = mtsd._apply_unet(tiny.mods, inp, t, emb, None)
        eps.sum().backward()
    assert inp.grad is not None
    assert kernels.COUNTS[ug.EAGER] == 1 and not tiny.mods.passes.entries


class FakeCuda:
    """What `graphable` reads of a tensor on the card."""
    is_cuda = True


@pytest.mark.parametrize("grad, tensors, expect", [
    (True, [FakeCuda()], False),                 # autograd recording
    (False, [torch.zeros(1)], False),            # a CPU tensor
    (False, [FakeCuda(), torch.zeros(1)], False),
    (True, [torch.zeros(1)], False),
])
def test_graphable_refuses_grad_and_cpu_tensors(grad, tensors, expect):
    with torch.set_grad_enabled(grad):
        assert ug.graphable(tensors) is expect


class StubPass:
    """A capture that runs the pass eagerly and records its calls."""

    made = []

    def __init__(self, fn, modules, args, shared):
        self.fn, self.modules, self.out = fn, modules, fn(*args)
        self.stale = False
        StubPass.made.append(self)

    def fresh(self):
        return not self.stale

    def replay(self, args):
        return self.fn(*args)


@pytest.fixture
def stubbed(monkeypatch):
    """The graph path on CPU tensors, with `StubPass` in place of the
    capture and capacity 2."""
    StubPass.made = []
    monkeypatch.setattr(ug, "graphable", lambda tensors: True)
    monkeypatch.setattr(ug, "CapturedPass", StubPass)
    monkeypatch.setattr(ug, "CAPACITY", 2)
    kernels.reset_counts()
    return monkeypatch


@pytest.fixture
def at_once(stubbed):
    """`stubbed`, and every key captured on its first pass."""
    stubbed.setattr(ug, "CAPTURE_AT", 1)
    return stubbed


def args_of(b=2, dtype=torch.float32, hint=False, size=4):
    return (torch.zeros((3 * b, 4, size, size), dtype=dtype), torch.zeros((3 * b,), dtype=torch.int32),
            torch.zeros((3 * b, 4, 8)), torch.zeros((3 * b, 8 * size, 8 * size, 3)) if hint
            else None)


def total(*args):
    return sum(float(a.sum()) for a in args if a is not None)


UNET, CN = torch.nn.Linear(1, 1), torch.nn.Linear(1, 1)


@pytest.mark.parametrize("other", [
    dict(b=3),                       # a shape
    dict(dtype=torch.float64),       # a dtype
    dict(hint=True),                 # the hint present
    dict(size=8),                    # the latent size
])
def test_cache_keys_on_shape_dtype_and_hint(at_once, other):
    cache = ug.UNetPasses()
    base, changed = args_of(), args_of(**other)
    for args in (base, base, changed, base):
        cache(total, (UNET,), args)
    assert len(StubPass.made) == 2 and len(cache.entries) == 2
    assert kernels.COUNTS[ug.CAPTURE] == 2 and kernels.COUNTS[ug.REPLAY] == 2


def test_cache_keys_on_the_modules(at_once):
    at_once.setattr(ug, "CAPACITY", 4)
    cache = ug.UNetPasses()
    args = args_of()
    for modules in ((UNET,), (UNET, CN), (CN,), (UNET,), (UNET, CN)):
        cache(total, modules, args)
    assert [s.modules for s in StubPass.made] == [(UNET,), (UNET, CN), (CN,)]


def test_cache_holds_at_most_capacity_keys_least_recently_used_out(at_once):
    cache = ug.UNetPasses()
    a, b, c = args_of(b=1), args_of(b=2), args_of(b=3)
    for args in (a, b, a, c):          # c evicts b, the least recently used
        cache(total, (UNET,), args)
    assert len(cache.entries) == 2 and kernels.COUNTS[ug.CAPTURE] == 3
    cache(total, (UNET,), a)           # a stayed: a replay
    cache(total, (UNET,), b)           # b was evicted: captured again, c out
    assert kernels.COUNTS[ug.CAPTURE] == 4 and kernels.COUNTS[ug.REPLAY] == 2
    assert [k[1][0][0] for k in cache.entries] == [(3, 4, 4, 4), (6, 4, 4, 4)]


def test_a_stale_entry_is_captured_again_and_the_last_drop_frees_the_shared_pool(stubbed):
    cache = ug.UNetPasses()
    args = args_of()
    for _ in range(ug.CAPTURE_AT):
        cache(total, (UNET,), args)
    cache.shared["dev"] = "stream and pool"
    StubPass.made[0].stale = True
    kernels.reset_counts()
    cache(total, (UNET,), args)        # captured again at once, not counted from nothing
    assert len(StubPass.made) == 2 and len(cache.entries) == 1
    assert kernels.COUNTS[ug.CAPTURE] == 1 and kernels.COUNTS[ug.EAGER] == 0
    assert cache.shared == {}


def test_each_call_returns_its_own_inputs_pass(at_once):
    cache = ug.UNetPasses()
    ones, zeros = args_of(), args_of()
    for x in ones:
        if x is not None:
            x.fill_(1.0)
    assert cache(total, (UNET,), args_of()) == 0.0           # the capture's warm-up
    assert cache(total, (UNET,), ones) == total(*ones)       # replays
    assert cache(total, (UNET,), zeros) == 0.0


def test_a_key_stays_eager_until_its_capture_at_th_pass(stubbed):
    """A ladder is at most 5 passes, so a key that one ladder alone uses
    never captures; the sixth pass of a key captures, later ones replay."""
    assert ug.CAPTURE_AT > 5
    cache, one_off, hot = ug.UNetPasses(), args_of(b=1), args_of(b=4)
    for _ in range(5):                 # one ladder of the one-off key
        cache(total, (UNET,), one_off)
    assert kernels.COUNTS[ug.EAGER] == 5 and not StubPass.made and not cache.entries
    for _ in range(ug.CAPTURE_AT + 3):
        cache(total, (UNET,), hot)
    assert kernels.COUNTS[ug.EAGER] == 5 + ug.CAPTURE_AT - 1
    assert kernels.COUNTS[ug.CAPTURE] == 1 and kernels.COUNTS[ug.REPLAY] == 3
    assert list(cache.seen) == [ug.pass_key((UNET,), one_off)]


def test_eager_counts_are_kept_for_the_last_seen_keys(stubbed):
    stubbed.setattr(ug, "CAPTURE_AT", 2)
    stubbed.setattr(ug, "SEEN", 3)
    cache = ug.UNetPasses()
    keys = [args_of(b=b) for b in range(1, 5)]
    for args in keys:                  # b=1 is forgotten when b=4 is seen
        cache(total, (UNET,), args)
    assert len(cache.seen) == 3
    cache(total, (UNET,), keys[1])     # its second pass: captured
    cache(total, (UNET,), keys[0])     # forgotten: its first pass again
    assert kernels.COUNTS[ug.CAPTURE] == 1 and kernels.COUNTS[ug.EAGER] == 5


@pytest.mark.parametrize("change, unchanged", [
    ("parameter", False),    # a new Parameter in the slot
    ("data", False),         # .data assigned: new storage
    ("module", False),       # a submodule swapped
    ("buffer", False),       # a buffer replaced
    ("in_place", True),      # copy_ in place: the graph reads it
    ("none", True),
])
def test_weights_detect_what_a_replay_would_read_stale(change, unchanged):
    unet = sdm.UNet2DCondition(sdm.tiny_unet_config())
    unet.register_buffer("scale", torch.ones(1))
    w = ug.Weights((unet,))
    assert len(w.ptrs) == len(list(unet.parameters())) + 1
    conv = unet.conv_in
    if change == "parameter":
        conv.weight = torch.nn.Parameter(conv.weight.detach().clone())
    elif change == "data":
        conv.weight.data = conv.weight.detach().clone()
    elif change == "module":
        unet.conv_in = sdm.Conv(4, 32, 3, torch.float32, padding=1)
    elif change == "buffer":
        unet.scale = torch.ones(1)
    elif change == "in_place":
        with torch.no_grad():
            conv.weight.mul_(2.0)
    assert w.unchanged() is unchanged


@pytest.mark.parametrize("hint", [False, True])
@pytest.mark.parametrize("walk", ["ladder_scores", "denoise_ladder"])
def test_cpu_ladders_unchanged_bit_for_bit(tiny, walk, hint):
    """Through the stack's cache and through passes run straight, the CPU
    ladders give the same bits."""
    lat, noise, emb, h = ladder_inputs(tiny, seed=3)
    straight = mtsd.GuidanceModules(**{f: getattr(tiny.mods, f) for f in (
        "unet", "vae_encoder", "vae_decoder", "scaling_factor", "schedule", "downscale",
        "controlnet")})
    straight.passes = eager_passes
    kw = dict(cond_image=h if hint else None)
    if walk == "ladder_scores":
        got = mtsd.ladder_scores(tiny.mods, lat, noise, [200, 400, 600], emb, **kw)
        want = mtsd.ladder_scores(straight, lat, noise, [200, 400, 600], emb, **kw)
    else:
        got = mtsd.denoise_ladder(tiny.mods, lat, noise, [700, 450, 200], emb, 3, cfg=7.5, **kw)
        want = mtsd.denoise_ladder(straight, lat, noise, [700, 450, 200], emb, 3, cfg=7.5, **kw)
    assert len(got) == len(want) == (4 if walk == "ladder_scores" else 3)
    for (t_g, eps_g, lat_g), (t_w, eps_w, lat_w) in zip(got, want):
        assert t_g == t_w
        assert all(torch.equal(a, b) for a, b in zip((*eps_g, lat_g), (*eps_w, lat_w)))
