"""The port's checkpoint loader against the JAX package's, on synthetic
diffusers-layout directories written under tmp_path (no checkpoint is
downloaded): the safetensors reader, the UNet config's three
`attention_head_dim` cases with SD1.x's 1x1-conv projections, strict
loading, the schedule, the ControlNet, the CLIP text encoder (against
FlaxCLIPTextModel, both activations), the tokenizer (against
transformers' CLIPTokenizer, as installed here without ftfy) and textual
inversion.

The weights are the port's own seeded random modules, written as F32 and
F16 safetensors (the `safetensors` package) and as a torch `.bin`; both
loaders read the same files. The SD configs compute in float32 here (the
loaders' UNetConfig and VAEConfig are patched to float32 and a small VAE)
so that eps and residuals compare at atol 1e-4.

Tolerances: tensors read bit-equal; eps and ControlNet residuals atol
1e-4 * max(1, max|ref|) (float32 on both sides through the 4-block trunk,
whose residuals reach |4| here); text embeddings atol 1e-5; token ids
equal.
"""

import collections
import functools
import json
import re
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from dreamscene_tpu.guidance import sd_flax as JSF
from dreamscene_tpu.guidance import sd_loader as JL
from dreamscene_tpu.utils.config import GuidanceParams as JGuidanceParams
from dreamscene_tpu_torch.guidance import clip_text as TC
from dreamscene_tpu_torch.guidance import sd_loader as TL
from dreamscene_tpu_torch.guidance import sd_modules as sdm
from dreamscene_tpu_torch.utils import safetensors as TS
from dreamscene_tpu_torch.utils.config import GuidanceParams

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
ATOL = 1e-4
UNET_JSON = {"block_out_channels": [32, 32, 64, 64], "cross_attention_dim": 32}
HEADS = {"head count (SD1.x)": 8, "head width": 32, "list": [16, 16, 16, 16]}
SMALL_VAE = dict(block_out_channels=(32, 32), layers_per_block=1, num_groups=8)
TEXT = dict(hidden_size=32, intermediate_size=64, num_hidden_layers=2, num_attention_heads=4,
            max_position_embeddings=77)
SCHEDULER = {"num_train_timesteps": 1000, "beta_start": 0.001, "beta_end": 0.015,
             "beta_schedule": "scaled_linear", "prediction_type": "v_prediction",
             "set_alpha_to_one": True}


def shipped_prompts() -> list:
    """Every prompt-like string of the shipped configs."""
    keys = r"(?:text|negative_text|scene_text|style_prompt|style_negative_prompt|init_prompt)"
    out = []
    for p in sorted((ROOT / "configs").rglob("*.yaml")):
        for m in re.finditer(rf"^\s*{keys}\s*:\s*(['\"])(.*)\1\s*$", p.read_text(), re.M):
            out.append(m.group(2))
    return out


EDGE_PROMPTS = [
    "A photo of a RED apple!", "wow!! it's <thing> <Thing> <style>_1 ok", "don't WE'LL they'RE",
    "café naïve café 123 3.14 ½ ² x_y", "  tabs\tand\nnewlines  ", "日本語 text 中文",
    "(foo) [bar] 'quoted' \"dq\" €5 — dash?!", "x\x00y​z\x07w", "", "!!!",
    "a photo of a sofa " * 30]


def write_tokenizer(d: Path, corpus: str, n_merges: int = 300, pad: str = "!") -> int:
    """vocab.json / merges.txt learned by plain BPE on `corpus` (byte
    symbols, `</w>` word ends, CLIP's layout: bytes, bytes + </w>, merges,
    then the two special tokens), tokenizer_config.json padding with
    <|endoftext|> and special_tokens_map.json padding with `pad` (as SD2.x
    ships them). Returns the vocabulary size."""
    d.mkdir(parents=True, exist_ok=True)
    chars = list(TC.bytes_to_unicode().values())
    vocab = chars + [c + "</w>" for c in chars]
    words = collections.Counter()
    for w in re.findall(r"[a-z]+", corpus.lower()):
        words[tuple(w[:-1]) + (w[-1] + "</w>",)] += 1
    merges = []
    for _ in range(n_merges):
        pairs = collections.Counter()
        for w, c in words.items():
            for pair in zip(w, w[1:]):
                pairs[pair] += c
        if not pairs:
            break
        (a, b), _ = pairs.most_common(1)[0]
        merges.append(f"{a} {b}")
        vocab.append(a + b)
        merged = collections.Counter()
        for w, c in words.items():
            out, i = [], 0
            while i < len(w):
                if i < len(w) - 1 and (w[i], w[i + 1]) == (a, b):
                    out.append(a + b)
                    i += 2
                else:
                    out.append(w[i])
                    i += 1
            merged[tuple(out)] += c
        words = merged
    vocab += [TC.BOS, TC.EOS]
    (d / "vocab.json").write_text(json.dumps({t: i for i, t in enumerate(vocab)}))
    (d / "merges.txt").write_text("#version: 0.2\n" + "\n".join(merges) + "\n")
    (d / "tokenizer_config.json").write_text(json.dumps({
        "model_max_length": 77, "do_lower_case": True, "pad_token": TC.EOS,
        "tokenizer_class": "CLIPTokenizer", "eos_token": TC.EOS, "unk_token": TC.EOS,
        "bos_token": {"content": TC.BOS, "lstrip": False, "normalized": True, "rstrip": False,
                      "single_word": False, "__type": "AddedToken"}}))
    (d / "special_tokens_map.json").write_text(json.dumps({
        "pad_token": pad, "bos_token": TC.BOS, "eos_token": TC.EOS, "unk_token": TC.EOS}))
    return len(vocab)


def write_text_encoder(d: Path, vocab_size: int, act: str, seed: int = 0):
    from transformers import CLIPTextConfig, CLIPTextModel

    torch.manual_seed(seed)
    cfg = CLIPTextConfig(vocab_size=vocab_size, hidden_act=act, bos_token_id=vocab_size - 2,
                         eos_token_id=vocab_size - 1, pad_token_id=0, **TEXT)
    CLIPTextModel(cfg).save_pretrained(str(d))


def port_modules(seed=0):
    """Seeded random UNet, small VAE and ControlNet (zero convs filled) of
    the port, as diffusers state dicts."""
    ucfg = sdm.UNetConfig(block_out_channels=tuple(UNET_JSON["block_out_channels"]),
                          cross_attention_dim=32, attention_head_dim=16, dtype=torch.float32)
    vcfg = sdm.VAEConfig(dtype=torch.float32, **SMALL_VAE)
    gen = torch.Generator().manual_seed(seed)
    unet = sdm.init_random_(sdm.UNet2DCondition(ucfg), gen)
    vae = {**sdm.init_random_(sdm.VAEEncoder(vcfg), gen).state_dict(),
           **sdm.init_random_(sdm.VAEDecoder(vcfg), gen).state_dict()}
    cn = sdm.init_random_(sdm.ControlNet(ucfg), gen)
    with torch.no_grad():
        for m in cn.modules():
            if getattr(m, "zero_init", False):
                m.weight.normal_(0.0, 0.2, generator=gen)
                m.bias.normal_(0.0, 0.2, generator=gen)
    return unet.state_dict(), vae, cn.state_dict()


def write_checkpoint(d: Path, heads, sd1_projections=False, text_act="gelu") -> dict:
    """A diffusers-layout directory: unet/ (F32 safetensors), vae/ (.bin),
    controlnet/ (F16 safetensors), text_encoder/, tokenizer/, scheduler/.
    Returns the state dicts written."""
    from safetensors.torch import save_file

    unet, vae, cn = port_modules()
    if sd1_projections:     # SD1.x: 1x1 convs
        unet = {k: (v[:, :, None, None] if re.search(r"\.proj_(in|out)\.weight$", k) else v)
                for k, v in unet.items()}
    for sub in ("unet", "vae", "controlnet", "scheduler"):
        (d / sub).mkdir(parents=True, exist_ok=True)
    (d / "unet" / "config.json").write_text(json.dumps({**UNET_JSON, "attention_head_dim": heads}))
    save_file({k: v.contiguous() for k, v in unet.items()},
              str(d / "unet" / "diffusion_pytorch_model.safetensors"))
    torch.save(vae, str(d / "vae" / "diffusion_pytorch_model.bin"))
    save_file({k: v.half().contiguous() for k, v in cn.items()},
              str(d / "controlnet" / "diffusion_pytorch_model.safetensors"))
    (d / "scheduler" / "scheduler_config.json").write_text(json.dumps(SCHEDULER))
    n = write_tokenizer(d / "tokenizer", " ".join(shipped_prompts()))
    write_text_encoder(d / "text_encoder", n, text_act)
    return dict(unet=unet, vae=vae, cn=cn)


@pytest.fixture
def float32_loaders(monkeypatch):
    """Both loaders build float32 SD configs and a small VAE."""
    monkeypatch.setattr(JL, "UNetConfig", functools.partial(JSF.UNetConfig, dtype=jnp.float32))
    monkeypatch.setattr(JL, "VAEConfig", functools.partial(JSF.VAEConfig, dtype=jnp.float32,
                                                           **SMALL_VAE))
    monkeypatch.setattr(TL, "UNetConfig", functools.partial(sdm.UNetConfig, dtype=torch.float32))
    monkeypatch.setattr(TL, "VAEConfig", functools.partial(sdm.VAEConfig, dtype=torch.float32,
                                                           **SMALL_VAE))


def close(got, ref):
    ref = np.asarray(ref)
    np.testing.assert_allclose(got, ref, atol=ATOL * max(1.0, float(np.abs(ref).max())))


@pytest.mark.parametrize("case", list(HEADS))
def test_build_sd_guidance_matches_jax(tmp_path, float32_loaders, case):
    d = tmp_path / "sd"
    write_checkpoint(d, HEADS[case], sd1_projections=case.startswith("head count"))
    jgp, tgp = JGuidanceParams(), GuidanceParams()
    jgp.controlnet_model_key = tgp.controlnet_model_key = str(d / "controlnet")
    jg = JL.build_sd_guidance(str(d), jgp)
    tg = TL.build_sd_guidance(str(d), tgp, device="cpu")
    want_heads = {"head count (SD1.x)": (8, 4), "head width": (1, 32), "list": (2, 16)}[case]
    assert tg.mods.unet.cfg.heads_for(32) == jg.mods.unet_apply.__self__.config.heads_for(32) \
        == want_heads

    ja, ta = jg.mods.schedule, tg.mods.schedule
    np.testing.assert_array_equal(ta.alphas_cumprod.numpy(), np.asarray(ja.alphas_cumprod))
    assert float(ta.final_alpha_cumprod) == float(ja.final_alpha_cumprod) == 1.0
    assert ta.prediction_type == ja.prediction_type == "v_prediction"
    assert tg.mods.downscale == jg.mods.downscale == 8

    rng = np.random.RandomState(0)
    lat = rng.randn(2, 8, 8, 4).astype(np.float32)
    t = np.array([13, 700], np.int32)
    prompts = ["a DSLR photo of a red apple", ""]
    jemb = np.asarray(jg.get_text_embeds(prompts))
    temb = tg.get_text_embeds(prompts)
    assert jemb.shape == (2, 77, 32)
    np.testing.assert_allclose(temb.numpy(), jemb, atol=1e-5)
    ctx = jnp.asarray(jemb)
    hint = rng.rand(2, 64, 64, 3).astype(np.float32)
    jres = jg.mods.controlnet_apply(jg.mods.controlnet_params, jnp.asarray(lat), jnp.asarray(t),
                                    ctx, jnp.asarray(hint))
    with torch.no_grad():
        tres = tg.mods.controlnet(torch.from_numpy(lat).permute(0, 3, 1, 2), torch.from_numpy(t),
                                  torch.from_numpy(jemb), torch.from_numpy(hint))
        got = tg.mods.unet(torch.from_numpy(lat).permute(0, 3, 1, 2), torch.from_numpy(t),
                           torch.from_numpy(jemb), control_res=tres).permute(0, 2, 3, 1)
    for a, b in zip(jres[0] + (jres[1],), tres[0] + [tres[1]]):
        assert np.abs(np.asarray(a)).max() > 1e-2
        close(b.permute(0, 2, 3, 1).numpy(), a)
    ref = jg.mods.unet_apply(jg.mods.unet_params, jnp.asarray(lat), jnp.asarray(t), ctx,
                             control_res=jres)
    close(got.numpy(), ref)
    img = rng.uniform(-1, 1, (1, 16, 16, 3)).astype(np.float32)
    with torch.no_grad():
        moments = tg.mods.vae_encoder(torch.from_numpy(img).permute(0, 3, 1, 2))
    close(moments.permute(0, 2, 3, 1).numpy(),
          jg.mods.vae_encode(jg.mods.vae_encode_params, jnp.asarray(img)))


def test_strict_loading_raises(tmp_path, float32_loaders):
    from safetensors.torch import save_file

    d = tmp_path / "sd"
    sds = write_checkpoint(d, 8)
    gp = GuidanceParams()
    path = str(d / "unet" / "diffusion_pytorch_model.safetensors")
    unet = dict(sds["unet"])
    unet.pop("mid_block.attentions.0.proj_in.bias")
    save_file(unet, path)
    with pytest.raises(RuntimeError, match="proj_in.bias"):
        TL.build_sd_guidance(str(d), gp, device="cpu")
    save_file({**sds["unet"], "extra.weight": torch.zeros(2)}, path)
    with pytest.raises(RuntimeError, match="extra.weight"):
        TL.build_sd_guidance(str(d), gp, device="cpu")
    (d / "vae" / "diffusion_pytorch_model.bin").unlink()
    with pytest.raises(FileNotFoundError):
        TL.load_torch_state(str(d / "vae"))


def test_safetensors_reader_matches_package(tmp_path):
    from safetensors.numpy import load_file as np_load, save_file as np_save
    from safetensors.torch import load_file as t_load, save_file as t_save

    rng = np.random.RandomState(0)
    arrays = {"w": rng.randn(3, 5).astype(np.float32), "h": rng.randn(7).astype(np.float16),
              "ids": np.arange(77, dtype=np.int64)[None], "empty": np.zeros((0, 4), np.float32)}
    np_save(arrays, str(tmp_path / "a.safetensors"), metadata={"format": "pt"})
    got, ref = TS.load_file(str(tmp_path / "a.safetensors")), np_load(str(tmp_path / "a.safetensors"))
    assert set(got) == set(ref) == set(arrays)
    for k, v in ref.items():
        assert got[k].numpy().dtype == v.dtype, k
        np.testing.assert_array_equal(got[k].numpy(), v)
    bf = {"b": torch.randn(4, 6).bfloat16()}
    t_save(bf, str(tmp_path / "b.safetensors"))
    got = TS.load_file(str(tmp_path / "b.safetensors"))
    assert got["b"].dtype == torch.bfloat16
    assert torch.equal(got["b"], t_load(str(tmp_path / "b.safetensors"))["b"])
    np_save({"d": np.ones(3, np.float64)}, str(tmp_path / "c.safetensors"))
    with pytest.raises(ValueError, match="F64"):
        TS.load_file(str(tmp_path / "c.safetensors"))


@pytest.mark.parametrize("act", ["quick_gelu", "gelu"])
def test_clip_text_model_matches_flax(tmp_path, act):
    from transformers import FlaxCLIPTextModel

    write_text_encoder(tmp_path, 600, act)
    ref = FlaxCLIPTextModel.from_pretrained(str(tmp_path), from_pt=True)
    model = TC.CLIPTextModel(json.loads((tmp_path / "config.json").read_text()))
    model.load_state_dict(TL.load_torch_state(str(tmp_path)), strict=True)
    ids = np.random.RandomState(1).randint(0, 600, (3, 77))
    want = np.asarray(ref(input_ids=jnp.asarray(ids))[0])
    with torch.no_grad():
        got = model(torch.from_numpy(ids)).numpy()
    assert want.shape == got.shape == (3, 77, 32)
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("pad", ["!", TC.EOS])
def test_tokenizer_matches_transformers(tmp_path, pad):
    from transformers import CLIPTokenizer

    prompts = shipped_prompts()
    assert len(prompts) > 20
    write_tokenizer(tmp_path, " ".join(prompts), pad=pad)
    ref, tok = CLIPTokenizer.from_pretrained(str(tmp_path)), TC.CLIPTokenizer(str(tmp_path))
    assert tok.model_max_length == ref.model_max_length == 77
    added = ["<thing>", "<style>", "<style>_1"]
    assert tok.add_tokens(added) == ref.add_tokens(added) == 3
    views = [f"{p}, {v} view, {s}" for p in prompts[:4] for v in ("front", "side", "overhead")
             for s in prompts[-2:]]
    for p in prompts + views + EDGE_PROMPTS:
        want = ref(p, padding="max_length", max_length=77, truncation=True).input_ids
        assert tok([p])[0].tolist() == want, p


@pytest.mark.parametrize("fmt", ["bin", "safetensors", "a1111"])
def test_textual_inversion_matches_jax_loader(tmp_path, fmt):
    """The JAX loader's embedding table and token registration (its
    `load_textual_inversion` on transformers' tokenizer and
    FlaxCLIPTextModel) against the port's; the encodings against a Flax
    CLIP configured with the grown vocabulary, since FlaxCLIPTextModel
    rejects a table larger than its config (the JAX encoder fails there)."""
    from safetensors.torch import save_file
    from transformers import CLIPTokenizer, FlaxCLIPTextModel

    d = tmp_path / "sd"
    n = write_tokenizer(d / "tokenizer", " ".join(shipped_prompts()))
    write_text_encoder(d / "text_encoder", n, "gelu")
    gen = torch.Generator().manual_seed(3)
    vec1, vec2 = torch.randn(32, generator=gen), torch.randn(2, 32, generator=gen)
    path = str(tmp_path / f"embeds.{'safetensors' if fmt == 'safetensors' else 'bin'}")
    if fmt == "bin":
        torch.save({"<thing>": vec1, "<style>": vec2}, path)
    elif fmt == "safetensors":
        save_file({"<thing>": vec1, "<style>": vec2}, path)
    else:
        torch.save({"string_to_param": {"*": vec2}, "name": "style", "step": 500}, path)

    tok = CLIPTokenizer.from_pretrained(str(d / "tokenizer"))
    model = FlaxCLIPTextModel.from_pretrained(str(d / "text_encoder"), from_pt=True)
    ptok = TC.CLIPTokenizer(str(d / "tokenizer"))
    pmodel = TC.CLIPTextModel(json.loads((d / "text_encoder" / "config.json").read_text()))
    pmodel.load_state_dict(TL.load_torch_state(str(d / "text_encoder")), strict=True)
    if fmt == "a1111":
        # its token "*" is a byte of CLIP's vocabulary already: both loaders
        # refuse it (add_tokens registers only "*_1")
        with pytest.raises(AssertionError, match=r"\*"):
            JL.load_textual_inversion(tok, model, path)
        with pytest.raises(ValueError, match=r"\*"):
            TC.load_textual_inversion(ptok, pmodel, path)
        return
    JL.load_textual_inversion(tok, model, path)
    table = np.asarray(model.params["text_model"]["embeddings"]["token_embedding"]["embedding"])
    n_new = 3
    assert table.shape == (n + n_new, 32)
    TC.load_textual_inversion(ptok, pmodel, path)
    np.testing.assert_array_equal(
        pmodel.text_model.embeddings.token_embedding.weight.detach().numpy(), table)
    assert len(ptok) == len(tok) == n + n_new

    prompts = ["a <thing> in <style> style", "<style>_1 <style> a sofa"]
    ids = tok(prompts, padding="max_length", max_length=77, truncation=True,
              return_tensors="np").input_ids
    assert (ids >= n).any()
    np.testing.assert_array_equal(ptok(prompts).numpy(), ids)
    grown = FlaxCLIPTextModel(model.config.__class__(**{**model.config.to_dict(),
                                                        "vocab_size": n + n_new}),
                              _do_init=False)
    want = np.asarray(grown(input_ids=jnp.asarray(ids), params=model.params)[0])
    encode = TC.make_clip_text_encoder(str(d), textual_inversion_path=path, device="cpu")
    np.testing.assert_allclose(encode(prompts).numpy(), want, atol=1e-5)
