"""CLIP text encoder and tokenizer of a local diffusers checkpoint, torch.

The JAX package encodes prompts with transformers' CLIPTokenizer and
FlaxCLIPTextModel (guidance/sd_loader.py:429-448). The port keeps its own
copies, because the machines it runs on need not have transformers (nor
the `regex` package that CLIP's split pattern needs):
  * `CLIPTextModel` — token + position embeddings, pre-LN transformer
    layers under a causal mask (hidden_act `quick_gelu` for SD1.x, `gelu`
    for SD2.x), final layer norm; returns last_hidden_state [B, 77, D].
    Its state-dict keys are transformers' CLIPTextModel keys
    (text_model.embeddings.token_embedding.weight, ...);
  * `CLIPTokenizer` — transformers' slow CLIP tokenizer as it runs without
    ftfy: the special and added tokens are split out first (matched as
    written), the rest is cleaned (control characters dropped, whitespace
    runs collapsed, CJK characters spaced, NFC), lowercased, split by
    CLIP's pattern (special tokens, contractions, letter runs, single
    numbers, other runs; \\p{L} / \\p{N} read from unicodedata) and
    byte-level BPE'd with `</w>` word ends. Prompts are padded to
    model_max_length (77) with the pad token of special_tokens_map.json
    (else tokenizer_config.json), truncated to fit;
  * `make_clip_text_encoder` — both from `text_encoder/` and `tokenizer/`,
    with an optional textual-inversion embedding file.
"""

from __future__ import annotations

import json
import logging
import math
import os
import unicodedata
from functools import lru_cache

import torch
import torch.nn as nn
import torch.nn.functional as F

from dreamscene_tpu_torch.device import resolve_device
from dreamscene_tpu_torch.guidance.sd_loader import load_torch_state
from dreamscene_tpu_torch.utils.safetensors import load_file

logger = logging.getLogger("dreamscene_tpu_torch")
BOS, EOS = "<|startoftext|>", "<|endoftext|>"
CONTRACTIONS = ("'s", "'t", "'re", "'ve", "'m", "'ll", "'d")


# --------------------------------------------------------------------------
# text transformer
# --------------------------------------------------------------------------

class _Attention(nn.Module):
    def __init__(self, d, heads):
        super().__init__()
        self.heads = heads
        self.q_proj, self.k_proj = nn.Linear(d, d), nn.Linear(d, d)
        self.v_proj, self.out_proj = nn.Linear(d, d), nn.Linear(d, d)

    def forward(self, x, mask):
        b, n, d = x.shape
        hd = d // self.heads

        def split(t):
            return t.reshape(b, n, self.heads, hd).transpose(1, 2)

        q, k, v = split(self.q_proj(x)), split(self.k_proj(x)), split(self.v_proj(x))
        attn = torch.matmul(q, k.transpose(-1, -2)) * hd**-0.5
        attn = torch.softmax(attn.masked_fill(mask, float("-inf")), dim=-1)
        return self.out_proj(torch.matmul(attn, v).transpose(1, 2).reshape(b, n, d))


class _MLP(nn.Module):
    def __init__(self, d, inner, act):
        super().__init__()
        self.fc1, self.fc2 = nn.Linear(d, inner), nn.Linear(inner, d)
        self.act = act

    def forward(self, x):
        h = self.fc1(x)
        if self.act == "quick_gelu":
            h = h * torch.sigmoid(1.702 * h)
        elif self.act == "gelu":
            h = F.gelu(h)
        else:
            raise ValueError(f"unsupported hidden_act {self.act!r}")
        return self.fc2(h)


class _Layer(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        d, eps = cfg["hidden_size"], cfg.get("layer_norm_eps", 1e-5)
        self.self_attn = _Attention(d, cfg["num_attention_heads"])
        self.layer_norm1 = nn.LayerNorm(d, eps=eps)
        self.mlp = _MLP(d, cfg["intermediate_size"], cfg.get("hidden_act", "quick_gelu"))
        self.layer_norm2 = nn.LayerNorm(d, eps=eps)

    def forward(self, x, mask):
        x = x + self.self_attn(self.layer_norm1(x), mask)
        return x + self.mlp(self.layer_norm2(x))


class CLIPTextModel(nn.Module):
    """input_ids [B, L] -> last_hidden_state [B, L, D] (float32), from a
    transformers CLIPTextConfig dict (text_encoder/config.json)."""

    def __init__(self, cfg: dict):
        super().__init__()
        d = cfg["hidden_size"]
        self.text_model = nn.Module()
        emb = self.text_model.embeddings = nn.Module()
        emb.token_embedding = nn.Embedding(cfg["vocab_size"], d)
        emb.position_embedding = nn.Embedding(cfg["max_position_embeddings"], d)
        self.text_model.encoder = nn.Module()
        self.text_model.encoder.layers = nn.ModuleList(
            [_Layer(cfg) for _ in range(cfg["num_hidden_layers"])])
        self.text_model.final_layer_norm = nn.LayerNorm(d, eps=cfg.get("layer_norm_eps", 1e-5))

    def forward(self, input_ids):
        tm = self.text_model
        n = input_ids.shape[1]
        pos = torch.arange(n, device=input_ids.device)
        x = tm.embeddings.token_embedding(input_ids) + tm.embeddings.position_embedding(pos)
        mask = torch.ones((n, n), dtype=torch.bool, device=x.device).triu(1)
        for layer in tm.encoder.layers:
            x = layer(x, mask)
        return tm.final_layer_norm(x)


# --------------------------------------------------------------------------
# tokenizer
# --------------------------------------------------------------------------

@lru_cache
def bytes_to_unicode() -> dict:
    """Byte -> printable character map of CLIP's byte-level BPE."""
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(2**8):
        if b not in bs:
            bs.append(b)
            cs.append(2**8 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _is_cjk(cp: int) -> bool:
    return any(lo <= cp <= hi for lo, hi in (
        (0x4E00, 0x9FFF), (0x3400, 0x4DBF), (0x20000, 0x2A6DF), (0x2A700, 0x2B73F),
        (0x2B740, 0x2B81F), (0x2B820, 0x2CEAF), (0xF900, 0xFAFF), (0x2F800, 0x2FA1F)))


def basic_clean(text: str) -> str:
    """Control characters dropped, whitespace collapsed to single spaces,
    CJK characters spaced, NFC, lowercased (transformers' BasicTokenizer
    with strip_accents=False and no punctuation split)."""
    out = []
    for ch in text:
        cp = ord(ch)
        if ch in " \t\n\r" or unicodedata.category(ch) == "Zs":
            out.append(" ")
        elif cp == 0 or cp == 0xFFFD or unicodedata.category(ch).startswith("C"):
            continue
        elif _is_cjk(cp):
            out.append(f" {ch} ")
        else:
            out.append(ch)
    text = unicodedata.normalize("NFC", "".join(out))
    return " ".join(w.lower() for w in text.split())


def _kind(ch: str) -> str:
    c = unicodedata.category(ch)[0]
    return c if c in "LN" else ("S" if ch.isspace() else "O")


def split_words(text: str) -> list[str]:
    """CLIP's split pattern: the special tokens, the contractions, runs of
    letters (\\p{L}), single numbers (\\p{N}), runs of anything else but
    whitespace; tried in that order at each position."""
    out, i, n = [], 0, len(text)
    while i < n:
        kind = _kind(text[i])
        if kind == "S":
            i += 1
            continue
        fixed = next((s for s in (BOS, EOS) + CONTRACTIONS if text.startswith(s, i)), None)
        if fixed is not None:
            j = i + len(fixed)
        elif kind == "N":
            j = i + 1
        else:
            j = i + 1
            while j < n and _kind(text[j]) == kind:
                j += 1
        out.append(text[i:j])
        i = j
    return out


def _token_content(tok) -> str | None:
    return tok.get("content") if isinstance(tok, dict) else tok


class CLIPTokenizer:
    """Byte-level BPE tokenizer of a `tokenizer/` directory (vocab.json,
    merges.txt, tokenizer_config.json, special_tokens_map.json)."""

    def __init__(self, path: str):
        with open(os.path.join(path, "vocab.json"), encoding="utf-8") as f:
            self.encoder = json.load(f)
        with open(os.path.join(path, "merges.txt"), encoding="utf-8") as f:
            merges = f.read().strip().split("\n")[1:49152 - 256 - 2 + 1]
        self.bpe_ranks = {tuple(m.split()): i for i, m in enumerate(merges)}
        special = {"bos_token": BOS, "eos_token": EOS, "unk_token": EOS, "pad_token": EOS}
        self.model_max_length = 77
        for name in ("tokenizer_config.json", "special_tokens_map.json"):
            p = os.path.join(path, name)
            if os.path.exists(p):
                with open(p, encoding="utf-8") as f:
                    cfg = json.load(f)
                special.update({k: _token_content(cfg[k]) for k in special if cfg.get(k)})
                self.model_max_length = cfg.get("model_max_length", self.model_max_length)
        self.special = special
        self.added: dict[str, int] = {}
        self.byte_encoder = bytes_to_unicode()
        self.cache = {BOS: BOS, EOS: EOS}

    def __len__(self):
        return len(self.encoder) + len(self.added)

    def token_id(self, token: str) -> int:
        if token in self.added:
            return self.added[token]
        return self.encoder.get(token, self.encoder.get(self.special["unk_token"]))

    def add_tokens(self, names) -> int:
        """Register new tokens (matched as written, never split); returns
        how many were new."""
        n = 0
        for name in names:
            if name not in self.encoder and name not in self.added:
                self.added[name] = len(self)
                n += 1
        return n

    def bpe(self, token: str) -> list[str]:
        if token in self.cache:
            return self.cache[token].split(" ")
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        while len(word) > 1:
            pairs = set(zip(word, word[1:]))
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, math.inf))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new, i = [], 0
            while i < len(word):
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    new.append(first + second)
                    i += 2
                else:
                    new.append(word[i])
                    i += 1
            word = tuple(new)
        self.cache[token] = " ".join(word)
        return list(word)

    def _pieces(self, text: str) -> list[str]:
        """The text split around the special and added tokens (leftmost,
        longest first)."""
        no_split = sorted(set(self.special.values()) | set(self.added), key=len, reverse=True)
        pieces, start, i = [], 0, 0
        while i < len(text):
            hit = next((t for t in no_split if text.startswith(t, i)), None)
            if hit is None:
                i += 1
                continue
            pieces += [text[start:i], hit]
            i = start = i + len(hit)
        pieces.append(text[start:])
        return [p for p in pieces if p]

    def tokenize(self, text: str) -> list[str]:
        out = []
        specials = set(self.special.values()) | set(self.added)
        for piece in self._pieces(text):
            if piece in specials:
                out.append(piece)
                continue
            for word in split_words(basic_clean(piece)):
                out += self.bpe("".join(self.byte_encoder[b] for b in word.encode("utf-8")))
        return out

    def __call__(self, prompts) -> torch.Tensor:
        """[B, model_max_length] int64 ids: <|startoftext|> tokens
        <|endoftext|>, truncated to fit, padded with the pad token."""
        n = self.model_max_length
        bos, eos, pad = (self.token_id(self.special[k])
                         for k in ("bos_token", "eos_token", "pad_token"))
        rows = []
        for p in prompts:
            ids = [self.token_id(t) for t in self.tokenize(p)][:n - 2]
            rows.append([bos] + ids + [eos] + [pad] * (n - 2 - len(ids)))
        return torch.tensor(rows, dtype=torch.int64)


# --------------------------------------------------------------------------
# checkpoint
# --------------------------------------------------------------------------

def load_textual_inversion(tok: CLIPTokenizer, model: CLIPTextModel, path: str) -> None:
    """Learned-embedding tokens into the tokenizer and the encoder's
    embedding table (reference: pipe.load_textual_inversion,
    multitime_sd_utils.py:104-106). Accepts the diffusers learned_embeds
    .bin / .safetensors format ({token: [n, D]}) and the A1111 variant
    ({"string_to_param": {"*": [n, D]}}); a multi-vector token expands to
    `tok`, `tok_1`, ... as in diffusers."""
    if path.endswith(".safetensors"):
        sd = load_file(path)
    else:
        # the A1111 format holds more than tensors
        sd = torch.load(path, map_location="cpu", weights_only=False)
    if "string_to_param" in sd:
        sd = {"*": list(sd["string_to_param"].values())[0]}
    emb = model.text_model.embeddings.token_embedding
    rows = [emb.weight.detach()]
    for token, vec in sd.items():
        vec = torch.as_tensor(vec).detach().float().to(emb.weight.device)
        if vec.ndim == 1:
            vec = vec[None]
        names = [token] + [f"{token}_{i}" for i in range(1, vec.shape[0])]
        added = tok.add_tokens(names)
        if added != len(names):
            raise ValueError(f"textual inversion token {token!r}: {len(names) - added} of "
                             f"its names are already tokens")
        rows.append(vec)
        logger.info("textual inversion: +%d vectors for %r", vec.shape[0], token)
    table = torch.cat(rows, 0)
    model.text_model.embeddings.token_embedding = nn.Embedding.from_pretrained(table)


def make_clip_text_encoder(model_dir: str, textual_inversion_path: str | None = None,
                           device="cuda"):
    """encode(list[str]) -> [B, 77, D] float32 on `device`, from the
    checkpoint's text_encoder/ and tokenizer/."""
    dev = resolve_device(device)
    tok = CLIPTokenizer(os.path.join(model_dir, "tokenizer"))
    with open(os.path.join(model_dir, "text_encoder", "config.json")) as f:
        cfg = json.load(f)
    model = CLIPTextModel(cfg)
    sd = load_torch_state(os.path.join(model_dir, "text_encoder"))
    # older checkpoints keep the position ids as a buffer; transformers ignores it
    sd.pop("text_model.embeddings.position_ids", None)
    model.load_state_dict(sd, strict=True)
    if textual_inversion_path:
        load_textual_inversion(tok, model, textual_inversion_path)
    model = model.to(dev).requires_grad_(False).eval()

    @torch.no_grad()
    def encode(prompts):
        return model(tok(prompts).to(dev))

    return encode
