"""CLIP-style text tower and its BPE tokenizer.

Counterpart of goi_tpu/query/clip_text.py. The reference embeds prompts
live with a frozen EVA02-CLIP text transformer
(ref:ext/clip_wrapper_eva02.py:50-148, ref:ext/eva02_clip/model.py:
250-262): token_embedding + positional embedding -> causal pre-LN
transformer -> ln_final -> projection, taken at the EOT token (the
argmax of the token ids). The weights are pluggable: convert an
open_clip-format text state dict with `convert_openclip_text_state` and
load it through `goi_tpu_torch.interop.clip_text_from_numpy`. The
architecture comes from a config, e.g. `CLIP_TEXT_BIGE` (the
EVA02-CLIP-bigE-14-plus text_cfg).

The tokenizer implements the public CLIP byte-pair encoding; the merge
table (`bpe_simple_vocab_16e6.txt.gz`) is supplied at run time. Without
the `regex` package it splits words with an ASCII pattern, which is
enough for English prompts.
"""

from __future__ import annotations

import dataclasses
import gzip
import html
import re
from collections import OrderedDict
from functools import lru_cache
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from goi_tpu_torch.query._nn import (gelu, init_by_rule_, layer_norm,
                                     linear, merge_heads, randn,
                                     split_heads)


# ---------------------------------------------------------------------------
# BPE tokenizer (CLIP SimpleTokenizer algorithm)
# ---------------------------------------------------------------------------

@lru_cache()
def bytes_to_unicode():
    """Reversible byte -> printable-unicode map (public GPT-2/CLIP BPE
    preliminary)."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _get_pairs(word):
    return {(word[i], word[i + 1]) for i in range(len(word) - 1)}


class ClipTokenizer:
    """CLIP BPE tokenizer. `bpe_path` points at the public
    bpe_simple_vocab_16e6.txt.gz merge table (or any gzip table in its
    format: a header line, then one merge per line)."""

    SOT = "<|startoftext|>"
    EOT = "<|endoftext|>"

    def __init__(self, bpe_path: str, context_length: int = 77):
        self.context_length = context_length
        self.byte_encoder = bytes_to_unicode()
        with gzip.open(bpe_path, "rt", encoding="utf-8") as f:
            lines = f.read().split("\n")
        merges = [tuple(m.split()) for m in
                  lines[1: 49152 - 256 - 2 + 1] if m]
        vocab = list(self.byte_encoder.values())
        vocab += [v + "</w>" for v in vocab]
        vocab += ["".join(m) for m in merges]
        vocab += [self.SOT, self.EOT]
        self.encoder: Dict[str, int] = {t: i for i, t in enumerate(vocab)}
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self.cache = {self.SOT: self.SOT, self.EOT: self.EOT}
        try:
            import regex
            self.pat = regex.compile(
                r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|"""
                r"""'ll|'d|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+""",
                regex.IGNORECASE)
            self._findall = self.pat.findall
        except ImportError:  # ascii fallback, fine for english prompts
            pat = re.compile(
                r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|"""
                r"""'ll|'d|[a-z]+|[0-9]|[^\sa-z0-9]+""", re.IGNORECASE)
            self._findall = pat.findall

    def _bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(
                p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: List[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if (i < len(word) - 1 and word[i] == first
                        and word[i + 1] == second):
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        text = html.unescape(html.unescape(text))
        text = re.sub(r"\s+", " ", text).strip().lower()
        ids: List[int] = []
        for tok in self._findall(text):
            tok = "".join(self.byte_encoder[b]
                          for b in tok.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self._bpe(tok).split(" "))
        return ids

    def __call__(self, texts, context_length: Optional[int] = None
                 ) -> np.ndarray:
        """List of prompts -> (B, context) int32 token matrix with
        SOT/EOT and zero padding (open_clip's tokenize; EOT is the
        largest id, so the argmax finds it, ref:eva02_clip/model.py:261)."""
        if isinstance(texts, str):
            texts = [texts]
        ctx = context_length or self.context_length
        out = np.zeros((len(texts), ctx), np.int32)
        sot, eot = self.encoder[self.SOT], self.encoder[self.EOT]
        for i, t in enumerate(texts):
            ids = [sot] + self.encode(t)[: ctx - 2] + [eot]
            out[i, : len(ids)] = ids
        return out


# ---------------------------------------------------------------------------
# Text transformer
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    context_length: int = 77
    width: int = 512
    heads: int = 8
    layers: int = 12
    embed_dim: int = 512
    quick_gelu: bool = False


# EVA02-CLIP-bigE-14-plus text_cfg (ref:model_configs/
# EVA02-CLIP-bigE-14-plus.json) with its embed_dim 1024
CLIP_TEXT_BIGE = CLIPTextConfig(vocab_size=49408, context_length=77,
                                width=1280, heads=20, layers=32,
                                embed_dim=1024)


class _Attention(nn.Module):
    """Causal self-attention with nn.MultiheadAttention's packed names
    (in_proj_weight, in_proj_bias, out_proj)."""

    def __init__(self, width: int, heads: int, device):
        super().__init__()
        self.heads = heads
        self.in_proj_weight = nn.Parameter(
            torch.zeros(3 * width, width, device=device))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * width,
                                                     device=device))
        self.out_proj = linear(width, width, device=device)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        q, k, v = F.linear(x, self.in_proj_weight,
                           self.in_proj_bias).chunk(3, dim=-1)
        q, k, v = (split_heads(a, self.heads) for a in (q, k, v))
        hd = q.shape[-1]
        logits = (q @ k.transpose(-1, -2)) * (hd ** -0.5) + mask
        out = merge_heads(torch.softmax(logits, dim=-1) @ v)
        return self.out_proj(out)


class _ResBlock(nn.Module):
    def __init__(self, width: int, heads: int, quick: bool, device):
        super().__init__()
        self.ln_1 = layer_norm(width, eps=1e-5, device=device)
        self.attn = _Attention(width, heads, device)
        self.ln_2 = layer_norm(width, eps=1e-5, device=device)
        self.mlp = nn.Sequential(OrderedDict(
            c_fc=linear(width, 4 * width, device=device),
            c_proj=linear(4 * width, width, device=device)))
        self.act = (lambda v: v * torch.sigmoid(1.702 * v)) if quick \
            else gelu

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.ln_1(x), mask)
        h = self.act(self.mlp.c_fc(self.ln_2(x)))
        return x + self.mlp.c_proj(h)


class CLIPTextTransformer(nn.Module):
    """The causal pre-LN text transformer (goi_tpu's clip_text_forward).
    Keys: token_embedding, positional_embedding, resblocks.{i}.*,
    ln_final.*, text_projection, as `convert_openclip_text_state`
    names them."""

    def __init__(self, cfg: CLIPTextConfig, device="cuda"):
        super().__init__()
        self.cfg = cfg
        w, t = cfg.width, cfg.context_length
        self.token_embedding = nn.Parameter(
            torch.zeros(cfg.vocab_size, w, device=device))
        self.positional_embedding = nn.Parameter(
            torch.zeros(t, w, device=device))
        self.resblocks = nn.ModuleList(
            _ResBlock(w, cfg.heads, cfg.quick_gelu, device)
            for _ in range(cfg.layers))
        self.ln_final = layer_norm(w, eps=1e-5, device=device)
        self.text_projection = nn.Parameter(
            torch.zeros(w, cfg.embed_dim, device=device))
        ar = torch.arange(t, device=device)
        self.register_buffer(
            "causal", torch.where(ar[None, :] > ar[:, None],
                                  float("-inf"), 0.0), persistent=False)

    def forward(self, tokens: torch.Tensor) -> dict:
        """tokens (B, context) int -> dict(eot (B, embed_dim), tokens
        (B, context, embed_dim), eot_idx (B,)): the wrapper's
        last_hidden_state_eot / last_hidden_state
        (ref:ext/clip_wrapper_eva02.py:129-148)."""
        tokens = tokens.long()
        t = tokens.shape[1]
        x = self.token_embedding[tokens] + self.positional_embedding[None]
        mask = self.causal[:t, :t]
        for blk in self.resblocks:
            x = blk(x, mask)
        all_tokens = self.ln_final(x) @ self.text_projection
        eot_idx = torch.argmax(tokens, dim=-1)
        eot = all_tokens[torch.arange(tokens.shape[0],
                                      device=tokens.device), eot_idx]
        return {"eot": eot, "tokens": all_tokens, "eot_idx": eot_idx}


def init_clip_text_(model: CLIPTextTransformer, generator: torch.Generator,
                    scale: float = 0.02) -> CLIPTextTransformer:
    """Random weights with the JAX package's init rules
    (init_clip_text_params), drawn from `generator`."""
    w = model.cfg.width

    def rule(name, shape, g):
        if name.endswith((".bias", "in_proj_bias")):
            return torch.zeros(shape)
        if ".ln_" in name or name.startswith("ln_"):
            return torch.ones(shape)
        if name == "token_embedding":
            return randn(shape, scale, g)
        if name == "positional_embedding":
            return randn(shape, 0.01, g)
        return randn(shape, w ** -0.5, g)

    return init_by_rule_(model, generator, rule)


def convert_openclip_text_state(state_dict) -> dict:
    """torch open_clip text-tower state_dict -> flat numpy params with
    this module's names. Accepts both bare ('transformer.resblocks...')
    and wrapped ('text.transformer.resblocks...') prefixes; run offline
    once and np.savez the result."""
    out = {}
    for k, v in state_dict.items():
        k = k[5:] if k.startswith("text.") else k
        if k.startswith("transformer."):
            k = k[len("transformer."):]
        if k in ("token_embedding.weight",):
            k = "token_embedding"
        arr = np.asarray(v.detach().cpu().numpy() if hasattr(v, "detach")
                         else v, np.float32)
        out[k] = arr
    return out


class TorchCLIPTextEncoder:
    """TextEncoder-protocol provider: a live prompt -> (embed_dim,)
    embedding on the tower's device (the role of
    ref:ext/clip_wrapper_eva02.py encode_text)."""

    def __init__(self, model: CLIPTextTransformer, bpe_path: str):
        self.model = model.eval()
        self.cfg = model.cfg
        self.tokenizer = ClipTokenizer(bpe_path, model.cfg.context_length)

    @property
    def device(self) -> torch.device:
        return self.model.token_embedding.device

    @staticmethod
    def from_npz(path: str, cfg: CLIPTextConfig, bpe_path: str,
                 device="cuda") -> "TorchCLIPTextEncoder":
        from goi_tpu_torch.interop import clip_text_from_numpy
        with np.load(path) as f:
            model = clip_text_from_numpy(dict(f), cfg, device=device)
        return TorchCLIPTextEncoder(model, bpe_path)

    @torch.inference_mode()
    def encode_batch(self, prompts: List[str]) -> np.ndarray:
        toks = torch.as_tensor(self.tokenizer(prompts), device=self.device)
        return self.model(toks)["eot"].float().cpu().numpy()

    def encode(self, prompt: str) -> np.ndarray:
        return self.encode_batch([prompt])[0]
