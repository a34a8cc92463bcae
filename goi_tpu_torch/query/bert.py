"""BERT text encoder and WordPiece tokenizer.

Counterpart of goi_tpu/query/bert.py: the language tower of the RES
detector (GroundingDINO conditions on a frozen bert-base-uncased;
ref:ext/GroundingDINO/groundingdino/models/GroundingDINO/bertwarper.py
and groundingdino.py:107-115). `BertModel`'s state_dict keys are the HF
names (``embeddings.word_embeddings.weight``,
``encoder.layer.0.attention.self.query.weight`` ...); inside
GroundingDINO it sits under ``bert.``, as in the released checkpoint.

`special_token_masks` is the bertwarper preprocessing
(generate_masks_with_special_tokens_and_transfer_map,
ref:bertwarper.py:224-273): each sub-sentence between special tokens
([CLS]/[SEP]/./?) attends only to itself, and position ids restart at
every special token. It runs on the host in numpy; the encoder takes
its result as a mask.

The WordPiece tokenizer implements the public BERT algorithm (lowercase,
accent strip, punctuation split; greedy longest-match-first wordpieces
with ``##`` continuations). The vocab file ships with any BERT
checkpoint; ``make_test_vocab`` builds a tiny one.
"""

from __future__ import annotations

import dataclasses
import math
import unicodedata
from typing import Dict, List, Sequence

import numpy as np
import torch
from torch import nn

from goi_tpu_torch.query._nn import (gelu, layer_norm, linear, merge_heads,
                                     split_heads)


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden: int = 768
    layers: int = 12
    heads: int = 12
    intermediate: int = 3072
    max_position: int = 512
    type_vocab: int = 2


BERT_BASE = BertConfig()
BERT_TINY_TEST = BertConfig(vocab_size=64, hidden=16, layers=2, heads=2,
                            intermediate=32, max_position=64)
EPS = 1e-12   # BERT's LayerNorm eps (HF config default)


# ---------------------------------------------------------------------------
# WordPiece tokenizer
# ---------------------------------------------------------------------------

def _is_punct(ch: str) -> bool:
    cp = ord(ch)
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) \
            or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _basic_tokenize(text: str) -> List[str]:
    text = text.lower()
    text = unicodedata.normalize("NFD", text)
    text = "".join(c for c in text if unicodedata.category(c) != "Mn")
    out: List[str] = []
    buf = ""
    for ch in text:
        if ch.isspace():
            if buf:
                out.append(buf)
            buf = ""
        elif _is_punct(ch):
            if buf:
                out.append(buf)
            buf = ""
            out.append(ch)
        else:
            buf += ch
    if buf:
        out.append(buf)
    return out


class BertTokenizer:
    """WordPiece tokenizer over a vocab.txt (one token per line)."""

    def __init__(self, vocab: Dict[str, int] | str):
        if isinstance(vocab, str):
            with open(vocab, encoding="utf-8") as f:
                vocab = {line.rstrip("\n"): i
                         for i, line in enumerate(f) if line.rstrip("\n")}
        self.vocab = dict(vocab)
        self.ids_to_tokens = {i: t for t, i in self.vocab.items()}
        self.cls_id = self.vocab["[CLS]"]
        self.sep_id = self.vocab["[SEP]"]
        self.unk_id = self.vocab["[UNK]"]
        self.pad_id = self.vocab.get("[PAD]", 0)

    def _wordpiece(self, word: str) -> List[int]:
        if len(word) > 100:   # HF BERT max_input_chars_per_word
            return [self.unk_id]
        ids: List[int] = []
        start = 0
        while start < len(word):
            end = len(word)
            cur = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    cur = self.vocab[sub]
                    break
                end -= 1
            if cur is None:
                return [self.unk_id]
            ids.append(cur)
            start = end
        return ids

    def encode(self, text: str) -> List[int]:
        """[CLS] wordpieces [SEP] (HF tokenizer(text))."""
        ids = [self.cls_id]
        for w in _basic_tokenize(text):
            ids.extend(self._wordpiece(w))
        ids.append(self.sep_id)
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        toks = [self.ids_to_tokens.get(int(i), "[UNK]") for i in ids]
        out = ""
        for t in toks:
            if t.startswith("##"):
                out += t[2:]
            else:
                out += (" " if out else "") + t
        return out

    def special_ids(self) -> List[int]:
        """[CLS], [SEP], ., ? — the GroundingDINO sub-sentence splitters
        (ref:groundingdino.py:119)."""
        return [self.vocab[t] for t in ("[CLS]", "[SEP]", ".", "?")
                if t in self.vocab]


def make_test_vocab(words: Sequence[str]) -> Dict[str, int]:
    base = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", ".", "?", ","]
    toks = list(base)
    for w in words:
        if w not in toks:
            toks.append(w)
    return {t: i for i, t in enumerate(toks)}


# ---------------------------------------------------------------------------
# bertwarper sub-sentence masks
# ---------------------------------------------------------------------------

def special_token_masks(input_ids: np.ndarray,
                        special_ids: Sequence[int]):
    """(bs, L) token ids -> (attn (bs, L, L) bool, position_ids
    (bs, L) int32, cate_to_token (bs lists of (n_cat, L) bool)), as
    generate_masks_with_special_tokens_and_transfer_map
    (ref:bertwarper.py:224-273) builds them."""
    input_ids = np.asarray(input_ids)
    bs, n = input_ids.shape
    special = np.isin(input_ids, np.asarray(list(special_ids)))
    attn = np.eye(n, dtype=bool)[None].repeat(bs, 0)
    pos = np.zeros((bs, n), np.int32)
    cate: List[List[np.ndarray]] = [[] for _ in range(bs)]
    prev = 0
    for row, col in np.argwhere(special):
        if col == 0 or col == n - 1:
            pos[row, col] = 0
        else:
            attn[row, prev + 1:col + 1, prev + 1:col + 1] = True
            pos[row, prev + 1:col + 1] = np.arange(col - prev)
            m = np.zeros(n, bool)
            m[prev + 1:col] = True
            cate[row].append(m)
        prev = col
    cate_np = [np.stack(c, 0) if c else np.zeros((0, n), bool)
               for c in cate]
    return attn, pos, cate_np


# ---------------------------------------------------------------------------
# encoder
# ---------------------------------------------------------------------------

def _dense_ln(d_in: int, d_out: int, device) -> nn.ModuleDict:
    return nn.ModuleDict({"dense": linear(d_in, d_out, device=device),
                          "LayerNorm": layer_norm(d_out, eps=EPS,
                                                  device=device)})


class BertLayer(nn.Module):
    def __init__(self, cfg: BertConfig, device):
        super().__init__()
        h = cfg.hidden
        self.heads = cfg.heads
        self.attention = nn.ModuleDict({
            "self": nn.ModuleDict({n: linear(h, h, device=device)
                                   for n in ("query", "key", "value")}),
            "output": _dense_ln(h, h, device)})
        self.intermediate = nn.ModuleDict(
            {"dense": linear(h, cfg.intermediate, device=device)})
        self.output = _dense_ln(cfg.intermediate, h, device)

    def forward(self, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        sa = self.attention["self"]
        q, k, v = (split_heads(sa[n](x), self.heads)
                   for n in ("query", "key", "value"))
        a = q @ k.transpose(-1, -2) / math.sqrt(q.shape[-1])
        o = merge_heads(torch.softmax(a + bias, -1) @ v)
        ao = self.attention["output"]
        x = ao["LayerNorm"](x + ao["dense"](o))
        h = gelu(self.intermediate["dense"](x))
        return self.output["LayerNorm"](x + self.output["dense"](h))


class BertModel(nn.Module):
    """bert-base-uncased's encoder (pooler kept for the checkpoint's
    keys; GroundingDINO reads last_hidden_state only)."""

    def __init__(self, cfg: BertConfig = BERT_BASE, device="cuda"):
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden
        self.embeddings = nn.ModuleDict({
            "word_embeddings": nn.Embedding(cfg.vocab_size, h,
                                            device=device),
            "position_embeddings": nn.Embedding(cfg.max_position, h,
                                                device=device),
            "token_type_embeddings": nn.Embedding(cfg.type_vocab, h,
                                                  device=device),
            "LayerNorm": layer_norm(h, eps=EPS, device=device)})
        self.encoder = nn.ModuleDict({"layer": nn.ModuleList(
            BertLayer(cfg, device) for _ in range(cfg.layers))})
        self.pooler = nn.ModuleDict({"dense": linear(h, h, device=device)})

    def forward(self, input_ids: torch.Tensor, attn_mask: torch.Tensor,
                position_ids: torch.Tensor,
                token_type_ids: torch.Tensor | None = None) -> torch.Tensor:
        """input_ids (bs, L); attn_mask (bs, L, L) bool (True = attend,
        the bertwarper sub-sentence mask); position_ids (bs, L).
        Returns last_hidden_state (bs, L, hidden)."""
        e = self.embeddings
        input_ids = input_ids.long()
        tt = token_type_ids if token_type_ids is not None \
            else torch.zeros_like(input_ids)
        x = e["word_embeddings"](input_ids) \
            + e["position_embeddings"](position_ids.long()) \
            + e["token_type_embeddings"](tt.long())
        x = e["LayerNorm"](x)
        bias = torch.where(attn_mask[:, None], 0.0, -1e9)  # (bs, 1, L, L)
        for lyr in self.encoder["layer"]:
            x = lyr(x, bias)
        return x


def bert_param_shapes(cfg: BertConfig, prefix: str = "bert") -> dict:
    s = {}
    h = cfg.hidden
    pre = f"{prefix}.embeddings"
    s[f"{pre}.word_embeddings.weight"] = (cfg.vocab_size, h)
    s[f"{pre}.position_embeddings.weight"] = (cfg.max_position, h)
    s[f"{pre}.token_type_embeddings.weight"] = (cfg.type_vocab, h)
    s[f"{pre}.LayerNorm.weight"] = (h,)
    s[f"{pre}.LayerNorm.bias"] = (h,)
    for i in range(cfg.layers):
        lyr = f"{prefix}.encoder.layer.{i}"
        for nm in ("attention.self.query", "attention.self.key",
                   "attention.self.value", "attention.output.dense"):
            s[f"{lyr}.{nm}.weight"] = (h, h)
            s[f"{lyr}.{nm}.bias"] = (h,)
        s[f"{lyr}.attention.output.LayerNorm.weight"] = (h,)
        s[f"{lyr}.attention.output.LayerNorm.bias"] = (h,)
        s[f"{lyr}.intermediate.dense.weight"] = (cfg.intermediate, h)
        s[f"{lyr}.intermediate.dense.bias"] = (cfg.intermediate,)
        s[f"{lyr}.output.dense.weight"] = (h, cfg.intermediate)
        s[f"{lyr}.output.dense.bias"] = (h,)
        s[f"{lyr}.output.LayerNorm.weight"] = (h,)
        s[f"{lyr}.output.LayerNorm.bias"] = (h,)
    s[f"{prefix}.pooler.dense.weight"] = (h, h)
    s[f"{prefix}.pooler.dense.bias"] = (h,)
    return s
