"""Text-embedding providers for open-vocabulary queries.

Counterpart of goi_tpu/query/text_encoder.py. The reference embeds
prompts with a frozen EVA02-CLIP-bigE-14-plus text tower plus the
learned aligner (ref:ext/clip_wrapper_eva02.py:8-148,
gui/main.py:105-111); the aligner (query/align.py) maps an embedding to
the image space on its device.

  PrecomputedTextEncoder  prompt -> embedding from an .npz file made
                          offline
  TorchCLIPTextEncoder    the live tower in this package
                          (query/clip_text.py) with pluggable converted
                          weights: any prompt, no offline step
  TorchEVA02TextEncoder   the reference's own tower, where the user
                          supplies the checkpoint and the eva02 CLIP
                          library
"""

from __future__ import annotations

import os
from typing import Dict, Protocol

import numpy as np
import torch

from goi_tpu_torch.query.clip_text import TorchCLIPTextEncoder

__all__ = ["TextEncoder", "PrecomputedTextEncoder", "TorchCLIPTextEncoder",
           "TorchEVA02TextEncoder", "encode_and_align"]


class TextEncoder(Protocol):
    def encode(self, prompt: str) -> np.ndarray:
        """Returns the language embedding (1024,) BEFORE alignment."""
        ...


class PrecomputedTextEncoder:
    """Embeddings exported offline:
    np.savez('prompts.npz', **{prompt: embedding (1024,)})."""

    def __init__(self, path: str):
        with np.load(path) as f:
            self.store: Dict[str, np.ndarray] = dict(f)

    def encode(self, prompt: str) -> np.ndarray:
        if prompt not in self.store:
            raise KeyError(
                f"prompt {prompt!r} not in the precomputed store; "
                f"available: {sorted(self.store)[:10]}...")
        return np.asarray(self.store[prompt], np.float32)

    def available(self):
        return sorted(self.store)


class TorchEVA02TextEncoder:
    """Runs the reference's text tower when its artifacts are present
    (models/model_language.pth and an importable eva02 CLIP package).
    The tower's import is deferred to construction."""

    def __init__(self, checkpoint: str = "models/model_language.pth",
                 clip_model: str = "EVA02-CLIP-bigE-14-plus"):
        if not os.path.exists(checkpoint):
            raise FileNotFoundError(
                f"{checkpoint} not found — export the EVA02 text tower "
                "offline or use PrecomputedTextEncoder")
        from eva02_clip import create_model_and_transforms  # type: ignore

        model, _, _ = create_model_and_transforms(clip_model)
        state = torch.load(checkpoint, map_location="cpu")
        model.load_state_dict(state, strict=False)
        model.eval()
        self.model = model

    def encode(self, prompt: str) -> np.ndarray:
        with torch.no_grad():
            tokens = self.model.tokenizer([prompt])  # type: ignore
            feat = self.model.encode_text(tokens)
        return np.asarray(feat[0].float().numpy(), np.float32)


def encode_and_align(encoder: TextEncoder, align, prompt: str):
    """The GUI's text path (ref:gui/main.py:105-111): tower ->
    VisionLanguageAlign.text_embedding_align -> the aligned (256,)
    tokens and the () bias, on the aligner's device."""
    emb = torch.as_tensor(encoder.encode(prompt), device=align.device)[None]
    tokens, bias = align.text_embedding_align(emb)
    return tokens[0], bias[0]
