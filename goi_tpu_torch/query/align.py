"""VisionLanguageAlign: 1024-dim language space -> 256-dim image space.

Counterpart of goi_tpu/query/align.py (the role of
ref:ext/vision_language_align.py:8-122): the tiny learned aligner that
maps a text tower's embedding onto the APE image features, and its logit
head. The text towers stay offline (query/text_encoder.py). Inference
only, so the parameters are a dataclass of tensors, as `OSHState` is.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


@dataclasses.dataclass
class VisionLanguageAlign:
    """Parameters (ref:ext/vision_language_align.py:17-23)."""

    w_text: torch.Tensor      # (embed_dim, embed_dim_language)
    b_text: torch.Tensor      # (embed_dim,)
    log_scale: torch.Tensor   # (1,)
    bias_lang: torch.Tensor   # (embed_dim_language,)
    bias0: torch.Tensor       # (1,)

    @property
    def device(self) -> torch.device:
        return self.w_text.device

    @staticmethod
    def create(embed_dim=256, embed_dim_language=1024, prior_prob=0.01,
               log_scale=0.0, seed=0, device="cuda") -> "VisionLanguageAlign":
        """The JAX package's numpy draws for `seed`, so both packages
        hold the same parameters."""
        rng = np.random.default_rng(seed)
        bound = 1.0 / math.sqrt(embed_dim_language)
        w = rng.uniform(-bound, bound, (embed_dim, embed_dim_language))
        return VisionLanguageAlign(
            w_text=torch.as_tensor(w.astype(np.float32), device=device),
            b_text=torch.zeros(embed_dim, device=device),
            log_scale=torch.full((1,), float(log_scale), device=device),
            bias_lang=torch.zeros(embed_dim_language, device=device),
            bias0=torch.full((1,), -math.log((1 - prior_prob) / prior_prob),
                             device=device))

    @staticmethod
    def from_state_dict(sd, device="cuda") -> "VisionLanguageAlign":
        """The reference module's state_dict (tensors or numpy arrays):
        dot_product_projection_text.{weight,bias}, log_scale, bias_lang,
        bias0."""
        def g(k):
            v = sd[k]
            v = v.detach().cpu().numpy() if torch.is_tensor(v) else v
            return torch.as_tensor(np.asarray(v, np.float32), device=device)

        return VisionLanguageAlign(
            w_text=g("dot_product_projection_text.weight"),
            b_text=g("dot_product_projection_text.bias"),
            log_scale=g("log_scale").reshape(1),
            bias_lang=g("bias_lang"),
            bias0=g("bias0").reshape(1))

    def text_embedding_align(self, lang_embedding: torch.Tensor):
        """(L, 1024) language embedding -> ((L, 256) aligned tokens,
        (L,) text bias) (ref:ext/vision_language_align.py:82-93)."""
        e = lang_embedding / torch.clamp(
            torch.linalg.norm(lang_embedding, dim=-1, keepdim=True),
            min=1e-12)
        tokens = (e / 2.0) @ self.w_text.T + self.b_text
        bias = e @ self.bias_lang + self.bias0
        return tokens, bias

    def logit_manual_bias(self, x: torch.Tensor, text_tokens: torch.Tensor,
                          manual_bias: float = 2.0) -> torch.Tensor:
        """Pixel-vs-text logit with the GUI's fixed manual bias
        (ref:ext/vision_language_align.py:109-122)."""
        logit = (x @ text_tokens.T) / torch.exp(self.log_scale)
        return torch.clamp(logit, -50000.0, 50000.0) + manual_bias

    def logit(self, x: torch.Tensor, text_tokens: torch.Tensor,
              text_bias: torch.Tensor) -> torch.Tensor:
        """(ref:ext/vision_language_align.py:95-107)."""
        logit = (x @ text_tokens.T) / torch.exp(self.log_scale) + text_bias
        return torch.clamp(logit, -50000.0, 50000.0)
