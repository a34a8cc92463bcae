"""Open-vocabulary similarity measures.

Counterpart of goi_tpu/query/similarity.py. The decode path
(ref:gui/main.py:363-385): rendered semantic map -> decoder MLP ->
softmax -> argmax code -> LUT row -> L2 normalize -> similarity against
an aligned text embedding. Text embeddings enter as plain tensors.
"""

from __future__ import annotations

import torch

from goi_tpu_torch.semantic.codebook import SemanticDecoder


def decode_semantic_features(decoder: SemanticDecoder, lut: torch.Tensor,
                             sem_map: torch.Tensor) -> torch.Tensor:
    """(pixels, S) rendered features -> (pixels, C) normalized codebook
    features (ref:gui/main.py:365-371)."""
    logits = decoder(sem_map)
    probs = torch.softmax(logits * 1.0, dim=-1) * 10.0
    code = torch.argmax(probs, dim=-1)
    feat = lut[code]
    return feat / torch.clamp(torch.linalg.norm(feat, dim=-1, keepdim=True),
                              min=1e-12)


def ape_similarity(pixel_feats: torch.Tensor, text_tokens: torch.Tensor,
                   *, log_scale=0.0, manual_bias: float = 2.0):
    """sigmoid(<pixel, text> / exp(log_scale) + 2), the ApeSimMeasure
    relevancy (ref:ext/vision_language_align.py:109-122)."""
    scale = torch.exp(torch.as_tensor(log_scale, dtype=torch.float32,
                                      device=pixel_feats.device))
    logits = pixel_feats @ text_tokens / scale
    logits = torch.clamp(logits, -50000.0, 50000.0) + manual_bias
    return torch.sigmoid(logits)


def clip_relevancy(pixel_feats: torch.Tensor, text_feat: torch.Tensor,
                   canon_feats: torch.Tensor,
                   temperature: float = 10.0) -> torch.Tensor:
    """LERF-style canonical-phrase relevancy of ClipSimMeasure
    (ref:gui/main.py:50-81): min over canonicals of the pairwise softmax
    probability of the query."""
    pf = pixel_feats / torch.clamp(
        torch.linalg.norm(pixel_feats, dim=-1, keepdim=True), min=1e-12)
    tq = text_feat / torch.clamp(torch.linalg.norm(text_feat), min=1e-12)
    tc = canon_feats / torch.clamp(
        torch.linalg.norm(canon_feats, dim=-1, keepdim=True), min=1e-12)
    s_q = pf @ tq * temperature
    s_c = pf @ tc.T * temperature
    pair = torch.exp(s_q)[:, None] / (torch.exp(s_q)[:, None]
                                      + torch.exp(s_c))
    return torch.min(pair, dim=-1).values
