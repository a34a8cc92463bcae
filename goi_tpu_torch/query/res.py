"""RES (referring expression segmentation) mask providers.

Counterpart of goi_tpu/query/res.py. The reference's RES pipeline runs
GroundingDINO + SAM + CLIP re-ranking (ref:guidance/res_model.py:
144-410). The towers are in this package (query/grounding.py,
query/sam.py, query/clip_text.py; weights pluggable), so
`TorchRESProvider` runs the whole prompt -> boxes -> masks -> re-rank ->
union chain on the towers' device. The file and command providers serve
precomputed or external masks (ref:gui/main.py:1673-1763 needs only the
binary mask).

Providers:
  TorchRESProvider    this package's GroundingDINO + SAM (+ optional CLIP)
  FileRESProvider     masks from <dir>/<prompt>/<image_name>.png
  CommandRESProvider  shells out to a user command that writes a mask
"""

from __future__ import annotations

import os
import subprocess
import tempfile
from typing import Optional, Protocol

import numpy as np

from goi_tpu_torch.utils.profiling import count, span


class RESProvider(Protocol):
    def predict_mask(self, image: np.ndarray, prompt: str,
                     image_name: str = "") -> Optional[np.ndarray]:
        """image (H, W, 3) float [0,1] -> binary mask (H, W) or None."""
        ...


def _resize_mask(mask: np.ndarray, h: int, w: int) -> np.ndarray:
    from PIL import Image
    im = Image.fromarray((mask > 0).astype(np.uint8) * 255)
    return np.asarray(im.resize((w, h), Image.BILINEAR)) > 127


class FileRESProvider:
    """Precomputed masks laid out <root>/<prompt>/<image_name>.png (the
    directory protocol eval_seg scores)."""

    def __init__(self, root: str):
        self.root = root

    def predict_mask(self, image, prompt, image_name=""):
        path = os.path.join(self.root, prompt, image_name + ".png")
        if not os.path.exists(path):
            return None
        from PIL import Image
        with Image.open(path) as im:
            m = np.asarray(im.convert("L"))
        return _resize_mask(m, image.shape[0], image.shape[1])


def rerank_keep(prob: np.ndarray, first_ratio: float,
                prev_ratio: float) -> np.ndarray:
    """The reference's greedy similarity cutoff: sort descending, keep
    while prob[i] >= first_ratio*prob[0] and >= prev_ratio*prob[i-1]
    (ref:guidance/res_model.py:384-399). Returns the kept indices in
    descending-prob order."""
    order = np.argsort(np.asarray(prob, np.float64))[::-1]
    for i in range(1, len(order)):
        if prob[order[i]] < first_ratio * prob[order[0]] \
                or prob[order[i]] < prev_ratio * prob[order[i - 1]]:
            return order[:i]
    return order


class TorchRESProvider:
    """predict_res_mask (ref:guidance/res_model.py:350-410): GroundingDINO
    boxes -> SAM box-prompted masks -> phrase re-ranking -> union mask.

    dino: query.grounding.GroundingDINOTorch
    sam: query.sam.SamTorch
    text_similarity: optional (a, b) -> cosine similarity in [0, 1]
        (e.g. through query.clip_text.TorchCLIPTextEncoder). When None,
        the first re-rank stage uses the detector's own phrase scores
        (the reference's CLIP ViT-B/32 re-ranker is a separate
        checkpoint).
    """

    def __init__(self, dino, sam, text_similarity=None,
                 box_threshold: float = 0.3,
                 text_threshold: float = 0.25):
        self.dino = dino
        self.sam = sam
        self.text_similarity = text_similarity
        self.box_threshold = box_threshold
        self.text_threshold = text_threshold

    def predict_mask(self, image, prompt, image_name=""):
        with span("res.request"):
            h, w = image.shape[:2]
            boxes, scores, phrases = self.dino.predict(
                image, prompt, self.box_threshold, self.text_threshold)
            count("res.boxes", len(boxes))
            if len(boxes) == 0:
                return None
            with span("res.host"):
                # cxcywh normalized -> xyxy pixels
                # (ref:res_model.py:291-294)
                b = np.asarray(boxes) * np.asarray([w, h, w, h], np.float32)
                xyxy = np.concatenate([b[:, :2] - b[:, 2:] / 2,
                                       b[:, :2] + b[:, 2:] / 2], 1)
            self.sam.set_image(image)
            masks, _ = self.sam.predict_boxes(xyxy, multimask=False)
            with span("res.host"):
                masks = masks[:, 0]                  # (n, H, W) bool
                # stage 1: phrase-vs-prompt similarity cutoff (0.99/0.9)
                if self.text_similarity is not None:
                    prob = np.asarray([self.text_similarity(prompt, ph)
                                       for ph in phrases], np.float64)
                else:
                    prob = scores.astype(np.float64)
                keep = rerank_keep(prob, 0.99, 0.9)
                # stage 2: detector-score cutoff (0.8/0.8) on the
                # survivors
                keep = keep[rerank_keep(scores[keep].astype(np.float64),
                                        0.8, 0.8)]
                return masks[keep].any(0)


class CommandRESProvider:
    """Runs `cmd <image.png> <prompt> <out_mask.png>` (e.g. a wrapper
    around an external GroundingDINO+SAM service)."""

    def __init__(self, cmd: str):
        self.cmd = cmd

    def predict_mask(self, image, prompt, image_name=""):
        from PIL import Image
        with tempfile.TemporaryDirectory() as td:
            ip = os.path.join(td, "in.png")
            op = os.path.join(td, "out.png")
            Image.fromarray(
                np.clip(image * 255, 0, 255).astype(np.uint8)).save(ip)
            r = subprocess.run([*self.cmd.split(), ip, prompt, op])
            if r.returncode != 0 or not os.path.exists(op):
                return None
            with Image.open(op) as im:
                m = np.asarray(im.convert("L"))
        return _resize_mask(m, image.shape[0], image.shape[1])
