"""Training observability: TensorBoard scalars and a PCA feature view.

Counterpart of goi_tpu/utils/logging.py (the role of the reference's
conditional TensorBoard integration, ref:train.py:28-33, 219-267, and
its latent PCA visualizer, ref:utils/visual_latent.py).
"""

from __future__ import annotations

import numpy as np


class TensorBoardLogger:
    """torch.utils.tensorboard's SummaryWriter when it imports, else a
    no-op, as in the reference."""

    def __init__(self, log_dir: str):
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            print("Tensorboard not available: not logging progress")
            self.writer = None
        else:
            self.writer = SummaryWriter(log_dir)

    def scalar(self, tag: str, value, step: int) -> None:
        if self.writer:
            self.writer.add_scalar(tag, float(value), step)

    def histogram(self, tag: str, values, step: int) -> None:
        if self.writer:
            self.writer.add_histogram(tag, np.asarray(values), step)

    def image(self, tag: str, img_chw, step: int) -> None:
        if self.writer:
            self.writer.add_image(tag, np.asarray(img_chw), step)

    def close(self) -> None:
        if self.writer:
            self.writer.close()


def pca_visualize(features: np.ndarray) -> np.ndarray:
    """(C, H, W) feature map -> (H, W, 3) PCA false-colour image
    (ref:utils/visual_latent.py)."""
    c, h, w = features.shape
    flat = np.asarray(features, np.float64).reshape(c, -1).T
    flat = flat - flat.mean(0, keepdims=True)
    # the top-3 principal directions, by the SVD of the (pixels, C) matrix
    _, _, vt = np.linalg.svd(flat, full_matrices=False)
    proj = flat @ vt[:3].T
    lo = np.percentile(proj, 1, axis=0)
    hi = np.percentile(proj, 99, axis=0)
    img = np.clip((proj - lo) / np.maximum(hi - lo, 1e-9), 0, 1)
    return img.reshape(h, w, 3).astype(np.float32)
