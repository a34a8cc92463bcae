"""Image-quality and segmentation metrics.

Counterpart of goi_tpu/eval/metrics.py, with the reference definitions:
  l1/l2/ssim      ref:utils/loss_utils.py:17-63
  psnr            ref:utils/image_utils.py:22-24
  IoU / mPA / mP  ref:utils/image_utils.py (calculate_iou) and
                  ref:eval_seg.py:8-28
SSIM uses the same 11x11 Gaussian window (sigma 1.5) and constants
(C1=0.01^2, C2=0.03^2) as the reference. Tensors stay on their device.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def l1_loss(a, b):
    return torch.mean(torch.abs(a - b))


def l2_loss(a, b):
    return torch.mean((a - b) ** 2)


def psnr(img1, img2):
    """PSNR of images in [0,1], (C,H,W) or batched
    (ref:utils/image_utils.py:22-24)."""
    mse = torch.mean((img1 - img2) ** 2)
    return 20.0 * torch.log10(1.0 / torch.sqrt(mse))


def _gaussian_window(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    xs = np.arange(size, dtype=np.float64) - size // 2
    g = np.exp(-(xs ** 2) / (2 * sigma ** 2))
    g /= g.sum()
    return np.outer(g, g).astype(np.float32)


def ssim(img1, img2, window_size: int = 11):
    """Structural similarity with per-channel 2D Gaussian filtering
    (ref:utils/loss_utils.py:25-63). Inputs (C,H,W)."""
    c = img1.shape[0]
    kernel = torch.as_tensor(_gaussian_window(window_size),
                             device=img1.device)[None, None].repeat(
                                 c, 1, 1, 1)
    pad = window_size // 2

    def filt(x):
        return F.conv2d(x[None], kernel, padding=pad, groups=c)[0]

    mu1 = filt(img1)
    mu2 = filt(img2)
    mu1_sq, mu2_sq, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    s1 = filt(img1 * img1) - mu1_sq
    s2 = filt(img2 * img2) - mu2_sq
    s12 = filt(img1 * img2) - mu12
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    m = ((2 * mu12 + c1) * (2 * s12 + c2)
         / ((mu1_sq + mu2_sq + c1) * (s1 + s2 + c2)))
    return torch.mean(m)


def iou_metrics(pred, gt):
    """Binary-mask metrics of eval_seg (ref:eval_seg.py:8-28,52-57):
    IoU plus the two-class means of per-class pixel accuracy (mPA) and
    precision (mP). Inputs boolean tensors."""
    pred = pred.bool()
    gt = gt.bool()
    inter = torch.sum(pred & gt)
    union = torch.sum(pred | gt)
    iou = inter / torch.clamp(union, min=1)

    tp = inter.float()
    tn = torch.sum(~pred & ~gt).float()
    n_gt1 = torch.sum(gt).float()
    n_gt0 = torch.sum(~gt).float()
    n_pr1 = torch.sum(pred).float()
    n_pr0 = torch.sum(~pred).float()
    zero = torch.zeros_like(tp)
    acc1 = torch.where(n_gt1 > 0, tp / torch.clamp(n_gt1, min=1), zero)
    acc0 = torch.where(n_gt0 > 0, tn / torch.clamp(n_gt0, min=1), zero)
    mpa = (acc1 + acc0) / 2
    # precision follows torch semantics: 0/0 -> nan propagates into the
    # mean exactly as in the reference (ref:eval_seg.py:21-28)
    mp = (tp / n_pr1 + tn / n_pr0) / 2
    return {"iou": iou, "mpa": mpa, "mp": mp}
