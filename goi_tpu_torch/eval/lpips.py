"""LPIPS perceptual metric (AlexNet and VGG16 backbones).

Counterpart of goi_tpu/eval/lpips.py (the role of ref:lpipsPyTorch/;
the reference's novel-view protocol scores with net_type='vgg',
ref:metrics.py:63). The backbone weights are pretrained artifacts that
are not in the repository; they load from a local npz of the `lpips`
package's state_dict, normalised by `normalize_lpips_state`:

  GOI_LPIPS_VGG_WEIGHTS=/path/to/lpips_vgg.npz (or ./models/lpips_vgg.npz)
  GOI_LPIPS_WEIGHTS=/path/to/lpips_alex.npz   (or ./models/lpips_alex.npz)

Protocol (as the JAX package): net='vgg' applies the z-score directly to
the [0,1] input and divides channels by (norm + 1e-10)
(ref:lpipsPyTorch/modules/networks.py:86-96, utils.py:6-8); net='alex'
keeps the official lpips convention ([0,1] -> [-1,1], clamped norm).
`lpips_or_none` returns None when no weights are present. The
convolutions are torch.nn.functional.conv2d on the images' device.
"""

from __future__ import annotations

import os
from functools import lru_cache
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

# AlexNet feature config: (out_ch, kernel, stride, pad); maxpool after
# convs 0 and 1 (before the next slice)
_ALEX_CONVS = [(64, 11, 4, 2), (192, 5, 1, 2), (384, 3, 1, 1),
               (256, 3, 1, 1), (256, 3, 1, 1)]
_POOL_AFTER = {0, 1}

# VGG16 feature slices (relu1_2/2_2/3_3/4_3/5_3): torchvision indices of
# the convs in each lpips-package slice (net.slice{k}.{idx}.weight)
_VGG_SLICES = [[0, 2], [5, 7], [10, 12, 14], [17, 19, 21],
               [24, 26, 28]]

# the LPIPS input scaling
_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)


def normalize_lpips_state(raw: Dict[str, np.ndarray], net: str = "alex"
                          ) -> Dict[str, np.ndarray]:
    """The `lpips` package's state_dict keys (net.slice{k}.{orig_idx}
    .weight/.bias, lin{i}.model.1.weight) -> the canonical keys
    net.slice{k}.conv{j}.weight/.bias (j the conv's position in its
    slice) and lin{i}.model.1.weight."""
    idx_to_j = {}
    if net == "vgg":
        for k, idxs in enumerate(_VGG_SLICES):
            for j, idx in enumerate(idxs):
                idx_to_j[(k + 1, idx)] = j
    out = {}
    for k, v in raw.items():
        v = np.asarray(v, np.float32)
        parts = k.split(".")
        if parts[0] == "net" and parts[1].startswith("slice") \
                and parts[2].isdigit():
            sl = int(parts[1][5:])
            j = idx_to_j.get((sl, int(parts[2])), 0)
            out[f"net.{parts[1]}.conv{j}.{parts[3]}"] = v
        elif parts[0].startswith("lin") and parts[1] == "model":
            out[f"{parts[0]}.model.1.{parts[3]}"] = v
        else:
            out[k] = v
    return out


def weights_path(net: str = "alex") -> str:
    if net == "vgg":
        return os.environ.get("GOI_LPIPS_VGG_WEIGHTS", "models/lpips_vgg.npz")
    return os.environ.get("GOI_LPIPS_WEIGHTS", "models/lpips_alex.npz")


@lru_cache(maxsize=4)
def _load_npz(path: str, net: str) -> Dict[str, np.ndarray]:
    with np.load(path) as z:
        return normalize_lpips_state(dict(z), net)


def load_weights(net: str = "alex") -> Optional[Dict[str, np.ndarray]]:
    """The backbone's normalised weights from its npz, or None."""
    path = weights_path(net)
    if not os.path.exists(path):
        return None
    return _load_npz(path, net)


def _conv(x, weights, key, stride, pad):
    w = torch.as_tensor(weights[key + ".weight"], device=x.device)
    b = torch.as_tensor(weights[key + ".bias"], device=x.device)
    return F.conv2d(x, w, b, stride=stride, padding=pad)


def _alex_features(x, weights):
    """The 5 relu feature maps LPIPS compares."""
    feats = []
    for i, (_, _, stride, pad) in enumerate(_ALEX_CONVS):
        x = torch.relu(_conv(x, weights, f"net.slice{i + 1}.conv0", stride,
                             pad))
        feats.append(x)
        if i in _POOL_AFTER:
            x = F.max_pool2d(x, 3, 2)
    return feats


def _vgg_features(x, weights):
    """relu1_2/2_2/3_3/4_3/5_3 (torchvision vgg16.features: 3x3 stride-1
    pad-1 convs, 2x2/2 maxpool between slices)."""
    feats = []
    for k, idxs in enumerate(_VGG_SLICES):
        if k > 0:
            x = F.max_pool2d(x, 2, 2)
        for j in range(len(idxs)):
            x = torch.relu(_conv(x, weights, f"net.slice{k + 1}.conv{j}",
                                 1, 1))
        feats.append(x)
    return feats


def lpips(img1: torch.Tensor, img2: torch.Tensor,
          weights: Optional[Dict[str, np.ndarray]] = None,
          net: str = "alex") -> torch.Tensor:
    """LPIPS distance between (3,H,W) images in [0,1]."""
    weights = weights if weights is not None else load_weights(net)
    if weights is None:
        raise FileNotFoundError(
            f"LPIPS {net} backbone weights not found at {weights_path(net)};"
            f" set {'GOI_LPIPS_VGG_WEIGHTS' if net == 'vgg' else 'GOI_LPIPS_WEIGHTS'}"
            f" (see goi_tpu_torch/eval/lpips.py)")
    shift = torch.as_tensor(_SHIFT, device=img1.device)[:, None, None]
    scale = torch.as_tensor(_SCALE, device=img1.device)[:, None, None]

    def norm_input(x):
        if net != "vgg":
            x = x * 2.0 - 1.0      # official lpips: inputs in [-1,1]
        return ((x - shift) / scale)[None]

    feat_fn = _vgg_features if net == "vgg" else _alex_features
    f1 = feat_fn(norm_input(img1), weights)
    f2 = feat_fn(norm_input(img2), weights)
    total = torch.zeros((), device=img1.device)
    for i, (a, b) in enumerate(zip(f1, f2)):
        na = torch.linalg.norm(a, dim=1, keepdim=True)
        nb = torch.linalg.norm(b, dim=1, keepdim=True)
        if net == "vgg":
            a, b = a / (na + 1e-10), b / (nb + 1e-10)
        else:
            a, b = a / torch.clamp(na, min=1e-10), b / torch.clamp(
                nb, min=1e-10)
        lin = torch.as_tensor(weights[f"lin{i}.model.1.weight"],
                              device=img1.device)[0, :, 0, 0]
        total = total + torch.mean(
            torch.sum((a - b) ** 2 * lin[None, :, None, None], dim=1))
    return total


def lpips_or_none(img1, img2, net: str = "vgg") -> Optional[torch.Tensor]:
    """LPIPS with `net`'s weights, or None when they are absent (the
    metrics CLI falls back from vgg to alex and records which)."""
    if load_weights(net) is not None:
        return lpips(img1, img2, net=net)
    return None
