"""Image/mask helpers, heat overlays and image files.

Counterpart of goi_tpu/utils/image.py (the parts the query frame and the
CLIs use): the turbo-colormap heat overlay `clip_color`
(ref:utils/image_utils.py:149-178), `compute_mask_ratio` (:36-49), and
the PNG/JPEG reads, writes and resizes of the data readers and CLIs,
through PIL, imported where the JAX package imports it.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.cache
def _turbo_table() -> np.ndarray:
    """256-entry turbo colormap (matplotlib 'turbo'), else the published
    polynomial fit, as the JAX package builds it."""
    try:
        import matplotlib
        return np.asarray(matplotlib.colormaps.get_cmap("turbo").colors,
                          np.float32)
    except ImportError:
        x = np.linspace(0.0, 1.0, 256)
        r = (0.13572138 + 4.61539260 * x - 42.66032258 * x ** 2
             + 132.13108234 * x ** 3 - 152.94239396 * x ** 4
             + 59.28637943 * x ** 5)
        g = (0.09140261 + 2.19418839 * x + 4.84296658 * x ** 2
             - 14.18503333 * x ** 3 + 4.27729857 * x ** 4
             + 2.82956604 * x ** 5)
        b = (0.10667330 + 12.64194608 * x - 60.58204836 * x ** 2
             + 110.36276771 * x ** 3 - 89.90310912 * x ** 4
             + 27.34824973 * x ** 5)
        return np.clip(np.stack([r, g, b], -1), 0, 1).astype(np.float32)


def turbo_colormap(value: torch.Tensor) -> torch.Tensor:
    """[0,1] values -> RGB via the turbo LUT."""
    table = torch.as_tensor(_turbo_table(), device=value.device)
    idx = (value * (table.shape[0] - 1)).to(torch.int32)
    return table[torch.clamp(idx, 0, table.shape[0] - 1).long()]


def clip_color(cos_sim, bg_mask, height: int, width: int,
               thresh: float = 0.7, res_finetuned: bool = False,
               coloring: bool = False):
    """Similarity -> (heat overlay, alpha) as the GUI renders it
    (ref:utils/image_utils.py:149-178). cos_sim/bg_mask are flat (H*W,)
    tensors; bg_mask True marks background pixels."""
    if res_finetuned:
        rel = torch.clamp(cos_sim + 0.2, 0.1, 0.9)
    else:
        rel = torch.clamp((cos_sim - thresh - 0.05)
                          / (cos_sim.max() - thresh), 0.0, 1.0)
    if coloring:
        heat = turbo_colormap(rel)
        heat = torch.where(bg_mask[:, None], torch.ones_like(heat), heat)
        masked_hi = torch.clamp(heat.reshape(height, width, 3), 0, 1)
    else:
        masked_hi = 1
    if not coloring or res_finetuned:
        alpha = bg_mask.to(torch.float32).reshape(height, width, 1)
    else:
        alpha = 1
    return masked_hi, alpha


def compute_mask_ratio(refer_mask, mask) -> float:
    """|refer & mask| / |refer| (ref:image_utils.py:36-49)."""
    refer = np.asarray(refer_mask, bool)
    if not refer.any():
        return 0
    inter = np.logical_and(refer, np.asarray(mask, bool))
    return float(np.count_nonzero(inter) / np.count_nonzero(refer))


def read_image(path: str, mode: str = "RGB") -> np.ndarray:
    """An image file as uint8 (H, W, 3) for mode "RGB", (H, W) for "L"."""
    from PIL import Image
    with Image.open(path) as im:
        return np.asarray(im.convert(mode))


def image_size(path: str) -> tuple:
    """(width, height) of an image file, read from its header."""
    from PIL import Image
    with Image.open(path) as im:
        return im.size


def resize_image(arr: np.ndarray, width: int, height: int,
                 resample: str) -> np.ndarray:
    """uint8 (H, W[, C]) -> (height, width[, C]) with PIL's "lanczos" (the
    dataset's images) or "bilinear" (eval_seg's masks) filter."""
    from PIL import Image
    filt = {"lanczos": Image.LANCZOS, "bilinear": Image.BILINEAR}[resample]
    return np.asarray(Image.fromarray(arr).resize((width, height), filt))


def save_image(img, path: str) -> None:
    """(3,H,W), (1,H,W) or (H,W,3) float in [0,1] (array or tensor) ->
    8-bit PNG, as the JAX package writes it (x 255, clipped, truncated)."""
    from PIL import Image
    arr = img.detach().cpu().numpy() if torch.is_tensor(img) \
        else np.asarray(img)
    if arr.ndim == 3 and arr.shape[0] in (1, 3):
        arr = arr.transpose(1, 2, 0)
    if arr.shape[-1] == 1:
        arr = arr[..., 0]
    Image.fromarray(np.clip(arr * 255, 0, 255).astype(np.uint8)).save(path)
