"""Image/mask helpers, heat overlays, image and video files.

Counterpart of goi_tpu/utils/image.py: the turbo-colormap heat overlay
`clip_color` (ref:utils/image_utils.py:149-178), `apply_mask`,
`compute_mask_ratio` and `calculate_iou` (:27-60), the image-sequence
video writer (:121-140), the NYU40 label palette
(ref:utils/general_utils.py:199-223), and the PNG/JPEG reads, writes
and resizes of the data readers and CLIs, through PIL, imported where
it is used.
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


def apply_mask(a_shape_like: torch.Tensor, mask: torch.Tensor):
    """Broadcast a leading-dim mask to a tensor's shape
    (ref:image_utils.py:27-34)."""
    if mask.ndim == 1:
        mask = mask.reshape(-1, *((1,) * (a_shape_like.ndim - 1)))
    return torch.broadcast_to(mask, a_shape_like.shape)


def compute_mask_ratio(refer_mask, mask) -> float:
    """|refer & mask| / |refer| (ref:image_utils.py:36-49)."""
    refer = np.asarray(refer_mask, bool)
    if not refer.any():
        return 0
    inter = np.logical_and(refer, np.asarray(mask, bool))
    return float(np.count_nonzero(inter) / np.count_nonzero(refer))


def calculate_iou(label, pred) -> float:
    label = np.asarray(label, bool)
    pred = np.asarray(pred, bool)
    union = np.count_nonzero(label | pred)
    if union == 0:
        return 0.0
    return float(np.count_nonzero(label & pred) / union)


def write_video(frames, path: str, fps: int = 10) -> str:
    """Write (H, W, 3) frames (uint8, or float in [0, 1]; or image
    paths) to an mp4 (ref:image_utils.py:121-140) with cv2, else with
    imageio; raises when neither can write it. Returns the path."""
    if isinstance(frames[0], str):
        frames = [read_image(p) for p in frames]
    frames = [np.asarray(f) for f in frames]
    if frames[0].dtype != np.uint8:
        frames = [np.clip(f * 255, 0, 255).astype(np.uint8) for f in frames]
    try:
        import cv2
    except ImportError:
        cv2 = None
    if cv2 is not None:
        h, w = frames[0].shape[:2]
        out = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps,
                              (w, h))
        if out.isOpened():
            for f in frames:
                out.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
            out.release()
            return path
    try:
        import imageio
    except ImportError:
        why = "is not installed" if cv2 is None else f"cannot open {path}"
        raise ImportError(f"write_video: cv2 {why} and imageio is not "
                          f"installed; install opencv-python or imageio"
                          ) from None
    imageio.mimwrite(path, frames, fps=fps)
    return path


# ScanNet NYU40 label palette (ref:utils/general_utils.py:199-223)
NYU40_COLORS = np.array([
    (0, 0, 0), (174, 199, 232), (152, 223, 138), (31, 119, 180),
    (255, 187, 120), (188, 189, 34), (140, 86, 75), (255, 152, 150),
    (214, 39, 40), (197, 176, 213), (148, 103, 189), (196, 156, 148),
    (23, 190, 207), (178, 76, 76), (247, 182, 210), (66, 188, 102),
    (219, 219, 141), (140, 57, 197), (202, 185, 52), (51, 176, 203),
    (200, 54, 131), (92, 193, 61), (78, 71, 183), (172, 114, 82),
    (255, 127, 14), (91, 163, 138), (153, 98, 156), (140, 153, 101),
    (158, 218, 229), (100, 125, 154), (178, 127, 135), (120, 185, 128),
    (146, 111, 194), (44, 160, 44), (112, 128, 144), (96, 207, 209),
    (227, 119, 194), (213, 92, 176), (94, 106, 211), (82, 84, 163),
    (100, 85, 144)], np.uint8)


def nyu40_colorize(labels: np.ndarray) -> np.ndarray:
    """(H, W) int labels in [0, 40] -> (H, W, 3) uint8 colors."""
    lab = np.clip(np.asarray(labels, np.int64), 0, len(NYU40_COLORS) - 1)
    return NYU40_COLORS[lab]


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
