"""Mean 3-nearest-neighbour squared distance (simple-knn's role).

Counterpart of goi_tpu/knn/knn.py, used once to set the initial
Gaussian scales (ref:scene/gaussian_model.py:147). The CUDA reference
(ref:submodules/simple-knn/simple_knn.cu:119-182) Morton-sorts the
points and searches box-pruned neighbourhoods; here, as in the JAX
package: an exact brute force for n <= BRUTE_MAX, else three passes of a
fixed +-window search in the Morton order of the axis-permuted points,
keeping the least estimate per point. The candidate set includes the
point itself, as the CUDA op's does (updateKBest is also fed
points[idx]), so a distance of 0 fills one of the 3 slots and the
result is (d1^2 + d2^2) / 3 over the two nearest true neighbours.
"""

from __future__ import annotations

import numpy as np
import torch

BRUTE_MAX = 4096
_MASK32 = 0xFFFFFFFF


def _morton10(x: torch.Tensor) -> torch.Tensor:
    """10 bits per axis interleaved into a 30-bit Morton code
    (ref:simple_knn.cu coord2Morton/prepMorton); uint32 arithmetic done
    in int64 and masked to 32 bits."""
    def expand_bits(v):
        v = (v * 0x00010001) & _MASK32 & 0xFF0000FF
        v = (v * 0x00000101) & _MASK32 & 0x0F00F00F
        v = (v * 0x00000011) & _MASK32 & 0xC30C30C3
        v = (v * 0x00000005) & _MASK32 & 0x49249249
        return v

    mn = x.amin(0, keepdim=True)
    mx = x.amax(0, keepdim=True)
    q = (x - mn) / torch.clamp(mx - mn, min=1e-12)
    q = torch.clamp(q * 1023.0, 0, 1023).to(torch.int64)
    return (expand_bits(q[:, 0]) * 4 + expand_bits(q[:, 1]) * 2
            + expand_bits(q[:, 2]))


def mean_knn_dist2(points: torch.Tensor, *, k: int = 3, window: int = 128,
                   chunk: int = 2048) -> torch.Tensor:
    """(N, 3) float32 -> (N,) mean of the k smallest squared distances
    within the candidate set (self included), on the points' device."""
    n = points.shape[0]
    if n <= BRUTE_MAX:
        d2 = ((points[:, None, :] - points[None, :, :]) ** 2).sum(-1)
        return torch.topk(d2, min(k, n), dim=1, largest=False).values.mean(-1)

    dev = points.device
    offs = torch.arange(-window, window + 1, device=dev)

    def one_pass(pts_perm):
        """Candidates: +-window in the Morton order of the permuted
        coordinates; each pass over-estimates (a candidate subset), so
        the least over the passes only improves."""
        order = torch.argsort(_morton10(pts_perm), stable=True)
        ps = points[order]
        out_sorted = torch.empty(n, dtype=points.dtype, device=dev)
        for c0 in range(0, n, chunk):
            rows = torch.arange(c0, min(c0 + chunk, n), device=dev)
            raw = rows[:, None] + offs[None, :]
            nb = ps[torch.clamp(raw, 0, n - 1)]          # (rows, 2W+1, 3)
            d2 = ((nb - ps[rows][:, None, :]) ** 2).sum(-1)
            # clamped (duplicate) candidates at the ends would add
            # spurious zero self-distances
            d2 = torch.where((raw >= 0) & (raw < n), d2,
                             torch.full_like(d2, float("inf")))
            out_sorted[c0:c0 + rows.numel()] = torch.topk(
                d2, k, dim=1, largest=False).values.mean(-1)
        out = torch.empty_like(out_sorted)
        out[order] = out_sorted
        return out

    best = one_pass(points)
    for perm in ((1, 2, 0), (2, 0, 1)):
        best = torch.minimum(best, one_pass(points[:, perm]))
    return best


def init_scales_from_points(points: np.ndarray, device="cuda") -> np.ndarray:
    """sqrt(clamp(mean 3-NN dist^2, 1e-7)), the per-point isotropic
    scale init (ref:scene/gaussian_model.py:147-148), computed on
    `device`."""
    pts = torch.as_tensor(np.asarray(points, np.float32), device=device)
    d2 = mean_knn_dist2(pts).cpu().numpy()
    return np.sqrt(np.maximum(d2, 1e-7))
