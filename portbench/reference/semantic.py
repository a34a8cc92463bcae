"""Plain GOI semantic math: the codebook's k-means init, the decoder,
the 4-term distillation loss, Adam, and the viewer's query overlay.

Written from GOI's equations (ref:train.py:36-87 and 142-167,
ref:scene/semantic_model.py, ref:gui/main.py:363-398 and 549-604,
ref:utils/image_utils.py:149-178) in plain PyTorch; it imports nothing
of the program. The k-means draws its permutations from a CPU
torch.Generator in the order the published init makes them, so that
the same seed gives the same codebook.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def unit_rows(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.norm(x, dim=1, keepdim=True),
                           min=1e-8)


def kmeans(gen: torch.Generator, x: torch.Tensor, k: int,
           niter: int = 10) -> torch.Tensor:
    """Cosine k-means: unit points, centres from a random permutation
    (tiled when there are fewer points than centres), assignment by the
    largest dot product, means of the assigned points, an empty centre
    re-drawn from a fresh permutation. A fresh permutation is drawn at
    every iteration, used or not."""
    n = x.shape[0]
    x = unit_rows(x)

    def draw():
        perm = torch.randperm(n, generator=gen)
        return x[perm[torch.arange(k) % n].to(x.device)]

    centres = draw()
    for _ in range(niter):
        centres = unit_rows(centres)
        assign = torch.argmax(x @ centres.T, dim=1)
        one_hot = torch.nn.functional.one_hot(assign, k).to(x.dtype)
        sums = one_hot.T @ x
        cnt = one_hot.sum(0)
        empty = cnt == 0
        centres = torch.where(empty[:, None], draw(),
                              sums / torch.where(empty, 1.0, cnt)[:, None])
    return centres


def init_codebook(gen: torch.Generator, maps, tab_len: int = 300,
                  per_image: int = 80, stride: int = 8,
                  max_points: int = 65536) -> torch.Tensor:
    """Two-level init: k-means(per_image) over the distinct pixel
    features of every stride-th map (at most max_points of them, picked
    by numpy's default_rng(map index)), then k-means(tab_len) over all
    the partial centres."""
    parts = []
    for i, fm in enumerate(maps[::stride]):
        pts = torch.unique(fm.reshape(fm.shape[0], -1).T, dim=0)
        if pts.shape[0] > max_points:
            idx = np.random.default_rng(i).choice(pts.shape[0], max_points,
                                                  replace=False)
            pts = pts[torch.as_tensor(idx, device=pts.device)]
        parts.append(kmeans(gen, pts, min(per_image, pts.shape[0])))
    return kmeans(gen, torch.cat(parts), tab_len)


def init_decoder(gen: torch.Generator, dim_in: int, dim_out: int, device):
    """One linear layer with bias: Xavier-uniform weight (out, in) from
    `gen`, zero bias."""
    bound = math.sqrt(6.0 / (dim_in + dim_out))
    w = (torch.rand((dim_out, dim_in), generator=gen) * 2 - 1) * bound
    return w.to(device), torch.zeros(dim_out, device=device)


def distill_loss(weight, bias, lut, sem, gt, anneal_t: float = 1.0,
                 keep=None):
    """total = lab + sl + 0.3 sl1 + recc over pixels (rows of sem (P, S)
    and gt (P, C)); `keep` restricts it to some rows."""
    if keep is not None:
        sem, gt = sem[keep], gt[keep]
    label_p = torch.softmax(sem @ weight.T + bias, dim=-1)
    gtl = unit_rows(gt)
    sim = gtl @ unit_rows(lut).T
    best = torch.amax(sim, dim=1, keepdim=True)
    label = (sim == best).to(sim.dtype).detach()
    lab = torch.mean((label_p - label) ** 2) * 50.0
    sl = 1.0 - torch.mean(best)
    code = torch.argmax(label_p, dim=-1)
    pick = torch.nn.functional.one_hot(code, lut.shape[0]).to(lut.dtype) \
        @ lut
    cos = torch.sum(pick * gtl, -1) / (torch.linalg.norm(pick, dim=-1)
                                       * torch.linalg.norm(gtl, dim=-1)
                                       + 1e-12)
    recc = 1.0 - torch.mean(cos)
    a = sim * anneal_t
    sl1 = -torch.mean(torch.sum(torch.softmax(a, 1) * torch.log_softmax(a, 1),
                                -1))
    return lab + sl + 0.3 * sl1 + recc


class Adam:
    """Adam with bias correction: p -= lr m_hat / (sqrt(v_hat) + eps)."""

    def __init__(self, lr: float, eps: float, b1=0.9, b2=0.999):
        self.lr, self.eps, self.b1, self.b2 = lr, eps, b1, b2
        self.m = self.v = None
        self.t = 0

    def step(self, p: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
        if self.m is None:
            self.m, self.v = torch.zeros_like(p), torch.zeros_like(p)
        self.t += 1
        self.m = self.b1 * self.m + (1 - self.b1) * g
        self.v = self.b2 * self.v + (1 - self.b2) * g * g
        mh = self.m / (1 - self.b1 ** self.t)
        vh = self.v / (1 - self.b2 ** self.t)
        return p - self.lr * mh / (torch.sqrt(vh) + self.eps)


def turbo_table() -> np.ndarray:
    """matplotlib's 256-entry 'turbo' colormap, else its published
    polynomial fit."""
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


def query_frame(rgb, sem, weight, bias, lut, text, *, log_scale=0.0,
                thresh=0.86):
    """The viewer's open-vocabulary overlay as uint8 (H, W, 3): decode
    each pixel's semantics to its code's unit codebook row (argmax of
    softmax(10 logits)), relevancy sigmoid(<row, text> / exp(log_scale)
    + 2) zeroed under `thresh`, turbo heat over the colour at 0.4."""
    s, h, w = sem.shape
    logits = sem.reshape(s, -1).T @ weight.T + bias
    code = torch.argmax(torch.softmax(logits * 10.0, dim=-1), dim=-1)
    feat = lut[code]
    feat = feat / torch.clamp(torch.linalg.norm(feat, dim=-1, keepdim=True),
                              min=1e-12)
    x = torch.clamp(feat @ text / math.exp(log_scale), -50000.0, 50000.0)
    sim = torch.sigmoid(x + 2.0)
    sim = torch.where(sim < thresh, torch.zeros_like(sim), sim)
    off = sim == 0
    rel = torch.clamp((sim - 0.75) / (sim.max() - 0.7), 0.0, 1.0)
    table = torch.as_tensor(turbo_table(), device=sem.device)
    idx = torch.clamp((rel * 255).to(torch.int32), 0, 255).long()
    heat = torch.where(off[:, None], torch.ones_like(table[idx]), table[idx])
    heat = torch.clamp(heat.reshape(h, w, 3), 0, 1)
    img = rgb.permute(1, 2, 0)
    out = torch.clamp(heat * 0.4 + img * 0.6, 0, 1)
    return (out * 255.0).to(torch.uint8)
