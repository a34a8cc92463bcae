"""Semantic codebook: the decoder MLP and the k-means codebook init.

Counterpart of goi_tpu/semantic/codebook.py: an MLP decoding the
rendered 10-dim semantic feature into codebook logits
(ref:scene/semantic_model.py:13-63; the GOI default is one 10->300
layer with bias, ref:train.py:64), and the two-level cosine k-means that
seeds the 300x256 lookup table (ref:train.py:36-56, 79-87).
Checkpoints use the JAX package's pickle of numpy arrays, so either
package loads the other's files. Random draws come from an explicit CPU
`torch.Generator`; they are not JAX's draws, so k-means agrees with the
JAX package's only where the clustering does not hinge on the draw.
"""

from __future__ import annotations

import math
import pickle
from typing import List, Optional, Sequence

import numpy as np
import torch
from torch import nn


class SemanticDecoder(nn.Module):
    """Linear layers with ReLU between, identity (or L2 norm) at the end
    (ref:scene/semantic_model.py:13-50). Weights are (out, in)."""

    def __init__(self, weights: List[torch.Tensor],
                 biases: List[Optional[torch.Tensor]],
                 norm_output: bool = False):
        super().__init__()
        if len(weights) != len(biases):
            raise ValueError("one bias (or None) per weight expected")
        self.num_layer = len(weights)
        self.norm_output = norm_output
        for i, (w, b) in enumerate(zip(weights, biases)):
            self.register_parameter(f"weight_{i}", nn.Parameter(w))
            self.register_parameter(
                f"bias_{i}", None if b is None else nn.Parameter(b))

    @property
    def weights(self) -> List[torch.Tensor]:
        return [getattr(self, f"weight_{i}") for i in range(self.num_layer)]

    @property
    def biases(self) -> List[Optional[torch.Tensor]]:
        return [getattr(self, f"bias_{i}") for i in range(self.num_layer)]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, (w, b) in enumerate(zip(self.weights, self.biases)):
            x = x @ w.T
            if b is not None:
                x = x + b
            if i < self.num_layer - 1:
                x = torch.relu(x)
        if self.norm_output:
            x = x / torch.linalg.norm(x, dim=-1, keepdim=True)
        return x

    @staticmethod
    def create(generator: torch.Generator, dim_in=10, dim_hidden=128,
               dim_out=300, num_layer=1, use_bias=True, norm=False,
               device="cuda") -> "SemanticDecoder":
        """Xavier-uniform weights (torch.nn.init.xavier_uniform_'s bound)
        drawn from `generator` (a CPU generator), zero biases."""
        ws, bs = [], []
        for i in range(num_layer):
            d_in = dim_in if i == 0 else dim_hidden
            d_out = dim_out if i == num_layer - 1 else dim_hidden
            bound = math.sqrt(6.0 / (d_in + d_out))
            w = torch.rand((d_out, d_in), generator=generator) * 2 - 1
            ws.append((w * bound).to(device))
            bs.append(torch.zeros(d_out, device=device) if use_bias
                      else None)
        return SemanticDecoder(ws, bs, norm_output=norm)

    def save(self, path: str) -> None:
        """The JAX package's self-describing pickle (numpy arrays)."""
        blob = {
            "args": {
                "dim_in": self.weights[0].shape[1],
                "dim_out": self.weights[-1].shape[0],
                "num_layer": self.num_layer,
                "use_bias": self.biases[0] is not None,
                "norm": self.norm_output,
            },
            "weights": [w.detach().cpu().numpy() for w in self.weights],
            "biases": [None if b is None else b.detach().cpu().numpy()
                       for b in self.biases],
        }
        with open(path, "wb") as f:
            pickle.dump(blob, f)

    @staticmethod
    def load(path: str, device="cuda") -> "SemanticDecoder":
        """Load a checkpoint written by `save` in either package."""
        with open(path, "rb") as f:
            blob = pickle.load(f)
        return SemanticDecoder(
            [torch.as_tensor(w, device=device) for w in blob["weights"]],
            [None if b is None else torch.as_tensor(b, device=device)
             for b in blob["biases"]],
            norm_output=blob["args"]["norm"])


def normalize_rows(x: torch.Tensor) -> torch.Tensor:
    """Rows scaled to unit norm, with the JAX package's eps guard."""
    return x / torch.clamp(torch.linalg.norm(x, dim=1, keepdim=True),
                           min=1e-8)


def kmeans(generator: torch.Generator, x: torch.Tensor, ncluster: int,
           niter: int = 10) -> torch.Tensor:
    """Cosine k-means on the unit sphere (ref:train.py:36-56): normalize
    points, init from a random permutation (tiled when n < ncluster),
    assign by max dot product, recompute means, re-init dead clusters
    from a fresh permutation. The sums are a one-hot matmul, so they
    are the same on every run."""
    n = x.shape[0]
    x = normalize_rows(x)

    def pick():
        perm = torch.randperm(n, generator=generator)
        return x[perm[torch.arange(ncluster) % n].to(x.device)]

    centers = pick()
    for _ in range(niter):
        centers = normalize_rows(centers)
        assign = torch.argmax(x @ centers.T, dim=1, keepdim=True)
        one_hot = torch.zeros((n, ncluster), dtype=x.dtype,
                              device=x.device).scatter_(1, assign, 1.0)
        sums = one_hot.T @ x
        cnt = one_hot.sum(0)
        dead = cnt == 0
        centers = torch.where(dead[:, None], pick(),
                              sums / torch.where(dead, 1.0, cnt)[:, None])
    return centers


def init_codebook(generator: torch.Generator, feature_maps: Sequence,
                  tab_len: int = 300, per_image_clusters: int = 80,
                  stride: int = 8, max_points_per_image: int = 65536,
                  device=None) -> torch.Tensor:
    """Two-level codebook init (ref:train.py:79-87): per-image
    k-means(80) over the distinct pixel features of every `stride`-th
    map (subsampled by np.random.default_rng(i).choice past
    max_points_per_image), then k-means(tab_len) over the concatenated
    per-image centers.

    feature_maps: (C, H, W) or (HW, C) arrays or tensors; each is moved
    to `device` (default: its own) and clustered there."""
    partials = []
    for i, fm in enumerate(feature_maps[::stride]):
        fm = torch.as_tensor(fm, dtype=torch.float32, device=device)
        if fm.dim() == 3:
            fm = fm.reshape(fm.shape[0], -1).T          # (HW, C)
        # the distinct rows in lexicographic order, as np.unique(axis=0)
        fm = torch.unique(fm, dim=0)
        if fm.shape[0] > max_points_per_image:
            idx = np.random.default_rng(i).choice(
                fm.shape[0], max_points_per_image, replace=False)
            fm = fm[torch.as_tensor(idx, device=fm.device)]
        k = min(per_image_clusters, fm.shape[0])
        partials.append(kmeans(generator, fm, k))
    return kmeans(generator, torch.cat(partials, 0), tab_len)
