"""Semantic codebook decoder.

Counterpart of goi_tpu/semantic/codebook.py (inference half): an MLP
decoding the rendered 10-dim semantic feature into codebook logits
(ref:scene/semantic_model.py:13-63; the GOI default is one 10->300
layer with bias, ref:train.py:64). Checkpoints use the JAX package's
pickle of numpy arrays, so either package loads the other's files.
`kmeans` and `init_codebook` belong to training and are not ported yet.
"""

from __future__ import annotations

import math
import pickle
from typing import List, Optional

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
