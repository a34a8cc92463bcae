"""The trained-scene triplet on disk: PLY + decoder pickle + LUT.

Counterpart of the save/load_semantics pair of goi_tpu/data/scene.py
(ref:train.py:184-189): `point_cloud.ply`, `semantic_MLP.pt` (a pickle
of numpy arrays) and `LUT.npy` in one directory. Files written here load
in the JAX package and the reverse.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from goi_tpu_torch.core.ply import load_gaussians_ply, save_gaussians_ply
from goi_tpu_torch.semantic.codebook import SemanticDecoder

PLY = "point_cloud.ply"
DECODER = "semantic_MLP.pt"
LUT = "LUT.npy"


def save(out_dir: str, scene, decoder=None, lut=None) -> str:
    os.makedirs(out_dir, exist_ok=True)
    save_gaussians_ply(os.path.join(out_dir, PLY), scene)
    if decoder is not None:
        decoder.save(os.path.join(out_dir, DECODER))
    if lut is not None:
        np.save(os.path.join(out_dir, LUT), lut.detach().cpu().numpy())
    return out_dir


def load_semantics(out_dir: str, device="cuda"):
    """The (decoder, LUT) pair saved by `save` in either package."""
    decoder = SemanticDecoder.load(os.path.join(out_dir, DECODER),
                                   device=device)
    lut = torch.as_tensor(np.load(os.path.join(out_dir, LUT)),
                          device=device)
    return decoder, lut


def load(out_dir: str, *, sem_dim: int = 10, device="cuda"):
    """(scene, decoder, LUT) from a directory written by `save`."""
    scene = load_gaussians_ply(os.path.join(out_dir, PLY), sem_dim=sem_dim,
                               device=device)
    return (scene, *load_semantics(out_dir, device=device))
