"""Semantic distillation loss (the 4-term GOI objective).

Counterpart of goi_tpu/semantic/losses.py, the form of ref:train.py:142-167:

  sem_label = softmax(MLP(rendered S-dim feature))            (pixels, K)
  gtl       = L2-normalized ground-truth APE features         (pixels, C)
  sim       = gtl @ normalize(LUT)^T                          (pixels, K)
  label     = one-hot-ish argmax mask of sim (detached)
  lab  = 50 * MSE(sem_label, label)
  sl   = 1 - mean(max_k sim)
  sl1  = mean entropy of softmax(sim * t), t = 1 (<1000 iters) else 2
  recc = 1 - mean cos(LUT[argmax sem_label], gtl)
  total = lab + sl + 0.3*sl1 + recc

The normalizations keep the JAX package's eps guards (PARITY.md
deviation 6). Two choices keep the gradient equal to JAX's and the same
on every run: the max of sim is `amax`, whose gradient splits evenly
over tied codes as JAX's does (a codebook may hold duplicate rows), and
the picked LUT rows are a one-hot product, whose backward is a matmul
rather than an accumulating index_put_.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from goi_tpu_torch.semantic.codebook import SemanticDecoder, normalize_rows


def distillation_loss(
    decoder: SemanticDecoder,
    lut: torch.Tensor,          # (K, C) codebook
    sem_feature: torch.Tensor,  # (pixels, S) rendered semantic features
    gt_features: torch.Tensor,  # (pixels, C) APE features (unnormalized)
    anneal_t: float,            # 1.0 before iter 1000, else 2.0
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    sem_label = torch.softmax(decoder(sem_feature), dim=-1)
    gtl = normalize_rows(gt_features)
    sim = gtl @ normalize_rows(lut).T                      # (pixels, K)

    sim_val = torch.amax(sim, dim=1, keepdim=True)
    label = (sim == sim_val).to(sim.dtype).detach()
    lab = torch.mean((sem_label - label) ** 2) * 50.0
    sl = 1.0 - torch.mean(sim_val)

    code = torch.argmax(sem_label, dim=-1, keepdim=True)
    one_hot = torch.zeros_like(sem_label).scatter_(1, code, 1.0)
    pick = one_hot @ lut                                   # (pixels, C)
    cos = torch.sum(pick * gtl, dim=-1) / (
        torch.linalg.norm(pick, dim=-1) * torch.linalg.norm(gtl, dim=-1)
        + 1e-12)
    recc = 1.0 - torch.mean(cos)

    anneal = sim * anneal_t
    b = torch.softmax(anneal, dim=1) * torch.log_softmax(anneal, dim=1)
    sl1 = -torch.mean(torch.sum(b, dim=-1))

    total = lab + sl + 0.3 * sl1 + recc
    return total, {"lab": lab, "sl": sl, "sl1": sl1, "recc": recc,
                   "total": total}
