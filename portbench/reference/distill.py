"""The plain distillation trainer's first steps, the yardstick of the
distillation cells.

From the cell's seeded inputs alone (scene, views, feature maps, seed)
it works out what the program derives from them (the codebook, the
decoder's initial weights, the epoch order of the views) and runs the
first steps of GOI's distillation: render each view's semantic map,
the 4-term loss over the batch's pixels, the gradients of the semantic
features, the decoder and the codebook, and one Adam step each
(semantics lr 5e-3 eps 1e-15, decoder 3e-3 and codebook 1e-3 at eps
1e-8; ref:train.py:63-67). Only semantics is trained among the
Gaussians' attributes, so the geometry and each view's tile lists are
the same at every step.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import raster, semantic

LEAVES = ("semantics", "decoder.weight", "decoder.bias", "lut")
OPTIM = {"semantics": (5e-3, 1e-15), "decoder.weight": (3e-3, 1e-8),
         "decoder.bias": (3e-3, 1e-8), "lut": (1e-3, 1e-8)}


def view_order(seed: int, n_views: int, steps: int, batch: int) -> list:
    """The views of each step: a fresh permutation of the views an epoch
    from numpy's default_rng(seed), taken from its end, `batch` a
    step."""
    rng = np.random.default_rng(seed)
    stack, out = [], []
    for _ in range(steps):
        step = []
        for _ in range(batch):
            if not stack:
                stack = list(rng.permutation(n_views))
            step.append(int(stack.pop()))
        out.append(step)
    return out


def first_steps(scene: dict, views: list, maps: list, seed: int, *,
                tab_len: int, steps: int = 3, batch: int = 1,
                keep_half: bool = False) -> dict:
    """Losses of the first `steps` steps, each leaf's first gradient and
    its parameters before and after those steps (float32 on the maps'
    device). With `keep_half` the loss takes the first half of each
    map's pixels only (a fault the comparison must catch)."""
    dev = maps[0].device
    gen = torch.Generator().manual_seed(seed)
    lut = semantic.init_codebook(gen, maps, tab_len=tab_len)
    weight, bias = semantic.init_decoder(gen, scene["semantics"].shape[1],
                                         tab_len, dev)
    p = {"semantics": scene["semantics"].clone(), "decoder.weight": weight,
         "decoder.bias": bias, "lut": lut}
    start = {k: v.clone() for k, v in p.items()}
    opt = {k: semantic.Adam(*OPTIM[k]) for k in LEAVES}
    geometry = {}
    losses, grad1 = [], None
    for step_views in view_order(seed, len(views), steps, batch):
        grads = {k: torch.zeros_like(v) for k, v in p.items()}
        total = 0.0
        for vi in step_views:
            if vi not in geometry:
                sp = raster.preprocess(scene, views[vi])
                geometry[vi] = (sp, raster.tile_lists(sp))
            sp, lists = geometry[vi]
            sp = dict(sp, semantics=p["semantics"])
            smap = raster.render(sp, lists, color=False)["semantics"]
            s, h, w = smap.shape
            leaf = smap.reshape(s, -1).T.clone().requires_grad_()
            dec = {k: p[k].clone().requires_grad_()
                   for k in ("decoder.weight", "decoder.bias", "lut")}
            gt = maps[vi].reshape(maps[vi].shape[0], -1).T
            keep = torch.arange(h * w // 2, device=dev) if keep_half else None
            loss = semantic.distill_loss(dec["decoder.weight"],
                                         dec["decoder.bias"], dec["lut"],
                                         leaf, gt, keep=keep) / len(step_views)
            loss.backward()
            total += float(loss.detach())
            for k in dec:
                grads[k] += dec[k].grad
            grads["semantics"] += raster.semantic_grad(
                sp, lists, leaf.grad.T.reshape(s, h, w))
            del leaf, dec, loss, smap
        losses.append(total)
        if grad1 is None:
            grad1 = {k: v.clone() for k, v in grads.items()}
        p = {k: opt[k].step(p[k], grads[k]) for k in LEAVES}
    return {"losses": losses, "grad1": grad1, "start": start, "end": p}
