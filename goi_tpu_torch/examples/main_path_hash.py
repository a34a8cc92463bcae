"""SHA-256 of the one-card main path's outputs, to hold two checkouts to
the same bits.

    python goi_tpu_torch/examples/main_path_hash.py

imports the goi_tpu_torch it finds on the path (PYTHONPATH=<checkout>
picks a checkout), builds its kernels, renders a seeded 1,000,000-Gaussian
scene (SH degree 3, 10 semantic channels) at 1296x968 through render()
(chunked layout, reduce 'chain' at the suggested budget), takes every
scene attribute's gradient of a seeded loss on the color and semantics,
and lifts a seeded 10-channel map with trace(); it prints one JSON line
of the hashes of the frame, the gradients and the lift. Two checkouts
that print the same hashes compute the same bits on that card. The scene
is made here from numpy seeds, with nothing of the checkout but
GaussianScene.create, Camera.look_at and the renderer.
"""

from __future__ import annotations

import hashlib
import json
import math

import numpy as np
import torch

N_GAUSS = 1_000_000
WIDTH, HEIGHT = 1296, 968
SEM_DIM = 10


def _scene(device):
    from goi_tpu_torch.core.scene import GaussianScene
    rng = np.random.default_rng(0)
    n = N_GAUSS
    scene = GaussianScene.create(
        rng.normal(0, 1.0, (n, 3)).astype(np.float32),
        rng.uniform(0, 1, (n, 3)).astype(np.float32), sh_degree=3,
        sem_dim=SEM_DIM,
        scales=rng.uniform(0.005, 0.02, n).astype(np.float32), device=device)

    def t(a):
        return torch.as_tensor(a.astype(np.float32), device=device)

    return scene.replace(
        active_sh_degree=3,
        opacity=scene.opacity + t(rng.normal(0, 1, (n, 1))),
        rotation=t(rng.normal(0, 1, (n, 4))),
        features_rest=t(0.05 * rng.normal(0, 1, (n, 15, 3))),
        semantics=t(rng.normal(0, 0.3, (n, SEM_DIM))))


def _sha(tensors) -> str:
    h = hashlib.sha256()
    for x in tensors:
        h.update(x.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def main() -> None:
    import goi_tpu_torch
    from goi_tpu_torch.core.camera import Camera, focal2fov, fov2focal
    from goi_tpu_torch.raster import _nvcc
    from goi_tpu_torch.raster.render import (RasterConfig, render,
                                             suggest_budgets, trace)
    _nvcc.build(("gather", "blend_fwd", "blend_bwd", "prefix", "trace"))
    dev = "cuda"
    scene = _scene(dev)
    fovy = focal2fov(fov2focal(0.9, WIDTH), HEIGHT)
    eye = [4.5 * math.sin(0.3), 0.5, -4.5 * math.cos(0.3)]
    cam = Camera.look_at(eye, [0, 0, 0], [0, 1, 0], 0.9, fovy, WIDTH, HEIGHT,
                         device=dev)
    mi, _ = suggest_budgets(scene, cam, margin=1.2)
    cfg = RasterConfig(max_instances=mi, reduce="chain")
    gen = torch.Generator(device=dev).manual_seed(5)
    bg = torch.zeros(3, device=dev)
    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in scene.params().items()}
    out = render(scene.with_params(leaves), cam, bg, cfg)
    loss = sum((out[k] * torch.randn(out[k].shape, generator=gen,
                                     device=dev)).sum()
               for k in ("render", "semantics"))
    loss.backward()
    img = torch.randn((SEM_DIM, HEIGHT, WIDTH), generator=gen, device=dev)
    lift = trace(scene, cam, img, bg, cfg)
    print(json.dumps({
        "package": goi_tpu_torch.__file__, "budget": mi,
        "frame": _sha(out[k] for k in ("render", "semantics", "depth",
                                       "alpha")),
        "grads": _sha(leaves[k].grad for k in sorted(leaves)),
        "trace": _sha([lift["gaussian_semantics"], lift["num_gsem"],
                       lift["render"]])}), flush=True)


if __name__ == "__main__":
    main()
