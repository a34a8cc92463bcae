"""goi_tpu_torch against the independent float64 golden vectors
(tests/golden/golden_vectors.json, from a from-scratch transcription of
the CUDA rasterizer math), at tests/test_golden_vectors.py's
tolerances: the forward of both backends, and the gradients of the
oracle (pure PyTorch, so autograd runs through preprocess too)."""

import json
import math
import os

import numpy as np
import pytest
import torch

from goi_tpu_torch.core.camera import Camera
from goi_tpu_torch.core.scene import GaussianScene
from goi_tpu_torch.raster.render import RasterConfig, render

torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "golden_vectors.json")


def _setup():
    with open(GOLDEN) as f:
        g = json.load(f)
    s = g["scene"]

    def t(v):
        return torch.tensor(v, dtype=torch.float32)

    scene = GaussianScene.create(np.asarray(s["xyz"], np.float32), None,
                                 sh_degree=0, sem_dim=10, device="cpu")
    scene = scene.replace(features_dc=t(s["dc"])[:, None, :],
                          scaling=torch.log(t(s["scale"])),
                          rotation=t(s["quat"]),
                          opacity=t(s["opa_logit"])[:, None],
                          semantics=t(s["sem"]), active_sh_degree=0)
    w, h = s["wh"]
    fov = 2.0 * math.atan(s["tan_fov"])
    cam = Camera.from_Rt(np.eye(3), np.zeros(3), fovx=fov, fovy=fov,
                         width=w, height=h, znear=s["znear"],
                         zfar=s["zfar"], device="cpu")
    return g, scene, cam, t(s["bg"])


def _cfg(backend):
    return RasterConfig(max_instances=1 << 12, backend=backend)


@pytest.mark.parametrize("backend", ["reference", "cuda"])
def test_forward_matches_golden(backend):
    g, scene, cam, bg = _setup()
    out = render(scene, cam, bg, _cfg(backend))
    color = out["render"].permute(1, 2, 0).numpy()
    sem = out["semantics"].permute(1, 2, 0).numpy()
    depth = out["depth"][0].numpy()
    alpha = out["alpha"][0].numpy()
    for p in g["probes"]:
        y, x = p["yx"]
        np.testing.assert_allclose(color[y, x], p["color"], atol=3e-5,
                                   err_msg=f"color@{y},{x}")
        np.testing.assert_allclose(sem[y, x], p["sem"], atol=3e-5)
        np.testing.assert_allclose(depth[y, x], p["depth"], atol=2e-4)
        np.testing.assert_allclose(alpha[y, x], p["alpha"], atol=3e-5)
    np.testing.assert_allclose(color.sum(axis=(0, 1)), g["sums"]["color"],
                               rtol=1e-5)
    np.testing.assert_allclose(sem.sum(axis=(0, 1)), g["sums"]["sem"],
                               rtol=1e-4, atol=2e-4)
    np.testing.assert_allclose(depth.sum(), g["sums"]["depth"], rtol=1e-5)
    np.testing.assert_allclose(alpha.sum(), g["sums"]["alpha"], rtol=1e-5)


def test_oracle_gradients_match_golden():
    g, scene, cam, bg = _setup()
    w, h = g["scene"]["wh"]
    idx = np.arange(h * w, dtype=np.float32).reshape(h, w)
    wc = torch.tensor(np.stack([np.cos(0.1 * idx + c) for c in range(3)], 0))
    ws = torch.tensor(np.stack([math.cos(0.3 * k + 1.0) * np.ones((h, w))
                                for k in range(10)], 0).astype(np.float32))
    leaves = {k: getattr(scene, k).clone().requires_grad_(True)
              for k in ("xyz", "scaling", "rotation", "opacity",
                        "features_dc", "semantics")}
    out = render(scene.replace(**leaves), cam, bg, _cfg("reference"))
    loss = (torch.sum(out["render"] * wc) + torch.sum(out["semantics"] * ws)
            + 0.05 * torch.sum(out["depth"]) + 0.07 * torch.sum(out["alpha"]))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), g["loss"], rtol=1e-5)
    got = {
        "xyz": leaves["xyz"].grad,
        "scaling_log": leaves["scaling"].grad,
        "quat": leaves["rotation"].grad,
        "opa_logit": leaves["opacity"].grad[:, 0],
        "dc": leaves["features_dc"].grad[:, 0, :],
        "sem": leaves["semantics"].grad,
    }
    for k, v in got.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(g["grads"][k]),
                                   rtol=2e-3, atol=2e-4, err_msg=k)
