"""The port's CUDA kernels against their plain versions, on the card.

Marked `cuda`: they skip where no NVIDIA GPU is present. On the card
(`--noconftest` because tests/conftest.py imports JAX, which a GPU
machine need not have; nothing here uses it):

    python -m pytest --noconftest tests/test_torch_cuda.py -q -m cuda
"""

import numpy as np
import pytest
import torch

from goi_tpu_torch.core.camera import Camera
from goi_tpu_torch.core.scene import GaussianScene
from goi_tpu_torch.raster import cuda_blend
from goi_tpu_torch.raster.binning import bin_splats_chunked
from goi_tpu_torch.raster.gather import monotone_gather, \
    monotone_gather_plain
from goi_tpu_torch.raster.preprocess import preprocess
from goi_tpu_torch.raster.render import RasterConfig, render

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc")
    return torch.device("cuda")


def _scene(n, sem_dim, seed, device):
    rng = np.random.default_rng(seed)
    s = GaussianScene.create(
        rng.normal(0, 1, (n, 3)).astype(np.float32),
        rng.uniform(0, 1, (n, 3)).astype(np.float32), sh_degree=3,
        sem_dim=sem_dim, scales=rng.uniform(0.01, 0.05, n).astype(np.float32),
        device=device)
    return s.replace(
        active_sh_degree=3,
        opacity=s.opacity + torch.as_tensor(
            rng.normal(0, 1, (n, 1)).astype(np.float32), device=device),
        semantics=torch.as_tensor(
            rng.normal(0, 1, (n, sem_dim)).astype(np.float32), device=device))


def _cam(device, w=160, h=120):
    return Camera.look_at([0.5, 0.4, -4.0], [0, 0, 0], [0, 1, 0], 0.9, 0.7,
                          w, h, device=device)


def test_gather_kernel_bit_exact(cuda):
    rng = np.random.default_rng(0)
    counts = rng.integers(1, 6, 5000)
    idx = np.repeat(np.arange(5000, dtype=np.int32), counts)
    table = torch.as_tensor(rng.normal(0, 1, (14, 5000)).astype(np.float32),
                            device=cuda)
    idx = torch.as_tensor(idx, device=cuda)
    before = monotone_gather.launches
    out = monotone_gather(table, idx)
    torch.cuda.synchronize()
    assert monotone_gather.launches == before + 1
    assert torch.equal(out.view(torch.int32),
                       monotone_gather_plain(table, idx).view(torch.int32))


@pytest.mark.parametrize("sem_dim", cuda_blend.SEM_DIMS)
def test_blend_kernel_matches_plain(cuda, sem_dim):
    scene = _scene(4000, sem_dim, sem_dim, cuda)
    cam = _cam(cuda)
    sp = preprocess(scene, cam)
    b = bin_splats_chunked(sp, grid_x=10, grid_y=8, max_instances=1 << 16,
                           chunk_k=cuda_blend.K)
    feat = cuda_blend._pack_impl(sp.mean2d, sp.conic, sp.opacity, sp.color,
                                 sp.semantics, sp.depth, b.point_list)
    before = cuda_blend.blend_fwd.launches
    got = cuda_blend.blend_fwd(feat, b.tile_start, b.tile_end, 10)
    torch.cuda.synchronize()
    assert cuda_blend.blend_fwd.launches == before + 1
    want = cuda_blend.blend_fwd_plain(feat, b.tile_start, b.tile_end, 10)
    n = 4 + sem_dim + 1
    torch.testing.assert_close(got[..., :n], want[..., :n], rtol=5e-5,
                               atol=5e-5)


def test_render_on_card_matches_cpu(cuda):
    scene = _scene(3000, 10, 7, cuda)
    cfg = RasterConfig(max_instances=1 << 16)
    bg = torch.ones(3)
    got = render(scene, _cam(cuda), bg.to(cuda), cfg)
    want = render(scene.to("cpu"), _cam("cpu"), bg, cfg)
    for k in ("render", "semantics", "depth", "alpha"):
        torch.testing.assert_close(got[k].cpu(), want[k], rtol=5e-5,
                                   atol=5e-5)
    assert int(got["num_slots"]) == int(want["num_slots"])
