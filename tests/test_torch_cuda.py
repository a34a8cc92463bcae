"""The port's CUDA kernels against their plain versions, on the card.

Marked `cuda`: they skip where no NVIDIA GPU is present. On the card
(`--noconftest` because tests/conftest.py imports JAX, which a GPU
machine need not have; nothing here uses it):

    python -m pytest --noconftest tests/test_torch_cuda.py -q -m cuda

Tolerances: the forward blend 5e-5 (tests/test_pallas_blend.py's oracle
bar); the backward rtol 2e-3 / atol 2e-4 (its gradient bar: the suffix
R_i = total - prefix_i cancels, and the plain version's CUDA cumsum and
cumprod associate differently from the kernel's sequential walk); the
block prefix rtol 1e-4 with atol 1e-5 of the rows' magnitude (an fp32
scan of up to 512 rows in another order); the trace kernel's render at
the forward's 5e-5, its hit counts and the plain version's exactly (both
multiply the transmittance in the same order), its lifted features at
tests/test_trace.py's 1e-4 (sums of up to 256 pixels in another order);
the fused prefix-boundary reduce and the mono row gather bit for bit.
"""

import numpy as np
import pytest
import torch

from goi_tpu_torch.core.camera import Camera
from goi_tpu_torch.core.scene import GaussianScene
from goi_tpu_torch.raster import cuda_blend
from goi_tpu_torch.raster import reduce as R
from goi_tpu_torch.raster import cuda_trace
from goi_tpu_torch.raster.binning import bin_splats_chunked
from goi_tpu_torch.raster.gather import (mono_rows, mono_rows_plain,
                                         monotone_gather,
                                         monotone_gather_plain)
from goi_tpu_torch.raster.preprocess import preprocess
from goi_tpu_torch.raster.render import RasterConfig, render, trace
from goi_tpu_torch.semantic.codebook import SemanticDecoder
from goi_tpu_torch.train.distill import create_distill_state, distill_loss
from goi_tpu_torch.train.optim import OptimConfig

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


def _packed(sem_dim, device):
    scene = _scene(4000, sem_dim, sem_dim, device)
    sp = preprocess(scene, _cam(device))
    b = bin_splats_chunked(sp, grid_x=10, grid_y=8, max_instances=1 << 16,
                           chunk_k=cuda_blend.K)
    feat = cuda_blend._pack_impl(sp.mean2d, sp.conic, sp.opacity, sp.color,
                                 sp.semantics, sp.depth, b.point_list)
    return feat, b


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
    feat, b = _packed(sem_dim, cuda)
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


@pytest.mark.parametrize("sem_dim", cuda_blend.SEM_DIMS)
def test_blend_bwd_kernel_matches_plain(cuda, sem_dim):
    feat, b = _packed(sem_dim, cuda)
    raw = cuda_blend.blend_fwd(feat, b.tile_start, b.tile_end, 10)
    gen = torch.Generator(device=cuda).manual_seed(sem_dim)
    grad = torch.randn(raw.shape, generator=gen, device=cuda)
    before = cuda_blend.blend_bwd.launches
    got = cuda_blend.blend_bwd(feat, b.tile_start, b.tile_end, raw, grad, 10)
    torch.cuda.synchronize()
    assert cuda_blend.blend_bwd.launches == before + 1
    want = cuda_blend.blend_bwd_plain(feat, b.tile_start, b.tile_end, raw,
                                      grad, 10)
    torch.testing.assert_close(got, want, rtol=2e-3, atol=2e-4)
    kept = int(b.tile_end[-1])
    assert not got[kept:].any() and got[:kept].abs().sum() > 0


@pytest.mark.parametrize("blk,nb,d,masked", [
    (512, 9, 20, False), (512, 3, 26, True), (256, 5, 70, False),
    (128, 1, 13, True)])
def test_prefix_kernel_matches_plain(cuda, blk, nb, d, masked):
    gen = torch.Generator(device=cuda).manual_seed(blk + d)
    rows = torch.randn((nb * blk, d), generator=gen, device=cuda) * 10
    okf = (torch.rand(nb * blk, generator=gen, device=cuda) > 0.2).float() \
        if masked else None
    before = R.prefix_blocks.launches
    inner, tot = R.prefix_blocks(rows, okf, blk)
    torch.cuda.synchronize()
    assert R.prefix_blocks.launches == before + 1
    want_inner, want_tot = R.prefix_blocks_plain(rows, okf, blk)
    scale = float(want_inner.abs().max())
    torch.testing.assert_close(inner, want_inner, rtol=1e-4,
                               atol=1e-5 * scale)
    torch.testing.assert_close(tot, want_tot, rtol=1e-4, atol=1e-5 * scale)
    assert not inner[nb * blk:].any()


@pytest.mark.parametrize("m", [5 * 512, 3000])
def test_blocked_segment_reduce_on_card_matches_cpu(cuda, m):
    """A whole number of 512-row blocks and a ragged m (padded to the
    128-row block)."""
    rng = np.random.default_rng(m)
    rows = rng.normal(0, 1, (m, 21)).astype(np.float32)
    sizes = rng.geometric(0.3, size=900)
    sizes[::97] += 300
    bounds = np.minimum(np.concatenate([[0], np.cumsum(sizes)]), m + 50)
    args = [torch.as_tensor(rows), torch.as_tensor(bounds)]
    want = R.blocked_segment_reduce(*args)
    got = R.blocked_segment_reduce(*[a.to(cuda) for a in args])
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)


def _close_to_peak(a, b, msg, rtol=2e-3, atol_rel=2e-4):
    """|a - b| <= rtol |b| + atol_rel max|b|: gradients through the
    whole render reach magnitudes where a fixed atol would be tighter
    than fp32 rounding."""
    err = (a - b).abs()
    bound = rtol * b.abs() + atol_rel * b.abs().max()
    assert bool((err <= bound).all()), (
        f"{msg}: max |a - b| {float(err.max())}, max |b| "
        f"{float(b.abs().max())}")


def _render_grads(scene, cam, cfg, bg):
    leaves = {k: v.clone().requires_grad_()
              for k, v in scene.params().items()}
    out = render(scene.with_params(leaves), cam, bg, cfg)
    (out["render"].square().sum() + out["semantics"].square().sum()
     + out["depth"].sum() + out["alpha"].sum()).backward()
    return {k: v.grad for k, v in leaves.items()}


@pytest.mark.parametrize("reduce", ["scatter", "chain"])
def test_render_grads_on_card_are_repeatable_and_match_cpu(cuda, reduce):
    scene = _scene(3000, 10, 7, cuda)
    cfg = RasterConfig(max_instances=1 << 16, reduce=reduce)
    bg = torch.zeros(3, device=cuda)
    before = (cuda_blend.blend_bwd.launches, R.prefix_blocks.launches)
    first = _render_grads(scene, _cam(cuda), cfg, bg)
    second = _render_grads(scene, _cam(cuda), cfg, bg)
    assert cuda_blend.blend_bwd.launches == before[0] + 2
    assert R.prefix_blocks.launches == before[1] + 2
    cpu = _render_grads(scene.to("cpu"), _cam("cpu"), cfg, bg.cpu())
    for k in first:
        assert torch.equal(first[k], second[k]), k
        _close_to_peak(first[k].cpu(), cpu[k], k)


def test_train_step_on_card_matches_cpu(cuda):
    scene = _scene(2000, 10, 3, cuda)
    gen = torch.Generator().manual_seed(0)
    decoder = SemanticDecoder.create(gen, dim_in=10, dim_out=12,
                                     device="cpu")
    lut = torch.randn((12, 32), generator=gen)
    gt = torch.randn((32, 120, 160), generator=gen)
    cfg = RasterConfig(max_instances=1 << 16)
    ocfg = OptimConfig(position_finetune=True, opacity_finetune=True,
                       feature_finetune=True)
    results = []
    for dev in (cuda, "cpu"):
        state, _ = create_distill_state(scene.to(dev), decoder.to(dev),
                                        lut.to(dev), ocfg)
        loss, aux = distill_loss(state, _cam(dev), gt.to(dev),
                                 torch.zeros(3, device=dev), cfg)
        loss.backward()
        grads = {k: v.grad.cpu() for k, v in state.scene.params().items()
                 if v.grad is not None}
        grads["lut"] = state.lut.grad.cpu()
        results.append(({k: float(v.detach()) for k, v in aux.items()},
                        grads))
    (aux_g, g_g), (aux_c, g_c) = results
    for k in ("lab", "sl", "sl1", "recc", "total"):
        assert aux_g[k] == pytest.approx(aux_c[k], rel=1e-4), k
    assert set(g_g) == {"xyz", "features_dc", "features_rest", "semantics",
                        "opacity", "lut"}
    for k in g_g:
        _close_to_peak(g_g[k], g_c[k], k)


@pytest.mark.parametrize("sem_dim,s_img", [
    (s, 10) for s in cuda_blend.SEM_DIMS] + [(10, 0), (10, 3), (16, 31)])
def test_trace_kernel_matches_plain(cuda, sem_dim, s_img):
    feat, b = _packed(sem_dim, cuda)
    gen = torch.Generator(device=cuda).manual_seed(s_img)
    aug = torch.randn((80, 256, s_img + 1), generator=gen, device=cuda)
    aug[..., -1] = 1.0
    aug[70:] = 0.0          # tiles outside the image lift nothing
    before = cuda_trace.trace_fwd.launches
    raw, rows = cuda_trace.trace_fwd(feat, b.tile_start, b.tile_end, aug, 10)
    torch.cuda.synchronize()
    assert cuda_trace.trace_fwd.launches == before + 1
    want_raw, want_rows = cuda_trace.trace_fwd_plain(
        feat, b.tile_start, b.tile_end, aug, 10)
    n = 4 + sem_dim + 1
    torch.testing.assert_close(raw[..., :n], want_raw[..., :n], rtol=5e-5,
                               atol=5e-5)
    assert torch.equal(raw[..., n:], want_raw[..., n:])
    assert torch.equal(rows[:, -1], want_rows[:, -1])
    torch.testing.assert_close(rows, want_rows, rtol=1e-4, atol=1e-4)
    assert rows[:, -1].sum() > 0
    # the embedded render is the forward blend's, bit for bit
    assert torch.equal(raw, cuda_blend.blend_fwd(feat, b.tile_start,
                                                 b.tile_end, 10))


def test_trace_on_card_matches_cpu(cuda):
    scene = _scene(3000, 10, 7, cuda)
    gen = torch.Generator().manual_seed(1)
    img = torch.randn((10, 120, 160), generator=gen)
    bg = torch.ones(3)
    results = []
    for dev, cfg in ((cuda, RasterConfig(max_instances=1 << 16)),
                     (cuda, RasterConfig(max_instances=1 << 19,
                                         dense_reduce=True)),
                     ("cpu", RasterConfig(max_instances=1 << 16))):
        out = trace(scene.to(dev), _cam(dev), img.to(dev), bg.to(dev), cfg)
        results.append({k: v.cpu() for k, v in out.items()})
    want = results[-1]
    for got in results[:2]:
        assert torch.equal(got["num_gsem"], want["num_gsem"])
        torch.testing.assert_close(got["gaussian_semantics"],
                                   want["gaussian_semantics"], rtol=1e-4,
                                   atol=1e-4)
        torch.testing.assert_close(got["render"], want["render"], rtol=5e-5,
                                   atol=5e-5)
    assert int(want["num_gsem"].sum()) > 0


@pytest.mark.parametrize("m,d,repeat", [
    (9 * 512, 20, False), (3000, 11, True), (5 * 512, 70, True)])
def test_prefix_boundary_kernel_bit_identical(cuda, m, d, repeat):
    gen = torch.Generator(device=cuda).manual_seed(m + d)
    rows = torch.randn((m, d), generator=gen, device=cuda) * 10
    sizes = torch.randint(0, 9, (m // 3,), generator=gen, device=cuda)
    bounds = torch.cat([torch.zeros(1, dtype=torch.long, device=cuda),
                        torch.cumsum(sizes, 0)])
    if repeat:   # _chain_bounds under an overflow: m - 1 repeated, then m
        bounds = torch.cat([torch.clamp(bounds, max=m - 1),
                            torch.full((1,), m, device=cuda)])
    before = R.prefix_boundary.launches
    got = R.dense_boundary_reduce(rows, bounds)
    torch.cuda.synchronize()
    assert R.prefix_boundary.launches == before + 1
    assert torch.equal(got, R.blocked_segment_reduce(rows, bounds))
    want = R.dense_boundary_reduce(rows.cpu(), bounds.cpu())
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-3)


def test_dense_reduce_grads_on_card_bit_identical(cuda):
    scene = _scene(3000, 10, 7, cuda)
    cfg = RasterConfig(max_instances=1 << 16, reduce="chain")
    bg = torch.zeros(3, device=cuda)
    off = _render_grads(scene, _cam(cuda), cfg, bg)
    before = R.prefix_boundary.launches
    on = _render_grads(scene, _cam(cuda), RasterConfig(
        max_instances=1 << 16, reduce="chain", dense_reduce=True), bg)
    assert R.prefix_boundary.launches == before + 1
    for k in off:
        assert torch.equal(on[k], off[k]), k


@pytest.mark.parametrize("n,m,blk,span", [
    (1_000_000, 1 << 20, 1024, 2048), (5000, 4000, 8, 16)])
def test_mono_rows_kernel_bit_exact(cuda, n, m, blk, span):
    gen = torch.Generator(device=cuda).manual_seed(n)
    table = torch.randn((n, 24), generator=gen, device=cuda)
    idx = torch.sort(torch.randint(0, n, (m,), generator=gen, device=cuda,
                                   dtype=torch.int32)).values
    before = mono_rows.launches
    got = mono_rows(table, idx, blk, span)
    torch.cuda.synchronize()
    assert mono_rows.launches == before + 1
    want = mono_rows_plain(table, idx, blk, span)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    zero = ~want.any(dim=1)
    assert bool(zero.any()) == (blk == 8)
