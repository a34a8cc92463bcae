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
the fused prefix-boundary reduce, the block owners' sums (owner_sums),
the expansion gathers and the mono row gather bit for bit.
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
from goi_tpu_torch.raster.gather import (expand_gather, expand_gather_plain,
                                         mono_rows, mono_rows_plain,
                                         monotone_gather,
                                         monotone_gather_plain,
                                         slot_owners_search)
from goi_tpu_torch.raster.preprocess import preprocess
from goi_tpu_torch.raster.render import RasterConfig, render, trace
from goi_tpu_torch.semantic.codebook import SemanticDecoder
from goi_tpu_torch.train.distill import create_distill_state, distill_loss
from goi_tpu_torch.train.optim import OptimConfig
# by its basename (pytest puts tests/ on the path): a machine may have
# another package named `tests` installed
from test_torch_block_cull import ADVERSARIAL, REGION, _adversarial

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


@pytest.mark.parametrize("m,c,offset", [(4000, 14, 0), (3999, 14, 0),
                                         (4001, 5, 1)])
def test_monotone_gather_kernel_ragged_and_unaligned(cuda, m, c, offset):
    """m not a multiple of the kernel's 4-slot stores, and an index view
    that starts off a 16-byte boundary."""
    rng = np.random.default_rng(m)
    idx = np.repeat(np.arange(3000, dtype=np.int32),
                    rng.integers(1, 4, 3000))[:m + offset]
    table = torch.as_tensor(rng.normal(0, 1, (c, 3000)).astype(np.float32),
                            device=cuda)
    idx = torch.as_tensor(idx, device=cuda)[offset:]
    got = monotone_gather(table, idx)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32),
                       monotone_gather_plain(table, idx).view(torch.int32))


def _bases(rng, n, zero_share):
    counts = rng.integers(1, 9, n)
    counts[rng.random(n) < zero_share] = 0
    c1 = np.maximum(counts, 1)
    return np.cumsum(c1) - c1, int(c1.sum())


@pytest.mark.parametrize("n,budget,ragged", [
    (5000, 1.3, False), (5000, 1.3, True), (5000, 0.5, False),
    (5000, 0.5, True), (3, 0.5, True), (70_000, 1.0, False)])
def test_expand_gather_kernel_bit_exact(cuda, n, budget, ragged):
    """The fused search + gather against the scatter + cummax + gather,
    with room to spare, under overflow (bases clamped onto the last slot)
    and at an m that is not a multiple of 4."""
    rng = np.random.default_rng(n + int(10 * budget) + ragged)
    base, demand = _bases(rng, n, 0.3)
    m = max(int(demand * budget) // 4 * 4 + (3 if ragged else 0), 1)
    base = torch.as_tensor(base, device=cuda)
    table = torch.as_tensor(rng.normal(0, 1, (14, n)).astype(np.float32),
                            device=cuda)
    before = expand_gather.launches
    g, rows = expand_gather(table, base, m)
    torch.cuda.synchronize()
    assert expand_gather.launches == before + 1
    want_g, want_rows = expand_gather_plain(table, base, m)
    assert torch.equal(g, want_g)
    assert torch.equal(g, slot_owners_search(base, m))
    assert torch.equal(rows.view(torch.int32), want_rows.view(torch.int32))
    assert int(g[-1]) == n - 1     # slots past the demand: the last id


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


def _deep_tiles(sem_dim, device, depths=(0, 700, 1200, 40, 900, 513),
                tail=100):
    """Packed instances of six 16x16 tiles (3 x 2) with the given range
    lengths, over 512 deep in most: splats crowd one corner of each tile,
    so pixels there stop after a few hundred instances and pixels far
    from it never do, each in another batch of the kernel's walk."""
    rng = np.random.default_rng(sem_dim)
    cols = []
    for t, depth in enumerate(depths):
        ox, oy = (t % 3) * 16, (t // 3) * 16
        x = ox + rng.normal(3, 3, depth)
        y = oy + rng.normal(4, 3, depth)
        sig = rng.uniform(1.0, 4.0, depth)
        rho = rng.uniform(-0.3, 0.3, depth)
        ca = 1 / (sig ** 2 * (1 - rho ** 2))
        cc = ca * rng.uniform(0.7, 1.3, depth)
        cb = -rho * np.sqrt(ca * cc)
        opa = rng.uniform(0.02, 0.3, depth)
        rest = rng.normal(0, 1, (4 + sem_dim, depth))
        cols.append(np.vstack([x, y, ca, cb, cc, opa, rest]))
    feat = np.hstack(cols + [rng.normal(0, 1, (10 + sem_dim, tail))])
    ends = np.cumsum(depths).astype(np.int32)
    starts = (ends - np.asarray(depths)).astype(np.int32)
    return (torch.as_tensor(feat.astype(np.float32), device=device),
            torch.as_tensor(starts, device=device),
            torch.as_tensor(ends, device=device))


@pytest.mark.parametrize("sem_dim", cuda_blend.SEM_DIMS)
def test_blend_bwd_kernel_deep_tiles(cuda, sem_dim):
    feat, starts, ends = _deep_tiles(sem_dim, cuda)
    raw = cuda_blend.blend_fwd(feat, starts, ends, 3)
    walked = raw[..., -2]
    assert int(walked.max()) > 512
    # pixels that stopped (walked less than their tile's range) did so
    # in different 256-instance batches of the kernel's walk
    depth = (ends - starts).float()[:, None].expand_as(walked)
    stopped = walked[walked < depth]
    assert len(set(((stopped - 1) // 256).tolist())) >= 2
    gen = torch.Generator(device=cuda).manual_seed(sem_dim)
    grad = torch.randn(raw.shape, generator=gen, device=cuda)
    # the allocator hands the wrapper's torch.empty this NaN-filled block
    junk = torch.full((feat.shape[1], feat.shape[0]), float("nan"),
                      device=cuda)
    del junk
    got = cuda_blend.blend_bwd(feat, starts, ends, raw, grad, 3)
    again = cuda_blend.blend_bwd(feat, starts, ends, raw, grad, 3)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    want = cuda_blend.blend_bwd_plain(feat, starts, ends, raw, grad, 3)
    _close_to_peak(got, want, f"S={sem_dim}")
    zero = ~want.any(dim=1)
    kept = int(ends[-1])
    assert bool(zero[kept:].all()) and not got[kept:].any()
    assert not got[zero].any() and bool(zero[:kept].any())


@pytest.mark.parametrize("sem_dim", cuda_blend.SEM_DIMS)
def test_blend_fwd_kernel_deep_tiles(cuda, sem_dim):
    """Ranges of several 256-instance batches, pixels that stop in
    different batches and warps that stop before their CTA: the walked
    counts, derived from the stopping position, equal the plain
    version's, and so do the sums."""
    feat, starts, ends = _deep_tiles(sem_dim, cuda)
    before = cuda_blend.blend_fwd.launches
    got = cuda_blend.blend_fwd(feat, starts, ends, 3)
    torch.cuda.synchronize()
    assert cuda_blend.blend_fwd.launches == before + 1
    want = cuda_blend.blend_fwd_plain(feat, starts, ends, 3)
    n = 4 + sem_dim + 1
    torch.testing.assert_close(got[..., :n], want[..., :n], rtol=5e-5,
                               atol=5e-5)
    assert torch.equal(got[..., n:], want[..., n:])
    walked = got[..., -2]
    depth = (ends - starts).float()[:, None].expand_as(walked)
    stopped = walked[walked < depth]
    assert len(set(((stopped - 1) // 256).tolist())) >= 2


def _aug(num_tiles, s_img, seed, device, outside=0):
    gen = torch.Generator(device=device).manual_seed(seed)
    aug = torch.randn((num_tiles, 256, s_img + 1), generator=gen,
                      device=device)
    aug[..., -1] = 1.0
    if outside:
        aug[-outside:] = 0.0    # tiles outside the image lift nothing
    return aug


@pytest.mark.parametrize("sem_dim", cuda_blend.SEM_DIMS)
def test_trace_kernel_deep_tiles(cuda, sem_dim):
    feat, starts, ends = _deep_tiles(sem_dim, cuda)
    aug = _aug(6, 10, sem_dim, cuda)
    raw, rows = cuda_trace.trace_fwd(feat, starts, ends, aug, 3)
    torch.cuda.synchronize()
    want_raw, want_rows = cuda_trace.trace_fwd_plain(feat, starts, ends,
                                                     aug, 3)
    n = 4 + sem_dim + 1
    torch.testing.assert_close(raw[..., :n], want_raw[..., :n], rtol=5e-5,
                               atol=5e-5)
    assert torch.equal(raw[..., n:], want_raw[..., n:])
    assert torch.equal(rows[:, -1], want_rows[:, -1])
    torch.testing.assert_close(rows, want_rows, rtol=1e-4, atol=1e-4)
    assert torch.equal(raw, cuda_blend.blend_fwd(feat, starts, ends, 3))


@pytest.mark.parametrize("sem_dim", cuda_blend.SEM_DIMS)
def test_blend_fwd_raw_bit_identical_to_trace_raw(cuda, sem_dim):
    """The two kernels share csrc/walk.cuh: the trace's embedded render
    is the forward's, bit for bit, at every semantic width."""
    feat, b = _packed(sem_dim, cuda)
    raw = cuda_blend.blend_fwd(feat, b.tile_start, b.tile_end, 10)
    for s_img in (0, 10, 31):
        traced, _ = cuda_trace.trace_fwd(feat, b.tile_start, b.tile_end,
                                         _aug(80, s_img, s_img, cuda), 10)
        assert torch.equal(raw, traced), s_img


@pytest.mark.parametrize("deep", [False, True])
def test_trace_kernel_writes_every_row(cuda, deep):
    """Rows are allocated uninitialised: the tail past the last tile's
    range and the instances no pixel hits (past a pixel's stop, culled,
    or with alpha <= 0.005 everywhere) come back as zeros."""
    if deep:
        feat, starts, ends = _deep_tiles(10, cuda)
        grid_x, num_tiles = 3, 6
    else:
        feat, b = _packed(10, cuda)
        starts, ends, grid_x, num_tiles = b.tile_start, b.tile_end, 10, 80
    aug = _aug(num_tiles, 10, 3, cuda, outside=num_tiles // 8)
    # the allocator hands the wrapper's torch.empty this NaN-filled block
    junk = torch.full((feat.shape[1], 11), float("nan"), device=cuda)
    del junk
    _, rows = cuda_trace.trace_fwd(feat, starts, ends, aug, grid_x)
    _, again = cuda_trace.trace_fwd(feat, starts, ends, aug, grid_x)
    torch.cuda.synchronize()
    assert torch.equal(rows, again)
    _, want = cuda_trace.trace_fwd_plain(feat, starts, ends, aug, grid_x)
    kept = int(ends[-1])
    assert kept < feat.shape[1] and not rows[kept:].any()
    zero = want[:, -1] == 0
    assert bool(zero[:kept].any()) and not rows[zero].any()
    assert bool((rows[:kept, -1] > 0).any())


def _adversarial_tiles(case, sem_dim, device, groups=10):
    """Packed instances of a 2 x 2g grid of tiles from the adversarial
    splats of tests/test_torch_block_cull.py (over its 32x32 region, 2 x 2
    tiles): group k's share of them, moved down by 32k pixels, fills the
    ranges of its four tiles in splat order. For "nan_fields", one splat
    in 37 of "thin_rotated" takes a splat with a NaN field, so that pixels
    walk past several. Returns the features, the same with each NaN splat
    replaced by its stand-in (a zero conic at opacity 1: alpha 0.99 at
    every pixel, which the kernels give a NaN power or opacity; the plain
    versions skip a NaN pair), starts and ends."""
    rng = np.random.default_rng(ADVERSARIAL.index(case))
    if case == "nan_fields":
        mean, conic, opa = _adversarial("thin_rotated", rng)
        nan = _adversarial("nan_fields", rng)
        sel = torch.arange(len(opa)) % 37 == 36
        for a, b in zip((mean, conic, opa), nan):
            a[sel] = b[sel]
    else:
        mean, conic, opa = _adversarial(case, rng)
    per = len(opa) // groups
    n = per * groups
    fields = torch.cat([mean, conic, opa[:, None]], 1)[:n]
    fields[:, 1] += REGION * (torch.arange(n) // per)
    finite = fields.clone()
    finite[~torch.isfinite(fields).all(1)] = torch.tensor(
        [0.0, 0.0, 0.0, 0.0, 0.0, 1.0])
    rest = torch.as_tensor(rng.normal(0, 1, (n, 4 + sem_dim)).astype(
        np.float32))
    tiles = 4 * groups
    cols = ((torch.arange(tiles) // 4 * per)[:, None]
            + torch.arange(per)).reshape(-1)
    starts = torch.arange(tiles, dtype=torch.int32) * per
    return (torch.cat([fields, rest], 1)[cols].T.contiguous().to(device),
            torch.cat([finite, rest], 1)[cols].T.contiguous().to(device),
            starts.to(device), (starts + per).to(device))


@pytest.mark.parametrize("case", ADVERSARIAL)
def test_blend_kernels_on_adversarial_splats(cuda, case):
    """The device cull (csrc/walk.cuh) on the splats its plain twin is
    held to on the CPU: it drops no pair that the walk would blend, so
    the forward's and the trace's walked, blended and hit counts equal
    the plain trace's (transmittance multiplied in the kernels' order)
    exactly, and the undecidable splats are kept."""
    feat, finite, starts, ends = _adversarial_tiles(case, 10, cuda)
    aug = _aug(starts.numel(), 10, 7, cuda)
    raw = cuda_blend.blend_fwd(feat, starts, ends, 2)
    traced, rows = cuda_trace.trace_fwd(feat, starts, ends, aug, 2)
    torch.cuda.synchronize()
    assert torch.equal(raw, traced)
    if case == "nan_fields":
        # each NaN splat blends as its stand-in, which the cull keeps
        again, again_rows = cuda_trace.trace_fwd(finite, starts, ends, aug, 2)
        assert torch.equal(raw, again) and torch.equal(rows, again_rows)
    want_raw, want_rows = cuda_trace.trace_fwd_plain(finite, starts, ends,
                                                     aug, 2)
    n = 4 + 10 + 1
    assert torch.equal(raw[..., n:], want_raw[..., n:])
    assert torch.equal(rows[:, -1], want_rows[:, -1])
    torch.testing.assert_close(raw[..., :n], want_raw[..., :n], rtol=5e-5,
                               atol=5e-5)
    torch.testing.assert_close(rows, want_rows, rtol=1e-4, atol=1e-4)
    assert bool((raw[..., -1] > 0).any())


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


def _rgb_grads(scene, cam, gt, cfg):
    """The gradients of an RGB step's loss (7 attributes and mean2d)."""
    from goi_tpu_torch.train.rgb import create_rgb_trainer, rgb_loss
    init_fn, _, _ = create_rgb_trainer(OptimConfig(), cfg)
    state = init_fn(scene)
    offset = torch.zeros((scene.capacity, 2), device=scene.device,
                         requires_grad=True)
    loss, _ = rgb_loss(state.scene, cam, gt, torch.zeros(3, device=cam
                       .full_proj.device), cfg, 0.2, mean2d_offset=offset)
    loss.backward()
    assert torch.isfinite(loss)
    return [p.grad for p in state.scene.params().values()] + [offset.grad]


def test_rgb_step_grads_on_card_bit_identical(cuda):
    """An RGB step (L1 + SSIM through every attribute and mean2d) at a
    100k-Gaussian scene: the same bits over two backward passes and with
    the fused reduce."""
    from goi_tpu_torch.raster.render import suggest_budgets
    scene = _scene(100_000, 10, 11, cuda)
    cam = _cam(cuda, 640, 480)
    with torch.no_grad():
        gt = render(_scene(100_000, 10, 12, cuda), cam,
                    torch.zeros(3, device=cuda),
                    RasterConfig(max_instances=1 << 21))["render"]
    cfg = RasterConfig(max_instances=max(
        suggest_budgets(scene, cam, margin=1.2)[0], 1 << 19))
    first = _rgb_grads(scene, cam, gt, cfg)
    second = _rgb_grads(scene, cam, gt, cfg)
    dense = _rgb_grads(scene, cam, gt, RasterConfig(
        max_instances=cfg.max_instances, dense_reduce=True))
    for i, (a, b, c) in enumerate(zip(first, second, dense)):
        assert torch.equal(a, b), i
        assert torch.equal(a, c), i
    assert any(bool(g.any()) for g in first)


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


def _count_reference(feat, starts, ends, grid_x):
    """Walked and blended counts of the plain trace (its transmittance
    multiplied one instance at a time, in the kernels' order)."""
    raw, _ = cuda_trace.trace_fwd_plain(
        feat, starts, ends,
        torch.ones((starts.numel(), 256, 1), device=feat.device), grid_x)
    return raw[..., -2:]


@pytest.mark.parametrize("sem_dim", [1, 12, 33])
def test_kernels_at_widths_between_instances(cuda, sem_dim):
    """Widths the kernels are not built for run padded to the next
    instance: each kernel against its plain version at the usual
    tolerances, the counts exactly, the trace's raw output bit-identical
    to the forward's."""
    assert sem_dim not in cuda_blend.SEM_DIMS
    feat, b = _packed(sem_dim, cuda)
    st, en = b.tile_start, b.tile_end
    raw = cuda_blend.blend_fwd(feat, st, en, 10)
    torch.cuda.synchronize()
    assert raw.shape[-1] == sem_dim + 7
    want = cuda_blend.blend_fwd_plain(feat, st, en, 10)
    n = 4 + sem_dim + 1
    torch.testing.assert_close(raw[..., :n], want[..., :n], rtol=5e-5,
                               atol=5e-5)
    assert torch.equal(raw[..., n:], _count_reference(feat, st, en, 10))
    gen = torch.Generator(device=cuda).manual_seed(sem_dim)
    grad = torch.randn(raw.shape, generator=gen, device=cuda)
    rows = cuda_blend.blend_bwd(feat, st, en, raw, grad, 10)
    torch.cuda.synchronize()
    assert rows.shape == (feat.shape[1], 10 + sem_dim)
    _close_to_peak(rows, cuda_blend.blend_bwd_plain(feat, st, en, raw, grad,
                                                    10), f"S={sem_dim}")
    aug = _aug(80, 10, sem_dim, cuda, outside=10)
    traw, trows = cuda_trace.trace_fwd(feat, st, en, aug, 10)
    torch.cuda.synchronize()
    assert torch.equal(traw, raw)
    _, want_rows = cuda_trace.trace_fwd_plain(feat, st, en, aug, 10)
    assert torch.equal(trows[:, -1], want_rows[:, -1])
    torch.testing.assert_close(trows, want_rows, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("width", [16, 32, 64])
def test_padded_width_is_bit_identical_to_the_native_one(cuda, width):
    """S = 10 padded with zero semantic rows to a wider instance
    (pad_feat, pad_raw) and sliced back (unpad_raw, unpad_rows) gives the
    native instance's bits in all three kernels, counts included: the
    padded channels add exact zeros, and each field's sum keeps its
    order. A width between instances takes the same path inside the
    wrappers."""
    feat, b = _packed(10, cuda)
    st, en = b.tile_start, b.tile_end
    raw = cuda_blend.blend_fwd(feat, st, en, 10)
    gen = torch.Generator(device=cuda).manual_seed(width)
    grad = torch.randn(raw.shape, generator=gen, device=cuda)
    rows = cuda_blend.blend_bwd(feat, st, en, raw, grad, 10)
    aug = _aug(80, 10, width, cuda)
    traw, trows = cuda_trace.trace_fwd(feat, st, en, aug, 10)
    wide = cuda_blend.pad_feat(feat, width)
    assert wide.shape[0] == 10 + width
    assert torch.equal(cuda_blend.unpad_raw(
        cuda_blend.blend_fwd(wide, st, en, 10), 10, width), raw)
    assert torch.equal(cuda_blend.unpad_rows(cuda_blend.blend_bwd(
        wide, st, en, cuda_blend.pad_raw(raw, 10, width),
        cuda_blend.pad_raw(grad, 10, width), 10), 10, width), rows)
    got_raw, got_rows = cuda_trace.trace_fwd(wide, st, en, aug, 10)
    got_raw = cuda_blend.unpad_raw(got_raw, 10, width)
    torch.cuda.synchronize()
    assert torch.equal(got_raw, traw) and torch.equal(got_rows, trows)
    assert rows.abs().sum() > 0 and trows[:, -1].sum() > 0


@pytest.mark.parametrize("sem_dim,s_img", [(10, 32), (10, 64), (64, 126),
                                           (3, 126)])
def test_trace_kernel_lifts_wide_maps(cuda, sem_dim, s_img):
    """Lift widths past one warp's 32 lanes (sa = 33, 65, 127 = SA_MAX),
    summed in groups of 32 fields: rows against the plain version, hit
    counts exactly; at S = 64, sa = 127 the CTA holds the widest tile."""
    feat, b = _packed(sem_dim, cuda)
    st, en = b.tile_start, b.tile_end
    aug = _aug(80, s_img, s_img, cuda, outside=10)
    raw, rows = cuda_trace.trace_fwd(feat, st, en, aug, 10)
    torch.cuda.synchronize()
    assert rows.shape == (feat.shape[1], s_img + 1)
    want_raw, want_rows = cuda_trace.trace_fwd_plain(feat, st, en, aug, 10)
    n = 4 + sem_dim + 1
    assert torch.equal(raw[..., n:], want_raw[..., n:])
    assert torch.equal(rows[:, -1], want_rows[:, -1])
    torch.testing.assert_close(rows, want_rows, rtol=1e-4, atol=1e-4)
    assert torch.equal(raw, cuda_blend.blend_fwd(feat, st, en, 10))
    kept = int(en[-1])
    assert not rows[kept:].any() and rows[:kept, -1].sum() > 0


def test_kernels_raise_past_their_bounds(cuda):
    """SA_MAX + 1 lifted fields raise ValueError naming the bound and the
    reference backend; S_MAX + 1 semantic channels no longer raise (they
    run in channel groups: test_wide_semantics_run_in_channel_groups)."""
    feat, b = _packed(cuda_blend.S_MAX, cuda)
    st, en = b.tile_start, b.tile_end
    with pytest.raises(ValueError, match="SA_MAX.*reference"):
        cuda_trace.trace_fwd(feat, st, en, _aug(80, cuda_trace.SA_MAX, 0,
                                                cuda), 10)


@pytest.mark.parametrize("sem_dim", [65, 117, 128])
def test_wide_semantics_run_in_channel_groups(cuda, sem_dim):
    """Past S_MAX the three kernels run in groups of S_MAX channels, one
    launch a group: each against its plain version at the usual
    tolerances, the counts exactly, each forward group bit-identical to a
    lone run of its channels on the S_MAX instance, and the trace's raw
    output bit-identical to the forward's."""
    groups = cuda_blend._channel_groups(sem_dim, cuda_blend.S_MAX)
    assert len(groups) == 2
    feat, b = _packed(sem_dim, cuda)
    st, en = b.tile_start, b.tile_end
    before = cuda_blend.blend_fwd.launches
    raw = cuda_blend.blend_fwd(feat, st, en, 10)
    torch.cuda.synchronize()
    assert cuda_blend.blend_fwd.launches == before + len(groups)
    assert raw.shape[-1] == sem_dim + 7
    want = cuda_blend.blend_fwd_plain(feat, st, en, 10)
    n = 4 + sem_dim + 1
    torch.testing.assert_close(raw[..., :n], want[..., :n], rtol=5e-5,
                               atol=5e-5)
    assert torch.equal(raw[..., n:], _count_reference(feat, st, en, 10))
    for lo, hi in groups:
        lone = cuda_blend.blend_fwd(cuda_blend.pad_feat(
            cuda_blend._group_rows(feat, sem_dim, lo, hi), cuda_blend.S_MAX),
            st, en, 10)
        assert torch.equal(lone[..., 3:3 + hi - lo], raw[..., 3 + lo:3 + hi])
    gen = torch.Generator(device=cuda).manual_seed(sem_dim)
    grad = torch.randn(raw.shape, generator=gen, device=cuda)
    before = cuda_blend.blend_bwd.launches
    rows = cuda_blend.blend_bwd(feat, st, en, raw, grad, 10)
    torch.cuda.synchronize()
    assert cuda_blend.blend_bwd.launches == before + len(groups)
    assert rows.shape == (feat.shape[1], 10 + sem_dim)
    _close_to_peak(rows, cuda_blend.blend_bwd_plain(feat, st, en, raw, grad,
                                                    10), f"S={sem_dim}")
    aug = _aug(80, 10, sem_dim, cuda, outside=10)
    traw, trows = cuda_trace.trace_fwd(feat, st, en, aug, 10)
    torch.cuda.synchronize()
    assert torch.equal(traw, raw)
    _, want_rows = cuda_trace.trace_fwd_plain(feat, st, en, aug, 10)
    assert torch.equal(trows[:, -1], want_rows[:, -1])
    torch.testing.assert_close(trows, want_rows, rtol=1e-4, atol=1e-4)


def _edge_bounds(case, m, blk, gen, device):
    """(n,) int64 non-decreasing bounds in [0, m] of one edge case."""
    if case == "repeated":    # the chain's clamp under an overflow
        sizes = torch.randint(0, 9, (m // 3,), generator=gen, device=device)
        b = torch.clamp(torch.cat([torch.zeros(1, dtype=torch.long,
                                               device=device),
                                   torch.cumsum(sizes, 0)]), max=m - 1)
        return torch.cat([b, torch.full((4,), m, device=device)])
    if case == "one_block":
        b = torch.randint(2 * blk, 3 * blk, (300,), generator=gen,
                          device=device)
        return torch.sort(b).values
    # empty blocks: bounds only in the first and the last block
    b = torch.cat([torch.randint(0, blk, (200,), generator=gen,
                                 device=device),
                   torch.randint(m - blk, m + 1, (200,), generator=gen,
                                 device=device)])
    return torch.sort(b).values


@pytest.mark.parametrize("case", ["repeated", "one_block", "empty_blocks"])
@pytest.mark.parametrize("blk", [96, 128, 256, 512])
@pytest.mark.parametrize("d", [1, 11, 20, 33])
def test_prefix_boundary_edge_cases_bit_identical(cuda, d, blk, case):
    """The redesigned kernel's lb and totals against the prefix kernel's
    inner[p] and totals, bit for bit: its first-bound table, its
    register and its warp-per-bound read-outs (blocks of more than 256
    bounds) at every block size (96 rows: the instance whose run is not
    a compile-time constant)."""
    nb = 6
    m = nb * blk
    gen = torch.Generator(device=cuda).manual_seed(d * blk + len(case))
    rows = torch.randn((m, d), generator=gen, device=cuda) * 10
    p = _edge_bounds(case, m, blk, gen, cuda)
    inner, tot = R.prefix_blocks(rows, None, blk)
    before = R.prefix_boundary.launches
    lb, t2 = R.prefix_boundary(rows, p, blk)
    torch.cuda.synchronize()
    assert R.prefix_boundary.launches == before + 1
    assert torch.equal(lb, inner[p]) and torch.equal(t2, tot)


def test_prefix_boundary_wide_rows_in_column_slices(cuda):
    """Rows too wide for one CTA's shared memory (d = 127 at blk = 512,
    a 126-channel trace's) are scanned in column slices, bit-identical
    to the prefix kernel's (sliced the same way)."""
    gen = torch.Generator(device=cuda).manual_seed(127)
    m = 4 * 512
    rows = torch.randn((m, 127), generator=gen, device=cuda)
    p = _edge_bounds("repeated", m, 512, gen, cuda)
    before = (R.prefix_boundary.launches, R.prefix_blocks.launches)
    lb, tot = R.prefix_boundary(rows, p)
    inner, tot_u = R.prefix_blocks(rows)
    torch.cuda.synchronize()
    assert R.prefix_boundary.launches == before[0] + 2
    assert R.prefix_blocks.launches == before[1] + 2
    assert torch.equal(lb, inner[p]) and torch.equal(tot, tot_u)
    want, want_tot = R.prefix_blocks_plain(rows, None, 512)
    scale = float(want.abs().max())
    torch.testing.assert_close(inner, want, rtol=1e-4, atol=1e-5 * scale)


def _span_bounds(spans, blk, nb, rng, tail):
    """Bounds from a random start whose segments span the given numbers
    of whole blocks (0: within one block), then `tail`."""
    p = [int(rng.integers(0, blk))]
    for span in spans:
        q = p[-1] // blk + span
        lo = p[-1] if span == 0 else q * blk
        p.append(int(rng.integers(lo, (q + 1) * blk)))
    assert p[-1] < nb * blk
    return np.asarray(p + list(tail), np.int64)


@pytest.mark.parametrize("d", [1, 20, 117])
@pytest.mark.parametrize("case", ["spans", "repeated", "end", "long"])
def test_owner_sums_kernel_equals_plain(cuda, case, d):
    """The owner_sums kernel torch.equal to its plain version (the same
    serial sum in ascending block order) in both read-out forms: spans
    of 0-3 and 11 blocks, repeated bounds (the chain's clamp), bounds at
    the stream's end, and segments of 512-4096 rows at 128-row blocks."""
    rng = np.random.default_rng(d + len(case))
    blk = 128 if case == "long" else 32
    spans = rng.permutation(np.repeat([0, 1, 2, 3, 11], 40))
    if case == "long":
        spans = rng.integers(4, 33, 60)
    nb = int(spans.sum()) + 2
    m = nb * blk
    tail = {"repeated": [m - 1, m - 1, m, m], "end": [m, m]}.get(case, [])
    p = _span_bounds(spans, blk, nb, rng, tail)
    if case == "repeated":
        p = np.sort(np.concatenate([p, p[::3]]))
    gen = torch.Generator(device=cuda).manual_seed(d)
    rows = torch.randn((m, d), generator=gen, device=cuda) * 10
    inner, tot = R.prefix_blocks(rows, None, blk)
    p = torch.as_tensor(p, device=cuda)
    before = R.owner_sums.launches
    got = R.owner_sums(inner, p, tot, blk, indexed=True)
    fused = R.owner_sums(inner[p], p, tot, blk, indexed=False)
    torch.cuda.synchronize()
    assert R.owner_sums.launches == before + 2
    assert torch.equal(got, R.owner_sums_plain(inner, p, tot, blk, True))
    assert torch.equal(fused, got)
    want = R.blocked_segment_reduce(rows.cpu(), p.cpu())
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("n,m,c,blk,span", [
    (5000, 4001, 1, 8, 16),         # scalar copies, m % blk != 0
    (5000, 4001, 24, 8, 16),        # float4 copies, indices past windows
    (5000, 4003, 25, 16, 64),       # scalar copies, c % 4 != 0
    (1000, 3333, 24, 1024, 2048),   # n < span: the window starts below 0
    (100_000, 77_777, 24, 1024, 2048)])
def test_mono_rows_kernel_edge_cases_bit_exact(cuda, n, m, c, blk, span):
    gen = torch.Generator(device=cuda).manual_seed(n + c)
    table = torch.randn((n, c), generator=gen, device=cuda)
    idx = torch.sort(torch.randint(0, n, (m,), generator=gen, device=cuda,
                                   dtype=torch.int32)).values
    if span < n:    # an index past block 0's window
        idx[blk // 2] = min(int(idx[0]) + span, n - 1)
        idx = torch.cummax(idx, 0).values
    got = mono_rows(table, idx, blk, span)
    torch.cuda.synchronize()
    want = mono_rows_plain(table, idx, blk, span)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert bool((~want.any(dim=1)).any()) == (span < n)


@pytest.mark.parametrize("n,eps,min_samples", [(20_000, 0.2, 12),
                                               (3000, 0.35, 1)])
def test_dbscan_on_card_equals_plain(cuda, n, eps, min_samples,
                                    monkeypatch):
    """The device DBSCAN's labels equal to its plain twin's (sklearn's,
    tests/test_torch_dbscan.py), blobs with noise and shared borders;
    chunked candidate pairs too."""
    from goi_tpu_torch.app import dbscan as dbscan_mod
    from goi_tpu_torch.app.dbscan import dbscan, dbscan_plain
    rng = np.random.default_rng(n)
    centers = rng.uniform(-2, 2, (8, 3))
    pts = np.concatenate([c + rng.normal(0, 0.3, (n // 10, 3))
                          for c in centers]
                         + [rng.uniform(-3, 3, (n - 8 * (n // 10), 3))])
    pts = torch.as_tensor(pts.astype(np.float32), device=cuda)
    want = dbscan_plain(pts, eps, min_samples)
    assert want.device == pts.device
    for budget in (1 << 25, 1 << 16):
        monkeypatch.setattr(dbscan_mod, "PAIR_BUDGET", budget)
        got = dbscan(pts, eps, min_samples)
        assert got.device == pts.device and torch.equal(got, want)
    assert int(want.max()) >= 1


def test_group_points_and_render_batch_on_card_match_cpu(cuda):
    from goi_tpu_torch.app.session import QuerySession
    from goi_tpu_torch.raster.render import render_batch
    scene = _scene(3000, 10, 5, "cpu")
    sems = torch.zeros(3000, 10)
    sems[:1500, 1] = 3.0
    sems[1500:, 5] = 3.0
    scene = scene.replace(semantics=sems)
    lut = torch.as_tensor(np.random.default_rng(1).normal(
        0, 1, (10, 64)).astype(np.float32))
    decoder = SemanticDecoder([torch.eye(10) * 4.0], [torch.zeros(10)])
    cfg = RasterConfig(max_instances=1 << 16)
    masks, keeps = [], []
    for dev in ("cpu", cuda):
        sess = QuerySession(scene, decoder, lut, cfg, device=dev)
        sess.set_text(lut[1] / torch.linalg.norm(lut[1]) * 10.0)
        sess.retrieve()
        cam = _cam(dev)
        with torch.no_grad():
            out = render(sess.scene, cam, sess.bg, cfg)
        sim = sess.compute_similarity(out["semantics"].reshape(10, -1).T)
        masks.append((sim > 0).reshape(cam.height, cam.width).cpu().numpy())
        keeps.append(sess.group_points(cam, masks[0], eps=0.3,
                                       min_samples=8, ratio_thresh=0.4))
    assert keeps[0].any()
    np.testing.assert_array_equal(keeps[1], keeps[0])
    cams = [Camera.look_at([0.5 * k, 0.4, -4.0], [0, 0, 0], [0, 1, 0], 0.9,
                           0.7, 160, 120, device=cuda) for k in range(3)]
    card = render_batch(scene.to(cuda), cams, torch.zeros(3, device=cuda),
                        cfg)
    cpu = render_batch(scene, [c.to("cpu") for c in cams], torch.zeros(3),
                       cfg)
    for k in ("render", "semantics", "depth", "alpha"):
        assert card[k].shape[0] == 3
        torch.testing.assert_close(card[k].cpu(), cpu[k], rtol=5e-5,
                                   atol=5e-5)
    for i, cam in enumerate(cams):
        single = render(scene.to(cuda), cam, torch.zeros(3, device=cuda), cfg)
        assert torch.equal(card["render"][i], single["render"])


def _packed_mixture(n, seed, device):
    """(n, 12) packed Gaussians of a seeded anisotropic scene."""
    from goi_tpu_torch.export.mesh import pack_gaussians
    rng = np.random.default_rng(seed)
    s = GaussianScene.create(
        rng.normal(0, 0.5, (max(n, 1), 3)).astype(np.float32), sh_degree=0,
        sem_dim=0, scales=rng.uniform(0.03, 0.2, max(n, 1)).astype(
            np.float32), device=device)
    s = s.replace(
        scaling=torch.as_tensor(np.log(rng.uniform(
            0.02, 0.25, (max(n, 1), 3))).astype(np.float32), device=device),
        rotation=torch.as_tensor(rng.normal(0, 1, (max(n, 1), 4)).astype(
            np.float32), device=device),
        opacity=torch.as_tensor(rng.uniform(-2, 3, (max(n, 1), 1)).astype(
            np.float32), device=device))
    return pack_gaussians(s)[:n].contiguous()


@pytest.mark.parametrize("n,r", [(1, 1), (0, 9), (127, 7), (129, 16),
                                 (1001, 33), (3000, 20)])
def test_density_grid_kernel_matches_plain(cuda, n, r):
    """csrc/density_grid.cu against density_grid_plain on the card within
    1e-5 of the grid's peak (sums in another order, ex2.approx against
    exp2): odd N, N not a multiple of the 128-Gaussian tile, an empty
    scene, R = 1 and R not a multiple of the 8 points a thread owns; the
    same bits on a second launch."""
    from goi_tpu_torch.export.mesh import density_grid_plain, mixture_grid
    packed = _packed_mixture(n, n + r, cuda)
    axes = torch.linspace(-1.2, 1.1, r, device=cuda)
    before = mixture_grid.launches
    got = mixture_grid(packed, axes)
    again = mixture_grid(packed, axes)
    torch.cuda.synchronize()
    assert mixture_grid.launches == before + 2
    want = density_grid_plain(packed, axes)
    assert got.shape == (r, r, r) and got.dtype == torch.float32
    assert torch.equal(got, again)
    if n == 0:
        assert not got.any()
        return
    peak = float(want.max())
    assert peak > 0
    assert float((got - want).abs().max()) <= 1e-5 * peak


def test_density_grid_kernel_at_a_gaussian_centre(cuda):
    """A grid point on a Gaussian's centre takes its whole weight, and a
    CUDA scene's density_grid launches the kernel."""
    from goi_tpu_torch.export.mesh import (density_grid, grid_axes,
                                           mixture_grid, pack_gaussians)
    axes = torch.as_tensor(grid_axes(-1.0, 1.0, 12), device=cuda)
    packed = _packed_mixture(200, 3, cuda)
    packed[17, :3] = axes[torch.tensor([4, 9, 2], device=cuda)]
    packed[17, 3] = 0.75
    got = mixture_grid(packed, axes)
    torch.cuda.synchronize()
    alone = mixture_grid(packed[17:18].contiguous(), axes)
    assert float(alone[4, 9, 2]) == 0.75
    assert float(got[4, 9, 2]) >= 0.75
    scene = _scene(500, 3, 4, cuda)
    before = mixture_grid.launches
    grid, origin, voxel = density_grid(scene, resolution=24, chunk=5)
    assert mixture_grid.launches == before + 1
    lo = float(origin[0])
    want = mixture_grid(pack_gaussians(scene), torch.as_tensor(
        grid_axes(lo, lo + voxel * 24, 24), device=cuda))
    np.testing.assert_array_equal(grid, want.cpu().numpy())


def test_marching_tetrahedra_on_card_equals_cpu(cuda):
    """The same vertices and faces from a grid on the card as from it on
    the CPU."""
    from goi_tpu_torch.export.marching import marching_tetrahedra
    rng = np.random.default_rng(0)
    g = rng.normal(0, 1, (17, 18, 19)).astype(np.float32)
    ax = np.linspace(-1, 1, 24)
    x, y, z = np.meshgrid(ax, ax, ax, indexing="ij")
    sphere = (1 - np.sqrt(x * x + y * y + z * z) / 0.7).astype(np.float32)
    for grid, iso in ((g, 0.2), (sphere, 0.0)):
        cpu = marching_tetrahedra(grid, iso, origin=(-1, 0.5, 2), voxel=0.1)
        card = marching_tetrahedra(torch.as_tensor(grid, device=cuda), iso,
                                   origin=(-1, 0.5, 2), voxel=0.1)
        assert len(cpu.faces) > 100
        np.testing.assert_array_equal(card.vertices, cpu.vertices)
        np.testing.assert_array_equal(card.faces, cpu.faces)


def test_edit_step_on_card_matches_cpu(cuda, monkeypatch):
    """One EditSession step on the card against the CPU: a tiny SD backend
    (tests/test_sd_backend.py's TINY widths, seeded weights), a
    3000-Gaussian scene, two 160x120 views at batch 2, the same noise. The
    loss within rtol 1e-4 and every attribute's masked gradient within
    tests/test_torch_train.py's GRAD_TOL (rtol 2e-3, atol 2e-4 of the
    peak); float32 with TF32 off on both."""
    from goi_tpu_torch.app.edit import EditSession
    from goi_tpu_torch.guidance import InpaintSDS, samplers
    from goi_tpu_torch.guidance.sd_torch import (AutoencoderKL, SDConfig,
                                                 TorchDiffusionBackend,
                                                 UNet2DCondition, init_sd_)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg = SDConfig(block_out_channels=(32, 64), layers_per_block=1,
                   attention_head_dim=2, cross_attention_dim=24,
                   norm_groups=8, vae_block_out_channels=(16, 32),
                   vae_layers_per_block=1, num_train_timesteps=50)
    g = torch.Generator().manual_seed(0)
    unet = init_sd_(UNet2DCondition(cfg, device="cpu"), g)
    vae = init_sd_(AutoencoderKL(cfg, device="cpu"), g)
    pos, neg = torch.randn(7, 24, generator=g), torch.randn(7, 24, generator=g)
    noise = torch.randn(2, 4, 32, 32, generator=g)
    monkeypatch.setattr(samplers, "_draw_noise",
                        lambda gen, shape, device: noise.to(device))
    aniso = np.log(np.random.default_rng(8).uniform(
        0.01, 0.05, (3000, 3))).astype(np.float32)
    masks = torch.zeros(2, 1, 120, 160)
    masks[:, :, 20:100, 30:140] = 1.0
    runs = {}
    for dev in ("cpu", cuda):
        u = UNet2DCondition(cfg, device=dev)
        u.load_state_dict(unet.state_dict())
        v = AutoencoderKL(cfg, device=dev)
        v.load_state_dict(vae.state_dict())
        sds = InpaintSDS(TorchDiffusionBackend(u, v, cfg), pos.to(dev),
                         neg.to(dev), latent_size=32, img_size=64)
        # per-axis scales, so that the rotation has a gradient
        scene = _scene(3000, 10, 7, dev).replace(scaling=torch.as_tensor(
            aniso, device=dev))
        edit = EditSession(scene, sds, RasterConfig(max_instances=1 << 16),
                           batch_size=2)
        edit.grad_mask = (torch.arange(3000, device=dev) % 3 == 0).float()
        params = edit._leaves()
        edit._rebind(params)
        cams = [_cam(dev), Camera.look_at([-1.0, 0.6, -3.8], [0, 0, 0],
                                          [0, 1, 0], 0.9, 0.7, 160, 120,
                                          device=dev)]
        loss = edit.step(params, cams, masks.to(dev),
                         torch.Generator(device=dev), 0.3)
        if dev != "cpu":
            torch.cuda.synchronize()
        runs[str(dev)] = (float(loss), {k: p.grad.cpu()
                                        for k, p in params.items()})
    (lc, gc), (lg, gg) = runs["cpu"], runs["cuda"]
    assert np.isfinite(lc) and lc > 0
    assert abs(lg - lc) <= 1e-4 * abs(lc)
    for k, want in gc.items():
        got = gg[k]
        assert not got[1::3].any() and not got[2::3].any(), k
        peak = float(want.abs().max())
        if k != "semantics":
            assert peak > 0, k
        assert torch.allclose(got, want, rtol=2e-3, atol=2e-4 * peak), k
