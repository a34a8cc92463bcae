"""Semantic widths outside the CUDA kernels' instances, and the plain
helpers behind them, on the CPU: render and a train step's gradients at
sem_dim = 12 against goi_tpu (backend='pallas', interpret mode) at
tests/test_pallas_blend.py's tolerances (5e-5 on images, 2e-3 / 2e-4 on
gradients); the pad/unpad of raster/cuda_blend.py held to the plain
blend and trace (a padded width sliced back equals the unpadded one,
bit for bit, and the plain backward within its matmul's rounding);
kernel_width's choice and its bound; the first-bound
table of raster/reduce.py against torch.searchsorted; the column slices
of the block scans."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from goi_tpu.raster import RasterConfig as JConfig
from goi_tpu.raster import render as jrender
from goi_tpu.semantic.codebook import SemanticDecoder as JDecoder
from goi_tpu.semantic.losses import distillation_loss as j_loss
from goi_tpu.train.distill import create_distill_state as j_create
from goi_tpu.train.optim import OptimConfig as JOptim
from goi_tpu_torch.raster import cuda_blend as CB
from goi_tpu_torch.raster import cuda_trace as CT
from goi_tpu_torch.raster import reduce as R
from goi_tpu_torch.raster.binning import bin_splats_chunked
from goi_tpu_torch.raster.preprocess import preprocess
from goi_tpu_torch.raster.render import RasterConfig, image_to_tiles, render
from goi_tpu_torch.train.distill import create_distill_state, distill_loss
from goi_tpu_torch.train.optim import OptimConfig
from tests.conftest import make_random_scene, make_test_camera
from tests.test_torch_core import to_torch_camera, to_torch_scene
from tests.test_torch_train import ALL_ON, GRAD_TOL, TERMS, _decoder_to_torch

torch.set_num_threads(1)

TOL = dict(rtol=5e-5, atol=5e-5)
S_ODD = 12       # a width between the kernels' instances 10 and 16
# shared memory a CTA may opt in to on the H100 (227 KB): the limit the
# block scans' column slices meet there
H100_SMEM_OPTIN = 232_448


def test_render_at_sem_dim_12_matches_pallas():
    js = make_random_scene(n=300, seed=4, sem_dim=S_ODD)
    jc = make_test_camera(width=64, height=48, angle=0.4)
    bg = np.array([0.2, 0.4, 0.6], np.float32)
    want = jrender(js, jc, jnp.asarray(bg),
                   JConfig(max_instances=1 << 14, backend="pallas"))
    got = render(to_torch_scene(js), to_torch_camera(jc),
                 torch.as_tensor(bg), RasterConfig(max_instances=1 << 14))
    assert got["semantics"].shape == (S_ODD, 48, 64)
    for k in ("render", "semantics", "depth", "alpha"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   err_msg=k, **TOL)


def test_train_step_grads_at_sem_dim_12_match_goi_tpu():
    """test_torch_train.py's step-1 check (loss terms at rtol 1e-5,
    every trained tensor's gradient at 2e-3 / 2e-4) at sem_dim = 12."""
    js = make_random_scene(n=200, seed=11, sem_dim=S_ODD)
    jc = make_test_camera(width=32, height=32)
    key = jax.random.PRNGKey(1)
    gt = np.array(jax.random.normal(key, (16, 32, 32)))
    jdec = JDecoder.create(key, dim_in=S_ODD, dim_out=8)
    lut = np.array(jax.random.normal(key, (8, 16))) * 0.1
    jstate, _ = j_create(js, jdec, jnp.asarray(lut), JOptim(**ALL_ON))
    tstate, _ = create_distill_state(
        to_torch_scene(js), _decoder_to_torch(jdec), torch.as_tensor(lut),
        OptimConfig(**ALL_ON))
    bg = np.zeros(3, np.float32)
    jcfg = JConfig(max_instances=1 << 13, backend="pallas")

    def jloss(params, dec, lut):
        out = jrender(js.with_params(params), jc, jnp.asarray(bg), jcfg)
        s, h, w = out["semantics"].shape
        return j_loss(dec, lut, out["semantics"].reshape(s, h * w).T,
                      jnp.asarray(gt).reshape(16, -1).T, 1.0)

    (_, jaux), (g_scene, g_dec, g_lut) = jax.value_and_grad(
        jloss, argnums=(0, 1, 2), has_aux=True)(
        js.params(), jstate.decoder, jstate.lut)
    loss, taux = distill_loss(tstate, to_torch_camera(jc),
                              torch.as_tensor(gt), torch.as_tensor(bg),
                              RasterConfig(max_instances=1 << 13))
    loss.backward()
    for k in TERMS:
        np.testing.assert_allclose(float(taux[k].detach()), float(jaux[k]),
                                   rtol=1e-5, err_msg=k)
    got = dict(tstate.scene.params(), dec_w=tstate.decoder.weights[0],
               lut=tstate.lut)
    want = dict(g_scene, dec_w=g_dec.weights[0], lut=g_lut)
    assert tuple(got["semantics"].shape[1:]) == (S_ODD,)
    for k in want:
        np.testing.assert_allclose(got[k].grad.numpy(), np.asarray(want[k]),
                                   err_msg=k, **GRAD_TOL)


def test_kernel_width_picks_an_instance_and_states_its_bound():
    """The narrowest instance that holds S; past S_MAX (the widest
    instance) no raise: the groups of S_MAX channels run on it."""
    assert CB.SEM_DIMS[-1] == CB.S_MAX >= 64
    assert [CB.kernel_width(s) for s in (0, 1, 3, 9, 10, 12, 16, 17, 33,
                                         64, 65, 117, 128, 1000)] == [
        0, 3, 3, 10, 10, 16, 16, 32, 64, 64, 64, 64, 64, 64]
    with pytest.raises(ValueError, match="sem_dim"):
        CB.kernel_width(-1)
    assert CB._channel_groups(0, CB.S_MAX) == [(0, 0)]
    assert CB._channel_groups(64, CB.S_MAX) == [(0, 64)]
    assert CB._channel_groups(65, CB.S_MAX) == [(0, 64), (64, 65)]
    assert CB._channel_groups(128, CB.S_MAX) == [(0, 64), (64, 128)]
    assert CB._channel_groups(8, 3) == [(0, 3), (3, 6), (6, 8)]


def _packed(sem_dim, n=400, w=48, h=32, seed=7):
    js = make_random_scene(n=n, seed=seed, sem_dim=sem_dim)
    sp = preprocess(to_torch_scene(js), to_torch_camera(
        make_test_camera(width=w, height=h)))
    gx, gy = (w + 15) // 16, (h + 15) // 16
    b = bin_splats_chunked(sp, grid_x=gx, grid_y=gy, max_instances=1 << 14,
                           chunk_k=CB.K)
    feat = CB.pack(sp.mean2d, sp.conic, sp.opacity, sp.color,
                   sp.semantics, sp.depth, b.point_list)
    return feat, b.tile_start, b.tile_end, gx


@pytest.mark.parametrize("sem_dim", [1, 12, 33])
def test_padding_to_the_next_instance_keeps_the_real_channels(sem_dim):
    """The plain forward and trace of a width padded with zero semantic
    rows, sliced back, equal the unpadded width's bit for bit (the
    backward within rounding): the padded channels are zero and the depth
    channel moves with them."""
    feat, st, en, gx = _packed(sem_dim)
    width = CB.kernel_width(sem_dim)
    assert width > sem_dim
    padded = CB.pad_feat(feat, width)
    assert padded.shape == (10 + width, feat.shape[1])
    assert torch.equal(padded[9 + width], feat[9 + sem_dim])   # depth
    assert not padded[9 + sem_dim:9 + width].any()

    raw = CB.blend_fwd_plain(feat, st, en, gx)
    raw_p = CB.blend_fwd_plain(padded, st, en, gx)
    assert not raw_p[..., 3 + sem_dim:3 + width].any()
    assert torch.equal(CB.unpad_raw(raw_p, sem_dim, width), raw)
    assert torch.equal(CB.pad_raw(raw, sem_dim, width), raw_p)

    grad = torch.as_tensor(np.random.default_rng(sem_dim).normal(
        0, 1, raw.shape).astype(np.float32))
    rows = CB.blend_bwd_plain(feat, st, en, raw, grad, gx)
    rows_p = CB.blend_bwd_plain(padded, st, en, raw_p,
                                CB.pad_raw(grad, sem_dim, width), gx)
    assert not rows_p[:, 9 + sem_dim:9 + width].any()
    # the plain backward sums f . g by a matmul whose blocking follows
    # the width, so its padded rows round otherwise: held at 1e-5 and 1e-6
    # of the rows' peak (the kernel, which sums in channel order, is held
    # bit for bit on the card: tests/test_torch_cuda.py)
    got = CB.unpad_rows(rows_p, sem_dim, width)
    err = (got - rows).abs()
    assert bool((err <= 1e-5 * rows.abs() + 1e-6 * rows.abs().max()).all())
    assert rows.abs().sum() > 0

    aug = image_to_tiles(torch.cat([
        torch.as_tensor(np.random.default_rng(1).normal(
            0, 1, (4, 32, 48)).astype(np.float32)),
        torch.ones(1, 32, 48)]), gx, st.numel() // gx)
    traw, trows = CT.trace_fwd_plain(feat, st, en, aug, gx)
    traw_p, trows_p = CT.trace_fwd_plain(padded, st, en, aug, gx)
    assert torch.equal(CB.unpad_raw(traw_p, sem_dim, width), traw)
    assert torch.equal(trows_p, trows)


@pytest.mark.parametrize("sem_dim,group", [(8, 3), (7, 7), (9, 4)])
def test_channel_groups_reassemble_one_wide_call(sem_dim, group):
    """The card's decomposition of a width past S_MAX, driven with the
    plain versions and small groups: the forward in groups is the one
    wide call's raw output bit for bit (a channel's sum depends only on
    the walk and its own row); the backward in groups within 1e-5 of the
    rows' peak (only the geometry rows' sum over the groups changes
    order)."""
    feat, st, en, gx = _packed(sem_dim, seed=sem_dim)

    def fwd(f):
        return CB.blend_fwd_plain(f, st, en, gx)

    raw = fwd(feat)
    assert torch.equal(CB._fwd_in_groups(feat, group, fwd), raw)
    (_, hi0), *_ = CB._channel_groups(sem_dim, group)
    raw0 = fwd(CB._group_rows(feat, sem_dim, 0, hi0))
    assert torch.equal(CB._fwd_in_groups(feat, group, fwd, raw0=raw0), raw)
    for lo, hi in CB._channel_groups(sem_dim, group):    # lone group runs
        lone = fwd(CB._group_rows(feat, sem_dim, lo, hi))
        assert torch.equal(lone[..., 3:3 + hi - lo], raw[..., 3 + lo:3 + hi])

    grad = torch.as_tensor(np.random.default_rng(sem_dim).normal(
        0, 1, raw.shape).astype(np.float32))
    rows = CB.blend_bwd_plain(feat, st, en, raw, grad, gx)
    got = CB._bwd_in_groups(
        feat, raw, grad, group,
        lambda f, r, g: CB.blend_bwd_plain(f, st, en, r, g, gx))
    assert got.shape == rows.shape
    peak = float(rows.abs().max())
    assert peak > 0
    assert float((got - rows).abs().max()) <= 1e-5 * peak
    # the semantic, rgb and depth rows come from one group each
    assert torch.allclose(got[:, 6:], rows[:, 6:], rtol=1e-5,
                          atol=1e-6 * peak)


def test_render_and_backward_at_sem_dim_80_match_xla():
    """S = 80 (past the card's widest instance; in channel groups there)
    on the CPU: the render against goi_tpu's xla backend at 5e-5, and
    the gradients of a seeded linear loss on every output at
    tests/test_pallas_blend.py's gradient bar (2e-3 / 2e-4)."""
    s_dim = 80
    js = make_random_scene(n=200, seed=8, sem_dim=s_dim)
    jc = make_test_camera(width=48, height=32, angle=0.5)
    bg = np.array([0.1, 0.3, 0.2], np.float32)
    rng = np.random.default_rng(80)
    wts = {k: rng.normal(0, 1, shape).astype(np.float32)
           for k, shape in (("render", (3, 32, 48)),
                            ("semantics", (s_dim, 32, 48)),
                            ("depth", (1, 32, 48)))}
    jcfg = JConfig(max_instances=1 << 14)

    def jloss(params):
        out = jrender(js.with_params(params), jc, jnp.asarray(bg), jcfg)
        return sum(jnp.sum(out[k] * wts[k]) for k in wts), out

    (_, jout), jgrads = jax.value_and_grad(jloss, has_aux=True)(js.params())
    ts = to_torch_scene(js)
    leaves = {k: v.clone().requires_grad_() for k, v in ts.params().items()}
    out = render(ts.with_params(leaves), to_torch_camera(jc),
                 torch.as_tensor(bg), RasterConfig(max_instances=1 << 14))
    sum((out[k] * torch.as_tensor(wts[k])).sum() for k in wts).backward()
    assert out["semantics"].shape == (s_dim, 32, 48)
    for k in ("render", "semantics", "depth", "alpha"):
        np.testing.assert_allclose(out[k].detach().numpy(),
                                   np.asarray(jout[k]), err_msg=k, **TOL)
    for k, g in jgrads.items():
        np.testing.assert_allclose(leaves[k].grad.numpy(), np.asarray(g),
                                   err_msg=k, **GRAD_TOL)


def _first_by_search(p, nb, blk):
    return torch.searchsorted(p, torch.arange(nb + 2) * blk).to(torch.int32)


@pytest.mark.parametrize("case", ["dense", "repeated", "empty_blocks",
                                  "one_block", "at_end", "none"])
@pytest.mark.parametrize("blk", [128, 512])
def test_first_bound_table_matches_searchsorted(case, blk):
    """first[b] = the number of bounds below b * blk for b in [0, nb + 1]:
    repeated bounds (the chain's clamp under an overflow), blocks no
    bound falls in, all bounds in one block, bounds at the stream's end
    nb * blk, and no bounds at all."""
    nb = 7
    m = nb * blk
    rng = np.random.default_rng(blk + len(case))
    if case == "dense":
        p = np.sort(rng.integers(0, m + 1, 900))
    elif case == "repeated":
        p = np.concatenate([np.sort(rng.integers(0, m - 1, 300)),
                            np.full(40, m - 1), np.full(5, m)])
    elif case == "empty_blocks":
        p = np.sort(np.concatenate([rng.integers(0, blk, 50),
                                    rng.integers(5 * blk, 6 * blk, 50)]))
    elif case == "one_block":
        p = np.sort(rng.integers(3 * blk, 4 * blk, 200))
    elif case == "at_end":
        p = np.concatenate([[0, 1, blk], np.full(9, m)])
    else:
        p = np.zeros(0, np.int64)
    p = torch.as_tensor(p.astype(np.int64))
    first = R.block_first_bounds_plain(p, nb, blk)
    assert first.dtype == torch.int32 and first.shape == (nb + 2,)
    assert torch.equal(first, _first_by_search(p, nb, blk))
    assert int(first[0]) == 0 and int(first[-1]) == p.numel()
    for b in range(nb + 1):     # each block's bounds lie in it
        blk_p = p[int(first[b]):int(first[b + 1])]
        assert bool(((blk_p >= b * blk) & (blk_p < (b + 1) * blk)).all()) \
            or b == nb and bool((blk_p == m).all())


@pytest.mark.parametrize("d,blk", [(1, 512), (20, 512), (106, 512),
                                   (107, 512), (127, 512), (360, 128),
                                   (400, 128), (74, 256)])
def test_column_slices_cover_and_fit(d, blk):
    smem = H100_SMEM_OPTIN
    sl = R.column_slices(d, blk, smem)
    assert sl[0][0] == 0 and sl[-1][1] == d
    assert all(a[1] == b[0] for a, b in zip(sl, sl[1:]))
    widths = [c1 - c0 for c0, c1 in sl]
    assert max(widths) * 4 * (blk + 33) <= smem
    assert max(widths) - min(widths) <= 1
    fits_one = d * 4 * (blk + 33) <= smem
    assert (len(sl) == 1) == fits_one
    if blk == 512:      # the H100's limit: 106 columns of 512-row blocks
        assert fits_one == (d <= 106)
