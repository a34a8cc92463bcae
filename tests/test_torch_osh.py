"""The OSH fine-tune of the port (goi_tpu_torch/query/osh.py) against
goi_tpu's: the hinge loss and its gradient (half at a tie), the IoU, and
osh_finetune run to the IoU target and to its epoch budget (the same
epoch count, weight and bias at rtol 1e-5); then QuerySession's
finetune_with_res, render_query_masks and eval_against_gt against
goi_tpu's on tests/test_torch_query.py's small scene."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from goi_tpu.query import osh as josh
from goi_tpu_torch.query import osh as tosh
from tests.conftest import make_test_camera
from tests.test_torch_core import to_torch_camera
from tests.test_torch_query import _sessions

torch.set_num_threads(1)


def test_hinge_loss_and_gradient_match_jax():
    rng = np.random.default_rng(0)
    out = rng.normal(0, 2, 400).astype(np.float32)
    lab = (rng.uniform(0, 1, 400) > 0.5).astype(np.float32)
    out[:20] = 2.0 * lab[:20] - 1.0     # ties: 1 - out * y == 0
    jl, jg = jax.value_and_grad(josh.hinge_loss)(jnp.asarray(out),
                                                 jnp.asarray(lab))
    t = torch.tensor(out, requires_grad=True)
    tl = tosh.hinge_loss(t, torch.as_tensor(lab))
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-6)
    np.testing.assert_array_equal(t.grad.numpy(), np.asarray(jg))
    assert float(t.grad[0]) == pytest.approx(-0.5 * (2 * lab[0] - 1) / 400)


def test_iou_matches_jax():
    rng = np.random.default_rng(1)
    a = rng.uniform(0, 1, 1000) > 0.4
    b = rng.uniform(0, 1, 1000) > 0.6
    for p, g in ((a, b), (a, a), (np.zeros(5, bool), np.zeros(5, bool))):
        got = tosh._iou(torch.as_tensor(p), torch.as_tensor(g))
        want = josh._iou(jnp.asarray(p), jnp.asarray(g))
        assert got.dtype == torch.float32
        assert float(got) == float(want)


def _problem(seed, flip):
    """Unit features in two clusters, a mask of one cluster with `flip`
    of its labels flipped, and a text embedding off the cluster's axis
    (so the fine-tune has work to do)."""
    rng = np.random.default_rng(seed)
    c = 64
    centers = rng.normal(0, 1, (2, c))
    lab = rng.uniform(0, 1, 3000) > 0.6
    feats = centers[lab.astype(int)] + 0.9 * rng.normal(0, 1, (3000, c))
    feats /= np.linalg.norm(feats, axis=1, keepdims=True)
    mask = lab ^ (rng.uniform(0, 1, 3000) < flip)
    text = centers[1] + 1.5 * rng.normal(0, 1, c)
    text /= np.linalg.norm(text)
    return (feats.astype(np.float32), mask.astype(np.float32),
            text.astype(np.float32))


@pytest.mark.parametrize("case,max_epochs", [("target", 8000),
                                             ("budget", 40)])
def test_osh_finetune_matches_jax(case, max_epochs):
    feats, mask, text = _problem(2, 0.0 if case == "target" else 0.25)
    jst, jiou, jep = josh.osh_finetune(
        josh.osh_init(jnp.asarray(text)), jnp.asarray(feats),
        jnp.asarray(mask), max_epochs=max_epochs)
    tst, tiou, tep = tosh.osh_finetune(
        tosh.osh_init(torch.as_tensor(text)), torch.as_tensor(feats),
        torch.as_tensor(mask), max_epochs=max_epochs)
    assert tep == int(jep)
    assert float(tiou) == float(jiou)
    if case == "target":
        assert 0 < tep < max_epochs and float(tiou) >= 0.9
    else:
        assert tep == max_epochs and float(tiou) < 0.9
    np.testing.assert_allclose(tst.weight.numpy(), np.asarray(jst.weight),
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(float(tst.bias), float(jst.bias), rtol=1e-5)


def test_osh_finetune_stops_at_once_when_the_init_clears_the_target():
    """A state that already clears the target runs no epoch (the loop
    tests its condition before the first epoch)."""
    feats, mask, text = [torch.as_tensor(a) for a in _problem(2, 0.0)]
    done, iou, _ = tosh.osh_finetune(tosh.osh_init(text), feats, mask)
    st, iou2, epochs = tosh.osh_finetune(done, feats, mask)
    assert epochs == 0 and float(iou2) == float(iou) >= 0.9
    assert torch.equal(st.weight, done.weight)
    assert torch.equal(st.bias, done.bias)


def _res_mask(h, w):
    m = np.zeros((h, w), np.float32)
    m[:, : w // 2] = 1.0
    return m


def _code_mask(tsess, cam):
    """The pixels whose decoded code is 1: a mask a hyperplane separates."""
    from goi_tpu_torch.raster.render import render
    with torch.no_grad():
        sem = render(tsess.scene, cam, tsess.bg, tsess.raster_cfg)[
            "semantics"]
        code = torch.argmax(tsess.decoder(sem.reshape(10, -1).T), -1)
    return (code == 1).reshape(cam.height, cam.width).float().numpy()


@pytest.mark.parametrize("mask", ["codes", "halves"])
def test_finetune_with_res_matches_jax(mask):
    """'codes' reaches the IoU target, 'halves' (no hyperplane over two
    distinct features splits it) runs out of epochs."""
    jsess, tsess = _sessions()
    cam = make_test_camera(width=48, height=32)
    tcam = to_torch_camera(cam)
    res = _code_mask(tsess, tcam) if mask == "codes" else _res_mask(32, 48)
    budget = 2000 if mask == "codes" else 300
    jiou, jep = jsess.finetune_with_res(cam, res, max_epochs=budget)
    tiou, tep = tsess.finetune_with_res(tcam, res, max_epochs=budget)
    assert tep == jep and tiou == jiou
    if mask == "codes":
        assert 0 < tep < budget and tiou >= 0.9
    else:
        assert tep == budget
    assert tsess.res_finetuned and jsess.res_finetuned
    # the epochs and the IoU agree exactly; over the ~570 epochs of
    # 'codes' the weights drift by ~3e-5 (each epoch's gradient sums
    # 1536 pixels in another order), hence its absolute floor
    np.testing.assert_allclose(tsess.osh.weight.numpy(),
                               np.asarray(jsess.osh.weight), rtol=1e-5,
                               atol=1e-4 if mask == "codes" else 1e-6)
    np.testing.assert_allclose(float(tsess.osh.bias),
                               float(jsess.osh.bias), rtol=1e-5)
    # the OSH branch now decides membership, in both packages
    np.testing.assert_array_equal(tsess.retrieve(), jsess.retrieve())

    jsess.text_tokens = None
    tsess.text_tokens = None
    with pytest.raises(ValueError, match="set_text"):
        tsess.finetune_with_res(tcam, res)
    with pytest.raises(ValueError, match="set_text"):
        jsess.finetune_with_res(cam, res)


def test_query_masks_and_eval_match_jax(tmp_path):
    jsess, tsess = _sessions()
    cams = [make_test_camera(width=48, height=32, angle=a)
            for a in (0.3, -0.2)]
    gts = [_res_mask(32, 48), 1.0 - _res_mask(32, 48)]
    want = jsess.eval_against_gt(cams, gts)
    got = tsess.eval_against_gt([to_torch_camera(c) for c in cams], gts)
    assert set(got) == {"iou", "mpa", "mp"}
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)

    jp = jsess.render_query_masks(cams, str(tmp_path / "jax"),
                                  names=["a", "b"])
    tp = tsess.render_query_masks([to_torch_camera(c) for c in cams],
                                  str(tmp_path / "port"), names=["a", "b"])
    assert [p.rsplit("/", 1)[1] for p in tp] == ["a.png", "b.png"]
    for a, b in zip(tp, jp):
        np.testing.assert_array_equal(np.asarray(Image.open(a)),
                                      np.asarray(Image.open(b)))
    assert tsess.render_query_masks([to_torch_camera(cams[0])],
                                    str(tmp_path / "n"))[0] \
        .endswith("00000.png")
