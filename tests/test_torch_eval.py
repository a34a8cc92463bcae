"""The port's metrics (goi_tpu_torch/eval) against goi_tpu's on seeded
inputs: l1, l2, PSNR, SSIM and the IoU/mPA/mP of eval_seg within 1e-5;
LPIPS (alex and vgg) with seeded random weights in the lpips package's
state_dict layout within 1e-4; lpips_or_none is None without weights."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from goi_tpu.eval import lpips as jlpips
from goi_tpu.eval import metrics as jmetrics
from goi_tpu_torch.eval import lpips as tlpips
from goi_tpu_torch.eval import metrics as tmetrics

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)


def _images(seed, c=3, h=40, w=56):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0, 1, (c, h, w)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    return a, b


@pytest.mark.parametrize("seed", [0, 1])
def test_image_metrics_match_goi_tpu(seed):
    a, b = _images(seed)
    for name in ("l1_loss", "l2_loss", "psnr", "ssim"):
        got = float(getattr(tmetrics, name)(torch.as_tensor(a),
                                            torch.as_tensor(b)))
        want = float(getattr(jmetrics, name)(jnp.asarray(a),
                                             jnp.asarray(b)))
        np.testing.assert_allclose(got, want, err_msg=name, **TOL)
    assert float(tmetrics.ssim(torch.as_tensor(a), torch.as_tensor(a))) \
        == pytest.approx(1.0, abs=1e-6)


@pytest.mark.parametrize("case", ["random", "empty_pred", "empty_gt",
                                  "equal"])
def test_iou_metrics_match_goi_tpu(case):
    rng = np.random.default_rng(len(case))
    pred = rng.uniform(0, 1, (30, 40)) > 0.6
    gt = rng.uniform(0, 1, (30, 40)) > 0.5
    if case == "empty_pred":
        pred[:] = False
    elif case == "empty_gt":
        gt[:] = False
    elif case == "equal":
        gt = pred.copy()
    got = tmetrics.iou_metrics(torch.as_tensor(pred), torch.as_tensor(gt))
    want = jmetrics.iou_metrics(jnp.asarray(pred), jnp.asarray(gt))
    for k in ("iou", "mpa", "mp"):
        np.testing.assert_allclose(float(got[k]), float(want[k]),
                                   err_msg=k, equal_nan=True, **TOL)


def _random_state(net, seed):
    """Seeded weights in the lpips package's state_dict layout."""
    rng = np.random.default_rng(seed)
    state = {}
    if net == "alex":
        chans = [3, 64, 192, 384, 256, 256]
        idx = [0, 3, 6, 8, 10]
        for k, (cfg, i) in enumerate(zip(tlpips._ALEX_CONVS, idx)):
            cin, cout, ks = chans[k], cfg[0], cfg[1]
            state[f"net.slice{k + 1}.{i}.weight"] = rng.normal(
                0, np.sqrt(2.0 / (cin * ks * ks)), (cout, cin, ks, ks))
            state[f"net.slice{k + 1}.{i}.bias"] = rng.normal(0, 0.01, cout)
        lin = chans[1:]
    else:
        widths = [64, 128, 256, 512, 512]
        cin = 3
        for k, idxs in enumerate(tlpips._VGG_SLICES):
            for i in idxs:
                state[f"net.slice{k + 1}.{i}.weight"] = rng.normal(
                    0, np.sqrt(2.0 / (cin * 9)), (widths[k], cin, 3, 3))
                state[f"net.slice{k + 1}.{i}.bias"] = rng.normal(
                    0, 0.01, widths[k])
                cin = widths[k]
        lin = widths
    for i, c in enumerate(lin):
        state[f"lin{i}.model.1.weight"] = np.abs(rng.normal(
            0, 0.1, (1, c, 1, 1)))
    return {k: v.astype(np.float32) for k, v in state.items()}


@pytest.mark.parametrize("net", ["alex", "vgg"])
def test_lpips_matches_goi_tpu_on_seeded_weights(net, tmp_path, monkeypatch):
    a, b = _images(7, h=64, w=64)
    state = _random_state(net, 3)
    path = tmp_path / f"lpips_{net}.npz"
    np.savez(path, **state)
    weights = jlpips.normalize_lpips_state(dict(np.load(path)), net)
    want = float(jlpips.lpips(jnp.asarray(a), jnp.asarray(b), weights=weights,
                              net=net))
    monkeypatch.setenv("GOI_LPIPS_VGG_WEIGHTS" if net == "vgg"
                       else "GOI_LPIPS_WEIGHTS", str(path))
    got = tlpips.lpips_or_none(torch.as_tensor(a), torch.as_tensor(b),
                               net=net)
    assert got is not None and want > 0
    np.testing.assert_allclose(float(got), want, rtol=1e-4)
    same = tlpips.lpips(torch.as_tensor(a), torch.as_tensor(a), net=net)
    assert float(same) == pytest.approx(0.0, abs=1e-6)


def test_lpips_or_none_without_weights(tmp_path, monkeypatch):
    for var in ("GOI_LPIPS_VGG_WEIGHTS", "GOI_LPIPS_WEIGHTS"):
        monkeypatch.setenv(var, str(tmp_path / "absent.npz"))
    a, b = _images(2, h=64, w=64)
    for net in ("vgg", "alex"):
        assert tlpips.load_weights(net) is None
        assert tlpips.lpips_or_none(torch.as_tensor(a), torch.as_tensor(b),
                                    net=net) is None
        with pytest.raises(FileNotFoundError, match="weights"):
            tlpips.lpips(torch.as_tensor(a), torch.as_tensor(b), net=net)
