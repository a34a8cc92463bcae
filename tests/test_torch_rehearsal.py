"""The port's one-command rehearsal (goi_tpu_torch/examples/rehearsal.py
--fast) on the CPU: synthetic COLMAP scene -> RGB pre-training from its
SfM points (iteration 1) -> the port's train, render and metrics entry
points -> query masks -> its eval_seg, with
tests/test_round_rehearsal.py's schema and metric sanity checks (and no
gate on TPU perf artifacts)."""

import json
import os

import numpy as np
import torch

from goi_tpu_torch.examples.rehearsal import main


def test_port_rehearsal_fast(tmp_path):
    summary = main(["--root", str(tmp_path), "--fast", "--device", "cpu"])
    with open(tmp_path / "REHEARSAL.json") as f:
        assert json.load(f) == summary

    # metric sanity (smoke size: finite and non-degenerate, not a bar)
    assert np.isfinite(summary["psnr"]) and summary["psnr"] > 5.0
    assert 0.0 <= summary["miou"] <= 1.0
    assert 0.0 <= summary["mpa"] <= 1.0

    art = summary["artifacts"]
    for key in ("point_cloud_ply", "semantic_mlp", "lut", "results_json",
                "per_view_json", "cfg_args"):
        assert os.path.exists(art[key]), key

    # iteration 1 is the RGB-trained scene: the SfM cloud's 4x subsample
    # of the GT's Gaussians, trained away from the create-from-points
    # init (opacity logit of 0.1 everywhere)
    from goi_tpu_torch.core.ply import load_gaussians_ply
    cfg = summary["config"]
    rgb = load_gaussians_ply(os.path.join(
        os.path.dirname(art["cfg_args"]), "point_cloud", "iteration_1",
        "point_cloud.ply"), device="cpu")
    assert cfg["rgb_iters"] == 60
    assert int(rgb.num_valid) == cfg["rgb_gaussians"]
    assert 0 < cfg["rgb_gaussians"] != cfg["n_gauss"]
    init_logit = float(np.log(0.1 / 0.9))
    assert float((rgb.opacity - init_logit).abs().max()) > 1e-3

    # the PLY reloads with its sem_* fields, the decoder/LUT pair decodes
    from goi_tpu_torch.data.scene import load_semantics
    scene = load_gaussians_ply(art["point_cloud_ply"], device="cpu")
    assert scene.semantics.shape[-1] == 10
    decoder, lut = load_semantics(os.path.dirname(art["point_cloud_ply"]),
                                  device="cpu")
    assert lut.shape == (16, 16)     # (tab_len, ape_dim) of --fast
    assert decoder(torch.zeros(4, 10)).shape == (4, 16)

    with open(art["results_json"]) as f:
        (_, vals), = json.load(f).items()
    assert {"PSNR", "SSIM", "LPIPS"} <= set(vals)

    # mask folders in eval_seg's m360 layout
    pred = os.path.join(art["pred_masks"], "synthetic")
    gt = os.path.join(art["gt_masks"], "synthetic")
    assert sorted(os.listdir(pred)) == sorted(os.listdir(gt))
    assert os.listdir(os.path.join(pred, sorted(os.listdir(pred))[0]))
