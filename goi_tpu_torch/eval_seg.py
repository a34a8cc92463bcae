"""Open-vocabulary segmentation evaluation: `python -m goi_tpu_torch.eval_seg`.

Counterpart of the root eval_seg.py (the role of ref:eval_seg.py:31-142):
per-prompt mask folders for MipNeRF360-OV (m360) and the Replica
top-7-prompt protocol, scored as mIoU / mPA / mP per prompt, then per
scene, then overall (eval/metrics.py `iou_metrics`).

  python -m goi_tpu_torch.eval_seg -e <eval_root> -s <saving_root> \\
      --scene_list room counter -d m360|replica [--device cuda|cpu]
"""

from __future__ import annotations

import json
import os
from argparse import ArgumentParser

import numpy as np
import torch

from goi_tpu_torch import _cli
from goi_tpu_torch.eval.metrics import iou_metrics
from goi_tpu_torch.utils.image import read_image, resize_image


def _load_pred(path, shape):
    """A predicted mask, resized (bilinear) to the GT's (H, W) if it
    differs, > 0."""
    pred = read_image(path, "L")
    if pred.shape != shape:
        pred = resize_image(pred, shape[1], shape[0], "bilinear")
    return pred > 0


def _score(gt, pred, device, clock):
    with clock.phase("compute"):
        m = iou_metrics(torch.as_tensor(pred, device=device),
                        torch.as_tensor(gt, device=device))
        return float(m["iou"]), float(m["mpa"]), float(m["mp"])


def m360(scene_name, eval_root, saving_root, device, clock):
    """(ref:eval_seg.py:31-62)."""
    gt_root = os.path.join(eval_root, scene_name)
    ious, mpas, mps = [], [], []
    for prompt in sorted(os.listdir(gt_root)):
        mdir = os.path.join(gt_root, prompt, "masks")
        p_iou, p_mpa, p_mp = [], [], []
        for gt_mask in sorted(os.listdir(mdir)):
            img_name = gt_mask.split(".")[0]
            pred_p = os.path.join(saving_root, scene_name, prompt,
                                  img_name + ".png")
            if not os.path.exists(pred_p):
                print("missing:", pred_p)
                continue
            with clock.phase("load"):
                gt = read_image(os.path.join(mdir, gt_mask), "L")
                pred = _load_pred(pred_p, gt.shape)
            i, a, p = _score(gt > 0, pred, device, clock)
            p_iou.append(i)
            p_mpa.append(a)
            p_mp.append(p)
        ious.append(np.mean(p_iou))
        mpas.append(np.mean(p_mpa))
        mps.append(np.mean(p_mp))
    print(f"{scene_name} metrics, (iou, mpa, mp): "
          f"{(np.mean(ious), np.mean(mpas), np.mean(mps))}")
    return np.mean(ious), np.mean(mpas), np.mean(mps)


def replica_top7(scene_name, data_root, saving_root, device, clock):
    """(ref:eval_seg.py:74-113)."""
    gt_root = os.path.join(data_root, scene_name, "test", "sem")
    with open(os.path.join(data_root, scene_name, "test",
                           "top_list.json")) as f:
        top = json.load(f)
    s_iou, s_mpa, s_mp = [], [], []
    for gt_name in sorted(os.listdir(gt_root)):
        img_name = gt_name.split(".")[0]
        with clock.phase("load"):
            gt_all = read_image(os.path.join(gt_root, gt_name), "L")
        i_iou, i_mpa, i_mp = [], [], []
        for entry in top[img_name + ".png"]:
            prompt, cid = entry["class_name"], entry["id"]
            pred_p = os.path.join(
                saving_root, scene_name, prompt,
                "rgb_" + img_name.split("_")[1] + ".png")
            if not os.path.exists(pred_p):
                print("missing:", pred_p)
                continue
            with clock.phase("load"):
                pred = _load_pred(pred_p, gt_all.shape)
            i, a, p = _score(gt_all == cid, pred, device, clock)
            i_iou.append(i)
            i_mpa.append(a)
            i_mp.append(p)
        s_iou.append(np.mean(i_iou))
        s_mpa.append(np.mean(i_mpa))
        s_mp.append(np.mean(i_mp))
    print(f"{scene_name} miou, mpa, mp: "
          f"{(np.mean(s_iou), np.mean(s_mpa), np.mean(s_mp))}")
    return np.mean(s_iou), np.mean(s_mpa), np.mean(s_mp)


def main(argv=None):
    parser = ArgumentParser("Evaluate goi_tpu_torch segmentation masks")
    parser.add_argument("--eval_root", "-e", type=str)
    parser.add_argument("--saving_root", "-s", type=str)
    parser.add_argument("--scene_list", nargs="+", default=["room"])
    parser.add_argument("--dataset", "-d", type=str, default="m360")
    _cli.add_device_flag(parser)
    args = parser.parse_args(argv)
    device = _cli.resolve_device(args.device)
    clock = _cli.Clock(device)
    fn = {"m360": m360, "replica": replica_top7}[args.dataset]
    res = np.asarray([fn(s, args.eval_root, args.saving_root, device, clock)
                      for s in args.scene_list])
    overall = tuple(res.mean(axis=0))
    print(f"Overall metrics, (iou, mpa, mp): {overall}")
    _cli.summary("eval_seg", clock, miou=float(overall[0]),
                 mpa=float(overall[1]), mp=float(overall[2]))
    return res


if __name__ == "__main__":
    main()
