"""Novel-view quality metrics: `python -m goi_tpu_torch.metrics`.

Counterpart of the root metrics.py (the role of ref:metrics.py:25-92):
reads `<model>/test/<method>/renders` and `gt`, computes per-view PSNR
and SSIM, and LPIPS when backbone weights are present (vgg, else alex;
eval/lpips.py), and writes `results.json` and `per_view.json` with the
JAX package's keys (`LPIPS: null` without weights).

  python -m goi_tpu_torch.metrics -m <model_dir> [...] [--device cuda|cpu]
"""

from __future__ import annotations

import json
import os
from argparse import ArgumentParser

import numpy as np
import torch

from goi_tpu_torch import _cli
from goi_tpu_torch.eval.lpips import load_weights, lpips_or_none
from goi_tpu_torch.eval.metrics import psnr, ssim
from goi_tpu_torch.utils.image import read_image


def _scores(rdir, gdir, names, lpips_net, device, clock):
    psnrs, ssims, lpipss = [], [], []
    for fname in names:
        with clock.phase("load"):
            r, g = (torch.as_tensor(
                read_image(os.path.join(d, fname), "RGB").transpose(
                    2, 0, 1).astype(np.float32) / 255.0, device=device)
                for d in (rdir, gdir))
        with clock.phase("compute"):
            psnrs.append(float(psnr(r, g)))
            ssims.append(float(ssim(r, g)))
            lp = lpips_or_none(r, g, net=lpips_net)
            if lp is not None:
                lpipss.append(float(lp))
    return psnrs, ssims, lpipss


def evaluate(model_paths, device="cuda"):
    """{model_path: results} over the model directories; each also
    written to the directory's results.json and per_view.json."""
    device = _cli.resolve_device(str(device))
    clock = _cli.Clock(device)
    everything = {}
    for model_path in model_paths:
        print("Scene:", model_path)
        full, per_view = {}, {}
        test_dir = os.path.join(model_path, "test")
        if not os.path.isdir(test_dir):
            print("  no test renders found")
            continue
        # the protocol's vgg (ref:metrics.py:63), else alex when only its
        # weights are present; the results name the backbone
        lpips_net = "vgg" if load_weights("vgg") is not None else "alex"
        for method in sorted(os.listdir(test_dir)):
            rdir = os.path.join(test_dir, method, "renders")
            gdir = os.path.join(test_dir, method, "gt")
            if not os.path.isdir(rdir):
                continue
            names = sorted(os.listdir(rdir))
            # SSIM and LPIPS convolve: in full fp32, as the reference
            with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
                psnrs, ssims, lpipss = _scores(rdir, gdir, names, lpips_net,
                                               device, clock)
            full[method] = {
                "PSNR": float(np.mean(psnrs)),
                "SSIM": float(np.mean(ssims)),
                "LPIPS": float(np.mean(lpipss)) if lpipss else None,
                "LPIPS_net": lpips_net if lpipss else None,
            }
            per_view[method] = {
                "PSNR": dict(zip(names, psnrs)),
                "SSIM": dict(zip(names, ssims)),
            }
            print(f"  {method}: PSNR {full[method]['PSNR']:.4f} "
                  f"SSIM {full[method]['SSIM']:.4f} "
                  f"LPIPS {full[method]['LPIPS']}")
        with open(os.path.join(model_path, "results.json"), "w") as f:
            json.dump(full, f, indent=2)
        with open(os.path.join(model_path, "per_view.json"), "w") as f:
            json.dump(per_view, f, indent=2)
        everything[model_path] = full
    _cli.summary("metrics", clock, results=everything)
    return everything


def main(argv=None):
    parser = ArgumentParser(description="goi_tpu_torch metrics")
    parser.add_argument("--model_paths", "-m", nargs="+", required=True)
    _cli.add_device_flag(parser)
    args = parser.parse_args(argv)
    return evaluate(args.model_paths, device=args.device)


if __name__ == "__main__":
    main()
