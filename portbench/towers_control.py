"""Readings that set the RES cell's limits: the port's requests held to
the plain reference by the cell's own comparison, sound and under three
controls, at the cell's own size, with no timed window.

    python3 -m portbench.towers_control --mode <mode> --seeds <n> [<n> ...]

prints one JSON line a seed, each with the worst of `--requests` seeded
requests of the cell's orbit. Modes: none (the sound readings), tf32
(the port's request with TF32 on, the precision below the
configuration's float32), ref_tf32 (the plain reference computed in
TF32 put in the port's place), squash (the detector's view squashed to
its 800 x 800 square, the input before the published rule), no_relpos
(SAM's decomposed relative positions left out: the port's tables
zeroed, the reference's kept). The benchmark's runs never run this.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import json
import sys
from pathlib import Path

import torch

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench import inputs, program  # noqa: E402
from portbench.control import tf32  # noqa: E402

CELL = "towers.res"


def driver():
    spec = importlib.util.spec_from_file_location(
        "portbench_driver_res",
        Path(__file__).resolve().parent / "drivers" / "res.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def readings(seed, mode, n_requests, device="cuda", overrides=None):
    from portbench.run import load_cell
    drv = driver()
    wl, cfg = load_cell(CELL)
    for key, part in (overrides or {}).items():
        target = cfg if key == "config" else wl
        for k, v in part.items():
            target[k] = dict(target[k], **v) if isinstance(v, dict) \
                and isinstance(target.get(k), dict) else v
    traffic = wl["params"]
    with tf32(False):
        c = drv.setup(cfg, traffic, seed, device)
    fault = contextlib.nullcontext
    if mode == "tf32":
        def fault():
            return tf32(True)
    elif mode == "squash":
        s = cfg["gdino"]["input"]["size"]

        @contextlib.contextmanager
        def fault():
            c["det"].input_hw = lambda h, w: (s, s)
            try:
                yield
            finally:
                del c["det"].input_hw
    elif mode == "no_relpos":
        # the port's tables zeroed; the reference keeps the drawn ones
        with torch.no_grad():
            for blk in c["predictor"].model.image_encoder.blocks:
                blk.attn.rel_pos_h.zero_()
                blk.attn.rel_pos_w.zero_()
    idx = inputs.sample_indices(seed, len(c["path"]), n_requests)
    rows = []
    with tf32(False):
        for i in idx:
            img, mask = drv.request(c, i)
            if mode == "ref_tf32":
                with tf32(True):
                    alt = drv.reference(c, cfg, img, i)
                p = {k: alt[k] for k in ("pred_logits", "pred_boxes",
                                         "embedding", "keep")}
                p.update(top=alt["score"].topk(
                    alt["topk_idx"].shape[1]).values,
                    to_sam=len(alt["keep"]), masks=(
                        None if alt["mask"] is None else alt["mask"].cpu(),))
                rows.append(drv.gaps(p, drv.reference(
                    c, cfg, img, i, select=alt["topk_idx"])))
                continue
            if mode != "none":
                with fault():
                    mask = c["prov"].predict_mask(img, drv.ask(c, i)[1])
            rows.append(drv.compare(c, cfg, img, i, mask, port_fault=fault))
    program.sync(device)
    return drv.worst(rows), wl["limits"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", default="none",
                    choices=("none", "tf32", "ref_tf32", "squash",
                             "no_relpos"))
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--requests", type=int, default=3)
    args = ap.parse_args(argv)
    for seed in args.seeds:
        nums, limits = readings(seed, args.mode, args.requests)
        checks, ok = program.checks(nums, limits)
        print(json.dumps({"workload": CELL, "mode": args.mode, "seed": seed,
                          "correct": ok, "checks": checks}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
