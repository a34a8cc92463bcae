"""Readings that bound a cell's limits from above: the control (the
plain reference put in the program's place and computed in TF32, the
precision below the float32 with TF32 off that the configurations
state) and the planted faults, each held against the float32 reference
by the cell's own comparison, at the cell's own size.

    python3 -m portbench.control --workload <cell> --mode tf32 \\
        --seeds <n> [<n> ...]

prints one JSON line a seed. Modes: tf32 (every cell), half_batch (the
loss over half of each view's pixels: distillation cells). The
benchmark's runs never run this; portbench/tests/
test_portbench_control.py runs it on the card.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
from pathlib import Path

import torch

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench import inputs, program  # noqa: E402
from portbench.reference import distill as ref_distill  # noqa: E402
from portbench.reference import orbit as ref_orbit  # noqa: E402
from portbench.reference import raster as ref_raster  # noqa: E402
from portbench.reference import semantic as ref_semantic  # noqa: E402


@contextlib.contextmanager
def tf32(on: bool):
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def distill_readings(workload, config, seed, mode, device) -> dict:
    p = workload["params"]
    raw = inputs.make_scene(config["scene"], seed, device)
    views = inputs.training_views(config["views"], seed)
    maps, _ = inputs.feature_maps(config["maps"], views, seed, device)
    kw = dict(tab_len=config["codebook"]["tab_len"],
              steps=p["compared_steps"], batch=p.get("batch", 1))
    with tf32(False):
        ref = ref_distill.first_steps(raw, views, maps, seed, **kw)
    with tf32(mode == "tf32"):
        alt = ref_distill.first_steps(raw, views, maps, seed,
                                      keep_half=mode == "half_batch", **kw)
    print(f"[control] losses {alt['losses']} reference {ref['losses']}",
          file=sys.stderr, flush=True)
    return program.training_numbers(alt, ref)


def query_frames(raw, path, idx, fovy, model, thresh):
    weight, bias, lut, text = model
    out = []
    for i in idx:
        view = ref_orbit.viewer_camera(path[i % len(path)], fovy)
        sp = ref_raster.preprocess(raw, view)
        r = ref_raster.render(sp, ref_raster.tile_lists(sp),
                              bg=torch.ones(3, device=raw["xyz"].device))
        out.append(ref_semantic.query_frame(r["render"], r["semantics"],
                                            weight, bias, lut, text,
                                            thresh=thresh))
    return out


def query_readings(workload, config, seed, device) -> dict:
    p = workload["params"]
    raw = inputs.make_scene(config["scene"], seed, device)
    protos = inputs.prototypes(config["maps"], seed, device)
    spec = dict(p["query"], dim_in=config["scene"]["sem_dim"],
                tab_len=config["codebook"]["tab_len"])
    model = inputs.query_model(spec, protos, seed, device)
    path = inputs.orbit_path(p["path"], seed)
    # as many frames as a run compares, at positions of the orbit drawn
    # from the seed
    idx = inputs.sample_indices(seed, len(path), p["compared_frames"])
    with tf32(False):
        ref = query_frames(raw, path, idx, p["fovy_deg"], model,
                           p["sim_thresh"])
    with tf32(True):
        alt = query_frames(raw, path, idx, p["fovy_deg"], model,
                           p["sim_thresh"])
    return program.frame_numbers([a.cpu() for a in alt], ref, p["levels"])


def readings(cell, seed, mode, device="cuda") -> dict:
    from portbench.run import load_cell
    wl, cfg = load_cell(cell)
    if wl["driver"] == "query":
        if mode != "tf32":
            raise ValueError(f"{cell} has no {mode} fault")
        return query_readings(wl, cfg, seed, device)
    return distill_readings(wl, cfg, seed, mode, device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--mode", default="tf32",
                    choices=("tf32", "half_batch"))
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    from portbench.run import load_cell
    limits = load_cell(args.workload)[0]["limits"]
    for seed in args.seeds:
        nums = readings(args.workload, seed, args.mode)
        checks, ok = program.checks(nums, limits)
        print(json.dumps({"workload": args.workload, "mode": args.mode,
                          "seed": seed, "correct": ok, "checks": checks}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
