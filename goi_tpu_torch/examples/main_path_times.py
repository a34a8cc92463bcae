"""Times of the one-card paths that run the 'chain' reduce, to compare two
checkouts on one card.

    python goi_tpu_torch/examples/main_path_times.py

imports the goi_tpu_torch it finds on the path (PYTHONPATH=<checkout>
picks a checkout) and, on main_path_hash.py's seeded 1,000,000-Gaussian
scene (SH degree 3, 10 semantic channels) at 1296x968 over 3 orbit views
(the first is main_path_hash.py's) with the suggested budget (reduce
'chain'), times:

- the distillation step (`train_step`, seeded 256-dim maps of 12
  prototypes plus noise, `init_codebook` to 300 codes);
- `trace()` of a seeded 10-channel map;
- the RGB step (`create_rgb_trainer`'s step, every attribute trained,
  against the scene's own render of the view);
- the whole per-Gaussian sum of one step's backward, unfused
  (`blocked_segment_reduce`) and fused (`dense_boundary_reduce`), beside
  `torch.segment_reduce` of the same rows over the same bounds.

Wall times are medians of host clocks around calls that end in a
synchronise; the reduces are timed with CUDA events; one profiled call of
each path gives its device-busy ms and its count of device ops. It
prints one JSON line. To compare two checkouts, run it for the parent,
the change, the change and the parent, one after another on one card.
"""

from __future__ import annotations

import json
import math
import subprocess
import time

import numpy as np
import torch

from goi_tpu_torch.examples.main_path_hash import (HEIGHT, SEM_DIM, WIDTH,
                                                   _scene)

APE_DIM, TAB_LEN, N_PROTOS = 256, 300, 12
N_VIEWS = 3
WARMUP, ITERS = 5, 30


def _cams(device):
    from goi_tpu_torch.core.camera import Camera, focal2fov, fov2focal
    fovy = focal2fov(fov2focal(0.9, WIDTH), HEIGHT)
    cams = []
    for i in range(N_VIEWS):
        a = 2 * math.pi * i / N_VIEWS + 0.3
        eye = [4.5 * math.sin(a), 0.5, -4.5 * math.cos(a)]
        cams.append(Camera.look_at(eye, [0, 0, 0], [0, 1, 0], 0.9, fovy,
                                   WIDTH, HEIGHT, device=device))
    return cams


def _maps(device):
    """N_VIEWS (256, H, W) maps: N_PROTOS prototypes laid out at 1/8
    resolution, upsampled, plus a little noise."""
    rng = np.random.default_rng(5)
    protos = torch.as_tensor(rng.normal(0, 1, (N_PROTOS, APE_DIM))
                             .astype(np.float32), device=device)
    gen = torch.Generator(device=device).manual_seed(5)
    maps = []
    for _ in range(N_VIEWS):
        lab = torch.as_tensor(rng.integers(
            0, N_PROTOS, ((HEIGHT + 7) // 8, (WIDTH + 7) // 8)),
            device=device)
        lab = lab.repeat_interleave(8, 0).repeat_interleave(8, 1)
        fm = protos[lab[:HEIGHT, :WIDTH]].permute(2, 0, 1).contiguous()
        fm += 0.05 * torch.randn(fm.shape, generator=gen, device=device)
        maps.append(fm)
    return maps


def _wall(fn):
    """Median wall ms of ITERS calls of fn(i) after WARMUP."""
    for i in range(WARMUP):
        fn(i)
    times = []
    for i in range(ITERS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(i)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times)), times


def _events(fn, iters=20):
    """Median device ms of fn() by CUDA events, after two warm-ups."""
    fn()
    fn()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def _profile(fn):
    """(device-busy ms, device ops) of one call of fn()."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    return (sum(e.self_device_time_total for e in kernels) / 1e3,
            sum(e.count for e in kernels))


def main() -> None:
    import goi_tpu_torch
    from goi_tpu_torch.raster import reduce
    from goi_tpu_torch.raster.render import (RasterConfig, render,
                                             suggest_budgets, trace)
    from goi_tpu_torch.semantic.codebook import (SemanticDecoder,
                                                 init_codebook)
    from goi_tpu_torch.train.distill import create_distill_state
    from goi_tpu_torch.train.optim import OptimConfig
    from goi_tpu_torch.train.rgb import create_rgb_trainer
    dev = "cuda"
    scene = _scene(dev)
    cams = _cams(dev)
    mi, _ = suggest_budgets(scene, cams, margin=1.2)
    cfg = RasterConfig(max_instances=mi, reduce="chain")
    bg = torch.zeros(3, device=dev)
    result = {"package": goi_tpu_torch.__file__, "budget": mi}

    # the distillation step, with the stream and bounds of one backward's
    # reduce recorded for the reduce timings
    maps = _maps(dev)
    gen = torch.Generator().manual_seed(0)
    lut = init_codebook(gen, maps, tab_len=TAB_LEN)
    decoder = SemanticDecoder.create(gen, dim_in=SEM_DIM, dim_out=TAB_LEN,
                                     device=dev)
    state, train_step = create_distill_state(scene, decoder, lut,
                                             OptimConfig())
    seen = {}
    orig = reduce.blocked_segment_reduce

    def record(rows, bounds):
        seen["args"] = (rows.detach(), bounds.detach())
        return orig(rows, bounds)
    reduce.blocked_segment_reduce = record
    try:
        train_step(state, cams[0], maps[0], bg, cfg)
    finally:
        reduce.blocked_segment_reduce = orig

    def step(i):
        train_step(state, cams[i % N_VIEWS], maps[i % N_VIEWS], bg, cfg)
    result["step_ms"], result["step_all_ms"] = _wall(step)
    result["step_busy_ms"], result["step_device_ops"] = _profile(
        lambda: step(0))
    del state, maps, lut

    rows, bounds = seen.pop("args")
    p = torch.clamp(bounds.long(), max=rows.shape[0])
    lengths = p.diff()
    used = rows[int(p[0]):int(p[-1])]
    result["reduce_rows"] = list(rows.shape)
    result["reduce_bounds"] = p.numel()
    result["unfused_reduce_ms"] = _events(
        lambda: reduce.blocked_segment_reduce(rows, bounds))
    result["fused_reduce_ms"] = _events(
        lambda: reduce.dense_boundary_reduce(rows, bounds))
    result["segment_reduce_ms"] = _events(
        lambda: torch.segment_reduce(used, "sum", lengths=lengths))
    result["reduce_routes_equal"] = bool(torch.equal(
        reduce.blocked_segment_reduce(rows, bounds),
        reduce.dense_boundary_reduce(rows, bounds)))
    del rows, bounds, used, p, lengths

    # trace()
    gen = torch.Generator(device=dev).manual_seed(7)
    imgs = [torch.randn((SEM_DIM, HEIGHT, WIDTH), generator=gen,
                        device=dev) for _ in cams]

    def lift(i):
        trace(scene, cams[i % N_VIEWS], imgs[i % N_VIEWS], bg, cfg)
    result["trace_ms"], result["trace_all_ms"] = _wall(lift)
    result["trace_busy_ms"], result["trace_device_ops"] = _profile(
        lambda: lift(0))
    del imgs

    # the RGB step against the scene's own renders
    with torch.no_grad():
        gts = [render(scene, c, bg, cfg)["render"] for c in cams]
    init_fn, rgb_step, _ = create_rgb_trainer(OptimConfig(), cfg)
    rgb_state = init_fn(scene)

    def rgb(i):
        rgb_step(rgb_state, cams[i % N_VIEWS], gts[i % N_VIEWS], bg)
    result["rgb_ms"], result["rgb_all_ms"] = _wall(rgb)
    result["rgb_busy_ms"], result["rgb_device_ops"] = _profile(
        lambda: rgb(0))

    result["device"] = torch.cuda.get_device_name(0)
    result["smi"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
