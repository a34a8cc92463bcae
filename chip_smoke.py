#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (goi_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its lines; any failure raises and the script
exits non-zero without the final result line:

1. device: CUDA version, the card's name and power limit (nvidia-smi),
   nvcc, triton;
2. build: compile every CUDA kernel of goi_tpu_torch/raster/csrc (one
   nvcc per source, all at once);
3. kernel checks: each kernel against its plain PyTorch version on the
   card, on the inputs the main paths give it, with times: the
   expansion gather bit-exact; the forward blend within atol = rtol =
   5e-5 on a 100k-Gaussian 512x512 frame and on the full frame; the
   blend backward and the block prefix on that 100k frame's backward
   here and on a full-width training step's in phase 5 (tolerances at
   TOL_BWD and TOL_PREFIX);
4. [main] the query path: a seeded 1,000,000-Gaussian scene (SH degree
   3, 10 semantic channels), a 10->300 decoder and a 300x256 LUT, saved
   as the PLY + pickle + LUT.npy triplet and loaded back; QuerySession
   answers 12 open-vocabulary query frames at 1296x968 over 3 orbit
   views, plus one render() per view; the forward kernels' launch
   counts must be > 0; one more frame runs under torch.profiler
   (device busy share, top kernels); a small scene is checked against
   the oracle and the CPU path;
5. [train] the distillation path on the same scene: 3 cameras at
   1296x968, seeded 256-dim feature maps, init_codebook to 300 codes,
   then N_STEPS train_steps with the reduce resolved to 'chain'; the
   loss must be finite and fall, every kernel must launch, the
   gradients of one step must be bit-identical over two backward
   passes and with RasterConfig(dense_reduce=True) (the fused
   prefix-boundary kernel, held bit-identical to the prefix kernel's
   read-out), and a small scene's step must match the CPU's; it prints
   the step time p50/p95 (also over DENSE_STEPS fused-reduce steps), both
   reduces' device times, the peak memory and one profiled step;
6. [trace] 2D->3D lifting on the same scene: trace() of a seeded
   (10, H, W) normal feature map over the 3 views at 1296x968 (reduce
   'chain', one view also with dense_reduce=True); the trace kernel
   against its plain version on the 100k 512x512 frame and on one full
   view (hit counts exact, rows within TOL_TRACE), trace's render
   against render()'s within 1e-5, num_gsem a multiple of 10 with hits,
   a small scene's trace on the card against the CPU; p50/p95 wall time
   and one profiled call;
7. [micro] the micro-benchmark (goi_tpu_torch/examples/micro_sortpayload.py)
   at its default sizes; the mono row gather bit-exact against its
   plain version and timed beside torch.index_select;
8. a JSON line with every ported kernel's launches, error, times and
   bound; then the final JSON line.
"""

import copy
import json
import math
import subprocess
import sys
import tempfile
import time

import numpy as np

# H100 SXM peaks (NVIDIA data sheet): device memory rate and float32
# outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12
# float32 operations of the blend per pixel x instance pair: walked
# (dx, dy, the 9-op exponent, expf, opacity product, clamp, two tests)
# and, when blended, the transmittance step plus a multiply-add per
# output channel
OPS_WALKED = 16
OPS_BLENDED_BASE = 4
# the backward per blended pair: the suffix and dalpha (~8), the six
# geometric terms (~16), the transmittance step (~6), three operations
# per output channel (f . g, w g, its share of dalpha) and one add per
# row field for the sum over the tile's pixels
OPS_BWD_BLENDED_BASE = 30
TOL = 5e-5          # tests/test_pallas_blend.py's oracle tolerance
# the backward: tests/test_pallas_blend.py's gradient bar, rtol and atol
# relative to the rows' peak (the suffix total - prefix cancels; the
# plain version's CUDA cumsum/cumprod associate differently)
TOL_BWD = (2e-3, 2e-4)
# the block prefix: rtol, and atol relative to the prefixes' peak (an
# fp32 scan of 512 rows in another order)
TOL_PREFIX = (1e-4, 1e-5)
# the trace kernel's lifted rows: rtol, and atol relative to the rows'
# peak (sums of up to 256 pixels' features in another order); the hit
# counts, sums of ones, exactly
TOL_TRACE = (1e-4, 1e-5)
TOL_TRACE_RENDER = 1e-5   # tests/test_trace.py's render bar
WIDTH, HEIGHT = 1296, 968
N_GAUSS = 1_000_000
SEM_DIM, APE_DIM, TAB_LEN = 10, 256, 300
N_VIEWS = 3
N_FRAMES = 12       # query frames on the main path, cycling the views
N_STEPS = 20        # distillation steps on the main path
N_PROTOS = 12       # prototypes of the seeded feature maps
DENSE_STEPS = 5     # distillation steps with the fused reduce
N_TRACES = 6        # trace() calls on the main path, cycling the views
MICRO_ITERS = 5     # steps per figure of the micro-benchmark
KERNEL_SOURCES = ("gather", "blend_fwd", "blend_bwd", "prefix", "trace",
                  "prefix_boundary", "mono_rows")


def log(*a):
    print(*a, flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    return out[0]


def median_ms(fn, iters=10, warmup=2):
    import torch
    for _ in range(warmup):
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


def make_scene(n, seed, device):
    """Seeded synthetic scene at the published widths (SH degree 3,
    10 semantic channels), like the JAX package's bench scene."""
    import torch
    from goi_tpu_torch.core.scene import GaussianScene
    rng = np.random.default_rng(seed)
    scene = GaussianScene.create(
        rng.normal(0, 1.0, (n, 3)).astype(np.float32),
        rng.uniform(0, 1, (n, 3)).astype(np.float32),
        sh_degree=3, sem_dim=SEM_DIM,
        scales=rng.uniform(0.005, 0.02, n).astype(np.float32),
        device=device)

    def t(a):
        return torch.as_tensor(a.astype(np.float32), device=device)

    return scene.replace(
        active_sh_degree=3,
        opacity=scene.opacity + t(rng.normal(0, 1, (n, 1))),
        rotation=t(rng.normal(0, 1, (n, 4))),
        features_rest=t(0.05 * rng.normal(0, 1, (n, 15, 3))),
        semantics=t(rng.normal(0, 0.3, (n, SEM_DIM))))


def orbit_cams(width, height, n, device, dist=4.5):
    from goi_tpu_torch.core.camera import Camera, focal2fov, fov2focal
    fovx = 0.9
    fovy = focal2fov(fov2focal(fovx, width), height)
    cams = []
    for i in range(n):
        a = 2 * math.pi * i / n + 0.3
        eye = [dist * math.sin(a), 0.5, -dist * math.cos(a)]
        cams.append(Camera.look_at(eye, [0, 0, 0], [0, 1, 0], fovx, fovy,
                                   width, height, device=device))
    return cams


def capture(run):
    """Call run() and record the arguments the path hands to each kernel
    wrapper (the last call of each; the wrappers themselves run as
    usual)."""
    import importlib
    import torch
    from goi_tpu_torch.raster import binning, cuda_blend, reduce
    # the module (the package re-exports its function `render`)
    render_mod = importlib.import_module("goi_tpu_torch.raster.render")
    sites = {"gather": (binning, "monotone_gather"),
             "blend": (cuda_blend, "blend_fwd"),
             "blend_bwd": (cuda_blend, "blend_bwd"),
             "prefix": (reduce, "prefix_blocks"),
             "trace": (render_mod, "trace_fwd"),
             "prefix_boundary": (reduce, "prefix_boundary")}
    orig = {k: getattr(mod, attr) for k, (mod, attr) in sites.items()}
    seen = {}

    def recorder(name):
        def rec(*args):
            seen[name] = tuple(a.detach() if torch.is_tensor(a) else a
                               for a in args)
            return orig[name](*args)
        # a wrapper counts on the module attribute it is called through,
        # so the launches of this capture land here and not in the counts
        rec.launches = 0
        return rec

    for k, (mod, attr) in sites.items():
        setattr(mod, attr, recorder(k))
    try:
        run()
    finally:
        for k, (mod, attr) in sites.items():
            setattr(mod, attr, orig[k])
    return seen


def capture_inputs(scene, cam, cfg):
    """The forward kernels' inputs of one render."""
    import torch
    from goi_tpu_torch.raster.render import render

    def run():
        with torch.no_grad():
            render(scene, cam, torch.zeros(3, device=scene.device), cfg)
    return capture(run)


def capture_backward_inputs(scene, cam, cfg, seed):
    """Every kernel's inputs of one render and its backward, with the
    gradient of a seeded random linear loss on color and semantics."""
    import torch
    from goi_tpu_torch.raster.render import render
    gen = torch.Generator(device=scene.device).manual_seed(seed)

    def run():
        sem = scene.semantics.clone().requires_grad_()
        out = render(scene.replace(semantics=sem), cam,
                     torch.zeros(3, device=scene.device), cfg)
        loss = sum((out[k] * torch.randn(out[k].shape, generator=gen,
                                         device=scene.device)).sum()
                   for k in ("semantics", "render"))
        loss.backward()
    return capture(run)


def check_gather(table, idx):
    import torch
    from goi_tpu_torch.raster.gather import (monotone_gather,
                                             monotone_gather_plain)
    out = monotone_gather(table, idx)
    ref = monotone_gather_plain(table, idx)
    torch.cuda.synchronize()
    if not torch.equal(out.view(torch.int32), ref.view(torch.int32)):
        raise AssertionError("monotone_gather differs from table[:, idx]")
    ms = median_ms(lambda: monotone_gather(table, idx))
    plain_ms = median_ms(lambda: monotone_gather_plain(table, idx))
    lib_ms = median_ms(lambda: torch.index_select(table, 1, idx))
    nbytes = 4 * (table.numel() + idx.numel() + out.numel())
    bound_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    log(f"[kernels] gather C={table.shape[0]} N={table.shape[1]} "
        f"M={idx.shape[0]}: bit-exact; kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, index_select {lib_ms:.4f} ms, bound "
        f"{bound_ms:.4f} ms (bytes)")
    return dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by="bytes", library_ms=lib_ms)


def check_blend(feat, starts, ends, grid_x, label):
    import torch
    from goi_tpu_torch.raster.cuda_blend import blend_fwd, blend_fwd_plain
    out = blend_fwd(feat, starts, ends, grid_x)
    torch.cuda.synchronize()
    ref = blend_fwd_plain(feat, starts, ends, grid_x)
    torch.cuda.synchronize()
    n_out = feat.shape[0] - 6
    a, b = out[..., :n_out + 1], ref[..., :n_out + 1]
    err = float((a - b).abs().max())
    if not torch.isfinite(a).all():
        raise AssertionError(f"blend {label}: non-finite kernel output")
    if not torch.allclose(a, b, rtol=TOL, atol=TOL):
        raise AssertionError(f"blend {label}: max |kernel - plain| {err}")
    count_diff = int((out[..., n_out + 1:] != ref[..., n_out + 1:]).sum())
    walked = float(out[..., n_out + 1].double().sum())
    blended = float(out[..., n_out + 2].double().sum())
    ms = median_ms(lambda: blend_fwd(feat, starts, ends, grid_x))
    plain_ms = median_ms(lambda: blend_fwd_plain(feat, starts, ends, grid_x),
                         iters=3, warmup=1)
    nbytes = 4 * (feat.numel() + starts.numel() + ends.numel()
                  + out.numel())
    ops = OPS_WALKED * walked + (OPS_BLENDED_BASE + 2 * n_out) * blended
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = ops / PEAK_FP32_PER_S * 1e3
    log(f"[kernels] blend {label}: tiles={starts.numel()} "
        f"M={feat.shape[1]} max_err={err:.3e} (tol {TOL}) count "
        f"mismatches={count_diff}; pairs walked={walked:.0f} "
        f"blended={blended:.0f}; kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, bound {max(bytes_ms, ops_ms):.4f} ms "
        f"(bytes {bytes_ms:.4f}, operations {ops_ms:.4f})")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                library_ms=None)


def close_to_peak(a, b, rtol, atol_rel):
    """|a - b| <= rtol |b| + atol_rel max|b|, elementwise; returns
    (ok, max |a - b|)."""
    import torch
    err = (a - b).abs()
    peak = float(b.abs().max())
    ok = bool(torch.isfinite(a).all()) and bool(
        (err <= rtol * b.abs() + atol_rel * peak).all())
    return ok, float(err.max())


def check_blend_bwd(feat, starts, ends, raw, grad, grid_x, label):
    import torch
    from goi_tpu_torch.raster.cuda_blend import blend_bwd, blend_bwd_plain
    out = blend_bwd(feat, starts, ends, raw, grad, grid_x)
    torch.cuda.synchronize()
    ref = blend_bwd_plain(feat, starts, ends, raw, grad, grid_x)
    torch.cuda.synchronize()
    ok, err = close_to_peak(out, ref, *TOL_BWD)
    peak = float(ref.abs().max())
    if not ok:
        raise AssertionError(f"blend_bwd {label}: max |kernel - plain| "
                             f"{err} (peak {peak})")
    n_out = feat.shape[0] - 6
    walked = float(raw[..., n_out + 1].double().sum())
    blended = float(raw[..., n_out + 2].double().sum())
    ms = median_ms(lambda: blend_bwd(feat, starts, ends, raw, grad, grid_x))
    plain_ms = median_ms(
        lambda: blend_bwd_plain(feat, starts, ends, raw, grad, grid_x),
        iters=2, warmup=1)
    nbytes = 4 * (feat.numel() + starts.numel() + ends.numel()
                  + raw.numel() + grad.numel() + out.numel())
    ops = OPS_WALKED * walked + (OPS_BWD_BLENDED_BASE + 3 * n_out
                                 + feat.shape[0]) * blended
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = ops / PEAK_FP32_PER_S * 1e3
    log(f"[kernels] blend_bwd {label}: tiles={starts.numel()} "
        f"M={feat.shape[1]} max_err={err:.3e} (peak {peak:.3e}, tol rtol "
        f"{TOL_BWD[0]} + {TOL_BWD[1]} x peak); pairs walked={walked:.0f} "
        f"blended={blended:.0f}; kernel {ms:.4f} ms, plain {plain_ms:.4f} "
        f"ms, bound {max(bytes_ms, ops_ms):.4f} ms (bytes {bytes_ms:.4f}, "
        f"operations {ops_ms:.4f})")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                library_ms=None)


def check_prefix(rows, okf, blk, label):
    import torch
    from goi_tpu_torch.raster.reduce import prefix_blocks, prefix_blocks_plain
    inner, tot = prefix_blocks(rows, okf, blk)
    torch.cuda.synchronize()
    ref_inner, ref_tot = prefix_blocks_plain(rows, okf, blk)
    torch.cuda.synchronize()
    ok_i, err_i = close_to_peak(inner, ref_inner, *TOL_PREFIX)
    ok_t, err_t = close_to_peak(tot, ref_tot, TOL_PREFIX[0],
                                TOL_PREFIX[1] * float(
                                    ref_inner.abs().max()) / max(
                                    float(ref_tot.abs().max()), 1e-30))
    err = max(err_i, err_t)
    if not (ok_i and ok_t):
        raise AssertionError(f"prefix {label}: max |kernel - plain| {err}")
    m, d = rows.shape
    nb = m // blk
    ms = median_ms(lambda: prefix_blocks(rows, okf, blk))
    plain_ms = median_ms(lambda: prefix_blocks_plain(rows, okf, blk))
    lib_ms = median_ms(lambda: torch.cumsum(rows.view(nb, blk, d), dim=1))
    nbytes = 4 * (rows.numel() + (0 if okf is None else okf.numel())
                  + inner.numel() + tot.numel())
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = m * d / PEAK_FP32_PER_S * 1e3
    log(f"[kernels] prefix {label}: rows=({m}, {d}) block={blk} "
        f"masked={okf is not None} max_err={err:.3e} (tol rtol "
        f"{TOL_PREFIX[0]} + {TOL_PREFIX[1]} x peak); kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, cumsum {lib_ms:.4f} ms, bound "
        f"{max(bytes_ms, ops_ms):.4f} ms (bytes)")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                library_ms=lib_ms)


def profile(run, what, top=12):
    """run() under torch.profiler: wall time, the device's busy and idle
    share, and the kernels that take the most device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    log(f"[profile] {what} {wall_ms:.2f} ms wall, device busy "
        f"{busy_ms:.2f} ms, idle share {1 - busy_ms / wall_ms:.3f}, "
        f"{sum(e.count for e in kernels)} device ops")
    kernels.sort(key=lambda e: -e.self_device_time_total)
    for e in kernels[:top]:
        log(f"[profile]   {e.self_device_time_total / 1e3:8.3f} ms "
            f"x{e.count:<4d} {e.key[:110]}")


def feature_maps(n, seed, width, height, device):
    """Seeded APE-like (256, H, W) maps: N_PROTOS prototypes laid out by
    a random label map at 1/8 resolution, upsampled, plus a little
    per-pixel noise (so every pixel's feature is distinct)."""
    import torch
    rng = np.random.default_rng(seed)
    protos = torch.as_tensor(rng.normal(0, 1, (N_PROTOS, APE_DIM))
                             .astype(np.float32), device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    maps = []
    for _ in range(n):
        lab = torch.as_tensor(rng.integers(
            0, N_PROTOS, ((height + 7) // 8, (width + 7) // 8)),
            device=device)
        lab = lab.repeat_interleave(8, 0).repeat_interleave(8, 1)
        fm = protos[lab[:height, :width]].permute(2, 0, 1).contiguous()
        fm += 0.05 * torch.randn(fm.shape, generator=gen, device=device)
        maps.append(fm)
    return maps


def step_grads(state, cam, gt, bg, cfg):
    """The gradients of one distillation step's loss (no update)."""
    from goi_tpu_torch.train.distill import distill_loss
    leaves = [p for p in state.scene.params().values() if p.requires_grad]
    leaves += list(state.decoder.parameters()) + [state.lut]
    for p in leaves:
        p.grad = None
    loss, aux = distill_loss(state, cam, gt, bg, cfg)
    loss.backward()
    grads = [p.grad.clone() for p in leaves]
    for p in leaves:
        p.grad = None
    return aux, grads


def train_phase(scene, cams, cfg, stats):
    """[train]: distillation at full width through the trainer API."""
    import dataclasses
    import torch
    from goi_tpu_torch.raster.render import _effective_reduce
    from goi_tpu_torch.semantic.codebook import (SemanticDecoder,
                                                 init_codebook)
    from goi_tpu_torch.train.distill import create_distill_state
    from goi_tpu_torch.train.optim import OptimConfig
    if _effective_reduce(cfg) != "chain":
        raise AssertionError(f"reduce resolves to {_effective_reduce(cfg)}")
    t0 = time.time()
    maps = feature_maps(N_VIEWS, 5, WIDTH, HEIGHT, "cuda")
    torch.cuda.synchronize()
    t1 = time.time()
    gen = torch.Generator().manual_seed(0)
    lut = init_codebook(gen, maps, tab_len=TAB_LEN)
    torch.cuda.synchronize()
    log(f"[train] {N_VIEWS} feature maps {tuple(maps[0].shape)} in "
        f"{t1 - t0:.1f} s; init_codebook -> {tuple(lut.shape)} in "
        f"{time.time() - t1:.1f} s")
    decoder = SemanticDecoder.create(gen, dim_in=SEM_DIM, dim_out=TAB_LEN,
                                     device="cuda")
    state, train_step = create_distill_state(scene, decoder, lut,
                                             OptimConfig())
    bg = torch.zeros(3, device="cuda")

    # step 1, captured: the backward kernels at the main path's shapes
    losses = []

    def first():
        _, aux = train_step(state, cams[0], maps[0], bg, cfg)
        losses.append(float(aux["total"]))
    seen = capture(first)
    stats["blend_bwd"] = check_blend_bwd(
        *seen["blend_bwd"], label=f"1M {WIDTH}x{HEIGHT} train step")
    stats["prefix"] = check_prefix(
        *seen["prefix"], label=f"1M {WIDTH}x{HEIGHT} train step")
    del seen

    # two backward passes of one step: bit-identical gradients
    _, g1 = step_grads(state, cams[1], maps[1], bg, cfg)
    _, g2 = step_grads(state, cams[1], maps[1], bg, cfg)
    if not all(torch.equal(a, b) for a, b in zip(g1, g2)):
        raise AssertionError("gradients differ between two backward passes")
    log(f"[train] gradients of one step bit-identical over two backward "
        f"passes ({len(g1)} tensors, {sum(g.numel() for g in g1)} values)")
    # the same step with the fused reduce: the same bits
    dense_cfg = dataclasses.replace(cfg, dense_reduce=True)
    g3 = []
    seen = capture(lambda: g3.extend(
        step_grads(state, cams[1], maps[1], bg, dense_cfg)[1]))
    if not all(torch.equal(a, b) for a, b in zip(g1, g3)):
        raise AssertionError("gradients with dense_reduce differ")
    log("[train] the step's gradients with dense_reduce=True are "
        "bit-identical to the unfused chain's")
    del g1, g2, g3
    stats["prefix_boundary"] = check_prefix_boundary(
        *seen["prefix_boundary"], label=f"1M {WIDTH}x{HEIGHT} train step")
    del seen

    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    step_ms = []
    for i in range(N_STEPS):
        cam = cams[(i + 1) % N_VIEWS]
        t0 = time.perf_counter()
        _, aux = train_step(state, cam, maps[(i + 1) % N_VIEWS], bg, cfg)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(aux["total"]))
    launches = {k: n for k, n in read_counts().items()
                if k in ("gather", "blend", "blend_bwd", "prefix")}
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    p50, p95 = np.percentile(step_ms, [50, 95])
    log(f"[train] {N_STEPS} steps at {WIDTH}x{HEIGHT}, 1M Gaussians, "
        f"S={SEM_DIM}, codebook {TAB_LEN}x{APE_DIM}, reduce "
        f"{_effective_reduce(cfg)}, max_instances={cfg.max_instances}: "
        f"step p50 {p50:.1f} ms, p95 {p95:.1f} ms, max {max(step_ms):.1f} "
        f"ms; peak memory {peak_gb:.2f} GiB; launches {launches}")
    log(f"[train] losses {' '.join(f'{x:.4f}' for x in losses)}")
    if not np.isfinite(losses).all():
        raise AssertionError("non-finite loss")
    if not np.mean(losses[-N_VIEWS:]) < np.mean(losses[:N_VIEWS]):
        raise AssertionError("the loss did not fall")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel was not launched: {launches}")
    slots = int(aux["num_slots"])
    if slots > cfg.max_instances:
        raise AssertionError(f"num_slots {slots} > {cfg.max_instances}")
    i = N_STEPS + 1
    profile(lambda: train_step(state, cams[i % N_VIEWS], maps[i % N_VIEWS],
                               bg, cfg), "distillation step", top=20)

    # DENSE_STEPS more steps with the fused reduce
    reset_counts()
    dense_ms = []
    for i in range(DENSE_STEPS):
        t0 = time.perf_counter()
        _, aux = train_step(state, cams[i % N_VIEWS], maps[i % N_VIEWS], bg,
                            dense_cfg)
        torch.cuda.synchronize()
        dense_ms.append((time.perf_counter() - t0) * 1e3)
        if not math.isfinite(float(aux["total"])):
            raise AssertionError("non-finite loss with dense_reduce")
    counts = read_counts()
    if counts["prefix_boundary"] != DENSE_STEPS or counts["prefix"]:
        raise AssertionError(f"dense_reduce steps launched {counts}")
    log(f"[train] {DENSE_STEPS} steps with dense_reduce=True: step p50 "
        f"{np.percentile(dense_ms, 50):.1f} ms, max {max(dense_ms):.1f} ms; "
        f"launches prefix_boundary={counts['prefix_boundary']} prefix=0")
    launches["prefix_boundary"] = counts["prefix_boundary"]
    for k in ("gather", "blend", "blend_bwd"):
        launches[k] += counts[k]
    return launches


def small_train_check():
    """A small scene's distillation step on the card against the same
    step on the CPU (all of position, opacity, color and semantics
    trained, so preprocess's backward runs too), and a short
    train_distillation run on the card."""
    import torch
    from goi_tpu_torch.semantic.codebook import SemanticDecoder
    from goi_tpu_torch.train.distill import (create_distill_state,
                                             train_distillation)
    from goi_tpu_torch.raster.render import RasterConfig
    from goi_tpu_torch.train.optim import OptimConfig
    tiny = make_scene(2000, seed=3, device="cpu")
    gen = torch.Generator().manual_seed(4)
    decoder = SemanticDecoder.create(gen, dim_in=SEM_DIM, dim_out=TAB_LEN,
                                     device="cpu")
    lut = torch.randn((TAB_LEN, APE_DIM), generator=gen)
    gt = torch.randn((APE_DIM, 64, 96), generator=gen)
    cfg = RasterConfig(max_instances=1 << 15)
    ocfg = OptimConfig(position_finetune=True, opacity_finetune=True,
                       feature_finetune=True)
    got = []
    for dev in ("cuda", "cpu"):
        state, _ = create_distill_state(tiny.to(dev), decoder.to(dev),
                                        lut.to(dev), ocfg)
        cam = orbit_cams(96, 64, 1, dev, dist=4.0)[0]
        aux, grads = step_grads(state, cam, gt.to(dev),
                                torch.zeros(3, device=dev), cfg)
        got.append(({k: float(v.detach()) for k, v in aux.items()},
                    [g.cpu() for g in grads]))
    (aux_g, g_g), (aux_c, g_c) = got
    for k in ("lab", "sl", "sl1", "recc", "total"):
        if not math.isclose(aux_g[k], aux_c[k], rel_tol=1e-4):
            raise AssertionError(f"{k}: card {aux_g[k]} vs CPU {aux_c[k]}")
    worst = 0.0
    for a, b in zip(g_g, g_c):
        ok, err = close_to_peak(a, b, *TOL_BWD)
        if not ok:
            raise AssertionError(f"step gradients card vs CPU: {err} "
                                 f"(peak {float(b.abs().max())})")
        worst = max(worst, err)
    log(f"[train] small scene: a step's loss terms and {len(g_g)} gradient "
        f"tensors on the card match the CPU's (max grad diff {worst:.2e})")
    maps = feature_maps(2, 9, 96, 64, "cuda")
    state = train_distillation(
        tiny.to("cuda"), orbit_cams(96, 64, 2, "cuda", dist=4.0), maps,
        tab_len=16, iterations=3, log_every=1,
        raster_cfg=RasterConfig(max_instances=1 << 15))
    if state.step != 3:
        raise AssertionError("train_distillation did not take 3 steps")


def kernel_wrappers():
    """The kernels line's names -> each kernel's wrapper (its launch
    count is the wrapper's `launches`)."""
    from goi_tpu_torch.raster.cuda_blend import blend_bwd, blend_fwd
    from goi_tpu_torch.raster.cuda_trace import trace_fwd
    from goi_tpu_torch.raster.gather import mono_rows, monotone_gather
    from goi_tpu_torch.raster.reduce import prefix_blocks, prefix_boundary
    return {"gather": monotone_gather, "blend": blend_fwd,
            "blend_bwd": blend_bwd, "prefix": prefix_blocks,
            "trace": trace_fwd, "prefix_boundary": prefix_boundary,
            "mono_rows": mono_rows}


def reset_counts():
    for k in kernel_wrappers().values():
        k.launches = 0


def read_counts() -> dict:
    return {name: k.launches for name, k in kernel_wrappers().items()}


def timed_ms(fn):
    """(fn(), device ms of that one call)."""
    import torch
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    out = fn()
    b.record()
    torch.cuda.synchronize()
    return out, a.elapsed_time(b)


def check_trace(feat, starts, ends, aug, grid_x, label):
    """The trace kernel against its plain version on one call's inputs:
    the render sums within TOL, hit counts exactly, lifted rows within
    TOL_TRACE; the plain version is timed on its one checking run."""
    import torch
    from goi_tpu_torch.raster.cuda_trace import trace_fwd, trace_fwd_plain
    raw, rows = trace_fwd(feat, starts, ends, aug, grid_x)
    torch.cuda.synchronize()
    (ref_raw, ref_rows), plain_ms = timed_ms(
        lambda: trace_fwd_plain(feat, starts, ends, aug, grid_x))
    n_out = feat.shape[0] - 6
    a, b = raw[..., :n_out + 1], ref_raw[..., :n_out + 1]
    err_raw = float((a - b).abs().max())
    if not torch.isfinite(a).all() or not torch.allclose(a, b, rtol=TOL,
                                                         atol=TOL):
        raise AssertionError(f"trace {label}: render max |kernel - plain| "
                             f"{err_raw}")
    hit_diff = int((rows[:, -1] != ref_rows[:, -1]).sum())
    if hit_diff:
        raise AssertionError(f"trace {label}: {hit_diff} instances' hit "
                             f"counts differ from the plain version's")
    ok, err_rows = close_to_peak(rows, ref_rows, *TOL_TRACE)
    if not ok:
        raise AssertionError(f"trace {label}: rows max |kernel - plain| "
                             f"{err_rows}")
    count_diff = int((raw[..., n_out + 1:] != ref_raw[..., n_out + 1:])
                     .sum())
    walked = float(raw[..., n_out + 1].double().sum())
    blended = float(raw[..., n_out + 2].double().sum())
    hits = float(rows[:, -1].double().sum())
    sa = aug.shape[-1]
    ms = median_ms(lambda: trace_fwd(feat, starts, ends, aug, grid_x))
    nbytes = 4 * (feat.numel() + starts.numel() + ends.numel() + aug.numel()
                  + raw.numel() + rows.numel())
    ops = (OPS_WALKED * walked + (OPS_BLENDED_BASE + 2 * n_out) * blended
           + sa * hits)
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = ops / PEAK_FP32_PER_S * 1e3
    log(f"[kernels] trace {label}: tiles={starts.numel()} M={feat.shape[1]} "
        f"lifted={sa}; render max_err={err_raw:.3e} (tol {TOL}), rows "
        f"max_err={err_rows:.3e} (tol rtol {TOL_TRACE[0]} + {TOL_TRACE[1]} x "
        f"peak), hit counts equal, walked/blended count mismatches="
        f"{count_diff}; pairs walked={walked:.0f} blended={blended:.0f} "
        f"hits={hits:.0f}; kernel {ms:.4f} ms, plain {plain_ms:.1f} ms, "
        f"bound {max(bytes_ms, ops_ms):.4f} ms (bytes {bytes_ms:.4f}, "
        f"operations {ops_ms:.4f})")
    return dict(max_abs_err=max(err_raw, err_rows), ms=ms,
                plain_ms=plain_ms, bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                library_ms=None)


def check_prefix_boundary(rows, p, blk, label):
    """The fused kernel against the prefix kernel's read-out (bit for
    bit) and its plain version, and the two whole reduces on the same
    stream, timed."""
    import torch
    from goi_tpu_torch.raster.reduce import (blocked_segment_reduce,
                                             dense_boundary_reduce,
                                             prefix_blocks, prefix_boundary,
                                             prefix_boundary_plain)
    lb, tot = prefix_boundary(rows, p, blk)
    inner, tot_u = prefix_blocks(rows, None, blk)
    fused = dense_boundary_reduce(rows, p)
    unfused = blocked_segment_reduce(rows, p)
    torch.cuda.synchronize()
    if not (torch.equal(lb, inner[p]) and torch.equal(tot, tot_u)
            and torch.equal(fused, unfused)):
        raise AssertionError(f"prefix_boundary {label}: not bit-identical "
                             f"to the prefix kernel's read-out")
    del inner, tot_u, fused, unfused
    ref_lb, ref_tot = prefix_boundary_plain(rows, p, blk)
    ok_l, err_l = close_to_peak(lb, ref_lb, *TOL_PREFIX)
    ok_t, err_t = close_to_peak(tot, ref_tot, TOL_PREFIX[0], TOL_PREFIX[1]
                                * float(ref_lb.abs().max())
                                / max(float(ref_tot.abs().max()), 1e-30))
    err = max(err_l, err_t)
    if not (ok_l and ok_t):
        raise AssertionError(f"prefix_boundary {label}: max |kernel - "
                             f"plain| {err}")
    del ref_lb, ref_tot
    m, d = rows.shape
    ms = median_ms(lambda: prefix_boundary(rows, p, blk))
    unfused_ms = median_ms(lambda: prefix_blocks(rows, None, blk)[0][p])
    plain_ms = median_ms(lambda: prefix_boundary_plain(rows, p, blk))
    fused_red_ms = median_ms(lambda: dense_boundary_reduce(rows, p))
    unfused_red_ms = median_ms(lambda: blocked_segment_reduce(rows, p))
    nbytes = 4 * (rows.numel() + lb.numel() + tot.numel()) + 8 * p.numel()
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = m * d / PEAK_FP32_PER_S * 1e3
    log(f"[kernels] prefix_boundary {label}: rows=({m}, {d}) bounds="
        f"{p.numel()} block={blk}: bit-identical to prefix's inner[p] and "
        f"totals, max_err vs plain={err:.3e}; kernel {ms:.4f} ms (prefix + "
        f"gather {unfused_ms:.4f} ms), plain {plain_ms:.4f} ms, bound "
        f"{max(bytes_ms, ops_ms):.4f} ms (bytes); whole reduce: fused "
        f"{fused_red_ms:.4f} ms, unfused {unfused_red_ms:.4f} ms")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                library_ms=None)


def check_mono(table, idx):
    import torch
    from goi_tpu_torch.raster.gather import mono_rows, mono_rows_plain
    out = mono_rows(table, idx)
    ref = mono_rows_plain(table, idx)
    torch.cuda.synchronize()
    if not torch.equal(out.view(torch.int32), ref.view(torch.int32)):
        raise AssertionError("mono_rows differs from its plain version")
    zero_rows = int((~ref.any(dim=1)).sum())
    ms = median_ms(lambda: mono_rows(table, idx))
    plain_ms = median_ms(lambda: mono_rows_plain(table, idx))
    lib_ms = median_ms(lambda: torch.index_select(table, 0, idx))
    nbytes = 4 * (table.numel() + idx.numel() + out.numel())
    bound_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    log(f"[kernels] mono_rows n={table.shape[0]} C={table.shape[1]} "
        f"m={idx.shape[0]}: bit-exact ({zero_rows} rows outside their "
        f"window); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"index_select {lib_ms:.4f} ms, bound {bound_ms:.4f} ms (bytes)")
    return dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by="bytes", library_ms=lib_ms)


def trace_phase(scene, cams, cfg, stats):
    """[trace]: 2D->3D lifting at full width through trace()."""
    import dataclasses
    import torch
    from goi_tpu_torch.raster.render import (RasterConfig, render,
                                             suggest_budgets, trace)
    gen = torch.Generator(device="cuda").manual_seed(7)
    bg = torch.zeros(3, device="cuda")

    # the kernel against its plain version on the 100k frame and one view
    small = make_scene(100_000, seed=1, device="cuda")
    small_cam = orbit_cams(512, 512, 1, "cuda")[0]
    mi, _ = suggest_budgets(small, small_cam, margin=1.2)
    simg = torch.randn((SEM_DIM, 512, 512), generator=gen, device="cuda")
    seen = capture(lambda: trace(small, small_cam, simg, bg, RasterConfig(
        max_instances=mi, reduce="chain")))
    check_trace(*seen["trace"], label="100k 512x512")
    del small, simg, seen
    imgs = [torch.randn((SEM_DIM, HEIGHT, WIDTH), generator=gen,
                        device="cuda") for _ in cams]
    seen = capture(lambda: trace(scene, cams[0], imgs[0], bg, cfg))
    stats["trace"] = check_trace(*seen["trace"],
                                 label=f"1M {WIDTH}x{HEIGHT}")
    del seen
    trace(scene, cams[0], imgs[0], bg, cfg)      # warm-up, before the counts

    reset_counts()
    dense_cfg = dataclasses.replace(cfg, dense_reduce=True)
    times, outs = [], []
    for i in range(N_TRACES + 1):
        v = i % N_VIEWS
        t0 = time.perf_counter()
        out = trace(scene, cams[v], imgs[v], bg,
                    dense_cfg if i == N_TRACES else cfg)
        torch.cuda.synchronize()
        if i < N_TRACES:
            times.append((time.perf_counter() - t0) * 1e3)
        if i < N_VIEWS or i == N_TRACES:
            outs.append(out)
    counts = read_counts()
    launches = {k: counts[k] for k in ("trace", "gather", "prefix",
                                       "prefix_boundary")}
    if counts["blend"] or counts["blend_bwd"]:
        raise AssertionError(f"trace ran a blend kernel: {counts}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel was not launched: {launches}")

    # what came out, read after the counted run
    n = scene.capacity
    for v, out in enumerate(outs[:N_VIEWS]):
        gsem, cnt = out["gaussian_semantics"], out["num_gsem"]
        if gsem.shape != (n, SEM_DIM) or cnt.shape != (n,) \
                or cnt.dtype != torch.int32:
            raise AssertionError(f"trace shapes {tuple(gsem.shape)} "
                                 f"{tuple(cnt.shape)} {cnt.dtype}")
        if not torch.isfinite(gsem).all() or not torch.isfinite(
                out["render"]).all():
            raise AssertionError("non-finite trace output")
        if bool((cnt % SEM_DIM != 0).any()) or int(cnt.sum()) <= 0:
            raise AssertionError("num_gsem is not a positive multiple of S")
        slots = int(out["num_slots"])
        if slots > cfg.max_instances:
            raise AssertionError(f"num_slots {slots} > {cfg.max_instances}")
        with torch.no_grad():
            ref = render(scene, cams[v], bg, cfg)["render"]
        err = float((out["render"] - ref).abs().max())
        if not torch.allclose(out["render"], ref, rtol=TOL_TRACE_RENDER,
                              atol=TOL_TRACE_RENDER):
            raise AssertionError(f"trace render vs render(): {err}")
        log(f"[trace] view {v}: {int((cnt > 0).sum())} of {n} Gaussians hit, "
            f"{int(cnt.sum()) // SEM_DIM} hits, num_slots={slots}, "
            f"max_tile_depth={int(out['max_tile_depth'])}; render vs "
            f"render() max diff {err:.3e} (tol {TOL_TRACE_RENDER})")
    dense = outs[-1]
    if not (torch.equal(dense["num_gsem"], outs[0]["num_gsem"]) and
            torch.equal(dense["gaussian_semantics"],
                        outs[0]["gaussian_semantics"])):
        raise AssertionError("trace with dense_reduce differs from the chain")
    del outs, dense
    p50, p95 = np.percentile(times, [50, 95])
    log(f"[trace] {N_TRACES} trace() calls at {WIDTH}x{HEIGHT}, 1M "
        f"Gaussians, S_img={SEM_DIM}, reduce chain: p50 {p50:.1f} ms, p95 "
        f"{p95:.1f} ms, max {max(times):.1f} ms; one more view with "
        f"dense_reduce=True is bit-identical; launches {launches}")
    profile(lambda: trace(scene, cams[0], imgs[0], bg, cfg), "trace call")

    # a small scene's trace on the card against the CPU
    tiny = make_scene(2000, seed=3, device="cpu")
    img = torch.randn((SEM_DIM, 64, 96), generator=torch.Generator()
                      .manual_seed(3))
    small_cfg = RasterConfig(max_instances=1 << 15)
    got, want = [{k: v.cpu() for k, v in trace(
        tiny.to(dev), orbit_cams(96, 64, 1, dev, dist=4.0)[0], img.to(dev),
        torch.ones(3, device=dev), small_cfg).items()}
        for dev in ("cuda", "cpu")]
    if not torch.equal(got["num_gsem"], want["num_gsem"]):
        raise AssertionError("small trace: hit counts card vs CPU differ")
    e = float((got["gaussian_semantics"] - want["gaussian_semantics"])
              .abs().max())
    if not torch.allclose(got["gaussian_semantics"],
                          want["gaussian_semantics"], rtol=1e-4, atol=1e-4) \
            or not torch.allclose(got["render"], want["render"], rtol=TOL,
                                  atol=TOL):
        raise AssertionError(f"small trace card vs CPU: {e}")
    log(f"[trace] small scene: counts equal card vs CPU "
        f"({int(want['num_gsem'].sum())}), features max diff {e:.2e}")
    return launches


def micro_phase(stats):
    """[micro]: the micro-benchmark at its default sizes."""
    import torch
    from goi_tpu_torch.examples import micro_sortpayload as micro
    x = micro.make_inputs(micro.DEFAULT_M, micro.DEFAULT_N, "cuda")
    stats["mono_rows"] = check_mono(x["table"], x["gstream"])
    del x
    torch.cuda.synchronize()
    reset_counts()
    res = micro.run(iters=MICRO_ITERS)
    n = read_counts()["mono_rows"]
    log(f"[micro] {json.dumps(res)}")
    if n <= 0:
        raise AssertionError("the micro-benchmark did not launch mono_rows")
    return {"mono_rows": n}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1

    # ---- 1. device ----
    import goi_tpu_torch  # noqa: F401  (fails outside a checkout)
    from goi_tpu_torch.raster import _nvcc
    smi = smi_line()
    try:
        import triton
        triton_version = triton.__version__
    except ImportError:
        triton_version = "absent"
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{smi}; nvcc {_nvcc.nvcc()}; triton {triton_version}")
    if torch.backends.cuda.matmul.allow_tf32 is not False:
        raise AssertionError("TF32 matmuls must be off (full fp32)")
    torch.backends.cudnn.allow_tf32 = False

    # ---- 2. build ----
    t0 = time.time()
    _nvcc.build(KERNEL_SOURCES)
    log(f"[build] {' + '.join(f'{k}.cu' for k in KERNEL_SOURCES)} in "
        f"{time.time() - t0:.1f} s")

    from goi_tpu_torch.app.session import QuerySession
    from goi_tpu_torch.data import scene as triplet
    from goi_tpu_torch.raster.render import (RasterConfig, render,
                                             suggest_budgets)
    from goi_tpu_torch.semantic.codebook import SemanticDecoder

    # ---- 3. kernel checks at main-path shapes ----
    small = make_scene(100_000, seed=1, device="cuda")
    small_cam = orbit_cams(512, 512, 1, "cuda")[0]
    mi, _ = suggest_budgets(small, small_cam, margin=1.2)
    seen = capture_backward_inputs(
        small, small_cam, RasterConfig(max_instances=mi, reduce="chain"), 1)
    check_blend(*seen["blend"], label="100k 512x512")
    check_blend_bwd(*seen["blend_bwd"], label="100k 512x512")
    check_prefix(*seen["prefix"], label="100k 512x512")
    del small, seen

    scene = make_scene(N_GAUSS, seed=0, device="cuda")
    cams = orbit_cams(WIDTH, HEIGHT, N_VIEWS, "cuda")
    mi, _ = suggest_budgets(scene, cams, margin=1.2)
    cfg = RasterConfig(max_instances=mi)
    log(f"[kernels] main-path budget max_instances={mi}")
    seen = capture_inputs(scene, cams[0], cfg)
    stats = {"gather": check_gather(*seen["gather"]),
             "blend": check_blend(*seen["blend"],
                                  label=f"1M {WIDTH}x{HEIGHT}")}
    del seen

    # ---- 4. main path: query ----
    gen = torch.Generator().manual_seed(0)
    decoder = SemanticDecoder.create(gen, dim_in=SEM_DIM, dim_out=TAB_LEN,
                                     device="cuda")
    rng = np.random.default_rng(2)
    lut = torch.as_tensor(rng.normal(0, 1, (TAB_LEN, APE_DIM))
                          .astype(np.float32), device="cuda")
    text = rng.normal(0, 1, APE_DIM).astype(np.float32)
    text /= np.linalg.norm(text)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.time()
        triplet.save(tmp, scene, decoder, lut)
        scene, decoder, lut = triplet.load(tmp, sem_dim=SEM_DIM,
                                           device="cuda")
        log(f"[main] triplet saved and loaded in {time.time() - t0:.1f} s "
            f"({scene.capacity} Gaussians, SH {scene.active_sh_degree}, "
            f"decoder {SEM_DIM}->{TAB_LEN}, LUT {tuple(lut.shape)})")
    sess = QuerySession(scene, decoder, lut, cfg, device="cuda")
    sess.set_text(text)
    sess.render_view(cams[0])           # warm-up, before the counts
    torch.cuda.synchronize()

    reset_counts()
    frame_ms = []
    for i in range(N_FRAMES):
        cam = cams[i % N_VIEWS]
        t0 = time.perf_counter()
        img = sess.render_view(cam)
        torch.cuda.synchronize()
        frame_ms.append((time.perf_counter() - t0) * 1e3)
        if img.shape != (HEIGHT, WIDTH, 3) or not np.isfinite(img).all():
            raise AssertionError(f"bad frame {img.shape}")
        if i >= N_VIEWS:
            continue
        with torch.no_grad():
            out = render(sess.scene, cam, sess.bg, cfg)
        torch.cuda.synchronize()
        slots, depth = int(out["num_slots"]), int(out["max_tile_depth"])
        if slots > cfg.max_instances:
            raise AssertionError(f"num_slots {slots} > {cfg.max_instances}")
        for k in ("render", "semantics", "depth", "alpha"):
            if not torch.isfinite(out[k]).all():
                raise AssertionError(f"non-finite {k}")
        log(f"[main] view: query frame {frame_ms[-1]:.1f} ms, "
            f"num_instances={int(out['num_instances'])} num_slots={slots}"
            f" <= {cfg.max_instances}, max_tile_depth={depth}")
    counts = read_counts()
    launches = {"gather": counts["gather"], "blend": counts["blend"]}
    if any(n for k, n in counts.items() if k not in launches):
        raise AssertionError(f"the query path ran another kernel: {counts}")
    p50, p95 = np.percentile(frame_ms, [50, 95])
    log(f"[main] {N_FRAMES} query frames + {N_VIEWS} renders at "
        f"{WIDTH}x{HEIGHT}: frame p50 {p50:.1f} ms, p95 {p95:.1f} ms, "
        f"max {max(frame_ms):.1f} ms; launches gather={launches['gather']}"
        f" blend={launches['blend']}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel was not launched: {launches}")
    profile(lambda: sess.render_view(cams[0]), "query frame")

    # small-input agreement: kernel path vs the oracle, and the whole
    # query frame on the card vs on the CPU (plain versions)
    tiny = make_scene(2000, seed=3, device="cuda")
    tcam = orbit_cams(96, 64, 1, "cuda", dist=4.0)[0]
    bg = torch.ones(3, device="cuda")
    with torch.no_grad():
        got = render(tiny, tcam, bg, RasterConfig(max_instances=1 << 15))
        ora = render(tiny, tcam, bg, RasterConfig(backend="reference"))
    for k in ("render", "semantics", "depth", "alpha"):
        e = float((got[k] - ora[k]).abs().max())
        if not torch.allclose(got[k], ora[k], rtol=TOL, atol=TOL):
            raise AssertionError(f"{k}: kernel path vs oracle {e}")
    tsess = QuerySession(tiny, decoder, lut,
                         RasterConfig(max_instances=1 << 15), device="cuda")
    csess = QuerySession(tiny, copy.deepcopy(decoder), lut,
                         RasterConfig(max_instances=1 << 15), device="cpu")
    for s in (tsess, csess):
        s.set_text(text)
    fg, fc = tsess.render_view(tcam), csess.render_view(tcam)
    e = float(np.abs(fg - fc).max())
    if not np.allclose(fg, fc, rtol=TOL, atol=TOL):
        raise AssertionError(f"query frame card vs CPU: {e}")
    log(f"[main] small scene: kernel path matches the oracle and the CPU "
        f"query frame (max diff {e:.2e})")
    del sess, tsess, csess, tiny

    # ---- 5. main path: distillation ----
    train_launches = train_phase(scene, cams, cfg, stats)
    small_train_check()
    launches = {k: launches.get(k, 0) + n for k, n in train_launches.items()}

    # ---- 6. main path: 2D->3D lifting ----
    trace_launches = trace_phase(scene, cams, cfg, stats)
    launches = {k: launches.get(k, 0) + trace_launches.get(k, 0)
                for k in set(launches) | set(trace_launches)}
    del scene

    # ---- 7. the micro-benchmark ----
    launches.update(micro_phase(stats))

    # ---- 8. kernels line, result ----
    kernels = [
        dict(name="monotone_gather", route="cuda",
             source="goi_tpu_torch/raster/csrc/gather.cu",
             replaces="goi_tpu/raster/gather.py:48",
             launches=launches["gather"], **stats["gather"]),
        dict(name="blend_fwd", route="cuda",
             source="goi_tpu_torch/raster/csrc/blend_fwd.cu",
             replaces="goi_tpu/raster/pallas_blend.py:832",
             launches=launches["blend"], **stats["blend"]),
        dict(name="blend_bwd", route="cuda",
             source="goi_tpu_torch/raster/csrc/blend_bwd.cu",
             replaces="goi_tpu/raster/pallas_blend.py:902",
             launches=launches["blend_bwd"], **stats["blend_bwd"]),
        dict(name="prefix", route="cuda",
             source="goi_tpu_torch/raster/csrc/prefix.cu",
             replaces="goi_tpu/raster/pallas_blend.py:245",
             launches=launches["prefix"], **stats["prefix"]),
        dict(name="trace", route="cuda",
             source="goi_tpu_torch/raster/csrc/trace.cu",
             replaces="goi_tpu/raster/pallas_blend.py:1106",
             launches=launches["trace"], **stats["trace"]),
        dict(name="prefix_boundary", route="cuda",
             source="goi_tpu_torch/raster/csrc/prefix_boundary.cu",
             replaces="goi_tpu/raster/pallas_blend.py:392",
             launches=launches["prefix_boundary"],
             **stats["prefix_boundary"]),
        dict(name="mono_rows", route="cuda",
             source="goi_tpu_torch/raster/csrc/mono_rows.cu",
             replaces="examples/micro_sortpayload.py:85",
             launches=launches["mono_rows"], **stats["mono_rows"]),
    ]
    if min(k["launches"] for k in kernels) <= 0:
        raise AssertionError(f"a kernel was not launched: {launches}")
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
