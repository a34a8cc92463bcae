#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (goi_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its lines; any failure raises and the script
exits non-zero without the final result line:

1. device: CUDA version, the card's name and power limit (nvidia-smi),
   nvcc, triton;
2. build: compile every CUDA kernel of the query path from
   goi_tpu_torch/raster/csrc (one nvcc per source, all at once);
3. kernel checks: each kernel against its plain PyTorch version on the
   card, on the inputs the main path gives it (the expansion gather
   bit-exact; the forward blend within atol = rtol = 5e-5 on a
   100k-Gaussian 512x512 frame and on the full frame), with times;
4. main path: a seeded 1,000,000-Gaussian scene (SH degree 3, 10
   semantic channels), a 10->300 decoder and a 300x256 LUT, saved as
   the PLY + pickle + LUT.npy triplet and loaded back; QuerySession
   answers 12 open-vocabulary query frames at 1296x968 over 3 orbit
   views, plus one render() per view; launch counts must be > 0; one
   more frame runs under torch.profiler (device busy share, top
   kernels); a small scene is checked against the oracle and the CPU
   path;
5. a JSON line with every ported kernel's launches, error, times and
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
TOL = 5e-5          # tests/test_pallas_blend.py's oracle tolerance
WIDTH, HEIGHT = 1296, 968
N_GAUSS = 1_000_000
SEM_DIM, APE_DIM, TAB_LEN = 10, 256, 300
N_VIEWS = 3
N_FRAMES = 12       # query frames on the main path, cycling the views


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


def capture_inputs(scene, cam, cfg):
    """Run one render and record the arguments the main path hands to
    each kernel wrapper (the wrappers themselves run as usual)."""
    import torch
    from goi_tpu_torch.raster import binning, cuda_blend
    from goi_tpu_torch.raster.render import render
    seen = {}
    orig = {"gather": binning.monotone_gather,
            "blend": cuda_blend.blend_fwd}

    def recorder(name):
        def rec(*args):
            seen[name] = args
            return orig[name](*args)
        # a wrapper counts on the module attribute it is called through,
        # so the launches of this capture land here and not in the counts
        rec.launches = 0
        return rec

    binning.monotone_gather = recorder("gather")
    cuda_blend.blend_fwd = recorder("blend")
    try:
        with torch.no_grad():
            render(scene, cam, torch.zeros(3, device=scene.device), cfg)
    finally:
        binning.monotone_gather = orig["gather"]
        cuda_blend.blend_fwd = orig["blend"]
    return seen


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


def profile_frame(sess, cam, top=12):
    """One query frame under torch.profiler: wall time, the device's
    busy and idle share, and the kernels that take the most device
    time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sess.render_view(cam)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    log(f"[profile] query frame {wall_ms:.2f} ms wall, device busy "
        f"{busy_ms:.2f} ms, idle share {1 - busy_ms / wall_ms:.3f}, "
        f"{sum(e.count for e in kernels)} device ops")
    kernels.sort(key=lambda e: -e.self_device_time_total)
    for e in kernels[:top]:
        log(f"[profile]   {e.self_device_time_total / 1e3:8.3f} ms "
            f"x{e.count:<4d} {e.key[:90]}")


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
    _nvcc.build(["gather", "blend_fwd"])
    log(f"[build] gather.cu + blend_fwd.cu in {time.time() - t0:.1f} s")

    from goi_tpu_torch.app.session import QuerySession
    from goi_tpu_torch.data import scene as triplet
    from goi_tpu_torch.raster.cuda_blend import blend_fwd
    from goi_tpu_torch.raster.gather import monotone_gather
    from goi_tpu_torch.raster.render import (RasterConfig, render,
                                             suggest_budgets)
    from goi_tpu_torch.semantic.codebook import SemanticDecoder

    # ---- 3. kernel checks at main-path shapes ----
    small = make_scene(100_000, seed=1, device="cuda")
    small_cam = orbit_cams(512, 512, 1, "cuda")[0]
    mi, _ = suggest_budgets(small, small_cam, margin=1.2)
    seen = capture_inputs(small, small_cam, RasterConfig(max_instances=mi))
    check_blend(*seen["blend"], label="100k 512x512")
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

    # ---- 4. main path ----
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

    monotone_gather.launches = 0
    blend_fwd.launches = 0
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
    launches = {"gather": monotone_gather.launches,
                "blend": blend_fwd.launches}
    p50, p95 = np.percentile(frame_ms, [50, 95])
    log(f"[main] {N_FRAMES} query frames + {N_VIEWS} renders at "
        f"{WIDTH}x{HEIGHT}: frame p50 {p50:.1f} ms, p95 {p95:.1f} ms, "
        f"max {max(frame_ms):.1f} ms; launches gather={launches['gather']}"
        f" blend={launches['blend']}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel was not launched: {launches}")
    profile_frame(sess, cams[0])

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

    # ---- 5. kernels line, result ----
    kernels = [
        dict(name="monotone_gather", route="cuda",
             source="goi_tpu_torch/raster/csrc/gather.cu",
             replaces="goi_tpu/raster/gather.py:48",
             launches=launches["gather"], **stats["gather"]),
        dict(name="blend_fwd", route="cuda",
             source="goi_tpu_torch/raster/csrc/blend_fwd.cu",
             replaces="goi_tpu/raster/pallas_blend.py:832",
             launches=launches["blend"], **stats["blend"]),
    ]
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
