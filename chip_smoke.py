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
   card, on the inputs the main paths give it, with times: the fused
   expansion gather (slot -> Gaussian search + gather) bit-exact against
   scatter + cummax + gather, beside torch.index_select on the same
   (table, g_stream), and monotone_gather bit-exact on that stream; the
   forward blend within atol = rtol = 5e-5 on a 100k-Gaussian 512x512
   frame and on the full frame, with the share of walked pairs that its
   per-warp cull keeps (the cull's plain twin, blend.block_cull_plain,
   on the card); the blend backward and the block prefix
   on that 100k frame's backward here and on a full-width training
   step's in phase 5 (tolerances at TOL_BWD and TOL_PREFIX; the prefix
   also bit for bit against prefix_boundary's read-out of every row,
   timed beside a device-to-device copy of its rows, the ceiling of a
   kernel that reads and writes as many bytes), and there
   the block owners' sums (owner_sums, the prefix's read-out at the
   bounds plus each segment's whole blocks) bit-exact against their
   plain version in both read-out forms, beside torch.segment_reduce;
   the preprocess kernel (csrc/preprocess.cu) bit for bit against its
   plain version, the composition, in every Splats field at scannet's
   1M Gaussians (the main-path scene and frame) and garden's 5.8M (the
   m360-garden cell's scene and view), with its time in a run of calls,
   its own device time, the composition's time and the bytes bound;
   the distillation loss's row kernel (csrc/distill_loss.cu, between
   two fp32 GEMMs) forward and backward against the composition at
   both distillation cells' pixel counts (against the composition in
   float64: terms rtol 1e-5, gradients no further off than twice the
   fp32 composition, two runs bit for bit), timed beside the
   composition and the GEMMs' flop bound, with its top device kernels;
4. [main] the query path: a seeded 1,000,000-Gaussian scene (SH degree
   3, 10 semantic channels), a 10->300 decoder and a 300x256 LUT, saved
   as the PLY + pickle + LUT.npy triplet and loaded back; QuerySession
   answers 12 open-vocabulary query frames at 1296x968 over 3 orbit
   views, plus one render() per view; the forward kernels' launch
   counts must be > 0; one more frame runs under torch.profiler
   (device busy share, top kernels; every profiled run fails if the
   plain expansion's cummax or scatter ran); a small scene is checked
   against the oracle and the CPU path;
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
   view (hit counts exact, rows within TOL_TRACE, its raw output
   bit-identical to blend_fwd's on the same inputs), trace's render
   against render()'s within 1e-5, num_gsem a multiple of 10 with hits,
   a small scene's trace on the card against the CPU; p50/p95 wall time
   and one profiled call;
6a. [dist1] distribution on one card, a single-rank NCCL group:
   render_sharded with the 'gather' and the 'rows' exchange (its cap
   from a lossless probe) on the same scene and view against render()
   (within 3e-5; bit-equality reported),
   their gradients (every attribute) within the flip budget of
   tests/test_sharded_render.py and bit-identical over two passes, and
   one make_sharded_distill_step step on the (1, 1) mesh against
   train_step (loss terms rtol 1e-5, gradients at GRAD_TOL, the updated
   parameters equal where the gradient is past its atol); the launches
   are counted in two windows that hold no reference call, the sharded
   renders' and the sharded step's, and each must show gather, blend,
   blend_bwd, prefix and owner_sums;
7. [widths] the blend, backward and trace kernels at semantic widths
   1, 12, 33, 64 (S_MAX; widths between the kernels' instances run
   padded to the next one), 65, 117 and 128 (in channel groups of
   S_MAX, each group bit-identical to a lone run of its channels, one
   launch a group) and the trace at lift widths 32, 33, 65 and 127
   (SA_MAX), on a seeded 100k-Gaussian scene at 1296x968, each against
   its plain version (counts exactly), and S = 10 padded to the next
   instance bit-identical to the native one, with times;
8. [micro] the micro-benchmark (goi_tpu_torch/examples/micro_sortpayload.py)
   at its default sizes; the mono row gather bit-exact against its
   plain version and timed beside torch.index_select;
9. [cli] the port's entry points on a scene from disk: a 4-view
   1296x968 COLMAP scene (the seeded 1M-Gaussian scene's renders plus
   noise, float16 256-dim feature maps, the scene as iteration 1) in a
   temporary directory, then python -m goi_tpu_torch.train (10 steps),
   .render, .metrics, query masks through QuerySession and .eval_seg,
   each CLI's wall and load/compute seconds, the train steps' p50 and
   the bytes written; it fails if a CLI exits non-zero, the triplet does
   not reload, the PSNR is not finite or <= 25 dB or the mIoU is outside
   [0, 1];
10. [rgb] RGB training at full width: the main-path scene's renders of
   RGB_VIEWS orbit views (the last held out), train_rgb for RGB_ITERS
   steps from every second GT Gaussian's xyz plus noise at a capacity
   with no free row; before it, one step's gradients (7 attributes and
   mean2d) bit-identical over two backward passes and with
   dense_reduce=True, and a small scene's step on the card against the
   CPU at GRAD_TOL; it fails on a non-finite loss or gnorm, no capacity
   growth, a held-out PSNR that does not rise, or a step past its
   budget with no rebudget in its own or the next iteration; step
   p50/p95, densify and grow_capacity times, regrowths, rebudgets,
   n_valid and capacity, peak memory, PSNR, one profiled step;
11. [pipeline] python -m goi_tpu_torch.examples.full_pipeline_demo
   --fast as a subprocess: PIPELINE COMPLETE, finite PSNR, mIoU and OSH
   IoU, its stage seconds and kernel launches;
12. [app] the interactive query app at full width (goi_tpu_torch/viewer)
   on its own seeded copy of the 1M scene, where APP_NEAR Gaussians in
   a ball before the group view and APP_FAR far above every view carry
   one code: QueryWebApp over localhost HTTP (the page revokes its
   object URLs; APP_FRAMES frames each of jpeg and png at 1296x960 and
   the 640x480 preview; a prompt from a .npz store through the seeded
   aligner; the retrieval exactly the designed groups; DBSCAN grouping
   at the GUI's defaults keeping exactly the on-screen group; the
   edits, reset bit for bit, finetune, delete_perm by exactly the
   matched count), dbscan on the card torch.equal to dbscan_plain on a
   subsample with shared border points, a camera path and the video op
   (when cv2 or imageio imports), render_batch torch.equal to single
   renders, RasterConfig(debug=True)'s dump, and python -m
   goi_tpu_torch.viewer as a subprocess, its SIBR frame equal to
   render_view's;
13. [export] geometry export at full width (goi_tpu_torch/export) on
   its own seeded scene of 1,000,000 Gaussians on the unit sphere (red
   above y = 0, blue below): the density grid kernel at 128^3 (timed,
   held against its plain version on 4096 seeded points and on a 10k
   scene's whole 32^3 grid), extract_textured_mesh with its defaults
   (its grid, marching and bake stages timed; the bake renders 26 orbit
   views at 512x512 through the gather and blend kernels), marching on
   the card equal to marching on the CPU, the shell's mesh watertight
   with Euler characteristic 4, radii in its band and oriented toward
   the lower density, the hemispheres baked red and blue, and the OBJ
   (+ MTL + PNG), colored point cloud and ellipsoid writers;
14. [towers] the frozen towers at full width with seeded random weights
   (the EVA02-CLIP-bigE-14-plus text tower, GroundingDINO Swin-T +
   BERT-base, SAM ViT-H; synthetic BPE and BERT vocabularies): each
   tower at reduced depth on the card against the CPU within TOL_TOWER;
   then behind QueryWebApp on a seeded 1M scene, a prompt through the
   tokenizer, the tower and the aligner into set_text (bit for bit
   encode_and_align's), a frame, and the OSH finetune with no client
   mask, its mask from res_fn = TorchRESProvider.predict_mask on the
   rendered view (exactly TOWER_BOXES boxes reach SAM; the mask has the
   view's shape, is not empty and is the same on a second run); the
   prompt, GroundingDINO, one encoder layer's ms_deform_attn_core, SAM
   set_image and decode, and res_fn times and the peak memory;
15. [edit] SDS guidance and the query app's edit session at full width:
   the SD-1.5-inpainting UNet + VAE (943M parameters, seeded, their
   state_dict the checkpoint's manifest), the UNet at reduced depth and
   the VAE on the card against the CPU within TOL_SD; QueryWebApp with an
   EditSession(InpaintSDS(TorchDiffusionBackend)) on the [app] scene:
   edit_precompute over EDIT_NEAR + EDIT_AWAY orbit views at 1296x968
   (exactly the EDIT_NEAR near views relative, grad_mask exactly the
   designed groups), edit_train for EDIT_EPOCHS epochs at batch 2 (every
   loss finite, only target Gaussians changed, num_valid kept, the app's
   frame showing the edit, the gather, blend, blend_bwd and prefix
   kernels launched), the UNet, VAE encode + backward, SDS step and edit
   step times, the peak memory and one profiled step;
16. a JSON line with every ported kernel's launches (those of the CLIs',
   the demo's and the viewer's processes included), error, times and
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
                  "prefix_boundary", "mono_rows", "density_grid",
                  "owner_sums", "preprocess", "distill_loss")
# the loss kernel's check: both distillation cells' frames (scannet-1m's
# is WIDTH x HEIGHT)
LOSS_FRAMES = (("scannet", 1296, 968), ("garden", 1297, 840))
# the preprocess kernel's check: garden's Gaussian count (the
# m360-garden cell), beside the main path's N_GAUSS (scannet's)
GARDEN_GAUSS = 5_800_000
# [widths]: semantic widths between and at the kernels' instances (S_MAX
# = 64 the widest), past it in channel groups (65, 117 = the pallas
# blend's widest, 128), lift widths past one warp's 32 lanes (127 =
# SA_MAX), on a WIDTHS_GAUSS-Gaussian scene at the full frame; S = 10
# and sa = 11, the main path's, as the yardstick
WIDTHS_S = (1, 10, 12, 33, 64, 65, 117, 128)
WIDTHS_SA = (11, 32, 33, 65, 127)
WIDTHS_GAUSS = 100_000
# [cli]: a COLMAP scene on disk of CLI_VIEWS views (llffhold 8: view 0 is
# the test view, the others train), images with seeded noise of sigma
# CLI_NOISE (so the PSNR of a perfect render is finite, ~34 dB), trained
# for CLI_ITERS steps; masks of CLI_PROTOS prototypes on the test view
CLI_VIEWS = 4
CLI_ITERS = 10
CLI_NOISE = 0.02
CLI_PROTOS = 2
CLI_SFM_POINTS = 5000
CLI_MIN_PSNR = 25.0
# [rgb]: RGB training from RGB_VIEWS - 1 renders of the main-path scene
# (the last view held out), started from every second GT Gaussian's xyz
# plus N(0, RGB_NOISE) noise at a capacity with no free row, so that the
# first densify overflows and the capacity grows; the schedule below
RGB_VIEWS = 4
RGB_NOISE = 0.02
RGB_ITERS = 150
RGB_SCHEDULE = dict(densify_from_iter=20, densification_interval=20,
                    densify_until_iter=120, opacity_reset_interval=100,
                    position_lr_max_steps=RGB_ITERS)
# [app]: the query app on the main-path scene's own seeded copy: APP_NEAR
# Gaussians uniform in a ball of radius APP_BALL, APP_BALL_DIST toward
# the group view APP_VIEW (~1e4 neighbours within APP_EPS each), and
# APP_FAR around (0, APP_FAR_Y, 0), above every view, carry one code;
# DBSCAN at the GUI's defaults; its check on APP_CHECK = (points, eps,
# min_samples), a subsample where clusters share border points; frames
# at bench.py's orbit (elevation 0, azimuth 137 i, radius 3.5, fovy 50);
# a path through anchors at APP_PATH[0] azimuths, APP_PATH[1] steps each
APP_NEAR, APP_FAR = 100_000, 50_000
APP_BALL, APP_BALL_DIST, APP_FAR_Y = 0.75, 2.2, 40.0
APP_VIEW = dict(elev=-10.0, azim=30.0, radius=3.5)
APP_EPS, APP_MIN_SAMPLES = 0.35, 600
APP_CHECK = (30_000, 0.1, 55)
APP_FRAMES = 12
APP_PATH = ((0.0, 40.0, 80.0), 10)
APP_OSH_EPOCHS = 300
# tests/test_torch_train.py's GRAD_TOL (rtol, atol): a small scene's RGB
# step on the card against the CPU's
GRAD_TOL = (2e-3, 2e-4)
# [dist1]: the sharded render against render(), the flip budget of
# tests/test_sharded_render.py's chunked gradient test (at most
# FLIP_SHARE of the elements past FLIP_TOL[0] + FLIP_TOL[1] |a|, none past
# FLIP_MAX)
TOL_DIST_FRAME = 3e-5
FLIP_SHARE, FLIP_TOL, FLIP_MAX = 0.005, (5e-7, 2e-4), 5e-5
# [export]: its own seeded scene, N_GAUSS Gaussians on the unit sphere
# (isotropic scales uniform in EXPORT_SCALES, opacity EXPORT_OPACITY, DC
# red above y = 0, blue below), exported by extract_textured_mesh's
# defaults (EXPORT_RES^3 grid, density_thresh 1.0: a shell ~6 voxels
# thick, two nested spheres near r = 0.95 and 1.05); the density kernel
# checked on EXPORT_CHECK[0] seeded points of that grid and on the whole
# EXPORT_CHECK[2]^3 grid of an EXPORT_CHECK[1]-Gaussian copy, within
# TOL_DENSITY of the grid's peak (float32 sums in another order,
# ex2.approx against exp2); every vertex radius in EXPORT_BAND; at least
# EXPORT_COLOUR of each hemisphere's outer faces baked in its colour
EXPORT_SCALES = (0.012, 0.018)
EXPORT_OPACITY = 0.95
EXPORT_RED, EXPORT_BLUE = (0.9, 0.1, 0.1), (0.1, 0.1, 0.9)
EXPORT_RES = 128
EXPORT_CHECK = (4096, 10_000, 32)
EXPORT_BAND = (0.9, 1.1)
EXPORT_COLOUR = 0.95
TOL_DENSITY = 1e-5
# float32 operations of the density kernel a pair: dz, the dz
# polynomial's two multiply-adds and the accumulate, and the shared
# per-Gaussian terms over a thread's 8 points
OPS_DENSITY = 8
# [towers]: the frozen towers at full width with seeded random weights
# (EVA02-CLIP-bigE-14-plus text, GroundingDINO Swin-T + BERT-base, SAM
# ViT-H) behind the query app's text_fn and res_fn; synthetic vocab
# assets (a BPE merge table of TOWER_MERGES, make_test_vocab of
# TOWER_WORDS). The box threshold is halfway between the TOWER_BOXES-th
# and the next detector score of the seeded run, so that many boxes reach
# SAM. Card against CPU at reduced depth (TOWER_CHECK_DEPTH: text layers,
# SAM blocks with the last one global, GroundingDINO encoder = decoder
# layers), each output within TOL_TOWER (rtol, atol relative to the
# peak) of the CPU's: float32 on both, GEMMs summed in another order
# through up to 12 Swin and 12 BERT blocks. The decoder's final norm is
# scaled to 1/16 so that the contrastive logits of two random unit-
# variance 256-d vectors have unit scale, as a trained head's calibrated
# scores do, rather than saturating the sigmoid at 1.0
TOWER_PROMPT = "the red chair"
TOWER_WORDS = ("the", "red", "chair", "a", "blue", "sofa", "near", "lamp")
TOWER_MERGES = ("t h", "th e</w>", "r e", "re d</w>", "c h", "a i",
                "ch ai", "chai r</w>", "s o", "so f", "sof a</w>", "b l",
                "bl u", "blu e</w>")
TOWER_BOXES = 4
TOWER_CHECK_DEPTH = 2, 2, 1
TOL_TOWER = (1e-3, 1e-4)
TOWER_LOGIT_SCALE = 1.0 / 16
# [edit]: the SDS edit session (goi_tpu_torch/app/edit.py) at full width:
# the SD-1.5-inpainting UNet + VAE at the SDConfig() defaults (943M
# parameters, float32, TF32 off) with seeded weights, behind QueryWebApp
# on the [app] scene (app_scene: a 100k ball and 50k far Gaussians of one
# code). The edit cameras are EDIT_NEAR orbit views at 1296x968 around the
# group view, where the ball fills most of the frame, and EDIT_AWAY views
# from the far side at radius EDIT_AWAY_R, where it is a few percent of
# the frame behind the central cloud: exactly EDIT_NEAR views pass
# precompute's min_relative_ratio of 0.1. EDIT_EPOCHS epochs at batch 2,
# then EDIT_TIMED more steps for the step time. Card against CPU at
# reduced depth (EDIT_CHECK_UNET: the UNet's first two blocks at their
# full widths 320 and 640, 768 cross-attention, 8 heads, on 64x64
# latents; the whole VAE on EDIT_CHECK_IMG^2 images) within TOL_SD (rtol,
# atol of the peak; float32 on both, convolutions and GEMMs summed in
# another order)
EDIT_NEAR, EDIT_AWAY, EDIT_AWAY_R = 6, 4, 6.0
EDIT_EPOCHS = 3
EDIT_TIMED = 6
EDIT_CHECK_UNET = dict(block_out_channels=(320, 640))
EDIT_CHECK_IMG = 128
TOL_SD = (1e-3, 1e-4)


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


def run_ms(fn, iters=20):
    """Device ms a call over a run of back-to-back calls between two CUDA
    events (after one warm-up): the host's launch gaps hide behind the
    calls before them."""
    import torch
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def device_ms(fn, kernel, iters=10):
    """Mean device ms a call of the kernels whose name holds `kernel`,
    over iters calls of fn() under torch.profiler: the kernel's own time,
    without the host's launch, which CUDA events around a call include
    when the card waits for it."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile
    fn()
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and kernel in e.key) / 1e3 / iters


def make_scene(n, seed, device, sem_dim=SEM_DIM):
    """Seeded synthetic scene at the published widths (SH degree 3,
    10 semantic channels), like the JAX package's bench scene."""
    import torch
    from goi_tpu_torch.core.scene import GaussianScene
    rng = np.random.default_rng(seed)
    scene = GaussianScene.create(
        rng.normal(0, 1.0, (n, 3)).astype(np.float32),
        rng.uniform(0, 1, (n, 3)).astype(np.float32),
        sh_degree=3, sem_dim=sem_dim,
        scales=rng.uniform(0.005, 0.02, n).astype(np.float32),
        device=device)

    def t(a):
        return torch.as_tensor(a.astype(np.float32), device=device)

    return scene.replace(
        active_sh_degree=3,
        opacity=scene.opacity + t(rng.normal(0, 1, (n, 1))),
        rotation=t(rng.normal(0, 1, (n, 4))),
        features_rest=t(0.05 * rng.normal(0, 1, (n, 15, 3))),
        semantics=t(rng.normal(0, 0.3, (n, sem_dim))))


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
    wrapper (the last call of each, keyword arguments after the
    positional ones in the order given; the wrappers themselves run as
    usual)."""
    import importlib
    import torch
    from goi_tpu_torch.raster import binning, cuda_blend, reduce
    # the module (the package re-exports its function `render`)
    render_mod = importlib.import_module("goi_tpu_torch.raster.render")
    sites = {"gather": (binning, "expand_gather"),
             "blend": (cuda_blend, "blend_fwd"),
             "blend_bwd": (cuda_blend, "blend_bwd"),
             "prefix": (reduce, "prefix_blocks"),
             "trace": (render_mod, "trace_fwd"),
             "prefix_boundary": (reduce, "prefix_boundary"),
             "owner_sums": (reduce, "owner_sums")}
    orig = {k: getattr(mod, attr) for k, (mod, attr) in sites.items()}
    seen = {}

    def recorder(name):
        def rec(*args, **kw):
            seen[name] = tuple(a.detach() if torch.is_tensor(a) else a
                               for a in args + tuple(kw.values()))
            return orig[name](*args, **kw)
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


def garden_scene(n, seed, device):
    """The m360-garden cell's scene: positions N(0, (1.6, 0.5, 1.6)),
    isotropic scales 0.004-0.016, opacity logit(0.1) + N(0, 1), SH
    degree 3 with rest coefficients N(0, 0.05)."""
    import torch
    from goi_tpu_torch.core.scene import GaussianScene
    gen = torch.Generator(device=device).manual_seed(seed)

    def rnd(*s):
        return torch.randn(s, generator=gen, device=device)

    scale = 0.004 + 0.012 * torch.rand(n, 1, generator=gen, device=device)
    return GaussianScene(
        xyz=rnd(n, 3) * torch.tensor([1.6, 0.5, 1.6], device=device),
        features_dc=0.5 * rnd(n, 1, 3), features_rest=0.05 * rnd(n, 15, 3),
        semantics=0.3 * rnd(n, SEM_DIM),
        scaling=torch.log(scale).expand(n, 3).contiguous(),
        rotation=rnd(n, 4), opacity=math.log(0.1 / 0.9) + rnd(n, 1),
        valid=torch.ones(n, dtype=torch.bool, device=device),
        active_sh_degree=3, max_sh_degree=3)


def garden_cam(device):
    """A view of the m360-garden cell: 1297x840, fovx 1.03, on the circle
    of radius 4 at height 1.5, looking at the origin."""
    from goi_tpu_torch.core.camera import Camera, focal2fov, fov2focal
    fovy = focal2fov(fov2focal(1.03, 1297), 840)
    return Camera.look_at([4.0 * math.sin(0.7), 1.5, -4.0 * math.cos(0.7)],
                          [0, 0, 0], [0, 1, 0], 1.03, fovy, 1297, 840,
                          device=device)


def preprocess_bytes(scene) -> int:
    """The preprocess kernel's bytes: each input row read once (xyz,
    scaling, rotation, opacity, SH, valid), each output written once
    (mean2d, depth, conic, opacity, colour, radius, two rects, tiles,
    cell_sel in 4-byte words, valid in one byte)."""
    rest = scene.features_rest.shape[1]
    read = 4 * (3 + 3 + 4 + 1 + 3 + 3 * rest) + 1
    written = 4 * (2 + 1 + 3 + 1 + 3 + 1 + 2 + 2 + 1 + 2) + 1
    return scene.capacity * (read + written)


def same_bits(a, b) -> bool:
    """Equal dtype and shape, NaN at the same places, every other element
    bit for bit."""
    import torch
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if not a.is_floating_point():
        return torch.equal(a, b)
    na, nb = torch.isnan(a), torch.isnan(b)
    return torch.equal(na, nb) and torch.equal(
        torch.where(na, 0.0, a).view(torch.int32),
        torch.where(nb, 0.0, b).view(torch.int32))


def preprocess_phase() -> dict:
    """The preprocess kernel against its plain version at scannet's 1M
    Gaussians (the main-path scene, 1296x968) and garden's 5.8M (the
    m360-garden cell's scene and view): every Splats field bit for bit;
    ms: a call in a run of calls (dispatch included); kernel_ms: the
    kernel's own device time (profiler); plain_ms: the composition's
    median call; bound_ms: preprocess_bytes at PEAK_BYTES_PER_S. Returns
    the kernels line's figures (garden's, and scannet's with _1m)."""
    import dataclasses
    import importlib
    import torch
    pre = importlib.import_module("goi_tpu_torch.raster.preprocess")
    stats = {}
    for label, n in (("1m", N_GAUSS), ("5.8m", GARDEN_GAUSS)):
        if n == N_GAUSS:
            scene = make_scene(n, seed=0, device="cuda")
            cam = orbit_cams(WIDTH, HEIGHT, 1, "cuda")[0]
        else:
            scene = garden_scene(n, seed=0, device="cuda")
            cam = garden_cam("cuda")
        with torch.no_grad():
            got = pre.preprocess(scene, cam)
            want = pre.preprocess_plain(scene, cam)
            bad = [f.name for f in dataclasses.fields(want)
                   if not same_bits(getattr(got, f.name),
                                    getattr(want, f.name))]
            if bad:
                raise AssertionError(f"[kernels] preprocess {label}: the "
                                     f"kernel differs from its plain "
                                     f"version in {bad}")
            del got, want
            ms = run_ms(lambda: pre.preprocess(scene, cam))
            kernel_ms = device_ms(lambda: pre.preprocess(scene, cam),
                                  "preprocess_kernel")
            plain_ms = median_ms(lambda: pre.preprocess_plain(scene, cam),
                                 iters=5)
        bound_ms = preprocess_bytes(scene) / PEAK_BYTES_PER_S * 1e3
        log(f"[kernels] preprocess {label} ({n} Gaussians, "
            f"{cam.width}x{cam.height}): bit-identical to the composition "
            f"in every field; {ms:.4f} ms a call in a run, kernel "
            f"{kernel_ms:.4f} ms, bound {bound_ms:.4f} ms (bytes), "
            f"composition {plain_ms:.3f} ms")
        sfx = "" if n == GARDEN_GAUSS else "_" + label
        stats.update({f"ms{sfx}": round(ms, 4),
                      f"kernel_ms{sfx}": round(kernel_ms, 4),
                      f"bound_ms{sfx}": round(bound_ms, 4),
                      f"plain_ms{sfx}": round(plain_ms, 3)})
        del scene
        torch.cuda.empty_cache()
    return stats


def device_top(fn, iters=5, top=6):
    """[(kernel name, device ms a call)] of fn's heaviest device kernels
    over iters calls under torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile
    fn()
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    rows = sorted(((e.key, e.self_device_time_total / 1e3 / iters)
                   for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA),
                  key=lambda r: -r[1])
    return [(k[:70], round(ms, 4)) for k, ms in rows[:top]]


def loss_argmax_slack(dec, lut, sem) -> float:
    """What recc's gradient to the LUT may differ by where the kernel's
    logits and PyTorch's, a rounding apart, pick another code: 2 / (P
    min |L_k|) (a pixel's alpha gtl and beta L at two codes) for each
    pixel whose two largest probabilities lie within 4e-6 of each other
    (the rule of the card tests' _argmax_slack)."""
    import torch
    with torch.no_grad():
        top = torch.topk(torch.softmax(dec(sem), dim=1), 2, dim=1).values
        near = int((top[:, 0] - top[:, 1] <= 4e-6 * top[:, 0]).sum())
        return near * 2.0 / (sem.shape[0] * float(lut.norm(dim=1).min()))


def loss_phase() -> dict:
    """The distillation loss's row path (semantic/losses.py
    distillation_loss on CUDA tensors: csrc/distill_loss.cu between two
    fp32 GEMMs) at each LOSS_FRAMES frame, 300 codes x 256 channels, the
    10 -> 300 decoder, seeded maps read through the callers' (P, C)
    views: forward and backward against the fp32 composition on the
    same inputs (distillation_loss_plain; each gradient within 1e-4 of
    its peak, the LUT's also within loss_argmax_slack) and against the
    composition in float64 (terms rtol 1e-5, each gradient's error of its
    peak at most twice the fp32 composition's, or 1e-5), the kernel path
    twice bit for bit; ms: forward and
    backward in a run of calls; plain_ms: the composition's; bound_ms:
    the two GEMMs' 4 P K C flops at PEAK_FP32_PER_S; bytes_ms: the rows
    read and written once, g and the features read once, at
    PEAK_BYTES_PER_S. Returns the kernels line's figures (garden's, and
    scannet's with _scannet) and the launches."""
    import importlib
    import torch
    from goi_tpu_torch.semantic.codebook import SemanticDecoder
    L = importlib.import_module("goi_tpu_torch.semantic.losses")
    stats = {}
    before = L.loss_rows_cuda.launches
    for label, w, h in LOSS_FRAMES:
        p = w * h
        gen = torch.Generator().manual_seed(31)
        dec = SemanticDecoder.create(gen, dim_in=SEM_DIM, dim_out=TAB_LEN,
                                     device="cuda")
        cgen = torch.Generator(device="cuda").manual_seed(31)
        lut = torch.randn((TAB_LEN, APE_DIM), generator=cgen,
                          device="cuda").requires_grad_()
        sem_map = torch.randn((SEM_DIM, h, w), generator=cgen,
                              device="cuda").requires_grad_()
        gt = torch.randn((APE_DIM, h, w), generator=cgen,
                         device="cuda").reshape(APE_DIM, -1).T
        leaves = [lut, sem_map, *dec.parameters()]

        def run(fn):
            for t in leaves:
                t.grad = None
            total, aux = fn(dec, lut, sem_map.reshape(SEM_DIM, -1).T, gt,
                            1.0)
            total.backward()
            return aux

        def grads():
            return [t.grad.clone() for t in leaves]

        got = run(L.distillation_loss)
        g1 = grads()
        again = run(L.distillation_loss)
        if not (all(torch.equal(a, b) for a, b in zip(g1, grads()))
                and all(torch.equal(got[k], again[k]) for k in got)):
            raise AssertionError(f"[kernels] distill_loss {label}: two "
                                 f"runs differ")
        comp = run(L.distillation_loss_plain)
        g_comp = grads()
        slack = loss_argmax_slack(dec, lut, sem_map.reshape(SEM_DIM, -1).T)
        # the yardstick: the composition in float64
        dec64 = copy.deepcopy(dec).double()
        x64 = [t.detach().double().requires_grad_() for t in (lut, sem_map)]
        t64, aux64 = L.distillation_loss_plain(
            dec64, x64[0], x64[1].reshape(SEM_DIM, -1).T, gt.double(), 1.0)
        t64.backward()
        g64 = [x64[0].grad, x64[1].grad,
               *[q.grad for q in dec64.parameters()]]
        names = ["lut", "sem", *[n for n, _ in dec.named_parameters()]]
        errs = {}
        for name, a, c, r in zip(names, g1, g_comp, g64):
            peak = float(r.abs().max())
            errs[name] = (float((a.double() - r).abs().max()) / peak,
                          float((c.double() - r).abs().max()) / peak,
                          float((a - c).abs().max()) / peak)
        for k in aux64:
            ref = float(aux64[k].detach())
            if not (math.isclose(float(got[k].detach()), ref, rel_tol=1e-5,
                                 abs_tol=1e-7)
                    and math.isclose(float(comp[k].detach()), ref, rel_tol=1e-5,
                                     abs_tol=1e-7)):
                raise AssertionError(
                    f"[kernels] distill_loss {label}: {k} {float(got[k])} "
                    f"(composition {float(comp[k])}) vs float64 {ref}")
        worst = max(e[2] for e in errs.values())
        off = {n: (float((a - c).abs().max()), float(c.abs().max()))
               for n, a, c in zip(names, g1, g_comp)}
        off = {n: e for n, e in off.items()
               if e[0] > 1e-4 * e[1] + (slack if n == "lut" else 0.0)}
        if off:
            raise AssertionError(f"[kernels] distill_loss {label}: gradients "
                                 f"off the fp32 composition's by more than "
                                 f"1e-4 of their peak (the LUT's slack "
                                 f"{slack:.3e}; error, peak): {off}")
        bad = {n: e for n, e in errs.items() if e[0] > max(2 * e[1], 1e-5)}
        if bad:
            raise AssertionError(f"[kernels] distill_loss {label}: gradients "
                                 f"off float64 by more than twice the "
                                 f"composition's (kernel, composition, of "
                                 f"the peak): {bad}")
        log(f"[kernels] distill_loss {label}: gradients' error of the peak "
            f"against the float64 composition (kernel path, fp32 "
            f"composition) and the kernel path's against the fp32 "
            f"composition: " + ", ".join(f"{n} {a:.2e} {c:.2e} {d:.2e}"
                                         for n, (a, c, d) in errs.items()))
        del g1, g_comp, g64, x64, dec64, t64, comp, got, again
        ms = run_ms(lambda: run(L.distillation_loss), iters=10)
        plain_ms = run_ms(lambda: run(L.distillation_loss_plain), iters=3)
        top = device_top(lambda: run(L.distillation_loss))
        bound_ms = 4 * p * TAB_LEN * APE_DIM / PEAK_FP32_PER_S * 1e3
        bytes_ms = 4 * (2 * p * TAB_LEN + p * APE_DIM + 2 * p * SEM_DIM) \
            / PEAK_BYTES_PER_S * 1e3
        log(f"[kernels] distill_loss {label} ({p} pixels x {TAB_LEN} codes "
            f"x {APE_DIM} channels, S={SEM_DIM}): terms within 1e-5 of "
            f"the float64 composition's, gradients within {worst:.2e} of "
            f"their peak of the fp32 composition's (LUT slack "
            f"{slack:.2e}), bit-identical over two "
            f"runs; forward + "
            f"backward {ms:.3f} ms in a run, bound {bound_ms:.3f} ms "
            f"(flops; bytes {bytes_ms:.3f} ms), composition "
            f"{plain_ms:.3f} ms; top device kernels {top}")
        sfx = "" if label == "garden" else "_" + label
        stats.update({f"ms{sfx}": round(ms, 3),
                      f"bound_ms{sfx}": round(bound_ms, 3),
                      f"bytes_ms{sfx}": round(bytes_ms, 3),
                      f"plain_ms{sfx}": round(plain_ms, 3),
                      f"grad_err{sfx}": float(f"{worst:.3e}")})
        del dec, lut, sem_map, gt, leaves
        torch.cuda.empty_cache()
    stats["launches"] = L.loss_rows_cuda.launches - before
    return stats


def check_gather(table, base, m):
    """The fused expansion gather against its plain version (scatter +
    cummax + gather) bit for bit, and monotone_gather on its g_stream;
    torch.index_select on the same (table, g_stream) is the yardstick."""
    import torch
    from goi_tpu_torch.raster.gather import (expand_gather,
                                             expand_gather_plain,
                                             monotone_gather)
    g, rows = expand_gather(table, base, m)
    ref_g, ref_rows = expand_gather_plain(table, base, m)
    mono = monotone_gather(table, g)
    torch.cuda.synchronize()
    if not torch.equal(g, ref_g) or not torch.equal(
            rows.view(torch.int32), ref_rows.view(torch.int32)):
        raise AssertionError("expand_gather differs from its plain version")
    if not torch.equal(mono.view(torch.int32), rows.view(torch.int32)):
        raise AssertionError("monotone_gather differs from table[:, idx]")
    del ref_g, ref_rows, mono
    ms = median_ms(lambda: expand_gather(table, base, m))
    plain_ms = median_ms(lambda: expand_gather_plain(table, base, m))
    lib_ms = median_ms(lambda: torch.index_select(table, 1, g))
    mono_ms = median_ms(lambda: monotone_gather(table, g))
    nbytes = (4 * table.numel() + 8 * base.numel() + 4 * g.numel()
              + 4 * rows.numel())
    bound_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    log(f"[kernels] gather C={table.shape[0]} N={table.shape[1]} M={m}: "
        f"g_stream and rows bit-exact, monotone_gather bit-exact; fused "
        f"expand_gather {ms:.4f} ms, plain (scatter + cummax + gather) "
        f"{plain_ms:.4f} ms, index_select on (table, g_stream) "
        f"{lib_ms:.4f} ms, monotone_gather {mono_ms:.4f} ms, bound "
        f"{bound_ms:.4f} ms (bytes)")
    return dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by="bytes", library_ms=lib_ms)


def cull_kept_pairs(feat, starts, ends, grid_x, raw, chunk=1 << 18):
    """Walked pixel x instance pairs that the blend kernels' per-warp cull
    keeps, by its plain twin (blend.block_cull_plain) on the card: the
    instance at offset k of its tile's range is walked by the pixels
    whose walked count exceeds k, and kept for them when their 8x4 block
    keeps it."""
    import torch
    from goi_tpu_torch.raster.blend import (block_cull_plain,
                                            tile_block_origins,
                                            tile_pixel_blocks)
    dev = raw.device
    num_tiles = starts.numel()
    # walked counts of each 8x4 block's 32 pixels, (T, 8, 32)
    wb = raw[..., -2][:, torch.argsort(tile_pixel_blocks(dev), stable=True)
                      ].view(num_tiles, 8, 32)
    bx0, by0 = tile_block_origins(grid_x, num_tiles // grid_x, device=dev)
    counts = (ends - starts).long()
    tile_of = torch.repeat_interleave(torch.arange(num_tiles, device=dev),
                                      counts)
    first = torch.cumsum(counts, 0) - counts
    kept = 0
    for c0 in range(0, tile_of.numel(), chunk):
        t = tile_of[c0:c0 + chunk]
        k = torch.arange(c0, c0 + t.numel(), device=dev) - first[t]
        f = feat[:, starts[t].long() + k]
        keep = block_cull_plain(f[0:2].T[:, None], f[2:5].T[:, None],
                                f[5][:, None], bx0[t], by0[t])   # (c, 8)
        n_walk = (wb[t] > k[:, None, None].float()).sum(-1)     # (c, 8)
        kept += int((keep * n_walk).sum())
    return kept


def check_blend(feat, starts, ends, grid_x, label):
    import torch
    from goi_tpu_torch.raster.cuda_blend import blend_fwd, blend_fwd_plain
    from goi_tpu_torch.raster.cuda_trace import trace_fwd_plain
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
    # walked and blended counts exactly against the plain trace's render,
    # which multiplies the transmittance one instance at a time as the
    # kernel does; the plain blend's per-chunk cumprod rounds otherwise
    # and may stop a pixel one instance apart near T = 1e-4
    seq_raw, _ = trace_fwd_plain(feat, starts, ends,
                                 torch.zeros((starts.numel(), 256, 1),
                                             device=feat.device), grid_x)
    count_diff = int((out[..., n_out + 1:] != seq_raw[..., n_out + 1:])
                     .sum())
    if count_diff:
        raise AssertionError(f"blend {label}: {count_diff} walked/blended "
                             f"counts differ from the sequential plain "
                             f"version's")
    del seq_raw
    chunk_diff = int((out[..., n_out + 1:] != ref[..., n_out + 1:]).sum())
    walked = float(out[..., n_out + 1].double().sum())
    blended = float(out[..., n_out + 2].double().sum())
    kept = cull_kept_pairs(feat, starts, ends, grid_x, out)
    if not blended <= kept <= walked:
        raise AssertionError(f"blend {label}: the cull keeps {kept} pairs, "
                             f"outside [blended, walked]")
    ms = median_ms(lambda: blend_fwd(feat, starts, ends, grid_x))
    plain_ms = median_ms(lambda: blend_fwd_plain(feat, starts, ends, grid_x),
                         iters=3, warmup=1)
    nbytes = 4 * (feat.numel() + starts.numel() + ends.numel()
                  + out.numel())
    ops = OPS_WALKED * walked + (OPS_BLENDED_BASE + 2 * n_out) * blended
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = ops / PEAK_FP32_PER_S * 1e3
    log(f"[kernels] blend {label}: tiles={starts.numel()} "
        f"M={feat.shape[1]} max_err={err:.3e} (tol {TOL}); walked/blended "
        f"counts equal to the sequential plain's (the chunked plain's "
        f"differ in {chunk_diff}); pairs walked={walked:.0f} "
        f"blended={blended:.0f}, the per-warp cull keeps {kept} "
        f"({kept / max(walked, 1):.4f} of walked, plain twin); kernel "
        f"{ms:.4f} ms, plain "
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
    """The block prefix against prefix_boundary's read-out of every row
    bit for bit (the same scan order, fed its own way) and against its
    plain version within TOL_PREFIX, timed beside torch.cumsum and a
    device-to-device copy of the rows (as many bytes read and written:
    the ceiling a kernel bound by bytes can reach)."""
    import torch
    from goi_tpu_torch.raster.reduce import (prefix_blocks,
                                             prefix_blocks_plain,
                                             prefix_boundary)
    inner, tot = prefix_blocks(rows, okf, blk)
    m, d = rows.shape
    x = rows if okf is None else rows * okf.reshape(m, 1)
    lb, lb_tot = prefix_boundary(x, torch.arange(m + 1, device=rows.device),
                                 blk)
    torch.cuda.synchronize()
    if not (torch.equal(inner[:m + 1], lb) and torch.equal(tot, lb_tot)
            and not inner[m:].any()):
        raise AssertionError(f"prefix {label}: not bit-identical to "
                             f"prefix_boundary's read-out of every row")
    del x, lb, lb_tot
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
    del ref_inner, ref_tot
    nb = m // blk
    ms = median_ms(lambda: prefix_blocks(rows, okf, blk))
    in_run_ms = run_ms(lambda: prefix_blocks(rows, okf, blk))
    kernel_ms = device_ms(lambda: prefix_blocks(rows, okf, blk),
                          "prefix_kernel")
    plain_ms = median_ms(lambda: prefix_blocks_plain(rows, okf, blk))
    lib_ms = median_ms(lambda: torch.cumsum(rows.view(nb, blk, d), dim=1))
    dst = torch.empty_like(rows)
    copy_ms = run_ms(lambda: dst.copy_(rows))
    del dst
    nbytes = 4 * (rows.numel() + (0 if okf is None else okf.numel())
                  + inner.numel() + tot.numel())
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = m * d / PEAK_FP32_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    log(f"[kernels] prefix {label}: rows=({m}, {d}) block={blk} "
        f"masked={okf is not None}: torch.equal to prefix_boundary's "
        f"read-out of every row, max_err vs plain={err:.3e} (tol rtol "
        f"{TOL_PREFIX[0]} + {TOL_PREFIX[1]} x peak); a call {ms:.4f} ms, "
        f"{in_run_ms:.4f} ms a call in a run of calls "
        f"({100 * bound_ms / in_run_ms:.1f}% of the bound), the kernel on "
        f"the device {kernel_ms:.4f} ms (profiler), plain {plain_ms:.4f} "
        f"ms, cumsum {lib_ms:.4f} ms, bound {bound_ms:.4f} ms (bytes); "
        f"copy ceiling: rows.copy_ ({rows.numel() * 4 / 1e6:.1f} MB) "
        f"{copy_ms:.4f} ms a call in a run ({100 * bound_ms / copy_ms:.1f}% "
        f"of the bound; the prefix at {copy_ms / in_run_ms:.3f}x its "
        f"speed)")
    return dict(max_abs_err=err, ms=ms, run_ms=in_run_ms,
                kernel_ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                library_ms=lib_ms, copy_ms=copy_ms)


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
    events = prof.key_averages()
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    # the expansion on the card is the fused search + gather kernel: the
    # plain version's scatter and cummax must not run
    plain = sorted({e.key for e in events
                    if "cummax" in e.key or "scatter_reduce" in e.key})
    if plain:
        raise AssertionError(f"{what} ran the plain expansion: {plain}")
    log(f"[profile] {what} {wall_ms:.2f} ms wall, device busy "
        f"{busy_ms:.2f} ms, idle share {1 - busy_ms / wall_ms:.3f}, "
        f"{sum(e.count for e in kernels)} device ops; no cummax or "
        f"scatter_reduce")
    kernels.sort(key=lambda e: -e.self_device_time_total)
    for e in kernels[:top]:
        log(f"[profile]   {e.self_device_time_total / 1e3:8.3f} ms "
            f"x{e.count:<4d} {e.key[:110]}")


def feature_maps(n, seed, width, height, device):
    """Seeded APE-like (256, H, W) maps: N_PROTOS prototypes laid out by
    a random label map at 1/8 resolution, upsampled, plus a little
    per-pixel noise (so every pixel's feature is distinct)."""
    return labelled_maps(n, seed, width, height, device)[0]


def labelled_maps(n, seed, width, height, device):
    """feature_maps' (maps, their (H, W) label maps, the prototypes)."""
    import torch
    rng = np.random.default_rng(seed)
    protos = torch.as_tensor(rng.normal(0, 1, (N_PROTOS, APE_DIM))
                             .astype(np.float32), device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    maps, labels = [], []
    for _ in range(n):
        lab = torch.as_tensor(rng.integers(
            0, N_PROTOS, ((height + 7) // 8, (width + 7) // 8)),
            device=device)
        lab = lab.repeat_interleave(8, 0).repeat_interleave(8, 1)
        lab = lab[:height, :width]
        fm = protos[lab].permute(2, 0, 1).contiguous()
        fm += 0.05 * torch.randn(fm.shape, generator=gen, device=device)
        maps.append(fm)
        labels.append(lab)
    return maps, labels, protos


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
    stats["owner_sums"] = check_owner_sums(
        *seen["owner_sums"], rows=seen["prefix"][0],
        label=f"1M {WIDTH}x{HEIGHT} train step")
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
                if k in ("gather", "blend", "blend_bwd", "prefix",
                         "owner_sums", "preprocess", "distill_loss")}
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
    for k in ("preprocess", "distill_loss"):
        if launches[k] != N_STEPS:
            raise AssertionError(f"[train] {N_STEPS} steps launched {k} "
                                 f"{launches[k]} times, not once each")
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
    if counts["prefix_boundary"] != DENSE_STEPS or counts["prefix"] \
            or counts["owner_sums"] != DENSE_STEPS \
            or counts["preprocess"] != DENSE_STEPS:
        raise AssertionError(f"dense_reduce steps launched {counts}")
    log(f"[train] {DENSE_STEPS} steps with dense_reduce=True: step p50 "
        f"{np.percentile(dense_ms, 50):.1f} ms, max {max(dense_ms):.1f} ms; "
        f"launches prefix_boundary={counts['prefix_boundary']} "
        f"owner_sums={counts['owner_sums']} prefix=0")
    launches["prefix_boundary"] = counts["prefix_boundary"]
    for k in ("gather", "blend", "blend_bwd", "owner_sums", "preprocess"):
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
    from goi_tpu_torch._cli import kernel_wrappers as wrappers
    return wrappers()


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
    from goi_tpu_torch.raster.cuda_blend import blend_fwd
    from goi_tpu_torch.raster.cuda_trace import trace_fwd, trace_fwd_plain
    raw, rows = trace_fwd(feat, starts, ends, aug, grid_x)
    fwd_raw = blend_fwd(feat, starts, ends, grid_x)
    torch.cuda.synchronize()
    # one walk (csrc/walk.cuh): the embedded render is the forward's
    if not torch.equal(raw, fwd_raw):
        raise AssertionError(f"trace {label}: raw output differs from "
                             f"blend_fwd's on the same inputs")
    del fwd_raw
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
    if count_diff:
        raise AssertionError(f"trace {label}: {count_diff} walked/blended "
                             f"counts differ from the plain version's")
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
        f"lifted={sa}; raw bit-identical to blend_fwd's; render max_err="
        f"{err_raw:.3e} (tol {TOL}), rows "
        f"max_err={err_rows:.3e} (tol rtol {TOL_TRACE[0]} + {TOL_TRACE[1]} x "
        f"peak), hit, walked and blended counts equal; pairs "
        f"walked={walked:.0f} blended={blended:.0f} "
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
    # the one PyTorch call that gives the same per-Gaussian sums (in
    # another order: a serial sum per segment)
    lengths = p.diff()
    used = rows[:int(p[-1])]
    lib_ms = median_ms(lambda: torch.segment_reduce(used, "sum",
                                                    lengths=lengths))
    lib_err = float((torch.segment_reduce(used, "sum", lengths=lengths)
                     - dense_boundary_reduce(rows, p)).abs().max())
    nbytes = 4 * (rows.numel() + lb.numel() + tot.numel()) + 8 * p.numel()
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = m * d / PEAK_FP32_PER_S * 1e3
    log(f"[kernels] prefix_boundary {label}: rows=({m}, {d}) bounds="
        f"{p.numel()} block={blk}: bit-identical to prefix's inner[p] and "
        f"totals, max_err vs plain={err:.3e}; kernel {ms:.4f} ms (with its "
        f"first-bound table; prefix + "
        f"gather {unfused_ms:.4f} ms), plain {plain_ms:.4f} ms, bound "
        f"{max(bytes_ms, ops_ms):.4f} ms (bytes); whole reduce: fused "
        f"{fused_red_ms:.4f} ms, unfused {unfused_red_ms:.4f} ms, "
        f"torch.segment_reduce {lib_ms:.4f} ms (max diff {lib_err:.3e})")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                library_ms=lib_ms)


def check_owner_sums(prefix, p, tot, blk, indexed, rows, label):
    """The block owners' sums against their plain version bit for bit,
    in the path's read-out form and in the other one, with times beside
    torch.segment_reduce of the block term and of the whole per-Gaussian
    sum (rows, the reduce's stream)."""
    import torch
    from goi_tpu_torch.raster.reduce import owner_sums, owner_sums_plain
    out = owner_sums(prefix, p, tot, blk, indexed)
    ref = owner_sums_plain(prefix, p, tot, blk, indexed)
    lb = prefix[p] if indexed else prefix
    fused = owner_sums(lb, p, tot, blk, False)
    torch.cuda.synchronize()
    if not (torch.equal(out, ref) and torch.equal(fused, out)):
        raise AssertionError(f"owner_sums {label}: not bit-identical to its "
                             f"plain version in both read-out forms")
    del ref, fused
    n, d = out.shape
    spans = (p // blk).diff()
    blocks = int(spans.sum())
    ms = median_ms(lambda: owner_sums(prefix, p, tot, blk, indexed))
    lb_ms = median_ms(lambda: owner_sums(lb, p, tot, blk, False))
    kernel_ms = device_ms(lambda: owner_sums(prefix, p, tot, blk, indexed),
                          "owner_sums_kernel")
    lb_kernel_ms = device_ms(lambda: owner_sums(lb, p, tot, blk, False),
                             "owner_sums_kernel")
    plain_ms = median_ms(lambda: owner_sums_plain(prefix, p, tot, blk,
                                                  indexed))
    q0 = int(p[0]) // blk
    block_ms = median_ms(lambda: torch.segment_reduce(
        tot[q0:q0 + blocks], "sum", lengths=spans))
    used, lengths = rows[int(p[0]):int(p[-1])], p.diff()
    lib_ms = median_ms(lambda: torch.segment_reduce(used, "sum",
                                                    lengths=lengths))
    # each read-out row, bound and block total the segments need read
    # once, each sum written once; a subtract and an add per value, an
    # add per value of a whole block
    nbytes = 4 * (p.numel() * d + blocks * d + n * d) + 8 * p.numel()
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = (2 * n * d + blocks * d) / PEAK_FP32_PER_S * 1e3
    log(f"[kernels] owner_sums {label}: {n} segments x {d}, {tot.shape[0]} "
        f"blocks of {blk} ({blocks} whole blocks in segments, "
        f"{int((spans >= 3).sum())} segments of >= 3, the longest "
        f"{int(spans.max())}), read-out {'indexed' if indexed else 'lb'}: "
        f"torch.equal to its plain version, and the lb form to this one; "
        f"a call {ms:.4f} ms (lb form {lb_ms:.4f} ms), the kernel on the "
        f"device {kernel_ms:.4f} ms (lb form {lb_kernel_ms:.4f} ms, "
        f"profiler), plain {plain_ms:.4f} ms, bound "
        f"{max(bytes_ms, ops_ms):.4f} ms (bytes {bytes_ms:.4f}, operations "
        f"{ops_ms:.4f}); torch.segment_reduce of the block term "
        f"{block_ms:.4f} ms, of the whole sum over the rows {lib_ms:.4f} "
        f"ms")
    return dict(max_abs_err=0.0, ms=ms, kernel_ms=kernel_ms,
                plain_ms=plain_ms, bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                library_ms=lib_ms)


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
                                       "prefix_boundary", "owner_sums",
                                       "preprocess")}
    if counts["blend"] or counts["blend_bwd"]:
        raise AssertionError(f"trace ran a blend kernel: {counts}")
    if counts["preprocess"] != N_TRACES + 1:
        raise AssertionError(f"{N_TRACES + 1} trace() calls launched "
                             f"preprocess {counts['preprocess']} times")
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


def scene_grads(render_fn, scene, tgt, reduce="mean"):
    """Every scene attribute's gradient of mean(render * tgt) +
    mean(semantics) (with reduce="sum" the sums: the two losses of
    tests/test_sharded_render.py) through render_fn(scene)."""
    import torch
    red = getattr(torch, reduce)
    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in scene.params().items()}
    out = render_fn(scene.with_params(leaves))
    (red(out["render"] * tgt) + red(out["semantics"])).backward()
    return {k: v.grad for k, v in leaves.items()}


def flip_budget(want, got, label):
    """The flip budget of the sharded gradients against one-card ones;
    returns (share past the bar, max |diff|)."""
    import torch
    d = (got - want).abs()
    share = float((d > FLIP_TOL[0] + FLIP_TOL[1] * want.abs()).float()
                  .mean())
    worst = float(d.max())
    if not bool(torch.isfinite(got).all()) or share > FLIP_SHARE \
            or worst > FLIP_MAX:
        raise AssertionError(f"{label}: {share:.4f} of the elements past "
                             f"the bar (budget {FLIP_SHARE}), max |diff| "
                             f"{worst} (bound {FLIP_MAX})")
    return share, worst


def frames_agree(out, ref, tol, label):
    """(bit-equal?, max |diff|) of the four images; raises past tol."""
    import torch
    keys = ("render", "semantics", "depth", "alpha")
    err = max(float((out[k] - ref[k]).abs().max()) for k in keys)
    if any(out[k].shape != ref[k].shape for k in keys) or err > tol:
        raise AssertionError(f"{label}: max |diff| {err} (tol {tol})")
    return all(torch.equal(out[k], ref[k]) for k in keys), err


def dist1_phase(scene, cams, cfg):
    """[dist1]: distribution's path on one card, a single-rank NCCL
    group: render_sharded with both exchanges against render(), their
    gradients within the flip budget and bit-identical over two passes,
    and one make_sharded_distill_step step on the (1, 1) mesh against
    train_step."""
    import torch
    import torch.distributed as dist
    from goi_tpu_torch.dist import (init_multihost, make_mesh,
                                    make_sharded_distill_step,
                                    render_sharded, shard_batch,
                                    stack_cameras)
    from goi_tpu_torch.dist.multihost import free_port
    from goi_tpu_torch.raster.render import render
    from goi_tpu_torch.semantic.codebook import SemanticDecoder
    from goi_tpu_torch.train.distill import create_distill_state
    from goi_tpu_torch.train.optim import OptimConfig
    t_phase = time.perf_counter()
    init_multihost(f"127.0.0.1:{free_port()}", 1, 0, device="cuda")
    try:
        mesh = make_mesh(1, 1, device="cuda")
        bg = torch.zeros(3, device="cuda")
        gen = torch.Generator(device="cuda").manual_seed(11)
        tgt = torch.randn((3, HEIGHT, WIDTH), generator=gen, device="cuda")
        with torch.no_grad():
            ref = render(scene, cams[0], bg, cfg)
        want = scene_grads(lambda s: render(s, cams[0], bg, cfg), scene, tgt)
        # two windows of launch counts, each holding only the sharded
        # path's own: the exchanges' passes, then the (1, 1) step
        reset_counts()
        with torch.no_grad():   # the rows exchange's lossless cap
            cap = int(render_sharded(
                scene, cams[0], bg, cfg, mesh, exchange="rows",
                exchange_cap=scene.capacity)["exchange_demand"])
        for exchange, kw in (("gather", {}),
                             ("rows", dict(exchange_cap=cap))):
            with torch.no_grad():
                out = render_sharded(scene, cams[0], bg, cfg, mesh,
                                     exchange=exchange, **kw)
            equal, err = frames_agree(out, ref, TOL_DIST_FRAME,
                                      f"[dist1] {exchange} frame")
            if int(out["num_slots"]) > out["local_budget"]:
                raise AssertionError(f"[dist1] {exchange}: num_slots "
                                     f"{int(out['num_slots'])} past "
                                     f"{out['local_budget']}")
            extra = ""
            if exchange == "rows":
                if int(out["exchange_demand"]) > out["exchange_cap"]:
                    raise AssertionError("[dist1] rows: demand past the cap")
                extra = (f", exchange demand {int(out['exchange_demand'])} "
                         f"<= cap {out['exchange_cap']} (a lossless probe's)")
            grads = [scene_grads(lambda s: render_sharded(
                s, cams[0], bg, cfg, mesh, exchange=exchange, **kw), scene,
                tgt) for _ in range(2)]
            if not all(torch.equal(grads[0][k], grads[1][k]) for k in want):
                raise AssertionError(f"[dist1] {exchange}: gradients differ "
                                     f"between two passes")
            flips = {k: flip_budget(want[k], grads[0][k],
                                    f"[dist1] {exchange} {k}")
                     for k in want}
            log(f"[dist1] {exchange}: frame "
                f"{'bit-equal to' if equal else 'within'} render()'s (max "
                f"diff {err:.3e}, tol {TOL_DIST_FRAME}), num_slots "
                f"{int(out['num_slots'])} <= {out['local_budget']}{extra}; "
                f"7 gradients bit-identical over two passes, worst flip "
                f"share {max(f[0] for f in flips.values()):.5f} (budget "
                f"{FLIP_SHARE}), max |diff| "
                f"{max(f[1] for f in flips.values()):.3e} (bound "
                f"{FLIP_MAX})")
            del grads
        del want
        render_counts = read_counts()
        launched("[dist1] render_sharded", render_counts)
        # the kernel for the three no-grad renders, the composition for
        # the four whose geometry gradients are taken
        if render_counts["preprocess"] != 3:
            raise AssertionError(f"[dist1] render_sharded launched "
                                 f"preprocess {render_counts['preprocess']}"
                                 f" times, not 3")

        # one distillation step on the (1, 1) mesh against train_step
        maps = feature_maps(1, 21, WIDTH, HEIGHT, "cuda")
        g = torch.Generator().manual_seed(21)
        decoder = SemanticDecoder.create(g, dim_in=SEM_DIM, dim_out=TAB_LEN,
                                         device="cuda")
        lut = torch.randn((TAB_LEN, APE_DIM), generator=g).to("cuda")
        state, train_step = create_distill_state(scene, decoder, lut,
                                                 OptimConfig())
        state, aux = train_step(state, cams[0], maps[0], bg, cfg)
        init_fn, step_fn = make_sharded_distill_step(OptimConfig(), cfg,
                                                     mesh=mesh)
        sstate = init_fn(scene, decoder, lut)
        c_b, g_b = shard_batch(mesh, stack_cameras([cams[0]]), maps[0][None])
        reset_counts()
        sstate, saux = step_fn(sstate, c_b, g_b, bg)
        step_counts = read_counts()
        launched("[dist1] sharded step", step_counts)
        if step_counts["preprocess"] != 1:
            raise AssertionError(f"[dist1] the sharded step launched "
                                 f"preprocess {step_counts['preprocess']} "
                                 f"times, not once")
        for k in ("lab", "sl", "sl1", "recc", "total"):
            if not math.isclose(float(saux[k]), float(aux[k]), rel_tol=1e-5):
                raise AssertionError(f"[dist1] step {k}: {float(saux[k])} vs "
                                     f"train_step's {float(aux[k])}")
        pairs = [(sstate.scene.semantics, state.scene.semantics),
                 (sstate.decoder.weights[0], state.decoder.weights[0]),
                 (sstate.lut, state.lut)]
        worst = 0.0
        for a, b in pairs:
            ok, err = close_to_peak(a.grad, b.grad, *GRAD_TOL)
            moved = b.grad.abs() > GRAD_TOL[1] * float(b.grad.abs().max())
            if not ok or not torch.allclose(a[moved], b[moved], rtol=1e-6,
                                            atol=1e-7):
                raise AssertionError(f"[dist1] step: gradients or updated "
                                     f"parameters differ (max grad diff "
                                     f"{err})")
            worst = max(worst, err)
        log(f"[dist1] make_sharded_distill_step on the (1, 1) mesh: loss "
            f"{float(saux['total']):.6f} = train_step's "
            f"{float(aux['total']):.6f} (rtol 1e-5), the semantics, decoder "
            f"and LUT gradients within {GRAD_TOL} of the peak (max diff "
            f"{worst:.3e}) and their updated values equal where the "
            f"gradient is past the atol; phase {time.perf_counter() - t_phase:.1f} s; "
            f"launches: render_sharded {render_counts}, step {step_counts}")
        del state, sstate, maps
    finally:
        dist.destroy_process_group()
    return {k: render_counts[k] + step_counts[k] for k in render_counts}


def launched(label, counts):
    """Raises unless the window's counts show the sharded path's forward
    and backward kernels (the 'chain' reduce's prefix and owner sums
    included)."""
    for k in ("gather", "blend", "blend_bwd", "prefix", "owner_sums"):
        if counts[k] <= 0:
            raise AssertionError(f"{label}: {k} was not launched: {counts}")


def widths_phase():
    """[widths]: the blend, backward and trace kernels at semantic widths
    between and at their instances (WIDTHS_S, run padded to the next
    instance) and past the widest (in channel groups of S_MAX, one launch
    a group), and the trace at lift widths past one warp (WIDTHS_SA), on
    a seeded WIDTHS_GAUSS-Gaussian scene at the full frame: each against
    its plain version at the main path's tolerances, walked, blended and
    hit counts exactly; past S_MAX each forward group bit-identical to a
    lone run of its channels on the S_MAX instance; S = 10 padded to the
    next instance bit-identical to the native instance in all three
    kernels. The scene carries max(WIDTHS_S) channels; a width S takes
    the first S of them, so the geometry, and with it every count, is the
    same at every S."""
    import torch
    from goi_tpu_torch.raster.cuda_blend import (S_MAX, SEM_DIMS,
                                                 _channel_groups,
                                                 _group_rows, blend_bwd,
                                                 blend_bwd_plain, blend_fwd,
                                                 blend_fwd_plain,
                                                 kernel_width, pad_feat,
                                                 pad_raw, unpad_raw,
                                                 unpad_rows)
    from goi_tpu_torch.raster.cuda_trace import (SA_MAX, trace_fwd,
                                                 trace_fwd_plain)
    from goi_tpu_torch.raster.render import RasterConfig, suggest_budgets
    if S_MAX not in WIDTHS_S or max(WIDTHS_S) <= S_MAX \
            or max(WIDTHS_SA) != SA_MAX:
        raise AssertionError("the phase must reach S_MAX, pass it and "
                             "reach SA_MAX")
    s_all = max(WIDTHS_S)
    scene = make_scene(WIDTHS_GAUSS, seed=11, device="cuda", sem_dim=s_all)
    cam = orbit_cams(WIDTH, HEIGHT, 1, "cuda")[0]
    mi, _ = suggest_budgets(scene, cam, margin=1.2)
    f_all, starts, ends, gx = capture_inputs(
        scene, cam, RasterConfig(max_instances=mi))["blend"]
    del scene
    nt = starts.numel()

    def feat_of(s_dim):    # the first s_dim semantic rows, then depth
        return torch.cat([f_all[:9 + s_dim], f_all[9 + s_all:]]).contiguous()

    f_max = feat_of(S_MAX)

    gen = torch.Generator(device="cuda").manual_seed(13)

    def aug_of(sa):
        a = torch.randn((nt, 256, sa), generator=gen, device="cuda")
        a[..., -1] = 1.0
        return a

    # the trace at each lift width, at S = S_MAX, against its plain version
    plain_rows = {}
    counts = None
    for sa in WIDTHS_SA:
        aug = aug_of(sa)
        raw, rows = trace_fwd(f_max, starts, ends, aug, gx)
        torch.cuda.synchronize()
        (ref_raw, ref_rows), plain_ms = timed_ms(
            lambda: trace_fwd_plain(f_max, starts, ends, aug, gx))
        n_out = 4 + S_MAX
        ok_r = torch.allclose(raw[..., :n_out + 1], ref_raw[..., :n_out + 1],
                              rtol=TOL, atol=TOL)
        ok_l, err = close_to_peak(rows, ref_rows, *TOL_TRACE)
        if not (ok_r and ok_l and torch.equal(rows[:, -1], ref_rows[:, -1])
                and torch.equal(raw[..., -2:], ref_raw[..., -2:])):
            raise AssertionError(f"[widths] trace sa={sa}: kernel differs "
                                 f"from plain (rows max err {err})")
        counts = ref_raw[..., -2:]
        plain_rows[sa] = (aug, ref_rows)
        ms = median_ms(lambda: trace_fwd(f_max, starts, ends, aug, gx))
        log(f"[widths] trace S={S_MAX} sa={sa}: rows max_err={err:.3e}, hit, "
            f"walked and blended counts equal to the plain version's; "
            f"kernel {ms:.4f} ms, plain {plain_ms:.1f} ms")
    del ref_raw, raw
    aug, ref_rows = plain_rows[33]
    for s_dim in WIDTHS_S:
        feat = feat_of(s_dim)
        groups = _channel_groups(s_dim, S_MAX)
        wrappers = (blend_fwd, blend_bwd, trace_fwd)
        before = [k.launches for k in wrappers]
        raw = blend_fwd(feat, starts, ends, gx)
        ref = blend_fwd_plain(feat, starts, ends, gx)
        torch.cuda.synchronize()
        n_out = 4 + s_dim
        err_f = float((raw[..., :n_out + 1] - ref[..., :n_out + 1])
                      .abs().max())
        if not torch.allclose(raw[..., :n_out + 1], ref[..., :n_out + 1],
                              rtol=TOL, atol=TOL) \
                or not torch.equal(raw[..., -2:], counts):
            raise AssertionError(f"[widths] blend_fwd S={s_dim}: {err_f}, "
                                 f"or counts differ")
        lone = "one launch"
        if len(groups) > 1:
            # each group's channels against a lone run on the S_MAX instance
            for lo, hi in groups:
                one = blend_fwd(pad_feat(_group_rows(feat, s_dim, lo, hi),
                                         S_MAX), starts, ends, gx)
                if not torch.equal(one[..., 3:3 + hi - lo],
                                   raw[..., 3 + lo:3 + hi]):
                    raise AssertionError(
                        f"[widths] blend_fwd S={s_dim}: group [{lo}, {hi}) "
                        f"differs from a lone run on the {S_MAX} instance")
            lone = (f"{len(groups)} groups, each bit-identical to a lone run "
                    f"on the {S_MAX} instance")
            before[0] += len(groups)
        grad = torch.randn(raw.shape, generator=gen, device="cuda")
        rows = blend_bwd(feat, starts, ends, raw, grad, gx)
        ref = blend_bwd_plain(feat, starts, ends, raw, grad, gx)
        torch.cuda.synchronize()
        ok_b, err_b = close_to_peak(rows, ref, *TOL_BWD)
        if not ok_b:
            raise AssertionError(f"[widths] blend_bwd S={s_dim}: {err_b}")
        traw, trows = trace_fwd(feat, starts, ends, aug, gx)
        torch.cuda.synchronize()
        ok_t, err_t = close_to_peak(trows, ref_rows, *TOL_TRACE)
        if not (torch.equal(traw, raw) and ok_t
                and torch.equal(trows[:, -1], ref_rows[:, -1])):
            raise AssertionError(f"[widths] trace S={s_dim}: raw differs "
                                 f"from blend_fwd's or rows {err_t}")
        # launches: a forward and a backward per group, one trace (which
        # runs the later groups through the forward)
        want = [before[0] + 2 * len(groups) - 1, before[1] + len(groups),
                before[2] + 1]
        if [k.launches for k in wrappers] != want:
            raise AssertionError(f"[widths] S={s_dim}: launches "
                                 f"{[k.launches for k in wrappers]}, "
                                 f"expected {want}")
        del ref, traw, trows
        times = [median_ms(fn, iters=5) for fn in (
            lambda: blend_fwd(feat, starts, ends, gx),
            lambda: blend_bwd(feat, starts, ends, raw, grad, gx),
            lambda: trace_fwd(feat, starts, ends, aug, gx))]
        log(f"[widths] S={s_dim} (instance {kernel_width(s_dim)}, {lone}): "
            f"blend_fwd max_err={err_f:.3e} counts equal, blend_bwd "
            f"max_err={err_b:.3e}, trace raw bit-identical to blend_fwd's, "
            f"rows max_err={err_t:.3e}, hits equal; kernel ms blend_fwd "
            f"{times[0]:.4f}, blend_bwd {times[1]:.4f}, trace (sa=33) "
            f"{times[2]:.4f}")
    # S = 10 padded with zero rows to the next instance, as the wrappers
    # pad a width between instances, and sliced back: the native bits
    feat = feat_of(SEM_DIM)
    width = next(w for w in SEM_DIMS if w > SEM_DIM)
    wide = pad_feat(feat, width)
    raw = blend_fwd(feat, starts, ends, gx)
    grad = torch.randn(raw.shape, generator=gen, device="cuda")
    aug = plain_rows[32][0]
    traw, trows = trace_fwd(wide, starts, ends, aug, gx)
    pairs = [(raw, unpad_raw(blend_fwd(wide, starts, ends, gx), SEM_DIM,
                             width)),
             (blend_bwd(feat, starts, ends, raw, grad, gx),
              unpad_rows(blend_bwd(wide, starts, ends,
                                   pad_raw(raw, SEM_DIM, width),
                                   pad_raw(grad, SEM_DIM, width), gx),
                         SEM_DIM, width))]
    pairs += list(zip(trace_fwd(feat, starts, ends, aug, gx),
                      (unpad_raw(traw, SEM_DIM, width), trows)))
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in pairs):
        raise AssertionError(f"[widths] S={SEM_DIM} padded to {width} "
                             f"differs from the native instance")
    log(f"[widths] S={SEM_DIM} padded to the {width} instance: blend_fwd "
        f"(counts included), blend_bwd and trace (raw and rows) "
        f"bit-identical to the native instance; {nt} tiles, "
        f"M={f_all.shape[1]}")


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


def look_at_pose(eye):
    """(W2C rotation, translation) of Camera.look_at(eye, 0, +y)."""
    eye = np.asarray(eye, np.float64)
    fwd = -eye / np.linalg.norm(eye)
    right = np.cross(fwd, [0.0, 1.0, 0.0])
    right /= np.linalg.norm(right)
    rw2c = np.stack([right, np.cross(fwd, right), fwd])
    return rw2c, -rw2c @ eye


def run_cli(module, args, cwd):
    """`python -m module args` with check=True; returns (wall seconds,
    the summary line's dict, the standard output)."""
    t0 = time.perf_counter()
    try:
        proc = subprocess.run([sys.executable, "-m", module, *args],
                              cwd=cwd, check=True, capture_output=True,
                              text=True)
    except subprocess.CalledProcessError as e:
        log(e.stdout[-6000:])
        log(e.stderr[-6000:])
        raise
    wall = time.perf_counter() - t0
    tag = f"[{module}] "
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith(tag)]
    if len(lines) != 1:
        raise AssertionError(f"[cli] {module}: no summary line")
    return wall, json.loads(lines[0][len(tag):]), proc.stdout


def cli_phase():
    """[cli]: the port's entry points on a scene from disk. A COLMAP scene
    of CLI_VIEWS views at the full frame (sparse/0 binaries, a small SfM
    cloud, the seeded 1M-Gaussian scene's renders plus noise, 256-dim
    float16 feature maps of the train views as clip_feat/<name>.pt) and
    the scene as iteration 1; then python -m goi_tpu_torch.train (-r 1
    --eval, CLI_ITERS steps), .render, .metrics; query masks of
    CLI_PROTOS prototypes on the test view through QuerySession; then
    .eval_seg against the seeded label map's masks. Fails if a CLI exits
    non-zero, the triplet is missing or does not reload, the PSNR is not
    finite or <= CLI_MIN_PSNR, or the mIoU is outside [0, 1]. Returns the
    kernel launches of the path (the CLIs' own counts and the query's)."""
    import os
    import shutil
    import torch
    from goi_tpu_torch.app.session import QuerySession
    from goi_tpu_torch.core.camera import focal2fov, fov2focal
    from goi_tpu_torch.data import scene as triplet
    from goi_tpu_torch.data.dataset import build_cameras
    from goi_tpu_torch.data.readers import load_scene_info
    from goi_tpu_torch.examples.rehearsal import write_colmap
    from goi_tpu_torch.raster.render import (RasterConfig, render,
                                             suggest_budgets)
    from goi_tpu_torch.utils.image import save_image

    repo = os.path.dirname(os.path.abspath(__file__))
    root = tempfile.mkdtemp(prefix="goi_cli_")
    try:
        t0 = time.perf_counter()
        scene_dir = os.path.join(root, "scene")
        model = os.path.join(root, "model")
        scene = make_scene(N_GAUSS, seed=0, device="cuda")
        focal = fov2focal(0.9, WIDTH)
        poses = []
        for i in range(CLI_VIEWS):
            a = 2 * math.pi * i / CLI_VIEWS + 0.3
            poses.append((*look_at_pose([4.5 * math.sin(a), 0.5,
                                         -4.5 * math.cos(a)]), None))
        rng = np.random.default_rng(17)
        pick = rng.choice(N_GAUSS, CLI_SFM_POINTS, replace=False)
        sfm_xyz = scene.xyz[torch.as_tensor(pick, device="cuda")].cpu() \
            .numpy().astype(np.float64)
        write_colmap(scene_dir, poses, WIDTH, HEIGHT, focal,
                     fov2focal(focal2fov(focal, HEIGHT), HEIGHT), [],
                     sfm_xyz, np.full((CLI_SFM_POINTS, 3), 128, np.uint8))
        info = load_scene_info(scene_dir, eval_split=True)
        if (len(info.test_cameras), len(info.train_cameras)) != (1, 3):
            raise AssertionError("[cli] llffhold 8 should give 1 test and "
                                 "3 train views")
        infos = info.test_cameras + info.train_cameras     # name order
        cams = build_cameras(infos, 1, device="cuda")
        cfg = RasterConfig(max_instances=suggest_budgets(
            scene, cams, margin=1.2)[0])
        maps, labels, protos = labelled_maps(CLI_VIEWS, 7, WIDTH, HEIGHT,
                                             "cuda")
        gen = torch.Generator(device="cuda").manual_seed(CLI_VIEWS)
        os.makedirs(os.path.join(scene_dir, "clip_feat"))
        bg = torch.zeros(3, device="cuda")
        for i, (inf, cam) in enumerate(zip(infos, cams)):
            with torch.no_grad():
                img = render(scene, cam, bg, cfg)["render"]
            img = torch.clamp(img + CLI_NOISE * torch.randn(
                img.shape, generator=gen, device="cuda"), 0, 1)
            save_image(img, inf.image_path)
            if i:     # the train views' feature maps
                torch.save(maps[i].half().cpu(), inf.semantic_path)
        del maps
        triplet.save(os.path.join(model, "point_cloud", "iteration_1"),
                     scene)
        del scene
        torch.cuda.empty_cache()
        log(f"[cli] scene on disk in {time.perf_counter() - t0:.1f} s: "
            f"{CLI_VIEWS} views at {WIDTH}x{HEIGHT}, {CLI_SFM_POINTS} SfM "
            f"points, feature maps (256, {HEIGHT}, {WIDTH}) float16 of the "
            f"3 train views, {N_GAUSS} Gaussians as iteration 1")

        launches = {}
        pc_dir = os.path.join(model, "point_cloud", f"iteration_{CLI_ITERS}")
        runs = [("train", ["-s", scene_dir, "-m", model, "-r", "1", "--eval",
                           "--iterations", str(CLI_ITERS), "--test_iterations",
                           str(CLI_ITERS), "--save_iterations",
                           str(CLI_ITERS), "--tab_len", str(TAB_LEN),
                           "--ape_dim", str(APE_DIM)]),
                ("render", ["-m", model, "--iteration", str(CLI_ITERS)]),
                ("metrics", ["-m", model])]
        summaries = {}
        for name, args in runs:
            wall, summ, _ = run_cli(f"goi_tpu_torch.{name}", args, repo)
            summaries[name] = summ
            for k, n in summ["launches"].items():
                launches[k] = launches.get(k, 0) + n
            split = ", ".join(f"{k[:-2]} {v:.2f} s" for k, v in summ.items()
                              if k.endswith("_s"))
            log(f"[cli] python -m goi_tpu_torch.{name}: {wall:.1f} s wall "
                f"({split}); launches {summ['launches']}")
        used = summaries["train"]["launches"]
        if min(used[k] for k in ("gather", "blend", "blend_bwd",
                                 "prefix")) <= 0:
            raise AssertionError(f"[cli] the train CLI did not launch every "
                                 f"kernel of its path: {used}")
        if min(summaries["render"]["launches"][k]
               for k in ("gather", "blend")) <= 0:
            raise AssertionError("[cli] the render CLI launched no kernel")
        log(f"[cli] train: {CLI_ITERS} steps, step p50 "
            f"{summaries['train']['step_ms_p50']:.1f} ms, budget "
            f"{summaries['train']['budget']}, PSNR at step {CLI_ITERS} "
            f"{summaries['train']['psnr']}")

        # the triplet reloads
        for f in (triplet.PLY, triplet.DECODER, triplet.LUT):
            if not os.path.exists(os.path.join(pc_dir, f)):
                raise AssertionError(f"[cli] {f} missing in {pc_dir}")
        trained, decoder, lut = triplet.load(pc_dir, sem_dim=SEM_DIM,
                                             device="cuda")
        if trained.capacity != N_GAUSS or tuple(lut.shape) != (TAB_LEN,
                                                               APE_DIM):
            raise AssertionError("[cli] the saved triplet does not reload")
        with open(os.path.join(model, "results.json")) as f:
            res = json.load(f)[f"ours_{CLI_ITERS}"]
        if not (math.isfinite(res["PSNR"]) and res["PSNR"] > CLI_MIN_PSNR):
            raise AssertionError(f"[cli] PSNR {res['PSNR']} (must be finite "
                                 f"and > {CLI_MIN_PSNR})")

        # query masks of the test view, scored by the eval_seg CLI
        test_cam = cams[0]
        reset_counts()
        sess = QuerySession(trained, decoder, lut, cfg, device="cuda")
        for k in range(CLI_PROTOS):
            sess.set_text(protos[k])
            frame = sess.render_view(test_cam)
            if frame.shape != (HEIGHT, WIDTH, 3) or \
                    not np.isfinite(frame).all():
                raise AssertionError(f"[cli] bad query frame {frame.shape}")
            with torch.no_grad():
                out = render(sess.scene, test_cam, sess.bg, cfg)
            sim = sess.compute_similarity(
                out["semantics"].reshape(SEM_DIM, -1).T)
            name = f"proto_{k}"
            pdir = os.path.join(root, "seg_pred", "synthetic", name)
            gdir = os.path.join(root, "seg_gt", "synthetic", name, "masks")
            os.makedirs(pdir)
            os.makedirs(gdir)
            save_image((sim > 0).reshape(1, HEIGHT, WIDTH).float(),
                       os.path.join(pdir, f"{infos[0].image_name}.png"))
            save_image((labels[0] == k).float()[None],
                       os.path.join(gdir, f"{infos[0].image_name}.png"))
        torch.cuda.synchronize()
        for k, n in read_counts().items():
            launches[k] = launches.get(k, 0) + n
        del sess, trained
        wall, summ, _ = run_cli("goi_tpu_torch.eval_seg", [
            "-e", os.path.join(root, "seg_gt"), "-s",
            os.path.join(root, "seg_pred"), "--scene_list", "synthetic",
            "-d", "m360"], repo)
        if not 0.0 <= summ["miou"] <= 1.0:
            raise AssertionError(f"[cli] mIoU {summ['miou']} outside [0, 1]")
        split = ", ".join(f"{k[:-2]} {v:.2f} s" for k, v in summ.items()
                          if k.endswith("_s"))
        log(f"[cli] python -m goi_tpu_torch.eval_seg: {wall:.1f} s wall "
            f"({split}); mIoU {summ['miou']:.4f} mPA {summ['mpa']:.4f} mP "
            f"{summ['mp']}")
        disk = sum(os.path.getsize(os.path.join(d, f))
                   for d, _, fs in os.walk(root) for f in fs)
        log(f"[cli] PSNR {res['PSNR']:.3f} dB, SSIM {res['SSIM']:.4f}, "
            f"LPIPS {res['LPIPS']}; triplet reloaded; {disk} bytes on disk; "
            f"phase {time.perf_counter() - t0:.1f} s; launches {launches}")
        return launches
    finally:
        shutil.rmtree(root, ignore_errors=True)


def rgb_grads(state, cam, gt, bg, cfg, lambda_dssim):
    """The gradients of one RGB step's loss (no update): the seven
    attributes' and mean2d's, through a zero mean2d offset."""
    import torch
    from goi_tpu_torch.train.rgb import rgb_loss
    params = list(state.scene.params().values())
    for p in params:
        p.grad = None
    offset = torch.zeros((state.scene.capacity, 2),
                         device=state.scene.device, requires_grad=True)
    loss, _ = rgb_loss(state.scene, cam, gt, bg, cfg, lambda_dssim,
                       mean2d_offset=offset)
    loss.backward()
    grads = [p.grad.clone() for p in params] + [offset.grad]
    for p in params:
        p.grad = None
    return float(loss.detach()), grads


def small_rgb_check():
    """A small scene's RGB step on the card against the same step on the
    CPU: the loss (rel 1e-4) and the gradients of the seven attributes
    and of mean2d at GRAD_TOL."""
    import torch
    from goi_tpu_torch.raster.render import RasterConfig, render
    from goi_tpu_torch.train.optim import OptimConfig
    from goi_tpu_torch.train.rgb import create_rgb_trainer
    cfg = RasterConfig(max_instances=1 << 15)
    target = make_scene(2000, seed=5, device="cpu")
    tiny = make_scene(2000, seed=3, device="cpu")
    with torch.no_grad():
        gt = render(target, orbit_cams(96, 64, 1, "cpu", dist=4.0)[0],
                    torch.zeros(3), cfg)["render"]
    ocfg = OptimConfig()
    got = []
    for dev in ("cuda", "cpu"):
        init_fn, _, _ = create_rgb_trainer(ocfg, cfg)
        state = init_fn(tiny.to(dev))
        cam = orbit_cams(96, 64, 1, dev, dist=4.0)[0]
        loss, grads = rgb_grads(state, cam, gt.to(dev),
                                torch.zeros(3, device=dev), cfg,
                                ocfg.lambda_dssim)
        got.append((loss, [g.cpu() for g in grads]))
    (loss_g, g_g), (loss_c, g_c) = got
    if not math.isclose(loss_g, loss_c, rel_tol=1e-4):
        raise AssertionError(f"[rgb] small scene loss: card {loss_g} vs "
                             f"CPU {loss_c}")
    worst = 0.0
    for a, b in zip(g_g, g_c):
        if not torch.allclose(a, b, rtol=GRAD_TOL[0], atol=GRAD_TOL[1]):
            raise AssertionError(f"[rgb] small scene gradients card vs CPU:"
                                 f" {float((a - b).abs().max())}")
        worst = max(worst, float((a - b).abs().max()))
    log(f"[rgb] small scene: an RGB step's loss and {len(g_g)} gradient "
        f"tensors (7 attributes + mean2d) on the card match the CPU's at "
        f"GRAD_TOL rtol {GRAD_TOL[0]} atol {GRAD_TOL[1]} (max diff "
        f"{worst:.2e})")


def camera_extent(cams) -> float:
    """The reference's scene extent: 1.1 x the largest distance of a
    camera centre from their mean (data/readers.get_nerfpp_norm)."""
    import torch
    centers = torch.stack([c.camera_center for c in cams]).double()
    return float(1.1 * (centers - centers.mean(0)).norm(dim=1).max())


def rgb_phase():
    """[rgb]: RGB training with densification at full width. Returns the
    kernel launches of train_rgb's run."""
    import dataclasses
    import torch
    from goi_tpu_torch.core.scene import GaussianScene
    from goi_tpu_torch.eval.metrics import psnr
    from goi_tpu_torch.raster.render import (RasterConfig, _effective_reduce,
                                             render, suggest_budgets)
    from goi_tpu_torch.train import rgb
    from goi_tpu_torch.train.optim import OptimConfig
    t_phase = time.perf_counter()
    bg = torch.zeros(3, device="cuda")
    cams = orbit_cams(WIDTH, HEIGHT, RGB_VIEWS, "cuda")
    train_cams, held = cams[:-1], cams[-1]
    gt_scene = make_scene(N_GAUSS, seed=0, device="cuda")
    gt_cfg = RasterConfig(max_instances=suggest_budgets(
        gt_scene, cams, margin=1.2)[0])
    with torch.no_grad():
        images = [render(gt_scene, c, bg, gt_cfg)["render"] for c in cams]
    rng = np.random.default_rng(23)
    pts = gt_scene.xyz[::2].cpu().numpy()
    pts = pts + rng.normal(0, RGB_NOISE, pts.shape).astype(np.float32)
    del gt_scene
    start = GaussianScene.create(pts, None, sh_degree=3, sem_dim=SEM_DIM,
                                 device="cuda")
    cfg = RasterConfig(max_instances=suggest_budgets(
        start, train_cams, margin=1.2)[0])
    if _effective_reduce(cfg) != "chain":
        raise AssertionError(f"[rgb] reduce resolves to "
                             f"{_effective_reduce(cfg)}")
    extent = camera_extent(train_cams)
    ocfg = OptimConfig(iterations=RGB_ITERS, **RGB_SCHEDULE)
    with torch.no_grad():
        psnr0 = float(psnr(render(start, held, bg, cfg)["render"],
                           images[-1]))
    log(f"[rgb] {RGB_VIEWS} views of the {N_GAUSS}-Gaussian scene at "
        f"{WIDTH}x{HEIGHT} ({RGB_VIEWS - 1} train, 1 held out); start "
        f"{start.capacity} points (every second GT xyz + N(0, {RGB_NOISE}))"
        f", capacity {start.capacity}, budget {cfg.max_instances} "
        f"(suggest_budgets x 1.2, reduce chain), extent {extent:.3f}")

    # one full-width step: bit-identical gradients over two backward
    # passes and with the fused reduce
    init_fn, _, _ = rgb.create_rgb_trainer(ocfg, cfg, extent)
    state = init_fn(start)
    lam = ocfg.lambda_dssim
    _, g1 = rgb_grads(state, train_cams[0], images[0], bg, cfg, lam)
    _, g2 = rgb_grads(state, train_cams[0], images[0], bg, cfg, lam)
    if not all(torch.equal(a, b) for a, b in zip(g1, g2)):
        raise AssertionError("[rgb] gradients differ between two backward "
                             "passes")
    _, g3 = rgb_grads(state, train_cams[0], images[0], bg,
                      dataclasses.replace(cfg, dense_reduce=True), lam)
    if not all(torch.equal(a, b) for a, b in zip(g1, g3)):
        raise AssertionError("[rgb] gradients with dense_reduce differ")
    log(f"[rgb] one step's gradients (7 attributes + mean2d, "
        f"{sum(g.numel() for g in g1)} values) bit-identical over two "
        f"backward passes and with dense_reduce=True")
    del state, g1, g2, g3
    small_rgb_check()

    # train_rgb, timed from outside: its densify, capacity growth and
    # rebudget are wrapped where the loop calls them
    timings = {"densify": [], "grow": [], "rebudget": []}
    iters = []          # (it, wall ms, loss, gnorm, slots, ninst, cap)
    wrapped = {name: getattr(rgb, name) for name in
               ("densify_and_prune", "grow_capacity", "_rebudget")}

    def timed(name, key):
        def run(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = wrapped[name](*a, **kw)
            torch.cuda.synchronize()
            timings[key].append((len(iters) + 1,
                                 (time.perf_counter() - t0) * 1e3, out))
            return out
        return run

    t_last = [0.0]

    def callback(it, state, aux):
        torch.cuda.synchronize()
        t = time.perf_counter()
        iters.append((it, (t - t_last[0]) * 1e3, float(aux["loss"]),
                      float(aux["gnorm"]), int(aux["num_slots"]),
                      int(aux["num_instances"]), state.scene.capacity))
        t_last[0] = time.perf_counter()

    for name, key in (("densify_and_prune", "densify"),
                      ("grow_capacity", "grow"), ("_rebudget", "rebudget")):
        setattr(rgb, name, timed(name, key))
    n_start = int(start.num_valid)
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t_last[0] = t_train = time.perf_counter()
    try:
        state, rcfg = rgb.train_rgb(
            start, train_cams, images[:-1], cfg=ocfg, raster_cfg=cfg,
            iterations=RGB_ITERS, scene_extent=extent, log_every=50,
            callback=callback, return_raster_cfg=True)
    finally:
        for name, fn in wrapped.items():
            setattr(rgb, name, fn)
    train_s = time.perf_counter() - t_train
    launches = {k: n for k, n in read_counts().items()
                if k in ("gather", "blend", "blend_bwd", "prefix",
                         "owner_sums")}
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30

    losses = np.array([r[2] for r in iters])
    gnorms = np.array([r[3] for r in iters])
    if len(iters) != RGB_ITERS or not (np.isfinite(losses).all()
                                       and np.isfinite(gnorms).all()):
        raise AssertionError("[rgb] a non-finite loss or gnorm")
    if not timings["grow"]:
        raise AssertionError("[rgb] the capacity never grew")
    if min(launches.values()) <= 0:
        raise AssertionError(f"[rgb] a kernel was not launched: {launches}")
    # every step past its budget was followed by a rebudget by the next
    # step: in its own iteration (the check of the step before it, which
    # ran past the budget too) or in the next one (one step of slack),
    # or in the final fold after the last step
    fired = {it: out.max_instances for it, _, out in timings["rebudget"]}
    budget = cfg.max_instances
    for it, _, _, _, slots, ninst, _ in iters:
        if max(slots, ninst) > budget and not {it, it + 1} & set(fired):
            raise AssertionError(f"[rgb] step {it} demanded "
                                 f"{max(slots, ninst)} > {budget} and no "
                                 f"rebudget followed")
        budget = fired.get(it, budget)
    if rcfg.max_instances != max([cfg.max_instances] + list(fired.values())):
        raise AssertionError("[rgb] return_raster_cfg is not the grown "
                             "config")
    with torch.no_grad():
        psnr1 = float(psnr(render(state.scene, held, bg, rcfg)["render"],
                           images[-1]))
    if not psnr1 > psnr0:
        raise AssertionError(f"[rgb] held-out PSNR did not rise: {psnr0} "
                             f"-> {psnr1}")

    # step-only iterations: no densify, capacity growth or rebudget
    busy = {it for key in timings for it, _, _ in timings[key]}
    busy |= {it for it in range(1, RGB_ITERS + 1)
             if it % ocfg.opacity_reset_interval == 0}
    step_ms = [r[1] for r in iters if r[0] not in busy and r[0] > 1]
    p50, p95 = np.percentile(step_ms, [50, 95])
    dens_ms = [ms for _, ms, _ in timings["densify"]]
    dens_info = ", ".join(
        f"{it}: +{int(out[3]['n_clone'])}c +{int(out[3]['n_split'])}s "
        f"-{int(out[3]['n_pruned'])}p ={int(out[3]['n_valid'])}"
        for it, _, out in timings["densify"])
    grow = [(it, ms, out[0].capacity) for it, ms, out in timings["grow"]]
    log(f"[rgb] train_rgb {RGB_ITERS} iterations in {train_s:.1f} s: step "
        f"p50 {p50:.1f} ms, p95 {p95:.1f} ms ({len(step_ms)} step-only "
        f"iterations); densify x{len(dens_ms)} p50 "
        f"{np.percentile(dens_ms, 50):.1f} ms; grow_capacity x{len(grow)} "
        + ", ".join(f"at {it} -> {cap} in {ms:.1f} ms"
                    for it, ms, cap in grow)
        + f"; rebudgets x{len(fired)} "
        + ", ".join(f"at {it} -> {mi}" for it, mi in fired.items()))
    log(f"[rgb] densify (clones, splits, pruned incl. free rows, valid): "
        f"{dens_info}")
    log(f"[rgb] n_valid {n_start} -> {int(state.scene.num_valid)}, capacity "
        f"{start.capacity} -> {state.scene.capacity}; budget "
        f"{cfg.max_instances} -> {rcfg.max_instances}; peak memory "
        f"{peak_gb:.2f} GiB; held-out PSNR {psnr0:.3f} -> {psnr1:.3f} dB; "
        f"losses {losses[0]:.4f} -> {losses[-1]:.4f}; launches {launches}")
    log(f"[rgb] losses every 10: "
        f"{' '.join(f'{x:.4f}' for x in losses[::10])}; gnorm max "
        f"{gnorms.max():.3e}")

    # one profiled step on the trained scene
    _, step_fn, _ = rgb.create_rgb_trainer(ocfg, rcfg, extent)
    profile(lambda: step_fn(state, train_cams[0], images[0], bg),
            "RGB step", top=15)
    log(f"[rgb] phase {time.perf_counter() - t_phase:.1f} s")
    return launches


def pipeline_phase():
    """[pipeline]: the port's full-pipeline demo (--fast) as a subprocess
    on the card. Returns its kernel launches."""
    import os
    repo = os.path.dirname(os.path.abspath(__file__))
    module = "goi_tpu_torch.examples.full_pipeline_demo"
    wall, summ, out = run_cli(module, ["--fast"], repo)
    if "PIPELINE COMPLETE" not in out.splitlines():
        raise AssertionError("[pipeline] no PIPELINE COMPLETE line")
    for line in out.splitlines():
        if line.startswith("[") and ("RGB training" in line or
                                     "query eval" in line or
                                     "OSH finetune" in line):
            log(f"[pipeline] {line}")
    nums = {k: summ[k] for k in ("psnr", "miou", "osh_iou")}
    if not all(math.isfinite(v) for v in nums.values()):
        raise AssertionError(f"[pipeline] a non-finite result: {nums}")
    if min(summ["launches"][k] for k in ("gather", "blend", "blend_bwd",
                                         "prefix")) <= 0:
        raise AssertionError(f"[pipeline] a kernel was not launched: "
                             f"{summ['launches']}")
    split = ", ".join(f"{k[:-2]} {v:.2f} s" for k, v in summ.items()
                      if k.endswith("_s"))
    log(f"[pipeline] python -m {module} --fast: {wall:.1f} s wall "
        f"({split}); PSNR {nums['psnr']:.3f} dB, mIoU {nums['miou']:.4f}, "
        f"OSH IoU {nums['osh_iou']:.4f} in {summ['osh_epochs']} epochs, "
        f"{summ['n_gaussians']} Gaussians; launches {summ['launches']}")
    return summ["launches"]


def app_points():
    """The designed groups' positions (float32): APP_NEAR uniform in a
    ball of radius APP_BALL, APP_BALL_DIST from the origin toward the
    group view's camera, and APP_FAR around (0, APP_FAR_Y, 0), above
    every view."""
    from goi_tpu_torch.app.orbit_ngp import orbit_pose
    rng = np.random.default_rng(9)
    d = orbit_pose(APP_VIEW["elev"], APP_VIEW["azim"], 1.0)[:3, 3]
    u = rng.normal(0, 1, (APP_NEAR, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    near = APP_BALL_DIST * d.astype(np.float64) + u * APP_BALL * rng.uniform(
        0, 1, (APP_NEAR, 1)) ** (1 / 3)
    far = np.array([0.0, APP_FAR_Y, 0.0]) + 0.4 * rng.normal(
        0, 1, (APP_FAR, 3))
    return near.astype(np.float32), far.astype(np.float32)


def app_scene(decoder):
    """The app phase's scene: the main-path scene's seeded copy with the
    designed groups (Gaussians picked at random) moved to app_points, the
    near ones small and opaque, all of them carrying one semantic vector
    that decodes to code c; no other Gaussian decodes to c (those that
    did have their semantics negated). Returns (scene, c, the groups'
    mask, the near group's mask), masks as numpy."""
    import torch
    scene = make_scene(N_GAUSS, seed=0, device="cuda")
    near, far = app_points()
    rng = np.random.default_rng(10)
    pick = rng.permutation(N_GAUSS)[:APP_NEAR + APP_FAR]
    idx = torch.as_tensor(pick, device="cuda")
    nidx = idx[:APP_NEAR]
    # the code whose own direction decodes to it with the widest margin
    w = decoder.weights[0].detach().double().cpu().numpy()
    u = w / np.linalg.norm(w, axis=1, keepdims=True)
    proj = u @ w.T
    own = np.diag(proj).copy()
    np.fill_diagonal(proj, -np.inf)
    code = int(np.argmax(own - proj.max(1)))
    vec = torch.as_tensor((4.0 * u[code]).astype(np.float32), device="cuda")

    def codes(sem):
        with torch.no_grad():
            return torch.argmax(torch.softmax(decoder(sem) * 10.0, -1), -1)

    xyz = scene.xyz.clone()
    xyz[idx] = torch.as_tensor(np.concatenate([near, far]), device="cuda")
    scaling = scene.scaling.clone()
    scaling[nidx] = torch.as_tensor(np.log(rng.uniform(
        0.004, 0.008, (APP_NEAR, 1))).astype(np.float32),
        device="cuda").expand(-1, 3)
    opacity = scene.opacity.clone()
    opacity[nidx] = 3.0
    sem = scene.semantics.clone()
    sem[idx] = vec
    target = torch.zeros(N_GAUSS, dtype=torch.bool, device="cuda")
    target[idx] = True
    flip = ~target & (codes(sem) == code)
    sem[flip] = -sem[flip]
    got = codes(sem) == code
    if not torch.equal(got, target):
        raise AssertionError("[app] the designed groups are not exactly "
                             "the Gaussians of code c")
    near_mask = torch.zeros_like(target)
    near_mask[nidx] = True
    scene = scene.replace(xyz=xyz, scaling=scaling, opacity=opacity,
                          semantics=sem)
    return scene, code, target.cpu().numpy(), near_mask.cpu().numpy()


def app_prompt(lut, code, root):
    """The app scene's prompt: a 1024-d embedding the seeded aligner maps
    onto LUT row `code`'s direction (its pseudo-inverse), in a .npz store
    under `root`, and the similarity threshold halfway between the code's
    similarity and the next code's, so that the designed groups are the
    retrieval. Returns (encoder, aligner, aligned tokens, threshold, a
    note for the log)."""
    import os
    import torch
    from goi_tpu_torch.query.align import VisionLanguageAlign
    from goi_tpu_torch.query.similarity import ape_similarity
    from goi_tpu_torch.query.text_encoder import (PrecomputedTextEncoder,
                                                  encode_and_align)
    align = VisionLanguageAlign.create(seed=0, device="cuda")
    n_code = (lut[code] / torch.linalg.norm(lut[code])).cpu().numpy()
    emb = np.linalg.pinv(align.w_text.cpu().numpy().astype(np.float64)
                         ) @ n_code.astype(np.float64)
    store = os.path.join(root, "prompts.npz")
    np.savez(store, target=emb.astype(np.float32))
    enc = PrecomputedTextEncoder(store)
    tokens = encode_and_align(enc, align, "target")[0]
    cos = float(tokens @ torch.as_tensor(n_code, device="cuda")
                / torch.linalg.norm(tokens))
    if cos < 0.999:
        raise AssertionError(f"[app] aligned prompt off its code: {cos}")
    normed = lut / torch.linalg.norm(lut, dim=-1, keepdim=True)
    sims = ape_similarity(normed, tokens).cpu().numpy().astype(np.float64)
    others = np.delete(sims, code)
    if not sims[code] > others.max():
        raise AssertionError("[app] the prompt's code is not the most "
                             "similar")
    thresh = float((sims[code] + others.max()) / 2)
    note = (f"prompt through the aligner (cos {cos:.6f} to the code's LUT "
            f"row, |tokens| {float(torch.linalg.norm(tokens)):.4f}); "
            f"sim_thresh {thresh:.6f} between {sims[code]:.6f} and "
            f"{others.max():.6f}")
    return enc, align, tokens, thresh, note


def shared_borders(points, eps, min_samples, labels) -> int:
    """Non-core points within eps of core points of two clusters (plain
    numpy and scipy, the float64 test of app/dbscan.py)."""
    from scipy.spatial import cKDTree
    p = points.astype(np.float64)
    pairs = cKDTree(p).query_pairs(eps * (1 + 1e-6), output_type="ndarray")
    i, j = pairs[:, 0], pairs[:, 1]
    near = ((p[i] - p[j]) ** 2).sum(1) <= eps * eps
    i, j = i[near], j[near]
    core = (1 + np.bincount(i, minlength=len(p))
            + np.bincount(j, minlength=len(p))) >= min_samples
    lo = np.full(len(p), len(p))
    hi = np.full(len(p), -1)
    for a, b in ((i, j), (j, i)):
        m = ~core[a] & core[b]
        np.minimum.at(lo, a[m], labels[b[m]])
        np.maximum.at(hi, a[m], labels[b[m]])
    return int((~core & (hi >= 0) & (lo != hi)).sum())


def http_get(base, path):
    """(body, wall ms) of one GET."""
    import urllib.request
    t0 = time.perf_counter()
    body = urllib.request.urlopen(base + path, timeout=300).read()
    return body, (time.perf_counter() - t0) * 1e3


def http_op(base, payload, expect_error=False):
    """POST /op; the reply's JSON (the error JSON of a 500 when
    expect_error)."""
    import urllib.error
    import urllib.request
    req = urllib.request.Request(base + "/op",
                                 data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        body = urllib.request.urlopen(req, timeout=600).read()
    except urllib.error.HTTPError as e:
        if expect_error and e.code == 500:
            return json.loads(e.read())
        raise
    if expect_error:
        raise AssertionError(f"[app] {payload['op']} did not fail")
    return json.loads(body)


def serve_cli(model, store, cam):
    """[app] check 10: python -m goi_tpu_torch.viewer on `model` as a
    subprocess; one SIBR request for `cam`; SIGTERM. Returns (the frame,
    the verification string, the summary line's dict, wall seconds to the
    first frame)."""
    import os
    import queue
    import threading
    from goi_tpu_torch.viewer.server import request_frame
    repo = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    with tempfile.TemporaryFile("w+") as err:
        proc = subprocess.Popen(
            [sys.executable, "-m", "goi_tpu_torch.viewer", "-m", model,
             "--port", "0", "--prompt_store", store, "--prompt", "target"],
            cwd=repo, stdout=subprocess.PIPE, stderr=err, text=True)
        lines = queue.Queue()
        reader = threading.Thread(
            target=lambda: [lines.put(ln) for ln in proc.stdout] + [
                lines.put(None)], daemon=True)
        reader.start()
        out = []
        try:
            port = None
            while port is None:
                line = lines.get(timeout=300)
                if line is None:
                    break
                out.append(line)
                if line.startswith("serving "):
                    port = int(line.rsplit(":", 1)[1].split()[0])
            if port is None:
                err.seek(0)
                raise AssertionError(f"[app] the viewer CLI stopped: "
                                     f"{''.join(out)}{err.read()[-4000:]}")
            frame, verify = request_frame("127.0.0.1", port, cam,
                                          timeout=300)
            wall = time.perf_counter() - t0
        finally:
            proc.terminate()
            proc.wait(timeout=120)
            reader.join(timeout=60)
        while True:
            line = lines.get_nowait() if not lines.empty() else None
            if line is None:
                break
            out.append(line)
        if proc.returncode != 0:
            err.seek(0)
            raise AssertionError(f"[app] the viewer CLI exited "
                                 f"{proc.returncode}: {err.read()[-4000:]}")
    tag = "[goi_tpu_torch.viewer] "
    summ = [ln for ln in out if ln.startswith(tag)]
    if len(summ) != 1:
        raise AssertionError(f"[app] no viewer summary line: {out}")
    return frame, verify, json.loads(summ[0][len(tag):]), wall


def app_phase():
    """[app]: the interactive query app at full width through its entry
    points: QueryWebApp over real HTTP on a localhost port (page, frame
    latency, text query through the aligner, retrieval, DBSCAN grouping,
    edits, OSH fine-tune, paths and the video op), render_batch,
    RasterConfig(debug=True), the DBSCAN check against its plain twin,
    and the SIBR viewer CLI as a subprocess. Returns the kernel launches
    of the path (this process's and the CLI's)."""
    import contextlib
    import io
    import os
    import pickle
    import shutil
    import torch
    from PIL import Image
    import goi_tpu_torch.app.session as session_mod
    from goi_tpu_torch.app.dbscan import dbscan, dbscan_plain
    from goi_tpu_torch.app.orbit_ngp import NGPOrbitCamera, orbit_pose
    from goi_tpu_torch.app.session import QuerySession
    from goi_tpu_torch.core.camera import focal2fov, fov2focal
    from goi_tpu_torch.data import scene as triplet
    from goi_tpu_torch.data.dataset import build_cameras
    from goi_tpu_torch.data.readers import load_scene_info
    from goi_tpu_torch.examples.rehearsal import write_colmap
    from goi_tpu_torch.query.text_encoder import encode_and_align
    from goi_tpu_torch.raster.preprocess import preprocess
    from goi_tpu_torch.raster.render import (DEBUG_DUMP, RasterConfig,
                                             render, render_batch,
                                             suggest_budgets)
    from goi_tpu_torch.semantic.codebook import SemanticDecoder
    from goi_tpu_torch.viewer.app import QueryWebApp
    from goi_tpu_torch.viewer.web import orbit_view_camera

    t_phase = time.perf_counter()
    smi = smi_line()
    root = tempfile.mkdtemp(prefix="goi_app_")
    app = None
    try:
        gen = torch.Generator().manual_seed(0)
        decoder = SemanticDecoder.create(gen, dim_in=SEM_DIM,
                                         dim_out=TAB_LEN, device="cuda")
        lut = torch.as_tensor(np.random.default_rng(2).normal(
            0, 1, (TAB_LEN, APE_DIM)).astype(np.float32), device="cuda")
        scene, code, target, near_mask = app_scene(decoder)

        enc, align, tokens, thresh, note = app_prompt(lut, code, root)

        ngp = NGPOrbitCamera(WIDTH, HEIGHT, r=3.5, fovy=50.0)
        views = []
        for i in range(APP_FRAMES + 1):
            ngp.orbit_to(0.0, 137.0 * i)
            views.append(ngp.to_camera(device="cuda"))
        group_q = dict(APP_VIEW, w=WIDTH, h=HEIGHT)
        group_cam = orbit_view_camera(group_q, 50.0, "cuda")
        anchors = []
        for az in APP_PATH[0]:
            ngp.orbit_to(APP_VIEW["elev"], az)
            anchors.append(np.linalg.inv(ngp.to_camera(
                device="cpu").world_view.numpy().astype(np.float64)))
        cfg = RasterConfig(max_instances=suggest_budgets(
            scene, views + [group_cam, ngp.to_camera(device="cuda")],
            margin=1.5)[0])
        sess = QuerySession(scene, decoder, lut, cfg, sim_thresh=thresh,
                            white_background=False, device="cuda")
        log(f"[app] scene: {N_GAUSS} Gaussians, {APP_NEAR} in a ball of "
            f"radius {APP_BALL} before the group view and {APP_FAR} above "
            f"every view carry code {code}; {note}; budget "
            f"{cfg.max_instances}")
        torch.cuda.synchronize()

        reset_counts()
        app = QueryWebApp(sess, text_fn=lambda p: encode_and_align(
            enc, align, p)[0], host="127.0.0.1", port=0)
        app.start()
        base = f"http://127.0.0.1:{app.port}"

        # 1. the page
        page, _ = http_get(base, "/")
        if b"revokeObjectURL" not in page:
            raise AssertionError("[app] the page does not revoke its URLs")

        # 3. the text query and the retrieval
        if http_op(base, {"op": "set_text", "prompt": "target"}) != {
                "ok": True, "prompt": "target"}:
            raise AssertionError("[app] set_text failed")
        if not torch.equal(sess.text_tokens, tokens):
            raise AssertionError("[app] the session's tokens differ")
        got = http_op(base, {"op": "retrieve"})["retrieved"]
        if got != APP_NEAR + APP_FAR or not np.array_equal(
                sess.rel_gs_index, target):
            raise AssertionError(f"[app] retrieved {got}, designed "
                                 f"{APP_NEAR + APP_FAR}")
        log(f"[app] set_text + retrieve over HTTP: {got} Gaussians, "
            f"exactly the designed groups")

        # 2. frame latency (bench.py's orbit), after a warm-up each
        for fmt, scale in (("jpeg", 1.0), ("png", 1.0), ("jpeg", 0.5)):
            def path(i):
                return (f"/frame?elev=0&azim={137.0 * i}&radius=3.5&w="
                        f"{WIDTH}&h={HEIGHT}&fmt={fmt}&scale={scale}")
            http_get(base, path(0))
            ms, size = [], 0
            for i in range(APP_FRAMES):
                body, t = http_get(base, path(i + 1))
                ms.append(t)
                size += len(body)
            img = Image.open(io.BytesIO(body))
            want = orbit_view_camera({"w": WIDTH, "h": HEIGHT,
                                      "scale": scale}, 50.0, "cpu")
            if img.format != fmt.upper() or img.size != (want.width,
                                                         want.height):
                raise AssertionError(f"[app] frame {img.format} {img.size}")
            p50, p95 = np.percentile(ms, [50, 95])
            log(f"[app] GET /frame {fmt} {img.size[0]}x{img.size[1]}: "
                f"{APP_FRAMES} frames p50 {p50:.2f} ms, p95 {p95:.2f} ms, "
                f"{size // APP_FRAMES} bytes each; {smi}")
        profile(lambda: app._frame({"elev": "0", "azim": "137", "radius":
                                    "3.5", "w": str(WIDTH), "h": str(HEIGHT),
                                    "fmt": "jpeg"}), "app frame (jpeg)")

        # 4. grouping: the query's own mask of the group view
        with torch.no_grad():
            out = render(sess.scene, group_cam, sess.bg, cfg)
        mask = (sess.compute_similarity(out["semantics"].reshape(
            SEM_DIM, -1).T) > 0).reshape(group_cam.height, group_cam.width)
        mask = mask.to(torch.uint8).cpu().numpy()
        seen = {}

        def timed_dbscan(points, eps, min_samples):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            labels = dbscan(points, eps, min_samples)
            torch.cuda.synchronize()
            seen.update(ms=(time.perf_counter() - t0) * 1e3,
                        n=len(points), labels=labels)
            return labels

        session_mod.dbscan = timed_dbscan
        try:
            t0 = time.perf_counter()
            kept = http_op(base, dict(op="group", mask=mask.tolist(),
                                      eps=APP_EPS,
                                      min_samples=APP_MIN_SAMPLES,
                                      **group_q))["kept"]
            group_ms = (time.perf_counter() - t0) * 1e3
        finally:
            session_mod.dbscan = dbscan
        lab = seen["labels"].cpu().numpy()
        if kept != APP_NEAR or not np.array_equal(sess.rel_gs_index,
                                                  near_mask):
            raise AssertionError(f"[app] group kept {kept}, the on-screen "
                                 f"group is {APP_NEAR}")
        log(f"[app] group (eps {APP_EPS}, min_samples {APP_MIN_SAMPLES}): "
            f"kept exactly the on-screen group ({kept}); the off-screen "
            f"cluster dropped; op {group_ms:.1f} ms wall; dbscan "
            f"{seen['ms']:.2f} ms at {seen['n']} points ({lab.max() + 1} "
            f"clusters, {(lab == -1).sum()} noise); {smi}")

        # 5. DBSCAN on the card against its plain twin
        n_sub, eps, min_samples = APP_CHECK
        pick = np.random.default_rng(11).choice(APP_NEAR + APP_FAR, n_sub,
                                                replace=False)
        sub = sess.scene.xyz[torch.as_tensor(np.nonzero(target)[0][pick],
                                             device="cuda")]
        got, got_ms = timed_ms(lambda: dbscan(sub, eps, min_samples))
        t0 = time.perf_counter()
        want = dbscan_plain(sub, eps, min_samples)
        plain_ms = (time.perf_counter() - t0) * 1e3
        if not torch.equal(got, want):
            raise AssertionError("[app] dbscan on the card differs from "
                                 "dbscan_plain")
        lab = want.cpu().numpy()
        shared = shared_borders(sub.cpu().numpy(), eps, min_samples, lab)
        if shared <= 0 or lab.max() < 2:
            raise AssertionError(f"[app] the DBSCAN check has {shared} "
                                 f"shared border points")
        log(f"[app] dbscan on {n_sub} points (eps {eps}, min_samples "
            f"{min_samples}): torch.equal to dbscan_plain; {lab.max() + 1} "
            f"clusters, {(lab == -1).sum()} noise, {shared} border points "
            f"shared by two clusters; card {got_ms:.2f} ms, plain "
            f"{plain_ms:.1f} ms (host); {smi}")

        # 7. a camera path and the video op
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        frames = sess.render_path(anchors, WIDTH, HEIGHT, ngp.fovx,
                                  ngp.fovy, steps_per_segment=APP_PATH[1])
        path_s = time.perf_counter() - t0
        n_path = (len(anchors) - 1) * APP_PATH[1] + 1
        if len(frames) != n_path or any(
                f.shape != (HEIGHT, WIDTH, 3) or not np.isfinite(f).all()
                for f in frames):
            raise AssertionError("[app] bad path frames")
        log(f"[app] render_path: {n_path} frames at {WIDTH}x{HEIGHT} in "
            f"{path_s:.2f} s, {n_path / path_s:.1f} frames/s; {smi}")
        writer = None
        for name in ("cv2", "imageio"):
            try:
                __import__(name)
                writer = name
                break
            except ImportError:
                pass
        if writer is None:
            log("[app] video op not run: neither cv2 nor imageio imports")
        else:
            out_mp4 = os.path.join(root, "path.mp4")
            res = http_op(base, {"op": "video", "anchors": [
                a.tolist() for a in anchors], "w": WIDTH, "h": HEIGHT,
                "fovx": ngp.fovx, "fovy": ngp.fovy, "steps": APP_PATH[1],
                "out": out_mp4})
            if res["frames"] != n_path or os.path.getsize(out_mp4) <= 0:
                raise AssertionError(f"[app] video op: {res}")
            log(f"[app] video op ({writer}): {res['frames']} frames, "
                f"{os.path.getsize(out_mp4)} bytes")

        # 8. render_batch of 3 views against three render() calls
        with torch.no_grad():
            batch = render_batch(sess.scene, views[:3], sess.bg, cfg)
            for i, cam in enumerate(views[:3]):
                one = render(sess.scene, cam, sess.bg, cfg)
                for k, v in one.items():
                    if not torch.equal(batch[k][i], v):
                        raise AssertionError(f"[app] render_batch {k}[{i}]")
        if int(batch["num_slots"].max()) > cfg.max_instances:
            raise AssertionError("[app] render_batch overflowed its budget")
        log("[app] render_batch of 3 views: every output torch.equal to "
            "three render() calls")

        # 9. RasterConfig(debug=True)
        dbg = RasterConfig(max_instances=cfg.max_instances, debug=True)
        # the nearest Gaussian of the view: the first its tiles blend
        with torch.no_grad():
            sp = preprocess(sess.scene, group_cam)
        depth = torch.where(sp.radius > 0, sp.depth,
                            torch.full_like(sp.depth, float("inf")))
        k = int(torch.argmin(depth))
        cwd = os.getcwd()
        os.chdir(root)
        try:
            with torch.no_grad():
                render(sess.scene, group_cam, sess.bg, dbg)
                xyz = sess.scene.xyz.clone()
                xyz[k, 0] = float("nan")
                out = render(sess.scene.replace(xyz=xyz), group_cam,
                             sess.bg, dbg)
                if os.path.exists(DEBUG_DUMP) or not (
                        torch.isfinite(out["render"]).all()
                        and torch.isfinite(out["semantics"]).all()):
                    raise AssertionError("[app] debug: a clean frame or a "
                                         "culled NaN position dumped")
                sem = sess.scene.semantics.clone()
                sem[k, 0] = float("nan")
                bad = sess.scene.replace(semantics=sem)
                said = io.StringIO()
                with contextlib.redirect_stdout(said):
                    render(bad, group_cam, sess.bg, dbg)
                with open(DEBUG_DUMP, "rb") as f:
                    dump = pickle.load(f)
                sp = preprocess(bad, group_cam)
            if "non-finite render output" not in said.getvalue() or any(
                    not np.array_equal(v, getattr(sp, n).cpu().numpy(),
                                       equal_nan=True)
                    for n, v in dump.items()) or len(dump) != len(
                        sp.__dataclass_fields__):
                raise AssertionError("[app] debug dump")
        finally:
            os.chdir(cwd)
        log(f"[app] debug: no dump for the clean frame nor for a NaN "
            f"position (culled); a NaN semantic channel dumped "
            f"{len(dump)} splat fields of {dump['mean2d'].shape[0]} rows, "
            f"which load")

        # 10. the SIBR viewer CLI on a model directory
        src = os.path.join(root, "scene")
        model = os.path.join(root, "model")
        eye = orbit_pose(APP_VIEW["elev"], APP_VIEW["azim"],
                         APP_VIEW["radius"])[:3, 3]
        focal = fov2focal(0.9, WIDTH)
        write_colmap(src, [(*look_at_pose(eye), None)], WIDTH, HEIGHT,
                     focal, fov2focal(focal2fov(focal, HEIGHT), HEIGHT), [],
                     np.zeros((8, 3)), np.full((8, 3), 128, np.uint8))
        t0 = time.perf_counter()
        triplet.save(os.path.join(model, "point_cloud", "iteration_1"),
                     sess.scene, decoder, lut)
        save_s = time.perf_counter() - t0
        with open(os.path.join(model, "cfg_args.json"), "w") as f:
            json.dump({"ModelParams": {"source_path": src}}, f)
        aligned = os.path.join(root, "prompts_aligned.npz")
        np.savez(aligned, target=tokens.cpu().numpy())
        cam = build_cameras(load_scene_info(src).train_cameras,
                            device="cuda")[0]
        frame, verify, summ, wall = serve_cli(model, aligned, cam)
        view_sess = QuerySession(sess.scene, decoder, lut, cfg,
                                 white_background=False, device="cuda")
        view_sess.set_text(tokens)
        want = view_sess.render_view(cam, as_u8=True)
        if not np.array_equal(frame, want) or verify != src or \
                summ["frames"] != 1:
            diff = np.abs(frame.astype(int) - want.astype(int))
            raise AssertionError(f"[app] viewer CLI frame: max diff "
                                 f"{diff.max()}, {(diff > 0).sum()} values "
                                 f"differ; {verify}, {summ}")
        log(f"[app] python -m goi_tpu_torch.viewer: a {cam.width}x"
            f"{cam.height} frame over the SIBR protocol equal to render_view"
            f"'s; {wall:.1f} s to it (triplet written in {save_s:.1f} s; "
            f"load {summ['load_s']:.2f} s, render {summ['render_s']:.3f} "
            f"s); launches {summ['launches']}")
        del view_sess

        # 6. the edits
        for op in ("segment", "delete_view"):
            if http_op(base, {"op": op}) != {"ok": True}:
                raise AssertionError(f"[app] {op}")
            http_get(base, f"/frame?elev={APP_VIEW['elev']}&azim="
                     f"{APP_VIEW['azim']}&radius=3.5&w={WIDTH}&h={HEIGHT}")
        xyz_before = sess.scene.xyz
        http_op(base, {"op": "move", "delta": [0.1, 0.0, -0.05]})
        moved = int((sess.scene.xyz != xyz_before).any(1).sum())
        http_op(base, {"op": "reset"})
        if moved != APP_NEAR or not torch.equal(sess.scene.xyz, xyz_before):
            raise AssertionError(f"[app] move/reset: {moved} moved")
        ft = http_op(base, dict(op="finetune", mask=mask.tolist(),
                                max_epochs=APP_OSH_EPOCHS, **group_q))
        if not (math.isfinite(ft["iou"]) and ft["epochs"] >= 0):
            raise AssertionError(f"[app] finetune: {ft}")
        http_op(base, {"op": "set_text", "prompt": "target"})
        http_op(base, {"op": "retrieve"})
        matched = int((sess.compute_similarity(sess.scene.get_semantics())
                       > 0).sum())
        before = int(sess.scene.num_valid)
        after = http_op(base, {"op": "delete_perm"})["num_valid"]
        if before - after != matched or matched != APP_NEAR + APP_FAR:
            raise AssertionError(f"[app] delete_perm: {before} -> {after}, "
                                 f"{matched} matched")
        refused = http_op(base, {"op": "edit_train"}, expect_error=True)
        if "no edit session configured" not in refused["error"]:
            raise AssertionError(f"[app] edit_train: {refused}")
        log(f"[app] segment, delete_view, move ({moved} moved) + reset "
            f"(xyz torch.equal), finetune (IoU {ft['iou']:.4f} in "
            f"{ft['epochs']} epochs), delete_perm ({before} -> {after}, "
            f"{matched} matched); the edit ops refused")
        app.stop()
        app = None
        torch.cuda.synchronize()
        launches = read_counts()
        for k2, n in summ["launches"].items():
            launches[k2] += n
        if min(launches[k2] for k2 in ("gather", "blend")) <= 0:
            raise AssertionError(f"[app] no kernel launched: {launches}")
        log(f"[app] phase {time.perf_counter() - t_phase:.1f} s; launches "
            f"{launches}")
        return launches
    finally:
        if app is not None:
            app.stop()
        shutil.rmtree(root, ignore_errors=True)


def export_scene(n, seed, device):
    """[export]'s seeded scene at the published widths (SH 3, 10
    semantic channels): n Gaussians on the unit sphere, isotropic scales
    uniform in EXPORT_SCALES, opacity EXPORT_OPACITY, DC colour red
    where y > 0 and blue where y < 0."""
    import torch
    from goi_tpu_torch.core.scene import GaussianScene
    rng = np.random.default_rng(seed)
    p = rng.normal(0, 1, (n, 3))
    p /= np.linalg.norm(p, axis=1, keepdims=True)
    col = np.where(p[:, 1:2] > 0, [EXPORT_RED], [EXPORT_BLUE])
    scene = GaussianScene.create(
        p.astype(np.float32), col.astype(np.float32), sh_degree=3,
        sem_dim=SEM_DIM, scales=rng.uniform(*EXPORT_SCALES, n).astype(
            np.float32), device=device)
    logit = math.log(EXPORT_OPACITY / (1 - EXPORT_OPACITY))
    return scene.replace(active_sh_degree=3,
                         opacity=torch.full_like(scene.opacity, logit))


def check_density(packed, axes, grid, label, points=None):
    """The density kernel's grid against density_grid_plain: on the
    whole grid, or on `points` seeded grid points. Returns the error
    relative to the grid's peak and the plain version's ms."""
    import torch
    from goi_tpu_torch.export.mesh import (PLAIN_PAIRS, density_grid_plain,
                                           mixture_at)
    r = axes.shape[0]
    flat = grid.reshape(-1)
    if points is None:
        want, plain_ms = timed_ms(lambda: density_grid_plain(packed, axes))
        got, what = flat, f"the whole {r}^3 grid"
        want = want.reshape(-1)
    else:
        rng = np.random.default_rng(5)
        idx = torch.as_tensor(rng.choice(r ** 3, points, replace=False),
                              device=grid.device)
        pts = torch.stack([axes[idx // (r * r)], axes[idx // r % r],
                           axes[idx % r]], 1)
        per = max(1, PLAIN_PAIRS // max(packed.shape[0], 1))

        def plain():
            return torch.cat([mixture_at(packed, pts[p:p + per])
                              for p in range(0, points, per)])

        want, plain_ms = timed_ms(plain)
        got, what = flat[idx], f"{points} seeded points of the {r}^3 grid"
    peak = float(grid.max())
    err = float((got - want).abs().max())
    if not peak > 0 or err > TOL_DENSITY * peak:
        raise AssertionError(f"[export] density_grid {label}: {err} against "
                             f"a peak of {peak} on {what}")
    log(f"[export] density_grid {label}: kernel vs plain on {what}: max abs "
        f"err {err:.3e} (peak {peak:.3f}, tolerance {TOL_DENSITY} x peak); "
        f"plain {plain_ms:.2f} ms")
    return err, plain_ms


def mesh_checks(mesh):
    """The shell's mesh: every edge shared by exactly two faces, Euler
    characteristic 4 (two spheres), every vertex radius in EXPORT_BAND,
    normals toward the lower density (out of the outer sphere, into the
    inner one)."""
    v, f = mesh.vertices, mesh.faces
    edges = np.sort(np.concatenate([f[:, [0, 1]], f[:, [1, 2]],
                                    f[:, [2, 0]]]), axis=1)
    uniq, counts = np.unique(edges, axis=0, return_counts=True)
    euler = len(v) - len(uniq) + len(f)
    rad = np.linalg.norm(v, axis=1)
    tri = v[f].astype(np.float64)
    c = tri.mean(axis=1)
    n = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    outer = np.linalg.norm(c, axis=1) > 1.0
    toward = (n * c).sum(1)
    oriented = float(np.where(outer, toward > 0, toward < 0).mean())
    log(f"[export] mesh: {len(f)} faces, {len(v)} vertices, {len(uniq)} "
        f"edges, Euler {euler}, radii {rad.min():.4f}..{rad.max():.4f}, "
        f"{int(outer.sum())} outer faces, oriented share {oriented:.5f}")
    if not (counts == 2).all():
        raise AssertionError(f"[export] {int((counts != 2).sum())} edges not "
                             f"shared by exactly two faces")
    if euler != 4:
        raise AssertionError(f"[export] Euler characteristic {euler} != 4")
    if rad.min() < EXPORT_BAND[0] or rad.max() > EXPORT_BAND[1]:
        raise AssertionError(f"[export] radii {rad.min()}..{rad.max()} "
                             f"outside {EXPORT_BAND}")
    if oriented < 0.99:
        raise AssertionError(f"[export] oriented share {oriented}")
    return outer


def hemisphere_colours(mesh, texture_size, outer):
    """Each outer face's chart texels, averaged: red above y = 0.1 and
    blue below y = -0.1 (the dominant channel over twice the other)."""
    from goi_tpu_torch.export.texture import _chart_layout
    v, f = mesh.vertices, mesh.faces
    _, bary, cell_pts, side = _chart_layout(len(f), texture_size)
    cell = texture_size / side
    fi = np.arange(len(f))
    px = np.clip((((fi % side) * cell)[:, None] + cell_pts[None, :, 0])
                 .astype(np.int64), 0, texture_size - 1)
    py = np.clip((((fi // side) * cell)[:, None] + cell_pts[None, :, 1])
                 .astype(np.int64), 0, texture_size - 1)
    face_rgb = mesh.albedo[py, px].mean(1)                 # (F, 3)
    cy = v[f][:, :, 1].mean(1)
    shares = {}
    for name, sel, hi, lo in (("red", outer & (cy > 0.1), 0, 2),
                              ("blue", outer & (cy < -0.1), 2, 0)):
        rgb = face_rgb[sel]
        shares[name] = float((rgb[:, hi] > 2 * rgb[:, lo]).mean())
        mean = rgb.mean(0)
        log(f"[export] {name} hemisphere: {int(sel.sum())} outer faces, "
            f"mean texel rgb {np.round(mean, 4).tolist()}, share with "
            f"{name} > 2x the other {shares[name]:.5f}")
        if not (mean[hi] > 2 * mean[lo] and shares[name] >= EXPORT_COLOUR):
            raise AssertionError(f"[export] the {name} hemisphere baked "
                                 f"{mean.tolist()}, share {shares[name]}")
    return shares


def export_phase():
    """[export]: geometry export at full width on its own seeded 1M
    shell scene: the density grid kernel (timed, against its plain
    version on seeded points and on a small scene's whole grid),
    marching tetrahedra on the card against the CPU, the shell mesh's
    topology, extract_textured_mesh with its defaults (the bake renders
    26 orbit views through the gather and blend kernels), the hemispheres'
    colours, and the OBJ, point-cloud and ellipsoid writers. Returns
    (the path's kernel launches, the density kernel's stats)."""
    import os
    import shutil
    import torch
    from goi_tpu_torch.core.ply import read_ply
    from goi_tpu_torch.export import marching as marching_mod
    from goi_tpu_torch.export import mesh as mesh_mod
    from goi_tpu_torch.export import texture as texture_mod
    from goi_tpu_torch.raster.render import RasterConfig, suggest_budgets

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    scene = export_scene(N_GAUSS, 0, "cuda")
    bg = torch.zeros(3, device="cuda")
    res = EXPORT_RES

    # the density kernel at the main path's shape, and its checks
    lo, hi = mesh_mod.grid_bounds(scene, None)
    axes = torch.as_tensor(mesh_mod.grid_axes(lo, hi, res), device="cuda")
    packed = mesh_mod.pack_gaussians(scene)
    grid = mesh_mod.mixture_grid(packed, axes)
    ms = median_ms(lambda: mesh_mod.mixture_grid(packed, axes), iters=3,
                   warmup=1)
    err, plain_ms = check_density(packed, axes, grid, f"{N_GAUSS // 1000}k",
                                  points=EXPORT_CHECK[0])
    pairs = packed.shape[0] * res ** 3
    # the least time: one ex2 a pair on the special-function units (16
    # lanes a clock on each SM against 128 float32 lanes) against ~8
    # float32 operations a pair and the bytes (inputs once, grid once)
    bound_s = max(pairs * 16 / PEAK_FP32_PER_S,
                  pairs * OPS_DENSITY / PEAK_FP32_PER_S,
                  (packed.numel() * 4 + axes.numel() * 4 + res ** 3 * 4)
                  / PEAK_BYTES_PER_S)
    log(f"[export] density_grid {packed.shape[0]} Gaussians x {res}^3 "
        f"points ({pairs:.4g} pairs): kernel {ms:.2f} ms (median of 3), "
        f"bound {bound_s * 1e3:.2f} ms (operations: the exponentials), "
        f"{pairs / (ms * 1e-3):.4g} pairs/s")
    small = export_scene(EXPORT_CHECK[1], 1, "cuda")
    s_lo, s_hi = mesh_mod.grid_bounds(small, None)
    s_axes = torch.as_tensor(mesh_mod.grid_axes(s_lo, s_hi, EXPORT_CHECK[2]),
                             device="cuda")
    s_packed = mesh_mod.pack_gaussians(small)
    s_grid, s_ms = timed_ms(lambda: mesh_mod.mixture_grid(s_packed, s_axes))
    check_density(s_packed, s_axes, s_grid, f"{EXPORT_CHECK[1] // 1000}k")
    log(f"[export] density_grid {EXPORT_CHECK[1] // 1000}k x "
        f"{EXPORT_CHECK[2]}^3: kernel {s_ms:.3f} ms")
    del small, s_packed, s_grid, packed, grid

    # the stages of extract_textured_mesh, timed where the entry point
    # calls them: density_tensor (grid), marching_tetrahedra, bake_texture
    stages = {}
    orig = {"density_tensor": mesh_mod.density_tensor,
            "marching_tetrahedra": marching_mod.marching_tetrahedra,
            "bake_texture": texture_mod.bake_texture}
    kept = {}

    def timed(name, mod):
        def run(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = orig[name](*a, **kw)
            torch.cuda.synchronize()
            stages[name] = time.perf_counter() - t0
            kept[name] = (a, out)
            return out
        setattr(mod, name, run)

    timed("density_tensor", mesh_mod)
    timed("marching_tetrahedra", marching_mod)
    timed("bake_texture", texture_mod)
    try:
        # the budget of the bake's 26 views, from the mesh it will bake
        mesh0 = marching_mod.extract_mesh(scene)
        center, radius = texture_mod.bake_center_radius(mesh0.vertices)
        cams = [c for _, c in texture_mod.orbit_cameras(center, radius,
                                                        device="cuda")]
        mi, _ = suggest_budgets(scene, cams, margin=1.2)
        cfg = RasterConfig(max_instances=mi)
        log(f"[export] bake budget max_instances={mi} over the 26 views")
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        mesh = texture_mod.extract_textured_mesh(scene, bg, cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counts()
    finally:
        mesh_mod.density_tensor = orig["density_tensor"]
        marching_mod.marching_tetrahedra = orig["marching_tetrahedra"]
        texture_mod.bake_texture = orig["bake_texture"]
    for k in ("density_grid", "gather", "blend"):
        if launches[k] <= 0:
            raise AssertionError(f"[export] {k} not launched: {launches}")
    if launches["density_grid"] != 1 or launches["gather"] < 26:
        raise AssertionError(f"[export] launches {launches}")
    if not (np.array_equal(mesh.vertices, mesh0.vertices)
            and np.array_equal(mesh.faces, mesh0.faces)):
        raise AssertionError("[export] two extractions of one scene differ")
    log(f"[export] extract_textured_mesh (resolution {res}, texture 1024, "
        f"26 views at 512x512, density_thresh 1.0): {wall:.2f} s; grid "
        f"{stages['density_tensor']:.3f} s, marching "
        f"{stages['marching_tetrahedra']:.3f} s, bake "
        f"{stages['bake_texture']:.3f} s; launches {launches}")

    # marching on the card against the CPU on the same grid
    (grid, iso, origin, voxel), _ = kept["marching_tetrahedra"]
    cpu = orig["marching_tetrahedra"](grid.cpu(), iso, origin, voxel)
    if not (np.array_equal(cpu.vertices, mesh.vertices)
            and np.array_equal(cpu.faces, mesh.faces)):
        raise AssertionError("[export] marching on the card != on the CPU")
    log(f"[export] marching_tetrahedra on the card equal to the CPU's "
        f"(vertices and faces)")
    outer = mesh_checks(mesh)
    if mesh.albedo.shape != (1024, 1024, 3) or \
            mesh.uvs.shape != (3 * len(mesh.faces), 2):
        raise AssertionError(f"[export] albedo {mesh.albedo.shape} uvs "
                             f"{mesh.uvs.shape}")
    hemisphere_colours(mesh, 1024, outer)

    # the writers
    root = tempfile.mkdtemp(prefix="goi_export_")
    try:
        t0 = time.perf_counter()
        obj = os.path.join(root, "shell.obj")
        mesh.write_obj(obj)
        t_obj = time.perf_counter() - t0
        t0 = time.perf_counter()
        n_pc = mesh_mod.export_colored_point_cloud(
            os.path.join(root, "points.ply"), scene)
        t_pc = time.perf_counter() - t0
        t0 = time.perf_counter()
        n_ell = mesh_mod.export_ellipsoids_obj(
            os.path.join(root, "ellipsoids.obj"), scene)
        t_ell = time.perf_counter() - t0
        for name in ("shell.obj", "shell.mtl", "shell.png", "points.ply",
                     "ellipsoids.obj"):
            if not os.path.exists(os.path.join(root, name)):
                raise AssertionError(f"[export] {name} not written")
        counts = {"v ": 0, "vt": 0, "f ": 0}
        with open(obj) as fh:
            for line in fh:
                if line[:2] in counts:
                    counts[line[:2]] += 1
        if counts != {"v ": len(mesh.vertices), "vt": 3 * len(mesh.faces),
                      "f ": len(mesh.faces)}:
            raise AssertionError(f"[export] OBJ reloads {counts}")
        if n_pc != N_GAUSS or len(read_ply(os.path.join(
                root, "points.ply"))["x"]) != N_GAUSS:
            raise AssertionError(f"[export] point cloud {n_pc}")
        with open(os.path.join(root, "ellipsoids.obj")) as fh:
            ell = sum(1 for line in fh if line[:2] in ("v ", "f "))
        if n_ell != min(100_000, N_GAUSS) or ell != 14 * n_ell:
            raise AssertionError(f"[export] ellipsoids {n_ell}, {ell} lines")
        sizes = {name: os.path.getsize(os.path.join(root, name))
                 for name in sorted(os.listdir(root))}
    finally:
        shutil.rmtree(root, ignore_errors=True)
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"[export] writes: write_obj {t_obj:.2f} s (OBJ reloads "
        f"{counts['f ']} faces), colored point cloud {t_pc:.2f} s ({n_pc} "
        f"points), ellipsoids {t_ell:.2f} s ({n_ell}); bytes {sizes}")
    log(f"[export] stages (s): grid {stages['density_tensor']:.3f}, "
        f"marching {stages['marching_tetrahedra']:.3f}, bake "
        f"{stages['bake_texture']:.3f}, writes {t_obj + t_pc + t_ell:.3f}; "
        f"{len(mesh.faces)} faces, {len(mesh.vertices)} vertices; peak "
        f"{peak_gb:.2f} GiB; phase {time.perf_counter() - t_phase:.1f} s")
    stats = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                 bound_ms=bound_s * 1e3, bound_by="operations",
                 library_ms=None,
                 note=f"plain_ms: the plain version on {EXPORT_CHECK[0]} of "
                      f"the {res ** 3} grid points (all Gaussians), the "
                      f"kernel's ms on the whole grid")
    return launches, stats


def tower_assets(root):
    """The synthetic vocab assets: a gzip BPE merge table in the public
    table's format and a BERT vocab dict."""
    import gzip
    import os
    from goi_tpu_torch.query.bert import make_test_vocab
    bpe = os.path.join(root, "bpe_merges.txt.gz")
    with gzip.open(bpe, "wt", encoding="utf-8") as f:
        f.write("#version: 0.2\n" + "\n".join(TOWER_MERGES) + "\n")
    return bpe, make_test_vocab(TOWER_WORDS)


def cpu_copy(build, model):
    """The same tower built on the CPU with `model`'s weights."""
    twin = build("cpu")
    twin.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    return twin.eval()


def towers_card_vs_cpu(bpe, vocab, view):
    """Each tower at full width and reduced depth on the card and on the
    CPU through the same modules and weights."""
    import dataclasses
    import torch
    from goi_tpu_torch.query import clip_text, grounding, sam
    from goi_tpu_torch.query.bert import BertTokenizer
    n_text, n_sam, n_dino = TOWER_CHECK_DEPTH
    gen = torch.Generator(device="cuda").manual_seed(11)
    errs = {}

    def check(name, a, b):
        ok, e = close_to_peak(a.cpu(), b, *TOL_TOWER)
        if not ok:
            raise AssertionError(f"[towers] {name}: card vs CPU {e}")
        errs[name] = e

    with torch.inference_mode():
        cfg = dataclasses.replace(clip_text.CLIP_TEXT_BIGE, layers=n_text)
        card = clip_text.init_clip_text_(
            clip_text.CLIPTextTransformer(cfg, device="cuda"), gen)
        cpu = cpu_copy(lambda d: clip_text.CLIPTextTransformer(cfg, d), card)
        toks = clip_text.ClipTokenizer(bpe, cfg.context_length)(
            [TOWER_PROMPT, "a blue sofa near a lamp"])
        a, b = card(torch.as_tensor(toks, device="cuda")), cpu(
            torch.as_tensor(toks))
        check("text eot", a["eot"], b["eot"])
        check("text tokens", a["tokens"], b["tokens"])
        del card, cpu

        scfg = dataclasses.replace(sam.SAM_VIT_H, depth=n_sam,
                                   global_attn=(n_sam - 1,))
        card = sam.SamTorch(sam.init_sam_(sam.SAM(scfg, device="cuda"), gen))
        cpu = sam.SamTorch(cpu_copy(lambda d: sam.SAM(scfg, d), card.model))
        for s in (card, cpu):
            s.set_image(view)
        check("sam embedding", card._emb, cpu._emb)
        boxes = np.array([[100, 80, 700, 600], [400, 300, 1200, 900]],
                         np.float32)
        masks = []
        for s in (card, cpu):
            pe = s.model.prompt_encoder
            sparse = pe.encode_boxes(torch.as_tensor(
                boxes, device=s.device) * (1024 / max(view.shape[:2])))
            masks.append(s.model.mask_decoder(
                cpu._emb.to(s.device).expand(2, -1, -1, -1), pe.dense_pe(),
                sparse, pe.no_mask(2), False))
        check("sam mask logits", masks[0][0], masks[1][0])
        check("sam iou", masks[0][1], masks[1][1])
        del card, cpu, masks

        gcfg = dataclasses.replace(grounding.GDINO_SWINT, enc_layers=n_dino,
                                   dec_layers=n_dino)
        tok = BertTokenizer(vocab)
        card = grounding.GroundingDINOTorch(grounding.init_grounding_(
            grounding.GroundingDINO(gcfg, device="cuda"), gen), tok)
        cpu = grounding.GroundingDINOTorch(cpu_copy(
            lambda d: grounding.GroundingDINO(gcfg, d), card.model), tok)
        outs = []
        for det in (card, cpu):
            args, _ = det.inputs(view, TOWER_PROMPT)
            enc = det.model.encode(*args)
            outs.append((enc, det.model.select(enc)))
        (ea, sa), (eb, sb) = outs
        check("dino memory", ea["memory"], eb["memory"])
        check("dino memory_text", ea["memory_text"], eb["memory_text"])
        check("dino scores", sa["score"], sb["score"])
        # the selection: near-equal scores may swap places, so the CPU
        # decodes the card's selection, whose CPU scores must be the
        # CPU's own top ones within the tolerance
        idx = sa["topk_idx"].cpu()
        top = sb["score"].gather(1, idx)
        check("dino selected scores", top, sb["score"].topk(
            gcfg.num_queries).values)
        same = int((idx == sb["topk_idx"]).sum())
        da = card.model.decode(ea, sa)
        db = cpu.model.decode(eb, dict(sb, topk_idx=idx))
        check("dino boxes", da["pred_boxes"], db["pred_boxes"])
        fin = torch.isfinite(db["pred_logits"])
        if not torch.equal(torch.isfinite(da["pred_logits"]).cpu(), fin):
            raise AssertionError("[towers] dino logits: -inf differ")
        la = da["pred_logits"]
        check("dino logits", la[fin.to(la.device)], db["pred_logits"][fin])
    log(f"[towers] card vs CPU at full width, depth {n_text} text layers, "
        f"{n_sam} SAM blocks (the last global), {n_dino} + {n_dino} "
        f"GroundingDINO layers; max |diff| "
        + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
        + f" (rtol {TOL_TOWER[0]}, atol {TOL_TOWER[1]} of the peak); "
        f"{same}/{gcfg.num_queries} queries selected in the CPU's order")


def towers_phase():
    """[towers]: the frozen towers at full width behind the query app:
    a prompt through ClipTokenizer, the bigE text tower and the aligner
    into set_text over HTTP (bit for bit encode_and_align's), a frame,
    then the OSH fine-tune with no client mask, its mask from res_fn =
    TorchRESProvider(GroundingDINO Swin-T/BERT-base, SAM ViT-H) on the
    rendered view. Returns the kernel launches of that path."""
    import shutil
    import torch
    from goi_tpu_torch.app.session import QuerySession
    from goi_tpu_torch.query import deform_attn
    from goi_tpu_torch.query.align import VisionLanguageAlign
    from goi_tpu_torch.query.bert import BertTokenizer
    from goi_tpu_torch.query.clip_text import (CLIP_TEXT_BIGE,
                                               CLIPTextTransformer,
                                               TorchCLIPTextEncoder,
                                               init_clip_text_)
    from goi_tpu_torch.query.grounding import (GDINO_SWINT, GroundingDINO,
                                               GroundingDINOTorch,
                                               init_grounding_)
    from goi_tpu_torch.query.res import TorchRESProvider
    from goi_tpu_torch.query.sam import SAM, SAM_VIT_H, SamTorch, init_sam_
    from goi_tpu_torch.query.text_encoder import encode_and_align
    from goi_tpu_torch.raster.render import RasterConfig, suggest_budgets
    from goi_tpu_torch.semantic.codebook import SemanticDecoder
    from goi_tpu_torch.viewer.app import QueryWebApp
    from goi_tpu_torch.viewer.web import orbit_view_camera

    t_phase = time.perf_counter()
    smi = smi_line()
    root = tempfile.mkdtemp(prefix="goi_towers_")
    app = None
    try:
        torch.cuda.reset_peak_memory_stats()
        bpe, vocab = tower_assets(root)
        scene = make_scene(N_GAUSS, seed=0, device="cuda")
        decoder = SemanticDecoder.create(torch.Generator().manual_seed(0),
                                         dim_in=SEM_DIM, dim_out=TAB_LEN,
                                         device="cuda")
        lut = torch.as_tensor(np.random.default_rng(2).normal(
            0, 1, (TAB_LEN, APE_DIM)).astype(np.float32), device="cuda")
        view_q = dict(APP_VIEW, w=WIDTH, h=HEIGHT)
        cam = orbit_view_camera(view_q, 50.0, "cuda")
        cfg = RasterConfig(max_instances=suggest_budgets(scene, [cam],
                                                         margin=1.5)[0])
        sess = QuerySession(scene, decoder, lut, cfg,
                            white_background=False, device="cuda")
        view = sess.render_view(cam, overlay=False)
        towers_card_vs_cpu(bpe, vocab, view)

        # the towers at full width, seeded on the card
        gen = torch.Generator(device="cuda").manual_seed(7)
        t0 = time.perf_counter()
        with torch.no_grad():
            text = init_clip_text_(CLIPTextTransformer(CLIP_TEXT_BIGE,
                                                       device="cuda"), gen)
            dino = init_grounding_(GroundingDINO(GDINO_SWINT, device="cuda"),
                                   gen)
            dino.transformer.decoder.norm.weight.mul_(TOWER_LOGIT_SCALE)
            sam_model = init_sam_(SAM(SAM_VIT_H, device="cuda"), gen)
        torch.cuda.synchronize()
        n_par = {k: sum(p.numel() for p in m.parameters())
                 for k, m in (("text", text), ("dino", dino),
                              ("sam", sam_model))}
        log(f"[towers] built on the card in {time.perf_counter() - t0:.1f} "
            f"s: bigE text {n_par['text']:,} parameters, GroundingDINO "
            f"Swin-T + BERT-base {n_par['dino']:,}, SAM ViT-H "
            f"{n_par['sam']:,} (float32, TF32 off)")
        enc = TorchCLIPTextEncoder(text, bpe)
        align = VisionLanguageAlign.create(seed=0, device="cuda")
        det = GroundingDINOTorch(dino, BertTokenizer(vocab))
        predictor = SamTorch(sam_model)

        # the box threshold, fixed from the seeded run's scores
        _, scores, _ = det.predict(view, TOWER_PROMPT, box_threshold=0.0)
        s = np.sort(scores)[::-1]
        if not s[TOWER_BOXES - 1] > s[TOWER_BOXES]:
            raise AssertionError(f"[towers] scores tie at {TOWER_BOXES}: "
                                 f"{s[:TOWER_BOXES + 1]}")
        thresh = float(s[TOWER_BOXES - 1] + s[TOWER_BOXES]) / 2
        prov = TorchRESProvider(det, predictor, box_threshold=thresh)
        reached = []
        predict_boxes = predictor.predict_boxes

        def counting_predict_boxes(boxes, multimask=False):
            reached.append(len(boxes))
            return predict_boxes(boxes, multimask)

        predictor.predict_boxes = counting_predict_boxes
        torch.cuda.synchronize()

        # the main path: prompt -> set_text, a frame, the mask-free
        # finetune through res_fn, all over HTTP
        reset_counts()
        app = QueryWebApp(sess, text_fn=lambda p: encode_and_align(
            enc, align, p)[0], res_fn=prov.predict_mask, host="127.0.0.1",
            port=0)
        app.start()
        base = f"http://127.0.0.1:{app.port}"
        t0 = time.perf_counter()
        if http_op(base, {"op": "set_text", "prompt": TOWER_PROMPT}) != {
                "ok": True, "prompt": TOWER_PROMPT}:
            raise AssertionError("[towers] set_text failed")
        set_text_ms = (time.perf_counter() - t0) * 1e3
        want = encode_and_align(enc, align, TOWER_PROMPT)[0]
        if not torch.equal(sess.text_tokens, want):
            raise AssertionError("[towers] set_text differs from "
                                 "encode_and_align")
        qs = "&".join(f"{k}={v}" for k, v in view_q.items())
        _, frame_ms = http_get(base, f"/frame?{qs}&fmt=jpeg")
        t0 = time.perf_counter()
        ft = http_op(base, dict(op="finetune", max_epochs=APP_OSH_EPOCHS,
                                **view_q))
        finetune_s = time.perf_counter() - t0
        if not (ft["ok"] and math.isfinite(ft["iou"]) and ft["epochs"] >= 0):
            raise AssertionError(f"[towers] finetune: {ft}")
        if reached != [TOWER_BOXES]:
            raise AssertionError(f"[towers] boxes that reached SAM: "
                                 f"{reached}, designed {TOWER_BOXES}")
        _, osh_ms = http_get(base, f"/frame?{qs}&fmt=jpeg")
        app.stop()
        app = None
        torch.cuda.synchronize()
        launches = read_counts()
        if min(launches[k] for k in ("gather", "blend")) <= 0:
            raise AssertionError(f"[towers] no kernel launched: {launches}")
        log(f"[towers] over HTTP: set_text {set_text_ms:.1f} ms (bit for "
            f"bit encode_and_align's), frame {frame_ms:.1f} ms, finetune "
            f"with no client mask {finetune_s:.2f} s (IoU {ft['iou']:.4f} in "
            f"{ft['epochs']} epochs; {reached[0]} boxes reached SAM at box "
            f"threshold {thresh:.6f}), the OSH frame {osh_ms:.1f} ms; "
            f"launches {launches}")

        # the mask: shape, not empty, the same on a second run
        masks = [prov.predict_mask(view, TOWER_PROMPT) for _ in range(2)]
        m = masks[0]
        if m is None or m.shape != view.shape[:2] or not m.any():
            raise AssertionError(f"[towers] mask: {m}")
        if not np.array_equal(masks[0], masks[1]):
            raise AssertionError("[towers] two runs gave other masks")
        if reached != [TOWER_BOXES] * 3:
            raise AssertionError(f"[towers] boxes: {reached}")

        # timings at full width (host clock around synchronised calls)
        def wall_ms(fn, n=3):
            out, times = None, []
            for _ in range(n):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn()
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            return out, float(np.median(times))

        _, prompt_ms = wall_ms(lambda: encode_and_align(enc, align,
                                                        TOWER_PROMPT))
        _, tok_ms = wall_ms(lambda: enc.tokenizer([TOWER_PROMPT]))
        (boxes, kept, _), dino_ms = wall_ms(
            lambda: det.predict(view, TOWER_PROMPT, thresh))
        seen = []
        core = deform_attn.ms_deform_attn_core

        def capture(*a):
            seen.append(a)
            return core(*a)

        deform_attn.ms_deform_attn_core = capture
        try:
            det.predict(view, TOWER_PROMPT, thresh)
        finally:
            deform_attn.ms_deform_attn_core = core
        v, shapes, loc, aw = seen[0]
        with torch.inference_mode():
            core_ms = median_ms(lambda: core(v, shapes, loc, aw))
        _, set_image_ms = wall_ms(lambda: predictor.set_image(view))
        h, w = view.shape[:2]
        b = boxes * np.asarray([w, h, w, h], np.float32)
        xyxy = np.concatenate([b[:, :2] - b[:, 2:] / 2,
                               b[:, :2] + b[:, 2:] / 2], 1)
        _, decode_ms = wall_ms(lambda: predict_boxes(xyxy))
        _, res_ms = wall_ms(lambda: prov.predict_mask(view, TOWER_PROMPT))
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        log(f"[towers] {smi}: prompt {prompt_ms:.2f} ms (tokens "
            f"{tok_ms:.3f} ms, bigE tower + aligner), GroundingDINO "
            f"{dino_ms:.1f} ms at {'x'.join(map(str, det.input_hw(h, w)))} "
            f"(the published resize of the {h}x{w} view) with a "
            f"{GDINO_SWINT.text_pad}-token "
            f"caption and {GDINO_SWINT.num_queries} queries, "
            f"ms_deform_attn_core {core_ms:.3f} ms (encoder layer 0: "
            f"{loc.shape[1]} queries, levels {list(shapes)}), SAM set_image "
            f"{set_image_ms:.1f} ms, SAM decode {decode_ms:.1f} ms for "
            f"{len(xyxy)} boxes, res_fn {res_ms:.1f} ms, mask "
            f"{int(m.sum())} of {m.size} pixels; peak {peak:.2f} GiB; "
            f"phase {time.perf_counter() - t_phase:.1f} s")
        profile(lambda: encode_and_align(enc, align, TOWER_PROMPT),
                "prompt (bigE tower + aligner)")
        profile(lambda: prov.predict_mask(view, TOWER_PROMPT), "res_fn")
        return launches
    finally:
        if app is not None:
            app.stop()
        shutil.rmtree(root, ignore_errors=True)


def sd_card_vs_cpu(gen):
    """The UNet at reduced depth and the VAE at full width on the card and
    on the CPU through the same modules and weights; returns the max
    |diff| of each output."""
    import dataclasses
    import torch
    from goi_tpu_torch.guidance.sd_torch import (AutoencoderKL, SDConfig,
                                                 UNet2DCondition, init_sd_)
    full = SDConfig()
    cfg = dataclasses.replace(full, **EDIT_CHECK_UNET)
    errs = {}

    def check(name, a, b):
        ok, e = close_to_peak(a.cpu(), b, *TOL_SD)
        if not ok or not float(b.abs().max()) > 0:
            raise AssertionError(f"[edit] {name}: card vs CPU {e}")
        errs[name] = e

    with torch.no_grad():
        unet = init_sd_(UNet2DCondition(cfg, device="cuda"), gen)
        cpu = cpu_copy(lambda d: UNet2DCondition(cfg, d), unet)
        x = torch.randn(2, cfg.in_channels, 64, 64, generator=gen,
                        device="cuda")
        t = torch.tensor([500, 21], device="cuda")
        ctx = torch.randn(2, 77, cfg.cross_attention_dim, generator=gen,
                          device="cuda")
        check("unet eps", unet(x, t, ctx), cpu(x.cpu(), t.cpu(), ctx.cpu()))
        del unet, cpu
        vae = init_sd_(AutoencoderKL(full, device="cuda"), gen)
        cpu = cpu_copy(lambda d: AutoencoderKL(full, d), vae)
        r = EDIT_CHECK_IMG
        img = torch.rand(2, 3, r, r, generator=gen, device="cuda") * 2 - 1
        check("vae encode", vae.encode(img), cpu.encode(img.cpu()))
        lat = torch.randn(2, full.latent_channels, r // 8, r // 8,
                          generator=gen, device="cuda")
        check("vae decode", vae.decode(lat), cpu.decode(lat.cpu()))
    log(f"[edit] card vs CPU: the UNet's blocks {cfg.block_out_channels} "
        f"(cross-attention {cfg.cross_attention_dim}, "
        f"{cfg.attention_head_dim} heads) on 64x64 latents, the VAE at full "
        f"width on {r}x{r}; max |diff| "
        + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
        + f" (rtol {TOL_SD[0]}, atol {TOL_SD[1]} of the peak)")
    return errs


def edit_phase():
    """[edit]: the SDS edit session at full width behind the query app:
    the SD-1.5-inpainting UNet + VAE with seeded weights, the [app]
    scene's prompt over HTTP, edit_precompute over the edit cameras (the
    relative cameras exactly the EDIT_NEAR near views, grad_mask exactly
    the designed groups), edit_train for EDIT_EPOCHS epochs at batch 2
    (every loss finite, only target Gaussians changed, num_valid kept, the
    app rendering the edited scene), then the UNet, VAE, SDS and step
    times and one profiled step. Returns the kernel launches of the path
    (precompute and train)."""
    import os
    import shutil
    import torch
    from goi_tpu_torch.app.edit import EditSession
    from goi_tpu_torch.app.orbit_ngp import NGPOrbitCamera
    from goi_tpu_torch.app.session import QuerySession
    from goi_tpu_torch.guidance import InpaintSDS
    from goi_tpu_torch.guidance.sd_torch import (AutoencoderKL, SDConfig,
                                                 TorchDiffusionBackend,
                                                 UNet2DCondition, init_sd_)
    from goi_tpu_torch.query.text_encoder import encode_and_align
    from goi_tpu_torch.raster.render import RasterConfig, render, \
        suggest_budgets
    from goi_tpu_torch.semantic.codebook import SemanticDecoder
    from goi_tpu_torch.viewer.app import QueryWebApp

    t_phase = time.perf_counter()
    smi = smi_line()
    root = tempfile.mkdtemp(prefix="goi_edit_")
    app = None
    try:
        torch.cuda.reset_peak_memory_stats()
        gen = torch.Generator(device="cuda").manual_seed(13)
        sd_card_vs_cpu(gen)

        # the model at full width, seeded on the card
        full = SDConfig()
        t0 = time.perf_counter()
        with torch.no_grad():
            unet = init_sd_(UNet2DCondition(full, device="cuda"), gen)
            vae = init_sd_(AutoencoderKL(full, device="cuda"), gen)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        shapes = {"unet." + k: list(v.shape)
                  for k, v in unet.state_dict().items()}
        shapes.update({"vae." + k: list(v.shape)
                       for k, v in vae.state_dict().items()})
        golden = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              "tests", "golden", "sd_golden.json")
        with open(golden) as f:
            if shapes != json.load(f)["manifest_full"]:
                raise AssertionError("[edit] the modules' state_dict is not "
                                     "the checkpoint's manifest")
        n_unet = sum(p.numel() for p in unet.parameters())
        n_vae = sum(p.numel() for p in vae.parameters())
        backend = TorchDiffusionBackend(unet, vae, full)
        pos = torch.randn(77, full.cross_attention_dim, generator=gen,
                          device="cuda")
        neg = torch.randn(77, full.cross_attention_dim, generator=gen,
                          device="cuda")
        sds = InpaintSDS(backend, pos, neg)
        log(f"[edit] SD-1.5-inpainting at full width built on the card in "
            f"{build_s:.1f} s: UNet {n_unet:,} + VAE {n_vae:,} = "
            f"{n_unet + n_vae:,} parameters (float32, TF32 off), state_dict "
            f"keys and shapes equal to manifest_full")

        # the app scene, its prompt, the edit cameras
        decoder = SemanticDecoder.create(torch.Generator().manual_seed(0),
                                         dim_in=SEM_DIM, dim_out=TAB_LEN,
                                         device="cuda")
        lut = torch.as_tensor(np.random.default_rng(2).normal(
            0, 1, (TAB_LEN, APE_DIM)).astype(np.float32), device="cuda")
        scene, code, target, _ = app_scene(decoder)
        enc, align, tokens, thresh, note = app_prompt(lut, code, root)
        near_ngp = NGPOrbitCamera(WIDTH, HEIGHT, r=3.5, fovy=50.0)
        away_ngp = NGPOrbitCamera(WIDTH, HEIGHT, r=EDIT_AWAY_R, fovy=50.0)
        near, away = [], []
        for i in range(EDIT_NEAR):
            near_ngp.orbit_to(APP_VIEW["elev"] + 4.0 * (i % 2),
                              APP_VIEW["azim"] + 6.0 * (i - EDIT_NEAR // 2))
            near.append(near_ngp.to_camera(device="cuda"))
        for i in range(EDIT_AWAY):
            away_ngp.orbit_to(0.0, APP_VIEW["azim"] + 180.0
                              + 12.0 * (i - EDIT_AWAY // 2))
            away.append(away_ngp.to_camera(device="cuda"))
        half = EDIT_NEAR // 2
        cams = near[:half] + away + near[half:]
        cfg = RasterConfig(max_instances=suggest_budgets(scene, cams,
                                                         margin=1.5)[0])
        sess = QuerySession(scene, decoder, lut, cfg, sim_thresh=thresh,
                            white_background=False, device="cuda")
        sess.set_text(tokens)

        def target_pixels(cam):
            with torch.no_grad():
                out = render(scene, cam, torch.ones(3, device="cuda"), cfg)
                return int((sess.compute_similarity(out["semantics"].reshape(
                    SEM_DIM, -1).T) > 0).sum())

        n_near = [target_pixels(c) for c in near]
        n_away = [target_pixels(c) for c in away]
        if min(n_near) < 0.1 * max(n_near) or max(n_away) >= 0.1 * max(
                n_near):
            raise AssertionError(f"[edit] target pixels: near {n_near}, "
                                 f"far side {n_away}")
        log(f"[edit] scene: {N_GAUSS} Gaussians, {APP_NEAR} in the ball and "
            f"{APP_FAR} far above carry code {code}; {note}; budget "
            f"{cfg.max_instances}; target pixels of the {EDIT_NEAR} near "
            f"views {n_near}, of the {EDIT_AWAY} far-side views {n_away} "
            f"(min_relative_ratio 0.1 of {max(n_near)})")
        edit = EditSession(scene, sds, cfg, batch_size=2)
        torch.cuda.synchronize()

        app = QueryWebApp(sess, text_fn=lambda p: encode_and_align(
            enc, align, p)[0], edit=edit, edit_cameras=cams,
            host="127.0.0.1", port=0)
        app.start()
        base = f"http://127.0.0.1:{app.port}"
        if http_op(base, {"op": "set_text", "prompt": "target"}) != {
                "ok": True, "prompt": "target"}:
            raise AssertionError("[edit] set_text failed")
        view = (f"/frame?elev={APP_VIEW['elev']}&azim={APP_VIEW['azim']}"
                f"&radius=3.5&w={WIDTH}&h={HEIGHT}&fmt=png")
        frame_before, _ = http_get(base, view)
        before = {k: v.clone() for k, v in sess.scene.params().items()}
        torch.cuda.synchronize()

        # the main path: edit_precompute and edit_train over HTTP
        reset_counts()
        t0 = time.perf_counter()
        got = http_op(base, {"op": "edit_precompute"})
        precompute_s = time.perf_counter() - t0
        if got != {"ok": True, "relative_cameras": EDIT_NEAR}:
            raise AssertionError(f"[edit] precompute: {got}, designed "
                                 f"{EDIT_NEAR}")
        state = json.loads(http_get(base, "/state")[0])
        if state["edit"] != {"relative_cameras": EDIT_NEAR} or not all(
                torch.equal(rc.camera.world_view, c.world_view)
                for rc, c in zip(edit.relative_cameras, near)):
            raise AssertionError(f"[edit] relative cameras: {state}")
        tgt = torch.as_tensor(target, device="cuda")
        if not torch.equal(edit.grad_mask > 0, tgt):
            raise AssertionError("[edit] grad_mask is not the designed "
                                 "groups")
        step_ms, losses = [], []
        step = edit.step

        def timed_step(*a, **k):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            loss = step(*a, **k)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t1) * 1e3)
            losses.append(float(loss))
            return loss

        edit.step = timed_step
        t0 = time.perf_counter()
        try:
            got = http_op(base, {"op": "edit_train", "seed": 0,
                                 "epochs": EDIT_EPOCHS,
                                 "log_every": EDIT_EPOCHS})
        finally:
            del edit.step
        train_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        launches = read_counts()
        n_steps = EDIT_EPOCHS * (EDIT_NEAR // 2)
        if got != {"ok": True, "num_valid": N_GAUSS}:
            raise AssertionError(f"[edit] edit_train: {got}")
        if len(losses) != n_steps or not all(map(math.isfinite, losses)):
            raise AssertionError(f"[edit] losses {losses}")
        if min(launches[k] for k in ("gather", "blend", "blend_bwd",
                                     "prefix")) <= 0:
            raise AssertionError(f"[edit] a kernel of the path was not "
                                 f"launched: {launches}")

        # only target Gaussians changed, and the app renders the edit
        after = sess.scene.params()
        changed = torch.zeros(N_GAUSS, dtype=torch.bool, device="cuda")
        per_attr = {}
        for k, v in before.items():
            c = (after[k] != v).reshape(N_GAUSS, -1).any(1)
            per_attr[k] = int(c.sum())
            changed |= c
        if bool((changed & ~tgt).any()) or not bool((changed & tgt).any()):
            raise AssertionError(f"[edit] changed outside the target "
                                 f"{int((changed & ~tgt).sum())}, inside "
                                 f"{int((changed & tgt).sum())}")
        if not torch.equal(sess.scene.xyz, edit.scene.xyz):
            raise AssertionError("[edit] the session does not hold the edit")
        frame_after, _ = http_get(base, view)
        if frame_after == frame_before:
            raise AssertionError("[edit] the app renders the scene as "
                                 "before the edit")
        app.stop()
        app = None
        p50, p95 = np.percentile(step_ms, [50, 95])
        log(f"[edit] over HTTP: edit_precompute {precompute_s:.2f} s "
            f"({len(cams)} views -> {EDIT_NEAR} relative cameras, grad_mask "
            f"the {int(tgt.sum())} designed Gaussians); edit_train "
            f"{EDIT_EPOCHS} epochs = {n_steps} steps at batch 2 in "
            f"{train_s:.2f} s, step p50 {p50:.1f} ms, p95 {p95:.1f} ms, "
            f"max {max(step_ms):.1f} ms; losses "
            + ", ".join(f"{v:.4g}" for v in losses)
            + f"; {int(changed.sum())} Gaussians changed, all in the target "
            f"(by attribute {per_attr}); num_valid {N_GAUSS}; the app's "
            f"frame shows the edit; launches {launches}; {smi}")

        # the layers' times at the path's shapes
        rel = edit.relative_cameras
        masks = torch.stack([rc.mask[None] for rc in rel[:2]]).float()
        lat_in = torch.randn(2, full.in_channels, 64, 64, generator=gen,
                             device="cuda")
        t_b = torch.full((2,), 500, device="cuda")
        with torch.no_grad():
            unet_ms = median_ms(lambda: backend.unet_eps(
                lat_in, t_b, pos[None].expand(2, -1, -1)), iters=5)
        x = (torch.rand(2, 3, 512, 512, generator=gen, device="cuda") * 2
             - 1).requires_grad_()
        gz = torch.randn(2, full.latent_channels, 64, 64, generator=gen,
                         device="cuda")

        def encode_fb():
            x.grad = None
            backend.encode_images(x).backward(gz)

        vae_ms = median_ms(encode_fb, iters=5)
        imgs = torch.rand(2, 3, HEIGHT, WIDTH, generator=gen,
                          device="cuda").requires_grad_()

        def sds_fb():
            imgs.grad = None
            sds.train_step(gen, imgs, masks, step_ratio=0.5,
                           guidance_scale=100.0).backward()

        sds_ms = median_ms(sds_fb, iters=5)
        params = edit._leaves()
        edit._rebind(params)
        cams2 = [rc.camera for rc in rel[:2]]
        timed = []
        for i in range(EDIT_TIMED):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            edit.step(params, cams2, masks, gen, (i + 1) / EDIT_TIMED)
            torch.cuda.synchronize()
            timed.append((time.perf_counter() - t1) * 1e3)
        q50, q95 = np.percentile(timed, [50, 95])
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        log(f"[edit] {smi}: UNet eps (batch 2, one condition, 64x64 "
            f"latents) {unet_ms:.2f} ms; VAE encode forward + backward "
            f"(2 x 512x512) {vae_ms:.2f} ms; InpaintSDS.train_step + "
            f"backward to the image (2 x {WIDTH}x{HEIGHT}) {sds_ms:.2f} ms; "
            f"edit step (render 2 views, SDS, backward, mask, Adam) "
            f"p50 {q50:.1f} ms, p95 {q95:.1f} ms over {EDIT_TIMED} more "
            f"steps; precompute {precompute_s:.2f} s; peak "
            f"{peak:.2f} GiB; phase {time.perf_counter() - t_phase:.1f} s")
        profile(lambda: edit.step(params, cams2, masks, gen, 0.5),
                "edit step")
        return launches
    finally:
        if app is not None:
            app.stop()
        shutil.rmtree(root, ignore_errors=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1

    # ---- 1. device ----
    t_start = time.time()
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
    preprocess_stats = preprocess_phase()
    loss_stats = loss_phase()

    scene = make_scene(N_GAUSS, seed=0, device="cuda")
    cams = orbit_cams(WIDTH, HEIGHT, N_VIEWS, "cuda")
    mi, _ = suggest_budgets(scene, cams, margin=1.2)
    cfg = RasterConfig(max_instances=mi)
    log(f"[kernels] main-path budget max_instances={mi}")
    seen = capture_inputs(scene, cams[0], cfg)
    stats = {"preprocess": preprocess_stats,
             "gather": check_gather(*seen["gather"]),
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
    launches = {k: counts[k] for k in ("gather", "blend", "preprocess")}
    if any(n for k, n in counts.items() if k not in launches):
        raise AssertionError(f"the query path ran another kernel: {counts}")
    if launches["preprocess"] != N_FRAMES + N_VIEWS:
        raise AssertionError(f"{N_FRAMES} frames and {N_VIEWS} renders "
                             f"launched preprocess {launches['preprocess']} "
                             f"times, not once each")
    p50, p95 = np.percentile(frame_ms, [50, 95])
    log(f"[main] {N_FRAMES} query frames + {N_VIEWS} renders at "
        f"{WIDTH}x{HEIGHT}: frame p50 {p50:.1f} ms, p95 {p95:.1f} ms, "
        f"max {max(frame_ms):.1f} ms; launches gather={launches['gather']}"
        f" blend={launches['blend']} preprocess={launches['preprocess']}")
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

    # ---- 6a. distribution's single-rank path ----
    torch.cuda.empty_cache()
    for k, n in dist1_phase(scene, cams, cfg).items():
        launches[k] = launches.get(k, 0) + n

    del scene

    # ---- 7. the kernels at other widths ----
    widths_phase()

    # ---- 8. the micro-benchmark ----
    launches.update(micro_phase(stats))

    # ---- 9. the entry points on a scene from disk ----
    torch.cuda.empty_cache()
    for k, n in cli_phase().items():
        launches[k] = launches.get(k, 0) + n

    # ---- 10. RGB training with densification ----
    torch.cuda.empty_cache()
    for k, n in rgb_phase().items():
        launches[k] = launches.get(k, 0) + n

    # ---- 11. the full-pipeline demo ----
    torch.cuda.empty_cache()
    for k, n in pipeline_phase().items():
        launches[k] = launches.get(k, 0) + n

    # ---- 12. the interactive query app ----
    torch.cuda.empty_cache()
    for k, n in app_phase().items():
        launches[k] = launches.get(k, 0) + n

    # ---- 13. geometry export ----
    torch.cuda.empty_cache()
    export_launches, stats["density_grid"] = export_phase()
    for k, n in export_launches.items():
        launches[k] = launches.get(k, 0) + n

    # ---- 14. the frozen towers behind the app's text and OSH paths ----
    torch.cuda.empty_cache()
    for k, n in towers_phase().items():
        launches[k] = launches.get(k, 0) + n

    # ---- 15. SDS guidance and the app's edit session ----
    torch.cuda.empty_cache()
    for k, n in edit_phase().items():
        launches[k] = launches.get(k, 0) + n

    # ---- 16. kernels line, result ----
    kernels = [
        dict(name="expand_gather", route="cuda",
             source="goi_tpu_torch/raster/csrc/gather.cu",
             replaces="goi_tpu/raster/gather.py:48 and "
                      "goi_tpu/raster/binning.py:414-416",
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
             launches=launches["prefix"],
             note="ms: CUDA events around a wrapper call; run_ms: a "
                  "call in a run of calls; kernel_ms: the kernel's own "
                  "device time (profiler); copy_ms: rows.copy_ in a run "
                  "(as many bytes read and written), the ceiling beside "
                  "bound_ms",
             **stats["prefix"]),
        dict(name="trace", route="cuda",
             source="goi_tpu_torch/raster/csrc/trace.cu",
             replaces="goi_tpu/raster/pallas_blend.py:1106",
             launches=launches["trace"], **stats["trace"]),
        dict(name="prefix_boundary", route="cuda",
             source="goi_tpu_torch/raster/csrc/prefix_boundary.cu",
             replaces="goi_tpu/raster/pallas_blend.py:392",
             launches=launches["prefix_boundary"],
             note="launches count the prefix kernel; each call also "
                  "launches first_bounds_kernel once, and ms include it",
             **stats["prefix_boundary"]),
        dict(name="mono_rows", route="cuda",
             source="goi_tpu_torch/raster/csrc/mono_rows.cu",
             replaces="examples/micro_sortpayload.py:85",
             launches=launches["mono_rows"], **stats["mono_rows"]),
        dict(name="density_grid", route="cuda",
             source="goi_tpu_torch/raster/csrc/density_grid.cu",
             replaces="goi_tpu/export/mesh.py:24-71 (XLA, no Pallas)",
             launches=launches["density_grid"], **stats["density_grid"]),
        dict(name="owner_sums", route="cuda",
             source="goi_tpu_torch/raster/csrc/owner_sums.cu",
             replaces="goi_tpu/raster/pallas_blend.py:367-389 and :622-629 "
                      "(the read-out and XLA's jax.ops.segment_sum, no "
                      "Pallas)",
             launches=launches["owner_sums"],
             note="ms: CUDA events around a wrapper call; kernel_ms: the "
                  "kernel's own device time (profiler); library_ms: "
                  "torch.segment_reduce of the rows over the bounds, the "
                  "whole per-Gaussian sum this kernel completes",
             **stats["owner_sums"]),
    ]
    kernels.append(dict(
        name="preprocess", route="cuda",
        source="goi_tpu_torch/raster/csrc/preprocess.cu",
        replaces="none: goi_tpu/raster/preprocess.py, XLA-fused (no "
                 "Pallas)",
        launches=launches["preprocess"],
        note="ms: a call in a run of calls; kernel_ms: the kernel's own "
             "device time (profiler); plain_ms: the composition "
             "(preprocess_plain); garden's 5.8M Gaussians, _1m scannet's",
        **stats["preprocess"]))
    kernels.append(dict(
        name="distill_loss", route="cuda",
        source="goi_tpu_torch/raster/csrc/distill_loss.cu",
        replaces="none: goi_tpu/semantic/losses.py, XLA (no Pallas)",
        launches=launches["distill_loss"],
        note="ms: the loss's forward and backward (the unit rows, the two "
             "fp32 GEMMs, the row kernel, its sums and epilogue) in a run "
             "of calls; plain_ms: the composition (distillation_loss_plain); "
             "bound_ms: the GEMMs' flops; garden's 1297x840, _scannet "
             "1296x968; launches: the main path's, the check's apart "
             "(check_launches)",
        check_launches=loss_stats.pop("launches"), **loss_stats))
    if min(k["launches"] for k in kernels) <= 0:
        raise AssertionError(f"a kernel was not launched: {launches}")
    log(f"[done] {time.time() - t_start:.1f} s")
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
