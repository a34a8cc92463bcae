#!/usr/bin/env python3
"""Four-card run of the port's distribution (goi_tpu_torch.dist) on four
NVIDIA GPUs of one host: one process per card over NCCL.

    python3 chip_smoke_dist.py

Without a GOI_PROC_ID variable this is the launcher: it exits non-zero
when fewer than four cards are seen, builds the kernels of the path from
goi_tpu_torch/raster/csrc into build/goi_tpu_torch/ (one nvcc per source,
all at once), starts four ranks of itself (GOI_COORD=127.0.0.1:<free
port>, GOI_NUM_PROCS=4, GOI_PROC_ID=0..3), waits for them and prints the
cards' nvidia-smi lines and the result line. Every rank builds the same
seeded 4,000,000-Gaussian scene (SH degree 3, 10 semantic channels) and
keeps its 1,000,000 rows; rank 0 also renders the whole scene on its own
card as the one-card reference, at 1296x968 over 3 orbit views:

1. [frames] render_sharded with the 'gather' exchange and with the
   'rows' exchange (its cap from a lossless probe, demand <= cap) against
   the one-card render() within 3e-5 on every view;
2. [grads] both exchanges' gradients (every scene attribute, the loss of
   tests/test_sharded_render.py) within its flip budget of the one-card
   ones and bit-identical over two sharded passes;
3. [overflow] a starved budget reports num_slots > local_budget; the
   budget regrown from that demand renders the reference frame;
4. [distill] make_sharded_distill_step at full width (codebook 300 x 256,
   seeded 256-dim feature maps, reduce 'chain') on the (1, 4) and (2, 2)
   meshes: the first step's loss terms, gradients and updated parameters
   held to the one-card step on the same batch, then 4 timed steps;
5. [scale] forward + backward Mrays/s and scaling efficiency on the rank
   sets {0} (one-card render()), {0, 1} and {0, 1, 2, 3}; the sharded
   frame's p50 ms; each rank's peak GiB of a fwd + bwd step under
   'gather' and 'rows', taken after the whole scene and the references
   are freed, beside what the rank held before the step; the bytes each
   exchange moves per frame, computed from the pack sizes (not
   measured); distillation camera-steps/s per mesh.

Rank 0 prints a `{"dist": {...}}` line of these numbers; the launcher's
last line is {"ok": true, "device": {"platform": "gpu", ...}}.
"""

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

WORLD = 4
N_GAUSS = 4_000_000
WIDTH, HEIGHT = 1296, 968
N_VIEWS = 3
SEM_DIM, APE_DIM, TAB_LEN = 10, 256, 300
SOURCES = ("gather", "blend_fwd", "blend_bwd", "prefix", "owner_sums",
           "distill_loss")
TOL_FRAME = 3e-5
DISTILL_STEPS = 5          # the first compared, the rest timed
SCALE_ITERS = 5
FRAMES = 10
RANK_TIMEOUT = 780         # seconds the launcher waits for the ranks


def log(*a):
    print(*a, flush=True)


def gather_rows(t, group):
    """Every rank's rows of t, joined in rank order, on each rank."""
    from goi_tpu_torch.dist.collectives import gather_parts
    return gather_parts(t.contiguous(), group).reshape(
        (-1,) + tuple(t.shape[1:]))


def all_true(flag: bool, group=None) -> bool:
    import torch
    import torch.distributed as dist
    t = torch.tensor([int(flag)], device="cuda")
    dist.all_reduce(t, op=dist.ReduceOp.MIN, group=group)
    return bool(t.item())


def frames_phase(ctx):
    """[frames]: both exchanges against the one-card frame."""
    import torch
    from goi_tpu_torch.dist import render_sharded
    cs, rank, mesh = ctx["cs"], ctx["rank"], ctx["mesh4"]
    caps = []
    for v, cam in enumerate(ctx["cams"]):
        with torch.no_grad():
            gather = render_sharded(ctx["shard"], cam, ctx["bg"], ctx["cfg"],
                                    mesh)
            probe = render_sharded(ctx["shard"], cam, ctx["bg"], ctx["cfg"],
                                   mesh, exchange="rows",
                                   exchange_cap=ctx["shard"].capacity)
            cap = int(probe["exchange_demand"])
            rows = render_sharded(ctx["shard"], cam, ctx["bg"], ctx["cfg"],
                                  mesh, exchange="rows", exchange_cap=cap)
        del probe
        caps.append(cap)
        if int(rows["exchange_demand"]) > cap:
            raise AssertionError(f"view {v}: rows demand past its cap")
        for out in (gather, rows):
            if int(out["num_slots"]) > out["local_budget"]:
                raise AssertionError(f"view {v}: num_slots past the budget")
        if rank == 0:
            ref = ctx["refs"][v]
            eq_g, err_g = cs.frames_agree(gather, ref, TOL_FRAME,
                                          f"view {v} gather")
            eq_r, err_r = cs.frames_agree(rows, ref, TOL_FRAME,
                                          f"view {v} rows")
            log(f"[frames] view {v}: gather "
                f"{'bit-equal' if eq_g else 'within'} (max diff "
                f"{err_g:.3e}), rows {'bit-equal' if eq_r else 'within'} "
                f"(max diff {err_r:.3e}) vs the one-card frame (tol "
                f"{TOL_FRAME}); rows cap {cap} from a lossless probe, "
                f"num_slots {int(gather['num_slots'])} <= "
                f"{gather['local_budget']}")
    return caps


def grads_phase(ctx, caps):
    """[grads]: both exchanges' gradients against the one-card ones."""
    import torch
    from goi_tpu_torch.dist import render_sharded
    from goi_tpu_torch.raster.render import render
    cs, rank, mesh = ctx["cs"], ctx["rank"], ctx["mesh4"]
    cam, bg = ctx["cams"][0], ctx["bg"]
    gen = torch.Generator(device="cuda").manual_seed(11)
    tgt = torch.randn((3, HEIGHT, WIDTH), generator=gen, device="cuda")
    want = (cs.scene_grads(lambda s: render(s, cam, bg, ctx["cfg1"]),
                           ctx["scene"], tgt) if rank == 0 else None)
    for exchange, kw in (("gather", {}),
                         ("rows", dict(exchange="rows",
                                       exchange_cap=caps[0]))):
        passes = [cs.scene_grads(lambda s: render_sharded(
            s, cam, bg, ctx["cfg"], mesh, **kw), ctx["shard"], tgt)
            for _ in range(2)]
        same = all(torch.equal(passes[0][k], passes[1][k])
                   for k in passes[0])
        if not all_true(same):
            raise AssertionError(f"{exchange}: gradients differ between two "
                                 f"sharded passes")
        full = {k: gather_rows(v, mesh.group("model"))
                for k, v in passes[0].items()}
        if rank == 0:
            flips = {k: cs.flip_budget(want[k], full[k], f"{exchange} {k}")
                     for k in want}
            log(f"[grads] {exchange}: 7 gradients bit-identical over two "
                f"sharded passes on every rank; against the one-card ones "
                f"worst flip share "
                f"{max(f[0] for f in flips.values()):.5f} (budget "
                f"{cs.FLIP_SHARE}), max |diff| "
                f"{max(f[1] for f in flips.values()):.3e} (bound "
                f"{cs.FLIP_MAX})")
        del passes, full


def overflow_phase(ctx):
    """[overflow]: a starved budget is reported, then regrown."""
    import torch
    from goi_tpu_torch.dist import render_sharded
    from goi_tpu_torch.raster.render import BUDGET_QUANTUM, RasterConfig
    mesh, cam = ctx["mesh4"], ctx["cams"][0]
    small = RasterConfig(max_instances=ctx["cfg"].max_instances // 2)
    with torch.no_grad():
        out = render_sharded(ctx["shard"], cam, ctx["bg"], small, mesh)
        demand = int(out["num_slots"])
        if demand <= out["local_budget"]:
            raise AssertionError("the starved budget reported no overflow")
        q = BUDGET_QUANTUM
        grown = RasterConfig(max_instances=WORLD * (-(-demand // q) * q))
        out2 = render_sharded(ctx["shard"], cam, ctx["bg"], grown, mesh)
    if int(out2["num_slots"]) > out2["local_budget"]:
        raise AssertionError("the regrown budget still overflows")
    if ctx["rank"] == 0:
        eq, err = ctx["cs"].frames_agree(out2, ctx["refs"][0], TOL_FRAME,
                                         "regrown frame")
        log(f"[overflow] local budget {out['local_budget']}: num_slots "
            f"{demand} reported; regrown to {grown.max_instances} "
            f"({out2['local_budget']} a rank): num_slots "
            f"{int(out2['num_slots'])}, frame "
            f"{'bit-equal to' if eq else 'within'} the one-card one (max "
            f"diff {err:.3e})")


def distill_phase(ctx):
    """[distill]: the sharded step on (1, 4) and (2, 2) against the
    one-card step, then timed steps; returns camera-steps/s per mesh."""
    import torch
    from goi_tpu_torch.dist import (make_sharded_distill_step, shard_batch,
                                    shard_scene, stack_cameras)
    from goi_tpu_torch.semantic.codebook import SemanticDecoder
    from goi_tpu_torch.train.distill import create_distill_state, distill_loss
    from goi_tpu_torch.train.optim import OptimConfig, set_scheduled_lr
    cs, rank, bg = ctx["cs"], ctx["rank"], ctx["bg"]
    cams = ctx["cams"][:2]
    maps = cs.feature_maps(2, 21, WIDTH, HEIGHT, "cuda")
    g = torch.Generator().manual_seed(21)
    decoder = SemanticDecoder.create(g, dim_in=SEM_DIM, dim_out=TAB_LEN,
                                     device="cuda")
    lut = torch.randn((TAB_LEN, APE_DIM), generator=g).to("cuda")
    rates = {}
    for nd, nm in ((1, 4), (2, 2)):
        mesh = ctx["mesh4"] if nd == 1 else ctx["mesh22"]
        ref = None
        if rank == 0:
            state, train_step = create_distill_state(
                ctx["scene"], decoder, lut, OptimConfig())
            if nd == 1:
                state, aux = train_step(state, cams[0], maps[0], bg,
                                        ctx["cfg1"])
                terms = {k: float(aux[k]) for k in ("total", "lab")}
            else:
                outs = [distill_loss(state, c, m, bg, ctx["cfg1"])
                        for c, m in zip(cams, maps)]
                (sum(loss for loss, _ in outs) / nd).backward()
                set_scheduled_lr(state.opt_scene, state.step)
                for o in (state.opt_scene, state.opt_decoder, state.opt_lut):
                    o.step()
                terms = {k: float(sum(a[k].detach() for _, a in outs)) / nd
                         for k in ("total", "lab")}
                del outs
            ref = (terms, state)
        init_fn, step_fn = make_sharded_distill_step(
            OptimConfig(), ctx["cfg_distill"][nm], mesh=mesh)
        sstate = init_fn(shard_scene(ctx["scene_host"], mesh), decoder, lut)
        c_b, g_b = shard_batch(mesh, stack_cameras(cams[:nd]),
                               torch.stack(maps[:nd]))
        sstate, aux = step_fn(sstate, c_b, g_b, bg)
        sem = gather_rows(sstate.scene.semantics.detach(),
                          mesh.group("model"))
        sem_grad = gather_rows(sstate.scene.semantics.grad,
                               mesh.group("model"))
        if rank == 0:
            terms, state = ref
            for k in terms:
                if not np.isclose(float(aux[k]), terms[k], rtol=1e-5):
                    raise AssertionError(f"({nd}, {nm}) step {k}: "
                                         f"{float(aux[k])} vs {terms[k]}")
            worst = 0.0
            for got, got_grad, want in (
                    (sem, sem_grad, state.scene.semantics),
                    (sstate.decoder.weights[0],
                     sstate.decoder.weights[0].grad,
                     state.decoder.weights[0]),
                    (sstate.lut, sstate.lut.grad, state.lut)):
                ok, err = cs.close_to_peak(got_grad, want.grad, *cs.GRAD_TOL)
                moved = want.grad.abs() > cs.GRAD_TOL[1] * float(
                    want.grad.abs().max())
                if not ok or not torch.allclose(got[moved], want[moved],
                                                rtol=1e-6, atol=1e-7):
                    raise AssertionError(f"({nd}, {nm}) step: gradients or "
                                         f"updated parameters differ ({err})")
                worst = max(worst, err)
            log(f"[distill] ({nd}, {nm}): the first step's loss "
                f"{float(aux['total']):.6f} = the one-card step's "
                f"{terms['total']:.6f} (rtol 1e-5); semantics, decoder and "
                f"LUT gradients within {cs.GRAD_TOL} of the peak (max diff "
                f"{worst:.3e}), updated values equal where the gradient is "
                f"past its atol")
            del ref, state
        times = []
        for _ in range(DISTILL_STEPS - 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sstate, aux = step_fn(sstate, c_b, g_b, bg)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            if not np.isfinite(float(aux["total"])):
                raise AssertionError("non-finite sharded loss")
        p50 = float(np.median(times))
        rates[f"({nd}, {nm})"] = dict(step_p50_ms=p50,
                                      cam_steps_per_s=nd / p50 * 1e3)
        if rank == 0:
            log(f"[distill] ({nd}, {nm}): {DISTILL_STEPS - 1} more steps, "
                f"p50 {p50:.1f} ms ({nd} camera(s) a step: "
                f"{nd / p50 * 1e3:.3f} camera-steps/s), num_slots "
                f"{int(aux['num_slots'])}")
        del sstate, c_b, g_b
    del maps
    return rates


def exchange_bytes(n_local, cap, s_dim, width, h_local, world):
    """Bytes one rank receives per frame (forward): the splats ((10 + S)
    floats + 7 int32 a row from every other rank; the rows exchange's
    packs of cap rows), the radii, and the other ranks' frame slabs
    (3 + S + 2 channels)."""
    row = 4 * (10 + s_dim + 7)
    splats = (world - 1) * (cap if cap else n_local) * row
    radii = (world - 1) * n_local * 4
    frame = (world - 1) * (5 + s_dim) * h_local * width * 4
    return splats + radii + frame


def scale_phase(ctx, caps):
    """[scale]: rays/s on {0}, {0, 1}, {0..3}; the sharded frame's p50;
    peak memory per rank; bytes per frame."""
    import torch
    import torch.distributed as dist
    from goi_tpu_torch import scale
    from goi_tpu_torch.dist import render_sharded, shard_scene
    from goi_tpu_torch.raster.render import RasterConfig
    rank, cam, bg = ctx["rank"], ctx["cams"][0], ctx["bg"]
    rays = WIDTH * HEIGHT
    out = {}
    for d, mesh in ((1, None), (2, ctx["mesh2"]), (4, ctx["mesh4"])):
        if d == 1 and rank == 0:
            step = scale.fwd_bwd_step(ctx["scene"], cam, ctx["cfg1"])
            out[d] = scale.timed(step, SCALE_ITERS, "cuda")
        elif d > 1 and mesh.member:
            shard = (ctx["shard"] if d == WORLD
                     else shard_scene(ctx["scene_host"], mesh))
            cfg = (ctx["cfg"] if d == WORLD else RasterConfig(
                max_instances=scale.sharded_budget(shard, cam, mesh)))
            step = scale.fwd_bwd_step(shard, cam, cfg, mesh)
            out[d] = scale.timed(step, SCALE_ITERS, "cuda",
                                 mesh.group("model"))
            del shard, step
        dist.barrier()
    mrays = {d: rays / ms / 1e3 for d, ms in out.items()}

    frame_ms = {}
    for exchange, kw in (("gather", {}),
                         ("rows", dict(exchange="rows",
                                       exchange_cap=caps[0]))):
        times = []
        with torch.no_grad():
            for i in range(FRAMES + 1):
                torch.cuda.synchronize()
                dist.barrier()
                t0 = time.perf_counter()
                render_sharded(ctx["shard"], ctx["cams"][i % N_VIEWS], bg,
                               ctx["cfg"], ctx["mesh4"], **kw)
                torch.cuda.synchronize()
                if i:
                    times.append((time.perf_counter() - t0) * 1e3)
        frame_ms[exchange] = float(np.median(times))
    # the peaks measure a rank's shard and the step alone: the whole scene
    # every rank cut its shard from, and rank 0's references, go first
    for k in ("scene", "scene_host", "refs"):
        ctx.pop(k, None)
    peaks, held = {}, {}
    for exchange, kw in (("gather", {}),
                         ("rows", dict(exchange="rows",
                                       exchange_cap=caps[0]))):
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        scale.fwd_bwd_step(ctx["shard"], cam, ctx["cfg"], ctx["mesh4"],
                           **kw)()
        torch.cuda.synchronize()
        gib = torch.tensor([torch.cuda.max_memory_allocated() / 2 ** 30,
                            before / 2 ** 30], device="cuda")
        both = gather_rows(gib[None], None)
        peaks[exchange] = [float(x) for x in both[:, 0]]
        held[exchange] = [float(x) for x in both[:, 1]]
    grid_y = -(-HEIGHT // 16)
    h_local = -(-grid_y // WORLD) * 16
    n_local = ctx["shard"].capacity
    moved = {"gather": exchange_bytes(n_local, 0, SEM_DIM, WIDTH, h_local,
                                      WORLD),
             "rows": exchange_bytes(n_local, caps[0], SEM_DIM, WIDTH,
                                    h_local, WORLD)}
    if rank != 0:
        return None
    for d in sorted(mrays):
        log(f"[scale] {d} rank(s): fwd + bwd {out[d]:.1f} ms, "
            f"{mrays[d]:.3f} Mrays/s, scaling efficiency "
            f"{mrays[d] / (mrays[1] * d):.3f}")
    log(f"[scale] sharded frame (4 ranks, forward) p50: gather "
        f"{frame_ms['gather']:.2f} ms, rows {frame_ms['rows']:.2f} ms; peak "
        f"GiB per rank of a fwd + bwd step gather {peaks['gather']}, rows "
        f"{peaks['rows']} (held before the step, the shard included: "
        f"gather {held['gather']}, rows {held['rows']}); bytes a rank "
        f"receives per frame, computed from the pack sizes (not measured): "
        f"gather {moved['gather']}, rows {moved['rows']}")
    return dict(fwd_bwd_ms=out, mrays=mrays,
                scaling_efficiency={d: mrays[d] / (mrays[1] * d)
                                    for d in mrays},
                frame_p50_ms=frame_ms, peak_gib=peaks,
                held_before_step_gib=held,
                computed_bytes_per_rank_per_frame=moved,
                computed_bytes_per_frame={k: WORLD * v
                                          for k, v in moved.items()})


def rank_main() -> int:
    import torch
    import torch.distributed as dist
    import chip_smoke as cs
    from goi_tpu_torch.dist import init_multihost, make_mesh, shard_scene
    from goi_tpu_torch.raster import _nvcc
    from goi_tpu_torch.raster.render import RasterConfig, suggest_budgets
    from goi_tpu_torch import scale
    t_start = time.time()
    if not init_multihost(device="cuda"):
        raise RuntimeError("no process group formed")
    rank = dist.get_rank()
    if torch.backends.cuda.matmul.allow_tf32 is not False:
        raise AssertionError("TF32 matmuls must be off (full fp32)")
    torch.backends.cudnn.allow_tf32 = False
    _nvcc.build(SOURCES)
    ctx = dict(cs=cs, rank=rank, bg=torch.zeros(3, device="cuda"))
    ctx["mesh4"] = make_mesh(1, 4, device="cuda")
    ctx["mesh2"] = make_mesh(1, 2, device="cuda")
    ctx["mesh22"] = make_mesh(2, 2, device="cuda")
    scene = cs.make_scene(N_GAUSS, seed=0, device="cuda")
    ctx["cams"] = cs.orbit_cams(WIDTH, HEIGHT, N_VIEWS, "cuda")
    ctx["scene_host"] = scene
    ctx["shard"] = shard_scene(scene, ctx["mesh4"])
    ctx["scene"] = scene if rank == 0 else None
    budgets = [scale.sharded_budget(ctx["shard"], c, ctx["mesh4"])
               for c in ctx["cams"]]
    ctx["cfg"] = RasterConfig(max_instances=max(budgets))
    mesh22_shard = shard_scene(scene, ctx["mesh22"])
    ctx["cfg_distill"] = {
        4: ctx["cfg"],
        2: RasterConfig(max_instances=max(
            scale.sharded_budget(mesh22_shard, c, ctx["mesh22"])
            for c in ctx["cams"][:2]))}
    del mesh22_shard
    if rank == 0:
        mi, _ = suggest_budgets(scene, ctx["cams"], margin=1.2)
        ctx["cfg1"] = RasterConfig(max_instances=mi)
        from goi_tpu_torch.raster.render import render
        with torch.no_grad():
            ctx["refs"] = [render(scene, c, ctx["bg"], ctx["cfg1"])
                           for c in ctx["cams"]]
        log(f"[dist] {dist.get_world_size()} ranks over NCCL; scene "
            f"{N_GAUSS} Gaussians ({ctx['shard'].capacity} a rank), "
            f"{WIDTH}x{HEIGHT}, {N_VIEWS} views; budgets: one card {mi}, "
            f"sharded {ctx['cfg'].max_instances} "
            f"({ctx['cfg'].max_instances // WORLD} a rank), (2, 2) "
            f"{ctx['cfg_distill'][2].max_instances}; set-up "
            f"{time.time() - t_start:.1f} s")
    del scene       # only ctx holds it now, so scale_phase can free it
    caps = frames_phase(ctx)
    grads_phase(ctx, caps)
    overflow_phase(ctx)
    rates = distill_phase(ctx)
    numbers = scale_phase(ctx, caps)
    dist.barrier()
    if rank == 0:
        numbers["distill"] = rates
        numbers["rows_caps"] = caps
        log(f"[done] rank 0 {time.time() - t_start:.1f} s")
        log(json.dumps({"dist": numbers}))
    dist.destroy_process_group()
    return 0


def smi_lines() -> list:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()


def main() -> int:
    if os.environ.get("GOI_PROC_ID") is not None:
        return rank_main()
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < WORLD:
        print(f"chip_smoke_dist: {WORLD} CUDA devices needed, "
              f"{torch.cuda.device_count()} seen", file=sys.stderr)
        return 1
    t0 = time.time()
    import goi_tpu_torch  # noqa: F401  (fails outside a checkout)
    from goi_tpu_torch.dist.multihost import spawn, wait_all
    from goi_tpu_torch.raster import _nvcc
    smi = smi_lines()
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{len(smi)} cards: {'; '.join(smi)}; nvcc {_nvcc.nvcc()}")
    _nvcc.build(SOURCES)
    log(f"[build] {' + '.join(f'{k}.cu' for k in SOURCES)} in "
        f"{time.time() - t0:.1f} s")
    with tempfile.TemporaryDirectory() as tmp:
        logs = [None] + [open(os.path.join(tmp, f"{r}.log"), "w")
                         for r in range(1, WORLD)]
        try:
            codes = wait_all(spawn([sys.executable, os.path.abspath(__file__)],
                                   WORLD, stdout=logs), RANK_TIMEOUT)
        finally:
            for f in logs[1:]:
                f.close()
        if codes != [0] * WORLD:
            for r in range(1, WORLD):
                with open(os.path.join(tmp, f"{r}.log")) as f:
                    tail = f.read()[-3000:]
                print(f"--- rank {r} ---\n{tail}", file=sys.stderr)
            print(f"chip_smoke_dist: ranks exited {codes} (None: killed at "
                  f"{RANK_TIMEOUT} s)", file=sys.stderr)
            return 1
    log(f"[done] {time.time() - t0:.1f} s")
    for line in smi:
        log(line)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
