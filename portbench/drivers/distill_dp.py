"""Driver of the four-card data-parallel distillation cell.

One process a card, joined by the port's init_multihost (a free
loopback port); the mesh is (data 4, model 1): every card holds the
whole scene and renders one camera of each step's global batch of
four, and the sharded step (dist/shard.py make_sharded_distill_step)
averages every gradient over the cards in one all-reduce before each
card's Adam steps. Each card makes the same seeded scene, views and
feature maps, and the codebook and decoder as train_distillation's
set-up makes them (init_codebook and SemanticDecoder.create from one
generator of the seed). The feed takes each step's four views from a
seeded epoch order and hands them to shard_batch. The first
`warmup_steps` steps are set-up; rank 0's clock closes the window at
the first step that ends past --seconds and tells the others with a
broadcast. dp4_step_ms is the window over its steps. Once it has
closed, the cards' parameters are compared with one another
(rank_spread, exact), and rank 0 runs the plain reference's first steps
over the same batches.
"""

from __future__ import annotations

import os
import time

import torch

from portbench import inputs, program
from portbench.drivers.distill import KERNELS, Recorder, WindowClosed
from portbench.reference import distill as ref_distill
from portbench.reference import raster as ref_raster
from portbench.work import counts


class MapBatch:
    """A step's feature maps as shard_batch slices them: maps[views[i]]
    stacked, for the slice a card takes only."""

    def __init__(self, maps, views):
        self.maps, self.views = maps, views

    def __getitem__(self, sl):
        return torch.stack([self.maps[v] for v in self.views[sl]])


def rank_spread(leaves, dist) -> float:
    """The largest difference of a parameter between two cards."""
    worst = torch.zeros((), dtype=torch.float64, device=leaves[0].device)
    for p in leaves:
        hi, lo = p.detach().clone(), p.detach().clone()
        dist.all_reduce(hi, op=dist.ReduceOp.MAX)
        dist.all_reduce(lo, op=dist.ReduceOp.MIN)
        worst = torch.maximum(worst, (hi - lo).abs().max().double())
    return float(worst)


def run(*, cell, workload, config, seed, seconds, trace, device, t_start):
    import torch.distributed as dist
    from goi_tpu_torch.dist import (make_sharded_distill_step, shard_batch,
                                    shard_scene, stack_cameras)
    from goi_tpu_torch.dist.multihost import init_multihost, make_global_mesh
    from goi_tpu_torch.raster.render import RasterConfig, suggest_budgets
    from goi_tpu_torch.semantic.codebook import SemanticDecoder, init_codebook
    from goi_tpu_torch.train.optim import OptimConfig
    from portbench.drivers.distill import leaves
    p = workload["params"]
    n = workload["chips"]
    kind = "cpu" if torch.device(device).type == "cpu" else "cuda"
    init_multihost(device=kind)
    mesh = make_global_mesh(n, 1, device=kind)
    rank = dist.get_rank()
    dev = mesh.device
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    # one build, then every card loads it
    if rank == 0:
        program.build_kernels(KERNELS, dev)
    dist.barrier()
    program.build_kernels(KERNELS, dev)
    raw = inputs.make_scene(config["scene"], seed, dev)
    views = inputs.training_views(config["views"], seed)
    maps, _ = inputs.feature_maps(config["maps"], views, seed, dev)
    scene = program.scene(raw)
    cams = [program.camera(v, dev) for v in views]
    budget, _ = suggest_budgets(scene, cams)
    gen = torch.Generator().manual_seed(seed)
    lut = init_codebook(gen, maps, tab_len=config["codebook"]["tab_len"])
    decoder = SemanticDecoder.create(
        gen, dim_in=config["scene"]["sem_dim"],
        dim_out=config["codebook"]["tab_len"], num_layer=1, use_bias=True,
        device=dev)
    init_fn, step_fn = make_sharded_distill_step(
        OptimConfig(iterations=p["max_steps"]),
        RasterConfig(max_instances=budget), mesh=mesh)
    state = init_fn(shard_scene(scene, mesh), decoder, lut)
    del decoder, lut
    bg = torch.zeros(3, device=dev)
    order = ref_distill.view_order(seed, len(views), p["max_steps"], n)
    rec = Recorder(p, seconds, trace and rank == 0, dev)
    t0_wall = None
    it = 0
    while it < p["max_steps"]:
        step_views = order[it]
        it += 1
        c_b, g_b = shard_batch(mesh, stack_cameras([cams[v]
                                                    for v in step_views]),
                               MapBatch(maps, step_views))
        state, aux = step_fn(state, c_b, g_b, bg)
        program.sync(dev)
        stop = 0
        try:
            rec(it, state, aux)
        except WindowClosed:
            stop = 1
        if it == rec.warm:
            t0_wall = time.time()
        if it > rec.warm:
            flag = torch.tensor([stop], device=dev)
            dist.broadcast(flag, 0)
            if int(flag):
                break
    rec.state = None
    spread = rank_spread([lf for lf, _ in leaves(state).values()], dist)
    peak = torch.tensor([float(torch.cuda.max_memory_allocated(dev))
                         if cuda else 0.0], dtype=torch.float64, device=dev)
    dist.all_reduce(peak, op=dist.ReduceOp.MAX)
    profile = rec.prof.result() if rec.prof is not None else None
    del state, scene, cams
    if cuda:
        torch.cuda.empty_cache()
    if rank != 0:
        dist.barrier()
        dist.destroy_process_group()
        return None
    step_ms = (rec.t1 - rec.t0) * 1e3 / rec.steps
    # from the start of the launching process, whose wall clock the
    # launcher hands its ranks
    setup_s = t0_wall - float(os.environ.get(
        "PORTBENCH_T0", time.time() - (time.perf_counter() - t_start)))
    readings = {"step_ms": step_ms, "steps": rec.steps, "chips": n}
    dev_info = program.device_info(dev, n)
    dev_info["memory_peak_bytes"] = int(peak.item())
    print(f"[portbench] {cell}: {n} cards, {rec.steps} steps of {n} cameras "
          f"in {rec.t1 - rec.t0:.3f} s, {step_ms:.3f} ms a step, set-up "
          f"{setup_s:.3f} s, budget {budget}, peak "
          f"{dev_info['memory_peak_bytes']} B, rank spread {spread!r}",
          flush=True)
    if trace:
        readings["profile"] = profile
        readings["step_ms"] = (rec.t1 - rec.t0 - rec.prof.held) * 1e3 / (
            rec.steps - rec.prof_n)
    ref = ref_distill.first_steps(raw, views, maps, seed,
                                  tab_len=config["codebook"]["tab_len"],
                                  steps=p["compared_steps"], batch=n)
    prog = {"losses": rec.losses, "grad1": rec.grad1, "start": rec.start,
            "end": rec.end}
    numbers = program.training_numbers(prog, ref)
    numbers["rank_spread"] = spread
    print(f"[portbench] {cell}: losses {rec.losses} reference "
          f"{ref['losses']}", flush=True)
    if trace:
        pairs = {}
        cams_done = [v for s in rec.prof_steps for v in order[s - 1]]
        for v in set(cams_done):
            sp = ref_raster.preprocess(raw, views[v])
            pairs[v] = ref_raster.blended_pairs(sp, ref_raster.tile_lists(sp))
        readings["work"] = counts.distill_step(
            config, views[0], [pairs[v] for v in cams_done])
    dist.barrier()
    dist.destroy_process_group()
    checks, ok = program.checks(numbers, workload["limits"])
    return {"correct": ok, "attempted": rec.steps,
            "failed": 0 if ok else rec.steps,
            "e2e": {"dp4_step_ms": step_ms, "setup_s": setup_s},
            "readings": readings, "profile": profile, "device": dev_info,
            "checks": checks}
