"""Scaling harness: `python -m goi_tpu_torch.scale`.

Counterpart of the root scale.py: the forward + backward rays/s of the
sharded render (dist/render.py) on 1, 2, 4, ... ranks (the ranks {0},
{0, 1}, ... of the world; one rank runs the one-card render()), then the
sharded distillation step's camera-steps/s on the (1, D) mesh and, for
even D, the (2, D / 2) mesh. One JSON line per rank count, with the root
scale.py's keys, printed by rank 0.

  torchrun --nproc_per_node 4 -m goi_tpu_torch.scale
  python -m goi_tpu_torch.scale --nproc 4      # spawns the 4 processes

Each process runs on its own card (cuda:<local rank>); `--device cpu`
runs the ranks on the CPU over gloo (the code path, not a measurement).
Without torchrun's or the GOI_* variables it starts --nproc processes of
itself (default: one per card seen), joined at 127.0.0.1:<free port>.
"""

from __future__ import annotations

import json
import os
import sys
import time
from argparse import ArgumentParser
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from goi_tpu_torch.core.camera import Camera, stack_cameras
from goi_tpu_torch.core.scene import GaussianScene
from goi_tpu_torch.dist import (init_multihost, make_mesh,
                                make_sharded_distill_step, render_sharded,
                                shard_batch, shard_scene)
from goi_tpu_torch.dist.mesh import Mesh
from goi_tpu_torch.dist.multihost import spawn, wait_all
from goi_tpu_torch.raster.render import (BUDGET_QUANTUM, RasterConfig, render,
                                         suggest_budgets)
from goi_tpu_torch.raster.preprocess import TILE


def seeded_scene(n: int, seed: int, device,
                 sem_dim: int = 10) -> GaussianScene:
    """Root scale.py's scene: normal positions, SH degree 3, scales
    0.005-0.02, opacity logits + N(0, 1); here also seeded rotations and
    semantics."""
    rng = np.random.default_rng(seed)
    scene = GaussianScene.create(
        rng.normal(0, 1.0, (n, 3)).astype(np.float32),
        rng.uniform(0, 1, (n, 3)).astype(np.float32), sh_degree=3,
        sem_dim=sem_dim,
        scales=rng.uniform(0.005, 0.02, n).astype(np.float32), device=device)

    def t(a):
        return torch.as_tensor(a.astype(np.float32), device=device)

    return scene.replace(
        active_sh_degree=3,
        opacity=scene.opacity + t(rng.normal(0, 1, (n, 1))),
        rotation=t(rng.normal(0, 1, (n, 4))),
        semantics=t(rng.normal(0, 0.3, (n, sem_dim))))


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _round_up(x: int) -> int:
    return -(-x // BUDGET_QUANTUM) * BUDGET_QUANTUM


def sharded_budget(shard: GaussianScene, cam: Camera, mesh: Mesh,
                   margin: float = 1.1) -> int:
    """max_instances for render_sharded on `mesh`: a probe at a budget no
    rank can overflow (every splat plus its whole rect area in one
    slice), then D times the worst rank's demand with `margin`."""
    from goi_tpu_torch.raster.preprocess import preprocess
    d = mesh.shape["model"]
    with torch.no_grad():
        sp = preprocess(shard, cam)
        area = ((sp.rect_max - sp.rect_min).prod(-1) * sp.valid).sum()
        bound = torch.stack([area.long(), torch.tensor(
            sp.valid.shape[0], device=area.device)])
        dist.all_reduce(bound, group=mesh.group("model"))
        probe = RasterConfig(max_instances=d * _round_up(int(bound.sum())))
        out = render_sharded(shard, cam, torch.zeros(3, device=mesh.device),
                             probe, mesh)
    return d * _round_up(int(int(out["num_slots"]) * margin))


def timed(step, iters: int, device, group=None) -> float:
    """ms per call of step() on this rank: one warm-up call, then `iters`
    calls between barriers of `group`, the card synchronised."""
    step()
    _sync(device)
    if group is not None:
        dist.barrier(group=group)
    t0 = time.perf_counter()
    for _ in range(iters):
        step()
    _sync(device)
    if group is not None:
        dist.barrier(group=group)
    return (time.perf_counter() - t0) / iters * 1e3


def fwd_bwd_step(scene: GaussianScene, cam: Camera, cfg: RasterConfig,
                 mesh: Optional[Mesh] = None, **kw):
    """One forward + backward of mean(render) + mean(semantics): render()
    of the whole scene when mesh is None, else render_sharded of this
    rank's shard."""
    leaves = {k: v.detach().requires_grad_(True)
              for k, v in scene.params().items()}
    bg = torch.zeros(3, device=scene.device)

    def step():
        for v in leaves.values():
            v.grad = None
        s = scene.with_params(leaves)
        out = (render(s, cam, bg, cfg) if mesh is None
               else render_sharded(s, cam, bg, cfg, mesh, **kw))
        (out["render"].mean() + out["semantics"].mean()).backward()
    return step


def rank_counts(world: int, height: int) -> list:
    return [d for d in (1, 2, 4, 8, 16) if d <= world
            and (height // TILE) % d == 0]


def main(argv=None) -> int:
    parser = ArgumentParser(description="goi_tpu_torch scaling harness")
    parser.add_argument("--n", type=int, default=100_000)
    parser.add_argument("--size", type=int, default=512,
                        help="render width = height")
    parser.add_argument("--iters", type=int, default=10)
    parser.add_argument("--nproc", type=int, default=0,
                        help="processes to spawn when not under torchrun "
                             "(default: the cards seen)")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    joined = any(k in os.environ for k in ("GOI_COORD", "RANK"))
    if not joined:
        return _spawn(args, argv)
    init_multihost(device=args.device)
    if not dist.is_initialized():
        raise SystemExit("no process group formed")
    rank, world = dist.get_rank(), dist.get_world_size()
    mesh1 = make_mesh(1, 1, device=args.device)
    dev = mesh1.device
    scene = seeded_scene(args.n, 0, dev)
    cam = Camera.look_at([0.3, 0.4, -4.0], [0, 0, 0], [0, 1, 0], 0.9, 0.9,
                         args.size, args.size, device=dev)
    rays = args.size * args.size
    counts = rank_counts(world, args.size)
    budget, _ = suggest_budgets(scene, cam)
    base = None
    for d in counts:
        mesh = mesh1 if d == 1 else make_mesh(1, d, device=args.device)
        if mesh.member:
            if d == 1:
                step = fwd_bwd_step(scene, cam, RasterConfig(
                    max_instances=budget))
            else:
                shard = shard_scene(scene, mesh)
                cfg = RasterConfig(max_instances=sharded_budget(shard, cam,
                                                                mesh))
                step = fwd_bwd_step(shard, cam, cfg, mesh)
            ms = timed(step, args.iters, dev,
                       None if d == 1 else mesh.group("model"))
            mrays = rays / ms / 1e3
            base = base or mrays
            if rank == 0:
                print(json.dumps({
                    "metric": "Mrays/s fwd+bwd", "devices": d,
                    "value": round(mrays, 3),
                    "scaling_efficiency": round(mrays / (base * d), 3)}),
                    flush=True)
        dist.barrier()
    _distill_sweep(args, scene, counts, rank, dev)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def _distill_sweep(args, scene, counts, rank, dev) -> None:
    """Root scale.py's sharded distillation sweep: half the render's
    size (256x256 at the default 512), S = 10, codebook 32 x 64, 5 timed
    steps per mesh."""
    from goi_tpu_torch.semantic.codebook import SemanticDecoder
    from goi_tpu_torch.train.optim import OptimConfig
    sem_dim, ape_dim, tab_len, size = 10, 64, 32, args.size // 2
    dcam = Camera.look_at([0.3, 0.4, -4.0], [0, 0, 0], [0, 1, 0], 0.9, 0.9,
                          size, size, device=dev)
    rng = np.random.default_rng(1)
    dbase = None
    for d in counts:
        n_data = 2 if d % 2 == 0 and d > 1 else 1
        mesh = make_mesh(n_data, d // n_data, device=args.device)
        if mesh.member:
            gen = torch.Generator().manual_seed(0)
            decoder = SemanticDecoder.create(gen, dim_in=sem_dim,
                                             dim_out=tab_len, device=dev)
            lut = 0.1 * torch.randn((tab_len, ape_dim), generator=gen) \
                .to(dev)
            gts = rng.normal(0, 1, (n_data, ape_dim, size, size)) \
                .astype(np.float32)
            cams, gts = shard_batch(mesh, stack_cameras([dcam] * n_data),
                                    gts)
            shard = shard_scene(scene, mesh)
            cfg = RasterConfig(max_instances=sharded_budget(shard, dcam,
                                                            mesh))
            init_fn, step_fn = make_sharded_distill_step(
                OptimConfig(), cfg, mesh=mesh)
            state = init_fn(shard, decoder, lut)
            bg = torch.zeros(3, device=dev)
            aux = {}

            def step():
                aux.update(step_fn(state, cams, gts, bg)[1])
            ms = timed(step, 5, dev, mesh.group("model"))
            sps = n_data / ms * 1e3
            dbase = dbase or sps
            if rank == 0:
                print(json.dumps({
                    "metric": "distill cam-steps/s", "devices": d,
                    "mesh": [n_data, d // n_data], "value": round(sps, 3),
                    "scaling_efficiency": round(sps / (dbase * d), 3),
                    "loss": round(float(aux["total"]), 4)}), flush=True)
        dist.barrier()


def _spawn(args, argv) -> int:
    """Start --nproc processes of this module joined at 127.0.0.1."""
    nproc = args.nproc or (torch.cuda.device_count()
                           if args.device != "cpu" else 1)
    if nproc < 1:
        raise SystemExit("no card seen: pass --device cpu --nproc N")
    argv = list(sys.argv[1:] if argv is None else argv)
    codes = wait_all(spawn([sys.executable, "-m", "goi_tpu_torch.scale",
                            *argv], nproc))
    return max(codes, key=abs)


if __name__ == "__main__":
    sys.exit(main())
