"""Sharded distillation step: camera-batch data parallelism x Gaussian
sharding.

Counterpart of goi_tpu/dist/shard.py. The scene arrives as this rank's
rows (shard_scene over 'model'), the camera batch and its feature maps
as this rank's slice along 'data' (shard_batch). A step renders each of
the rank's cameras with render_sharded, whose backward returns the
splat gradients to their owners summed over 'model'; then every
gradient is averaged over 'data' (one all-reduce of all of them), so the
step descends the mean loss over the global batch. The decoder and LUT
gradients need no sum over 'model': every rank of a 'model' group
decodes the same whole frame. Each rank then steps Adam on its own
shard, decoder and LUT (the decoder and LUT stay equal on every rank).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.distributed as dist

from goi_tpu_torch.core.camera import (_TENSOR_FIELDS, Camera, stack_cameras,
                                       unstack_cameras)
from goi_tpu_torch.dist.collectives import all_reduce_max
from goi_tpu_torch.dist.mesh import Mesh
from goi_tpu_torch.dist.render import render_sharded
from goi_tpu_torch.raster.render import RasterConfig
from goi_tpu_torch.semantic.losses import distillation_loss
from goi_tpu_torch.train.distill import (ANNEAL_STEP, DistillState,
                                         create_distill_state)
from goi_tpu_torch.train.optim import OptimConfig, set_scheduled_lr
from goi_tpu_torch.utils.profiling import span

__all__ = ["stack_cameras", "shard_batch", "make_sharded_distill_step"]

TERMS = ("lab", "sl", "sl1", "recc", "total")


def shard_batch(mesh: Mesh, batched_cams: Camera, gt_feats):
    """This rank's contiguous slice along 'data' of a stacked camera
    batch (stack_cameras) and its (B, C, H, W) feature maps (array or
    tensor), on the rank's device; B must divide over 'data'."""
    b, n = batched_cams.world_view.shape[0], mesh.shape["data"]
    if b % n:
        raise ValueError(f"a batch of {b} cameras does not split over "
                         f"{n} data ranks")
    lo = mesh.index("data") * (b // n)
    sl = slice(lo, lo + b // n)
    cams = dataclasses.replace(batched_cams, **{
        f: getattr(batched_cams, f)[sl].to(mesh.device)
        for f in _TENSOR_FIELDS})
    return cams, torch.as_tensor(gt_feats[sl]).to(mesh.device)


def make_sharded_distill_step(cfg: OptimConfig, raster_cfg: RasterConfig,
                              spatial_lr_scale: float = 1.0, *, mesh: Mesh):
    """Returns (init_fn, step_fn).

    init_fn(scene, decoder, lut) -> DistillState: this rank's scene
    shard, the decoder and the LUT (copied, as create_distill_state does)
    with their optimizers.
    step_fn(state, cams, gts, bg) -> (state, aux): one step on this
    rank's cameras (a stacked Camera) and feature maps (B_local, C, H, W)
    from shard_batch; updates the state in place. aux holds the loss
    terms averaged over the global batch and num_slots / num_instances,
    the max over every rank and camera (hold them against
    max_instances // n_model)."""

    def init_fn(scene, decoder, lut) -> DistillState:
        state, _ = create_distill_state(scene, decoder, lut, cfg,
                                        spatial_lr_scale)
        return state

    def step_fn(state: DistillState, cams: Camera, gts: torch.Tensor,
                bg: torch.Tensor) -> Tuple[DistillState, dict]:
        with span("dist.step"):
            opts = [o for o in (state.opt_scene, state.opt_decoder,
                                state.opt_lut) if o is not None]
            for o in opts:
                o.zero_grad(set_to_none=True)
            views = unstack_cameras(cams)
            anneal_t = 1.0 if state.step < ANNEAL_STEP else 2.0
            terms = torch.zeros(len(TERMS), device=mesh.device)
            counts = torch.zeros(2, dtype=torch.int64, device=mesh.device)
            for cam, gt in zip(views, gts):
                out = render_sharded(state.scene, cam, bg, raster_cfg, mesh)
                s, h, w = out["semantics"].shape
                loss, aux = distillation_loss(
                    state.decoder, state.lut,
                    out["semantics"].reshape(s, h * w).T,
                    gt.reshape(gt.shape[0], -1).T, anneal_t)
                (loss / len(views)).backward()
                terms += torch.stack([aux[k].detach() for k in TERMS]) \
                    / len(views)
                counts = torch.maximum(counts, torch.stack(
                    [out["num_slots"], out["num_instances"]]).long())
            leaves = [p for p in state.scene.params().values()
                      if p.requires_grad]
            leaves += list(state.decoder.parameters()) + [state.lut]
            _mean_over_data(leaves, terms, mesh)
            counts = all_reduce_max(counts, mesh.group("data"))
            set_scheduled_lr(state.opt_scene, state.step)
            for o in opts:
                o.step()
            state.step += 1
            aux = dict(zip(TERMS, terms))
            aux.update(num_slots=counts[0], num_instances=counts[1])
            return state, aux

    return init_fn, step_fn


def _mean_over_data(leaves, terms: torch.Tensor, mesh: Mesh) -> None:
    """Average every leaf's gradient (a missing one counts as zero) and
    the loss terms over 'data', in one all-reduce."""
    n = mesh.shape["data"]
    with span("dist.mean_over_data"):
        for p in leaves:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        flat = torch.cat([p.grad.reshape(-1) for p in leaves] + [terms])
        with span("dist.allreduce"):
            dist.all_reduce(flat, group=mesh.group("data"))
        flat /= n
        off = 0
        for p in leaves:
            p.grad.copy_(flat[off:off + p.numel()].view_as(p))
            off += p.numel()
        terms.copy_(flat[off:])
