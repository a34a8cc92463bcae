"""Adaptive density control: clone / split / prune at a fixed capacity.

Counterpart of goi_tpu/train/densify.py, with the reference's behaviour
(ref:scene/gaussian_model.py:360-514):
  - accumulate per-Gaussian screen-space gradient norms and counts
  - clone small Gaussians whose gradient reaches the threshold
  - split large ones into 2 samples drawn from the Gaussian itself,
    scale / (0.8 * 2), pruning the parent
  - prune by minimum opacity, and by screen radius and world scale
  - Adam moments of new Gaussians start at zero
    (cat_tensors_to_optimizer, ref::410-430)

The scene keeps a capacity and a validity mask, as in the JAX package:
clones and split children are written into free rows (ranked by a
prefix sum over the free mask), a prune clears validity. The rows are
written in place into the scene's parameter tensors, under no_grad, so
the tensors a `torch.optim.Adam` holds stay its keys; the written rows'
moments are zeroed and the step count is left alone (optax keeps one
count per group, and the zeroed rows keep it too). Only
`grow_capacity` replaces the tensors, and with them the optimizer.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from goi_tpu_torch.core.scene import GaussianScene, build_rotation_matrix


@dataclasses.dataclass
class DensifyStats:
    xyz_grad_accum: torch.Tensor   # (N,)
    denom: torch.Tensor            # (N,)
    max_radii: torch.Tensor        # (N,) int32

    @staticmethod
    def create(capacity: int, device="cuda") -> "DensifyStats":
        return DensifyStats(
            xyz_grad_accum=torch.zeros(capacity, device=device),
            denom=torch.zeros(capacity, device=device),
            max_radii=torch.zeros(capacity, dtype=torch.int32,
                                  device=device))


def add_stats(stats: DensifyStats, mean2d_grad_pixel: torch.Tensor,
              radii: torch.Tensor, width: int,
              height: int) -> DensifyStats:
    """Accumulate the NDC-scaled viewspace gradient norm of the visible
    Gaussians (ref:scene/gaussian_model.py:512-514; the CUDA backward
    stores dL/dmean2D in NDC units through the 0.5*W/H factors,
    ref:cuda_rasterizer/backward.cu:498-499)."""
    vis = radii > 0
    scale = torch.tensor([[0.5 * width, 0.5 * height]],
                         device=mean2d_grad_pixel.device)
    norm = torch.linalg.norm(mean2d_grad_pixel * scale, dim=-1)
    return DensifyStats(
        xyz_grad_accum=stats.xyz_grad_accum + torch.where(
            vis, norm, torch.zeros_like(norm)),
        denom=stats.denom + vis.to(torch.float32),
        max_radii=torch.maximum(stats.max_radii, radii))


def _allocate_slots(valid: torch.Tensor):
    """Rank the free rows: (slot of rank r (N,), number of free rows).
    Ranks at or past the number of free rows map to N, the dropped
    slot."""
    n = valid.shape[0]
    free = ~valid
    rank_of_slot = torch.cumsum(free.to(torch.int64), 0) - 1
    # one spare entry past the end takes the writes of the valid rows
    slot_of_rank = torch.full((n + 1,), n, dtype=torch.int64,
                              device=valid.device)
    slot_of_rank[torch.where(free, rank_of_slot,
                             torch.full_like(rank_of_slot, n))] = \
        torch.arange(n, device=valid.device)
    return slot_of_rank[:n], free.sum()


def _split_noise(generator: torch.Generator, n: int,
                 device) -> torch.Tensor:
    """Standard normal draws (2, n, 3): one (n, 3) draw for every row,
    per split child, as the JAX package draws normal(sub, (n, 3)) after
    each key split. Drawn on the generator's device."""
    return torch.randn((2, n, 3), generator=generator,
                       device=generator.device).to(device)


def _rotate(rot: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """rot @ v per row, (N, 3, 3) x (N, 3), summed as chained
    multiply-adds in the order of the JAX package's einsum on the CPU,
    so that both give the same bits there."""
    out = rot[..., 0] * v[:, None, 0]
    for j in (1, 2):
        out = torch.addcmul(out, rot[..., j], v[:, None, j])
    return out


def _moment_tensors(opt: Optional[torch.optim.Optimizer], n: int):
    """Every float tensor of the optimizer's state with leading dim n:
    the per-Gaussian moments (fix_leaf's rule in the JAX package)."""
    if opt is None:
        return
    for state in opt.state.values():
        for v in state.values():
            if torch.is_tensor(v) and v.dim() >= 1 and v.shape[0] == n \
                    and v.is_floating_point():
                yield v


@torch.no_grad()
def densify_and_prune(
    scene: GaussianScene,
    opt: Optional[torch.optim.Optimizer],
    stats: DensifyStats,
    generator: torch.Generator,
    *,
    grad_threshold: float,
    min_opacity: float,
    extent: float,
    percent_dense: float = 0.01,
    max_screen_size: int = 0,
) -> Tuple[GaussianScene, Optional[torch.optim.Optimizer], DensifyStats,
           dict]:
    """Clone, split and prune; returns (scene, opt, fresh stats, info).
    The parameter rows and the optimizer's moments are written in place
    (the returned scene holds the same parameter tensors and a new
    `valid`). info holds 0-dim tensors: n_clone, n_split, n_pruned,
    n_valid and overflow (the clone and child rows that found no free
    row)."""
    n = scene.capacity
    dev = scene.device
    grads = stats.xyz_grad_accum / torch.clamp(stats.denom, min=1.0)
    grads = torch.where(stats.denom > 0, grads, torch.zeros_like(grads))
    scaling = scene.get_scaling()
    max_scale = torch.max(scaling, dim=-1).values
    hot = (grads >= grad_threshold) & scene.valid

    clone_mask = hot & (max_scale <= percent_dense * extent)
    split_mask = hot & (max_scale > percent_dense * extent)

    # ---- allocation: clones first, then 2 children per split ----
    slot_of_rank, num_free = _allocate_slots(scene.valid)
    c_rank = torch.cumsum(clone_mask.to(torch.int64), 0) - 1
    n_clone = clone_mask.sum()
    s_rank = torch.cumsum(split_mask.to(torch.int64), 0) - 1
    n_split = split_mask.sum()
    drop = torch.full((n,), n, dtype=torch.int64, device=dev)

    def slots_of(mask, rank):
        return torch.where(mask, slot_of_rank[torch.clamp(rank, 0, n - 1)],
                           drop)

    # a split whose children would be dropped keeps its parent: the
    # whole split is gated on its last child's rank fitting
    split_ok = split_mask & (n_clone + 2 * s_rank + 1 < num_free)

    params = scene.params()
    c_slots = slots_of(clone_mask, c_rank)
    child_slots = [slots_of(split_ok, n_clone + 2 * s_rank + c)
                   for c in range(2)]
    # the children, sampled from the parent Gaussian (ref::454-478);
    # child scale = log(scale / (0.8 * 2))
    rot = build_rotation_matrix(scene.get_rotation())
    noise = _split_noise(generator, n, dev)
    child_xyz = [params["xyz"] + _rotate(rot, noise[c] * scaling)
                 for c in range(2)]
    child_scaling = torch.log(scaling / (0.8 * 2))

    # clones: exact copies (ref::480-494); then each child's rows. Rows
    # are read from valid rows and written to free ones, so no write
    # changes a row that a later write reads.
    writes = [(c_slots, {})] + [
        (child_slots[c], {"xyz": child_xyz[c], "scaling": child_scaling})
        for c in range(2)]
    for slots, override in writes:
        keep = slots < n          # slot n is the dropped one
        for k, v in params.items():
            v[slots[keep]] = override.get(k, v)[keep]

    just_written = torch.zeros(n + 1, dtype=torch.bool, device=dev)
    just_written[torch.cat([s for s, _ in writes])] = True
    just_written = just_written[:n]
    new_valid = scene.valid | just_written

    # prune: split parents whose children were written, low opacity and
    # (with a screen size) oversized ones (ref::496-508); never the rows
    # just written (their stats are stale zeros)
    opacity = torch.sigmoid(params["opacity"][:, 0])
    prune = split_ok | (opacity < min_opacity)
    if max_screen_size:
        prune = prune | (stats.max_radii > max_screen_size) \
            | (max_scale > 0.1 * extent)
    prune = prune & ~just_written
    new_valid = new_valid & ~prune

    # optimizer-state surgery: zero the written rows' Adam moments
    # (ref:scene/gaussian_model.py:410-430)
    for m in _moment_tensors(opt, n):
        m[just_written] = 0.0

    info = {
        "n_clone": n_clone,
        "n_split": n_split,
        "n_pruned": prune.sum(),
        "n_valid": new_valid.sum(),
        "overflow": torch.clamp(n_clone + 2 * n_split - num_free, min=0),
    }
    return (scene.replace(valid=new_valid), opt,
            DensifyStats.create(n, device=dev), info)


def _pad_rows(t: torch.Tensor, new_capacity: int) -> torch.Tensor:
    """Zero rows appended up to new_capacity (invalid, zero moments)."""
    return torch.cat([t, t.new_zeros((new_capacity - t.shape[0],)
                                     + tuple(t.shape[1:]))])


def grow_capacity(scene: GaussianScene, opt: Optional[torch.optim.Adam],
                  stats: DensifyStats, new_capacity: int):
    """Pad every per-Gaussian tensor (parameters, validity, the Adam
    moments, the densify stats) from the capacity to `new_capacity`
    with zeros. The parameters become new tensors, so the optimizer is
    rebuilt around them with its groups, its padded moments and the
    same step counts (bias correction reads them). Returns (scene, opt,
    stats); call it when densify_and_prune reports an overflow."""
    n = scene.capacity
    if new_capacity < n:
        raise ValueError(f"new_capacity {new_capacity} < capacity {n}")
    with torch.no_grad():
        new_params = {k: _pad_rows(v.detach(), new_capacity)
                      .requires_grad_(v.requires_grad)
                      for k, v in scene.params().items()}
        new_scene = scene.with_params(new_params).replace(
            valid=_pad_rows(scene.valid, new_capacity))
        new_stats = DensifyStats(
            **{f.name: _pad_rows(getattr(stats, f.name), new_capacity)
               for f in dataclasses.fields(stats)})
        if opt is None:
            return new_scene, None, new_stats
        swap = {id(v): new_params[k] for k, v in scene.params().items()}
        groups = [dict(g, params=[swap[id(p)] for p in g["params"]])
                  for g in opt.param_groups]
        new_opt = type(opt)(groups, **opt.defaults)
        for p, state in opt.state.items():
            new_opt.state[swap[id(p)]] = {
                k: (_pad_rows(v, new_capacity) if torch.is_tensor(v)
                    and v.dim() >= 1 and v.shape[0] == n else v)
                for k, v in state.items()}
    return new_scene, new_opt, new_stats


@torch.no_grad()
def reset_opacity(scene: GaussianScene,
                  opt: Optional[torch.optim.Optimizer]):
    """Clamp opacities to <= 0.01 (ref:scene/gaussian_model.py:291-294)
    through the logit, in place, and zero the opacity group's moments
    (replace_tensor_to_optimizer). Returns (scene, opt)."""
    new_op = torch.clamp(scene.get_opacity(), max=0.01)
    scene.opacity.copy_(torch.log(new_op / (1.0 - new_op)))
    if opt is not None and scene.opacity in opt.state:
        for k, v in opt.state[scene.opacity].items():
            if torch.is_tensor(v) and v.shape == scene.opacity.shape:
                v.zero_()
    return scene, opt
