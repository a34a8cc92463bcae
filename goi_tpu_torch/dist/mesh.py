"""The ('data', 'model') mesh of ranks and the scene's row sharding.

Counterpart of goi_tpu/dist/mesh.py, over torch.distributed:

- axis 'data': camera-batch data parallelism;
- axis 'model': Gaussian sharding. Each rank owns a contiguous slice of
  the capacity-padded per-Gaussian tensors; the sharded render
  (dist/render.py) gathers or exchanges the screen-space splats and its
  backward returns their gradients to the owners.

Ranks fill the mesh row-major, as the JAX package reshapes its device
list: rank r sits at data index r // n_model and model index
r % n_model. A process group holds each row ('model') and each column
('data'); every rank builds all of them, in one order, as
torch.distributed.new_group requires.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch
import torch.distributed as dist

AXES = ("data", "model")


def rank_device(device: str = "cuda") -> torch.device:
    """This process's device: cuda:<local rank> (LOCAL_RANK, else the
    rank modulo the cards seen), or the CPU when asked for."""
    if device == "cpu":
        return torch.device("cpu")
    local = os.environ.get("LOCAL_RANK")
    rank = dist.get_rank() if dist.is_initialized() else 0
    return torch.device("cuda", int(local) if local is not None
                        else rank % max(torch.cuda.device_count(), 1))


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in an (n_data, n_model) mesh. `coords` is None on
    a rank the mesh leaves out (a mesh over fewer ranks than the world)."""

    n_data: int
    n_model: int
    coords: Optional[tuple]
    groups: dict
    device: torch.device

    @property
    def shape(self) -> dict:
        return {"data": self.n_data, "model": self.n_model}

    @property
    def member(self) -> bool:
        return self.coords is not None

    def index(self, axis: str) -> int:
        if not self.member:
            raise RuntimeError("this rank is not in the mesh")
        return self.coords[AXES.index(axis)]

    def group(self, axis: str):
        return self.groups[axis]


def make_mesh(n_data: int = 1, n_model: Optional[int] = None,
              device: str = "cuda") -> Mesh:
    """Mesh of the first n_data * n_model ranks of the world (n_model
    defaults to the rest of the world over n_data). Every rank of the
    world calls it (the groups are collective to build); the ranks past
    the mesh get coords None. device: 'cuda' (each rank's own card) or
    'cpu'."""
    if not dist.is_initialized():
        raise RuntimeError("torch.distributed is not initialised: call "
                           "dist.multihost.init_multihost first")
    world, rank = dist.get_world_size(), dist.get_rank()
    n_model = n_model or world // n_data
    if not 0 < n_data * n_model <= world:
        raise ValueError(f"mesh ({n_data}, {n_model}) over {world} ranks")
    groups = {}
    for d in range(n_data):
        g = dist.new_group([d * n_model + m for m in range(n_model)])
        if rank // n_model == d:
            groups["model"] = g
    for m in range(n_model):
        g = dist.new_group([d * n_model + m for d in range(n_data)])
        if rank % n_model == m and rank < n_data * n_model:
            groups["data"] = g
    coords = (divmod(rank, n_model) if rank < n_data * n_model else None)
    return Mesh(n_data, n_model, coords,
                groups if coords is not None else {}, rank_device(device))


@dataclasses.dataclass(frozen=True)
class RowSharding:
    """Every per-Gaussian tensor split on its leading axis: shard `index`
    of `parts` holds rows [index * cap / parts, (index + 1) * cap / parts)."""

    parts: int
    index: int

    def rows(self, capacity: int) -> slice:
        if capacity % self.parts:
            raise ValueError(
                f"capacity {capacity} not divisible by model axis "
                f"{self.parts}; pad the scene (GaussianScene capacity "
                f"padding) first")
        step = capacity // self.parts
        return slice(self.index * step, (self.index + 1) * step)


def scene_sharding(mesh: Mesh) -> RowSharding:
    """The scene's sharding on this rank: rows over 'model', replicated
    over 'data'."""
    return RowSharding(mesh.shape["model"], mesh.index("model"))


def shard_scene(scene, mesh: Mesh):
    """This rank's rows of a whole scene (on the host or any device), on
    the rank's device, in memory of their own: the shard keeps no
    reference to the whole scene's storage. Capacity must be divisible
    by the 'model' axis."""
    rows = scene_sharding(mesh).rows(scene.capacity)
    return scene.replace(**{
        k: getattr(scene, k)[rows].to(mesh.device, copy=True).contiguous()
        for k in scene.PARAM_FIELDS + ("valid",)})
