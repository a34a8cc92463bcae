"""Multi-process wiring: one process per card over torch.distributed.

Counterpart of goi_tpu/dist/multihost.py. A run is N identical
processes, one per card; `init_multihost` joins them into one process
group (NCCL on the cards, gloo when the caller asks for the CPU) and the
same mesh and sharded-render code of this package then spans them.

Launch (one command per process, or torchrun):

  GOI_COORD=host0:8476 GOI_NUM_PROCS=4 GOI_PROC_ID=<0..3> \\
      python -m goi_tpu_torch.scale    # calls init_multihost() first

  torchrun --nproc_per_node 4 -m goi_tpu_torch.scale

In JAX a process sees every device of the mesh; here a process owns one
card and sees the others only through collectives, so
`shard_rows_global` and `shard_scene_global` keep this process's rows
and `replicate_to_global` is a copy onto the rank's device.
"""

from __future__ import annotations

import datetime
import os
import socket
import subprocess
import time
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from goi_tpu_torch.dist.mesh import Mesh, make_mesh, shard_scene


def _bind_card(local_rank: int, local_world: int) -> None:
    """Pin this process to its card before the group forms; more local
    ranks than cards raises."""
    cards = torch.cuda.device_count()
    if local_world > cards or local_rank >= cards:
        raise RuntimeError(f"{local_world} ranks on this host but {cards} "
                           f"cards seen: one process per card")
    torch.cuda.set_device(local_rank)


def init_multihost(coordinator_address: Optional[str] = None,
                   num_processes: Optional[int] = None,
                   process_id: Optional[int] = None, *,
                   device: str = "cuda",
                   timeout: Optional[datetime.timedelta] = None) -> bool:
    """Join the process group from the arguments or GOI_COORD /
    GOI_NUM_PROCS / GOI_PROC_ID (the JAX version's variables; the
    coordinator is host:port of process 0, init_method tcp://), else from
    torchrun's RANK / WORLD_SIZE / MASTER_ADDR (init_method env://).
    Backend NCCL on the cards (each process pinned to its card first),
    gloo for device="cpu". Returns True when a group of more than one
    process formed, False with nothing to join (one process). With a
    coordinator given, a group that cannot form raises: a run never
    carries on as one process."""
    coord = coordinator_address or os.environ.get("GOI_COORD")
    nproc = num_processes if num_processes is not None else \
        int(os.environ.get("GOI_NUM_PROCS", "0") or 0)
    pid = process_id if process_id is not None else \
        int(os.environ.get("GOI_PROC_ID", "-1"))
    backend = "gloo" if device == "cpu" else "nccl"
    kw = {} if timeout is None else {"timeout": timeout}
    if coord is None and nproc == 0:
        env = os.environ
        if not all(k in env for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR")):
            return False
        if backend == "nccl":
            _bind_card(int(env.get("LOCAL_RANK", env["RANK"])),
                       int(env.get("LOCAL_WORLD_SIZE", env["WORLD_SIZE"])))
        dist.init_process_group(backend, init_method="env://", **kw)
        return dist.get_world_size() > 1
    if coord is None or nproc <= 0 or not 0 <= pid < nproc:
        raise ValueError(f"coordinator {coord!r}, {nproc} processes and "
                         f"process id {pid} do not make a group")
    if backend == "nccl":
        _bind_card(pid % max(torch.cuda.device_count(), 1),
                   int(os.environ.get("LOCAL_WORLD_SIZE", nproc)))
    dist.init_process_group(backend, init_method=f"tcp://{coord}",
                            world_size=nproc, rank=pid, **kw)
    return True


def make_global_mesh(n_data: int = 1, n_model: Optional[int] = None,
                     device: str = "cuda") -> Mesh:
    """('data', 'model') mesh over every process. Ranks fill it row-major,
    so a 'model' group is consecutive ranks, which torchrun places on one
    host: its all-gather and reduce-scatter traffic stays on NVLink,
    while 'data' only averages gradients once a step."""
    return make_mesh(n_data, n_model, device=device)


def replicate_to_global(x, mesh: Mesh) -> torch.Tensor:
    """A value every process holds (array or tensor) -> a tensor on this
    rank's device (every process must pass the same values)."""
    return torch.as_tensor(x).to(mesh.device)


def shard_rows_global(x, mesh: Mesh, axis: str = "model") -> torch.Tensor:
    """The full (N, ...) array or tensor every process holds -> this
    rank's rows along `axis`, on its device, in memory of their own."""
    x = torch.as_tensor(x)
    n, parts = x.shape[0], mesh.shape[axis]
    if n % parts:
        raise ValueError(f"{n} rows do not split over {parts} shards")
    lo = mesh.index(axis) * (n // parts)
    return x[lo:lo + n // parts].to(mesh.device, copy=True).contiguous()


def shard_scene_global(scene, mesh: Mesh):
    """dist.mesh.shard_scene for the multi-process run: every process
    holds the whole scene (on the host or its card) and keeps its rows
    on its device."""
    return shard_scene(scene, mesh)


def local_camera_indices(num_cameras: int) -> list:
    """Round-robin camera split over the processes: each loads only its
    own images and feature maps."""
    if not dist.is_initialized():
        return list(range(num_cameras))
    return list(range(dist.get_rank(), num_cameras, dist.get_world_size()))


def free_port() -> int:
    """A TCP port on 127.0.0.1 that is free now, for a coordinator."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(cmd: Sequence[str], nproc: int, *, env: Optional[dict] = None,
          stdout: Optional[Sequence] = None) -> list:
    """Start `nproc` processes of `cmd` on this host, joined at
    127.0.0.1:<a free port> through GOI_COORD / GOI_NUM_PROCS /
    GOI_PROC_ID, process r on card r (LOCAL_RANK). `env` is the base
    environment (default os.environ); `stdout[r]` is rank r's output
    file, its errors joined to it (None: inherited). Returns the
    processes; `wait_all` collects them."""
    port = free_port()
    base = os.environ if env is None else env
    procs = []
    for r in range(nproc):
        out = stdout[r] if stdout is not None else None
        procs.append(subprocess.Popen(
            list(cmd), env=dict(base, GOI_COORD=f"127.0.0.1:{port}",
                                GOI_NUM_PROCS=str(nproc), GOI_PROC_ID=str(r),
                                LOCAL_RANK=str(r),
                                LOCAL_WORLD_SIZE=str(nproc)),
            stdout=out, stderr=None if out is None else subprocess.STDOUT))
    return procs


def wait_all(procs, timeout: Optional[float] = None) -> list:
    """Each process's exit code, waiting at most `timeout` seconds in
    all; a process still running then is killed and reads None."""
    deadline = None if timeout is None else time.monotonic() + timeout
    codes = []
    try:
        for p in procs:
            left = None if deadline is None else \
                max(deadline - time.monotonic(), 0.1)
            try:
                codes.append(p.wait(timeout=left))
            except subprocess.TimeoutExpired:
                codes.append(None)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return codes
