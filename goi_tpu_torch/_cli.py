"""What the port's entry points share: the device flag, the kernel
launch counts and the summary line.

`python -m goi_tpu_torch.{train,render,metrics,eval_seg,viewer}` run on
the CUDA card unless given `--device cpu`; asked for the card where
there is none, they stop. Each ends by printing one summary line,
`[goi_tpu_torch.<cli>] {json}`, with its load and compute seconds and
the launches of each hand-written kernel in the process (a kernel
wrapper counts one for each launch; the plain versions that CPU tensors
run count none).
"""

from __future__ import annotations

import contextlib
import json
import time
from argparse import ArgumentParser

import torch

SUMMARY = "[goi_tpu_torch.{}] "


def add_device_flag(parser: ArgumentParser) -> None:
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")


def resolve_device(name: str) -> torch.device:
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {name}: no CUDA device here (pass "
                         f"--device cpu to run on the CPU)")
    return dev


def kernel_wrappers() -> dict:
    """Kernel name -> its wrapper (its launch count is `launches`)."""
    from goi_tpu_torch.export.mesh import mixture_grid
    from goi_tpu_torch.raster.cuda_blend import blend_bwd, blend_fwd
    from goi_tpu_torch.raster.cuda_trace import trace_fwd
    from goi_tpu_torch.raster.gather import expand_gather, mono_rows
    from goi_tpu_torch.raster.preprocess import preprocess_cuda
    from goi_tpu_torch.raster.reduce import (owner_sums, prefix_blocks,
                                             prefix_boundary)
    from goi_tpu_torch.semantic.losses import loss_rows_cuda
    return {"gather": expand_gather, "blend": blend_fwd,
            "blend_bwd": blend_bwd, "prefix": prefix_blocks,
            "trace": trace_fwd, "prefix_boundary": prefix_boundary,
            "mono_rows": mono_rows, "density_grid": mixture_grid,
            "owner_sums": owner_sums, "preprocess": preprocess_cuda,
            "distill_loss": loss_rows_cuda}


def launch_counts() -> dict:
    return {name: k.launches for name, k in kernel_wrappers().items()}


class Clock:
    """Seconds by phase, the card synchronised at each boundary."""

    def __init__(self, device: torch.device):
        self.device = device
        self.seconds: dict = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        self._sync()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._sync()
            self.seconds[name] = (self.seconds.get(name, 0.0)
                                  + time.perf_counter() - t0)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


def summary(cli: str, clock: Clock, **fields) -> dict:
    """Print and return the entry point's summary line."""
    out = dict({f"{k}_s": v for k, v in clock.seconds.items()},
               launches=launch_counts(), device=str(clock.device), **fields)
    print(SUMMARY.format(cli) + json.dumps(out), flush=True)
    return out
