"""Step timing and profiler integration.

Counterpart of goi_tpu/utils/profiling.py (the role of the reference's
CUDA-event wall timing, ref:train.py:75-76, 113, 170 'iter_time', and
its GUI FPS readout, gui/main.py:556-558): a host-clock EMA step timer
that synchronises the card before it reads the clock (the card runs
asynchronously to the host), and torch.profiler traces.
"""

from __future__ import annotations

import contextlib
import time
from typing import Optional

import torch


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class StepTimer:
    """EMA wall-clock per step + FPS, like the GUI readout."""

    def __init__(self, ema: float = 0.95):
        self.ema = ema
        self.avg: Optional[float] = None
        self._t0: Optional[float] = None

    def __enter__(self):
        _sync()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        _sync()
        dt = time.perf_counter() - self._t0
        self.avg = dt if self.avg is None else (
            self.ema * self.avg + (1 - self.ema) * dt)
        return False

    @property
    def ms(self) -> float:
        return (self.avg or 0.0) * 1e3

    @property
    def fps(self) -> float:
        return 1.0 / self.avg if self.avg else 0.0

    def __str__(self):
        return f"{self.ms:.1f} ms ({self.fps:.1f} FPS)"


@contextlib.contextmanager
def trace(log_dir: str):
    """A torch.profiler trace of the block (CPU and, when present, the
    card), written to `log_dir` for TensorBoard's profiler plugin."""
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts,
                 on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield log_dir


annotate = torch.profiler.record_function
