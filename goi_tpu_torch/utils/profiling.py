"""Step timing, profiler traces, and the port's own spans and counters.

Counterpart of goi_tpu/utils/profiling.py (the role of the reference's
CUDA-event wall timing, ref:train.py:75-76, 113, 170 'iter_time', and
its GUI FPS readout, gui/main.py:556-558): a host-clock EMA step timer
that synchronises the card before it reads the clock (the card runs
asynchronously to the host), and torch.profiler traces.

Spans and counters time the port's layers from inside, where they do
the work. They are armed only while a torch profiler is active
(`torch.autograd._profiler_enabled()`, read at a span's entry): under
`trace(log_dir)` the operator's TensorBoard trace carries them, and the
benchmark's profiled window reads them with `snapshot()`. Disarmed,
`span` returns one shared null context and `count` does nothing: no
event, no allocation, no launch, no synchronise. Armed, a span opens a
host range of its name in the profiler's trace (a CPU-op scope,
`_RecordFunctionFast`: unlike a `record_function` annotation it gets no
device-side twin that would fill the idle gaps it encloses), reads the
host clock and records two CUDA timing events on the current stream at
its entry and exit (no synchronise), and notes its parent and its unit:
the step, frame or request it belongs to. A unit's span opened while a
span of the same unit is open joins it: a caller may open the unit
around more than the function that opens it (the RES request around the
render it starts from). Span names never hold a kernel's name.

Spans (file, function):
  distill.step (unit)    train/distill.py, create_distill_state's
                         train_step
    render               raster/render.py render
      render.preprocess  render, around preprocess
      render.binning     render._bin: expansion, cull, sort, tile ranges
    loss.forward         train/distill.py distill_loss, around
                         distillation_loss
    distill.backward     train_step, around loss.backward(); its self
                         time is the loss's backward
      render.backward    render's tensor hook on the semantic map's
                         gradient, to the end of the backward pass
                         (`span_backward`)
        blend.reduce     raster/cuda_blend.py _BlendCore.backward,
                         around reduce_rows
    optim                train_step: set_scheduled_lr and the Adam steps
  query.frame (unit)     app/session.py QuerySession.render_view
    render               (as above)
    query.overlay        app/session.py _frame after render: decode,
                         similarity, heat, composite, uint8 finish
    query.to_host        render_view, around the frame's copy to the host
  dist.step (unit)       dist/shard.py make_sharded_distill_step's step_fn
    dist.mean_over_data  dist/shard.py _mean_over_data; its self time is
                         the gradients' cat, divide and copies back
      dist.allreduce     around its dist.all_reduce
  res.request (unit)     query/res.py TorchRESProvider.predict_mask
    dino.backbone        query/grounding.py: the image's resize and
                         normalisation (GroundingDINOTorch.inputs), Swin
                         and the input projections (GroundingDINO.encode)
    dino.text            encode: BERT and feat_map
    dino.encoder         encode: the feature enhancer
      deform_attn        query/deform_attn.py ms_deform_attn_core
    dino.decoder         GroundingDINO.forward: the query selection and
                         the decoder; predict: the outputs' copy to the
                         host
    sam.encoder          query/sam.py SamTorch.set_image: the resize,
                         normalisation and padding, the image encoder
    sam.decode           SamTorch.predict_boxes: the prompt encoder, the
                         mask decoder, the upscale chain, the copy to the
                         host
    res.host             the caption's tokens and masks (inputs), the
                         thresholds and phrases (predict), the boxes'
                         pixels, the re-rank and the union (predict_mask)
Counters (raster/render.py _bin; raster/cuda_blend.py blend_tiles_cuda;
raster/preprocess.py preprocess; semantic/losses.py distillation_loss;
query/grounding.py encode;
query/deform_attn.py ms_deform_attn_core; query/res.py predict_mask):
  preprocess.fused       the Gaussians preprocessed by the kernel
  preprocess.plain       the Gaussians of CUDA tensors preprocessed by the
                         composition (a gradient flows to the geometry)
  loss.fused             the pixels whose loss the row kernel computed
                         (csrc/distill_loss.cu)
  loss.plain             the pixels whose loss the composition computed
                         (CPU tensors)
  binning.sorted_slots   the sort's length (the instance budget)
  binning.kept           the instances the blend walks (the tiles' ranges)
  blend.walked           the forward's walked pairs (raw's per-pixel
                         counts, summed in float64)
  blend.blended          the forward's blended pairs (likewise)
  dino.image_tokens      GroundingDINO's image tokens over its levels
  deform.samples         deformable attention's queries x heads x levels
                         x points, summed over the calls
  res.boxes              the boxes the detector hands SAM
"""

from __future__ import annotations

import collections
import contextlib
import threading
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
    card), written to `log_dir` for TensorBoard's profiler plugin. The
    port's spans (the module docstring lists them) are armed inside it
    and appear in the trace as host ranges of their names."""
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts,
                 on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield log_dir


UNITS = ("distill.step", "query.frame", "dist.step", "res.request")


class _Span:
    """One armed span: the context manager and its record."""

    __slots__ = ("name", "id", "parent", "unit", "t0", "t1", "ev0", "ev1",
                 "_range")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        _REGISTRY.open(self)
        return self

    def __exit__(self, *exc):
        _REGISTRY.close(self)
        return False


class Registry:
    """The process's spans and counters. One span stack behind a lock,
    not one a thread: on the card the backward runs on autograd's device
    thread while the calling thread waits in backward(), so spans of two
    threads nest and never interleave."""

    def __init__(self):
        self._lock = threading.Lock()
        self.reset()

    def reset(self) -> None:
        with self._lock:
            self._stack, self._done = [], []
            self._units = collections.Counter()
            self._host, self._device = {}, {}
            self._next = 0

    def open(self, s: _Span) -> None:
        s._range = torch._C._profiler._RecordFunctionFast(s.name)
        s._range.__enter__()
        s.ev0 = s.ev1 = None
        if torch.cuda.is_initialized():
            s.ev0 = torch.cuda.Event(enable_timing=True)
            s.ev1 = torch.cuda.Event(enable_timing=True)
            s.ev0.record()
        with self._lock:
            top = self._stack[-1] if self._stack else None
            s.id, self._next = self._next, self._next + 1
            s.parent = None if top is None else top.id
            if s.name in UNITS:
                self._units[s.name] += 1
                s.unit = s.id
            else:
                s.unit = None if top is None else top.unit
            self._stack.append(s)
        s.t0 = time.perf_counter_ns()

    def close(self, s: _Span) -> None:
        s.t1 = time.perf_counter_ns()
        if s.ev1 is not None:
            s.ev1.record()
        s._range.__exit__(None, None, None)
        s._range = None
        with self._lock:
            self._stack.remove(s)
            self._done.append(s)

    def is_open(self, name: str) -> bool:
        with self._lock:
            return any(s.name == name for s in self._stack)

    def count(self, name: str, value) -> None:
        if not isinstance(value, torch.Tensor):
            with self._lock:
                self._host[name] = self._host.get(name, 0) + value
            return
        v = value.detach().reshape(())
        with self._lock:
            acc = self._device.get(name)
            if acc is None:
                self._device[name] = v.to(
                    torch.float64 if v.is_floating_point() else torch.int64,
                    copy=True)
            else:
                acc.add_(v)

    def records(self) -> list:
        """(name, id, parent, unit) of every closed span, in closing
        order."""
        with self._lock:
            return [(s.name, s.id, s.parent, s.unit) for s in self._done]

    def snapshot(self) -> dict:
        """Synchronise once and resolve the events: {"units": {name: n},
        "spans": {name: {calls, host_ms, device_ms, self_host_ms,
        self_device_ms}}, "counters": {name: total}}. A span's self time
        is its time less its children's. Without CUDA the spans ran on
        the host, and device_ms is the host's time."""
        with self._lock:
            done = list(self._done)
            units = dict(self._units)
            host, device = dict(self._host), dict(self._device)
        _sync()
        ms = {}
        for s in done:
            h = (s.t1 - s.t0) * 1e-6
            ms[s.id] = (h, h if s.ev0 is None else s.ev0.elapsed_time(s.ev1))
        kids = collections.defaultdict(lambda: [0.0, 0.0])
        for s in done:
            if s.parent in ms:
                kids[s.parent][0] += ms[s.id][0]
                kids[s.parent][1] += ms[s.id][1]
        spans = {}
        for s in done:
            a = spans.setdefault(s.name, {
                "calls": 0, "host_ms": 0.0, "device_ms": 0.0,
                "self_host_ms": 0.0, "self_device_ms": 0.0})
            a["calls"] += 1
            h, d = ms[s.id]
            a["host_ms"] += h
            a["device_ms"] += d
            a["self_host_ms"] += h - kids[s.id][0]
            a["self_device_ms"] += d - kids[s.id][1]
        counters = dict(host)
        for k, acc in device.items():
            counters[k] = counters.get(k, 0) + acc.item()
        return {"units": units, "spans": spans, "counters": counters}


_REGISTRY = Registry()
_NULL = contextlib.nullcontext()


def armed() -> bool:
    """Whether spans and counters record: a torch profiler is active."""
    return torch.autograd._profiler_enabled()


def span(name: str):
    """Time the block as the span `name` while armed (the module
    docstring lists the spans); disarmed, or a unit already open under
    this name, a shared null context."""
    if not torch.autograd._profiler_enabled():
        return _NULL
    if name in UNITS and _REGISTRY.is_open(name):
        return _NULL
    return _Span(name)


def span_backward(t: torch.Tensor, name: str) -> None:
    """While armed, time the backward pass from t's gradient on as the
    span `name`: a tensor hook opens it when the gradient reaches t and
    a callback queued on autograd's engine closes it when the pass ends,
    both on the thread that runs the pass."""
    if not (t.requires_grad and torch.autograd._profiler_enabled()):
        return

    def opened(grad):
        s = _Span(name).__enter__()
        torch.autograd.Variable._execution_engine.queue_callback(
            lambda: s.__exit__(None, None, None))

    t.register_hook(opened)


def count(name: str, value) -> None:
    """While armed, add `value` (a Python number, or a device scalar
    tensor summed on the device in int64 or float64) to the counter
    `name`. Callers test `armed()` before reducing a tensor for it."""
    if torch.autograd._profiler_enabled():
        _REGISTRY.count(name, value)


def snapshot() -> dict:
    """The spans and counters recorded so far (`Registry.snapshot`)."""
    return _REGISTRY.snapshot()


def records() -> list:
    """(name, id, parent, unit) of every closed span."""
    return _REGISTRY.records()


def reset() -> None:
    _REGISTRY.reset()
