"""Device traces and spans of a traced run.

`Profile` runs torch.profiler over a steady part of the window and
reduces its events to what the per-layer readers and the result's
`breakdown` take: device busy seconds (the union of the device's
intervals), the traced window's length, device seconds by kernel name,
and the device's idle gaps by what the host was doing in them.
`Spans` times calls into the program's layers with CUDA events and a
synchronise around each.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import time

import torch


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _union(intervals):
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


SHORT_GAP_US = 5.0


def _host_op(host, starts, a, b) -> str:
    """The innermost host operation (the latest to start) that spans the
    middle of the idle gap [a, b] (microseconds)."""
    if b - a < SHORT_GAP_US:
        return "between launches (< 5 us)"
    mid = 0.5 * (a + b)
    i = bisect.bisect_right(starts, mid)
    for j in range(i - 1, max(i - 4000, 0) - 1, -1):
        if host[j][1] >= mid:
            return host[j][2]
    return "host, no op"


class Profile:
    """start() and stop() around `units` (steps or frames) of the
    window; `result()` once stopped."""

    def __init__(self, device):
        self.device = device
        self.prof = None
        self.units = 0
        self.wall = 0.0

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile
        _sync(self.device)
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.__enter__()
        self._t0 = time.perf_counter()

    def stop(self, units: int) -> None:
        _sync(self.device)
        self.wall = time.perf_counter() - self._t0
        self.prof.__exit__(None, None, None)
        self.units = units
        # the profiler's own time too: start to the end of its exit
        self.held = time.perf_counter() - self._t0

    def result(self) -> dict:
        """busy_s, window_s, units, kernels {name: device s}, gaps
        {host op: idle s}; empty when the trace holds no device time."""
        dev_t = torch.autograd.DeviceType.CUDA
        events = list(self.prof.events())
        kernels = collections.Counter()
        intervals, host = [], []
        for e in events:
            a, b = e.time_range.start, e.time_range.end
            if e.device_type == dev_t:
                kernels[e.name] += (b - a) * 1e-6
                intervals.append((a, b))
            elif b > a:
                host.append((a, b, e.name))
        if not intervals:
            return {}
        merged = _union(intervals)
        busy = sum(b - a for a, b in merged) * 1e-6
        lo = min([a for a, _, _ in host] + [merged[0][0]])
        hi = max([b for _, b, _ in host] + [merged[-1][1]])
        edges = [lo] + [x for ab in merged for x in ab] + [hi]
        host.sort()
        starts = [h[0] for h in host]
        gaps = collections.Counter()
        for a, b in zip(edges[0::2], edges[1::2]):
            if b > a:
                gaps[_host_op(host, starts, a, b)] += (b - a) * 1e-6
        return {"busy_s": busy, "window_s": self.wall, "units": self.units,
                "kernels": dict(kernels), "gaps": dict(gaps)}


class Spans:
    """Named device times: with spans.time(name): ... adds the CUDA-event
    milliseconds of the block (synchronised on both sides)."""

    def __init__(self, device):
        self.device = device
        self.ms = collections.defaultdict(list)

    @contextlib.contextmanager
    def time(self, name: str):
        cuda = torch.device(self.device).type == "cuda"
        _sync(self.device)
        if cuda:
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
        else:
            t0 = time.perf_counter()
        yield
        if cuda:
            b.record()
            _sync(self.device)
            self.ms[name].append(a.elapsed_time(b))
        else:
            self.ms[name].append((time.perf_counter() - t0) * 1e3)

    def mean(self) -> dict:
        return {k: sum(v) / len(v) for k, v in self.ms.items() if v}


def breakdown(prof: dict) -> dict:
    """The result's breakdown: the ten device operations that took most
    time and the ten host operations most idle time fell in."""
    def top(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])
                [:10]]
    return {"device_ops": top(prof.get("kernels", {})),
            "idle_gaps": top(prof.get("gaps", {}))}
