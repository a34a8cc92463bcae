"""The port's own spans and counters of a traced run, for the readers in
portbench/metrics.

goi_tpu_torch/utils/profiling.py keeps a registry of spans and counters
that records only while a torch profiler is active: in a traced run,
the profiled steps or frames. The readers read its snapshot in the
run's own process (rank 0 of a multi-card cell), taken once a run and
kept. Each divides by the registry's own count of the cell's units
(steps or frames). Where the program has no registry, or it holds no
unit of the cell (an untraced run), they return None.
"""

from __future__ import annotations

_LAST = [None, None]    # the readings of the run last read, its snapshot


def snapshot(r):
    """The registry's snapshot for the run whose readings are `r`, or
    None where the program has no registry."""
    if _LAST[0] is not r:
        try:
            from goi_tpu_torch.utils import profiling
            snap = profiling.snapshot()
        except (ImportError, AttributeError):
            snap = None
        _LAST[:] = [r, snap]
    return _LAST[1]


def _units(snap, unit) -> int:
    return snap["units"].get(unit, 0) if snap else 0


def per_unit(r, unit: str, name: str, key: str):
    """The span `name`'s `key` (host_ms, device_ms, self_host_ms or
    self_device_ms) summed over the run, over its `unit` spans."""
    snap = snapshot(r)
    n = _units(snap, unit)
    if not n or name not in snap["spans"]:
        return None
    return snap["spans"][name][key] / n


def share(r, unit: str, part: str, whole: str):
    """100 x the counter `part` over the counter `whole`."""
    snap = snapshot(r)
    if not _units(snap, unit) or not snap["counters"].get(whole):
        return None
    return 100.0 * snap["counters"].get(part, 0) / snap["counters"][whole]
