"""Rank 0's device idle share over the profiled data-parallel steps
(the profiler's busy seconds against their wall seconds); a rank that
waits for a slower one in the all-reduce idles."""

LAYER = "device"
SOURCE = "device_trace"
MOVES = "dp4_step_ms"


def read(r):
    p = r.get("profile")
    if not p or r.get("chips") is None:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
