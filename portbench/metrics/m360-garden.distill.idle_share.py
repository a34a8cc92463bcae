"""The device's idle share of the profiled distillation steps (the
profiler's busy seconds against their wall seconds)."""

LAYER = "device"
SOURCE = "device_trace"
MOVES = "m360-garden.distill_step_ms"


def read(r):
    p = r.get("profile")
    if not p or r.get("steps") is None:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
