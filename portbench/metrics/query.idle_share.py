"""The device's idle share of the traced viewer frames (the profiler's
busy seconds against the traced wall seconds; the loop is closed, so
the frames follow one another and no wait for a request is in it)."""

LAYER = "device"
SOURCE = "device_trace"
MOVES = "query_frame_ms.p95"


def read(r):
    p = r.get("profile")
    if not p or r.get("frames") is None:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
