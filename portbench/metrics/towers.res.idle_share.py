"""The device's idle share of the traced RES requests (the profiler's
busy seconds against the traced wall seconds; the loop is closed, so the
requests follow one another and no wait for a user is in it)."""

LAYER = "device"
SOURCE = "device_trace"
MOVES = "query_frame_ms.p95"


def read(r):
    p = r.get("profile")
    if not p or r.get("requests") is None:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
